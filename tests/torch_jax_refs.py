"""The JAX package's kernel outputs that the port's CPU tests compare with.

The port's tests hold its plain versions to the JAX package's Pallas
kernels on the same inputs. In interpret mode each of those kernel calls
costs 10-90 s of CPU, inside the time limit of the whole CPU test run, so
their outputs are stored in tests/torch_jax_refs.npz, each case beside a
digest of its inputs. A test builds its inputs from its seed as before
(numpy, and the JAX package's own scene functions) and takes the JAX
outputs through ``outputs(case, inputs)``, which fails unless the inputs'
digest equals the stored one; tests/test_torch_jax_refs.py rebuilds every
case's inputs and checks them against the record. Regenerate the file
(every case, a few minutes on a CPU) with

    JAX_PLATFORMS=cpu python tests/torch_jax_refs.py

    JAX_PLATFORMS=cpu python tests/torch_jax_refs.py CASE ...

rewrites only the named cases and keeps the others.

Cases: ``replay_tris`` (tests/test_torch_grad.py), ``intersect_cornell``
(tests/test_torch_intersect.py), ``prism_render`` and ``prism_flip`` (tests/test_torch_render.py),
``fused_prism`` (tests/test_torch_diff.py), ``field_mega``
(tests/test_torch_wavefront.py), ``field_sorted`` and ``field_replay``
(tests/test_torch_wavefront_grad.py); the XLA-style renderer's
``xla_camera``, ``xla_spectrum``, ``xla_hits``, ``xla_scatter``,
``xla_cornell``, ``xla_prism``, ``xla_train`` and ``xla_misc``
(tests/test_torch_xla.py)
``lbvh`` (tests/test_torch_lbvh.py), and the warp estimators'
``warp_geometry``, ``warp_funcs``, ``warp_screen``, ``warp_shadow``,
``warp_fuzz`` and ``warp_train`` (tests/test_torch_warp.py), the sharded
paths' ``par_render``, ``par_train`` and ``par_fused``
(tests/test_torch_parallel.py), the general-colour rgb2spec's ``rgb2spec``
(tests/test_torch_rgb2spec.py), and the first step of each of the last two
examples, ``inverse_field`` and ``inverse_dispersion``
(tests/test_torch_examples.py). The XLA-style
and warped cases store the draws of the JAX renderer's key schedule beside
its outputs, so that the port renders the same paths (``xla_draws``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import sys

import numpy as np

REFS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_jax_refs.npz")


def jax_arrays(s) -> dict:
    """A JAX scene's arrays (materials nested), as scene_from_numpy takes them."""
    d = {f.name: np.asarray(getattr(s, f.name)) for f in dataclasses.fields(s) if f.name not in ("materials", "bvh")}
    d["materials"] = {f.name: np.asarray(getattr(s.materials, f.name)) for f in dataclasses.fields(s.materials)}
    return d


def _flat(inputs: dict, prefix: str = ""):
    for k in sorted(inputs):
        v = inputs[k]
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def digest(inputs: dict) -> str:
    """sha256 of the inputs' names, dtypes, shapes and bytes."""
    h = hashlib.sha256()
    for k, a in _flat(inputs):
        h.update(f"{k}:{a.dtype.str}:{a.shape}".encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


_STORE = None


def stored(case: str) -> tuple[str, dict]:
    """(inputs digest, outputs) of a case as recorded in the file."""
    global _STORE
    if _STORE is None:
        with np.load(REFS) as f:
            _STORE = {k: f[k] for k in f.files}
    pre = f"{case}/"
    outs = {k[len(pre):]: v for k, v in _STORE.items() if k.startswith(pre) and k != pre + "_digest"}
    return str(_STORE[pre + "_digest"]), outs


def outputs(case: str, inputs: dict) -> dict:
    """The stored JAX outputs of ``case``, after checking that ``inputs``
    are the ones they were computed from."""
    want, outs = stored(case)
    got = digest(inputs)
    if got != want:
        raise AssertionError(
            f"{case}: inputs differ from those of the stored JAX outputs ({got[:12]} != {want[:12]}); "
            "regenerate with: JAX_PLATFORMS=cpu python tests/torch_jax_refs.py"
        )
    return outs


# ---- the cases: inputs from a seed, and the JAX calls that regenerate -----


def replay_tris_inputs() -> dict:
    """Synthetic residuals for TRIS (9 materials, sky-lit): 1024 rays, 2 spp,
    4 bounces, material residuals in {-1, 0, 1..9}, n_valid in {0, 1, 7},
    heroes in [360, 830), a seeded cotangent."""
    import jax.numpy as jnp

    from spectral_tpu.models.scenes import TRIS
    from spectral_tpu.models.scenes import build_scene as jax_build_scene
    from spectral_tpu.ops.pallas.render_kernel import pack_scene as jax_pack_scene
    from spectral_tpu.ops.rgb2spec import srgb_to_illuminance_spectrum

    n, spp, bounces = 1024, 2, 4
    rng = np.random.default_rng(20240521)
    scene = dataclasses.replace(
        jax_build_scene(TRIS), background_spd=srgb_to_illuminance_spectrum(jnp.asarray([0.8, 0.8, 0.8]))
    )
    _, mat, tab = jax_pack_scene(scene)
    hero = rng.uniform(360.0, 830.0, (spp, n)).astype(np.float32)
    n_valid = rng.choice(np.asarray([0.0, 1.0, 7.0], np.float32), (spp, n))
    power = rng.uniform(0.0, 2.0, (spp, 7, n)).astype(np.float32)
    matres = rng.choice(np.arange(-1, 10, dtype=np.int32), (spp, bounces, n))
    g = rng.normal(size=(n, 3)).astype(np.float32)
    return dict(mat=np.asarray(mat), tab=np.asarray(tab), g=g, hero=hero, n_valid=n_valid, power=power,
                matres=matres, spp=np.int32(spp), bounces=np.int32(bounces))


def replay_tris_jax(x: dict) -> dict:
    import jax.numpy as jnp

    from spectral_tpu.ops.pallas.grad_kernel import render_grads_pallas

    ref = render_grads_pallas(
        *(jnp.asarray(x[k]) for k in ("mat", "tab", "g", "hero", "n_valid", "power", "matres")),
        int(x["spp"]), int(x["bounces"]), 1024, True, want_bg_grads=True, want_sellmeier=True,
    )
    return dict(zip(("d_coeffs", "d_power", "d_bg", "sell_a", "sell_b"), (np.asarray(r) for r in ref)))


def intersect_cornell_inputs() -> dict:
    """512 rays from seed 0 (origins inside and in front of the box, random
    directions) against the port's packed CORNELL."""
    from spectral_tpu_torch.models.scenes import CORNELL, build_scene
    from spectral_tpu_torch.ops.cuda.intersect_kernel import pack_tris

    rng = np.random.default_rng(0)
    o = rng.uniform([20.0, 20.0, -400.0], [535.0, 535.0, 535.0], (512, 3)).astype(np.float32)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    return dict(o=o, d=d, tri=pack_tris(build_scene(CORNELL, "cpu")).numpy())


def intersect_cornell_jax(x: dict) -> dict:
    import jax.numpy as jnp

    from spectral_tpu.ops.pallas.intersect_kernel import intersect_pallas

    out = intersect_pallas(jnp.asarray(x["o"]), jnp.asarray(x["d"]), jnp.asarray(x["tri"]), interpret=True)
    return dict(zip(("t", "idx", "hit", "front"), (np.asarray(v) for v in out)))


def prism_render_inputs() -> dict:
    """PRISM 16x16, 8 spp, 5 bounces on numpy planes of seed 2024 over a
    768-ray tile, and the JAX package's pack and camera vector."""
    from spectral_tpu.models.scenes import PRISM
    from spectral_tpu.models.scenes import build_scene as jax_build_scene
    from spectral_tpu.models.scenes import scene_camera as jax_scene_camera
    from spectral_tpu.ops.pallas.render_kernel import camera_vector as jax_camera_vector
    from spectral_tpu.ops.pallas.render_kernel import n_uniforms as jax_n_uniforms
    from spectral_tpu.ops.pallas.render_kernel import pack_scene as jax_pack_scene

    w = h = 16
    spp, bounces, tile = 8, 5, 768
    n = w * h
    rand = np.random.default_rng(2024).uniform(size=(spp, jax_n_uniforms(bounces), tile)).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    px = np.zeros(tile, np.float32)
    py = np.zeros(tile, np.float32)
    px[:n], py[:n] = xs.ravel(), ys.ravel()
    tri, mat, tab = jax_pack_scene(jax_build_scene(PRISM))
    cam = jax_camera_vector(jax_scene_camera(PRISM, w, h))
    return dict(rand=rand, px=px, py=py, tri=np.asarray(tri), mat=np.asarray(mat), tab=np.asarray(tab),
                cam=np.asarray(cam), w=np.int32(w), h=np.int32(h), spp=np.int32(spp), bounces=np.int32(bounces))


def prism_render_jax(x: dict) -> dict:
    import jax.numpy as jnp

    from spectral_tpu.ops.pallas.render_kernel import render_rays_pallas

    n = int(x["w"]) * int(x["h"])
    ref = render_rays_pallas(
        jnp.asarray(x["cam"]), jnp.int32(0), *(jnp.asarray(x[k]) for k in ("tri", "mat", "tab", "px", "py")),
        int(x["spp"]), int(x["bounces"]), ray_tile=x["rand"].shape[2], interpret=True, rand=jnp.asarray(x["rand"]),
    )
    return dict(xyz=np.asarray(ref)[:n])


def prism_flip_inputs() -> dict:
    """One PRISM sample-ray whose path hangs on the last bit of a sin or a
    cos: pixel (30, 18) of a 32x32 frame, sample 6 of the planes of seed
    7 drawn for 16 spp and 6 bounces over a 1024-ray tile, alone in a
    768-ray tile (the other rays at pixel (0, 0) with zero planes); the
    JAX package's pack and camera vector."""
    from spectral_tpu.models.scenes import PRISM
    from spectral_tpu.models.scenes import build_scene as jax_build_scene
    from spectral_tpu.models.scenes import scene_camera as jax_scene_camera
    from spectral_tpu.ops.pallas.render_kernel import camera_vector as jax_camera_vector
    from spectral_tpu.ops.pallas.render_kernel import n_uniforms as jax_n_uniforms
    from spectral_tpu.ops.pallas.render_kernel import pack_scene as jax_pack_scene

    w = h = 32
    bounces, tile = 6, 768
    planes = np.random.default_rng(7).uniform(size=(16, jax_n_uniforms(bounces), 1024)).astype(np.float32)
    rand = np.zeros((1, jax_n_uniforms(bounces), tile), np.float32)
    rand[0, :, 0] = planes[6, :, 18 * w + 30]
    px = np.zeros(tile, np.float32)
    py = np.zeros(tile, np.float32)
    px[0], py[0] = 30.0, 18.0
    tri, mat, tab = jax_pack_scene(jax_build_scene(PRISM))
    cam = jax_camera_vector(jax_scene_camera(PRISM, w, h))
    return dict(rand=rand, px=px, py=py, tri=np.asarray(tri), mat=np.asarray(mat), tab=np.asarray(tab),
                cam=np.asarray(cam), w=np.int32(w), h=np.int32(h), spp=np.int32(1), bounces=np.int32(bounces))


def prism_flip_jax(x: dict) -> dict:
    import jax.numpy as jnp

    from spectral_tpu.ops.pallas.render_kernel import render_rays_pallas

    ref = render_rays_pallas(
        jnp.asarray(x["cam"]), jnp.int32(0), *(jnp.asarray(x[k]) for k in ("tri", "mat", "tab", "px", "py")),
        int(x["spp"]), int(x["bounces"]), ray_tile=x["rand"].shape[2], interpret=True, rand=jnp.asarray(x["rand"]),
    )
    return dict(xyz=np.asarray(ref)[:1])


def sky_lit_jax(scene):
    """A JAX scene under the gray sky of the port's gradient tests."""
    import jax.numpy as jnp

    from spectral_tpu.ops.rgb2spec import srgb_to_illuminance_spectrum

    return dataclasses.replace(scene, background_spd=srgb_to_illuminance_spectrum(jnp.asarray([0.8, 0.8, 0.8])))


def fused_prism_inputs() -> dict:
    """Sky-lit PRISM, 16x16, 4 spp, 4 bounces, the uniform planes of
    PRNGKey(13) over a 1024-ray tile, a cotangent of seed 99, and the JAX
    camera."""
    import jax

    from spectral_tpu.models.scenes import PRISM
    from spectral_tpu.models.scenes import build_scene as jax_build_scene
    from spectral_tpu.models.scenes import scene_camera as jax_scene_camera
    from spectral_tpu.ops.pallas.render_kernel import camera_vector as jax_camera_vector
    from spectral_tpu.ops.pallas.render_kernel import n_uniforms as jax_n_uniforms

    w = h = 16
    spp, bounces = 4, 4
    planes = np.asarray(jax.random.uniform(jax.random.PRNGKey(13), (spp, jax_n_uniforms(bounces), 1024)))
    cot = np.random.default_rng(99).normal(size=(h, w, 3)).astype(np.float32)
    cam = jax_camera_vector(jax_scene_camera(PRISM, w, h))
    return dict(scene=jax_arrays(sky_lit_jax(jax_build_scene(PRISM))), planes=planes, cot=cot, cam=np.asarray(cam),
                w=np.int32(w), h=np.int32(h), spp=np.int32(spp), bounces=np.int32(bounces), glass=np.int32(2))


def fused_prism_jax(x: dict) -> dict:
    """What the JAX fused backward does (diff/fast.py:239-282):
    _fused_fwd_impl, then render_grads_pallas and
    _sellmeier_grads_from_replay."""
    import jax.numpy as jnp

    from spectral_tpu.diff.fast import _fused_fwd_impl
    from spectral_tpu.diff.fast import _sellmeier_grads_from_replay
    from spectral_tpu.models.scenes import PRISM
    from spectral_tpu.models.scenes import build_scene as jax_build_scene
    from spectral_tpu.models.scenes import scene_camera as jax_scene_camera
    from spectral_tpu.ops.pallas.grad_kernel import render_grads_pallas

    w, h, spp, bounces, glass = (int(x[k]) for k in ("w", "h", "spp", "bounces", "glass"))
    n = w * h
    jscene = sky_lit_jax(jax_build_scene(PRISM))
    jcam = jax_scene_camera(PRISM, w, h)
    jxyz, jres = _fused_fwd_impl(jscene.materials, jscene, jcam, 0, 0, 0, w, h, spp, bounces, True, 13)
    jmat, jtab, jhero, jnv, jpow, jmres = jres[:6]
    g_flat = jnp.concatenate([jnp.asarray(x["cot"].reshape(n, 3)), jnp.zeros((1024 - n, 3), jnp.float32)])
    jgrads = render_grads_pallas(
        jmat, jtab, g_flat, jhero, jnv, jpow, jmres, spp, bounces, 1024, True,
        want_bg_grads=True, want_sellmeier=True,
    )
    jd_b, jd_c = _sellmeier_grads_from_replay(jscene.materials, glass, jhero, jgrads[3], jgrads[4])
    out = dict(xyz=jxyz, mat=jmat, hero=jhero, n_valid=jnv, power=jpow, matres=jmres, d_coeffs=jgrads[0],
               d_power=jgrads[1], d_bg=jgrads[2], d_sell_b=jd_b, d_sell_c=jd_c)
    return {k: np.asarray(v) for k, v in out.items()}


# the field configuration of tests/test_torch_wavefront.py and
# tests/test_torch_wavefront_grad.py: the sky-lit glass field 520/3, 64x32,
# 2 spp, 3 bounces, numpy planes of seed 5
FIELD_W, FIELD_H, FIELD_SPP, FIELD_BOUNCES = 64, 32, 2, 3
FIELD_N = FIELD_W * FIELD_H


def field_scene():
    """The field's JAX scene: build_tri_field(520, 3, glass=True), sky-lit."""
    from spectral_tpu.models import scenes as jscenes

    return sky_lit_jax(jscenes.build_tri_field(520, 3, glass=True))


def field_inputs(jscene=None) -> dict:
    """The field's JAX scene arrays, its JAX camera vector, planes, px, py."""
    from spectral_tpu.models import scenes as jscenes
    from spectral_tpu.ops.pallas.render_kernel import camera_vector as jax_camera_vector
    from spectral_tpu.ops.pallas.render_kernel import n_uniforms as jax_n_uniforms

    jscene = field_scene() if jscene is None else jscene
    jcv = jax_camera_vector(jscenes.scene_camera(jscenes.CORNELL, FIELD_W, FIELD_H))
    planes = np.random.default_rng(5).uniform(size=(FIELD_SPP, jax_n_uniforms(FIELD_BOUNCES), FIELD_N))
    ys, xs = np.meshgrid(np.arange(FIELD_H), np.arange(FIELD_W), indexing="ij")
    return dict(scene=jax_arrays(jscene), cam=np.asarray(jcv), planes=planes.astype(np.float32),
                px=xs.ravel().astype(np.float32), py=ys.ravel().astype(np.float32))


def _field_jax_pack():
    from spectral_tpu.models import scenes as jscenes
    from spectral_tpu.ops.pallas.render_kernel import camera_vector as jax_camera_vector
    from spectral_tpu.ops.pallas.render_kernel import pack_scene_auto as jax_pack_scene_auto

    jscene = field_scene()
    jcv = jax_camera_vector(jscenes.scene_camera(jscenes.CORNELL, FIELD_W, FIELD_H))
    return jscene, jcv, jax_pack_scene_auto(jscene, jcv)


def field_mega_jax(x: dict) -> dict:
    """The JAX BVH megakernel's residual form with its MXU leaf pack."""
    import jax.numpy as jnp

    from spectral_tpu.ops.pallas.render_kernel import render_rays_pallas_residuals

    _, jcv, (a, jmat, jtab, jleaf, c, leaf_size) = _field_jax_pack()
    out = render_rays_pallas_residuals(
        jcv, jnp.int32(0), a, jmat, jtab, jnp.asarray(x["px"]), jnp.asarray(x["py"]), FIELD_SPP, FIELD_BOUNCES,
        1024, True, jnp.asarray(x["planes"]), leaf_pack=jleaf, leaf_size=leaf_size, c_pack=c,
    )
    return dict(zip(("xyz", "hero", "n_valid", "power", "matres"), (np.asarray(v) for v in out)))


field_mega_inputs = field_inputs
field_sorted_inputs = field_inputs


def field_sorted_jax(x: dict) -> dict:
    """The JAX sorted scheduler, save_residuals=True."""
    import jax.numpy as jnp

    from spectral_tpu.ops.pallas.wavefront_kernel import render_rays_wavefront as jax_render_rays_wavefront

    _, jcv, (a, jmat, jtab, jleaf, c, _) = _field_jax_pack()
    out = jax_render_rays_wavefront(
        jcv, a, jmat, jtab, jnp.asarray(x["px"]), jnp.asarray(x["py"]), jnp.asarray(x["planes"]), FIELD_SPP,
        FIELD_BOUNCES, jleaf, c, 1024, True, save_residuals=True,
    )
    return dict(zip(("xyz", "hero", "n_valid", "power", "matres"), (np.asarray(v) for v in out)))


def field_replay_inputs(field=None, cot=None) -> dict:
    """The field's inputs and the replay's cotangent (see field_cotangent);
    the replay reads the stored field_sorted residuals of the frame's
    bottom half, whose inputs that case checks."""
    field = field_inputs() if field is None else field
    return dict(field=field, cot=field_cotangent(field, stored("field_sorted")[1]) if cot is None else cot)


def field_cotangent(x: dict, jax_sorted: dict) -> np.ndarray:
    """The replay's cotangent [N, 3]: seed 99, zero on the frame's top half
    and on every pixel with a sample-ray whose residuals depart from the
    port's plain sorted render."""
    import torch

    from spectral_tpu_torch.models.camera import camera_vector
    from spectral_tpu_torch.models.scenes import CORNELL, scene_camera, scene_from_numpy
    from spectral_tpu_torch.ops.cuda.render_kernel import pack_scene_auto
    from spectral_tpu_torch.ops.cuda.wavefront_kernel import render_rays_wavefront

    scene = scene_from_numpy(x["scene"], "cpu")
    cam = camera_vector(scene_camera(CORNELL, FIELD_W, FIELD_H, "cpu"))
    tri, mat, tab, leaf = pack_scene_auto(scene, cam)
    port = render_rays_wavefront(
        cam, 0, tri, mat, tab, leaf, torch.from_numpy(x["px"]), torch.from_numpy(x["py"]), FIELD_SPP,
        FIELD_BOUNCES, FIELD_W, torch.from_numpy(x["planes"]), save_residuals=True,
    )
    mres = (port[4].numpy() != jax_sorted["matres"]).any(axis=1)
    nv = port[2].numpy() != jax_sorted["n_valid"]
    pw = ~np.isclose(port[3].numpy(), jax_sorted["power"], rtol=2e-4, atol=1e-5).all(axis=1)
    cot = np.random.default_rng(99).normal(size=(FIELD_N, 3)).astype(np.float32)
    cot[(mres | nv | pw).any(axis=0)] = 0.0
    cot[: FIELD_N // 2] = 0.0
    return cot


def field_replay_jax(x: dict) -> dict:
    """render_grads_pallas on the JAX sorted residuals of the replayed half
    (the bottom one), and the JAX Sellmeier fold for FIELD_GLASS_MAT."""
    import jax.numpy as jnp

    from spectral_tpu.diff.fast import _sellmeier_grads_from_replay
    from spectral_tpu.models import scenes as jscenes
    from spectral_tpu.ops.pallas.grad_kernel import render_grads_pallas

    jscene, _, (_, jmat, jtab, _, _, _) = _field_jax_pack()
    _, res = stored("field_sorted")
    half = slice(FIELD_N // 2, FIELD_N)
    hero = jnp.asarray(res["hero"][:, half])
    g = render_grads_pallas(
        jmat, jtab, jnp.asarray(x["cot"][half]), hero, jnp.asarray(res["n_valid"][:, half]),
        jnp.asarray(res["power"][:, :, half]), jnp.asarray(res["matres"][:, :, half]), FIELD_SPP, FIELD_BOUNCES, 1024,
        True, want_bg_grads=True, want_sellmeier=True,
    )
    jd_b, jd_c = _sellmeier_grads_from_replay(jscene.materials, jscenes.FIELD_GLASS_MAT, hero, g[3], g[4])
    return {k: np.asarray(v) for k, v in zip(("d_coeffs", "d_power", "d_bg", "d_sell_b", "d_sell_c"), (*g[:3], jd_b, jd_c))}


# ---- the XLA-style renderer (render/wavefront.py) -------------------------


def xla_draws(key, n: int, spp: int, bounces: int) -> dict:
    """The draws of the JAX renderer's key schedule for n rays
    (wavefront.py:184-186, :103; camera.py:107; shading.py:140): k =
    fold(key, s), split into k_ray, k_lam, k_path; k_ray split into the
    jitter's and the disk's keys; fold(k_path, b) split into the lambertian,
    metallic and Schlick keys. jitter [spp, n, 2], disk [spp, n, 2], hero
    (the hero uniforms) [spp, n], u1 and u2 [spp, B, n, 3], u_refl
    [spp, B, n]."""
    import jax
    import jax.numpy as jnp

    from spectral_tpu.utils.prng import fold, random_in_unit_disk, random_unit_vectors

    unit = jax.jit(lambda k: random_unit_vectors(k, (n,)))
    out = {k: [] for k in ("jitter", "disk", "hero", "u1", "u2", "u_refl")}
    for s in range(spp):
        k_ray, k_lam, k_path = jax.random.split(fold(key, s), 3)
        k_jit, k_disk = jax.random.split(k_ray)
        out["jitter"].append(jax.random.uniform(k_jit, (n, 2), jnp.float32))
        out["disk"].append(random_in_unit_disk(k_disk, (n,)))
        out["hero"].append(jax.random.uniform(k_lam, (n,), jnp.float32))
        bounce = [jax.random.split(fold(k_path, b), 3) for b in range(bounces)]
        out["u1"].append([unit(k[0]) for k in bounce])
        out["u2"].append([unit(k[1]) for k in bounce])
        out["u_refl"].append([jax.random.uniform(k[2], (n,), jnp.float32) for k in bounce])
    return {f"draws.{k}": np.asarray(v, np.float32) for k, v in out.items()}


def jax_camera_arrays(cam) -> dict:
    return {f.name: np.asarray(getattr(cam, f.name)) for f in dataclasses.fields(cam)}


def _render_inputs(scene_id, size, crop, spp, bounces, seed, sky=False, glass=-1) -> dict:
    from spectral_tpu.models import scenes as jscenes

    jscene = jscenes.build_scene(scene_id)
    if sky:
        jscene = sky_lit_jax(jscene)
    cot = np.random.default_rng(99).normal(size=(crop[3], crop[2], 3)).astype(np.float32)
    return dict(scene=jax_arrays(jscene), cam=jax_camera_arrays(jscenes.scene_camera(scene_id, *size)),
                crop=np.asarray(crop, np.int32), spp=np.int32(spp), bounces=np.int32(bounces), seed=np.int32(seed),
                cot=cot, glass=np.int32(glass))


def _jax_scene(arrays: dict):
    """A JAX Scene from jax_arrays' dict."""
    import jax.numpy as jnp

    from spectral_tpu.models.materials import Materials
    from spectral_tpu.models.scenes import Scene

    sd = dict(arrays)
    mats = Materials(**{k: jnp.asarray(v) for k, v in sd.pop("materials").items()})
    return Scene(**{k: jnp.asarray(v) for k, v in sd.items()}, materials=mats)


def _jax_camera(c: dict):
    """A JAX Camera from jax_camera_arrays' dict."""
    import jax.numpy as jnp

    from spectral_tpu.models.camera import Camera

    vecs = ("center", "pixel00_loc", "pixel_delta_u", "pixel_delta_v", "defocus_disk_u", "defocus_disk_v", "background")
    return Camera(**{k: jnp.asarray(c[k]) for k in vecs}, defocus_angle=float(c["defocus_angle"]),
                  image_width=int(c["image_width"]), image_height=int(c["image_height"]))


def _render_jax(x: dict) -> dict:
    """The JAX render_chunk of the case, its draws, and the gradients of
    sum(xyz * cot) with respect to coeffs, emission_power, the background
    SPD and Sellmeier B/C (with reparam_glass when ``glass`` >= 0)."""
    import jax
    import jax.numpy as jnp

    from spectral_tpu.models.materials import tabulate
    from spectral_tpu.render.wavefront import render_chunk

    scene, cam = _jax_scene(x["scene"]), _jax_camera(x["cam"])
    x0, y0, w, h = (int(v) for v in x["crop"])
    spp, bounces, glass = int(x["spp"]), int(x["bounces"]), int(x["glass"])
    glass = None if glass < 0 else glass
    key = jax.random.PRNGKey(int(x["seed"]))
    cot = jnp.asarray(x["cot"])

    def render(coeffs, power, bg, sb, sc):
        m = dataclasses.replace(scene.materials, coeffs=coeffs, emission_power=power, sellmeier_b=sb, sellmeier_c=sc)
        s = dataclasses.replace(scene, materials=tabulate(m), background_spd=bg)
        return render_chunk(s, cam, key, x0, y0, w, h, spp, bounces, reparam_glass=glass)

    m = scene.materials
    leaves = (m.coeffs, m.emission_power, scene.background_spd, m.sellmeier_b, m.sellmeier_c)
    grads = jax.grad(lambda *a: jnp.sum(render(*a) * cot), argnums=tuple(range(5)))(*leaves)
    out = dict(xyz=render(*leaves), **dict(zip(("d_coeffs", "d_power", "d_bg", "d_sell_b", "d_sell_c"), grads)))
    out = {k: np.asarray(v) for k, v in out.items()}
    out.update(xla_draws(key, w * h, spp, bounces))
    return out


def xla_cornell_inputs() -> dict:
    """CORNELL 16x16, 4 spp, 4 bounces, PRNGKey(0), a cotangent of seed 99."""
    from spectral_tpu.models.scenes import CORNELL

    return _render_inputs(CORNELL, (16, 16), (0, 0, 16, 16), 4, 4, 0)


def xla_prism_inputs() -> dict:
    """The upper 32x16 crop of PRISM's 32x32 camera, 8 spp, 6 bounces,
    PRNGKey(1), reparam_glass = 2 (inverse_dispersion.py's XLA shape)."""
    from spectral_tpu.models.scenes import PRISM

    return _render_inputs(PRISM, (32, 32), (0, 0, 32, 16), 8, 6, 1, glass=2)


xla_cornell_jax = xla_prism_jax = _render_jax


def xla_train_inputs() -> dict:
    """One train_step on CORNELL 16x16, 4 spp, 4 bounces, PRNGKey(3), lr
    1e-9, from coeffs with the white wall's third coefficient + 1.5
    (inverse_rendering.py:51), against a target of seed 5."""
    from spectral_tpu.models.scenes import CORNELL
    from spectral_tpu.models.scenes import build_scene as jax_build_scene
    from spectral_tpu.models.scenes import scene_camera as jax_scene_camera

    jscene = jax_build_scene(CORNELL)
    coeffs = np.array(jscene.materials.coeffs)
    coeffs[3, 2] += 1.5
    target = np.random.default_rng(5).uniform(0.0, 0.3, (16, 16, 3)).astype(np.float32)
    return dict(scene=jax_arrays(jscene), cam=jax_camera_arrays(jax_scene_camera(CORNELL, 16, 16)),
                coeffs=coeffs, power=np.asarray(jscene.materials.emission_power), target=target,
                spp=np.int32(4), bounces=np.int32(4), seed=np.int32(3), lr=np.float32(1e-9))


def xla_train_jax(x: dict) -> dict:
    """JAX's train_step on a 1 x 1 mesh (parallel/render.py:352), and the
    draws of its one shard (keyed fold(key, 0, 0), render.py:80)."""
    import jax
    import jax.numpy as jnp

    from spectral_tpu.parallel.mesh import make_mesh
    from spectral_tpu.parallel.render import train_step
    from spectral_tpu.utils.prng import fold

    scene, cam = _jax_scene(x["scene"]), _jax_camera(x["cam"])
    key = jax.random.PRNGKey(int(x["seed"]))
    params = {"coeffs": jnp.asarray(x["coeffs"]), "emission_power": jnp.asarray(x["power"])}
    spp, bounces = int(x["spp"]), int(x["bounces"])
    new, loss = train_step(params, scene, cam, jnp.asarray(x["target"]), key, make_mesh(1), spp, bounces,
                           float(x["lr"]))
    out = dict(loss=np.asarray(loss), coeffs=np.asarray(new["coeffs"]), power=np.asarray(new["emission_power"]))
    out.update(xla_draws(fold(key, 0, 0), cam.image_width * cam.image_height, spp, bounces))
    return out


def xla_camera_inputs() -> dict:
    """A thin-lens camera (defocus 2 degrees, focus 800) at 16x8 and its
    pixels, PRNGKey(4)."""
    from spectral_tpu.models.camera import make_camera

    cam = make_camera(16, 8, 40.0, (278.0, 278.0, -800.0), (278.0, 278.0, 0.0), (0.0, 1.0, 0.0), 2.0, 800.0)
    ys, xs = np.meshgrid(np.arange(8), np.arange(16), indexing="ij")
    return dict(cam=jax_camera_arrays(cam), px=xs.ravel().astype(np.int32), py=ys.ravel().astype(np.int32),
                seed=np.int32(4))


def xla_camera_jax(x: dict) -> dict:
    """generate_rays with defocus, and its jitter and disk draws."""
    import jax

    from spectral_tpu.models.camera import generate_rays
    from spectral_tpu.utils.prng import random_in_unit_disk

    cam = _jax_camera(x["cam"])
    key = jax.random.PRNGKey(int(x["seed"]))
    n = x["px"].shape[0]
    o, d = jax.jit(lambda k: generate_rays(cam, x["px"], x["py"], k))(key)
    k_jit, k_disk = jax.random.split(key)
    return dict(o=np.asarray(o), d=np.asarray(d), jitter=np.asarray(jax.random.uniform(k_jit, (n, 2))),
                disk=np.asarray(random_in_unit_disk(k_disk, (n,))))


def xla_spectrum_inputs() -> dict:
    """1024 rays' powers (seed 6, some negative), n_valid in 0..7, sRGB
    triples in [0, 1], PRNGKey(6) for the heroes."""
    rng = np.random.default_rng(6)
    n = 1024
    return dict(power=rng.normal(1.0, 0.5, (n, 7)).astype(np.float32), n_valid=rng.integers(0, 8, n).astype(np.int32),
                srgb=rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32), seed=np.int32(6))


def xla_spectrum_jax(x: dict) -> dict:
    """hero_wavelengths (and its uniforms), spectrum_to_xyz of those combs,
    srgb_to_xyz."""
    import jax
    import jax.numpy as jnp

    from spectral_tpu.ops.color import srgb_to_xyz
    from spectral_tpu.ops.spectrum import hero_wavelengths, spectrum_to_xyz

    key = jax.random.PRNGKey(int(x["seed"]))
    n = x["power"].shape[0]
    lam = jax.jit(lambda k: hero_wavelengths(k, (n,), 7))(key)
    xyz = jax.jit(spectrum_to_xyz)(lam, jnp.asarray(x["power"]), jnp.asarray(x["n_valid"]))
    return dict(u=np.asarray(jax.random.uniform(key, (n,), jnp.float32)), lam=np.asarray(lam), xyz=np.asarray(xyz),
                srgb_xyz=np.asarray(jax.jit(srgb_to_xyz)(jnp.asarray(x["srgb"]))))


def xla_hits_inputs() -> dict:
    """CORNELL's and PRISM's arrays, and 1024 rays of seed 8 in and in
    front of the box."""
    from spectral_tpu.models.scenes import CORNELL, PRISM
    from spectral_tpu.models.scenes import build_scene as jax_build_scene

    rng = np.random.default_rng(8)
    o = rng.uniform([20.0, 20.0, -400.0], [535.0, 535.0, 535.0], (1024, 3)).astype(np.float32)
    d = rng.normal(size=(1024, 3)).astype(np.float32)
    return dict(cornell=jax_arrays(jax_build_scene(CORNELL)), prism=jax_arrays(jax_build_scene(PRISM)), o=o, d=d)


def xla_hits_jax(x: dict) -> dict:
    """The JAX scene-level nearest_hit (intersect.py:92) on both scenes."""
    import jax

    from spectral_tpu.ops.intersect import nearest_hit

    out = {}
    for name in ("cornell", "prism"):
        scene = _jax_scene(x[name])
        rec = jax.jit(lambda o, d: nearest_hit(o, d, scene))(x["o"], x["d"])
        out.update({f"{name}.{f}": np.asarray(getattr(rec, f)) for f in rec._fields})
    return out


def xla_scatter_inputs() -> dict:
    """A bounce of 2048 hand-made rays on TRIS's 9 materials (lambertian,
    metallic with fuzz 0.3 and 0.8, flint and BK7, emissive), seed 9: unit
    normals facing the ray or not, a sixth of them misses, a tenth already
    ended, hero combs over the band, grazing rays among them (so metal
    absorbs and total internal reflections occur); PRNGKey(9)."""
    from spectral_tpu.models.scenes import TRIS
    from spectral_tpu.models.scenes import build_scene as jax_build_scene

    rng = np.random.default_rng(9)
    n = 2048
    jscene = jax_build_scene(TRIS)
    n_mats = jscene.materials.mat_type.shape[0]
    d = rng.normal(size=(n, 3))
    normal = rng.normal(size=(n, 3))
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    # a third of the rays graze their surface
    graze = rng.random(n) < 1.0 / 3.0
    d[graze] -= np.sum(d[graze] * normal[graze], axis=1, keepdims=True) * normal[graze] * rng.uniform(0.9, 1.0, (graze.sum(), 1))
    front = np.sum(d * normal, axis=1) < 0.0
    hero = rng.uniform(360.0, 830.0, n)
    lam = hero[:, None] + np.arange(7) * (470.0 / 7.0)
    lam = np.where(lam > 830.0, lam - 470.0, lam)
    return dict(
        scene=jax_arrays(jscene), o=rng.uniform(0.0, 555.0, (n, 3)).astype(np.float32), d=d.astype(np.float32),
        wavelengths=lam.astype(np.float32), power=rng.uniform(0.0, 2.0, (n, 7)).astype(np.float32),
        n_valid=rng.choice(np.asarray([1, 7], np.int32), n), alive=rng.random(n) > 0.1,
        hit=rng.random(n) > 1.0 / 6.0, p=rng.uniform(0.0, 555.0, (n, 3)).astype(np.float32),
        normal=np.where(front[:, None], normal, -normal).astype(np.float32), front=front,
        mat_index=rng.integers(0, n_mats, n).astype(np.int32), seed=np.int32(9),
    )


def xla_scatter_jax(x: dict) -> dict:
    """scatter_step (shading.py:115) on the batch, and its draws."""
    import jax
    import jax.numpy as jnp

    from spectral_tpu.ops.intersect import BIG, HitRecord
    from spectral_tpu.ops.shading import RayState, scatter_step
    from spectral_tpu.utils.prng import random_unit_vectors

    scene = _jax_scene(x["scene"])
    n = x["o"].shape[0]
    hit = jnp.asarray(x["hit"])
    rec = HitRecord(t=jnp.where(hit, 1.0, BIG), hit=hit, p=jnp.asarray(x["p"]), normal=jnp.asarray(x["normal"]),
                    front_face=jnp.asarray(x["front"]), mat_index=jnp.asarray(x["mat_index"]),
                    tri_index=jnp.where(hit, 0, -1))
    state = RayState(o=jnp.asarray(x["o"]), d=jnp.asarray(x["d"]), wavelengths=jnp.asarray(x["wavelengths"]),
                     power=jnp.asarray(x["power"]), n_valid=jnp.asarray(x["n_valid"]), alive=jnp.asarray(x["alive"]))
    key = jax.random.PRNGKey(int(x["seed"]))
    out = jax.jit(lambda st, r, k: scatter_step(st, r, scene.materials, scene.background_spd, k))(state, rec, key)
    k_lamb, k_fuzz, k_sch = jax.random.split(key, 3)
    unit = jax.jit(lambda k: random_unit_vectors(k, (n,)))
    res = {f: np.asarray(getattr(out, f)) for f in ("o", "d", "power", "n_valid", "alive")}
    res.update(u1=np.asarray(unit(k_lamb)), u2=np.asarray(unit(k_fuzz)),
               u_refl=np.asarray(jax.random.uniform(k_sch, (n,), jnp.float32)))
    return res


def xla_misc_inputs() -> dict:
    """1024 values of seed 12 (infinities among them) and clamp bounds, for
    utils/misc.py::device_clamp; 512 rays of seed 12 in and in front of the
    box (a quarter with a zero direction component, so an infinite inverse)
    against 64 boxes, and per-ray t limits, for ray_aabb (intersect.py:143)."""
    rng = np.random.default_rng(12)
    x = rng.normal(0.0, 3.0, 1024).astype(np.float32)
    x[:4] = (np.inf, -np.inf, 1.5, -1.5)
    n, n_boxes = 512, 64
    o = rng.uniform([20.0, 20.0, -400.0], [535.0, 535.0, 535.0], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[rng.random(n) < 0.25, rng.integers(0, 3)] = 0.0
    with np.errstate(divide="ignore"):
        inv_d = (np.float32(1.0) / d).astype(np.float32)
    centre = rng.uniform(0.0, 555.0, (n_boxes, 3))
    half = rng.uniform(5.0, 120.0, (n_boxes, 3))
    return dict(x=x, lo=np.float32(-1.5), hi=np.float32(2.0), o=o, inv_d=inv_d,
                bb_min=(centre - half).astype(np.float32), bb_max=(centre + half).astype(np.float32),
                t_min=np.float32(1.0), t_max=rng.uniform(100.0, 1500.0, (n, 1)).astype(np.float32))


def xla_misc_jax(x: dict) -> dict:
    """device_clamp (utils/misc.py), and ray_aabb with its default t range
    and with the case's."""
    import jax.numpy as jnp

    from spectral_tpu.ops.intersect import ray_aabb
    from spectral_tpu.utils.misc import device_clamp

    boxes = [jnp.asarray(x[k]) for k in ("o", "inv_d", "bb_min", "bb_max")]
    return dict(clamp=np.asarray(device_clamp(jnp.asarray(x["x"]), x["lo"], x["hi"])),
                aabb=np.asarray(ray_aabb(*boxes)),
                aabb_range=np.asarray(ray_aabb(*boxes, x["t_min"], jnp.asarray(x["t_max"]))))


LBVH_LEAF_SIZES = (4, 8)


def lbvh_inputs() -> dict:
    """build_tri_field(520, 3)'s arrays and 2048 rays of seed 10 over it."""
    from spectral_tpu.models import scenes as jscenes

    rng = np.random.default_rng(10)
    o = rng.uniform([20.0, 20.0, -400.0], [535.0, 300.0, 535.0], (2048, 3)).astype(np.float32)
    d = rng.normal(size=(2048, 3)).astype(np.float32)
    return dict(scene=jax_arrays(jscenes.build_tri_field(520, 3)), o=o, d=d)


def lbvh_jax(x: dict) -> dict:
    """build_lbvh's tables (bvh.py:98) and nearest_hit_bvh's record
    (bvh.py:233) at each of LBVH_LEAF_SIZES."""
    import jax

    from spectral_tpu.ops.bvh import build_lbvh, nearest_hit_bvh

    scene = _jax_scene(x["scene"])
    out = {}
    for ls in LBVH_LEAF_SIZES:
        bvh = build_lbvh(scene.bbox_min, scene.bbox_max, ls)
        out.update({f"leaf{ls}.{k}": np.asarray(getattr(bvh, k))
                    for k in ("node_min", "node_max", "left", "right", "leaf_start", "order")})
        rec = jax.jit(lambda o, d: nearest_hit_bvh(o, d, scene, bvh))(x["o"], x["d"])
        out.update({f"leaf{ls}.{f}": np.asarray(getattr(rec, f)) for f in rec._fields})
    return out


# ---- the warp estimators (diff/geometry.py, diff/vertex_warp.py, -------
# ---- diff/fuzz_warp.py) and the warped XLA-style renderer -----------------


def warp_scene_jax(name: str):
    """The warp scenes of tests/test_diff.py (JAX package): (scene, camera,
    first moving triangle). "screen" (:739, a dark quad against an emissive
    one), "shadow" (:757, an occluder's shadow on a lit floor; also
    examples/inverse_geometry.py's scene), "fuzz" (:991, a fuzzy metal floor
    reflecting a light; also examples/inverse_fuzz.py's), "mirror" (:930, a
    mirror slab under a blue-gray sky)."""
    from spectral_tpu.models.camera import make_camera
    from spectral_tpu.models.geometry import TriSoup
    from spectral_tpu.models.materials import MaterialBuilder
    from spectral_tpu.models.scenes import PRISM, _scene_from, scene_camera

    mb = MaterialBuilder(replicate_reference_bugs=name != "mirror")
    soup = TriSoup()
    if name == "screen":
        dark = mb.lambertian((0.1, 0.1, 0.1))
        light = mb.emissive((1.0, 1.0, 1.0), 4.0)
        soup.quad((-4.0, -4.0, 3.0), (8.0, 0.0, 0.0), (0.0, 8.0, 0.0), light)
        soup.quad((-3.0, -2.0, 1.0), (3.0, 0.0, 0.0), (0.0, 4.0, 0.0), dark)
        cam = make_camera(16, 16, vfov=60.0, lookfrom=(0, 0, -2), lookat=(0, 0, 0))
        return _scene_from(soup, mb.build(), (0.0, 0.0, 0.0)), cam, 2
    if name == "shadow":
        white = mb.lambertian((0.8, 0.8, 0.8))
        dark = mb.lambertian((0.05, 0.05, 0.05))
        light = mb.emissive((1.0, 1.0, 1.0), 6.0)
        soup.quad((-4.0, 0.0, -4.0), (8.0, 0.0, 0.0), (0.0, 0.0, 8.0), white)
        soup.quad((-1.0, 3.0, -1.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0), light)
        soup.quad((-2.0, 1.5, -1.5), (2.0, 0.0, 0.0), (0.0, 0.0, 3.0), dark)
        cam = make_camera(16, 16, vfov=70.0, lookfrom=(0.0, 1.0, -3.0), lookat=(0.0, 0.0, 0.5))
        return _scene_from(soup, mb.build(), (0.0, 0.0, 0.0)), cam, 4
    if name == "fuzz":
        metal = mb.metallic((0.9, 0.9, 0.9), 0.25)
        light = mb.emissive((1.0, 1.0, 1.0), 5.0)
        soup.quad((-4.0, 0.0, -4.0), (8.0, 0.0, 0.0), (0.0, 0.0, 8.0), metal)
        soup.quad((0.5, 2.5, -0.5), (1.2, 0.0, 0.0), (0.0, 0.0, 1.2), light)
        cam = make_camera(16, 16, vfov=60.0, lookfrom=(0.0, 1.2, -3.0), lookat=(0.5, 0.0, 0.0))
        return _scene_from(soup, mb.build(), (0.0, 0.0, 0.0)), cam, metal
    if name == "mirror":
        mirror = mb.metallic((0.9, 0.9, 0.9), fuzz=0.0)
        soup.box((-400, -400, -220), (955, 955, -200), mirror)
        return _scene_from(soup, mb.build(), (0.5, 0.6, 0.8)), scene_camera(PRISM, 16, 16), 0
    raise ValueError(name)


def warp_geometry_inputs() -> dict:
    """The vertices of CORNELL, PRISM and TRIS, and CORNELL's moved by
    normal(0, 2) noise of seed 13."""
    from spectral_tpu.models.scenes import CORNELL, PRISM, TRIS
    from spectral_tpu.models.scenes import build_scene as jax_build_scene

    out = {}
    for name, sid in (("cornell", CORNELL), ("prism", PRISM), ("tris", TRIS)):
        s = jax_build_scene(sid)
        out[name] = {k: np.asarray(getattr(s, k)) for k in ("v0", "v1", "v2")}
    rng = np.random.default_rng(13)
    out["moved"] = {k: (v + rng.normal(0.0, 2.0, v.shape)).astype(np.float32) for k, v in out["cornell"].items()}
    return out


def warp_geometry_jax(x: dict) -> dict:
    """derive_tri_arrays (diff/geometry.py:38), jitted, on each set."""
    import jax

    from spectral_tpu.diff.geometry import derive_tri_arrays

    f = jax.jit(derive_tri_arrays)
    return {f"{name}.{k}": np.asarray(v) for name, vs in x.items()
            for k, v in f(vs["v0"], vs["v1"], vs["v2"]).items()}


def warp_funcs_inputs() -> dict:
    """Seed 14: CORNELL's vertices and 16x16 camera; 512 pixel samples over
    the frame (and 2 px past it); 512 bounce origins in the box, unit
    normals and unit directions about them; 512 fuzz-sphere samples with
    unit mirror directions, fuzz in [0.05, 0.6]; seeded weights of each
    output."""
    from spectral_tpu.models.scenes import CORNELL
    from spectral_tpu.models.scenes import build_scene as jax_build_scene
    from spectral_tpu.models.scenes import scene_camera as jax_scene_camera

    rng = np.random.default_rng(14)
    n = 512
    s = jax_build_scene(CORNELL)

    def unit(k):
        v = rng.normal(size=(k, 3))
        return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)

    normal = unit(n)
    w0 = normal + unit(n)
    return dict(
        v0=np.asarray(s.v0), v1=np.asarray(s.v1), v2=np.asarray(s.v2),
        cam=jax_camera_arrays(jax_scene_camera(CORNELL, 16, 16)),
        fx=rng.uniform(-2.5, 17.5, n).astype(np.float32), fy=rng.uniform(-2.5, 17.5, n).astype(np.float32),
        o=rng.uniform(5.0, 550.0, (n, 3)).astype(np.float32), n=normal,
        w0=(w0 / np.linalg.norm(w0, axis=1, keepdims=True)).astype(np.float32),
        s0=unit(n), r=unit(n), fuzz=rng.uniform(0.05, 0.6, n).astype(np.float32),
        wts=rng.normal(size=(n, 4)).astype(np.float32), frozen=np.float32(0.3),
    )


def warp_funcs_jax(x: dict) -> dict:
    """warp_pixel_samples, warp_directions (vertex_warp.py:172, :256) and
    warp_fuzz (fuzz_warp.py:143, also with frozen_fuzz), and the gradients
    of sum(outputs * wts) with respect to the vertices (and for
    warp_directions the origins and normals), and to the fuzz."""
    import jax
    import jax.numpy as jnp

    from spectral_tpu.diff.fuzz_warp import warp_fuzz
    from spectral_tpu.diff.vertex_warp import edges_from_vertices, warp_directions, warp_pixel_samples

    cam = _jax_camera(x["cam"])
    wts = jnp.asarray(x["wts"])
    verts = tuple(jnp.asarray(x[k]) for k in ("v0", "v1", "v2"))

    def screen(v0, v1, v2):
        fx, fy, det = warp_pixel_samples(cam, edges_from_vertices(v0, v1, v2), jnp.asarray(x["fx"]),
                                         jnp.asarray(x["fy"]))
        return jnp.sum(fx * wts[:, 0] + fy * wts[:, 1] + det * wts[:, 2]), (fx, fy, det)

    def sphere(v0, v1, v2, o, n):
        wp, fac = warp_directions(o, n, jnp.asarray(x["w0"]), edges_from_vertices(v0, v1, v2))
        return jnp.sum(wp * wts[:, :3]) + jnp.sum(fac * wts[:, 3]), (wp, fac)

    def fuzz(f, frozen=None):
        sw, det = warp_fuzz(*(jnp.asarray(x[k]) for k in ("s0", "o", "r", "n")), f, edges_from_vertices(*verts),
                            frozen_fuzz=frozen)
        return jnp.sum(sw * wts[:, :3]) + jnp.sum(det * wts[:, 3]), (sw, det)

    out = {}
    (_, (fx, fy, det)), g = jax.jit(jax.value_and_grad(screen, argnums=(0, 1, 2), has_aux=True))(*verts)
    out.update(fx=fx, fy=fy, det=det, **{f"screen.d_v{i}": g[i] for i in range(3)})
    (_, (wp, fac)), g = jax.jit(jax.value_and_grad(sphere, argnums=(0, 1, 2, 3, 4), has_aux=True))(
        *verts, jnp.asarray(x["o"]), jnp.asarray(x["n"]))
    out.update(wp=wp, factor=fac, **{f"sphere.d_{k}": v for k, v in zip(("v0", "v1", "v2", "o", "n"), g)})
    for tag, frozen in (("fuzz", None), ("frozen", float(x["frozen"]))):
        (_, (sw, fdet)), g = jax.jit(jax.value_and_grad(lambda f: fuzz(f, frozen), has_aux=True))(
            jnp.asarray(x["fuzz"]))
        out.update({f"{tag}.s": sw, f"{tag}.det": fdet, f"{tag}.d_fuzz": g})
    return {k: np.asarray(v) for k, v in out.items()}


# the warped renders: (scene, spp, bounces, seed); 16x16 frames
WARP_RENDERS = {"warp_screen": ("screen", 4, 2, 0), "warp_shadow": ("shadow", 4, 3, 1), "warp_fuzz": ("fuzz", 4, 2, 2)}


def _warp_render_inputs(case: str) -> dict:
    name, spp, bounces, seed = WARP_RENDERS[case]
    scene, cam, _ = warp_scene_jax(name)
    cot = np.random.default_rng(99).normal(size=(16, 16, 3)).astype(np.float32)
    return dict(scene=jax_arrays(scene), cam=jax_camera_arrays(cam), spp=np.int32(spp), bounces=np.int32(bounces),
                seed=np.int32(seed), cot=cot)


def _warp_render_jax(x: dict) -> dict:
    """The warped JAX render_chunk of the whole 16x16 frame and its draws;
    the gradients of sum(xyz * cot) with respect to the vertices (under
    vertex_warp, the edges of the live vertices) or, for the fuzz scene, to
    the materials' fuzz (under fuzz_warp, the scene's edges)."""
    import jax
    import jax.numpy as jnp

    from spectral_tpu.diff.geometry import scene_with_vertices
    from spectral_tpu.diff.vertex_warp import edges_from_vertices
    from spectral_tpu.render.wavefront import render_chunk

    scene, cam = _jax_scene(x["scene"]), _jax_camera(x["cam"])
    spp, bounces = int(x["spp"]), int(x["bounces"])
    key = jax.random.PRNGKey(int(x["seed"]))
    cot = jnp.asarray(x["cot"])
    fuzz = bool(np.any(np.asarray(x["scene"]["materials"]["mat_type"]) == 1))
    if fuzz:
        edges = edges_from_vertices(scene.v0, scene.v1, scene.v2)

        def render(f):
            s = dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, fuzz=f))
            return render_chunk(s, cam, key, 0, 0, 16, 16, spp, bounces, fuzz_warp=edges)

        leaves = (scene.materials.fuzz,)
        names = ("d_fuzz",)
    else:
        def render(v0, v1, v2):
            s = scene_with_vertices(scene, v0, v1, v2)
            return render_chunk(s, cam, key, 0, 0, 16, 16, spp, bounces,
                                vertex_warp=edges_from_vertices(v0, v1, v2))

        leaves = (scene.v0, scene.v1, scene.v2)
        names = ("d_v0", "d_v1", "d_v2")
    grads = jax.grad(lambda *a: jnp.sum(render(*a) * cot), argnums=tuple(range(len(leaves))))(*leaves)
    out = dict(xyz=render(*leaves), **dict(zip(names, grads)))
    out = {k: np.asarray(v) for k, v in out.items()}
    out["xyz_s"] = _warp_samples_jax(scene, cam, key, spp, bounces, fuzz)
    out.update(xla_draws(key, 256, spp, bounces))
    return out


def _warp_samples_jax(scene, cam, key, spp: int, bounces: int, fuzz: bool) -> np.ndarray:
    """Each sample's XYZ [spp, 256, 3] of the warped render, as the sample
    body of render_tile_xyz (wavefront.py:180-204) computes it: the port's
    tests count the sample-rays that leave JAX's paths with these."""
    import jax

    from spectral_tpu.diff.vertex_warp import edges_from_vertices, warp_pixel_samples
    from spectral_tpu.models.camera import generate_rays
    from spectral_tpu.ops.spectrum import hero_wavelengths, spectrum_to_xyz
    from spectral_tpu.render.wavefront import trace_paths
    from spectral_tpu.utils.constants import N_RAY_WAVELENGTHS
    from spectral_tpu.utils.prng import fold

    edges = edges_from_vertices(scene.v0, scene.v1, scene.v2)
    ys, xs = np.meshgrid(np.arange(16, dtype=np.int32), np.arange(16, dtype=np.int32), indexing="ij")
    px, py = xs.ravel(), ys.ravel()

    @jax.jit
    def one(k):
        k_ray, k_lam, k_path = jax.random.split(k, 3)
        det = 1.0
        if fuzz:
            o, d = generate_rays(cam, px, py, k_ray)
        else:
            o, d, det = generate_rays(cam, px, py, k_ray,
                                      screen_warp=lambda fx, fy: warp_pixel_samples(cam, edges, fx, fy))
            det = det[:, None]
        lam = hero_wavelengths(k_lam, (256,), N_RAY_WAVELENGTHS)
        state = trace_paths(scene, o, d, lam, k_path, bounces, None if fuzz else edges, edges if fuzz else None)
        return spectrum_to_xyz(state.wavelengths, state.power, state.n_valid) * det

    return np.stack([np.asarray(one(fold(key, s))) for s in range(spp)])


def warp_screen_inputs() -> dict:
    """The screen scene, 16x16, 4 spp, 2 bounces, PRNGKey(0), a cotangent
    of seed 99."""
    return _warp_render_inputs("warp_screen")


def warp_shadow_inputs() -> dict:
    """The shadow scene, 16x16, 4 spp, 3 bounces, PRNGKey(1)."""
    return _warp_render_inputs("warp_shadow")


def warp_fuzz_inputs() -> dict:
    """The fuzz scene, 16x16, 4 spp, 2 bounces, PRNGKey(2)."""
    return _warp_render_inputs("warp_fuzz")


warp_screen_jax = warp_shadow_jax = warp_fuzz_jax = _warp_render_jax


def warp_train_inputs() -> dict:
    """One train_step(vertex_warp=True) on the shadow scene, 16x16, 4 spp,
    3 bounces, PRNGKey(5), lr 1, from trainable_params(include_vertices=
    True) with the occluder moved +0.35 in x (examples/inverse_geometry.py),
    against a target of seed 6."""
    scene, cam, occ = warp_scene_jax("shadow")
    move = np.zeros((scene.num_tris, 3), np.float32)
    move[occ:, 0] = 0.35
    verts = {k: np.asarray(getattr(scene, k)) + move for k in ("v0", "v1", "v2")}
    target = np.random.default_rng(6).uniform(0.0, 0.3, (16, 16, 3)).astype(np.float32)
    return dict(scene=jax_arrays(scene), cam=jax_camera_arrays(cam), **verts, target=target, spp=np.int32(4),
                bounces=np.int32(3), seed=np.int32(5), lr=np.float32(1.0))


def warp_train_jax(x: dict) -> dict:
    """JAX's train_step(vertex_warp=True) on a 1 x 1 mesh with every leaf of
    trainable_params(include_vertices=True), the vertices moved; the draws
    of its one shard."""
    import jax
    import jax.numpy as jnp

    from spectral_tpu.parallel.mesh import make_mesh
    from spectral_tpu.parallel.render import train_step, trainable_params
    from spectral_tpu.utils.prng import fold

    scene, cam = _jax_scene(x["scene"]), _jax_camera(x["cam"])
    key = jax.random.PRNGKey(int(x["seed"]))
    params = dict(trainable_params(scene, include_vertices=True), **{k: jnp.asarray(x[k]) for k in ("v0", "v1", "v2")})
    spp, bounces = int(x["spp"]), int(x["bounces"])
    new, loss = train_step(params, scene, cam, jnp.asarray(x["target"]), key, make_mesh(1), spp, bounces,
                           float(x["lr"]), vertex_warp=True)
    out = dict(loss=np.asarray(loss), **{f"new.{k}": np.asarray(v) for k, v in new.items()})
    out.update(xla_draws(fold(key, 0, 0), cam.image_width * cam.image_height, spp, bounces))
    return out


# ---- the multi-device functions (parallel/render.py) on a 2 x 2 mesh -------
# Cornell 16x16, 4 spp, 2 bounces: each (tile, sample) shard renders 8 rows
# at 2 samples. Written with 4 virtual CPU devices (main() sets
# --xla_force_host_platform_device_count).

PAR_SHAPE = (2, 2)
PAR_SIZE, PAR_SPP, PAR_BOUNCES = 16, 4, 2


def _par_mesh():
    import jax

    from spectral_tpu.parallel.mesh import make_mesh

    n = PAR_SHAPE[0] * PAR_SHAPE[1]
    if len(jax.devices()) < n:
        raise SystemExit(f"the par_* cases need {n} devices: set XLA_FLAGS=--xla_force_host_platform_device_count={n}")
    mesh = make_mesh(n)
    assert (mesh.shape["tile"], mesh.shape["sample"]) == PAR_SHAPE
    return mesh


def _par_draws(key, cam) -> dict:
    """Each shard's draws (xla_draws of fold(key, ti, si), render.py:80) under
    "shard{ti * ns + si}."."""
    from spectral_tpu.utils.prng import fold

    nt, ns = PAR_SHAPE
    rows, local_spp = cam.image_height // nt, PAR_SPP // ns
    out = {}
    for ti in range(nt):
        for si in range(ns):
            draws = xla_draws(fold(key, ti, si), rows * cam.image_width, local_spp, PAR_BOUNCES)
            out.update({f"shard{ti * ns + si}.{k}": v for k, v in draws.items()})
    return out


def _par_inputs(seed: int, lr: float, sky: bool = False) -> dict:
    """CORNELL at PAR_SIZE (``sky``: under the gray sky), the white wall's
    third coefficient + 1.5 (inverse_rendering.py:51), a target of seed 5,
    PRNGKey(seed) / seed."""
    from spectral_tpu.models.scenes import CORNELL
    from spectral_tpu.models.scenes import build_scene as jax_build_scene
    from spectral_tpu.models.scenes import scene_camera as jax_scene_camera

    jscene = jax_build_scene(CORNELL)
    if sky:
        jscene = sky_lit_jax(jscene)
    coeffs = np.array(jscene.materials.coeffs)
    coeffs[3, 2] += 1.5
    target = np.random.default_rng(5).uniform(0.0, 0.3, (PAR_SIZE, PAR_SIZE, 3)).astype(np.float32)
    return dict(scene=jax_arrays(jscene), cam=jax_camera_arrays(jax_scene_camera(CORNELL, PAR_SIZE, PAR_SIZE)),
                coeffs=coeffs, power=np.asarray(jscene.materials.emission_power), target=target,
                mesh=np.asarray(PAR_SHAPE, np.int32), spp=np.int32(PAR_SPP), bounces=np.int32(PAR_BOUNCES),
                seed=np.int32(seed), lr=np.float32(lr))


def par_render_inputs() -> dict:
    return _par_inputs(7, 0.0)


def par_render_jax(x: dict) -> dict:
    """JAX's render_image_sharded (render.py:41) on the 2 x 2 mesh, and each
    shard's draws."""
    import jax

    from spectral_tpu.parallel.render import render_image_sharded

    scene, cam = _jax_scene(x["scene"]), _jax_camera(x["cam"])
    key = jax.random.PRNGKey(int(x["seed"]))
    xyz = render_image_sharded(scene, cam, key, _par_mesh(), PAR_SPP, PAR_BOUNCES)
    return dict(xyz=np.asarray(xyz), **_par_draws(key, cam))


def par_train_inputs() -> dict:
    return _par_inputs(3, 1e-9)


def par_train_jax(x: dict) -> dict:
    """JAX's train_step (render.py:352) on the 2 x 2 mesh; the gradient it
    descends, jax.grad of its loss function (:371-391) on the same mesh,
    since at its lr the step is below the parameters' last bit for most
    leaves; and each shard's draws."""
    import jax
    import jax.numpy as jnp

    from spectral_tpu.parallel.render import apply_params, render_image_sharded, train_step

    scene, cam = _jax_scene(x["scene"]), _jax_camera(x["cam"])
    key = jax.random.PRNGKey(int(x["seed"]))
    params = {"coeffs": jnp.asarray(x["coeffs"]), "emission_power": jnp.asarray(x["power"])}
    target = jnp.asarray(x["target"])
    mesh = _par_mesh()
    new, loss = train_step(params, scene, cam, target, key, mesh, PAR_SPP, PAR_BOUNCES, float(x["lr"]))

    def loss_fn(p):
        img = render_image_sharded(apply_params(scene, p), cam, key, mesh, PAR_SPP, PAR_BOUNCES) / float(PAR_SPP)
        return jnp.mean((img - target) ** 2)

    grads = jax.jit(jax.grad(loss_fn))(params)
    out = dict(loss=np.asarray(loss), coeffs=np.asarray(new["coeffs"]), power=np.asarray(new["emission_power"]),
               d_coeffs=np.asarray(grads["coeffs"]), d_power=np.asarray(grads["emission_power"]))
    out.update(_par_draws(key, cam))
    return out


def par_fused_inputs() -> dict:
    """Sky-lit: in interpret mode the kernels' hardware PRNG draws zeros
    (render_kernel.py:2003), and no such path reaches CORNELL's light in
    PAR_BOUNCES bounces."""
    return _par_inputs(11, 1.0, sky=True)


def par_fused_jax(x: dict) -> dict:
    """JAX's train_step_fused (render.py:269) on the 2 x 2 mesh in interpret
    mode, and the gradient JAX composes from its own per-shard fused
    renders (render_rays_diff_fused, the shard seeds of render.py:290, the
    sample shards summed, the loss summed over tiles): the sharded step's
    gradient, (p - new) / lr, is n_sample times the composed one (ROADMAP
    C8)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from spectral_tpu.diff.fast import render_rays_diff_fused
    from spectral_tpu.parallel.render import train_step_fused

    scene, cam = _jax_scene(x["scene"]), _jax_camera(x["cam"])
    seed, lr = int(x["seed"]), float(x["lr"])
    target = jnp.asarray(x["target"])
    params = {"coeffs": jnp.asarray(x["coeffs"]), "emission_power": jnp.asarray(x["power"])}
    interpret = pltpu.InterpretParams()
    new, loss = train_step_fused(params, scene, cam, target, seed, _par_mesh(), PAR_SPP, PAR_BOUNCES, lr,
                                 interpret=interpret)

    nt, ns = PAR_SHAPE
    h = w = PAR_SIZE
    rows, local_spp = h // nt, PAR_SPP // ns
    n_local = rows * w
    pad = (-n_local) % 1024

    def composed(p):
        mats = dataclasses.replace(scene.materials, **p)
        total = 0.0
        for ti in range(nt):
            ys, xs = np.meshgrid(np.arange(rows) + ti * rows, np.arange(w), indexing="ij")
            px = jnp.asarray(np.concatenate([xs.ravel(), np.zeros(pad)]), jnp.float32)
            py = jnp.asarray(np.concatenate([ys.ravel(), np.zeros(pad)]), jnp.float32)
            xyz = 0.0
            for si in range(ns):
                shard_seed = jnp.int32(seed + (ti * ns + si) * 7919993)
                out = render_rays_diff_fused(mats, scene, cam, px, py, shard_seed, local_spp, PAR_BOUNCES, interpret)
                xyz = xyz + out[:n_local]
            img = xyz.reshape(rows, w, 3) / PAR_SPP
            total = total + jnp.sum((img - target[ti * rows:(ti + 1) * rows]) ** 2)
        return total

    c_loss, c_grads = jax.value_and_grad(composed)(params)
    return dict(loss=np.asarray(loss), coeffs=np.asarray(new["coeffs"]), power=np.asarray(new["emission_power"]),
                composed_loss=np.asarray(c_loss) / (h * w * 3), composed_d_coeffs=np.asarray(c_grads["coeffs"]),
                composed_d_power=np.asarray(c_grads["emission_power"]))


# ---- general-colour rgb2spec and the last two examples --------------------


def rgb2spec_inputs() -> dict:
    """32 colours of seed 5 in [0.05, 0.95], four grays (0 and 1 among
    them) and the three primaries."""
    rng = np.random.default_rng(5)
    grays = np.repeat(np.asarray([0.0, 0.25, 0.73, 1.0])[:, None], 3, axis=1)
    rgb = np.concatenate([rng.uniform(0.05, 0.95, (32, 3)), grays, np.eye(3)]).astype(np.float32)
    return dict(rgb=rgb)


def rgb2spec_jax(x: dict) -> dict:
    """lookup_sigmoid_coeffs, jax.vmap(_fit_one), and srgb_to_spectrum and
    roundtrip_srgb through the table and, with RGB2SPEC_EXACT=1, through
    the LM fit (the memo cleared before each)."""
    import jax
    import jax.numpy as jnp

    from spectral_tpu.ops import rgb2spec as jr

    rgb = jnp.asarray(x["rgb"])
    out = dict(lookup=jr.lookup_sigmoid_coeffs(rgb), fit=jax.vmap(jr._fit_one)(rgb))
    old = os.environ.get("RGB2SPEC_EXACT")
    try:
        for tag, exact in (("table", "0"), ("exact", "1")):
            os.environ["RGB2SPEC_EXACT"] = exact
            jr._fit_cache.clear()
            spd = jr.srgb_to_spectrum(rgb)
            out[f"spd_{tag}"], out[f"rt_{tag}"] = spd, jr.roundtrip_srgb(spd)
    finally:
        jr._fit_cache.clear()
        if old is None:
            os.environ.pop("RGB2SPEC_EXACT", None)
        else:
            os.environ["RGB2SPEC_EXACT"] = old
    return {k: np.asarray(v) for k, v in out.items()}


# examples/inverse_field.py's first step, cut to size: the 520-triangle glass
# field at 32x16 (padded to 1024 rays with pixel (0, 0)) at the example's 4
# spp and 5 bounces (at 2 spp and 3 bounces only the light itself is seen on
# these planes, and the green row's gradient is 0)
IF_TRIS, IF_W, IF_H, IF_SPP, IF_BOUNCES, IF_GREEN = 520, 32, 16, 4, 5, 2


def _padded(w: int, h: int) -> tuple[np.ndarray, np.ndarray]:
    n = w * h
    pad = (-n) % 1024
    idx = np.arange(n)
    return (np.concatenate([idx % w, np.zeros(pad)]).astype(np.float32),
            np.concatenate([idx // w, np.zeros(pad)]).astype(np.float32))


def inverse_field_inputs() -> dict:
    """The field's JAX scene arrays and camera vector, the uniform planes of
    seed 21 over the padded rays, and the green row's perturbation."""
    from spectral_tpu.models import scenes as jscenes
    from spectral_tpu.ops.pallas.render_kernel import camera_vector as jax_camera_vector
    from spectral_tpu.ops.pallas.render_kernel import n_uniforms as jax_n_uniforms

    px, py = _padded(IF_W, IF_H)
    planes = np.random.default_rng(21).uniform(size=(IF_SPP, jax_n_uniforms(IF_BOUNCES), px.shape[0]))
    jcv = jax_camera_vector(jscenes.scene_camera(jscenes.CORNELL, IF_W, IF_H))
    return dict(scene=jax_arrays(jscenes.build_tri_field(IF_TRIS, 0, glass=True)), cam=np.asarray(jcv),
                planes=planes.astype(np.float32), px=px, py=py, offset=np.asarray([0.0, 0.0, 1.5], np.float32))


def inverse_field_jax(x: dict) -> dict:
    """What the JAX example's first step computes (inverse_field.py:107-137)
    through render_rays_diff_fused's parts on the planes (diff/fast.py:
    _rays_fwd_impl with ``rand``, then _rays_bwd's replay) in interpret
    mode: the target at the true materials, the render with the green row
    perturbed, the pixel MSE and its gradient."""
    import jax.numpy as jnp

    from spectral_tpu.diff.fast import _residual_forward, _with_materials
    from spectral_tpu.ops.pallas.grad_kernel import render_grads_pallas
    from spectral_tpu.ops.pallas.render_kernel import pack_scene_auto as jax_pack_scene_auto

    jscene = _jax_scene(x["scene"])
    cv, planes = jnp.asarray(x["cam"]), jnp.asarray(x["planes"])
    px, py = jnp.asarray(x["px"]), jnp.asarray(x["py"])

    def forward(coeffs):
        s = _with_materials(jscene, dataclasses.replace(jscene.materials, coeffs=coeffs))
        tri, mat, tab, leaf, cpk, leaf_size = jax_pack_scene_auto(s, cv)
        out = _residual_forward(cv, 0, tri, mat, tab, px, py, IF_SPP, IF_BOUNCES, 1024, True, planes, leaf, cpk,
                                leaf_size)
        return mat, tab, out

    true = jscene.materials.coeffs
    target = forward(true)[2][0] / IF_SPP
    c = true.at[IF_GREEN].add(jnp.asarray(x["offset"]))
    mat, tab, (xyz, hero, nv, pw, mres) = forward(c)
    img = xyz / IF_SPP
    loss = jnp.mean((img - target) ** 2)
    cot = 2.0 * (img - target) / img.size / IF_SPP
    grads = render_grads_pallas(mat, tab, cot, hero, nv, pw, mres, IF_SPP, IF_BOUNCES, 1024, True,
                                want_bg_grads=True, want_sellmeier=False)
    out = dict(target=target, xyz=xyz, loss=loss, d_coeffs=grads[0], n_valid=nv, matres=mres)
    return {k: np.asarray(v) for k, v in out.items()}


# examples/inverse_dispersion.py's first step, cut to size: PRISM at 32 px
# (the 32x16 upper crop), 6 bounces, B0 + 0.08; the XLA-style estimate at the
# example's 16 spp, the first of the first step's estimates (the keys of the
# JAX example's splits) that is not 0 (most are: few of a crop's paths cross
# the glass), and the fused gradient factor at spp_g 4 on uniform planes of
# seed 23 with a cotangent of seed 24
ID_SIZE, ID_SPP, ID_SPPG, ID_BOUNCES, ID_GLASS, ID_OFFSET = 32, 16, 4, 6, 2, 0.08


def inverse_dispersion_inputs() -> dict:
    from spectral_tpu.models import scenes as jscenes
    from spectral_tpu.ops.pallas.render_kernel import camera_vector as jax_camera_vector
    from spectral_tpu.ops.pallas.render_kernel import n_uniforms as jax_n_uniforms

    w, h = ID_SIZE, ID_SIZE // 2
    px, py = _padded(w, h)
    planes = np.random.default_rng(23).uniform(size=(ID_SPPG, jax_n_uniforms(ID_BOUNCES), px.shape[0]))
    cot = np.random.default_rng(24).normal(size=(h, w, 3)).astype(np.float32)
    jcam = jscenes.scene_camera(jscenes.PRISM, ID_SIZE, ID_SIZE)
    return dict(scene=jax_arrays(jscenes.build_scene(jscenes.PRISM)), cam=jax_camera_arrays(jcam),
                cam_vec=np.asarray(jax_camera_vector(jcam)), planes=planes.astype(np.float32), px=px, py=py, cot=cot)


def inverse_dispersion_jax(x: dict) -> dict:
    """The XLA-style estimate of the JAX example's first step
    (inverse_dispersion.py:77-95: the CRN residual at k1, the
    reparameterized VJP at k2; key, k1, k2 = split(key, 3) from PRNGKey(7))
    that is the first not 0, with its index and both keys' draws; and the
    fused gradient factor (render_rays_diff_fused with reparam_glass,
    :133-139) on the planes: _rays_fwd_impl's parts with ``rand``, the
    replay of cot / spp_g and the Sellmeier fold."""
    import jax
    import jax.numpy as jnp

    from spectral_tpu.diff.fast import _residual_forward, _sellmeier_grads_from_replay, _with_materials
    from spectral_tpu.ops.pallas.grad_kernel import render_grads_pallas
    from spectral_tpu.ops.pallas.render_kernel import pack_scene_auto as jax_pack_scene_auto
    from spectral_tpu.render.wavefront import render_chunk

    scene, cam = _jax_scene(x["scene"]), _jax_camera(x["cam"])
    w, h = ID_SIZE, ID_SIZE // 2
    n = w * h

    def set_b(b_glass):
        m = scene.materials
        return dataclasses.replace(scene, materials=dataclasses.replace(
            m, sellmeier_b=m.sellmeier_b.at[ID_GLASS].set(b_glass)))

    b = scene.materials.sellmeier_b[ID_GLASS] + jnp.asarray([ID_OFFSET, 0.0, 0.0])
    key = jax.random.PRNGKey(7)
    for i in range(8):  # the first step's M = 8 estimates
        key, k1, k2 = jax.random.split(key, 3)
        ref = render_chunk(scene, cam, k1, 0, 0, w, h, ID_SPP, ID_BOUNCES)
        cur = render_chunk(set_b(b), cam, k1, 0, 0, w, h, ID_SPP, ID_BOUNCES)
        resid = (cur - ref) / ID_SPP

        def f(bg, k2=k2):
            return render_chunk(set_b(bg), cam, k2, 0, 0, w, h, ID_SPP, ID_BOUNCES, reparam_glass=ID_GLASS) / ID_SPP

        _, vjp = jax.vjp(f, b)
        (g_xla,) = vjp(2.0 * resid / resid.size)
        if np.any(np.asarray(g_xla) != 0.0):
            break

    s = _with_materials(scene, set_b(b).materials)
    cv = jnp.asarray(x["cam_vec"])
    tri, mat, tab, leaf, cpk, leaf_size = jax_pack_scene_auto(s, cv)
    xyz, hero, nv, pw, mres = _residual_forward(
        cv, 0, tri, mat, tab, jnp.asarray(x["px"]), jnp.asarray(x["py"]), ID_SPPG, ID_BOUNCES, 1024, True,
        jnp.asarray(x["planes"]), leaf, cpk, leaf_size,
    )
    cot = jnp.concatenate([jnp.asarray(x["cot"]).reshape(n, 3), jnp.zeros((xyz.shape[0] - n, 3), jnp.float32)])
    grads = render_grads_pallas(mat, tab, cot / ID_SPPG, hero, nv, pw, mres, ID_SPPG, ID_BOUNCES, 1024, True,
                                want_bg_grads=True, want_sellmeier=True)
    g_fused, _ = _sellmeier_grads_from_replay(s.materials, ID_GLASS, hero, grads[3], grads[4])
    out = dict(estimate=np.int32(i), resid=resid, loss=jnp.mean(resid**2), g_xla=g_xla, xyz=xyz, g_fused=g_fused,
               matres=mres)
    out = {k: np.asarray(v) for k, v in out.items()}
    out.update({f"k1.{k}": v for k, v in xla_draws(k1, n, ID_SPP, ID_BOUNCES).items()})
    out.update({f"k2.{k}": v for k, v in xla_draws(k2, n, ID_SPP, ID_BOUNCES).items()})
    return out


CASES = {
    name: (globals()[f"{name}_inputs"], globals()[f"{name}_jax"])
    for name in ("replay_tris", "intersect_cornell", "prism_render", "prism_flip", "fused_prism", "field_mega",
                 "field_sorted", "field_replay", "xla_camera", "xla_spectrum", "xla_hits", "xla_scatter",
                 "xla_cornell", "xla_prism", "xla_train", "xla_misc", "lbvh", "warp_geometry", "warp_funcs",
                 "warp_screen", "warp_shadow", "warp_fuzz", "warp_train", "par_render", "par_train", "par_fused",
                 "rgb2spec", "inverse_field", "inverse_dispersion")
}


def main(names=()) -> int:
    """Recompute every case, or only ``names`` (in order: field_replay reads
    field_sorted's new outputs), and write the file."""
    global _STORE
    store = {}
    if names:
        unknown = set(names) - set(CASES)
        if unknown:
            raise SystemExit(f"unknown cases {sorted(unknown)}")
        with np.load(REFS) as f:
            store = {k: f[k] for k in f.files if k.split("/")[0] not in names}
    for name, (make_inputs, run_jax) in CASES.items():
        if names and name not in names:
            continue
        _STORE = dict(store)
        x = make_inputs()
        out = run_jax(x)
        store[f"{name}/_digest"] = np.asarray(digest(x))
        store.update({f"{name}/{k}": v for k, v in out.items()})
        print(name, digest(x)[:12], {k: v.shape for k, v in out.items()}, flush=True)
    np.savez_compressed(REFS, **store)
    _STORE = None
    return 0


if __name__ == "__main__":
    # the par_* cases run on a 2 x 2 mesh of virtual CPU devices
    n_dev = PAR_SHAPE[0] * PAR_SHAPE[1]
    os.environ["XLA_FLAGS"] = f"{os.environ.get('XLA_FLAGS', '')} --xla_force_host_platform_device_count={n_dev}"
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main(tuple(sys.argv[1:])))
