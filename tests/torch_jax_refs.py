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

Cases: ``replay_tris`` (tests/test_torch_grad.py), ``intersect_cornell``
(tests/test_torch_intersect.py), ``prism_render`` and ``prism_flip`` (tests/test_torch_render.py),
``fused_prism`` (tests/test_torch_diff.py), ``field_mega``
(tests/test_torch_wavefront.py), ``field_sorted`` and ``field_replay``
(tests/test_torch_wavefront_grad.py).
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


CASES = {
    name: (globals()[f"{name}_inputs"], globals()[f"{name}_jax"])
    for name in ("replay_tris", "intersect_cornell", "prism_render", "prism_flip", "fused_prism", "field_mega",
                 "field_sorted", "field_replay")
}


def main() -> int:
    """Recompute every case (in order: field_replay reads field_sorted's
    new outputs) and write the file."""
    global _STORE
    store = {}
    for name, (make_inputs, run_jax) in CASES.items():
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
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main())
