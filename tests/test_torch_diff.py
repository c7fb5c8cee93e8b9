"""The port's fused-gradient training path against the JAX package, on the
CPU.

(d) The composition against JAX's, on one interpret-mode forward (the JAX
    side stored in tests/torch_jax_refs.npz): sky-lit
    PRISM (gray background, carried over with scene_from_numpy), 16x16,
    4 spp, 4 bounces, the uniform planes of PRNGKey(13) handed over as
    numpy, reparam_glass = 2 and a seeded cotangent. The JAX side is what
    its fused backward does (diff/fast.py:239-282): _fused_fwd_impl, then
    render_grads_pallas and _sellmeier_grads_from_replay. The port's side is
    render_chunk_diff_fused(rand=planes) and backward(). Tolerances:
    - hero, n_valid and matres equal: both trace the same paths;
    - power: rtol 2e-4 / atol 1e-5 (tests/test_wavefront_sorted.py:127);
    - xyz: 2e-3 + 1e-5 |b| per value (tests/test_torch_render.py);
    - d_coeffs per column, d_power, d_bg: 2e-4 max|b| of the column (see
      tests/test_torch_grad.py);
    - d_sellmeier_b/c of the glass: rtol 1e-3; they pass through float32
      tanh and second-order AD over the 1024 heroes.
(e) Finite differences of the port's own deterministic estimator (the plain
    versions), mirroring tests/test_diff.py and its tolerances: white-wall
    c2 and light power on Cornell, a background knot sky-lit, Sellmeier b/c
    by frozen-target FD on the slab scene, TRIS's 9 materials, and the
    sample-chunked variant.
(f) train_step_fused: p - lr g for the g of (e)'s function, the loss by its
    formula, and a loss that falls over 3 steps from a perturbed white
    wall.
(g) The residual forward writes every matres entry: a buffer filled with
    garbage comes back with 0 for each bounce after its path ended.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from spectral_tpu.models.scenes import _scene_from
from spectral_tpu.models.scenes import build_scene as jax_build_scene
from spectral_tpu_torch.diff import render_chunk_diff_fused, render_chunk_diff_fused_accum
from spectral_tpu_torch.diff.fast import _fused_fwd_impl, _sellmeier_grads_from_replay
from spectral_tpu_torch.diff.spectral_reparam import reparam_hero
from spectral_tpu_torch.models.camera import camera_vector
from spectral_tpu_torch.models.scenes import (
    CORNELL,
    PRISM,
    TRIS,
    build_scene,
    params_from_numpy,
    scene_camera,
    scene_from_numpy,
)
from spectral_tpu_torch.ops.cuda.grad_kernel import render_grads
from spectral_tpu_torch.ops.cuda.render_kernel import (
    n_uniforms,
    pack_scene,
    render_rays,
    render_rays_residuals,
    scene_pack,
)
from spectral_tpu_torch.parallel import Mesh, apply_params, train_step_fused, trainable_params
from spectral_tpu_torch.utils.constants import LAMBDA_MAX, LAMBDA_MIN

import torch_jax_refs as refs

# one torch thread a process: the CPU test run's workers share the cores
torch.set_num_threads(1)

GLASS = 2  # the PRISM glass row


def _sky_lit(scene_id):
    return scene_from_numpy(refs.jax_arrays(refs.sky_lit_jax(jax_build_scene(scene_id))), "cpu")


def _leaves(mats, **extra):
    """Materials with coeffs/emission_power/sellmeier leaves that require
    grad (copies), plus the leaves."""
    leaves = {k: getattr(mats, k).clone().requires_grad_(True) for k in ("coeffs", "emission_power", "sellmeier_b", "sellmeier_c")}
    leaves.update(extra)
    return dataclasses.replace(mats, **{k: v for k, v in leaves.items() if hasattr(mats, k)}), leaves


def assert_columns_close(got, ref, rel=2e-4):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    got, ref = got.reshape(ref.shape[0], -1), ref.reshape(ref.shape[0], -1)
    for j in range(ref.shape[1]):
        err, scale = np.abs(got[:, j] - ref[:, j]).max(), np.abs(ref[:, j]).max()
        assert err <= rel * scale, f"column {j}: max abs {err} vs bound {rel * scale}"


def test_fused_composition_equals_jax():
    """(d): the JAX side (its interpret-mode forward, replay and Sellmeier
    fold) is stored in tests/torch_jax_refs.npz, case fused_prism, for
    these inputs."""
    x = refs.fused_prism_inputs()
    ref = refs.outputs("fused_prism", x)
    w, h, spp, bounces = (int(x[k]) for k in ("w", "h", "spp", "bounces"))
    n = w * h
    planes, cot = x["planes"], x["cot"]
    jxyz, jmat, jhero, jnv, jpow, jmres = (ref[k] for k in ("xyz", "mat", "hero", "n_valid", "power", "matres"))
    jgrads = [ref[k] for k in ("d_coeffs", "d_power", "d_bg")]
    jd_b, jd_c = ref["d_sell_b"], ref["d_sell_c"]

    scene = scene_from_numpy(x["scene"], "cpu")
    cam = scene_camera(PRISM, w, h, "cpu")
    rand = torch.from_numpy(planes[:, :, :n].copy())
    mats, leaves = _leaves(scene.materials)
    bg = scene.background_spd.clone().requires_grad_(True)
    scene_g = dataclasses.replace(scene, background_spd=bg)
    xyz = render_chunk_diff_fused(mats, scene_g, cam, 0, 0, 0, w, h, spp, bounces, reparam_glass=GLASS, rand=rand)
    xyz.backward(torch.from_numpy(cot))
    _, (mat, tab, hero, nv, pw, mres) = _fused_fwd_impl(scene.materials, scene, cam, 0, 0, 0, w, h, spp, bounces, rand=rand)

    ref_xyz = np.asarray(jxyz)
    assert (ref_xyz.sum(-1) > 0).sum() >= 20  # not a vacuous comparison
    np.testing.assert_array_equal(hero.numpy(), np.asarray(jhero)[:, :n])
    np.testing.assert_array_equal(nv.numpy(), np.asarray(jnv)[:, :n])
    np.testing.assert_array_equal(mres.numpy(), np.asarray(jmres)[:, :, :n])
    np.testing.assert_allclose(pw.numpy(), np.asarray(jpow)[:, :, :n], rtol=2e-4, atol=1e-5)
    err = np.abs(xyz.detach().numpy() - ref_xyz)
    assert (err <= 2e-3 + 1e-5 * np.abs(ref_xyz)).all(), err.max()
    np.testing.assert_allclose(mat.numpy(), np.asarray(jmat), rtol=1e-6)

    d_coeffs, d_power = leaves["coeffs"].grad.numpy(), leaves["emission_power"].grad.numpy()
    assert np.abs(d_coeffs).max() > 0 and np.abs(d_power).max() > 0 and np.abs(bg.grad.numpy()).max() > 0
    assert_columns_close(d_coeffs, np.asarray(jgrads[0]))
    assert_columns_close(d_power, np.asarray(jgrads[1]))
    assert_columns_close(bg.grad.numpy(), np.asarray(jgrads[2]))
    d_b, d_c = leaves["sellmeier_b"].grad.numpy(), leaves["sellmeier_c"].grad.numpy()
    assert np.abs(d_b[GLASS]).max() > 0
    assert not np.delete(d_b, GLASS, 0).any() and not np.delete(d_c, GLASS, 0).any()
    np.testing.assert_allclose(d_b[GLASS], np.asarray(jd_b), rtol=1e-3)
    np.testing.assert_allclose(d_c[GLASS], np.asarray(jd_c), rtol=1e-3)


def _fd(loss, eps):
    return (loss(eps) - loss(-eps)) / (2 * eps)


def _y_sum(mats, scene, cam, *args, **kw):
    with torch.no_grad():
        return float(render_chunk_diff_fused(mats, scene, cam, *args, **kw)[..., 1].sum())


def test_fd_coeff_and_power_cornell():
    """(e) test_diff.py:514-550 (white-wall c2 at 5% + 5e-3, light power at
    2% + 1e-4), at 8 spp and 4 bounces so the wall's gradient is not 0."""
    scene = build_scene(CORNELL, "cpu")
    cam = scene_camera(CORNELL, 16, 16, "cpu")
    args = (1, 0, 0, 16, 16, 8, 4)
    mats, leaves = _leaves(scene.materials)
    render_chunk_diff_fused(mats, scene, cam, *args)[..., 1].sum().backward()
    m0 = scene.materials

    def at(name, idx, e):
        t = getattr(m0, name).clone()
        t[idx] += e
        return _y_sum(dataclasses.replace(m0, **{name: t}), scene, cam, *args)

    ad = float(leaves["coeffs"].grad[3, 2])
    fd = _fd(lambda e: at("coeffs", (3, 2), e), 1e-3)
    assert ad != 0.0 and abs(ad - fd) <= 0.05 * max(abs(ad), abs(fd)) + 5e-3, (ad, fd)
    ad_p = float(leaves["emission_power"].grad[4])
    fd_p = _fd(lambda e: at("emission_power", 4, e), 1e-3)
    assert ad_p > 0.0 and abs(ad_p - fd_p) <= 0.02 * max(abs(ad_p), abs(fd_p)) + 1e-4, (ad_p, fd_p)


def test_fd_background_knot():
    """(e) test_diff.py:574-603: knot 40 of a sky-lit Cornell, 5% + 5e-3."""
    scene = _sky_lit(CORNELL)
    cam = scene_camera(CORNELL, 16, 16, "cpu")
    args = (1, 0, 0, 16, 16, 4, 3)
    bg = scene.background_spd.clone().requires_grad_(True)
    render_chunk_diff_fused(scene.materials, dataclasses.replace(scene, background_spd=bg), cam, *args)[..., 1].sum().backward()

    def at(e):
        b = scene.background_spd.clone()
        b[40] += e
        return _y_sum(scene.materials, dataclasses.replace(scene, background_spd=b), cam, *args)

    ad, fd = float(bg.grad[40]), _fd(at, 1e-3)
    assert ad != 0.0 and abs(ad - fd) <= 0.05 * max(abs(ad), abs(fd)) + 5e-3, (ad, fd)


def test_fd_sellmeier_frozen_target_slab():
    """(e) test_diff.py:302-391: the replay's Sellmeier gradients against
    the frozen-target FD of the megakernel's own reparameterized estimator
    on the slab scene (built by the JAX package, carried over), eps 1e-5,
    6% + 1e-3."""
    from spectral_tpu.models.geometry import TriSoup
    from spectral_tpu.models.materials import MaterialBuilder
    from spectral_tpu.utils.constants import SELLMEIER_FLINT_GLASS_B, SELLMEIER_FLINT_GLASS_C

    mb = MaterialBuilder(replicate_reference_bugs=False)
    glass = mb.dielectric(np.asarray(SELLMEIER_FLINT_GLASS_B), np.asarray(SELLMEIER_FLINT_GLASS_C))
    soup = TriSoup()
    soup.box((-400, -400, -220), (955, 955, -200), glass)
    scene = scene_from_numpy(refs.jax_arrays(_scene_from(soup, mb.build(), background_rgb=(0.35, 0.55, 0.9))), "cpu")
    bounces = 4
    cam = camera_vector(scene_camera(PRISM, 32, 32, "cpu"))
    px = torch.arange(32, dtype=torch.float32).repeat(32)
    py = torch.arange(32, dtype=torch.float32).repeat_interleave(32)
    rand = torch.from_numpy(np.random.default_rng(3).uniform(size=(1, n_uniforms(bounces), 1024)).astype(np.float32))
    m0 = scene.materials
    b0, c0 = m0.sellmeier_b[glass], m0.sellmeier_c[glass]

    pack = scene_pack(*pack_scene(scene))
    mat, tab = pack.mat, pack.tab
    _, hero, nv, pw, mres = render_rays_residuals(cam, 5, pack, px, py, 1, bounces, 32, rand)
    grads = render_grads(mat, tab, torch.ones((1024, 3)), hero, nv, pw, mres, 1, bounces, want_bg_grads=True, want_sellmeier=True)
    d_b, d_c = _sellmeier_grads_from_replay(m0, glass, hero, grads[3], grads[4])
    assert torch.isfinite(d_b).all() and torch.isfinite(d_c).all()

    def value(bg, cg):
        hr, wgt = reparam_hero(hero[0], bg, cg, frozen=(b0, c0))
        rand2 = rand.clone()
        rand2[0, 2] = (hr - LAMBDA_MIN) / (LAMBDA_MAX - LAMBDA_MIN)
        sb, sc = m0.sellmeier_b.clone(), m0.sellmeier_c.clone()
        sb[glass], sc[glass] = bg, cg
        pack2 = scene_pack(*pack_scene(
            dataclasses.replace(scene, materials=dataclasses.replace(m0, sellmeier_b=sb, sellmeier_c=sc))))
        out = render_rays(cam, 5, pack2, px, py, 1, bounces, 32, rand2)
        return float(torch.sum(out * wgt[:, None]))

    eps = 1e-5
    for j in (0, 1):
        e = torch.zeros(3)
        e[j] = eps
        fd = (value(b0 + e, c0) - value(b0 - e, c0)) / (2 * eps)
        ad = float(d_b[j])
        assert ad != 0.0 and abs(ad - fd) <= 0.06 * max(abs(ad), abs(fd)) + 1e-3, ("b", j, ad, fd)
    e = torch.zeros(3)
    e[0] = eps
    fd_c = (value(b0, c0 + e) - value(b0, c0 - e)) / (2 * eps)
    ad_c = float(d_c[0])
    assert abs(ad_c - fd_c) <= 0.06 * max(abs(ad_c), abs(fd_c)) + 1e-3, (ad_c, fd_c)


def test_tris_nine_materials():
    """(e) test_diff.py:552: TRIS's 9 materials need no padding; every
    gradient is finite, and every non-dielectric material on a path that
    reached a light has a nonzero coefficient gradient (a dielectric's
    weight is 1, so its coefficient gradient is 0)."""
    scene = _sky_lit(TRIS)  # every escaping path carries weight
    cam = scene_camera(TRIS, 16, 16, "cpu")
    mats, leaves = _leaves(scene.materials)
    render_chunk_diff_fused(mats, scene, cam, 1, 0, 0, 16, 16, 2, 2)[..., 1].sum().backward()
    g = leaves["coeffs"].grad
    assert g.shape == (9, 3)
    assert torch.isfinite(g).all() and torch.isfinite(leaves["emission_power"].grad).all()
    _, (_, _, _, nv, pw, mres) = _fused_fwd_impl(scene.materials, scene, cam, 1, 0, 0, 16, 16, 2, 2)
    lit = (nv > 0) & (pw.sum(1) > 0)
    hit = {int(m) - 1 for m in mres.permute(1, 0, 2)[:, lit].unique() if m > 0}
    diel = {m for m in range(9) if int(scene.materials.mat_type[m]) == 2}
    assert len(hit - diel) >= 5
    for m in range(9):
        if m in diel:
            assert not g[m].any(), m
        elif m in hit:
            assert g[m].abs().sum() > 0, m


def test_spp_chunked_accum():
    """(e) test_diff.py:643-676: with spp_chunk >= spp the accumulated
    variant is the plain call bit for bit; chunked 2 x 2 its gradient
    matches its own FD (light power, 2% + 1e-4)."""
    scene = build_scene(CORNELL, "cpu")
    cam = scene_camera(CORNELL, 16, 16, "cpu")
    common = (1, 0, 0, 16, 16, 4, 3)
    m0 = scene.materials
    with torch.no_grad():
        plain = render_chunk_diff_fused(m0, scene, cam, *common, rand_seed=11)
        nochunk = render_chunk_diff_fused_accum(m0, scene, cam, *common, rand_seed=11, spp_chunk=4)
        default = render_chunk_diff_fused_accum(m0, scene, cam, *common, rand_seed=11)
    assert torch.equal(plain, nochunk) and torch.equal(plain, default)

    mats, leaves = _leaves(m0)
    render_chunk_diff_fused_accum(mats, scene, cam, *common, rand_seed=11, spp_chunk=2)[..., 1].sum().backward()

    def at(e):
        p = m0.emission_power.clone()
        p[4] += e
        with torch.no_grad():
            out = render_chunk_diff_fused_accum(dataclasses.replace(m0, emission_power=p), scene, cam, *common, rand_seed=11, spp_chunk=2)
        return float(out[..., 1].sum())

    ad, fd = float(leaves["emission_power"].grad[4]), _fd(at, 1e-3)
    assert ad > 0.0 and abs(ad - fd) <= 0.02 * max(abs(ad), abs(fd)) + 1e-4, (ad, fd)


def test_train_step_fused():
    """(f)"""
    scene = build_scene(CORNELL, "cpu")
    # the step descends the un-normalized sum, whose gradient is largest by
    # far along c0 (it multiplies lambda^2 ~ 3e5): one lr for all leaves
    # must keep that step small
    size, spp, bounces, seed, lr = 16, 4, 4, 7, 1e-13
    cam = scene_camera(CORNELL, size, size, "cpu")
    with torch.no_grad():
        target = render_chunk_diff_fused(scene.materials, scene, cam, seed, 0, 0, size, size, spp, bounces) / spp
    truth = trainable_params(scene)
    start = {k: truth[k] for k in ("coeffs", "emission_power")}
    start["coeffs"] = start["coeffs"].clone()
    start["coeffs"][3, 2] += 1.5  # the white wall, as examples/inverse_rendering.py:51

    # the step is p - lr g for the gradient of sum((img - target)^2)
    mats, leaves = _leaves(dataclasses.replace(scene.materials, **start))
    img = render_chunk_diff_fused(mats, scene, cam, seed, 0, 0, size, size, spp, bounces) / spp
    total = torch.sum((img - target) ** 2)
    total.backward()
    new, loss = train_step_fused(start, scene, cam, target, seed, spp, bounces, lr=lr)
    assert set(new) == {"coeffs", "emission_power"}
    assert float(loss) == pytest.approx(float(total.detach()) / (size * size * 3), rel=1e-6)
    assert leaves["coeffs"].grad[3].abs().max() > 0
    for k in new:
        np.testing.assert_allclose(new[k].numpy(), (start[k] - lr * leaves[k].grad).numpy(), rtol=1e-6, atol=1e-7)

    losses = [float(loss)]
    params = new
    for _ in range(2):
        params, loss = train_step_fused(params, scene, cam, target, seed, spp, bounces, lr=lr)
        losses.append(float(loss))
    assert losses[0] > losses[1] > losses[2] > 0, losses
    # a mesh whose extents do not divide the height (16 rows over 3 tiles)
    # or the spp (4 samples over 3) raises before anything is rendered
    for shape in ((3, 1), (1, 3)):
        with pytest.raises(ValueError, match="must divide mesh"):
            train_step_fused(params, scene, cam, target, seed, spp, bounces, mesh=Mesh(*shape, 0, 0, "cpu"))


def test_params_from_numpy_and_apply():
    """The JAX leaves, vertices included, carried by params_from_numpy, and
    an EdgeSet built from numpy arrays."""
    from spectral_tpu_torch.diff import derive_tri_arrays
    from spectral_tpu_torch.diff.vertex_warp import EdgeSet, edges_from_vertices

    jscene = jax_build_scene(CORNELL)
    jmats = jscene.materials
    d = {k: np.asarray(getattr(jmats, k)) for k in ("coeffs", "emission_power", "fuzz", "sellmeier_b", "sellmeier_c")}
    d.update({k: np.asarray(getattr(jscene, k)) for k in ("v0", "v1", "v2")})
    p = params_from_numpy(d, "cpu")
    own = trainable_params(build_scene(CORNELL, "cpu"), include_vertices=True)
    assert set(p) == set(own)
    for k in p:
        assert p[k].dtype == torch.float32
        np.testing.assert_allclose(p[k].numpy(), own[k].numpy(), rtol=1e-6)
    moved = p["v1"] + 1.0
    scene = apply_params(build_scene(CORNELL, "cpu"), dict(p, emission_power=p["emission_power"] * 2, v1=moved))
    assert torch.equal(scene.materials.emission_power, p["emission_power"] * 2)
    assert torch.equal(scene.normal, derive_tri_arrays(p["v0"], moved, p["v2"])["normal"])
    edges = EdgeSet(*(torch.from_numpy(np.concatenate([d[a], d[b], d[c]])) for a, b, c in
                      (("v0", "v1", "v2"), ("v1", "v2", "v0"))))
    for x, y in zip(edges, edges_from_vertices(p["v0"], p["v1"], p["v2"])):
        assert torch.equal(x, y)


def test_residual_matres_overwrites_garbage():
    """(g): paths end early (misses, lights, absorbing metal); every later
    bounce must read 0 even when the buffer held garbage."""
    scene = build_scene(CORNELL, "cpu")
    pack = scene_pack(*pack_scene(scene))
    cam = camera_vector(scene_camera(CORNELL, 8, 8, "cpu"))
    px = torch.arange(8, dtype=torch.float32).repeat(8)
    py = torch.arange(8, dtype=torch.float32).repeat_interleave(8)
    spp, bounces = 2, 6
    out = (
        torch.full((spp, 64), 7.0), torch.full((spp, 64), 7.0),
        torch.full((spp, 7, 64), 7.0), torch.full((spp, bounces, 64), 7, dtype=torch.int32),
    )
    xyz, *res = render_rays_residuals(cam, 3, pack, px, py, spp, bounces, 8, out=out)
    ref_xyz, *ref = render_rays_residuals(cam, 3, pack, px, py, spp, bounces, 8)
    assert all(r is o for r, o in zip(res, out))
    for a, b in zip(res, ref):
        assert torch.equal(a, b)
    assert torch.equal(xyz, ref_xyz) and torch.equal(xyz, render_rays(cam, 3, pack, px, py, spp, bounces, 8))
    m = res[3]
    ended = torch.zeros_like(m[:, 0], dtype=torch.bool)
    n_after = 0
    for b in range(bounces):
        assert (m[:, b][ended] == 0).all()
        n_after += int(ended.sum())
        ended |= m[:, b] <= 0  # a miss (or nothing) ends the path ...
        lights = (m[:, b] == 5)  # ... as does the emissive ceiling (material 4)
        ended |= lights
    assert n_after > 0
    with pytest.raises(ValueError):
        render_rays_residuals(cam, 3, pack, px, py, spp, bounces, 8, out=out[:3] + (out[3].float(),))
