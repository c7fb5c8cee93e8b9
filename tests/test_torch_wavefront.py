"""The port's large-scene renders against the JAX package, on the CPU.

One configuration, the JAX package's own (tests/test_wavefront_sorted.py):
build_tri_field(520, seed=3, glass=True), carried over bit for bit with
scene_from_numpy, Cornell camera, 64x32, 2 spp, 3 bounces, numpy uniform
planes; lit by a gray sky (as tests/test_torch_diff.py does), so that paths
that leave the scene count and the background gradient is not zero. The
JAX side is its BVH megakernel (render_rays_pallas_residuals with its MXU
leaf pack) in interpret mode, stored in tests/torch_jax_refs.npz (case
field_mega) for these inputs. The port's side is
its plain leaf megakernel and its plain sorted scheduler, held bit-equal to
each other. tests/test_torch_wavefront_grad.py holds the sorted scheduler
and the gradients against the JAX sorted scheduler and replay (stored the
same way).

Tolerances, the JAX package's own between its two schedulers
(tests/test_wavefront_sorted.py:70-71, 125-127): image max abs <= 2e-3,
mean <= 2e-5; hero <= 1e-2; power rtol 2e-4 / atol 1e-5; matres and
n_valid equal.

The JAX MXU "quad" leaf sweep scores triangles with leaf-centred quadratic
forms and rounds differently from an exact sweep. On this input it takes
another hit than its own exact dense sweep (spectral_tpu/ops/intersect.py::
nearest_hit) on a few bounce rays (ROADMAP C3): t = 0 re-hits of a
refracting glass face that it misses, and hits at grazing distance. Those
sample-rays are found, each is held to the JAX exact sweep at the bounce
where it departs (the port must agree with that), and their number is
bounded; the comparisons above hold on every other sample-ray and on every
pixel none of whose samples departed.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectral_tpu.ops.intersect import nearest_hit as jax_nearest_hit
from spectral_tpu_torch.diff import render_chunk_diff_fused
from spectral_tpu_torch.models.camera import camera_vector
from spectral_tpu_torch.models.scenes import CORNELL, build_tri_field, scene_camera, scene_from_numpy
from spectral_tpu_torch.ops.cuda import wavefront_kernel
from spectral_tpu_torch.ops.cuda.render_kernel import (
    W,
    hero_curves,
    pack_scene_frame,
    path_xyz,
    render_rays_residuals,
)
from spectral_tpu_torch.ops.cuda.wavefront_kernel import (
    STATE_ROWS,
    bounce_reference,
    camera_bounce_reference,
    integrate_reference,
    render_rays_wavefront,
)
from spectral_tpu_torch.parallel import train_step_fused, trainable_params

import torch_jax_refs as refs

# one torch thread a process: the CPU test run's workers share the cores
torch.set_num_threads(1)

W_PX, H_PX, SPP, BOUNCES = refs.FIELD_W, refs.FIELD_H, refs.FIELD_SPP, refs.FIELD_BOUNCES
N = W_PX * H_PX
# at most this share of sample-rays may take another path than the JAX MXU
# sweep, each one where the JAX exact sweep sides with the port
MAX_DEPARTED = 0.01


def jax_field_inputs():
    """(JAX scene, the inputs of the stored field cases: its arrays, its
    JAX camera vector, planes of seed 5, px, py) of the configuration."""
    jscene = refs.field_scene()
    return jscene, refs.field_inputs(jscene)


def port_field(jscene, planes, px, py):
    """The port's scene (the JAX arrays) and the arguments of its renders,
    its leaf pack from the camera among them."""
    scene = scene_from_numpy(refs.jax_arrays(jscene), "cpu")
    cam = camera_vector(scene_camera(CORNELL, W_PX, H_PX, "cpu"))
    pack = pack_scene_frame(scene, cam)
    args = (cam, 0, pack, torch.from_numpy(px), torch.from_numpy(py), SPP, BOUNCES, W_PX, torch.from_numpy(planes))
    return scene, args


@pytest.fixture(scope="module")
def field():
    """Both packages' leaf megakernel renders of the field on the same
    planes (the JAX one stored), and the port's sorted render."""
    jscene, x = jax_field_inputs()
    ref = refs.outputs("field_mega", x)
    jm = [ref[k] for k in ("xyz", "hero", "n_valid", "power", "matres")]
    scene, args = port_field(jscene, x["planes"], x["px"], x["py"])
    mega = render_rays_residuals(*args)
    sorted_ = render_rays_wavefront(*args, save_residuals=True)
    return dict(jscene=jscene, args=args, mega=mega, sorted=sorted_, jax_mega=jm, departed=departed(mega, jm))


def departed(port, jax_res) -> np.ndarray:
    """bool [spp, N]: sample-rays whose discrete residuals (matres, n_valid)
    or power differ from the JAX ones."""
    mres = (port[4].numpy() != jax_res[4]).any(axis=1)
    nv = port[2].numpy() != jax_res[2]
    pw = ~np.isclose(port[3].numpy(), jax_res[3], rtol=2e-4, atol=1e-5).all(axis=1)
    return mres | nv | pw


def test_port_schedulers_are_bit_equal(field):
    for a, b in zip(field["sorted"], field["mega"]):
        assert torch.equal(a, b)
    assert field["mega"][0].mean() > 0.01 and (field["mega"][4] > 0).any() and (field["mega"][4] == 0).any()


def assert_render_equal(port, jax_res, departed_rays):
    """The tolerances of the module docstring, off the departed sample-rays
    and their pixels."""
    xyz, hero, nv, pw, mres = (x.numpy() for x in port)
    jxyz, jhero, jnv, jpw, jmres = jax_res
    assert jxyz.mean() > 0.01
    keep = ~departed_rays
    assert keep.mean() >= 1.0 - MAX_DEPARTED, keep.mean()
    pixels = keep.all(axis=0)
    d = np.abs(xyz - jxyz)[pixels]
    assert d.max() <= 2e-3, d.max()
    assert d.mean() <= 2e-5, d.mean()
    assert np.abs(hero - jhero).max() <= 1e-2
    np.testing.assert_array_equal(mres.transpose(0, 2, 1)[keep], jmres.transpose(0, 2, 1)[keep])
    np.testing.assert_array_equal(nv[keep], jnv[keep])
    np.testing.assert_allclose(pw.transpose(0, 2, 1)[keep], jpw.transpose(0, 2, 1)[keep], rtol=2e-4, atol=1e-5)


def test_leaf_megakernel_equals_jax(field):
    assert_render_equal(field["mega"], field["jax_mega"], field["departed"])


def test_departed_rays_follow_the_jax_exact_sweep(field):
    """Each sample-ray where the port and the JAX MXU megakernel differ:
    at the first bounce where their material residuals part, the JAX exact
    dense sweep on the port's ray gives the port's residual."""
    departed_rays = field["departed"]
    assert departed_rays.sum() > 0  # the reference-side divergence this file documents
    cam, seed, pack, px, py, spp, bounces, width, rand = field["args"]
    port_m, jax_m = field["mega"][4].numpy(), field["jax_mega"][4]
    # the port's rays before each bounce, in original order (no sort)
    state = torch.empty((STATE_ROWS, spp * N))
    camera_bounce_reference(cam, seed, pack, px, py, spp, bounces, width, rand, state)
    rays = {1: state[0:6].clone()}
    orig = torch.arange(spp * N, dtype=torch.int32)
    for b in range(1, bounces - 1):
        bounce_reference(seed, pack, px, py, spp, bounces, b, width, rand, state, orig)
        rays[b + 1] = state[0:6].clone()
    checked = 0
    mat_index = np.asarray(field["jscene"].mat_index)
    for s, p in zip(*np.nonzero(departed_rays)):
        differ = np.nonzero(port_m[s, :, p] != jax_m[s, :, p])[0]
        if differ.size == 0:
            continue  # n_valid or power only: its hits agree
        b = int(differ[0])
        assert b >= 1, "camera rays agree"
        ray = rays[b][:, s * N + p].numpy()
        rec = jax_nearest_hit(jnp.asarray(ray[None, 0:3]), jnp.asarray(ray[None, 3:6]), field["jscene"])
        exact = int(mat_index[int(rec.tri_index[0])]) + 1 if bool(rec.hit[0]) else -1
        assert exact == port_m[s, b, p], (s, b, p, exact, port_m[s, :, p], jax_m[s, :, p])
        checked += 1
    assert checked > 0


def _per_ray_then_ascending_sum(tables, state, orig, n, spp):
    """The integrate step as two passes: each sample-ray's XYZ written at
    its original index, then the samples added in ascending order from 0."""
    o = orig.long()
    nv = torch.where(state[7] > 0.0, 0.0, state[8])
    _, cell, frac, _, _ = hero_curves(state[6], tables)
    xyz_rays = torch.empty((spp * n, 3))
    xyz_rays[o] = torch.stack(path_xyz([state[10 + w] for w in range(W)], nv, cell, frac, tables), dim=1)
    per_sample = xyz_rays.reshape(spp, n, 3)
    xyz = torch.zeros((n, 3))
    for s in range(spp):
        xyz = xyz + per_sample[s]
    return xyz


def test_integrate_step_equals_per_ray_then_ascending_sum(field):
    """The plain integrate step, which sums each pixel's slots as the kernel
    does, gives the two-pass sum bit for bit on the field's final sorted
    state, and the sorted render's xyz is that sum."""
    finals = []

    def integrate(tables, state, orig, n, spp, pixel_xyz, *res):
        integrate_reference(tables, state, orig, n, spp, pixel_xyz, *res)
        finals.append((tables, state.clone(), orig.clone(), n, spp, pixel_xyz.clone()))

    xyz = wavefront_kernel._wavefront(
        (camera_bounce_reference, bounce_reference, integrate), *field["args"], False,
        (None, None, None, None), None,
    )
    (tables, state, orig, n, spp, pixel_xyz), = finals
    assert torch.equal(pixel_xyz, _per_ray_then_ascending_sum(tables, state, orig, n, spp))
    assert torch.equal(xyz, pixel_xyz) and torch.equal(xyz, field["sorted"][0])
    assert not torch.equal(orig, torch.arange(spp * n, dtype=torch.int32))  # the state was sorted


def test_train_step_on_field_lowers_the_loss():
    scene = build_tri_field(520, 3, device="cpu")
    w, h, spp, bounces, seed = 32, 16, 4, 4, 7
    lr = 1e-13 * 256 / (w * h)
    cam = scene_camera(CORNELL, w, h, "cpu")
    with torch.no_grad():
        target = render_chunk_diff_fused(scene.materials, scene, cam, seed, 0, 0, w, h, spp, bounces) / spp
    params = {k: v.clone() for k, v in trainable_params(scene).items() if k in ("coeffs", "emission_power")}
    params["coeffs"][0, 2] += 1.5  # the white of walls and boxes
    new, loss0 = train_step_fused(params, scene, cam, target, seed, spp, bounces, lr=lr)
    _, loss1 = train_step_fused(new, scene, cam, target, seed, spp, bounces, lr=lr)
    assert float(loss1) < float(loss0), (float(loss0), float(loss1))
    assert not torch.equal(new["coeffs"], params["coeffs"])
