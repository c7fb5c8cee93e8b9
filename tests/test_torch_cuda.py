"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one: a CUDA kernel has no CPU mode. The file imports no JAX, so it runs on
a GPU machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(--noconftest: tests/conftest.py clears JAX caches after each module.)
Kernel and plain version compute the same float32 operations in the same
order (ops/fp32.py), so discrete outputs must be equal and the rendered
XYZ within the render tolerance of tests/test_torch_render.py. The replay
kernel sums its gradients over rays in another order than the plain
version: per column within 2e-4 of the column's largest value, as in
tests/test_torch_grad.py, and bit-identical between two of its launches.
The large-scene kernels (the leaf megakernel, forward and residual, and
the sorted scheduler's three kernels) run on build_tri_field(520, seed=3,
glass=True) against their plain versions, and against each other: the
two schedulers share one source of path arithmetic and give equal paths.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from spectral_tpu_torch.diff import render_chunk_diff_fused
from spectral_tpu_torch.models.camera import camera_vector
from spectral_tpu_torch.models.scenes import CORNELL, PRISM, TRIS, build_scene, build_tri_field, scene_camera
from spectral_tpu_torch.ops.cuda import build
from spectral_tpu_torch.ops.cuda.grad_kernel import render_grads, render_grads_reference
from spectral_tpu_torch.ops.cuda.intersect_kernel import intersect, pack_tris
from spectral_tpu_torch.ops.cuda.render_kernel import (
    n_uniforms,
    order_leaves_near_to_far,
    pack_scene,
    pack_scene_auto,
    pack_scene_leaves,
    render_rays,
    render_rays_reference,
    render_rays_residuals,
)
from spectral_tpu_torch.ops.cuda.wavefront_kernel import render_rays_wavefront, render_rays_wavefront_reference
from spectral_tpu_torch.parallel import train_step_fused, trainable_params
from spectral_tpu_torch.ops.intersect import nearest_hit


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_intersect_kernel_equals_plain(cuda_device):
    rng = np.random.default_rng(7)
    n = 1 << 16
    o = rng.uniform([20.0, 20.0, -400.0], [535.0, 535.0, 535.0], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    tri = pack_tris(build_scene(CORNELL, cuda_device))
    o, d = torch.from_numpy(o).to(cuda_device), torch.from_numpy(d).to(cuda_device)
    before = build.INTERSECT.launches
    got = intersect(o, d, tri)
    torch.cuda.synchronize()
    assert build.INTERSECT.launches == before + 1
    ref = nearest_hit(o, d, tri)
    for a, b in zip(got[1:], ref[1:]):
        assert torch.equal(a, b)
    torch.testing.assert_close(got[0], ref[0], rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("scene_id", (CORNELL, PRISM, TRIS))
@pytest.mark.parametrize("injected", (True, False), ids=("planes", "hash"))
def test_render_kernel_equals_plain(cuda_device, scene_id, injected):
    w = h = 32
    spp, bounces = 4, 5
    scene = build_scene(scene_id, cuda_device)
    tri, mat, tab = pack_scene(scene)
    cam = camera_vector(scene_camera(scene_id, w, h, cuda_device))
    px = (torch.arange(w * h, device=cuda_device) % w).float()
    py = (torch.arange(w * h, device=cuda_device) // w).float()
    rand = None
    if injected:
        planes = np.random.default_rng(scene_id).uniform(size=(spp, n_uniforms(bounces), w * h))
        rand = torch.from_numpy(planes.astype(np.float32)).to(cuda_device)
    steps = torch.zeros(w * h, dtype=torch.int32, device=cuda_device)
    ref_steps = torch.zeros_like(steps)
    before = build.RENDER.launches
    got = render_rays(cam, 1984, tri, mat, tab, px, py, spp, bounces, w, rand, steps)
    torch.cuda.synchronize()
    assert build.RENDER.launches == before + 1
    ref = render_rays_reference(cam, 1984, tri, mat, tab, px, py, spp, bounces, w, rand, ref_steps)
    assert torch.equal(steps, ref_steps)
    err = (got - ref).abs()
    assert (err <= 2e-3 + 1e-5 * ref.abs()).all(), err.max().item()
    assert err.mean().item() <= 2e-5
    assert ref.sum().item() > 0


# The dense megakernel regenerates: a lane starts its next sample as soon as
# its path ends, so the lanes of a warp sit at different samples and
# bounces; the forward form also runs a persistent grid whose lanes take
# whole pixels from a counter. Its edges: one sample, one bounce, a ragged
# last warp and block (1000 rays), PRISM's glass and diffuse paths of very
# different lengths in one warp; forward and residual form (into
# garbage-filled buffers), each bit-equal to the plain version.
_EDGES = {
    "spp1": (CORNELL, 32, 32, 1, 5, True),
    "bounces1": (CORNELL, 32, 32, 4, 1, False),
    "ragged": (TRIS, 40, 25, 3, 5, False),
    "prism": (PRISM, 32, 32, 8, 10, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("residual", (False, True), ids=("forward", "residual"))
@pytest.mark.parametrize("case", sorted(_EDGES))
def test_dense_kernel_edges_bit_equal(cuda_device, case, residual):
    scene_id, w, h, spp, bounces, injected = _EDGES[case]
    n = w * h
    tri, mat, tab = pack_scene(build_scene(scene_id, cuda_device))
    cam = camera_vector(scene_camera(scene_id, w, h, cuda_device))
    px = (torch.arange(n, device=cuda_device) % w).float()
    py = (torch.arange(n, device=cuda_device) // w).float()
    rand = None
    if injected:
        planes = np.random.default_rng(scene_id + 40).uniform(size=(spp, n_uniforms(bounces), n))
        rand = torch.from_numpy(planes.astype(np.float32)).to(cuda_device)
    args = (cam, 1984, tri, mat, tab, px, py, spp, bounces, w, rand)
    steps = [torch.full((n,), -1, dtype=torch.int32, device=cuda_device) for _ in range(2)]
    warps = torch.full((-(-n // 32),), -1, dtype=torch.int32, device=cuda_device)
    if residual:
        got = render_rays_residuals(*args, steps[0], out=_garbage(spp, bounces, n, cuda_device), warp_steps=warps)
    else:
        got = (render_rays(*args, steps[0], warp_steps=warps),)
    torch.cuda.synchronize()
    ref = render_rays_reference(*args, steps[1], residuals=residual)
    ref = ref if residual else (ref,)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert torch.equal(steps[0], steps[1])
    assert ref[0].sum().item() > 0
    live = steps[0].to(torch.int64)
    if residual:
        # regeneration on a grid of one warp per 32 rays: a warp sweeps as
        # often as its busiest lane has live ray-steps
        busiest = torch.nn.functional.pad(live, (0, 32 * warps.numel() - n)).reshape(-1, 32).amax(dim=1)
        assert torch.equal(warps.to(torch.int64), busiest)
    else:
        # the persistent grid: at most 32 live ray-steps a sweep
        assert int(warps.min()) >= 0 and int(live.sum()) <= 32 * int(warps.sum())


def _columns_close(got, ref, rel=2e-4):
    got, ref = got.double().reshape(ref.shape[0], -1), ref.double().reshape(ref.shape[0], -1)
    for j in range(ref.shape[1]):
        assert (got[:, j] - ref[:, j]).abs().max() <= rel * ref[:, j].abs().max(), j


@pytest.mark.cuda
@pytest.mark.parametrize("scene_id", (CORNELL, PRISM, TRIS))
@pytest.mark.parametrize("injected", (True, False), ids=("planes", "hash"))
def test_residual_and_replay_kernels_equal_plain(cuda_device, scene_id, injected):
    w = h = 32
    spp, bounces = 4, 5
    n = w * h
    tri, mat, tab = pack_scene(build_scene(scene_id, cuda_device))
    cam = camera_vector(scene_camera(scene_id, w, h, cuda_device))
    px = (torch.arange(n, device=cuda_device) % w).float()
    py = (torch.arange(n, device=cuda_device) // w).float()
    rand = None
    if injected:
        planes = np.random.default_rng(scene_id).uniform(size=(spp, n_uniforms(bounces), n))
        rand = torch.from_numpy(planes.astype(np.float32)).to(cuda_device)
    # garbage in every residual buffer: the kernel must write each element
    out = (
        torch.full((spp, n), 7.0, device=cuda_device), torch.full((spp, n), 7.0, device=cuda_device),
        torch.full((spp, 7, n), 7.0, device=cuda_device),
        torch.full((spp, bounces, n), 7, dtype=torch.int32, device=cuda_device),
    )
    before = build.RENDER_RESIDUALS.launches
    xyz, *res = render_rays_residuals(cam, 1984, tri, mat, tab, px, py, spp, bounces, w, rand, out=out)
    torch.cuda.synchronize()
    assert build.RENDER_RESIDUALS.launches == before + 1
    fwd = render_rays(cam, 1984, tri, mat, tab, px, py, spp, bounces, w, rand)
    assert torch.equal(xyz, fwd)
    ref_xyz, *ref = render_rays_reference(cam, 1984, tri, mat, tab, px, py, spp, bounces, w, rand, residuals=True)
    for k in (0, 1, 3):
        assert torch.equal(res[k], ref[k]), k
    torch.testing.assert_close(res[2], ref[2], rtol=2e-4, atol=1e-5)
    assert ((xyz - ref_xyz).abs() <= 2e-3 + 1e-5 * ref_xyz.abs()).all()
    assert (res[3] == 0).any() and (res[3] == -1).any()

    g = torch.from_numpy(np.random.default_rng(5).normal(size=(n, 3)).astype(np.float32)).to(cuda_device)
    sell = scene_id == PRISM
    before = build.GRAD.launches
    got = render_grads(mat, tab, g, *res, spp, bounces, want_bg_grads=True, want_sellmeier=sell)
    again = render_grads(mat, tab, g, *res, spp, bounces, want_bg_grads=True, want_sellmeier=sell)
    torch.cuda.synchronize()
    assert build.GRAD.launches == before + 2
    for a, b in zip(got, again):
        assert torch.equal(a, b)  # deterministic reduction
    want = render_grads_reference(mat, tab, g, *res, spp, bounces, want_bg_grads=True, want_sellmeier=sell)
    assert len(got) == len(want) == (5 if sell else 3)
    _columns_close(got[0], want[0])
    _columns_close(got[1][:, None], want[1][:, None])
    _columns_close(got[2][:, None], want[2][:, None])
    for a, b in zip(got[3:], want[3:]):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=1e-6 * float(b.abs().max()))
    assert got[0].abs().sum() > 0


@pytest.mark.cuda
def test_fused_train_step_on_card(cuda_device):
    scene = build_scene(CORNELL, cuda_device)
    size, spp, bounces, seed, lr = 32, 4, 4, 7, 1e-13 * 256 / (32 * 32)
    cam = scene_camera(CORNELL, size, size, cuda_device)
    with torch.no_grad():
        target = render_chunk_diff_fused(scene.materials, scene, cam, seed, 0, 0, size, size, spp, bounces) / spp
    params = {k: v.clone() for k, v in trainable_params(scene).items() if k in ("coeffs", "emission_power")}
    params["coeffs"][3, 2] += 1.5
    before = (build.RENDER_RESIDUALS.launches, build.GRAD.launches)
    losses = []
    for _ in range(3):
        params, loss = train_step_fused(params, scene, cam, target, seed, spp, bounces, lr=lr)
        losses.append(float(loss))
    assert (build.RENDER_RESIDUALS.launches, build.GRAD.launches) == (before[0] + 3, before[1] + 3)
    assert losses[0] > losses[1] > losses[2], losses
    assert all(torch.isfinite(v).all() for v in params.values())


def _garbage(spp, bounces, n, dev):
    """Residual buffers filled with 7s: the kernels must write every element."""
    return (
        torch.full((spp, n), 7.0, device=dev), torch.full((spp, n), 7.0, device=dev),
        torch.full((spp, 7, n), 7.0, device=dev), torch.full((spp, bounces, n), 7, dtype=torch.int32, device=dev),
    )


def _field_case(dev, injected, w=64, h=32, spp=4, bounces=5):
    scene = build_tri_field(520, seed=3, glass=True, device=dev)
    cam = camera_vector(scene_camera(CORNELL, w, h, dev))
    tri, mat, tab, leaf = pack_scene_auto(scene, cam)
    px = (torch.arange(w * h, device=dev) % w).float()
    py = (torch.arange(w * h, device=dev) // w).float()
    rand = None
    if injected:
        planes = np.random.default_rng(11).uniform(size=(spp, n_uniforms(bounces), w * h))
        rand = torch.from_numpy(planes.astype(np.float32)).to(dev)
    return (cam, 1984, tri, mat, tab, px, py, spp, bounces, w, rand), leaf


def _assert_residuals_equal(got, ref):
    """xyz within the render tolerance, hero, n_valid and matres equal,
    power at rtol 2e-4 / atol 1e-5."""
    xyz, *res = got
    ref_xyz, *ref_res = ref
    for k in (0, 1, 3):
        assert torch.equal(res[k], ref_res[k]), k
    torch.testing.assert_close(res[2], ref_res[2], rtol=2e-4, atol=1e-5)
    assert ((xyz - ref_xyz).abs() <= 2e-3 + 1e-5 * ref_xyz.abs()).all()
    assert (xyz - ref_xyz).abs().mean().item() <= 2e-5
    assert ref_xyz.sum().item() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("injected", (True, False), ids=("planes", "hash"))
def test_leaf_megakernel_equals_plain(cuda_device, injected):
    args, leaf = _field_case(cuda_device, injected)
    n, spp, bounces = args[5].numel(), args[7], args[8]
    counts = [torch.zeros(n, dtype=torch.int32, device=cuda_device) for _ in range(8)]
    before = (build.RENDER_LEAVES.launches, build.RENDER_LEAVES_RESIDUALS.launches)
    fwd = render_rays(*args, counts[0], leaf_pack=leaf, visits=counts[1], group_visits=counts[2],
                      super_visits=counts[3])
    got = render_rays_residuals(*args, out=_garbage(spp, bounces, n, cuda_device), leaf_pack=leaf)
    torch.cuda.synchronize()
    assert (build.RENDER_LEAVES.launches, build.RENDER_LEAVES_RESIDUALS.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got[0], fwd)
    ref = render_rays_reference(*args, counts[4], residuals=True, leaf_pack=leaf, visits=counts[5],
                                group_visits=counts[6], super_visits=counts[7])
    for k in range(4):  # live ray-steps, leaves, groups and super-groups entered
        assert torch.equal(counts[k], counts[4 + k]), k
    assert int(counts[3].sum()) > 0
    _assert_residuals_equal(got, ref)
    assert (got[4] == 0).any() and (got[4] == -1).any()


@pytest.mark.cuda
@pytest.mark.parametrize("injected", (True, False), ids=("planes", "hash"))
def test_sorted_scheduler_equals_plain_and_megakernel(cuda_device, injected):
    args, leaf = _field_case(cuda_device, injected)
    cam, seed, tri, mat, tab, px, py, spp, bounces, w, rand = args
    n = px.numel()
    wf_args = (cam, seed, tri, mat, tab, leaf, px, py, spp, bounces, w, rand)
    counts = [torch.zeros((spp, n), dtype=torch.int32, device=cuda_device) for _ in range(8)]
    kernels = (build.WAVEFRONT_CAMERA, build.WAVEFRONT_BOUNCE, build.WAVEFRONT_INTEGRATE)
    before = [k.launches for k in kernels]
    got = render_rays_wavefront(
        *wf_args, save_residuals=True, steps=counts[0], visits=counts[1], out=_garbage(spp, bounces, n, cuda_device),
        group_visits=counts[2], super_visits=counts[3],
    )
    fwd = render_rays_wavefront(*wf_args)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [2, 2 * (bounces - 1), 2]
    assert torch.equal(got[0], fwd)
    ref = render_rays_wavefront_reference(
        *wf_args, save_residuals=True, steps=counts[4], visits=counts[5], group_visits=counts[6],
        super_visits=counts[7],
    )
    for k in range(4):  # live ray-steps, leaves, groups and super-groups entered
        assert torch.equal(counts[k], counts[4 + k]), k
    assert int(counts[3].sum()) > 0
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    _assert_residuals_equal(got, ref)
    # one source of path arithmetic: the same paths as the leaf megakernel
    mega = render_rays_residuals(*args, leaf_pack=leaf)
    for a, b in zip(got, mega):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_leaf_kernels_on_morton_pack_equal_plain(cuda_device):
    """The Morton-ordered pack of pack_scene_leaves, whose last group and
    super-group are ragged (33 leaves of 16: groups of 8, 8, 8, 8 and 1):
    both leaf sweeps and their counts of boxes entered equal the plain
    versions'."""
    args, _ = _field_case(cuda_device, injected=False)
    tri, _, _, leaf = pack_scene_leaves(build_tri_field(520, seed=3, glass=True, device=cuda_device), leaf_size=16)
    args = (*args[:2], tri, *args[3:])
    cam, seed, tri, mat, tab, px, py, spp, bounces, w, rand = args
    n = px.numel()
    wf_args = (cam, seed, tri, mat, tab, leaf, px, py, spp, bounces, w, rand)
    counts = [torch.zeros((spp, n), dtype=torch.int32, device=cuda_device) for _ in range(6)]
    got = render_rays_wavefront(*wf_args, save_residuals=True, visits=counts[0], group_visits=counts[1],
                                super_visits=counts[2])
    ref = render_rays_wavefront_reference(*wf_args, save_residuals=True, visits=counts[3], group_visits=counts[4],
                                          super_visits=counts[5])
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    for k in range(3):
        assert torch.equal(counts[k], counts[3 + k]), k
    mega = [torch.zeros(n, dtype=torch.int32, device=cuda_device) for _ in range(3)]
    xyz = render_rays(*args, leaf_pack=leaf, visits=mega[0], group_visits=mega[1], super_visits=mega[2])
    assert torch.equal(xyz, got[0])
    for k in range(3):
        assert torch.equal(mega[k], counts[k].sum(0)), k


@pytest.mark.cuda
def test_leaf_megakernel_on_cornell_equals_dense(cuda_device):
    w = h = 32
    spp, bounces = 4, 5
    scene = build_scene(CORNELL, cuda_device)
    cam = camera_vector(scene_camera(CORNELL, w, h, cuda_device))
    px = (torch.arange(w * h, device=cuda_device) % w).float()
    py = (torch.arange(w * h, device=cuda_device) // w).float()
    tri, mat, tab, leaf = pack_scene_leaves(scene, leaf_size=8)
    tri, leaf = order_leaves_near_to_far(tri, leaf, cam[0:3])
    args = (cam, 1984, tri, mat, tab, px, py, spp, bounces, w, None)
    dense = render_rays_residuals(cam, 1984, *pack_scene(scene), px, py, spp, bounces, w, None)
    _assert_residuals_equal(render_rays_residuals(*args, leaf_pack=leaf), dense)


@pytest.mark.cuda
def test_field_train_step_on_card(cuda_device):
    scene = build_tri_field(520, seed=3, device=cuda_device)
    w, h, spp, bounces, seed, lr = 32, 16, 4, 4, 7, 1e-13 * 256 / (32 * 16)
    cam = scene_camera(CORNELL, w, h, cuda_device)
    with torch.no_grad():
        target = render_chunk_diff_fused(scene.materials, scene, cam, seed, 0, 0, w, h, spp, bounces) / spp
    params = {k: v.clone() for k, v in trainable_params(scene).items() if k in ("coeffs", "emission_power")}
    params["coeffs"][0, 2] += 1.5  # the white of walls and boxes
    kernels = (build.WAVEFRONT_CAMERA, build.WAVEFRONT_BOUNCE, build.WAVEFRONT_INTEGRATE, build.GRAD)
    before = [k.launches for k in kernels]
    losses = []
    for _ in range(3):
        params, loss = train_step_fused(params, scene, cam, target, seed, spp, bounces, lr=lr)
        losses.append(float(loss))
    assert [k.launches - b for k, b in zip(kernels, before)] == [3, 3 * (bounces - 1), 3, 3]
    assert losses[0] > losses[1] > losses[2], losses
    assert all(torch.isfinite(v).all() for v in params.values())
