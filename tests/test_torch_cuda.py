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
The intersect kernel takes any number of triangles, in tiles, and the
XLA-style renderer's dot order; that renderer selects its nearest hits
with it, and its render equals the one whose selection is the plain
version's, warped gradients included. Two gloo ranks that share the card
render a sharded image (parallel/render.py) equal to its composition.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from spectral_tpu_torch.config import RenderParams
from spectral_tpu_torch.diff import render_chunk_diff_fused
from spectral_tpu_torch.models.camera import camera_vector, make_camera
from spectral_tpu_torch.models.scenes import CORNELL, PRISM, TRIS, build_scene, build_tri_field, scene_camera
from spectral_tpu_torch.ops.cuda import build
from spectral_tpu_torch.ops.cuda.grad_kernel import launch_shape, render_grads, render_grads_reference
from spectral_tpu_torch.ops.cuda import wavefront_kernel
from spectral_tpu_torch.ops.cuda.intersect_kernel import MAX_TRIS, intersect, pack_tris
from spectral_tpu_torch.ops.cuda.render_kernel import (
    LEAF_PACKS,
    n_uniforms,
    order_leaves_near_to_far,
    pack_scene,
    pack_scene_frame,
    pack_scene_leaves,
    render_rays,
    render_rays_reference,
    render_rays_residuals,
    scene_pack,
)
from spectral_tpu_torch.ops.cuda.wavefront_kernel import (
    STATE_ROWS,
    render_rays_wavefront,
    render_rays_wavefront_reference,
)
from spectral_tpu_torch.parallel import train_step_fused, trainable_params
from spectral_tpu_torch.ops.intersect import nearest_hit
from spectral_tpu_torch.runtime.render_manager import RenderManager


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
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def _tri_pack(n_tris: int, dev) -> torch.Tensor:
    """n_tris packed triangles: CORNELL's first ones, or past its 42 a
    1008-triangle field's first ones (a larger field's past 1008)."""
    if n_tris <= 42:
        return pack_tris(build_scene(CORNELL, dev))[:n_tris].contiguous()
    field = pack_tris(build_tri_field(max(1000, n_tris), seed=3, device=dev))
    return field[:n_tris].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("n_tris", (1, 42, MAX_TRIS))
@pytest.mark.parametrize("n", (1, 127, 129, 360_000))
def test_intersect_kernel_shapes_bit_equal(cuda_device, n, n_tris):
    """Every output of the intersect kernel equal to the plain version's, at
    ray counts around a block's rays and at the default frame's, and from
    one triangle to a whole tile of the pack (MAX_TRIS)."""
    rng = np.random.default_rng(n + n_tris)
    o = rng.uniform([20.0, 20.0, -400.0], [535.0, 535.0, 535.0], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    o, d = torch.from_numpy(o).to(cuda_device), torch.from_numpy(d).to(cuda_device)
    tri = _tri_pack(n_tris, cuda_device)
    assert tri.shape[0] == n_tris
    before = build.INTERSECT.launches
    got = intersect(o, d, tri)
    torch.cuda.synchronize()
    assert build.INTERSECT.launches == before + 1
    ref = nearest_hit(o, d, tri)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    if n > 1:
        assert ref[2].any()


@pytest.mark.cuda
@pytest.mark.parametrize("n_tris", (MAX_TRIS + 1, 2000))
@pytest.mark.parametrize("n", (1, 129, 65_536))
def test_intersect_kernel_tiles_bit_equal(cuda_device, n, n_tris):
    """Past one tile (769 and 2,000 triangles: the pack streams through
    shared memory in tiles of MAX_TRIS), every output equal to the plain
    version's. (The plain version's [N, T] float64 tensors bound N here.)"""
    rng = np.random.default_rng(n + n_tris)
    o = rng.uniform([20.0, 20.0, -400.0], [535.0, 535.0, 535.0], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    o, d = torch.from_numpy(o).to(cuda_device), torch.from_numpy(d).to(cuda_device)
    tri = _tri_pack(n_tris, cuda_device)
    assert tri.shape[0] == n_tris
    before = build.INTERSECT.launches
    got = intersect(o, d, tri)
    torch.cuda.synchronize()
    assert build.INTERSECT.launches == before + 1
    ref = nearest_hit(o, d, tri)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    if n > 1:
        assert ref[2].any()
    if n >= 65_536:
        assert (ref[1] >= MAX_TRIS).any()  # hits past the first tile


@pytest.mark.cuda
@pytest.mark.parametrize("n_tris", (42, MAX_TRIS + 1, 2000))
@pytest.mark.parametrize("n", (129, 65_536))
def test_intersect_kernel_xla_order_bit_equal(cuda_device, n, n_tris):
    """The kernel with the XLA-style renderer's dot order (xla=True) equal
    to the plain version in that order, over one tile and several."""
    rng = np.random.default_rng(n + 7 * n_tris)
    o = rng.uniform([20.0, 20.0, -400.0], [535.0, 535.0, 535.0], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    o, d = torch.from_numpy(o).to(cuda_device), torch.from_numpy(d).to(cuda_device)
    tri = _tri_pack(n_tris, cuda_device)
    got = intersect(o, d, tri, xla=True)
    ref = nearest_hit(o, d, tri, xla=True)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert ref[2].any()


@pytest.mark.cuda
@pytest.mark.parametrize("scene_id", (CORNELL, PRISM))
def test_xla_render_selects_with_the_intersect_kernel(cuda_device, scene_id):
    """The XLA-style render launches the intersect kernel once a bounce and
    pass of samples, and equals the render whose selection is the plain
    version's; render_chunk_diff's backward (that render's VJP) is finite."""
    import dataclasses

    from spectral_tpu_torch.diff import render_chunk_diff
    from spectral_tpu_torch.render import wavefront

    scene = build_scene(scene_id, cuda_device)
    cam = scene_camera(scene_id, 32, 32, cuda_device)
    spp, bounces = 4, 5
    before = build.INTERSECT.launches
    with torch.no_grad():
        got = wavefront.render_chunk(scene, cam, 3, 0, 0, 32, 16, spp, bounces)
        torch.cuda.synchronize()
        passes = -(-spp // wavefront.samples_per_pass(32 * 16, spp))
        assert build.INTERSECT.launches == before + passes * bounces
        plain = wavefront.render_chunk(
            scene, cam, 3, 0, 0, 32, 16, spp, bounces, select=lambda o, d, t: nearest_hit(o, d, t, xla=True)
        )
    assert torch.equal(got, plain) and got.max() > 0
    coeffs = scene.materials.coeffs.clone().requires_grad_(True)
    mats = dataclasses.replace(scene.materials, coeffs=coeffs)
    out = render_chunk_diff(mats, scene, cam, 3, 0, 0, 32, 16, spp, bounces)
    out[..., 1].sum().backward()
    assert torch.isfinite(coeffs.grad).all() and coeffs.grad.abs().max() > 0


def _warped_gradient(dev, case: str, select=None):
    """d(sum Y)/d(th) of a warped render with the moving triangles at x
    offset th = 0.1: the shadow scene of examples/inverse_geometry.py at its
    shape (16x16, 8 spp, 3 bounces), or the all-diffuse 520-triangle field
    with every box moving (a 32x16 crop of its 64x64 frame, 2 spp, 3
    bounces)."""
    from spectral_tpu_torch.diff import scene_with_vertices
    from spectral_tpu_torch.diff.vertex_warp import edges_from_vertices
    from spectral_tpu_torch.examples import inverse_geometry
    from spectral_tpu_torch.models.scenes import build_diffuse_field
    from spectral_tpu_torch.render import wavefront

    if case == "shadow":
        scene, cam = inverse_geometry.build(dev)
        first, frame, spp = inverse_geometry.FIRST_OCCLUDER_TRI, (0, 0, 16, 16), 8
    else:
        scene, cam = build_diffuse_field(520, 0, dev), scene_camera(CORNELL, 64, 64, dev)
        first, frame, spp = 12, (16, 24, 32, 16), 2
    move = (torch.arange(scene.num_tris, device=dev) >= first).float()[:, None] * torch.tensor([1.0, 0.0, 0.0],
                                                                                             device=dev)
    th = torch.tensor(0.1, device=dev, requires_grad=True)
    vs = [getattr(scene, k) + th * move for k in ("v0", "v1", "v2")]
    out = wavefront.render_chunk(scene_with_vertices(scene, *vs), cam, 9, *frame, spp, 3,
                                 vertex_warp=edges_from_vertices(*vs), select=select)
    (g,) = torch.autograd.grad(out[..., 1].sum(), th)
    return out.detach(), g


@pytest.mark.cuda
@pytest.mark.parametrize("case", ("shadow", "field"))
def test_warped_gradient_selects_with_the_intersect_kernel(cuda_device, case):
    """A warped vertex gradient with the intersect kernel selecting (twice
    a pass of samples and bounce: the forward and the checkpoint's
    recompute) equals, bit for bit, the same gradient with the plain
    selection (deterministic algorithms on: the backward's index sums
    otherwise accumulate in any order)."""
    from spectral_tpu_torch.render import wavefront

    torch.use_deterministic_algorithms(True)
    try:
        before = build.INTERSECT.launches
        out, g = _warped_gradient(cuda_device, case)
        torch.cuda.synchronize()
        spp, n = (8, 16 * 16) if case == "shadow" else (2, 32 * 16)
        assert build.INTERSECT.launches == before + 2 * -(-spp // wavefront.samples_per_pass(n, spp)) * 3
        plain_out, plain_g = _warped_gradient(cuda_device, case, lambda o, d, t: nearest_hit(o, d, t, xla=True))
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(out, plain_out) and out.max() > 0
    assert torch.equal(g, plain_g) and torch.isfinite(g) and float(g) != 0.0


def _final_state(n: int, spp: int, dev, seed: int):
    """A ray state after the last bounce, in a random sorted order: heroes
    over the whole band, ended and unended paths, n_valid 0-7, powers of
    both signs' magnitudes; and its orig."""
    rng = np.random.default_rng(seed)
    nrays = n * spp
    st = np.zeros((STATE_ROWS, nrays), np.float32)
    st[0:6] = rng.normal(size=(6, nrays))
    st[6] = rng.uniform(360.0, 830.0, nrays)
    st[7] = rng.uniform(size=nrays) < 0.2
    st[8] = rng.integers(0, 8, nrays)
    st[9] = -1.0
    st[10:] = rng.lognormal(0.0, 2.0, (7, nrays))
    orig = rng.permutation(nrays).astype(np.int32)
    return torch.from_numpy(st).to(dev), torch.from_numpy(orig).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("residual", (False, True), ids=("forward", "residual"))
@pytest.mark.parametrize("n", (1000, 100_003))
@pytest.mark.parametrize("spp", (1, 3, 4))
def test_integrate_step_bit_equal(cuda_device, spp, n, residual):
    """The integrate step (each sample-ray's XYZ into its slot, then each
    pixel's slots summed) against its plain version on a synthetic final
    state in a random sorted order, at pixel counts that are no multiple of
    a block, forward and residual (into garbage-filled buffers); twice in a
    row bit-identical, one launch count a step."""
    state, orig = _final_state(n, spp, cuda_device, seed=spp * n)
    tab = pack_scene(build_scene(CORNELL, cuda_device))[2]

    def outputs():
        xyz = torch.full((n, 3), 7.0, device=cuda_device)
        res = _garbage(spp, 1, n, cuda_device)[:3] if residual else ()
        return xyz, res

    xyz, res = outputs()
    before = build.WAVEFRONT_INTEGRATE.launches
    wavefront_kernel._launch_integrate(tab, state, orig, n, spp, xyz, *res)
    again, res_again = outputs()
    wavefront_kernel._launch_integrate(tab, state, orig, n, spp, again, *res_again)
    torch.cuda.synchronize()
    assert build.WAVEFRONT_INTEGRATE.launches == before + 2
    ref, ref_res = outputs()
    wavefront_kernel.integrate_reference(tab, state, orig, n, spp, ref, *ref_res)
    assert torch.equal(xyz, ref) and torch.equal(again, ref)
    for a, b, c in zip(res, res_again, ref_res):
        assert torch.equal(a, c) and torch.equal(b, c)
    assert float(ref.abs().sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("scene_id", (CORNELL, PRISM, TRIS))
@pytest.mark.parametrize("injected", (True, False), ids=("planes", "hash"))
def test_render_kernel_equals_plain(cuda_device, scene_id, injected):
    w = h = 32
    spp, bounces = 4, 5
    scene = build_scene(scene_id, cuda_device)
    pack = scene_pack(*pack_scene(scene))
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
    got = render_rays(cam, 1984, pack, px, py, spp, bounces, w, rand, steps)
    torch.cuda.synchronize()
    assert build.RENDER.launches == before + 1
    ref = render_rays_reference(cam, 1984, pack, px, py, spp, bounces, w, rand, ref_steps)
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
    pack = scene_pack(*pack_scene(build_scene(scene_id, cuda_device)))
    cam = camera_vector(scene_camera(scene_id, w, h, cuda_device))
    px = (torch.arange(n, device=cuda_device) % w).float()
    py = (torch.arange(n, device=cuda_device) // w).float()
    rand = None
    if injected:
        planes = np.random.default_rng(scene_id + 40).uniform(size=(spp, n_uniforms(bounces), n))
        rand = torch.from_numpy(planes.astype(np.float32)).to(cuda_device)
    args = (cam, 1984, pack, px, py, spp, bounces, w, rand)
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
    pack = scene_pack(*pack_scene(build_scene(scene_id, cuda_device)))
    mat, tab = pack.mat, pack.tab
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
    xyz, *res = render_rays_residuals(cam, 1984, pack, px, py, spp, bounces, w, rand, out=out)
    torch.cuda.synchronize()
    assert build.RENDER_RESIDUALS.launches == before + 1
    fwd = render_rays(cam, 1984, pack, px, py, spp, bounces, w, rand)
    assert torch.equal(xyz, fwd)
    ref_xyz, *ref = render_rays_reference(cam, 1984, pack, px, py, spp, bounces, w, rand, residuals=True)
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


def _synthetic_replay(dev, n_mats, bounces, kind, n=1000, spp=2, seed=0):
    """Residuals for the replay from a numpy seed: TRIS's materials tiled to
    n_mats rows (c0..c2 perturbed), TRIS's tables with D65 as a positive
    background, heroes in [360, 830), n_valid in {0, 1, 7}, powers in
    [0, 2), material residuals in {-1, 0, 1..n_mats} ("random"), all -1
    ("miss") or all 0 ("none": paths that hit nothing), a normal
    cotangent."""
    rng = np.random.default_rng(seed)
    _, mat, tab = pack_scene(build_scene(TRIS, "cpu"))
    mat = mat[torch.arange(n_mats) % mat.shape[0]].clone()
    mat[:, :3] *= torch.from_numpy(rng.uniform(0.9, 1.1, (n_mats, 3)).astype(np.float32))
    tab = tab.clone()
    tab[4] = tab[3]
    hero = rng.uniform(360.0, 830.0, (spp, n)).astype(np.float32)
    n_valid = rng.choice(np.asarray([0.0, 1.0, 7.0], np.float32), (spp, n))
    power = rng.uniform(0.0, 2.0, (spp, 7, n)).astype(np.float32)
    if kind == "random":
        matres = rng.choice(np.arange(-1, n_mats + 1, dtype=np.int32), (spp, bounces, n))
    else:
        matres = np.full((spp, bounces, n), -1 if kind == "miss" else 0, np.int32)
    g = rng.normal(size=(n, 3)).astype(np.float32)
    host = (mat, tab, *(torch.from_numpy(x) for x in (g, hero, n_valid, power, matres)))
    return tuple(x.to(dev) for x in host)


def _check_replay_kernel(dev, n_mats, bounces, want_bg, want_sell, kind, n):
    spp = 2
    args = _synthetic_replay(dev, n_mats, bounces, kind, n=n, spp=spp)
    shape = launch_shape(n, n_mats, bounces, want_bg, want_sell, dev)
    assert shape["packed"] == int(n_mats <= 16 and bounces <= 15)
    assert shape["block"] in (32, 64, 128, 256) and shape["blocks_per_sm"] >= 1
    before = build.GRAD.launches
    got = render_grads(*args, spp, bounces, want_bg_grads=want_bg, want_sellmeier=want_sell)
    again = render_grads(*args, spp, bounces, want_bg_grads=want_bg, want_sellmeier=want_sell)
    torch.cuda.synchronize()
    assert build.GRAD.launches == before + 2
    for a, b in zip(got, again):
        assert torch.equal(a, b)  # deterministic reduction
    want = render_grads_reference(*args, spp, bounces, want_bg_grads=want_bg, want_sellmeier=want_sell)
    assert len(got) == len(want) == 2 + want_bg + 2 * want_sell
    assert all(torch.isfinite(x).all() for x in got)
    _columns_close(got[0], want[0])
    _columns_close(got[1][:, None], want[1][:, None])
    if want_bg:
        _columns_close(got[2][:, None], want[2][:, None])
    if want_sell:
        # chip_smoke.py::check_replay's per-value test
        for a, b in zip(got[-2:], want[-2:]):
            err = (a - b).abs()
            assert int((err > 1e-6 * float(b.abs().max()) + 2e-4 * b.abs()).sum()) == 0
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n_mats", (1, 7, 9, 70))
@pytest.mark.parametrize("bounces", (1, 8, 20))
@pytest.mark.parametrize("want_bg", (True, False), ids=("bg", "nobg"))
@pytest.mark.parametrize("want_sell", (True, False), ids=("sell", "nosell"))
def test_replay_kernel_shapes_equal_plain(cuda_device, n_mats, bounces, want_bg, want_sell):
    """The replay on synthetic residuals, 1000 rays (not a multiple of a
    block): the packed form (at most 16 materials and 15 bounces) and the
    other one; 70 materials are past a 64-bit presence mask, 20 bounces
    past 4-bit counts."""
    got = _check_replay_kernel(cuda_device, n_mats, bounces, want_bg, want_sell, "random", 1000)
    assert got[0].abs().sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_mats", (7, 70))
@pytest.mark.parametrize("kind", ("miss", "none"))
def test_replay_kernel_all_miss_and_no_hit(cuda_device, n_mats, kind):
    """Paths that all miss (only the background knots move) and paths that
    hit nothing (residual 0: every gradient is 0), on 37 rays."""
    got = _check_replay_kernel(cuda_device, n_mats, 8, True, True, kind, 37)
    assert float(got[0].abs().sum()) == 0 and float(got[1].abs().sum()) == 0
    assert (float(got[2].abs().sum()) > 0) == (kind == "miss")


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
    pack = pack_scene_frame(scene, cam)
    px = (torch.arange(w * h, device=dev) % w).float()
    py = (torch.arange(w * h, device=dev) // w).float()
    rand = None
    if injected:
        planes = np.random.default_rng(11).uniform(size=(spp, n_uniforms(bounces), w * h))
        rand = torch.from_numpy(planes.astype(np.float32)).to(dev)
    return cam, 1984, pack, px, py, spp, bounces, w, rand


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
    args = _field_case(cuda_device, injected)
    n, spp, bounces = args[3].numel(), args[5], args[6]
    counts = [torch.zeros(n, dtype=torch.int32, device=cuda_device) for _ in range(8)]
    before = (build.RENDER_LEAVES.launches, build.RENDER_LEAVES_RESIDUALS.launches)
    fwd = render_rays(*args, counts[0], visits=counts[1], group_visits=counts[2], super_visits=counts[3])
    got = render_rays_residuals(*args, out=_garbage(spp, bounces, n, cuda_device))
    torch.cuda.synchronize()
    assert (build.RENDER_LEAVES.launches, build.RENDER_LEAVES_RESIDUALS.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got[0], fwd)
    ref = render_rays_reference(*args, counts[4], residuals=True, visits=counts[5], group_visits=counts[6],
                                super_visits=counts[7])
    for k in range(4):  # live ray-steps, leaves, groups and super-groups entered
        assert torch.equal(counts[k], counts[4 + k]), k
    assert int(counts[3].sum()) > 0
    _assert_residuals_equal(got, ref)
    assert (got[4] == 0).any() and (got[4] == -1).any()


@pytest.mark.cuda
@pytest.mark.parametrize("injected", (True, False), ids=("planes", "hash"))
def test_sorted_scheduler_equals_plain_and_megakernel(cuda_device, injected):
    wf_args = _field_case(cuda_device, injected)
    cam, seed, pack, px, py, spp, bounces, w, rand = wf_args
    n = px.numel()
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
    mega = render_rays_residuals(*wf_args)
    for a, b in zip(got, mega):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_leaf_kernels_on_morton_pack_equal_plain(cuda_device):
    """The Morton-ordered pack of pack_scene_leaves, whose last group and
    super-group are ragged (33 leaves of 16: groups of 8, 8, 8, 8 and 1):
    both leaf sweeps and their counts of boxes entered equal the plain
    versions'."""
    args = _field_case(cuda_device, injected=False)
    pack = scene_pack(*pack_scene_leaves(build_tri_field(520, seed=3, glass=True, device=cuda_device), leaf_size=16))
    wf_args = (*args[:2], pack, *args[3:])
    cam, seed, pack, px, py, spp, bounces, w, rand = wf_args
    n = px.numel()
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
    xyz = render_rays(*wf_args, visits=mega[0], group_visits=mega[1], super_visits=mega[2])
    assert torch.equal(xyz, got[0])
    for k in range(3):
        assert torch.equal(mega[k], counts[k].sum(0)), k


def _bounce_case(dev, case):
    """A sorted state for bounce 1 of a 13x7-pixel, 3 spp frame of the
    field (273 columns: no multiple of a warp or of a run of columns): the
    camera bounce's, with every path ended (``dead``), all but one ended
    (``one_live``), or rays from a corner of the field toward random points
    across it (``corner``), whose walks enter very different numbers of
    leaves. Returns (the bounce's arguments before ``b``, the state, orig)."""
    cam, seed, pack, px, py, spp, bounces, w, rand = _field_case(dev, injected=False, w=13, h=7, spp=3, bounces=3)
    nrays = spp * px.numel()
    state = torch.empty((STATE_ROWS, nrays), device=dev)
    wavefront_kernel.camera_bounce_reference(cam, seed, pack, px, py, spp, bounces, w, rand, state)
    lo, inv_ext = pack.key_box
    if case == "corner":
        ext = 1.0 / inv_ext
        g = torch.Generator(device="cpu").manual_seed(5)
        origin = lo + ext * (0.01 + 0.02 * torch.rand((nrays, 3), generator=g)).to(dev)
        target = lo + ext * torch.rand((nrays, 3), generator=g).to(dev)
        d = target - origin
        state[0:3] = origin.T
        state[3:6] = (d / d.norm(dim=1, keepdim=True)).T
        state[7] = 1.0
    elif case == "dead":
        state[7] = 0.0
    elif case == "one_live":
        state[7] = 0.0
        state[7, nrays // 2] = 1.0
    perm = torch.argsort(wavefront_kernel._sort_keys(state, lo, inv_ext), stable=True)
    orig = torch.arange(nrays, dtype=torch.int32, device=dev)[perm].contiguous()
    return (seed, pack, px, py, spp, bounces), state[:, perm].contiguous(), orig


@pytest.mark.cuda
@pytest.mark.parametrize("case", ("ragged", "dead", "one_live", "corner"))
def test_persistent_bounce_kernel_equals_plain(cuda_device, case):
    """The persistent bounce kernel against its plain version on one launch:
    the state, the material residuals (into garbage) and the four counters
    (live ray-steps, leaves, groups, super-groups entered) bit-equal."""
    scene, state, orig = _bounce_case(cuda_device, case)
    spp, bounces, n = scene[4], scene[5], scene[2].numel()
    outs = []
    for bounce in (wavefront_kernel._launch_bounce, wavefront_kernel.bounce_reference):
        st = state.clone()
        matres = _garbage(spp, bounces, n, cuda_device)[3]
        counts = [torch.zeros((spp, n), dtype=torch.int32, device=cuda_device) for _ in range(4)]
        bounce(*scene, 1, 13, None, st, orig, matres, *counts)
        outs.append((st, matres, *counts))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    live = int((state[7] != 0).sum())
    assert int(outs[0][2].sum()) == live
    if case == "corner":
        visits = outs[0][3][outs[0][2] > 0]
        assert int(visits.max()) - int(visits.min()) >= 8
    if case != "dead":
        assert int(outs[0][5].sum()) > 0


@pytest.mark.cuda
def test_warp_passes_cover_the_live_ray_steps(cuda_device):
    """Launch by launch, the tracing kernels' warp passes (warp_passes) hold
    every live ray-step and every unit of its walk (a batch of box tests or
    a leaf): a pass is at most 32 lanes at work, each lane at work on one
    step's end or on one unit, and a unit takes at least one lane, so
    live ray-steps + units <= lanes at work <= 32 x passes."""
    cam, seed, pack, px, py, spp, bounces, w, rand = _field_case(cuda_device, injected=False)
    n, nrays = px.numel(), spp * px.numel()
    scene = (pack, px, py, spp, bounces)
    batches = -(-pack.sweep.supers.shape[0] // 8)
    state = torch.empty((STATE_ROWS, nrays), device=cuda_device)
    orig = torch.arange(nrays, dtype=torch.int32, device=cuda_device)
    lo, inv_ext = pack.key_box
    for b in range(bounces):
        counts = [torch.zeros((spp, n), dtype=torch.int32, device=cuda_device) for _ in range(4)]
        passes = torch.zeros(2, dtype=torch.int64, device=cuda_device)
        if b == 0:
            wavefront_kernel._launch_camera(cam, seed, *scene, w, rand, state, None, *counts, warp_passes=passes)
        else:
            perm = torch.argsort(wavefront_kernel._sort_keys(state, lo, inv_ext), stable=True)
            state, orig = state.index_select(1, perm), orig.index_select(0, perm)
            wavefront_kernel._launch_bounce(seed, *scene, b, w, rand, state, orig, None, *counts,
                                            warp_passes=passes)
        steps, leaves, groups, supers = (int(c.to(torch.int64).sum()) for c in counts)
        units = steps * batches + supers + groups + leaves
        n_passes, at_work = passes.tolist()
        assert steps > 0
        assert steps + units <= at_work <= 32 * n_passes, b


@pytest.mark.cuda
def test_warp_passes_output_changes_nothing_else(cuda_device):
    """A frame with the warp_passes output and one without give the same
    image, residuals and counters."""
    wf_args = _field_case(cuda_device, injected=True)
    cam, seed, pack, px, py, spp, bounces, w, rand = wf_args
    n = px.numel()
    outs = []
    passes = torch.full((bounces, 2), 7, dtype=torch.int64, device=cuda_device)
    for out in (passes, None):
        counts = [torch.zeros((spp, n), dtype=torch.int32, device=cuda_device) for _ in range(4)]
        got = render_rays_wavefront(*wf_args, save_residuals=True, steps=counts[0], visits=counts[1],
                                    group_visits=counts[2], super_visits=counts[3], warp_passes=out)
        outs.append((*got, *counts))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert (passes > 0).all() and (passes[:, 1] <= 32 * passes[:, 0]).all()
    assert torch.equal(render_rays_wavefront(*wf_args), outs[1][0])


@pytest.mark.cuda
def test_field_frames_reuse_the_leaf_pack(cuda_device):
    """Two frames of the 10k field at two poses through RenderManager: the
    first builds the scene's leaf pack, the second is served from it and
    its XYZ is bit-equal to a cold render of its pose; render_rays_wavefront
    gives the same image, residuals and counters with the served pack and
    with the pack ``scene_pack`` builds by hand from its tri and leaf
    packs."""
    scene = build_tri_field(10008, seed=0, device=cuda_device)
    params = RenderParams(xres=128, aspect_ratio=2.0, nsamples=4, bounce_limit=6, device="cuda", show=False)
    cams = [make_camera(128, 64, vfov=40.0, lookfrom=eye, lookat=(278.0, 278.0, 0.0), vup=(0.0, 1.0, 0.0),
                        device=cuda_device) for eye in ((278.0, 278.0, -800.0), (139.0, 278.0, -788.0))]

    def frame(cam):
        got = {}
        RenderManager(scene, cam, params).render(on_chunk=lambda _c, fb: got.__setitem__("xyz", fb.copy()))
        return got["xyz"]

    b0, r0 = LEAF_PACKS.builds, LEAF_PACKS.reuses
    served = [frame(cam) for cam in cams]
    assert (LEAF_PACKS.builds - b0, LEAF_PACKS.reuses - r0) == (1, 1)
    LEAF_PACKS.entries.clear()
    cold = frame(cams[1])
    assert (LEAF_PACKS.builds - b0, LEAF_PACKS.reuses - r0) == (2, 1)
    np.testing.assert_array_equal(served[1], cold)
    assert served[1].sum() > 0 and not np.array_equal(served[0], served[1])

    w, h, spp, bounces = 64, 32, 4, 6
    cv = camera_vector(cams[1])
    pack = pack_scene_frame(scene, cv)
    px = (torch.arange(w * h, device=cuda_device) % w).float()
    py = (torch.arange(w * h, device=cuda_device) // w).float()
    outs = []
    for given in (pack, scene_pack(*pack[:4])):
        counts = [torch.zeros((spp, w * h), dtype=torch.int32, device=cuda_device) for _ in range(4)]
        got = render_rays_wavefront(cv, 1984, given, px, py, spp, bounces, 128, save_residuals=True, steps=counts[0],
                                    visits=counts[1], group_visits=counts[2], super_visits=counts[3])
        outs.append((*got, *counts))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


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
    leaves = render_rays_residuals(cam, 1984, scene_pack(tri, mat, tab, leaf), px, py, spp, bounces, w, None)
    dense = render_rays_residuals(cam, 1984, scene_pack(*pack_scene(scene)), px, py, spp, bounces, w, None)
    _assert_residuals_equal(leaves, dense)


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


@pytest.mark.cuda
def test_sharded_render_on_two_gloo_ranks_equals_composition(cuda_device, tmp_path):
    """render_image_sharded_pallas on two gloo ranks that share the card
    (tests/torch_parallel_worker.py --card; a 2 x 1 mesh, CUDA tensors
    all-reduced by gloo): every rank's image bit-equal to the shards'
    one-device dense renders composed here (the kernels built first, so the
    ranks do not build them twice)."""
    import torch_parallel_worker as worker

    from spectral_tpu_torch.ops.cuda.render_kernel import render_chunk
    from spectral_tpu_torch.parallel.render import RENDER_SEED_STRIDE

    build.build_all(build.KERNELS.values())
    ranks = worker.spawn(2, ["--card", str(tmp_path)], tmp_path, 300)
    (w, h), spp, bounces, seed = worker.CARD_RUN
    scene = build_scene(CORNELL, cuda_device)
    cam = scene_camera(CORNELL, w, h, cuda_device)
    rows = h // 2
    want = torch.cat([render_chunk(scene, cam, seed + ti * RENDER_SEED_STRIDE, 0, ti * rows, w, rows, spp, bounces)
                      for ti in range(2)]).cpu().numpy()
    assert want.max() > 0.0
    for r, out in enumerate(ranks):
        assert tuple(out["coords"]) == (r, 0)
        np.testing.assert_array_equal(out["image"], want)


@pytest.mark.cuda
def test_rgb2spec_on_the_card_equals_the_cpu(cuda_device):
    """The general-colour table lookup and the LM fit on CUDA tensors against
    their CPU results: the table within rtol 1e-5 / atol 1e-6, the fit's
    SPDs within 1e-4."""
    from spectral_tpu_torch.ops import rgb2spec

    rng = np.random.default_rng(5)
    rgb = torch.from_numpy(np.concatenate([rng.uniform(0.05, 0.95, (12, 3)), np.eye(3)]).astype(np.float32))
    lookup = rgb2spec.lookup_sigmoid_coeffs(rgb.to(cuda_device))
    assert lookup.device.type == "cuda"
    torch.testing.assert_close(lookup.cpu(), rgb2spec.lookup_sigmoid_coeffs(rgb), rtol=1e-5, atol=1e-6)
    card, host = rgb2spec.lm_fit_coeffs(rgb.to(cuda_device)).cpu(), rgb2spec.lm_fit_coeffs(rgb)
    spd = rgb2spec.spd_from_coeffs_reflectance
    assert float((spd(card) - spd(host)).abs().max()) <= 1e-4
