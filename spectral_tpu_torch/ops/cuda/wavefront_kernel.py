"""The sorted per-bounce scheduler for large scenes: its three CUDA kernels,
their plain versions and the glue between them.

Port of spectral_tpu/ops/pallas/wavefront_kernel.py (``render_rays_wavefront``
:407, ``_sort_keys`` :380; its ``_spread3`` :369 is ops/bvh.py's
``_expand_bits``). The path trace is cut into
one launch per bounce on a ray state [17, spp * N] kept in device memory
(rows: origin, direction, hero, alive, n_valid, previous triangle, power):
csrc/wavefront_kernel.cu's camera kernel traces the camera rays and bounce
0, the bounce kernel each later bounce, and the integrate step (two
kernels, one entry point) the XYZ of every sample-ray and each pixel's sum
over its samples. Between bounces the rays are sorted stably by
``_sort_keys`` (ended rays last, then direction octant, then the Morton
code of the origin) and the state gathered, so that neighbouring threads
trace neighbouring rays and enter the same leaves. ``torch.argsort`` and
the index gathers are that glue, the counterpart of the XLA code between
the JAX package's kernels.

Each ray carries its original sample-ray index ``orig`` = s * N + p, from
which the kernels take its draws (the megakernel's hash of (chunk seed,
global pixel, sample, draw), or injected planes read at rand[s, :, p]) and
write its residuals. The path arithmetic is the leaf megakernel's
(csrc/path.cuh, csrc/leaf_sweep.cuh), so on the same draws both schedulers
give the same paths, and the spp sum runs in ascending order as the
megakernel's does (in the integrate step's second kernel: the counterpart
of the JAX package's scatter and sum after its integrate kernel).
Sample-ray i of the state is updated in place by the bounce kernel; each
gather makes the next state.

``render_rays_wavefront`` launches the kernels for CUDA tensors and runs the
plain versions (``camera_bounce_reference``, ``bounce_reference``,
``integrate_reference``) for CPU tensors; ``render_rays_wavefront_reference``
runs the plain versions on any device.
"""

from __future__ import annotations

import torch

from ...utils.trace import span
from ..bvh import _expand_bits
from . import build
from .render_kernel import (
    _M32,
    W,
    _check,
    _ptr,
    camera_rays,
    hash_uniforms,
    hero_curves,
    hero_wavelength,
    leaf_launch_args,
    n_uniforms,
    path_xyz,
    pixel_keys,
    residual_buffers,
    trace_bounce,
)

# ray-state rows (wavefront_kernel.py:78-82)
_ROW_OX, _ROW_OY, _ROW_OZ = 0, 1, 2
_ROW_DX, _ROW_DY, _ROW_DZ = 3, 4, 5
_ROW_HERO, _ROW_ALIVE, _ROW_NVALID, _ROW_PREV = 6, 7, 8, 9
_ROW_POWER = 10  # rows 10 .. 10 + W - 1
STATE_ROWS = _ROW_POWER + W


def _sort_keys(st: torch.Tensor, lo: torch.Tensor, inv_ext: torch.Tensor) -> torch.Tensor:
    """int32 sort key per ray of the state ``st`` [17, R]: ended rays last
    (bit 30), then the direction octant (bits 27-29), then the 27-bit Morton
    code of the origin normalized by ``lo`` and ``inv_ext`` [3]. The
    position is clamped in float, NaN to 0, before the int cast
    (wavefront_kernel.py:391-395): a NaN or overflowing origin would
    otherwise meet an implementation-defined cast."""
    q = []
    for ax in range(3):
        x = (st[_ROW_OX + ax] - lo[ax]) * inv_ext[ax] * 511.0
        q.append(torch.clamp(torch.nan_to_num(x), 0.0, 511.0).to(torch.int32))
    morton = _expand_bits(q[0]) | (_expand_bits(q[1]) << 1) | (_expand_bits(q[2]) << 2)
    i32 = torch.int32
    octant = (st[_ROW_DX] > 0.0).to(i32) * 4 + (st[_ROW_DY] > 0.0).to(i32) * 2 + (st[_ROW_DZ] > 0.0).to(i32)
    dead = (st[_ROW_ALIVE] == 0.0).to(i32)
    return (dead << 30) | (octant << 27) | morton


def _ray_draws(seed, px, py, image_width, rand, sample, pixel, first, count):
    """Draws [count, R] first.. of rays of samples ``sample`` and pixels
    ``pixel`` (int64 [R]): the planes at rand[s, j, p], else the hash."""
    if rand is not None:
        j = torch.arange(first, first + count, device=px.device)[:, None]
        return rand[sample[None, :], j, pixel[None, :]]
    keys = pixel_keys(seed, px[pixel], py[pixel], image_width)
    return hash_uniforms(keys, sample, count, first)


def _state_of(st: torch.Tensor):
    ray = tuple(st[k] for k in range(6))
    power = [st[_ROW_POWER + w] for w in range(W)]
    return ray, power, st[_ROW_ALIVE], st[_ROW_NVALID]


def _store(st, cols, ray, power, alive, n_valid, hero=None):
    for k in range(6):
        st[k, cols] = ray[k]
    for w in range(W):
        st[_ROW_POWER + w, cols] = power[w]
    st[_ROW_ALIVE, cols] = alive
    st[_ROW_NVALID, cols] = n_valid
    if hero is not None:
        st[_ROW_HERO, cols] = hero
        st[_ROW_PREV, cols] = -1.0


def _counts(n_rays, dev, visits, group_visits, super_visits):
    """Zeroed int32 [R] counters where the [spp, N] outputs are wanted."""
    return tuple(
        None if x is None else torch.zeros(n_rays, dtype=torch.int32, device=dev)
        for x in (visits, group_visits, super_visits)
    )


def camera_bounce_reference(
    cam_vec, seed, pack, px, py, spp, bounces, image_width, rand, state, matres=None, steps=None, visits=None,
    group_visits=None, super_visits=None,
):
    """Plain version of the camera kernel on the leaf ScenePack ``pack``:
    sample-ray r = s * N + p gets the camera ray and hero of its draws, then
    bounce 0; writes ``state`` [17, spp * N], matres[:, 0, :], and steps,
    visits, group_visits, super_visits [spp, N]."""
    n = px.shape[0]
    dev = px.device
    r = torch.arange(spp * n, device=dev)
    sample, pixel = r // n, r % n
    u = _ray_draws(seed, px, py, image_width, rand, sample, pixel, 0, n_uniforms(bounces))
    ray = camera_rays(cam_vec, px[pixel], py[pixel], u[0], u[1], u[3 + 3 * bounces], u[4 + 3 * bounces])
    hero = hero_wavelength(u[2])
    one = torch.ones(spp * n, dtype=torch.float32, device=dev)
    cnt = _counts(spp * n, dev, visits, group_visits, super_visits)
    ray, power, alive, n_valid, mres = trace_bounce(
        ray, [one] * W, one, torch.full_like(one, float(W)), hero_curves(hero, pack.tab),
        u[3], u[4], u[5], pack.tri, pack.mat, pack.sweep, cnt,
    )
    _store(state, r, ray, power, alive, n_valid, hero)
    if matres is not None:
        matres[:, 0, :] = mres.reshape(spp, n)
    if steps is not None:
        steps.fill_(1)
    for out, c in zip((visits, group_visits, super_visits), cnt):
        if out is not None:
            out.copy_(c.reshape(spp, n))


def bounce_reference(
    seed, pack, px, py, spp, bounces, b, image_width, rand, state, orig, matres=None, steps=None, visits=None,
    group_visits=None, super_visits=None,
):
    """Plain version of the bounce kernel: bounce ``b`` of the state in
    sorted order, in place; ``orig`` [spp * N] int32 holds each column's
    original sample-ray. An ended path stays as it is and gets material
    residual 0."""
    n = px.shape[0]
    o = orig.long()
    sample, pixel = o // n, o % n
    u = _ray_draws(seed, px, py, image_width, rand, sample, pixel, 3 + 3 * b, 3)
    ray, power, alive, n_valid = _state_of(state)
    live = alive > 0.0
    cnt = _counts(o.shape[0], o.device, visits, group_visits, super_visits)
    ray, power, alive, n_valid, mres = trace_bounce(
        ray, power, alive, n_valid, hero_curves(state[_ROW_HERO], pack.tab),
        u[0], u[1], u[2], pack.tri, pack.mat, pack.sweep, cnt,
    )
    _store(state, slice(None), ray, power, alive, n_valid)
    if matres is not None:
        matres[sample, b, pixel] = mres
    if steps is not None:
        steps.view(-1)[o] += live.to(torch.int32)
    for out, c in zip((visits, group_visits, super_visits), cnt):
        if out is not None:
            out.view(-1)[o] += c


def integrate_reference(tables, state, orig, n, spp, pixel_xyz, hero=None, n_valid=None, power=None):
    """Plain version of the integrate step: ``pixel_xyz`` [N, 3] gets each
    pixel's XYZ, the sum over its samples in ascending order from 0 of each
    sample-ray's XYZ (the megakernel's order); with ``hero`` also the
    residuals hero, n_valid [spp, N] and power [spp, W, N], all in original
    order. As the kernels do, each sample-ray's XYZ goes to its slot [s, p]
    and the slots are added from s = 0."""
    o = orig.long()
    nv = torch.where(state[_ROW_ALIVE] > 0.0, 0.0, state[_ROW_NVALID])
    _, cell, frac, _, _ = hero_curves(state[_ROW_HERO], tables)
    pw = [state[_ROW_POWER + w] for w in range(W)]
    slot = torch.empty((spp * n, 3), dtype=torch.float32, device=state.device)
    slot[o] = torch.stack(path_xyz(pw, nv, cell, frac, tables), dim=1)
    acc = torch.zeros((n, 3), dtype=torch.float32, device=state.device)
    for s in range(spp):
        acc = acc + slot[s * n:(s + 1) * n]
    pixel_xyz.copy_(acc)
    if hero is not None:
        hero.view(-1)[o] = state[_ROW_HERO]
        n_valid.view(-1)[o] = nv
        power.view(spp, W, n)[o // n, :, o % n] = torch.stack(pw, dim=1)


def _launch_camera(cam_vec, seed, pack, px, py, spp, bounces, image_width, rand, state, matres=None, steps=None,
                   visits=None, group_visits=None, super_visits=None, next_col=None, warp_passes=None):
    """The camera kernel; ``next_col``: its column counter, one int32 that is
    0 (made here when not given); ``warp_passes``: two int64 that the launch
    adds its warp passes and lanes at work to, or None."""
    if next_col is None:
        next_col = torch.zeros(1, dtype=torch.int32, device=px.device)
    build.WAVEFRONT_CAMERA.launch(
        px.device, cam_vec.data_ptr(), seed & _M32, *leaf_launch_args(pack.sweep),
        pack.mat.data_ptr(), pack.mat.shape[0], pack.tab.data_ptr(), px.data_ptr(), py.data_ptr(), px.shape[0],
        image_width, spp, bounces,
        *(_ptr(x) for x in (rand, state, matres, steps, visits, group_visits, super_visits, next_col, warp_passes)),
    )


def _launch_bounce(seed, pack, px, py, spp, bounces, b, image_width, rand, state, orig, matres=None, steps=None,
                   visits=None, group_visits=None, super_visits=None, next_col=None, warp_passes=None):
    """The bounce kernel; ``next_col`` and ``warp_passes`` as _launch_camera's."""
    if next_col is None:
        next_col = torch.zeros(1, dtype=torch.int32, device=px.device)
    build.WAVEFRONT_BOUNCE.launch(
        px.device, seed & _M32, *leaf_launch_args(pack.sweep),
        pack.mat.data_ptr(), pack.mat.shape[0], pack.tab.data_ptr(), px.data_ptr(), py.data_ptr(), px.shape[0],
        image_width, spp, bounces, _ptr(rand), b,
        *(_ptr(x) for x in (state, orig, matres, steps, visits, group_visits, super_visits, next_col, warp_passes)),
    )


def _launch_integrate(tables, state, orig, n, spp, pixel_xyz, hero=None, n_valid=None, power=None):
    slot = torch.empty((spp * n, 4), dtype=torch.float32, device=state.device)
    build.WAVEFRONT_INTEGRATE.launch(
        state.device, tables.data_ptr(), state.data_ptr(), orig.data_ptr(), n, spp, slot.data_ptr(),
        *(_ptr(x) for x in (pixel_xyz, hero, n_valid, power)),
    )


_PLAIN = (camera_bounce_reference, bounce_reference, integrate_reference)
_CUDA = (_launch_camera, _launch_bounce, _launch_integrate)


def _wavefront(kernels, cam_vec, seed, pack, px, py, spp, bounces, image_width, rand, save_residuals, counters, out,
               warp_passes=None):
    _check(cam_vec, pack, px, py, spp, bounces, rand, None)
    if pack.leaf is None:
        raise ValueError("the sorted scheduler traces a leaf pack: pass the scene's leaf pack")
    n = px.shape[0]
    dev = px.device
    f32 = torch.float32
    for name, x in zip(("steps", "visits", "group_visits", "super_visits"), counters):
        if x is not None and (x.shape != (spp, n) or x.dtype != torch.int32 or x.device != dev
                              or not x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int32 [spp, N] tensor on {dev}")
    if warp_passes is not None:
        if kernels is not _CUDA:
            raise ValueError("warp_passes counts the CUDA kernels' warp passes: it needs CUDA tensors")
        if (warp_passes.shape != (bounces, 2) or warp_passes.dtype != torch.int64 or warp_passes.device != dev
                or not warp_passes.is_contiguous()):
            raise ValueError(f"warp_passes must be a contiguous int64 [bounces, 2] tensor on {dev}")
        warp_passes.zero_()
    cam_vec, px, py = (x.to(f32).contiguous() for x in (cam_vec, px, py))
    if rand is not None:
        rand = rand.to(f32).contiguous()
    camera, bounce, integrate = kernels
    nrays = spp * n
    res = residual_buffers(spp, bounces, n, dev, out) if save_residuals else None
    matres = res[3] if res is not None else None
    scene = (pack, px, py, spp, bounces)

    with span("sched.camera"):
        if kernels is _CUDA:
            # each launch's column counter, and its warp passes where wanted
            cols = torch.zeros(bounces, dtype=torch.int32, device=dev)
            launch = [{"next_col": cols[b:b + 1], "warp_passes": None if warp_passes is None else warp_passes[b]}
                      for b in range(bounces)]
        else:
            launch = [{}] * bounces
        state = torch.empty((STATE_ROWS, nrays), dtype=f32, device=dev)
        camera(cam_vec, seed, *scene, image_width, rand, state, matres, *counters, **launch[0])
        orig = torch.arange(nrays, dtype=torch.int32, device=dev)
    lo, inv_ext = pack.key_box
    for b in range(1, bounces):
        with span("sched.sort"):
            perm = torch.argsort(_sort_keys(state, lo, inv_ext), stable=True)
            state = state.index_select(1, perm)
            orig = orig.index_select(0, perm)
        with span("sched.bounce"):
            bounce(seed, *scene, b, image_width, rand, state, orig, matres, *counters, **launch[b])

    with span("sched.integrate"):
        xyz = torch.empty((n, 3), dtype=f32, device=dev)
        integrate(pack.tab, state, orig, n, spp, xyz, *(res[:3] if res is not None else ()))
    return (xyz, *res) if save_residuals else xyz


def render_rays_wavefront(
    cam_vec, seed, pack, px, py, spp, bounces, image_width, rand=None, save_residuals=False, steps=None,
    visits=None, out=None, group_visits=None, super_visits=None, warp_passes=None,
):
    """Accumulated XYZ [N, 3] for the rays of pixels (px, py) [N] through
    the sorted per-bounce scheduler, over the leaf ScenePack ``pack``
    (ops/cuda/render_kernel.py::pack_scene_frame or scene_pack): every
    launch reads its LeafTables, the sort keys its box. ``seed``,
    ``image_width`` and ``rand`` as in render_rays: the draws are the
    megakernel's. With ``save_residuals``: (xyz, hero [spp, N], n_valid
    [spp, N], power [spp, W, N], matres int32 [spp, bounces, N]), all in
    original ray order, as render_rays_residuals returns them; ``out``:
    preallocated residual buffers (every element is written). ``steps``,
    ``visits``, ``group_visits``, ``super_visits``: optional int32 [spp, N]
    outputs, each sample-ray's live ray-steps and entered leaves, groups and
    super-groups. ``warp_passes``: optional int64 [bounces, 2] output of the
    tracing launches (row 0 the camera launch, b bounce b), CUDA tensors
    only: each launch's warp passes and the lanes at work in them
    (csrc/wavefront_kernel.cu::trace_columns); [:, 1] / (32 x [:, 0]) is the
    share of lanes at work, the lane efficiency. CUDA tensors launch the
    kernels (one camera launch, bounces - 1 bounce launches, one integrate
    launch), CPU tensors run their plain versions."""
    kernels = _PLAIN if px.device.type == "cpu" else _CUDA
    if px.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {px.device}")
    return _wavefront(
        kernels, cam_vec, seed, pack, px, py, spp, bounces, image_width, rand, save_residuals,
        (steps, visits, group_visits, super_visits), out, warp_passes,
    )


def render_rays_wavefront_reference(
    cam_vec, seed, pack, px, py, spp, bounces, image_width, rand=None, save_residuals=False, steps=None,
    visits=None, out=None, group_visits=None, super_visits=None,
):
    """``render_rays_wavefront`` through the plain versions of its kernels,
    on any device."""
    return _wavefront(
        _PLAIN, cam_vec, seed, pack, px, py, spp, bounces, image_width, rand, save_residuals,
        (steps, visits, group_visits, super_visits), out,
    )
