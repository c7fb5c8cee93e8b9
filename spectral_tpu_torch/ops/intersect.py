"""Ray-triangle nearest hit, dense and over Morton leaves: the plain
PyTorch versions.

This is the function both CUDA kernels compute (csrc/hit.cuh): per ray, the
nearest of all triangles of a packed table, with the reference's plane test
(primitives/tri.cu:12-25) and the sign-folded affine edge functionals of
models/geometry.py (tri.cu:121-128). The sweep is vectorised over a
[rays, triangles] grid. Every product and sum is written in the order the
kernels use, with fused multiply-adds where XLA contracts them (ops/fp32.py),
so the plain version and the kernels take the same discrete decisions on
the same inputs.

The selection matches the kernels' sequential roll-forward (``tt < best``,
triangle by triangle): the nearest valid triangle wins and a tie goes to
the lower index, which is what argmin's first-occurrence rule gives.

``nearest_hit_leaves`` is the leaf sweep of csrc/leaf_sweep.cuh: the same
triangle test over Morton-ordered leaves, each leaf entered only by the
rays whose slab test against its AABB passes (spectral_tpu/ops/pallas/
render_kernel.py:701-724, ``_slab_want``, op for op) and whose entry lies
nearer than their best hit so far. Ties go to the lower original triangle
index, so it returns what ``nearest_hit`` returns on the unsorted scene.
"""

from __future__ import annotations

import torch

from .fp32 import dot3, fma

# Ray-parallel-to-plane threshold (reference tri.cu:15)
DENOM_EPS = 1e-8
# "no hit yet" distance; also the distance reported for a miss
BIG = 3.4e38
# leaf pack columns: AABB min 0:3, max 3:6, valid flag 6 (1 = holds a
# triangle; an inverted padding box would pass the min/max slab test)
LEAF_VALID = 6
# column of a leaf tri row that holds the triangle's original index
TRI_ORIG = 17


def nearest_hit(o: torch.Tensor, d: torch.Tensor, tri_pack: torch.Tensor):
    """Nearest hit of rays ``o, d`` [N, 3] over ``tri_pack`` [T, >=16]
    (normal 0:3, plane offset 3, edge_g 4:13, edge_c 13:16).

    Returns (t [N] f32, BIG on a miss; idx [N] int32, 0 on a miss;
    hit [N] bool; front [N] bool: the ray meets the triangle's front face),
    the outputs of the reference's intersect kernel."""
    tt, valid, nd = _tri_test(o, d, tri_pack)
    t_masked = torch.where(valid, tt, torch.full_like(tt, BIG))
    idx = torch.argmin(t_masked, dim=1, keepdim=True)
    hit = valid.any(dim=1)
    t = t_masked.gather(1, idx)[:, 0]
    front = hit & (nd.gather(1, idx)[:, 0] < 0.0)
    idx = torch.where(hit, idx[:, 0], torch.zeros_like(idx[:, 0])).to(torch.int32)
    return t, idx, hit, front


def _tri_test(o, d, tri_pack):
    """(tt, valid, nd) of the rays o, d [N, 3] against the rows of
    ``tri_pack``: [N, T] for a [T, C] table, or [N, K] for [N, K, C] (ray i
    against its own K rows). The plane distance, the full acceptance test
    and n . d."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    col = lambda k: tri_pack[..., k]  # noqa: E731  [T] or [N, K], broadcast against [N, 1]
    nx, ny, nz, dd = col(0), col(1), col(2), col(3)
    nd = dot3(nx, ny, nz, dx, dy, dz)
    no = dot3(nx, ny, nz, ox, oy, oz)
    tt = (dd - no) / nd
    inside = torch.ones_like(tt, dtype=torch.bool)
    for k in range(3):
        g0, g1, g2, c = col(4 + 3 * k), col(5 + 3 * k), col(6 + 3 * k), col(13 + k)
        ao = dot3(g0, g1, g2, ox, oy, oz) + c
        ad = dot3(g0, g1, g2, dx, dy, dz)
        inside = inside & (fma(tt, ad, ao) >= 0.0)
    return tt, inside & (nd.abs() >= DENOM_EPS) & (tt >= 0.0) & (tt < BIG), nd


def safe_inv(x: torch.Tensor) -> torch.Tensor:
    """1 / x with |x| raised to at least 1e-20, the sign kept (-0 counts
    as positive): render_kernel.py:664-670."""
    safe = torch.where(x >= 0.0, torch.clamp_min(x, 1e-20), torch.clamp_max(x, -1e-20))
    return 1.0 / safe


def leaf_slabs(boxes, o, inv_d):
    """(passes, enter) [N, NL] of rays ``o`` [N, 3] with reciprocal
    directions ``inv_d`` (three [N] tensors) against the AABBs ``boxes``
    [NL, >=6] (min xyz, max xyz), op for op as render_kernel.py:701-724:
    the slab interval [tmin, tmax], ``enter = max(tmin, 0)`` and ``passes =
    tmax >= enter``. The ray enters the leaf when it passes and ``enter``
    lies nearer than its best hit so far. An inverted box does not fail
    it: callers check the leaf's valid flag first."""
    tmin = tmax = None
    for k in range(3):
        t1 = (boxes[None, :, k] - o[:, k:k + 1]) * inv_d[k][:, None]
        t2 = (boxes[None, :, 3 + k] - o[:, k:k + 1]) * inv_d[k][:, None]
        lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
        tmin = lo if tmin is None else torch.maximum(tmin, lo)
        tmax = hi if tmax is None else torch.minimum(tmax, hi)
    enter = torch.clamp_min(tmin, 0.0)
    return tmax >= enter, enter


def nearest_hit_leaves(o, d, tri_pack, leaf_pack, alive=None, visits=None):
    """Nearest hit of rays ``o, d`` [N, 3] over the leaf pack of
    ops/cuda/render_kernel.py::pack_scene_leaves: ``tri_pack`` [NL * K, 18]
    (the dense columns, then the original triangle index), ``leaf_pack``
    [NL, 8]. Leaves are visited in storage order; a ray tests a leaf's K
    rows only if the leaf is valid and its slab test passes against its
    best hit so far (``leaf_slabs``). ``alive`` (bool [N]): rays that sweep
    at all, the others miss. ``visits`` (int32 [N]): incremented by the
    leaves each ray entered.

    Returns (t, idx, hit, front) as ``nearest_hit`` does, idx being the
    original index (the lower one on a tie), and the winning row of
    ``tri_pack`` (0 on a miss).

    Vectorised so that the visit order is the only sequential part: the
    slab intervals of every (ray, leaf), then the triangle test of every
    pair whose slab test passes and the pair's best (t, index), then, leaf
    by leaf, the cull against the best hit so far and the update. The
    selection is a lexicographic minimum, so this equals the kernel's
    triangle-by-triangle loop. Rays go in chunks that keep the [rays,
    leaves] tables near 2^24 entries."""
    n = o.shape[0]
    chunk = max(1, (1 << 24) // leaf_pack.shape[0])
    if n > chunk:
        parts = [
            nearest_hit_leaves(
                o[i:i + chunk], d[i:i + chunk], tri_pack, leaf_pack,
                None if alive is None else alive[i:i + chunk], None if visits is None else visits[i:i + chunk],
            )
            for i in range(0, n, chunk)
        ]
        return tuple(torch.cat(x) for x in zip(*parts))
    dev = o.device
    n_leaves = leaf_pack.shape[0]
    k_size = tri_pack.shape[0] // n_leaves
    no_idx = torch.iinfo(torch.int32).max
    in_box, enter = leaf_slabs(leaf_pack, o, [safe_inv(d[:, k]) for k in range(3)])
    in_box &= leaf_pack[None, :, LEAF_VALID] != 0.0
    if alive is not None:
        in_box &= alive[:, None]
    # each pair's best (t, original index) over the leaf's rows
    ray_i, leaf_i = in_box.nonzero(as_tuple=True)
    rows = leaf_i[:, None] * k_size + torch.arange(k_size, device=dev)
    tt, valid, nd = _tri_test(o[ray_i], d[ray_i], tri_pack[rows])
    t_m = torch.where(valid, tt, torch.full_like(tt, BIG))
    pair_t = t_m.min(dim=1).values
    orig = tri_pack[rows, TRI_ORIG].to(torch.int32)
    cand = torch.where(valid & (t_m == pair_t[:, None]), orig, torch.full_like(orig, no_idx))
    pair_idx, k_best = cand.min(dim=1)
    pick = torch.arange(rows.shape[0], device=dev)
    leaf_t = torch.full((n, n_leaves), BIG, dtype=torch.float32, device=dev)
    leaf_idx = torch.full((n, n_leaves), no_idx, dtype=torch.int32, device=dev)
    leaf_row = torch.zeros((n, n_leaves), dtype=torch.int64, device=dev)
    leaf_nd = torch.zeros((n, n_leaves), dtype=torch.float32, device=dev)
    leaf_t[ray_i, leaf_i] = pair_t
    leaf_idx[ray_i, leaf_i] = pair_idx
    leaf_row[ray_i, leaf_i] = rows[pick, k_best]
    leaf_nd[ray_i, leaf_i] = nd[pick, k_best]
    # the visits in storage order, each culled against the best hit so far
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    best_idx = torch.full((n,), no_idx, dtype=torch.int32, device=dev)
    best_row = torch.zeros(n, dtype=torch.int64, device=dev)
    best_nd = torch.zeros(n, dtype=torch.float32, device=dev)
    for leaf in range(n_leaves):
        want = in_box[:, leaf] & (enter[:, leaf] < best_t)
        if visits is not None:
            visits += want.to(torch.int32)
        lt, li = leaf_t[:, leaf], leaf_idx[:, leaf]
        take = want & ((lt < best_t) | ((lt == best_t) & (li < best_idx)))
        best_t = torch.where(take, lt, best_t)
        best_idx = torch.where(take, li, best_idx)
        best_row = torch.where(take, leaf_row[:, leaf], best_row)
        best_nd = torch.where(take, leaf_nd[:, leaf], best_nd)
    hit = best_idx != no_idx
    idx = torch.where(hit, best_idx, torch.zeros_like(best_idx))
    return best_t, idx, hit, hit & (best_nd < 0.0), best_row
