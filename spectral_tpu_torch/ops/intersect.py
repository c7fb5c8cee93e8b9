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
nearer than their best hit so far, under the JAX kernel's two levels of
leaf groups (``leaf_groups``; render_kernel.py:1470-1660, :2921-2958),
whose boxes gate their members' tests the same way. Ties go to the lower
original triangle index, so it returns what ``nearest_hit`` returns on the
unsorted scene.

The scene-level half of spectral_tpu/ops/intersect.py serves the
XLA-style renderer (render/wavefront.py): ``HitRecord`` (:39),
``intersect_block`` (:51), ``nearest_hit_scene`` (the scene form of
``nearest_hit`` :92) with ``gather_record`` (:111), and ``ray_aabb``
(:143). Its gradient policy is the JAX module's: the selection (index and
hit mask) is discrete and detached, and the selected triangle's t, point
and normal are recomputed from it as smooth functions of the ray and the
scene. The selection is the dense intersect kernel's
(ops/cuda/intersect_kernel.py::intersect), or on the CPU its plain version
``nearest_hit``; the recomputation follows XLA's arithmetic (ops/fp32.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .fp32 import dot3, dot3_xla, fma, sum3

# Ray-parallel-to-plane threshold (reference tri.cu:15)
DENOM_EPS = 1e-8
# "no hit yet" distance; also the distance reported for a miss
BIG = 3.4e38
# leaf pack columns: AABB min 0:3, max 3:6, valid flag 6 (1 = holds a
# triangle; an inverted padding box would pass the min/max slab test)
LEAF_VALID = 6
# column of a leaf tri row that holds the triangle's original index
TRI_ORIG = 17
# Leaves per group and groups per super-group of the leaf sweep's cull
# hierarchy: the JAX kernel's defaults (render_kernel.py:2962 MXU_GROUP_SIZE,
# and the 8 groups of its MXU_GROUP_L2 level, :2936). With LEAF_SIZE = 16 a
# group holds 128 triangles, the JAX leaf size. The CUDA sweep holds both as
# csrc/leaf_sweep.cuh::kFan; fan-outs of 16 measured no faster (PERF.md).
GROUP_SIZE = 8
SUPER_SIZE = 8
# the plain leaf sweep's rays a pass and (ray, leaf) pairs a batch of
# triangle tests: they bound its memory
_RAY_CHUNK = 1 << 15
_PAIR_CHUNK = 1 << 16
_NO_IDX = torch.iinfo(torch.int32).max


def nearest_hit(o: torch.Tensor, d: torch.Tensor, tri_pack: torch.Tensor, xla: bool = False):
    """Nearest hit of rays ``o, d`` [N, 3] over ``tri_pack`` [T, >=16]
    (normal 0:3, plane offset 3, edge_g 4:13, edge_c 13:16).

    Returns (t [N] f32, BIG on a miss; idx [N] int32, 0 on a miss;
    hit [N] bool; front [N] bool: the ray meets the triangle's front face),
    the outputs of the reference's intersect kernel. ``xla``: the dots in
    the order of the XLA-style renderer's ``intersect_block``
    (ops/fp32.py::sum3), so that the selection is its argmin's."""
    tt, valid, nd = _tri_test(o, d, tri_pack, dot3_xla if xla else dot3)
    t_masked = torch.where(valid, tt, torch.full_like(tt, BIG))
    idx = torch.argmin(t_masked, dim=1, keepdim=True)
    hit = valid.any(dim=1)
    t = t_masked.gather(1, idx)[:, 0]
    front = hit & (nd.gather(1, idx)[:, 0] < 0.0)
    idx = torch.where(hit, idx[:, 0], torch.zeros_like(idx[:, 0])).to(torch.int32)
    return t, idx, hit, front


def _tri_test(o, d, tri_pack, dot=dot3):
    """(tt, valid, nd) of the rays o, d [N, 3] against the rows of
    ``tri_pack``: [N, T] for a [T, C] table, or [N, K] for [N, K, C] (ray i
    against its own K rows). The plane distance, the full acceptance test
    and n . d, the dots taken by ``dot``."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    col = lambda k: tri_pack[..., k]  # noqa: E731  [T] or [N, K], broadcast against [N, 1]
    nx, ny, nz, dd = col(0), col(1), col(2), col(3)
    nd = dot(nx, ny, nz, dx, dy, dz)
    no = dot(nx, ny, nz, ox, oy, oz)
    tt = (dd - no) / nd
    inside = torch.ones_like(tt, dtype=torch.bool)
    for k in range(3):
        g0, g1, g2, c = col(4 + 3 * k), col(5 + 3 * k), col(6 + 3 * k), col(13 + k)
        ao = dot(g0, g1, g2, ox, oy, oz) + c
        ad = dot(g0, g1, g2, dx, dy, dz)
        inside = inside & (fma(tt, ad, ao) >= 0.0)
    return tt, inside & (nd.abs() >= DENOM_EPS) & (tt >= 0.0) & (tt < BIG), nd




def safe_inv(x: torch.Tensor) -> torch.Tensor:
    """1 / x with |x| raised to at least 1e-20, the sign kept (-0 counts
    as positive): render_kernel.py:664-670."""
    safe = torch.where(x >= 0.0, torch.clamp_min(x, 1e-20), torch.clamp_max(x, -1e-20))
    return 1.0 / safe


def _slabs(box, o, inv_d):
    """(passes, enter) of rays ``o`` [..., 3] with reciprocal directions
    ``inv_d`` (three [...] tensors) against the AABBs ``box`` [..., >=6]
    (min xyz, max xyz), element by element, op for op as
    render_kernel.py:701-724: the slab interval [tmin, tmax],
    ``enter = max(tmin, 0)`` and ``passes = tmax >= enter``."""
    tmin = tmax = None
    for k in range(3):
        t1 = (box[..., k] - o[..., k]) * inv_d[k]
        t2 = (box[..., 3 + k] - o[..., k]) * inv_d[k]
        lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
        tmin = lo if tmin is None else torch.maximum(tmin, lo)
        tmax = hi if tmax is None else torch.minimum(tmax, hi)
    enter = torch.clamp_min(tmin, 0.0)
    return tmax >= enter, enter


def leaf_slabs(boxes, o, inv_d):
    """(passes, enter) [N, NL] of rays ``o`` [N, 3] with reciprocal
    directions ``inv_d`` (three [N] tensors) against the AABBs ``boxes``
    [NL, >=6]: ``_slabs`` of every pair. The ray enters the box when it
    passes and ``enter`` lies nearer than its best hit so far. An inverted
    box does not fail it: callers check the box's valid flag first."""
    return _slabs(boxes[None], o[:, None], [x[:, None] for x in inv_d])


def box_unions(boxes: torch.Tensor, fan: int) -> torch.Tensor:
    """[ceil(B / fan), 8] rows in the leaf pack's layout for every ``fan``
    consecutive rows of ``boxes`` [B, 8]: the union AABB of the valid ones
    and a valid flag, 1 when any is valid. A row with none valid gets the
    inverted box (min +BIG, max -BIG) and flag 0, as the JAX package's
    group tables (render_kernel.py:2921-2958)."""
    n = boxes.shape[0]
    m = -(-n // fan)
    dev, f32 = boxes.device, torch.float32
    valid = boxes[:, LEAF_VALID] != 0.0
    pad = torch.zeros(m * fan - n, dtype=torch.bool, device=dev)
    valid = torch.cat([valid, pad])
    inverted = torch.full((m * fan - n, 3), BIG, dtype=f32, device=dev)
    lo = torch.cat([boxes[:, 0:3], inverted])
    hi = torch.cat([boxes[:, 3:6], -inverted])
    lo = torch.where(valid[:, None], lo, BIG).reshape(m, fan, 3).min(dim=1).values
    hi = torch.where(valid[:, None], hi, -BIG).reshape(m, fan, 3).max(dim=1).values
    flag = valid.reshape(m, fan).any(dim=1).to(f32)[:, None]
    return torch.cat([lo, hi, flag, torch.zeros_like(flag)], dim=1)


def leaf_groups(leaf_pack: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(group_pack [NG, 8], super_pack [NS, 8]) of the leaf sweep's cull
    hierarchy: ``box_unions`` of every GROUP_SIZE consecutive leaves, then
    of every SUPER_SIZE consecutive groups."""
    groups = box_unions(leaf_pack, GROUP_SIZE)
    return groups, box_unions(groups, SUPER_SIZE)


def _children(ray, parent, fan, boxes, o, inv_d):
    """The (ray, child, enter) triples, in order, of the children
    parent * fan + j of each (ray, parent) pair whose box is valid and
    passes the ray's slab test."""
    child = (parent[:, None] * fan + torch.arange(fan, device=parent.device)).reshape(-1)
    ray = ray.repeat_interleave(fan)
    keep = child < boxes.shape[0]
    ray, child = ray[keep], child[keep]
    box = boxes[child]
    passes, enter = _slabs(box, o[ray], [x[ray] for x in inv_d])
    keep = passes & (box[:, LEAF_VALID] != 0.0)
    return ray[keep], child[keep], enter[keep]


def _leaf_best(o, d, tri_pack, k_size, ray, leaf):
    """(t, original index, row, n . d) of the best hit of each (ray, leaf)
    pair over the leaf's K rows (BIG and the no-index sentinel where none
    hits), in batches of _PAIR_CHUNK pairs."""
    dev = o.device
    out = []
    for i in range(0, max(ray.shape[0], 1), _PAIR_CHUNK):
        r, lf = ray[i:i + _PAIR_CHUNK], leaf[i:i + _PAIR_CHUNK]
        rows = lf[:, None] * k_size + torch.arange(k_size, device=dev)
        tt, valid, nd = _tri_test(o[r], d[r], tri_pack[rows])
        t_m = torch.where(valid, tt, torch.full_like(tt, BIG))
        best_t = t_m.min(dim=1).values
        orig = tri_pack[rows, TRI_ORIG].to(torch.int32)
        cand = torch.where(valid & (t_m == best_t[:, None]), orig, torch.full_like(orig, _NO_IDX))
        best_idx, k_best = cand.min(dim=1)
        pick = torch.arange(rows.shape[0], device=dev)
        out.append((best_t, best_idx, rows[pick, k_best], nd[pick, k_best]))
    return tuple(torch.cat(x) for x in zip(*out))


def nearest_hit_leaves(o, d, tri_pack, leaf_pack, alive=None, visits=None, groups=None,
                       group_visits=None, super_visits=None):
    """Nearest hit of rays ``o, d`` [N, 3] over the leaf pack of
    ops/cuda/render_kernel.py::pack_scene_leaves: ``tri_pack`` [NL * K, 18]
    (the dense columns, then the original triangle index), ``leaf_pack``
    [NL, 8], under its cull hierarchy ``groups`` (``leaf_groups``; built
    here when not given). The visit order is csrc/leaf_sweep.cuh's:
    super-groups in storage order, the groups of a super-group whose test
    passes, the leaves of a group whose test passes, each test a valid flag
    and a slab test (``_slabs``) passed against the ray's best hit so far;
    a ray tests the K rows of each leaf it enters. ``alive`` (bool [N]):
    rays that sweep at all, the others miss. ``visits``, ``group_visits``,
    ``super_visits`` (int32 [N]): incremented by the leaves, groups and
    super-groups each ray entered.

    Returns (t, idx, hit, front) as ``nearest_hit`` does, idx being the
    original index (the lower one on a tie), and the winning row of
    ``tri_pack`` (0 on a miss).

    Vectorised so that only the cull against the best hit is sequential.
    First the boxes each ray's slab test passes whatever its best hit,
    level by level (so that the groups and leaves of boxes no ray passes
    are never looked at), and the best (t, index) of each (ray, leaf) pair
    that passes. Then step k takes every ray's k-th such leaf in storage
    order, culls it against the best hit so far and updates it. A box
    above the leaves is entered when its slab test passes against the best
    hit at its first leaf: the hierarchy is conservative (leaf_sweep.cuh),
    so a ray enters a leaf only through its group and super-group and the
    counts are the kernel's. The selection is a lexicographic minimum, so
    this equals the kernel's triangle-by-triangle loop. Rays go in chunks
    of _RAY_CHUNK."""
    if groups is None:
        groups = leaf_groups(leaf_pack)
    n = o.shape[0]
    if n > _RAY_CHUNK:
        def cut(x, i):
            return None if x is None else x[i:i + _RAY_CHUNK]

        parts = [
            nearest_hit_leaves(
                o[i:i + _RAY_CHUNK], d[i:i + _RAY_CHUNK], tri_pack, leaf_pack, cut(alive, i), cut(visits, i),
                groups, cut(group_visits, i), cut(super_visits, i),
            )
            for i in range(0, n, _RAY_CHUNK)
        ]
        return tuple(torch.cat(x) for x in zip(*parts))
    dev = o.device
    i32 = torch.int32
    group_pack, super_pack = groups
    n_leaves = leaf_pack.shape[0]
    inv_d = [safe_inv(d[:, k]) for k in range(3)]
    # the boxes each ray's slab test passes, level by level
    passes, enter = leaf_slabs(super_pack, o, inv_d)
    passes &= super_pack[None, :, LEAF_VALID] != 0.0
    if alive is not None:
        passes &= alive[:, None]
    ray_s, sup = passes.nonzero(as_tuple=True)
    enter_s = enter[ray_s, sup]
    ray_g, grp, enter_g = _children(ray_s, sup, SUPER_SIZE, group_pack, o, inv_d)
    ray_l, leaf, enter_l = _children(ray_g, grp, GROUP_SIZE, leaf_pack, o, inv_d)
    pair_t, pair_idx, pair_row, pair_nd = _leaf_best(o, d, tri_pack, tri_pack.shape[0] // n_leaves, ray_l, leaf)

    # the pairs of a ray lie in storage order; rank the rays by their pair
    # count, so that the rays with more than k pairs come first
    counts = torch.bincount(ray_l, minlength=n)
    start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(ray_l.shape[0], device=dev) - start[ray_l]
    by_count = torch.argsort(counts, descending=True, stable=True)
    rank = torch.empty_like(by_count)
    rank[by_count] = torch.arange(n, device=dev)
    n_steps = int(counts.max()) if n else 0
    longer = (n - torch.cumsum(torch.bincount(counts, minlength=n_steps + 1), 0))[:n_steps].tolist()

    def table(x, fill):
        t = torch.full((n, n_steps), fill, dtype=x.dtype, device=dev)
        t[rank[ray_l], pos] = x
        return t

    t_enter, t_t, t_idx = table(enter_l, BIG), table(pair_t, BIG), table(pair_idx, _NO_IDX)
    t_row, t_nd = table(pair_row, 0), table(pair_nd, 0.0)
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    best_idx = torch.full((n,), _NO_IDX, dtype=i32, device=dev)
    best_row = torch.zeros(n, dtype=torch.int64, device=dev)
    best_nd = torch.zeros(n, dtype=torch.float32, device=dev)
    before = torch.empty((n, n_steps), dtype=torch.float32, device=dev)
    entered = torch.zeros(n, dtype=i32, device=dev)
    for k, m in enumerate(longer):
        bt, bi = best_t[:m], best_idx[:m]
        before[:m, k] = bt
        want = t_enter[:m, k] < bt
        entered[:m] += want.to(i32)
        lt, li = t_t[:m, k], t_idx[:m, k]
        take = want & ((lt < bt) | ((lt == bt) & (li < bi)))
        best_row[:m] = torch.where(take, t_row[:m, k], best_row[:m])
        best_nd[:m] = torch.where(take, t_nd[:m, k], best_nd[:m])
        best_idx[:m] = torch.where(take, li, bi)
        best_t[:m] = torch.where(take, lt, bt)
    best_t, best_idx, best_row, best_nd = (x[rank] for x in (best_t, best_idx, best_row, best_nd))
    if visits is not None:
        visits += entered[rank]

    def boxes_entered(ray, first_leaf, enter_box):
        """Per ray, its boxes whose test passes against the best hit at
        their first leaf: the one before the ray's first pair at or after
        it, or the final one."""
        t = best_t[ray]
        if ray_l.numel():
            q = torch.searchsorted(ray_l * n_leaves + leaf, ray * n_leaves + first_leaf)
            t = torch.where(q < (start + counts)[ray], before[rank[ray_l], pos][q.clamp_max(ray_l.numel() - 1)], t)
        return torch.bincount(ray[enter_box < t], minlength=n).to(i32)

    if group_visits is not None:
        group_visits += boxes_entered(ray_g, grp * GROUP_SIZE, enter_g)
    if super_visits is not None:
        super_visits += boxes_entered(ray_s, sup * (GROUP_SIZE * SUPER_SIZE), enter_s)
    hit = best_idx != _NO_IDX
    idx = torch.where(hit, best_idx, torch.zeros_like(best_idx))
    return best_t, idx, hit, hit & (best_nd < 0.0), best_row


class HitRecord(NamedTuple):
    """SoA hit record (reference primitives/hit_record.cuh:13-45)."""

    t: torch.Tensor  # [N] hit distance (BIG on a miss)
    hit: torch.Tensor  # [N] bool
    p: torch.Tensor  # [N, 3] hit point (0 on a miss)
    normal: torch.Tensor  # [N, 3] normal, flipped to face the ray
    front_face: torch.Tensor  # [N] bool
    mat_index: torch.Tensor  # [N] int64
    tri_index: torch.Tensor  # [N] int64 (-1 on a miss)


def intersect_block(o, d, v_normal, v_d, edge_g, edge_c, t_min: float = 0.0, t_max: float = BIG):
    """All-pairs candidate test, rays [N] x triangles [T] -> (t_all [N, T],
    valid [N, T]): the plane hit lies in [t_min, t_max], inside all three
    edges, and the ray is not parallel to the plane (intersect.py:51).
    o, d [N, 3]; v_normal [T, 3]; v_d [T]; edge_g [T, 3, 3]; edge_c [T, 3].
    Its products are XLA's K = 3 matmuls (ops/fp32.py::sum3)."""
    o3, d3 = o[:, None, :], d[:, None, :]
    no = sum3(o3, v_normal[None])
    nd = sum3(d3, v_normal[None])
    t_all = (v_d[None, :] - no) / nd
    ao = sum3(o3[:, :, None, :], edge_g[None]) + edge_c[None]
    ad = sum3(d3[:, :, None, :], edge_g[None])
    inside = (fma(t_all[..., None], ad, ao) >= 0.0).all(dim=-1)
    valid = inside & (nd.abs() >= DENOM_EPS) & (t_all >= t_min) & (t_all <= t_max)
    return t_all, valid


def gather_record(o, d, scene, idx, hit) -> HitRecord:
    """The hit record of the selected triangles ``idx`` [N] (hit [N] bool),
    op for op as intersect.py:111 ``_gather_record``. t is recomputed from
    the selected plane, so gradients flow through it alone; the selection
    is detached. The point comes from the miss-zeroed t, not the
    BIG-masked one: BIG * d would give inf in the backward, and 0 * inf
    NaN."""
    idx = idx.detach().long()
    hit = hit.detach()
    n_sel = scene.normal[idx]
    d_sel = scene.d[idx]
    nd = sum3(n_sel, d)
    no = sum3(n_sel, o)
    t = (d_sel - no) / torch.where(nd.abs() < DENOM_EPS, torch.full_like(nd, DENOM_EPS), nd)
    p = fma(torch.where(hit, t, torch.zeros_like(t))[:, None], d, o)
    t = torch.where(hit, t, torch.full_like(t, BIG))
    # set_face_normal (hit_record.cuh:30-45): flip toward the ray origin
    front = nd < 0.0
    normal = torch.where(front[:, None], n_sel, -n_sel)
    return HitRecord(
        t=t,
        hit=hit,
        p=torch.where(hit[:, None], p, torch.zeros_like(p)),
        normal=normal,
        front_face=front,
        mat_index=scene.mat_index[idx].long(),
        tri_index=torch.where(hit, idx, torch.full_like(idx, -1)),
    )


def nearest_hit_scene(o, d, scene, tri_pack=None, select=None) -> HitRecord:
    """Dense nearest hit over the whole scene, the scene form of
    intersect.py:92 ``nearest_hit``. The selection is ``select(o, d,
    tri_pack)`` -> (t, idx, hit, front), by default the dense intersect
    kernel (ops/cuda/intersect_kernel.py::intersect: the CUDA kernel on
    CUDA tensors, ``nearest_hit`` on the CPU), run without autograd on
    ``tri_pack`` (its ``pack_tris`` of the scene when not given); the
    record is ``gather_record`` of it. The kernel takes its dots in the
    order of the JAX renderer's intersect_block (``xla=True``): in the
    other order a refracted ray re-hits its entry face at t = 0 where JAX's
    finds t < 0 (ROADMAP C6)."""
    from .cuda.intersect_kernel import intersect, pack_tris

    with torch.no_grad():
        if tri_pack is None:
            tri_pack = pack_tris(scene)
        if select is None:
            _, idx, hit, _ = intersect(o.detach(), d.detach(), tri_pack, xla=True)
        else:
            _, idx, hit, _ = select(o.detach(), d.detach(), tri_pack)
    return gather_record(o, d, scene, idx, hit)


def ray_aabb(o, inv_d, bb_min, bb_max, t_min: float = 0.0, t_max: float = BIG):
    """Slab test, rays [N] x boxes [B] -> bool [N, B], with aabb::hit's
    strict ``max <= min -> miss`` (bvh/aabb.cu:7-40; intersect.py:143)."""
    lo = (bb_min[None] - o[:, None]) * inv_d[:, None]
    hi = (bb_max[None] - o[:, None]) * inv_d[:, None]
    near = torch.clamp_min(torch.minimum(lo, hi).amax(dim=-1), t_min)
    far = torch.clamp_max(torch.maximum(lo, hi).amin(dim=-1), t_max)
    return near < far
