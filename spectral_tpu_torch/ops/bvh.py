"""Morton codes and the Karras LBVH: the order of the leaf packs, and the
XLA-style renderer's tree for large scenes.

Port of spectral_tpu/ops/bvh.py: ``_expand_bits`` and ``morton_codes``
(:64-81), which the CUDA leaf sweep's packs (ops/cuda/render_kernel.py::
pack_scene_leaves) and the sorted scheduler's key (ops/cuda/
wavefront_kernel.py::_sort_keys) use; and the LBVH (:45-347) that the
XLA-style renderer (render/wavefront.py) walks when a scene carries one
(models/scenes.py::with_bvh).

Build: 30-bit Morton codes of the triangles' box centroids, a stable sort,
then Karras 2012's binary radix tree, each internal node's range and split
computed in closed form, vectorised over nodes. Leaves are clusters of
``leaf_size`` consecutive sorted triangles (the last padded with copies of
the last triangle). The nodes' boxes are fitted bottom up, a level of ready
nodes a pass. Traversal: every ray keeps a stack of STACK_DEPTH node ids;
each step pops one node a ray, slab-tests it against [0, best t], and
pushes an internal node's children or tests a leaf's triangles densely
(the reference's per-thread walk, bvh.cu:99-166, in lock step). Both are
plain PyTorch: the JAX module has no Pallas kernel. The walk's loop tests
``(sp > 0).any()`` on the host once a step.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .fp32 import fma, sum3
from .intersect import BIG, DENOM_EPS, gather_record, intersect_block

STACK_DEPTH = 64  # the reference's MAX_DEPTH (bvh.cuh:12)


@dataclasses.dataclass(frozen=True)
class LBVH:
    """Flat-array BVH over leaf clusters: L leaves, L - 1 internal nodes.
    Internal nodes are ids [0, L - 1); leaf k is id L - 1 + k."""

    node_min: torch.Tensor  # [2L-1, 3] box min per node (internal, then leaves)
    node_max: torch.Tensor  # [2L-1, 3]
    left: torch.Tensor  # [L-1] child id (int64)
    right: torch.Tensor  # [L-1]
    leaf_start: torch.Tensor  # [L] first sorted triangle of each leaf
    order: torch.Tensor  # [T_padded] sorted triangle indices (pad = last)
    leaf_size: int = 8
    n_tris: int = 0


def _expand_bits(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of integer x to every third position (also
    the sorted scheduler's key, spectral_tpu/ops/pallas/
    wavefront_kernel.py:369 ``_spread3``)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_codes(centroids: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes (int32) of float32 points [T, 3] normalized into
    the bounds lo/hi [3]."""
    q = torch.clamp((centroids - lo) / torch.clamp_min(hi - lo, 1e-12), 0.0, 0.99999)
    xyz = (q * 1024.0).to(torch.int64)
    ex, ey, ez = (_expand_bits(xyz[:, k]) for k in range(3))
    return ((ex << 2) | (ey << 1) | ez).to(torch.int32)


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of x as a 32-bit integer (0 <= x < 2^32), int64."""
    x = x.to(torch.int64)
    n = torch.zeros_like(x)
    for shift in (16, 8, 4, 2, 1):
        small = x < (1 << (32 - shift))
        n = torch.where(small, n + shift, n)
        x = torch.where(small, x << shift, x)
    return torch.where(x == 0, torch.full_like(n, 32), n)


def _delta(codes: torch.Tensor, i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Longest common prefix of sorted codes i and j (Karras 2012, section
    4), -1 when j is out of range; equal codes are told apart by their
    indices, so it is defined everywhere in range."""
    n = codes.shape[0]
    valid = (j >= 0) & (j < n)
    jc = j.clamp(0, n - 1)
    x = codes[i] ^ codes[jc]
    lcp = torch.where(x == 0, 32 + _clz32(i ^ jc), _clz32(x))
    return torch.where(valid, lcp, torch.full_like(lcp, -1))


def build_lbvh(bbox_min: torch.Tensor, bbox_max: torch.Tensor, leaf_size: int = 8) -> LBVH:
    """The LBVH over T triangles given their boxes [T, 3] (bvh.py:98)."""
    t = bbox_min.shape[0]
    dev = bbox_min.device
    centroids = 0.5 * (bbox_min + bbox_max)
    lo = bbox_min.amin(dim=0)
    hi = bbox_max.amax(dim=0)
    codes = morton_codes(centroids, lo, hi).to(torch.int64)
    order = torch.argsort(codes, stable=True)
    sorted_codes = codes[order]

    t_pad = -(-t // leaf_size) * leaf_size
    pad = t_pad - t
    order_p = torch.cat([order, order[-1:].repeat(pad)])
    codes_p = torch.cat([sorted_codes, sorted_codes[-1:].repeat(pad)])
    n_leaves = t_pad // leaf_size
    leaf_start = torch.arange(n_leaves, device=dev) * leaf_size
    # each leaf's key: the code of its first triangle
    leaf_codes = codes_p[leaf_start]

    if n_leaves == 1:
        # a single leaf: the scene box, and no internal node to walk
        return LBVH(
            node_min=torch.stack([lo, lo]), node_max=torch.stack([hi, hi]),
            left=torch.zeros(1, dtype=torch.int64, device=dev), right=torch.zeros(1, dtype=torch.int64, device=dev),
            leaf_start=leaf_start, order=order_p, leaf_size=leaf_size, n_tris=t,
        )

    def delta(i, j):
        return _delta(leaf_codes, i, j)

    i = torch.arange(n_leaves - 1, device=dev)
    # the direction and extent of each internal node's range
    d = torch.sign(delta(i, i + 1) - delta(i, i - 1))
    d = torch.where(d == 0, torch.ones_like(d), d)
    delta_min = delta(i, i - d)
    n_search = int(math.ceil(math.log2(max(n_leaves, 2)))) + 2
    lmax = torch.full_like(i, 2)
    for _ in range(n_search):
        lmax = torch.where(delta(i, i + lmax * d) > delta_min, lmax * 2, lmax)
    # binary search for the range's other end; extra steps at 1 change nothing
    length = torch.zeros_like(i)
    step = lmax
    for _ in range(n_search + 2):
        step = (step + 1) >> 1
        length = torch.where(delta(i, i + (length + step) * d) > delta_min, length + step, length)
    j = i + length * d
    # the split: binary search for the highest differing bit
    delta_node = delta(i, j)
    s = torch.zeros_like(i)
    step = length
    for _ in range(n_search + 2):
        step = (step + 1) >> 1
        s = torch.where(delta(i, i + (s + step) * d) > delta_node, s + step, s)
    gamma = i + s * d + torch.clamp_max(d, 0)
    rng_lo = torch.minimum(i, j)
    rng_hi = torch.maximum(i, j)
    left = torch.where(rng_lo == gamma, (n_leaves - 1) + gamma, gamma)
    right = torch.where(rng_hi == gamma + 1, (n_leaves - 1) + gamma + 1, gamma + 1)

    leaf_min = bbox_min[order_p].reshape(n_leaves, leaf_size, 3).amin(dim=1)
    leaf_max = bbox_max[order_p].reshape(n_leaves, leaf_size, 3).amax(dim=1)

    # bottom-up fit: a node is fitted once both children are
    n_int = n_leaves - 1
    inf = torch.full((n_int, 3), float("inf"), dtype=torch.float32, device=dev)
    node_min = torch.cat([inf, leaf_min])
    node_max = torch.cat([-inf, leaf_max])
    ready = torch.cat([torch.zeros(n_int, dtype=torch.bool, device=dev), torch.ones(n_leaves, dtype=torch.bool, device=dev)])
    while not bool(ready[:n_int].all()):
        can = ready[left] & ready[right] & ~ready[:n_int]
        node_min[:n_int] = torch.where(can[:, None], torch.minimum(node_min[left], node_min[right]), node_min[:n_int])
        node_max[:n_int] = torch.where(can[:, None], torch.maximum(node_max[left], node_max[right]), node_max[:n_int])
        ready[:n_int] |= can
    return LBVH(node_min=node_min, node_max=node_max, left=left, right=right, leaf_start=leaf_start,
                order=order_p, leaf_size=leaf_size, n_tris=t)


def nearest_hit_bvh(o: torch.Tensor, d: torch.Tensor, scene, bvh: LBVH):
    """Nearest hit by the lock-step stack walk with dense leaf tests
    (bvh.py:233; bvh::hit, bvh.cu:99-166). The selection is detached and
    the record is ops/intersect.py::gather_record of it, as for the dense
    selection."""
    n = o.shape[0]
    n_leaves = bvh.leaf_start.shape[0]
    n_int = n_leaves - 1
    ls = bvh.leaf_size
    leaf_tris = bvh.order.reshape(n_leaves, ls)
    with torch.no_grad():
        o_, d_ = o.detach(), d.detach()
        if n_int == 0:
            # a single leaf: test everything densely
            tri_idx = leaf_tris[0]
            t_all, valid = intersect_block(o_, d_, scene.normal[tri_idx], scene.d[tri_idx], scene.edge_g[tri_idx],
                                           scene.edge_c[tri_idx])
            t_masked = torch.where(valid, t_all, torch.full_like(t_all, BIG))
            j = torch.argmin(t_masked, dim=-1)
            hit = valid.gather(1, j[:, None])[:, 0]
            return gather_record(o, d, scene, tri_idx[j], hit)
        best_idx, best_valid = _walk(o_, d_, scene, bvh, leaf_tris, n, n_int, n_leaves)
    return gather_record(o, d, scene, best_idx, best_valid)


def _walk(o, d, scene, bvh, leaf_tris, n, n_int, n_leaves):
    dev = o.device
    inv_d = 1.0 / d
    ar = torch.arange(n, device=dev)
    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int64, device=dev)
    sp = torch.ones(n, dtype=torch.int64, device=dev)  # the root, node 0, pushed
    t_best = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    best_idx = torch.zeros(n, dtype=torch.int64, device=dev)
    best_valid = torch.zeros(n, dtype=torch.bool, device=dev)
    while bool((sp > 0).any()):
        active = sp > 0
        sp_pop = torch.where(active, sp - 1, sp)
        top = sp_pop.clamp(0, STACK_DEPTH - 1)
        node = torch.where(active, stack[ar, top], torch.zeros_like(sp))

        # the slab test of one node a ray against [0, t_best] (aabb.cu:34:
        # a strict max <= min is a miss)
        lo = (bvh.node_min[node] - o) * inv_d
        hi = (bvh.node_max[node] - o) * inv_d
        near = torch.clamp_min(torch.minimum(lo, hi).amax(dim=-1), 0.0)
        far = torch.minimum(torch.maximum(lo, hi).amin(dim=-1), t_best)
        hit_box = (near < far) & active
        is_leaf = node >= n_int

        # a leaf: its triangles against the ray, densely
        tri_idx = leaf_tris[(node - n_int).clamp(0, n_leaves - 1)]  # [N, ls]
        vn = scene.normal[tri_idx]
        vd = scene.d[tri_idx]
        eg = scene.edge_g[tri_idx]
        ec = scene.edge_c[tri_idx]
        o3, d3 = o[:, None, :], d[:, None, :]
        no = sum3(o3, vn)
        nd = sum3(d3, vn)
        t_all = (vd - no) / nd
        ao = sum3(o3[:, :, None, :], eg) + ec
        ad = sum3(d3[:, :, None, :], eg)
        inside = (fma(t_all[..., None], ad, ao) >= 0.0).all(dim=-1)
        valid = (
            inside & (nd.abs() >= DENOM_EPS) & (t_all >= 0.0) & (t_all <= t_best[:, None])
            & (hit_box & is_leaf)[:, None]
        )
        t_masked = torch.where(valid, t_all, torch.full_like(t_all, BIG))
        jbest = torch.argmin(t_masked, dim=-1, keepdim=True)
        t_leaf = t_masked.gather(1, jbest)[:, 0]
        v_leaf = valid.gather(1, jbest)[:, 0]
        improved = v_leaf & (t_leaf < t_best)
        t_best = torch.where(improved, t_leaf, t_best)
        best_idx = torch.where(improved, tri_idx.gather(1, jbest)[:, 0], best_idx)
        best_valid = best_valid | improved

        # an internal node: push the left child, then the right (popped first)
        push = hit_box & ~is_leaf
        node_c = node.clamp(0, n_int - 1)
        at0 = sp_pop.clamp(0, STACK_DEPTH - 1)
        stack[ar, at0] = torch.where(push, bvh.left[node_c], stack[ar, at0])
        sp1 = torch.where(push, sp_pop + 1, sp_pop)
        at1 = sp1.clamp(0, STACK_DEPTH - 1)
        stack[ar, at1] = torch.where(push, bvh.right[node_c], stack[ar, at1])
        sp = torch.where(push, sp1 + 1, sp1)
    return best_idx, best_valid
