"""Dense ray-triangle nearest hit: the plain PyTorch version.

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
"""

from __future__ import annotations

import torch

from .fp32 import dot3, fma

# Ray-parallel-to-plane threshold (reference tri.cu:15)
DENOM_EPS = 1e-8
# "no hit yet" distance; also the distance reported for a miss
BIG = 3.4e38


def nearest_hit(o: torch.Tensor, d: torch.Tensor, tri_pack: torch.Tensor):
    """Nearest hit of rays ``o, d`` [N, 3] over ``tri_pack`` [T, >=16]
    (normal 0:3, plane offset 3, edge_g 4:13, edge_c 13:16).

    Returns (t [N] f32, BIG on a miss; idx [N] int32, 0 on a miss;
    hit [N] bool; front [N] bool: the ray meets the triangle's front face),
    the outputs of the reference's intersect kernel."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    col = lambda k: tri_pack[:, k]  # noqa: E731  [T], broadcast against [N, 1]
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
    valid = inside & (nd.abs() >= DENOM_EPS) & (tt >= 0.0) & (tt < BIG)
    t_masked = torch.where(valid, tt, torch.full_like(tt, BIG))
    idx = torch.argmin(t_masked, dim=1, keepdim=True)
    hit = valid.any(dim=1)
    t = t_masked.gather(1, idx)[:, 0]
    front = hit & (nd.gather(1, idx)[:, 0] < 0.0)
    idx = torch.where(hit, idx[:, 0], torch.zeros_like(idx[:, 0])).to(torch.int32)
    return t, idx, hit, front
