"""Differentiable scene geometry: tri::init as tensor operations.

Port of spectral_tpu/diff/geometry.py. ``models.geometry.finalize`` derives
the per-triangle intersection arrays (normal, plane offset, sign-folded
affine edge functionals, AABBs) on the host in float64 numpy, which
autograd cannot see. ``derive_tri_arrays`` is the same derivation in
float32 tensor operations, so

    d(pixel) / d(vertex position)

flows through the plane equations and edge functionals into the vertices
(the vertex-gradient family, with the warped-area estimator of
diff/vertex_warp.py making it exact through the renderer).

The discrete quantities (the axis-aligned projection tag, the winding
sign) are piecewise constant in the vertices and detached (geometry.py:53-
60), the "detached selection, smooth selected value" policy of
ops/intersect.py.

The derived arrays feed the dense intersect kernel's pack and
``gather_record`` as the host ones do, so the arithmetic is XLA's on the
CPU (ops/fp32.py, read in the LLVM IR of the jitted JAX function): each
cross-product component is fma(a1, b2, -(a2 * b1)), the norm and the plane
offset are 3-term reductions of products (``sum3``), and the signed area
and the edge constants fuse their left product. The one-hot projections
of the JAX function (a sum of products with 0 and 1) are exact, so they
are gathers here.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.fp32 import fma, sqrt, sum3


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.cross as XLA's CPU backend contracts it."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([fma(a1, b2, -(a2 * b1)), fma(a2, b0, -(a0 * b2)), fma(a0, b1, -(a1 * b0))], dim=-1)


def derive_tri_arrays(v0: torch.Tensor, v1: torch.Tensor, v2: torch.Tensor) -> dict:
    """Differentiable tri::init (primitives/tri.cu:47-84): vertices [T, 3]
    -> the Scene's intersection arrays (v0, v1, v2, normal, d, edge_g,
    edge_c, bbox_min, bbox_max), with finalize's projection tags, winding
    signs, edge-functional layout and AABB padding."""
    f32 = torch.float32
    v0, v1, v2 = v0.to(f32), v1.to(f32), v2.to(f32)

    n = _cross(v1 - v0, v2 - v0)
    norm = sqrt(sum3(n, n))[:, None]
    normal = n / torch.clamp_min(norm, 1e-30)
    d = sum3(normal, v0)

    # axis-aligned plane tags (tri.cu:58-79): discrete, detached
    perp = normal.detach().abs() < 1e-8
    yz = perp[:, 1] & perp[:, 2]
    xz = perp[:, 0] & perp[:, 2]
    xy = perp[:, 0] & perp[:, 1]
    # default / XY: (w, h) = (0, 1); XZ: (0, 2); YZ: (1, 2)
    w_axis = torch.where(yz, 1, 0)
    h_axis = torch.where(xy, 1, torch.where(xz | yz, 2, 1))
    w_idx, h_idx = w_axis[:, None], h_axis[:, None]

    def pw(p):
        return p.gather(1, w_idx)[:, 0]

    def ph(p):
        return p.gather(1, h_idx)[:, 0]

    def dsa(a, b, c):
        """double_signed_area_2D (tri.cu:153-182) on the projected plane."""
        return fma(pw(a) - pw(c), ph(b) - ph(c), -((pw(b) - pw(c)) * (ph(a) - ph(c))))

    with torch.no_grad():
        sign = torch.where(dsa(v0, v1, v2) >= 0, 1.0, -1.0).to(f32)

    w_hot = torch.nn.functional.one_hot(w_axis, 3).to(f32)
    h_hot = torch.nn.functional.one_hot(h_axis, 3).to(f32)
    gs, cs = [], []
    for a, b in ((v0, v1), (v1, v2), (v2, v0)):
        gw = ph(a) - ph(b)
        gh = -(pw(a) - pw(b))
        gs.append(sign[:, None] * (w_hot * gw[:, None] + h_hot * gh[:, None]))
        cs.append(sign * fma(ph(b), pw(a) - pw(b), -(pw(b) * (ph(a) - ph(b)))))
    edge_g = torch.stack(gs, dim=1)
    edge_c = torch.stack(cs, dim=1)

    v = torch.stack([v0, v1, v2], dim=1)
    bb_min = v.amin(dim=1)
    bb_max = v.amax(dim=1)
    pad = (bb_max - bb_min) < 1e-4  # aabb::pad (aabb.cuh:92-102)
    bb_min = torch.where(pad, bb_min - 5e-5, bb_min)
    bb_max = torch.where(pad, bb_max + 5e-5, bb_max)
    return {"v0": v0, "v1": v1, "v2": v2, "normal": normal, "d": d, "edge_g": edge_g, "edge_c": edge_c,
            "bbox_min": bb_min, "bbox_max": bb_max}


def scene_with_vertices(scene, v0: torch.Tensor, v1: torch.Tensor, v2: torch.Tensor):
    """The scene with its intersection arrays derived again from (perhaps
    moved) vertices, differentiably; materials, background and any LBVH
    are kept, as the JAX function's ``dataclasses.replace`` keeps them."""
    return dataclasses.replace(scene, **derive_tri_arrays(v0, v1, v2))
