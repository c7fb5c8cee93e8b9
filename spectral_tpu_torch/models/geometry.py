"""Host-side scene geometry: triangle soup construction and transforms.

The reference builds its worlds on-device with a single CUDA thread running
composite-primitive constructors that ``new`` triangles into a pointer array
(reference: scene/scene.cu:9-54, primitives/*.cuh). Scene construction is a
one-time O(tens-of-triangles) task, so the port does it on the
host in numpy with the SAME construction order and vertex math, producing a
flat SoA triangle soup that uploads once as device tensors.

Composite factories (citations into the reference CUDA renderer):
- quad      <- primitives/tri_quad.cuh:14-20 (two tris, VECTORS mode)
- box       <- primitives/tri_box.cuh:30-46  (6 quads)
- prism     <- primitives/prism.cuh:23-32    (2 base tris + 3 side quads)
- pyramid   <- primitives/pyramid.cuh:30-47  (base quad + 4 side tris)
- rotate    <- primitives/transform.cu:3-34 + tri.cu:97-119
- translate <- primitives/tri.cu:86-94

Derived per-triangle quantities (normal, D, axis-aligned-plane tag, winding,
edge functionals) mirror tri::init (primitives/tri.cu:47-84) and additionally
precompute the *affine edge functionals* that turn the interior test into
three dot products -- the form both the plain sweep (ops/intersect.py) and
the CUDA kernels (csrc/hit.cuh) evaluate.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

# Axis-aligned plane tags (reference primitives/tri.cuh:9-14); encoded as the
# (w_axis, h_axis) projection used by double_signed_area_2D (tri.cu:153-182).
_AA_AXES = {
    "NONE": (0, 1),  # XY projection is the default branch
    "XY": (0, 1),
    "YZ": (1, 2),
    "XZ": (0, 2),
}


@dataclasses.dataclass
class TriSoup:
    """Mutable host-side triangle soup under construction."""

    v: list  # list of (3, 3) float arrays: rows v0, v1, v2
    mat_index: list  # int per tri

    def __init__(self):
        self.v = []
        self.mat_index = []

    # -- primitive emitters -------------------------------------------------

    def tri(self, v0, v1, v2, mat: int) -> "TriSoup":
        """VERTICES-mode triangle (reference tri.cuh:28-48)."""
        self.v.append(np.array([v0, v1, v2], dtype=np.float64))
        self.mat_index.append(int(mat))
        return self

    def tri_vec(self, q, u, v, mat: int) -> "TriSoup":
        """VECTORS-mode triangle: vertices (Q, Q+u, Q+v)."""
        q = np.asarray(q, np.float64)
        return self.tri(q, q + np.asarray(u, np.float64), q + np.asarray(v, np.float64), mat)

    def quad(self, q, u, v, mat: int) -> "TriSoup":
        """Two triangles (Q,u,v VECTORS) and (Q+u+v,-u,-v VECTORS)
        (reference tri_quad.cuh:14-20)."""
        q = np.asarray(q, np.float64)
        u = np.asarray(u, np.float64)
        v = np.asarray(v, np.float64)
        self.tri_vec(q, u, v, mat)
        self.tri_vec(q + u + v, -u, -v, mat)
        return self

    def box(self, a, b, mats: int | Sequence[int]) -> "TriSoup":
        """Axis-aligned box from two corners; 6 quads = 12 tris, face order
        front/right/back/left/top/bottom (reference tri_box.cuh:30-46)."""
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        mn, mx = np.minimum(a, b), np.maximum(a, b)
        dx = np.array([mx[0] - mn[0], 0.0, 0.0])
        dy = np.array([0.0, mx[1] - mn[1], 0.0])
        dz = np.array([0.0, 0.0, mx[2] - mn[2]])
        m = [mats] * 6 if isinstance(mats, int) else list(mats)
        self.quad([mn[0], mn[1], mx[2]], dx, dy, m[0])  # front
        self.quad([mx[0], mn[1], mx[2]], -dz, dy, m[1])  # right
        self.quad([mx[0], mn[1], mn[2]], -dx, dy, m[2])  # back
        self.quad([mn[0], mn[1], mn[2]], dz, dy, m[3])  # left
        self.quad([mn[0], mx[1], mx[2]], dx, -dz, m[4])  # top
        self.quad([mn[0], mn[1], mn[2]], dx, dz, m[5])  # bottom
        return self

    def prism(self, q, u, v, w, mat: int) -> "TriSoup":
        """Triangular prism: 8 tris (reference prism.cuh:23-32)."""
        q = np.asarray(q, np.float64)
        u = np.asarray(u, np.float64)
        v = np.asarray(v, np.float64)
        w = np.asarray(w, np.float64)
        self.tri_vec(q, v, u, mat)  # bottom (u, v swapped for outward normal)
        self.tri_vec(q + w, u, v, mat)  # top
        self.quad(q, u, w, mat)
        self.quad(q, w, v, mat)
        self.quad(q + u, v - u, w, mat)
        return self

    def pyramid(self, q, u, v, w, mat: int) -> "TriSoup":
        """Base quad + 4 side tris, uniform-material ctor vertex order
        (reference pyramid.cuh:30-47)."""
        q = np.asarray(q, np.float64)
        u = np.asarray(u, np.float64)
        v = np.asarray(v, np.float64)
        w = np.asarray(w, np.float64)
        self.quad(q, u, v, mat)
        top = q + (u + v) / 2.0 + w  # base.center() + w
        v0, v1, v2 = q, q + u, q + v
        v3 = v2 + u
        self.tri(v0, top, v2, mat)
        self.tri(v1, top, v0, mat)
        self.tri(v2, top, v3, mat)
        self.tri(v3, top, v1, mat)
        return self

    # -- transforms over a slice of already-emitted tris ---------------------

    def translate(self, start: int, dir, count: int | None = None) -> "TriSoup":
        d = np.asarray(dir, np.float64)
        end = len(self.v) if count is None else start + count
        for i in range(start, end):
            self.v[i] = self.v[i] + d
        return self

    def rotate(
        self,
        start: int,
        theta: float,
        axis: str,
        pivot=None,
        count: int | None = None,
    ) -> "TriSoup":
        """Rotate tris about X/Y/Z (reference transform.cu:3-34).

        ``pivot=None`` rotates about the world origin (the composites'
        per-tri rotate(local=false) fan-out, e.g. tri_box.cu rotate). A
        composite's local=true rotation translates to/from its center first
        (tri_box.cu / prism.cu / pyramid.cu rotate) -- pass that center as
        ``pivot``. Helpers ``slice_centroid``/``slice_bbox_center`` compute
        the reference's pivot choices."""
        m = rotation_matrix(theta, axis)
        end = len(self.v) if count is None else start + count
        p = np.zeros(3) if pivot is None else np.asarray(pivot, np.float64)
        for i in range(start, end):
            self.v[i] = (self.v[i] - p) @ m.T + p
        return self

    def slice_bbox_center(self, start: int, end: int) -> np.ndarray:
        """tri_box::center(): min corner + half diagonal (tri_box.cuh:125-131)."""
        pts = np.concatenate(self.v[start:end], axis=0)
        mn, mx = pts.min(axis=0), pts.max(axis=0)
        return (mx - mn) / 2.0 + mn

    def slice_vertex_mean(self, start: int, end: int) -> np.ndarray:
        """Mean of all vertices in [start, end) (prism::centroid over its 6
        base vertices, prism.cuh:45-56; pyramid base_center via quad center)."""
        pts = np.concatenate(self.v[start:end], axis=0)
        return pts.mean(axis=0)

    def flip_normals(self, start: int, count: int | None = None) -> "TriSoup":
        """Swap v1 <-> v2 (reference tri.cuh:79-86)."""
        end = len(self.v) if count is None else start + count
        for i in range(start, end):
            self.v[i] = self.v[i][[0, 2, 1]]
        return self

    def __len__(self) -> int:
        return len(self.v)


def rotation_matrix(theta: float, axis: str) -> np.ndarray:
    """Rotation matrix matching transform::assign_rot_matrix
    (reference transform.cu:3-34; applied as matrix_mul(v, m), vec3.cuh:80-91)."""
    c, s = np.cos(theta), np.sin(theta)
    if axis.upper() == "X":
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)
    if axis.upper() == "Y":
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)
    if axis.upper() == "Z":
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)
    raise ValueError(axis)


def finalize(soup: TriSoup) -> dict[str, np.ndarray]:
    """Derive per-triangle quantities (tri::init, reference tri.cu:47-84)
    plus the affine edge functionals.

    Returns float32 SoA arrays:
      v0, v1, v2    [T, 3]   vertices
      normal        [T, 3]   unit plane normal (cross(v1-v0, v2-v0))
      d             [T]      plane offset, normal . v0
      mat_index     [T]      material id
      edge_g        [T, 3, 3] edge-functional gradients (sign-folded)
      edge_c        [T, 3]    edge-functional constants (sign-folded)
      bbox_min/max  [T, 3]   padded AABBs (aabb.pad, reference aabb.cuh:93-102)

    Interior test: point p is inside tri t iff
        edge_g[t, k] . p + edge_c[t, k] >= 0  for k = 0, 1, 2
    equivalent to is_interior_faster (reference tri.cu:121-128) with the
    clockwise sign folded in.
    """
    v = np.stack(soup.v)  # [T, 3, 3] float64
    t = v.shape[0]
    v0, v1, v2 = v[:, 0], v[:, 1], v[:, 2]

    n = np.cross(v1 - v0, v2 - v0)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    normal = n / np.maximum(norm, 1e-300)
    d = np.einsum("ij,ij->i", normal, v0)

    # axis-aligned plane tag (tri.cu:58-79): the projection axes for the 2D
    # signed-area test
    perp = np.abs(normal) < 1e-8  # perp[:, a]: normal has ~no component on a
    w_axis = np.full(t, 0, np.int64)
    h_axis = np.full(t, 1, np.int64)  # default / XY
    yz = perp[:, 1] & perp[:, 2]  # normal parallel to X
    xz = perp[:, 0] & perp[:, 2]
    xy = perp[:, 0] & perp[:, 1]
    w_axis[xz] = 0
    h_axis[xz] = 2
    w_axis[yz] = 1
    h_axis[yz] = 2
    w_axis[xy] = 0
    h_axis[xy] = 1

    ar = np.arange(t)
    pw = lambda pts: pts[ar, w_axis]  # noqa: E731
    ph = lambda pts: pts[ar, h_axis]  # noqa: E731

    def dsa(a, b, c):
        """double_signed_area_2D(a, b, c) projected per-tri (tri.cu:153-182)."""
        return (pw(a) - pw(c)) * (ph(b) - ph(c)) - (pw(b) - pw(c)) * (ph(a) - ph(c))

    clockwise = dsa(v0, v1, v2) >= 0  # tri.cuh init_clockwise
    sign = np.where(clockwise, 1.0, -1.0)

    # Edge functional for dsa(p, a, b) as an affine map of p:
    #   f(p) = p_w (a_h - b_h) - p_h (a_w - b_w) + [b_h (a_w - b_w) - b_w (a_h - b_h)]
    edge_g = np.zeros((t, 3, 3), np.float64)
    edge_c = np.zeros((t, 3), np.float64)
    for k, (a, b) in enumerate(((v0, v1), (v1, v2), (v2, v0))):
        gw = ph(a) - ph(b)
        gh = -(pw(a) - pw(b))
        edge_g[ar, k, w_axis] = sign * gw
        edge_g[ar, k, h_axis] = sign * gh
        edge_c[:, k] = sign * (ph(b) * (pw(a) - pw(b)) - pw(b) * (ph(a) - ph(b)))

    bb_min = v.min(axis=1)
    bb_max = v.max(axis=1)
    pad = (bb_max - bb_min) < 1e-4
    bb_min = np.where(pad, bb_min - 5e-5, bb_min)
    bb_max = np.where(pad, bb_max + 5e-5, bb_max)

    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    return {
        "v0": f32(v0),
        "v1": f32(v1),
        "v2": f32(v2),
        "normal": f32(normal),
        "d": f32(d),
        "mat_index": np.asarray(soup.mat_index, np.int32),
        "edge_g": f32(edge_g),
        "edge_c": f32(edge_c),
        "bbox_min": f32(bb_min),
        "bbox_max": f32(bb_max),
    }
