"""Exact vertex-position pixel gradients: the warped-area estimator.

Port of spectral_tpu/diff/vertex_warp.py, whose docstring gives the
construction and its four rules. In short: through the plain estimator
d(pixel)/d(vertex) is zero almost everywhere, since geometry only selects
which materials a path multiplies; the whole gradient is the boundary term
at visibility silhouettes. Each sampled integration variable (the camera's
pixel sample, the lambertian bounce direction) is composed with a warp
field built from the scene's triangle edges, whose value is zero and whose
parameter-derivative moves the sample with the silhouettes; autograd of
the warped estimator (warp, area-element determinant, density ratio) then
carries the boundary term. The primal rays are unchanged: V == 0 and the
screen's det == 1 exactly; the sphere warp re-normalizes the lambertian
direction, so its direction and factor move in the last bits.

Derivatives. JAX takes ``jax.jacfwd`` (the screen) and two ``jax.jvp``
(each sphere) inside the function that ``jax.grad`` differentiates; here
they are forward-mode products too (``torch.autograd.forward_ad``), one a
tangent: the screen's two columns of J, a sphere map's J t1 and J t2. The
tangents are computed by ordinary differentiable operations, so the
outer gradient differentiates them (reverse over forward, as JAX's grad
of jvp), and they need no backward pass of their own: inside the
checkpointed bounce (render/wavefront.py) a nested reverse pass would
unpack the checkpoint's saved tensors and recompute the bounce, its
selection included, once a pass.

The NaN invariants of the JAX module are kept select for select:
``_safe_normalize``'s eps of 1e-4 (1e-9 overflows the second derivative),
the ``degen`` select in ``_sphere_V``, the image border as four
zero-velocity edges in ``warp_screen``, and the far-parking of lanes that
do not warp (ops/shading.py). ``jnp.clip`` and ``jnp.maximum`` split the
gradient of a tie in half, as ``torch.maximum`` and ``torch.minimum`` of
two tensors do (``torch.clamp`` passes all of it), so they are written so.

The screen velocity is written (1 - s)(a - sg(a)) + s(b - sg(b)), the JAX
function's pe_live - pe_frozen regrouped: every derivative is the same,
and its u-derivative is exactly 0 at the primal, as in JAX, where XLA
computes pe_live and pe_frozen as one expression (so det == 1 exactly).

``_safe_normalize`` is ``jax.lax.rsqrt``, which XLA's CPU backend computes
as the SSE estimate (rsqrtps, a table of the processor) refined by one
Newton step; PyTorch's rsqrt is not that, so a warped direction may differ
from JAX's in its last bit (ROADMAP C).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.autograd.forward_ad as fwAD


def _maximum(x: torch.Tensor, c: float) -> torch.Tensor:
    """jnp.maximum(x, c): a tie passes half the gradient."""
    return torch.maximum(x, torch.tensor(c, dtype=x.dtype, device=x.device))


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip(x, lo, hi) = minimum(maximum(x, lo), hi): a tie at either
    bound passes half the gradient."""
    return torch.minimum(_maximum(x, lo), torch.tensor(hi, dtype=x.dtype, device=x.device))


def _sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def _safe_normalize(v: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """v / |v| with finite derivatives of every order used at v == 0:
    v * rsqrt(|v|^2 + eps^2) (vertex_warp.py:56). For |v| ~ 1 the value is
    that of v / |v| in float32 (1 + 1e-8 rounds to 1)."""
    n2 = (v * v).sum(-1, keepdim=True)
    return v * torch.rsqrt(n2 + eps * eps)


class EdgeSet(NamedTuple):
    """All 3T triangle edges, live (theta-differentiable)."""

    a: torch.Tensor  # [E, 3] endpoint
    b: torch.Tensor  # [E, 3] endpoint


def edges_from_vertices(v0: torch.Tensor, v1: torch.Tensor, v2: torch.Tensor) -> EdgeSet:
    """EdgeSet of per-triangle vertices [T, 3]: every triangle's 3 edges,
    shared ones kept (equal velocities leave the weighted field unchanged;
    an interior edge has no integrand jump, so no boundary term)."""
    return EdgeSet(a=torch.cat([v0, v1, v2], dim=0), b=torch.cat([v1, v2, v0], dim=0))


def _jvps(m, x: torch.Tensor, tangents) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """(m(x), [J t for t in tangents]) of a per-row map m of x [N, k], J
    its Jacobian at x: one forward-mode pass a tangent."""
    cols = []
    for t in tangents:
        with fwAD.dual_level():
            y, jt = fwAD.unpack_dual(m(fwAD.make_dual(x, t)))
        cols.append(jt)
    return y, cols


# ---------------------------------------------------------------------------
# camera (screen-space) warp
# ---------------------------------------------------------------------------


def screen_project(cam, p: torch.Tensor):
    """World points [E, 3] -> continuous pixel coordinates (fx, fy) [E]
    each and a validity mask (in front of the camera): Cramer's rule on
    [du | dv | -(p - c)] (fx, fy, s)^T = c - pixel00, inverting
    generate_rays' pixel = pixel00 + fx du + fy dv (vertex_warp.py:99);
    s = 1/t > 0 selects points in front."""
    du, dv, c = cam.pixel_delta_u, cam.pixel_delta_v, cam.center
    rhs = c - cam.pixel00_loc
    w = -(p - c)

    def det3(x, y, z):
        return _sum(x, _cross(y, z))

    duE, dvE, rhsE = du.expand_as(w), dv.expand_as(w), rhs.expand_as(w)
    big_d = det3(duE, dvE, w)
    safe = torch.where(big_d.abs() < 1e-20, torch.full_like(big_d, 1e-20), big_d)
    fx = det3(rhsE, dvE, w) / safe
    fy = det3(duE, rhsE, w) / safe
    s = det3(duE, dvE, rhsE) / safe
    return fx, fy, (s > 1e-9) & (big_d.abs() >= 1e-20)


def warp_screen(cam, edges: EdgeSet, eps_px: float = 0.05, r0_px: float = 1.5):
    """The screen warp field V(u) [N, 2] -> [N, 2] (pixel units) of the
    edges' projections (vertex_warp.py:129). The image border enters as
    four zero-velocity edges: without them the field's 1/d^2 tail leaves
    the film and the change of variables picks up a spurious boundary flux
    (7.4%/15% gradient deficit measured in the JAX module)."""
    ax, ay, a_ok = screen_project(cam, edges.a)
    bx, by, b_ok = screen_project(cam, edges.b)
    a2 = torch.stack([ax, ay], -1)
    b2 = torch.stack([bx, by], -1)
    w_px = float(cam.image_width) - 0.5
    h_px = float(cam.image_height) - 0.5
    corners = torch.tensor([[-0.5, -0.5], [w_px, -0.5], [w_px, h_px], [-0.5, h_px]], dtype=torch.float32,
                           device=a2.device)
    a2 = torch.cat([a2, corners], 0)
    b2 = torch.cat([b2, torch.roll(corners, -1, 0)], 0)
    ok = torch.cat([(a_ok & b_ok).detach(), torch.ones(4, dtype=torch.bool, device=a2.device)], 0)
    af, bf = a2.detach(), b2.detach()
    da, db = a2 - af, b2 - bf  # value 0, theta-velocity of the endpoints
    abf = bf - af
    ab2 = torch.clamp_min(_sum(abf, abf), 1e-12)
    floor = 1.0 / (r0_px * r0_px + eps_px * eps_px)

    def V(u):
        rel = u[:, None, :] - af
        s = _clip(_sum(rel, abf) / ab2, 0.0, 1.0)[..., None]  # [N, E, 1]
        pe_frozen = (1.0 - s) * af + s * bf
        vel = (1.0 - s) * da + s * db
        d2 = (u[:, None, :] - pe_frozen).square().sum(-1)
        w = torch.where(ok, 1.0 / (d2 + eps_px * eps_px), torch.zeros_like(d2))
        return (w[..., None] * vel).sum(1) / (w.sum(1) + floor)[:, None]

    return V


def warp_pixel_samples(cam, edges: EdgeSet, fx: torch.Tensor, fy: torch.Tensor, eps_px: float = 0.05,
                       r0_px: float = 1.5):
    """Warped continuous pixel samples (fx', fy', det) [N] each, det the
    2x2 area element of u -> u + V(u) (vertex_warp.py:172). At the primal
    fx' == fx, fy' == fy and det == 1; the gradients carry the primary
    visibility boundary term."""
    V = warp_screen(cam, edges, eps_px, r0_px)
    u = torch.stack([fx, fy], -1)
    e0 = torch.zeros_like(u)
    e0[:, 0] = 1.0
    uv, (j0, j1) = _jvps(lambda x: x + V(x), u, (e0, 1.0 - e0))  # the columns of J
    det = j0[:, 0] * j1[:, 1] - j1[:, 0] * j0[:, 1]
    return uv[:, 0], uv[:, 1], det


# ---------------------------------------------------------------------------
# direction-sphere warp (lambertian bounces)
# ---------------------------------------------------------------------------


def _sphere_V(o: torch.Tensor, edges: EdgeSet, eps: float, r0: float):
    """Directional warp field V(w) [N, 3] -> [N, 3] for origins o [N, 3]
    (vertex_warp.py:193). The closest direction on edge q(s) = (a - o) +
    s (b - a) has s* = (BD - AE) / (AD - BC) (linear stationarity) from
    frozen geometry, w-differentiable; the velocity is normalize(q_live) -
    normalize(q_frozen) at s*, the origin's own motion included."""
    qa_l = edges.a[None] - o[:, None]  # [N, E, 3]
    d_l = edges.b - edges.a  # [E, 3]
    qa, dd = qa_l.detach(), d_l.detach()
    C = _sum(dd, dd)
    D = _sum(qa, dd)
    E = _sum(qa, qa)
    floor = 1.0 / (r0 * r0 + eps * eps)

    def V(w):
        A = _sum(w[:, None, :], dd)
        B = _sum(w[:, None, :], qa)
        den = A * D - B * C
        den = torch.where(den.abs() < 1e-12, torch.full_like(den, 1e-12), den)
        s = _clip((B * D - A * E) / den, 0.0, 1.0)[..., None]
        q_f = qa + s * dd
        e_live = _safe_normalize(qa_l + s * d_l)
        e_frozen = _safe_normalize(q_f)
        # an edge through the origin (|q_f| ~ 0, a hit point on a box seam)
        # has no silhouette direction and a 1/eps velocity: selected out,
        # value and derivatives
        degen = _sum(q_f, q_f) < 1e-6
        vel = torch.where(degen[..., None], torch.zeros_like(e_live), e_live - e_frozen)
        d2 = (w[:, None, :] - e_frozen).square().sum(-1)
        wgt = torch.where(degen, torch.zeros_like(d2), 1.0 / (d2 + eps * eps))
        return (wgt[..., None] * vel).sum(1) / (wgt.sum(1) + floor)[:, None]

    return V


def tangent_plane_det(m, x: torch.Tensor):
    """(m(x), det) [N, 3], [N]: the 2x2 tangent-plane area element of a
    per-row sphere map m at unit points x (vertex_warp.py:235), in an
    orthonormal frame of the detached x (cross with x-hat, y-hat when
    nearly parallel): det = (t1.Jt1)(t2.Jt2) - (t1.Jt2)(t2.Jt1). Both
    sphere warps (this module's and diff/fuzz_warp.py's) use this one
    copy."""
    xf = x.detach()
    t1 = _cross(xf, torch.tensor([1.0, 0.0, 0.0], device=x.device).expand_as(xf))
    alt = _cross(xf, torch.tensor([0.0, 1.0, 0.0], device=x.device).expand_as(xf))
    t1 = torch.where((torch.linalg.vector_norm(t1, dim=-1) < 1e-6)[:, None], alt, t1)
    t1 = t1 / torch.clamp_min(torch.linalg.vector_norm(t1, dim=-1, keepdim=True), 1e-12)
    t2 = _cross(xf, t1)
    y, (j1, j2) = _jvps(m, x, (t1, t2))
    det = _sum(t1, j1) * _sum(t2, j2) - _sum(t1, j2) * _sum(t2, j1)
    return y, det


def warp_directions(o: torch.Tensor, n: torch.Tensor, w0: torch.Tensor, edges: EdgeSet, eps: float = 2e-3,
                    r0: float = 0.05):
    """(w', factor) [N, 3], [N]: warped unit directions and the per-ray
    factor det x rho(w'; n) / rho(w0; sg(n)), value 1 at the primal
    (vertex_warp.py:256). o [N, 3] live bounce origins, n [N, 3] live
    shading normals, w0 [N, 3] unit directions sampled about the detached
    normal (the integration variable is parameter-fixed; the cosine
    density's tilt re-enters through the ratio)."""
    V = _sphere_V(o, edges, eps, r0)

    def m(x):
        return _safe_normalize(x + V(_safe_normalize(x)))

    wp, det = tangent_plane_det(m, w0)
    rho = _maximum(_sum(wp, n), 1e-6) / _maximum(_sum(w0, n).detach(), 1e-6)
    return wp, det * rho
