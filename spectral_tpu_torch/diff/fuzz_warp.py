"""Exact metal-fuzz pixel gradients: the warped-area estimator on the fuzz
sampling sphere.

Port of spectral_tpu/diff/fuzz_warp.py, whose docstring derives it. The
metallic lobe scatters along m = r + fuzz * s with s uniform on the unit
sphere (materials/material.cu:22-37); with s fixed, radiance is a step
function of fuzz, so every fuzz derivative lives in boundary terms. Two
boundary families exist in s-space, both closed-form in c = 1/fuzz:
the preimages s_pm(c) = mu_pm(c) e - c r of each silhouette direction e
(both branches blended, each with its own kernel), and the absorb horizon
s.n = -c (r.n). Each sample s is composed with their weighted velocity
field; the tangent-plane area element of s -> normalize(s + V(s))
(diff/vertex_warp.py::tangent_plane_det) carries the boundary terms into
autograd. The sphere density is uniform, so no density ratio appears.

Scope (the JAX module's): fuzz only (the edges, the mirror direction and
the normal are detached here); silhouettes at the fuzz-cone rim (disc <
DISC_MIN) are masked out; a fuzz below FUZZ_MIN has no gradient (the 1/fuzz
pole).
"""

from __future__ import annotations

import torch

from .vertex_warp import EdgeSet, _clip, _maximum, _safe_normalize, _sum, tangent_plane_det

FUZZ_MIN = 1e-3
# the kernel's rim cut; the JAX module records the sweep that chose it and
# the ~20% finite-kernel overshoot it leaves (fuzz_warp.py:49-62)
DISC_MIN = 1e-2


def _fuzz_V(o, r, n, edges: EdgeSet, c_live, c0, eps: float, r0: float):
    """The warp field V(s) [N, 3] -> [N, 3] on the fuzz sampling sphere
    (fuzz_warp.py:66). o, r, n [N, 3]: frozen origins, unit mirror
    directions and unit normals; c_live [N]: 1/fuzz (live); c0 [N]: the
    warp's freeze point. All geometry is frozen."""
    qa = (edges.a[None] - o[:, None]).detach()  # [N, E, 3]
    dd = (edges.b - edges.a).detach()
    C = _sum(dd, dd)
    D = _sum(qa, dd)
    E = _sum(qa, qa)
    floor = 1.0 / (r0 * r0 + eps * eps)
    rn = _sum(r, n)
    h0 = -c0 * rn
    abs_ok = h0.abs() < 1.0 - 1e-4  # the horizon cuts the sphere

    def V(s):
        # the frozen scattered direction of this query point, and the
        # closest silhouette direction on each edge (as in _sphere_V)
        w = _safe_normalize(c0[:, None] * r + s)
        A = _sum(w[:, None, :], dd)
        B = _sum(w[:, None, :], qa)
        den = A * D - B * C
        den = torch.where(den.abs() < 1e-12, torch.full_like(den, 1e-12), den)
        sig = _clip((B * D - A * E) / den, 0.0, 1.0)[..., None]
        e = _safe_normalize(qa + sig * dd)
        er = _sum(e, r[:, None, :])  # [N, E]

        def pullback(c):
            c = c[:, None]
            disc = 1.0 - c * c * (1.0 - er * er)
            disc_c = torch.sqrt(_maximum(disc, DISC_MIN))
            mu_p = c * er + disc_c
            mu_m = c * er - disc_c
            cr = (c[..., None] * r[:, None, :])
            return mu_p[..., None] * e - cr, mu_m[..., None] * e - cr, disc > DISC_MIN

        sp0, sm0, ok0 = pullback(c0)
        spl, sml, _ = pullback(c_live)
        # both branches, each with its own kernel: a hard choice of the
        # nearer one makes V discontinuous (+43% bias in the JAX module)
        dp = (s[:, None, :] - sp0).square().sum(-1)
        dm = (s[:, None, :] - sm0).square().sum(-1)
        zero = torch.zeros_like(dp)
        w_p = torch.where(ok0, 1.0 / (dp + eps * eps), zero)
        w_m = torch.where(ok0, 1.0 / (dm + eps * eps), zero)
        num = (w_p[..., None] * (spl - sp0) + w_m[..., None] * (sml - sm0)).sum(1)
        den_w = w_p.sum(1) + w_m.sum(1)

        # the absorb-horizon circle s.n = h(c) = -c (r.n)
        sn = _sum(s, n)
        t_hat = _safe_normalize(s - sn[:, None] * n)

        def q_of(c):
            h = _clip(-c * rn, -1.0 + 1e-6, 1.0 - 1e-6)[:, None]
            return h * n + torch.sqrt(_maximum(1.0 - h * h, 1e-12)) * t_hat

        q0 = q_of(c0)
        d2a = (s - q0).square().sum(-1)
        w_a = torch.where(abs_ok, 1.0 / (d2a + eps * eps), torch.zeros_like(d2a))
        num = num + w_a[:, None] * (q_of(c_live) - q0)
        return num / (den_w + w_a + floor)[:, None]

    return V


def warp_fuzz(s0: torch.Tensor, o: torch.Tensor, r: torch.Tensor, n: torch.Tensor, fuzz: torch.Tensor,
              edges: EdgeSet, eps: float = 2e-2, r0: float = 0.1, frozen_fuzz: torch.Tensor | None = None):
    """(s', det) [N, 3], [N]: warped sphere samples and their tangent-plane
    area element, (s0, 1) at the primal (fuzz_warp.py:143). s0: unit
    sphere samples (the frozen integration variable); o, r, n: origins,
    unit mirror directions and normals (detached here); fuzz [N]: the live
    fuzz. The caller forms m = r + fuzz * s' and multiplies det into the
    path weight. ``frozen_fuzz`` pins the warp's freeze point (default the
    detached live fuzz), for the change-of-variables identity E[warped at
    f0](f) = E[plain](f)."""
    c_live = 1.0 / _maximum(fuzz, FUZZ_MIN)
    if frozen_fuzz is None:
        c0 = c_live.detach()
    else:
        c0 = (1.0 / _maximum(torch.as_tensor(frozen_fuzz, dtype=fuzz.dtype, device=fuzz.device), FUZZ_MIN)
              ).expand_as(c_live)
    V = _fuzz_V(o.detach(), r.detach(), n.detach(), edges, c_live, c0, eps, r0)

    def m(x):
        return _safe_normalize(x + V(_safe_normalize(x)))

    return tangent_plane_det(m, s0)
