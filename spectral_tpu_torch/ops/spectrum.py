"""Spectral sampling primitives (port of spectral_tpu/ops/spectrum.py).

- ``spectrum_interp_shared``: the scene build's lookup of one shared SPD;
- ``spectrum_interp`` (:44), ``hero_wavelengths`` (:76) and
  ``spectrum_to_xyz`` (:93): the XLA-style renderer's (render/wavefront.py)
  per-ray lookups, hero-wavelength sampling and XYZ integration.

The reference's lookup (spectrum/spectrum.cu:11-22) clamps the integer
cell to [0, n-2] but not the fractional weight, so out-of-range
wavelengths extrapolate linearly. The render kernels do the same lookup
inline; ``ops/cuda/render_kernel.py`` repeats it in its plain version. The
renderer's lerp is fused as XLA's CPU backend fuses the JAX expression
``(1 - w) * lo + w * hi`` (ops/fp32.py).
"""

from __future__ import annotations

import torch

from ..utils.constants import LAMBDA_MAX, LAMBDA_MIN, N_RAY_WAVELENGTHS, cie_xyz, to
from .fp32 import fma


def _cell(n: int, lam: torch.Tensor):
    x = (lam - LAMBDA_MIN) * ((n - 1) / (LAMBDA_MAX - LAMBDA_MIN))
    cell = x.to(torch.int32).clamp(0, n - 2).long()
    return cell, x - cell.to(x.dtype)


def spectrum_interp_shared(spd: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Lookup a single shared SPD [n] at a batch of wavelengths [...].

    The integer cell is clamped to [0, n-2] while the fractional weight is
    not, so out-of-range wavelengths extrapolate linearly exactly like the
    reference (spectrum.cu:11-22)."""
    cell, w = _cell(spd.shape[-1], lam)
    return (1.0 - w) * spd[cell] + w * spd[cell + 1]


def spectrum_interp(spd: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear lookup of uniformly sampled SPDs at wavelengths:
    one shared SPD [n] at wavelengths [...], or rows [..., n] each at the
    wavelength [...] beside it. Differentiable in both."""
    n = spd.shape[-1]
    if spd.ndim == 1:
        cell, w = _cell(n, lam)
        return fma(1.0 - w, spd[cell], w * spd[cell + 1])
    return interp_rows(spd.expand(*lam.shape, n), lam[..., None])[..., 0]


def interp_rows(spd_rows: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Per-ray SPD rows [N, S] sampled at per-ray wavelengths [N, W]
    (ray.cuh:60-69; spectral_tpu/ops/shading.py:96 ``_interp_rows``)."""
    cell, w = _cell(spd_rows.shape[-1], lam)
    return fma(1.0 - w, spd_rows.gather(-1, cell), w * spd_rows.gather(-1, cell + 1))


def hero_wavelengths(u, n: int | None = None, n_lambdas: int = N_RAY_WAVELENGTHS) -> torch.Tensor:
    """Hero-wavelength combs [N, n_lambdas], hero at index 0.

    ``u``: the hero uniforms [N] in [0, 1), or a ``torch.Generator`` to draw
    ``n`` of them from. The hero is U[LAMBDA_MIN, LAMBDA_MAX) (as
    ``jax.random.uniform`` maps a uniform to an interval); the other
    n_lambdas - 1 wavelengths follow at equal steps, and those above
    LAMBDA_MAX wrap to the band's start (spectrum.cu:31-48)."""
    if isinstance(u, torch.Generator):
        u = torch.rand(n, generator=u, device=u.device, dtype=torch.float32)
    span = LAMBDA_MAX - LAMBDA_MIN
    step = span / float(n_lambdas)
    hero = torch.clamp_min(fma(u, span, LAMBDA_MIN), LAMBDA_MIN)
    offs = torch.arange(n_lambdas, dtype=torch.float32, device=u.device) * step
    lam = hero[..., None] + offs
    return torch.where(lam > LAMBDA_MAX, lam - span, lam)


def spectrum_to_xyz(wavelengths: torch.Tensor, power: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """Riemann-sum a sampled ray spectrum into CIE XYZ [..., 3]
    (color.cu:88-104): the first ``n_valid`` [...] wavelengths of
    ``wavelengths``, ``power`` [..., W] count, each times
    (LAMBDA_MAX - LAMBDA_MIN) / W. Differentiable in power and
    wavelengths; n_valid is discrete."""
    w = wavelengths.shape[-1]
    delta = (LAMBDA_MAX - LAMBDA_MIN) / float(w)
    idx = torch.arange(w, device=power.device)
    mask = (idx < n_valid[..., None]).to(power.dtype)
    weighted = power * mask * delta
    cie = to(cie_xyz, power.device)
    resp = torch.stack([spectrum_interp(cie[i], wavelengths) for i in range(3)], dim=-1)
    return (weighted[..., None] * resp).sum(dim=-2)
