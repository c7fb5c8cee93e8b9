"""sRGB -> reflectance/illuminance spectrum uplift (sigmoid-polynomial).

Port of spectral_tpu/ops/rgb2spec.py. The representation is the reference's
(color/color_to_spectrum.cuh:69-219): SPD(lambda) = sigmoid(c0*l^2 + c1*l + c2).

This slice resolves coefficients from the per-process memo, then the stock
palette (``data/rgb2spec_fits.npz``, exact fits for every colour of the three
reference scenes), then the closed form for grays. The general-colour
trilinear table and the Levenberg-Marquardt fit of the JAX package are not
ported yet (ROADMAP A2b): a colour outside the palette raises
NotImplementedError.

SPD sampling keeps the reference's quirk: sample i is taken at
lambda_i = LAMBDA_MIN + i * (LAMBDA_MAX - LAMBDA_MIN) / N (/N, not /(N-1);
color_to_spectrum.cuh:161,196).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ..utils.constants import LAMBDA_MAX, LAMBDA_MIN, N_CIE_SAMPLES, cie_d65_normalized
from .spectrum import spectrum_interp_shared

# Wavelengths at which material SPDs are tabulated (reference step = range/N)
SPD_LAMBDAS = LAMBDA_MIN + np.arange(N_CIE_SAMPLES, dtype=np.float32) * (
    LAMBDA_MAX - LAMBDA_MIN
) / N_CIE_SAMPLES

PALETTE_PATH = os.path.join(os.path.dirname(__file__), "..", "data", "rgb2spec_fits.npz")


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Reference sigmoid with inf-check (color_to_spectrum.cuh:38-41)."""
    core = 0.5 * x / torch.sqrt(1.0 + x * x) + 0.5
    return torch.where(
        torch.isposinf(x),
        torch.ones_like(x),
        torch.where(torch.isneginf(x), torch.zeros_like(x), core),
    )


def eval_sigmoid_poly(coeffs: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """SPD(lambda) = sigmoid(c0 lam^2 + c1 lam + c2); coeffs [..., 3] in pbrt
    order, lam broadcasts (color_to_spectrum.cuh:154-157)."""
    c0, c1, c2 = coeffs[..., 0], coeffs[..., 1], coeffs[..., 2]
    x = (c0 * lam + c1) * lam + c2
    return sigmoid(x)


def _gray_coeffs(r: torch.Tensor) -> torch.Tensor:
    """Closed-form coefficients for gray colors; sigmoid(c2) == r exactly.
    Pure 0/1 grays saturate to +-1e6 (color_to_spectrum.cuh:38-41)."""
    denom = torch.sqrt(torch.clamp_min(r * (1.0 - r), 0.0))
    c2 = torch.where(
        denom > 0.0,
        (r - 0.5) / torch.clamp_min(denom, 1e-37),
        torch.where(r >= 0.5, torch.full_like(r, 1e6), torch.full_like(r, -1e6)),
    )
    z = torch.zeros_like(r)
    return torch.stack([z, z, c2], dim=-1)


@functools.lru_cache(maxsize=1)
def _palette() -> tuple[np.ndarray, np.ndarray]:
    """(rgb [K, 3], coeffs [K, 3]) exact fits for the stock scene palettes."""
    with np.load(PALETTE_PATH) as z:
        return z["rgb"].astype(np.float32), z["coeffs"].astype(np.float32)


def _lookup_palette(batch: np.ndarray) -> np.ndarray | None:
    """Exact-match rows of ``batch`` [K, 3] against the palette; coeffs
    [K, 3], or None if any row misses."""
    rgb_t, co_t = _palette()
    out = np.empty((batch.shape[0], 3), np.float32)
    for i, row in enumerate(batch):
        m = np.nonzero((rgb_t == row).all(axis=1))[0]
        if m.size == 0:
            return None
        out[i] = co_t[m[0]]
    return out


_fit_cache: dict[bytes, np.ndarray] = {}


def fit_sigmoid_coeffs(rgb) -> torch.Tensor:
    """Sigmoid-polynomial coefficients [..., 3] for linear-sRGB colours
    [..., 3]: memo, then palette, then the closed form when every colour is
    gray. Returns a float32 tensor on ``rgb``'s device (CPU for arrays)."""
    device = rgb.device if isinstance(rgb, torch.Tensor) else torch.device("cpu")
    host = (
        rgb.detach().cpu().numpy() if isinstance(rgb, torch.Tensor) else np.asarray(rgb)
    ).astype(np.float32)
    key = host.tobytes() + repr(host.shape).encode()
    if key not in _fit_cache:
        batch = host.reshape(-1, 3)
        hit = _lookup_palette(batch)
        if hit is None:
            if not (batch == batch[:, :1]).all():
                raise NotImplementedError(
                    f"colours {batch.tolist()} are not in the stock palette; "
                    "the general-colour rgb2spec table and LM fit are not "
                    "ported yet (ROADMAP A2b)"
                )
            hit = _gray_coeffs(torch.from_numpy(batch[:, 0])).numpy()
        _fit_cache[key] = hit.reshape(host.shape)
    return torch.as_tensor(_fit_cache[key], device=device)


def _spd_lambdas(device) -> torch.Tensor:
    return torch.as_tensor(SPD_LAMBDAS, device=device)


def _d65_on_spd_grid(device) -> torch.Tensor:
    lam = _spd_lambdas(device)
    return spectrum_interp_shared(torch.as_tensor(cie_d65_normalized, device=device), lam)


def srgb_to_illuminance_spectrum(rgb, power: float = 1.0) -> torch.Tensor:
    """Illuminance SPD [..., 95]: power^2 * sigmoid-SPD * normalized D65
    (color_to_spectrum.cuh:158-186)."""
    coeffs = fit_sigmoid_coeffs(rgb)
    base = eval_sigmoid_poly(coeffs[..., None, :], _spd_lambdas(coeffs.device))
    d65 = _d65_on_spd_grid(coeffs.device)
    power = torch.as_tensor(power, dtype=torch.float32, device=coeffs.device)
    if power.ndim:
        return (power**2)[..., None] * base * d65
    return power**2 * base * d65


def spd_from_coeffs_reflectance(coeffs: torch.Tensor) -> torch.Tensor:
    """SPD tabulation [..., 95] from coefficients [..., 3]."""
    return eval_sigmoid_poly(coeffs[..., None, :], _spd_lambdas(coeffs.device))


def spd_from_coeffs_illuminance(coeffs: torch.Tensor, power: torch.Tensor) -> torch.Tensor:
    """Emitter SPD tabulation: power^2 * sigmoid-SPD * normalized D65."""
    d65 = _d65_on_spd_grid(coeffs.device)
    return (power**2)[..., None] * eval_sigmoid_poly(
        coeffs[..., None, :], _spd_lambdas(coeffs.device)
    ) * d65
