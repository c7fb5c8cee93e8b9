"""sRGB -> reflectance/illuminance spectrum uplift (sigmoid-polynomial).

Port of spectral_tpu/ops/rgb2spec.py. The representation is the reference's
(color/color_to_spectrum.cuh:69-219): SPD(lambda) = sigmoid(c0*l^2 + c1*l + c2).

``fit_sigmoid_coeffs`` resolves coefficients in the JAX package's order:
the per-process memo, then the stock palette (``data/rgb2spec_fits.npz``,
exact fits for every colour of the stock scenes, used when every colour of
the batch is in it), then the general-colour trilinear table
(``data/rgb2spec_table.npz``, the reference's [3][64][64][64][3] layout;
``lookup_sigmoid_coeffs``) unless RGB2SPEC_EXACT=1, then the multi-start
Levenberg-Marquardt fit on the CIE-Lab round trip under D65
(``lm_fit_coeffs``). Grays take the exact closed form on the last two
routes. The table and the fit are host-side float32 functions of tensors
and run on any device; the fit batches colours and starts into one tensor.

SPD sampling keeps the reference's quirk: sample i is taken at
lambda_i = LAMBDA_MIN + i * (LAMBDA_MAX - LAMBDA_MIN) / N (/N, not /(N-1);
color_to_spectrum.cuh:161,196).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ..utils.constants import (
    LAMBDA_MAX,
    LAMBDA_MIN,
    N_CIE_SAMPLES,
    cie_d65,
    cie_d65_normalized,
    cie_xyz,
    d65_srgb_to_xyz,
    d65_xyz_to_srgb,
    to,
)
from .spectrum import _cell, spectrum_interp_shared

# Wavelengths at which material SPDs are tabulated (reference step = range/N)
SPD_LAMBDAS = LAMBDA_MIN + np.arange(N_CIE_SAMPLES, dtype=np.float32) * (
    LAMBDA_MAX - LAMBDA_MIN
) / N_CIE_SAMPLES

# the fit's wavelength grid: the full 5 nm CIE grid (360, 365, ..., 830)
FIT_LAMBDAS = np.linspace(LAMBDA_MIN, LAMBDA_MAX, N_CIE_SAMPLES, dtype=np.float32)

# the fit's normalized polynomial basis: u = (lambda - MID) / HALF
_MID = 0.5 * (LAMBDA_MIN + LAMBDA_MAX)
_HALF = 0.5 * (LAMBDA_MAX - LAMBDA_MIN)

# the LM fit's steps (rgb2spec.py:157): in-gamut colours reach ~1e-12 Lab MSE
# well before
LM_ITERS = 48

_DATA = os.path.join(os.path.dirname(__file__), "..", "data")
PALETTE_PATH = os.path.join(_DATA, "rgb2spec_fits.npz")
TABLE_PATH = os.path.join(_DATA, "rgb2spec_table.npz")


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


# ---- the general-colour table (color_to_spectrum.cuh:69-151) ---------------


@functools.lru_cache(maxsize=None)
def _coeff_table(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(data [3, N, N, N, 3], scale [N]) of the coefficient table on
    ``device``."""
    with np.load(TABLE_PATH) as z:
        return torch.from_numpy(z["data"]).to(device), torch.from_numpy(z["scale"]).to(device)


def lookup_sigmoid_coeffs(rgb) -> torch.Tensor:
    """Trilinear table fetch of sigmoid coefficients [..., 3] for colours
    [..., 3] on ``rgb``'s device (rgb2spec.py:288-354; the reference's
    get_sigmoid_coeffs, color_to_spectrum.cuh:69-107): the slice is the
    largest component by the reference's comparison chain, z on the table's
    non-uniform scale (searchsorted, FindInterval), x and y on the uniform
    relative grids, then the 8-corner lerp. Grays take the closed form."""
    rgb = torch.as_tensor(rgb, dtype=torch.float32)
    data, scale = _coeff_table(rgb.device)
    res = data.shape[1]
    flat = rgb.reshape(-1, 3)
    r, g, b = flat.unbind(1)
    maxc = torch.where(r > g, torch.where(r > b, 0, 2), torch.where(g > b, 1, 2))

    def comp(k):
        return flat.gather(1, k[:, None])[:, 0]

    z = comp(maxc)
    zs = torch.clamp_min(z, 1e-12)
    x = comp((maxc + 1) % 3) * (res - 1) / zs
    y = comp((maxc + 2) % 3) * (res - 1) / zs
    xi = x.to(torch.int32).clamp(0, res - 2).long()
    yi = y.to(torch.int32).clamp(0, res - 2).long()
    zi = (torch.searchsorted(scale, z.contiguous(), right=True) - 1).clamp(0, res - 2)
    dx = (x - xi)[:, None]
    dy = (y - yi)[:, None]
    dz = ((z - scale[zi]) / (scale[zi + 1] - scale[zi]))[:, None]

    def co(ddx, ddy, ddz):
        return data[maxc, zi + ddz, yi + ddy, xi + ddx]  # [K, 3]

    def lerp(t, a, b_):
        return (1.0 - t) * a + t * b_

    c = lerp(
        dz,
        lerp(dy, lerp(dx, co(0, 0, 0), co(1, 0, 0)), lerp(dx, co(0, 1, 0), co(1, 1, 0))),
        lerp(dy, lerp(dx, co(0, 0, 1), co(1, 0, 1)), lerp(dx, co(0, 1, 1), co(1, 1, 1))),
    )
    is_gray = (r == g) & (g == b)
    return torch.where(is_gray[:, None], _gray_coeffs(r), c).reshape(rgb.shape)


# ---- the Levenberg-Marquardt fit on the pbrt objective ----------------------
# match the CIE Lab of the D65-lit spectrum against the target colour's


def _xyz_of_spd(spd: torch.Tensor) -> torch.Tensor:
    """XYZ [..., 3] of SPD samples [..., 95] on the fit grid against the
    CMFs x D65, normalized so SPD == 1 gives the D65 white (Y = 1)
    (rgb2spec.py:103)."""
    d65 = to(cie_d65, spd.device)
    w = to(cie_xyz, spd.device) * d65  # [3, 95]
    k = 1.0 / torch.sum(w[1])
    return k * (spd @ w.T)


def _lab_f(t: torch.Tensor) -> torch.Tensor:
    d = 6.0 / 29.0
    return torch.where(t > d**3, torch.pow(torch.clamp_min(t, 1e-20), 1.0 / 3.0), t / (3 * d * d) + 4.0 / 29.0)


def _xyz_to_lab(xyz: torch.Tensor, white: torch.Tensor) -> torch.Tensor:
    fx, fy, fz = _lab_f(xyz / white).unbind(-1)
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)], dim=-1)


def _srgb_linear_to_xyz(rgb: torch.Tensor) -> torch.Tensor:
    return rgb @ to(d65_srgb_to_xyz, rgb.device).T


def _table_to_cie_grid(spd_table: torch.Tensor) -> torch.Tensor:
    """SPD tables [..., 95] (tabulated on SPD_LAMBDAS, the /N grid)
    resampled on the 5 nm CIE grid with the renderer's /(N-1) lerp: the
    SPD the renderer observes (rgb2spec.py:132)."""
    cell, w = _cell(spd_table.shape[-1], to(FIT_LAMBDAS, spd_table.device))
    return (1.0 - w) * spd_table[..., cell] + w * spd_table[..., cell + 1]


def _residual(u_coeffs: torch.Tensor, target_lab: torch.Tensor, white: torch.Tensor) -> torch.Tensor:
    """Lab residual [..., 3] of normalized-basis coefficients [..., 3]: the
    sigmoid on the tabulation grid, resampled as the renderer reads it,
    integrated against the CIE curves (rgb2spec.py:140)."""
    u = (_spd_lambdas(u_coeffs.device) - _MID) / _HALF
    x = (u_coeffs[..., 0:1] * u + u_coeffs[..., 1:2]) * u + u_coeffs[..., 2:3]
    spd = 0.5 * x / torch.sqrt(1.0 + x * x) + 0.5
    return _xyz_to_lab(_xyz_of_spd(_table_to_cie_grid(spd)), white) - target_lab


def _residual_jacobian(u_coeffs: torch.Tensor, white: torch.Tensor) -> torch.Tensor:
    """d _residual / d u_coeffs [n, 3 (Lab), 3 (coefficient)] in closed form,
    the chain that jax.jacfwd differentiates: the basis (u^2, u, 1), the
    sigmoid's 0.5 / (1 + x^2)^1.5, the linear resampling and integration,
    and Lab's cube root ((1/3) f^-2, f its value) or linear segment."""
    u = (_spd_lambdas(u_coeffs.device) - _MID) / _HALF
    basis = torch.stack([u * u, u, torch.ones_like(u)])  # [3, 95]
    x = (u_coeffs[:, 0:1] * u + u_coeffs[:, 1:2]) * u + u_coeffs[:, 2:3]
    s = torch.sqrt(1.0 + x * x)
    spd = 0.5 * x / s + 0.5
    d_spd = (0.5 / (s * s * s))[:, None, :] * basis  # [n, 3, 95]
    xyz = _xyz_of_spd(_table_to_cie_grid(spd))  # [n, 3]
    d_xyz = _xyz_of_spd(_table_to_cie_grid(d_spd))  # [n, 3 (coefficient), 3 (xyz)]
    t = xyz / white
    d = 6.0 / 29.0
    f = torch.pow(torch.clamp_min(t, 1e-20), 1.0 / 3.0)
    df = torch.where(t > d**3, (1.0 / 3.0) / (f * f), torch.full_like(t, 1.0 / (3 * d * d)))
    d_f = df[:, None, :] * (d_xyz / white)  # [n, 3 (coefficient), 3 (f)]
    fx, fy, fz = d_f.unbind(-1)
    return torch.stack([116.0 * fy, 500.0 * (fx - fy), 200.0 * (fy - fz)], dim=1)


def lm_fit_coeffs(rgb) -> torch.Tensor:
    """Raw-lambda coefficients [..., 3] of colours [..., 3] by the JAX
    package's multi-start Levenberg-Marquardt fit (rgb2spec.py:157-220),
    every colour and start in one batch on ``rgb``'s device: five starts
    (flat, rising and falling edges, band and notch) scaled by k0, LM_ITERS
    damped 3x3 Gauss-Newton steps from damping 1e-4 (x0.33 on an accepted
    step, x4 on a refused one, within [1e-10, 1e8]) keeping the best
    iterate, the best start, then the normalized-u basis converted to raw
    lambda. Grays are fitted too (fit_sigmoid_coeffs gives them the closed
    form)."""
    rgb = torch.as_tensor(rgb, dtype=torch.float32)
    dev = rgb.device
    flat = rgb.reshape(-1, 3)
    k = flat.shape[0]
    white = _xyz_of_spd(torch.ones(N_CIE_SAMPLES, dtype=torch.float32, device=dev))
    target = _xyz_to_lab(_srgb_linear_to_xyz(flat), white)

    m = torch.clamp(flat.mean(-1), 1e-4, 1.0 - 1e-4)
    k0 = (m - 0.5) / torch.sqrt(m * (1.0 - m))
    starts = torch.tensor(
        [[0.0, 0.0, 0.0], [0.0, 20.0, 0.0], [0.0, -20.0, 0.0], [-25.0, 0.0, 10.0], [25.0, 0.0, -10.0]], device=dev
    )
    unit = torch.tensor([0.0, 0.0, 1.0], device=dev)
    c = (starts[None] + unit * k0[:, None, None]).reshape(-1, 3)  # [K * 5, 3], colour-major
    tgt = target.repeat_interleave(5, dim=0)

    def resid(cc, tt):
        return _residual(cc, tt, white)

    eye = torch.eye(3, dtype=torch.float32, device=dev)
    damp = torch.full((c.shape[0],), 1e-4, dtype=torch.float32, device=dev)
    best_c, best_l = c.clone(), torch.full_like(damp, float("inf"))
    for _ in range(LM_ITERS):
        r = resid(c, tgt)
        loss = torch.sum(r * r, -1)
        best_c = torch.where((loss < best_l)[:, None], c, best_c)
        best_l = torch.minimum(loss, best_l)
        jac = _residual_jacobian(c, white)  # [n, 3, 3]
        jt = jac.transpose(-1, -2)
        a = jt @ jac + damp[:, None, None] * eye
        g = (jt @ r[..., None])[..., 0]
        c_new = c - torch.linalg.solve_ex(a, g[..., None])[0][..., 0]
        accept = torch.sum(resid(c_new, tgt) ** 2, -1) < loss
        damp = torch.clamp(torch.where(accept, damp * 0.33, damp * 4.0), 1e-10, 1e8)
        c = torch.where(accept[:, None], c_new, c)
    l_fin = torch.sum(resid(c, tgt) ** 2, -1)
    cs = torch.where((l_fin < best_l)[:, None], c, best_c).reshape(k, 5, 3)
    ls = torch.minimum(l_fin, best_l).reshape(k, 5)
    a, b, kk = cs[torch.arange(k, device=dev), torch.argmin(ls, 1)].unbind(-1)
    c0 = a / (_HALF * _HALF)
    c1 = b / _HALF - 2.0 * a * _MID / (_HALF * _HALF)
    c2 = a * _MID * _MID / (_HALF * _HALF) - b * _MID / _HALF + kk
    return torch.stack([c0, c1, c2], -1).reshape(rgb.shape)


_fit_cache: dict[bytes, np.ndarray] = {}


def fit_sigmoid_coeffs(rgb) -> torch.Tensor:
    """Sigmoid-polynomial coefficients [..., 3] (pbrt order c0, c1, c2)
    for linear-sRGB colours [..., 3] in [0, 1] (rgb2spec.py:357): the memo,
    then the palette when it holds every colour, then the table unless
    RGB2SPEC_EXACT=1, then the LM fit; grays take the closed form. Returns a
    float32 tensor on ``rgb``'s device (CPU for arrays); the lookups run on
    the host."""
    device = rgb.device if isinstance(rgb, torch.Tensor) else torch.device("cpu")
    host = (
        rgb.detach().cpu().numpy() if isinstance(rgb, torch.Tensor) else np.asarray(rgb)
    ).astype(np.float32)
    exact = os.environ.get("RGB2SPEC_EXACT", "0") == "1"
    key = host.tobytes() + repr((host.shape, exact)).encode()
    if key not in _fit_cache:
        batch = host.reshape(-1, 3)
        hit = _lookup_palette(batch)
        if hit is None:
            t = torch.from_numpy(batch)
            if not exact:
                hit = lookup_sigmoid_coeffs(t).numpy()
            else:
                is_gray = (t[:, 0] == t[:, 1]) & (t[:, 1] == t[:, 2])
                hit = torch.where(is_gray[:, None], _gray_coeffs(t[:, 0]), lm_fit_coeffs(t)).numpy()
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


def srgb_to_spectrum(rgb) -> torch.Tensor:
    """Reflectance SPD [..., 95] of linear-sRGB colours [..., 3]
    (color_to_spectrum.cuh:188-219; rgb2spec.py:394)."""
    return spd_from_coeffs_reflectance(fit_sigmoid_coeffs(rgb))


def roundtrip_srgb(spd: torch.Tensor) -> torch.Tensor:
    """Linear sRGB [..., 3] of SPD tables [..., 95] (tabulated on
    SPD_LAMBDAS) under D65, through the renderer's resampling: the fit's
    acceptance metric (rgb2spec.py:423)."""
    xyz = _xyz_of_spd(_table_to_cie_grid(spd))
    return xyz @ to(d65_xyz_to_srgb, spd.device).T
