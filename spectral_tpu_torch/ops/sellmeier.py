"""Three-term Sellmeier dispersion, batched and differentiable.

Port of spectral_tpu/ops/sellmeier.py (reference refraction/sellmeier.cu:
12-23). Wavelengths arrive in nm and are converted to micrometers inside;
the coefficients may carry gradients.
"""

from __future__ import annotations

import torch


def sellmeier_index(b: torch.Tensor, c: torch.Tensor, lambda_nm: torch.Tensor) -> torch.Tensor:
    """Refractive index n(lambda) from 3-term Sellmeier coefficients.

    b, c: [..., 3]; lambda_nm broadcasts against b[..., 0]. Near a pole n^2
    can go negative in float32; it is clamped at 1e-6 instead of giving NaN
    (the reference would NaN)."""
    lam_um = lambda_nm * 1e-3
    l2 = (lam_um * lam_um)[..., None]
    n2 = 1.0 + torch.sum(b * l2 / (l2 - c), dim=-1)
    return torch.sqrt(torch.clamp_min(n2, 1e-6))
