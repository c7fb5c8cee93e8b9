"""Three-term Sellmeier dispersion, batched and differentiable.

Port of spectral_tpu/ops/sellmeier.py (reference refraction/sellmeier.cu:
12-23). Wavelengths arrive in nm and are converted to micrometers inside;
the coefficients may carry gradients. The three terms are summed left to
right and the root is correctly rounded, as XLA computes the JAX function.
"""

from __future__ import annotations

import torch

from .fp32 import sqrt


def sellmeier_index(b: torch.Tensor, c: torch.Tensor, lambda_nm: torch.Tensor) -> torch.Tensor:
    """Refractive index n(lambda) from 3-term Sellmeier coefficients.

    b, c: [..., 3]; lambda_nm broadcasts against b[..., 0]. Near a pole n^2
    can go negative in float32; it is clamped at 1e-6 instead of giving NaN
    (the reference would NaN)."""
    lam_um = lambda_nm * 1e-3
    l2 = (lam_um * lam_um)[..., None]
    q = b * l2 / (l2 - c)
    n2 = 1.0 + ((q[..., 0] + q[..., 1]) + q[..., 2])
    return sqrt(torch.clamp_min(n2, 1e-6))
