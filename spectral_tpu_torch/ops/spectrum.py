"""Spectral sampling primitives (port of spectral_tpu/ops/spectrum.py).

Only what the scene build needs lives here: the piecewise-linear lookup of
a shared 95-sample SPD (reference spectrum/spectrum.cu:11-22). The render
kernels do the same lookup inline; ``ops/cuda/render_kernel.py`` repeats it
in its plain version.
"""

from __future__ import annotations

import torch

from ..utils.constants import LAMBDA_MAX, LAMBDA_MIN


def spectrum_interp_shared(spd: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Lookup a single shared SPD [n] at a batch of wavelengths [...].

    The integer cell is clamped to [0, n-2] while the fractional weight is
    not, so out-of-range wavelengths extrapolate linearly exactly like the
    reference (spectrum.cu:11-22)."""
    n = spd.shape[-1]
    x = (lam - LAMBDA_MIN) * ((n - 1) / (LAMBDA_MAX - LAMBDA_MIN))
    cell = x.to(torch.int32).clamp(0, n - 2).long()
    w = x - cell.to(x.dtype)
    return (1.0 - w) * spd[cell] + w * spd[cell + 1]
