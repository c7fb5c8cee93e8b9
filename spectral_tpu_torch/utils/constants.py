"""Physical / colorimetric constants for the spectral pipeline.

Port of spectral_tpu/utils/constants.py. The tables are float32 numpy
arrays (the values the JAX package holds as device arrays); ``to(table,
device)`` makes the device tensor a caller needs. The reference uploads
them to ``__constant__`` memory (utils/cie_const.cuh:20-23,
utils/color_const.cuh:17-19, refraction/sellmeier.cuh:15-20); the port's
kernels take them as arguments and stage them in shared memory.
"""

from __future__ import annotations

import numpy as np
import torch

from .cie_data import CIE_D65, CIE_D65_NORMALIZED, CIE_X, CIE_Y, CIE_Z

# Spectral sampling domain (reference: utils/cie_const.cuh:8-12)
N_CIE_SAMPLES = 95
CIE_CURVE_RES = 5.0
CIE_Y_INTEGRAL = 106.856895
LAMBDA_MIN = 360.0
LAMBDA_MAX = 830.0

# Wavelengths carried per ray; hero wavelength lives at index 0
# (reference: ray/ray.cuh:12)
N_RAY_WAVELENGTHS = 7

# Self-intersection offset applied along the surface normal after scattering
# (reference: materials/material.cuh:14)
EPSILON = 1e-4

_f32 = np.float32

# CIE 1931 color matching functions, shape [95]
cie_x = np.array(CIE_X, dtype=_f32)
cie_y = np.array(CIE_Y, dtype=_f32)
cie_z = np.array(CIE_Z, dtype=_f32)
# Stacked [3, 95] for fused XYZ integration
cie_xyz = np.stack([cie_x, cie_y, cie_z])

# D65 illuminant, raw and normalized to illuminance 1 (Y=1)
cie_d65 = np.array(CIE_D65, dtype=_f32)
cie_d65_normalized = np.array(CIE_D65_NORMALIZED, dtype=_f32)

# Bruce Lindbloom sRGB<->XYZ matrices, D65 white point
# (reference: utils/color_const.cu:13-20)
d65_srgb_to_xyz = np.array(
    [
        [0.4124564, 0.3575761, 0.1804375],
        [0.2126729, 0.7151522, 0.0721750],
        [0.0193339, 0.1191920, 0.9503041],
    ],
    dtype=_f32,
)
d65_xyz_to_srgb = np.array(
    [
        [3.2404542, -1.5371385, -0.4985314],
        [-0.9692660, 1.8760108, 0.0415560],
        [0.0556434, -0.2040259, 1.0572252],
    ],
    dtype=_f32,
)
d50_srgb_to_xyz = np.array(
    [
        [0.4360747, 0.3850649, 0.1430804],
        [0.2225045, 0.7168786, 0.0606169],
        [0.0139322, 0.0971045, 0.7141733],
    ],
    dtype=_f32,
)
d50_xyz_to_srgb = np.array(
    [
        [3.1338561, -1.6168667, -0.4906146],
        [-0.9787684, 1.9161415, 0.0334540],
        [0.0719453, -0.2289914, 1.4052427],
    ],
    dtype=_f32,
)

# Three-term Sellmeier coefficient presets (reference: refraction/sellmeier.cuh:6-13)
SELLMEIER_BK7_B = (1.03961212, 0.231792344, 1.01046945)
SELLMEIER_BK7_C = (6.00069867e-3, 2.00179144e-2, 1.03560653e2)
SELLMEIER_FUSED_SILICA_B = (0.6961663, 0.4079426, 0.8974794)
# NOTE: the reference stores Malitson's sqrt(C) values (0.0684043, ...)
# un-squared (sellmeier.cuh:10), which yields n(589 nm) = 1.564 instead of
# fused silica's 1.4584. BK7 and flint use proper um^2 values, and no scene
# uses fused silica, so the physically-correct squares are stored here.
SELLMEIER_FUSED_SILICA_C = (0.0684043**2, 0.1162414**2, 9.896161**2)
SELLMEIER_FLINT_GLASS_B = (1.34533359, 0.209073176, 0.937357162)
SELLMEIER_FLINT_GLASS_C = (0.00997743871, 0.0470450767, 111.886764)

sellmeier_presets = {
    "BK7": (
        np.array(SELLMEIER_BK7_B, dtype=_f32),
        np.array(SELLMEIER_BK7_C, dtype=_f32),
    ),
    "fused_silica": (
        np.array(SELLMEIER_FUSED_SILICA_B, dtype=_f32),
        np.array(SELLMEIER_FUSED_SILICA_C, dtype=_f32),
    ),
    "flint_glass": (
        np.array(SELLMEIER_FLINT_GLASS_B, dtype=_f32),
        np.array(SELLMEIER_FLINT_GLASS_C, dtype=_f32),
    ),
}


def to(table: np.ndarray, device: torch.device | str) -> torch.Tensor:
    """A constant table as a float32 tensor on ``device``."""
    return torch.as_tensor(np.asarray(table, _f32), device=device)
