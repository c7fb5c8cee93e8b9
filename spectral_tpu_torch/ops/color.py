"""sRGB <-> CIE XYZ conversion, gamma and quantization (port of
spectral_tpu/ops/color.py; reference color/color.cu).

All functions take tensors shaped [..., 3] and broadcast over leading axes.
The 3x3 products are written out per component rather than as a matmul, so
no TF32 or reduction-order choice of a library can touch them.
"""

from __future__ import annotations

import torch

from ..utils.constants import d65_srgb_to_xyz, d65_xyz_to_srgb


def _mat3(m, v: torch.Tensor) -> torch.Tensor:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    rows = [
        float(m[i][0]) * x + float(m[i][1]) * y + float(m[i][2]) * z
        for i in range(3)
    ]
    return torch.stack(rows, dim=-1)


def srgb_gamma_expand(v: torch.Tensor) -> torch.Tensor:
    """Inverse sRGB gamma, encoded -> linear (color.cu:8-13)."""
    powseg = torch.pow(torch.clamp_min((v + 0.055) / 1.055, 0.0), 2.4)
    return torch.where(v < 0.04045, v / 12.92, powseg)


def srgb_to_xyz(srgb: torch.Tensor, matrix=None) -> torch.Tensor:
    """Encoded sRGB [..., 3] -> XYZ [..., 3] (color.cu:24-33)."""
    m = d65_srgb_to_xyz if matrix is None else matrix
    return _mat3(m, srgb_gamma_expand(srgb))


def srgb_gamma_compress(v: torch.Tensor) -> torch.Tensor:
    """Forward sRGB gamma with the reference's clamping (color.cu:15-22):
    negative -> 0, linear segment below 0.0031308, power segment with the
    reference's truncated exponent 0.416666 below 1, saturate at 1."""
    v_safe = torch.clamp_min(v, 1e-30)
    powseg = 1.055 * torch.pow(v_safe, 0.416666) - 0.055
    out = torch.where(
        v < 0.0031308,
        12.92 * v,
        torch.where(v < 1.0, powseg, torch.ones_like(v)),
    )
    return torch.where(v < 0.0, torch.zeros_like(v), out)


def xyz_to_srgb(xyz: torch.Tensor, matrix=None) -> torch.Tensor:
    """XYZ [..., 3] -> gamma-encoded sRGB [..., 3] (reference color.cu:35-41)."""
    m = d65_xyz_to_srgb if matrix is None else matrix
    return srgb_gamma_compress(_mat3(m, xyz))


def expand_srgb(srgb01: torch.Tensor) -> torch.Tensor:
    """[0,1] floats -> [0,255] floats with the reference's int truncation
    (color.cu:43-49: ``float(int(v * 255.99f))``)."""
    return torch.trunc(srgb01 * 255.99)


def to_uint8(srgb01: torch.Tensor) -> torch.Tensor:
    """Final framebuffer quantization (reference frame_buffer.cuh:31-37)."""
    return torch.clamp(expand_srgb(srgb01), 0.0, 255.0).to(torch.uint8)
