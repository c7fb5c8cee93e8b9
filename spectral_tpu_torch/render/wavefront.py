"""Framebuffer conversion of the renderer (port of the ``xyz_to_image`` part
of spectral_tpu/render/wavefront.py).

The XLA wavefront renderer itself (trace_paths, render_tile_xyz,
render_chunk with autograd) is a later slice (ROADMAP A4); this slice
renders through the megakernel (ops/cuda/render_kernel.py).
"""

from __future__ import annotations

import torch

from ..ops.color import to_uint8, xyz_to_srgb


def xyz_to_image(xyz_sum: torch.Tensor, samples_per_pixel: int) -> torch.Tensor:
    """XYZ accumulator [..., 3] -> uint8 sRGB on the same device
    (save_to_fb, rendering.cu:140-149 + frame_buffer uchar conversion)."""
    spp = torch.tensor(float(samples_per_pixel), dtype=xyz_sum.dtype, device=xyz_sum.device)
    return to_uint8(xyz_to_srgb(xyz_sum / spp))
