"""Morton codes of triangle centroids: the order of the leaf packs.

Port of spectral_tpu/ops/bvh.py:64-81 (``_expand_bits``, ``morton_codes``).
The Karras LBVH build and its traversal wait for the XLA-style wavefront
renderer that uses them (ROADMAP A4); the CUDA leaf sweep only needs the
Morton order (ops/cuda/render_kernel.py::pack_scene_leaves) and the sorted
scheduler's key (ops/cuda/wavefront_kernel.py::_sort_keys).
"""

from __future__ import annotations

import torch


def _expand_bits(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of integer x to every third position (also
    the sorted scheduler's key, spectral_tpu/ops/pallas/
    wavefront_kernel.py:369 ``_spread3``)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_codes(centroids: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes (int32) of float32 points [T, 3] normalized into
    the bounds lo/hi [3]."""
    q = torch.clamp((centroids - lo) / torch.clamp_min(hi - lo, 1e-12), 0.0, 0.99999)
    xyz = (q * 1024.0).to(torch.int64)
    ex, ey, ez = (_expand_bits(xyz[:, k]) for k in range(3))
    return ((ex << 2) | (ey << 1) | ez).to(torch.int32)
