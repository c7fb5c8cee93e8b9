"""Differentiable rendering (diff/fast.py): ``render_chunk_diff`` (the
render kernel's forward, the XLA-style renderer's backward) and the fused
residual/replay estimators. ``diff/geometry.py`` and the warp estimators
wait for ROADMAP A10.
"""

from .fast import (
    render_chunk_diff,
    render_chunk_diff_fused,
    render_chunk_diff_fused_accum,
    render_rays_diff_fused,
)
from .spectral_reparam import reparam_wavelengths

__all__ = [
    "render_chunk_diff",
    "render_chunk_diff_fused",
    "render_chunk_diff_fused_accum",
    "render_rays_diff_fused",
    "reparam_wavelengths",
]
