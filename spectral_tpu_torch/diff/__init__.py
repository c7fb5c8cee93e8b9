"""Differentiable rendering: ``render_chunk_diff`` (the render kernel's
forward, the XLA-style renderer's backward) and the fused residual/replay
estimators (diff/fast.py); the differentiable scene geometry
(diff/geometry.py); the warped-area estimators of vertex positions and
metal fuzz (diff/vertex_warp.py, diff/fuzz_warp.py), which the XLA-style
renderer runs under ``vertex_warp`` and ``fuzz_warp``.
"""

from .fast import (
    render_chunk_diff,
    render_chunk_diff_fused,
    render_chunk_diff_fused_accum,
    render_rays_diff_fused,
)
from .geometry import derive_tri_arrays, scene_with_vertices
from .spectral_reparam import reparam_wavelengths

__all__ = [
    "derive_tri_arrays",
    "render_chunk_diff",
    "render_chunk_diff_fused",
    "render_chunk_diff_fused_accum",
    "render_rays_diff_fused",
    "reparam_wavelengths",
    "scene_with_vertices",
]
