"""Differentiable rendering on the port's fused kernels (diff/fast.py).

``render_chunk_diff`` (megakernel forward, XLA wavefront backward) waits
for the wavefront renderer (ROADMAP A4), and ``diff/geometry.py`` with the
warp estimators for A10.
"""

from .fast import (
    render_chunk_diff_fused,
    render_chunk_diff_fused_accum,
    render_rays_diff_fused,
)

__all__ = [
    "render_chunk_diff_fused",
    "render_chunk_diff_fused_accum",
    "render_rays_diff_fused",
]
