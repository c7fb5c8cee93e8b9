"""Rendering and inverse rendering on one device (the XLA-style renderer
and the fused kernels)."""

from .render import apply_params, render_image_sharded, train_step, train_step_fused, trainable_params

__all__ = ["apply_params", "render_image_sharded", "train_step", "train_step_fused", "trainable_params"]
