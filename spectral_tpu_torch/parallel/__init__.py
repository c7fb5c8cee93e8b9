"""Inverse rendering on the port's fused kernels (one device)."""

from .render import apply_params, train_step_fused, trainable_params

__all__ = ["apply_params", "train_step_fused", "trainable_params"]
