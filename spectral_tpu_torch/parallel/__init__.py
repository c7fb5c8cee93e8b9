"""Rendering and inverse rendering over a (tile, sample) mesh of devices on
torch.distributed, one process per device (the XLA-style renderer and the
fused kernels); with no process group, on one device."""

from .distributed import init_distributed, local_row_block, make_global_mesh
from .mesh import SAMPLE_AXIS, TILE_AXIS, Mesh, factor_devices, make_mesh, mesh_of_shape
from .render import (
    apply_params,
    fused_loss_and_grads,
    loss_and_grads,
    render_image_sharded,
    render_image_sharded_pallas,
    train_step,
    train_step_fused,
    trainable_params,
)

__all__ = [
    "SAMPLE_AXIS",
    "TILE_AXIS",
    "init_distributed",
    "local_row_block",
    "make_global_mesh",
    "factor_devices",
    "make_mesh",
    "apply_params",
    "render_image_sharded",
    "render_image_sharded_pallas",
    "train_step",
    "train_step_fused",
    "trainable_params",
    "Mesh",
    "mesh_of_shape",
    "loss_and_grads",
    "fused_loss_and_grads",
]
