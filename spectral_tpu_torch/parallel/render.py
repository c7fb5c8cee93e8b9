"""Rendering and inverse rendering on one device: the whole image through
the XLA-style renderer, the trainable scene leaves, and the two SGD steps.

Port of spectral_tpu/parallel/render.py (``render_image_sharded`` :41,
``trainable_params`` :234, ``apply_params`` :253, ``train_step_fused``
:269, ``train_step`` :352) for the one-device case, the JAX functions on a
1 x 1 mesh: ``train_step`` differentiates the XLA-style renderer by
autograd, ``train_step_fused`` runs the fused kernels. Row and sample
sharding over several devices, with all-reduced loss and gradients, is
ROADMAP A11; vertex leaves and the warps wait for the warp estimators
(A10).
"""

from __future__ import annotations

import dataclasses

import torch

from ..diff.fast import render_rays_diff_fused
from ..models.materials import tabulate
from ..render.wavefront import chunk_pixels, render_tile_xyz
from ..utils.prng import fold

_MATERIAL_KEYS = ("coeffs", "emission_power", "fuzz", "sellmeier_b", "sellmeier_c")
_VERTEX_KEYS = ("v0", "v1", "v2")


def trainable_params(scene, include_vertices: bool = False) -> dict:
    """The differentiable material leaves: sigmoid-spectrum coefficients,
    emission powers, metal fuzz and Sellmeier coefficients."""
    if include_vertices:
        raise NotImplementedError("vertex leaves need the warp estimators, not ported yet (ROADMAP A10)")
    m = scene.materials
    return {k: getattr(m, k) for k in _MATERIAL_KEYS}


def apply_params(scene, params: dict):
    """The scene with its material leaves replaced and the SPD table
    re-tabulated."""
    if any(k in params for k in _VERTEX_KEYS):
        raise NotImplementedError("vertex leaves need the warp estimators, not ported yet (ROADMAP A10)")
    mats = dataclasses.replace(scene.materials, **params)
    return dataclasses.replace(scene, materials=tabulate(mats))


def _one_device(n_devices: int, what: str) -> None:
    if n_devices != 1:
        raise NotImplementedError(
            f"{what} on {n_devices} devices: sharding over devices is not ported yet (ROADMAP A11)"
        )


def render_image_sharded(scene, cam, key: int, samples_per_pixel: int, bounce_limit: int, vertex_warp=None,
                         fuzz_warp=None, n_devices: int = 1, draws=None) -> torch.Tensor:
    """Accumulated XYZ [H, W, 3] of the whole image through the XLA-style
    renderer (render.py:41) on one device: the JAX function's shard at
    tile 0 and sample 0, keyed by ``fold(key, 0, 0)`` as that shard folds
    its mesh coordinates (render.py:80). ``draws``: see
    render/wavefront.py::render_tile_xyz."""
    _one_device(n_devices, "render_image_sharded")
    if vertex_warp is not None or fuzz_warp is not None:
        raise NotImplementedError("vertex_warp and fuzz_warp: the warp estimators are not ported yet (ROADMAP A10)")
    h, w = cam.image_height, cam.image_width
    px, py = chunk_pixels(0, 0, w, h, scene.normal.device)
    xyz = render_tile_xyz(scene, cam, px, py, fold(key, 0, 0), samples_per_pixel, bounce_limit, draws=draws)
    return xyz.reshape(h, w, 3)


def train_step(params: dict, scene, cam, target_xyz: torch.Tensor, key: int, samples_per_pixel: int,
               bounce_limit: int, lr: float = 1e-2, vertex_warp: bool = False, fuzz_warp: bool = False,
               n_devices: int = 1, draws=None):
    """One SGD step of inverse rendering through the XLA-style renderer and
    autograd (render.py:352): render the image under ``params`` (material
    leaves), loss = mean((xyz / spp - target)^2) against ``target_xyz``
    [H, W, 3] (mean-per-sample XYZ), and p - lr * g for every leaf.
    Returns (new_params, loss)."""
    _one_device(n_devices, "train_step")
    if vertex_warp or fuzz_warp:
        raise NotImplementedError("vertex_warp and fuzz_warp: the warp estimators are not ported yet (ROADMAP A10)")
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        xyz = render_image_sharded(apply_params(scene, leaves), cam, key, samples_per_pixel, bounce_limit,
                                   draws=draws)
        loss = torch.mean((xyz / float(samples_per_pixel) - target_xyz) ** 2)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True, materialize_grads=True)
    with torch.no_grad():
        new_params = {k: p - lr * g for (k, p), g in zip(leaves.items(), grads)}
    return new_params, loss.detach()


def train_step_fused(
    params: dict,
    scene,
    cam,
    target_xyz: torch.Tensor,
    seed: int,
    samples_per_pixel: int,
    bounce_limit: int,
    lr: float = 1e-2,
    n_devices: int = 1,
):
    """One SGD step of inverse rendering through the fused kernels: the
    residual megakernel renders the whole frame with ``params`` (material
    leaves, usually {coeffs, emission_power}) in one launch, the replay
    kernel gives the gradient, and each leaf becomes p - lr * g.

    Returns (new_params, loss). As in the JAX function, ``loss`` is
    sum((img - target)^2) / (h * w * 3) with img = xyz / spp, while g is the
    gradient of the sum itself, not divided by h * w * 3. ``target_xyz``
    [h, w, 3] is mean-per-sample XYZ on the scene's device."""
    _one_device(n_devices, "train_step_fused")
    h, w = cam.image_height, cam.image_width
    dev = target_xyz.device
    ys, xs = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev), indexing="ij")
    px, py = xs.reshape(-1).to(torch.float32), ys.reshape(-1).to(torch.float32)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    mats = dataclasses.replace(scene.materials, **leaves)
    xyz = render_rays_diff_fused(mats, scene, cam, px, py, int(seed), samples_per_pixel, bounce_limit)
    img = xyz.reshape(h, w, 3) / samples_per_pixel
    local = torch.sum((img - target_xyz) ** 2)
    grads = torch.autograd.grad(local, list(leaves.values()), allow_unused=True, materialize_grads=True)
    with torch.no_grad():
        new_params = {k: p - lr * g for (k, p), g in zip(leaves.items(), grads)}
    return new_params, local.detach() / (h * w * 3)
