"""Rendering and inverse rendering on one device: the whole image through
the XLA-style renderer, the trainable scene leaves, and the two SGD steps.

Port of spectral_tpu/parallel/render.py (``render_image_sharded`` :41,
``trainable_params`` :234, ``apply_params`` :253, ``train_step_fused``
:269, ``train_step`` :352) for the one-device case, the JAX functions on a
1 x 1 mesh: ``train_step`` differentiates the XLA-style renderer by
autograd, ``train_step_fused`` runs the fused kernels. Row and sample
sharding over several devices, with all-reduced loss and gradients, is
ROADMAP A11. Vertex leaves re-derive the intersection arrays
(diff/geometry.py), and ``vertex_warp`` / ``fuzz_warp`` turn on the
warped-area estimators (diff/vertex_warp.py, diff/fuzz_warp.py) that make
their gradients and the fuzz gradients exact.
"""

from __future__ import annotations

import dataclasses

import torch

from ..diff.fast import render_rays_diff_fused
from ..diff.geometry import scene_with_vertices
from ..diff.vertex_warp import edges_from_vertices
from ..models.materials import tabulate
from ..render.wavefront import chunk_pixels, render_tile_xyz
from ..utils.prng import fold

_MATERIAL_KEYS = ("coeffs", "emission_power", "fuzz", "sellmeier_b", "sellmeier_c")
_VERTEX_KEYS = ("v0", "v1", "v2")


def trainable_params(scene, include_vertices: bool = False) -> dict:
    """The differentiable scene leaves (render.py:234): sigmoid-spectrum
    coefficients, emission powers, metal fuzz, Sellmeier coefficients and,
    with ``include_vertices``, the triangle vertices v0, v1, v2 (exact
    gradients through the warped-area estimator)."""
    m = scene.materials
    p = {k: getattr(m, k) for k in _MATERIAL_KEYS}
    if include_vertices:
        p.update({k: getattr(scene, k) for k in _VERTEX_KEYS})
    return p


def apply_params(scene, params: dict):
    """The scene under ``params`` (render.py:253): material leaves replace
    the materials' and re-tabulate the SPDs; vertex leaves (all three)
    re-derive the intersection arrays differentiably
    (diff/geometry.py::scene_with_vertices). An LBVH is kept as it is."""
    mats = dataclasses.replace(scene.materials, **{k: v for k, v in params.items() if k not in _VERTEX_KEYS})
    scene = dataclasses.replace(scene, materials=tabulate(mats))
    if "v0" in params:
        scene = scene_with_vertices(scene, params["v0"], params["v1"], params["v2"])
    return scene


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
    render/wavefront.py::render_tile_xyz, as are ``vertex_warp`` and
    ``fuzz_warp`` (EdgeSets)."""
    _one_device(n_devices, "render_image_sharded")
    h, w = cam.image_height, cam.image_width
    px, py = chunk_pixels(0, 0, w, h, scene.normal.device)
    xyz = render_tile_xyz(scene, cam, px, py, fold(key, 0, 0), samples_per_pixel, bounce_limit,
                          vertex_warp=vertex_warp, fuzz_warp=fuzz_warp, draws=draws)
    return xyz.reshape(h, w, 3)


def train_step(params: dict, scene, cam, target_xyz: torch.Tensor, key: int, samples_per_pixel: int,
               bounce_limit: int, lr: float = 1e-2, vertex_warp: bool = False, fuzz_warp: bool = False,
               n_devices: int = 1, draws=None):
    """One SGD step of inverse rendering through the XLA-style renderer and
    autograd (render.py:352): render the image under ``params`` (material
    leaves), loss = mean((xyz / spp - target)^2) against ``target_xyz``
    [H, W, 3] (mean-per-sample XYZ), and p - lr * g for every leaf.
    Returns (new_params, loss). ``params`` may hold vertex leaves
    (``trainable_params(include_vertices=True)``); with ``vertex_warp``
    their gradients go through the warped-area estimator, whose edges are
    those of the live leaves (render.py:379-383), and with ``fuzz_warp``
    the fuzz gradients through the fuzz-sphere warp, on the scene's edges
    (:384-386)."""
    _one_device(n_devices, "train_step")
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        s = apply_params(scene, leaves)
        vw = fz = None
        if vertex_warp and "v0" in leaves:
            vw = edges_from_vertices(leaves["v0"], leaves["v1"], leaves["v2"])
        if fuzz_warp:
            fz = edges_from_vertices(s.v0, s.v1, s.v2)
        xyz = render_image_sharded(s, cam, key, samples_per_pixel, bounce_limit, vertex_warp=vw, fuzz_warp=fz,
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
