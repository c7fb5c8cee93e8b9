"""Rendering and inverse rendering over a (tile, sample) device mesh.

Port of spectral_tpu/parallel/render.py (``render_image_sharded`` :41,
``render_image_sharded_pallas`` :101, ``trainable_params`` :234,
``apply_params`` :253, ``train_step_fused`` :269, ``train_step`` :352) on
torch.distributed, one process per device (parallel/mesh.py). Rank
(ti, si) renders the rows of tile ti at spp / n_sample samples; its XYZ is
summed over the sample group, and a function that returns the image
assembles the rows over the tile group, so every rank holds the whole
[H, W, 3] image as JAX's global array is. ``mesh=None`` is the 1 x 1 mesh
of one device, which makes no collective call. Heights or spp that the
mesh extents do not divide raise ValueError.

Two renderers, as in the JAX package: ``render_image_sharded`` and
``train_step`` trace the XLA-style renderer (render/wavefront.py) and
differentiate it by autograd; ``render_image_sharded_pallas`` and
``train_step_fused`` launch the kernels in each shard (the dense
megakernel, the leaf megakernel or the sorted scheduler; the residual
forward and its replay).

Gradients. The XYZ sum over the sample group passes the cotangent on
unchanged (mesh.py::_SumAcross), and the parameter gradients are
all-reduced once over every rank; that is the gradient of the loss over
the whole image. JAX's ``train_step_fused`` differentiates a loss that
holds a psum inside ``shard_map(check_vma=False)`` and then psums the
gradients, so its gradient is n_sample times this one (ROADMAP C8);
``torch.distributed.nn``'s all_reduce, whose backward all-reduces the
cotangent again, would do the same.

Vertex leaves re-derive the intersection arrays (diff/geometry.py), and
``vertex_warp`` / ``fuzz_warp`` turn on the warped-area estimators
(diff/vertex_warp.py, diff/fuzz_warp.py); their EdgeSets are built on every
rank from the same leaves.
"""

from __future__ import annotations

import dataclasses

import torch

from ..diff.fast import render_rays_diff_fused
from ..diff.geometry import scene_with_vertices
from ..diff.vertex_warp import edges_from_vertices
from ..models.materials import tabulate
from ..ops.cuda.render_kernel import render_chunk
from ..render.wavefront import chunk_pixels, render_tile_xyz
from ..utils.prng import fold
from ..utils.trace import span
from .mesh import SAMPLE_AXIS, TILE_AXIS, Mesh

_MATERIAL_KEYS = ("coeffs", "emission_power", "fuzz", "sellmeier_b", "sellmeier_c")
_VERTEX_KEYS = ("v0", "v1", "v2")
# the shard seeds' strides of the kernel paths (render.py:175, :290)
RENDER_SEED_STRIDE = 7919999
FUSED_SEED_STRIDE = 7919993


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


def _mesh(mesh: Mesh | None, device) -> Mesh:
    return Mesh.one(device) if mesh is None else mesh


def _sum_grads(mesh: Mesh, grads) -> list[torch.Tensor]:
    """The gradients summed over every rank, in one all-reduce."""
    if not mesh.distributed:
        return list(grads)
    flat = mesh.sum(torch.cat([g.reshape(-1) for g in grads]))
    return [part.reshape(g.shape) for part, g in zip(flat.split([g.numel() for g in grads]), grads)]


def _shard_rows_xyz(scene, cam, key: int, mesh: Mesh, samples_per_pixel: int, bounce_limit: int, vertex_warp,
                    fuzz_warp, draws):
    """(row0, rows, XYZ [rows, W, 3]) of this rank's tile through the
    XLA-style renderer, summed over the sample group; the shard is keyed by
    ``fold(key, ti, si)`` (render.py:80)."""
    h, w = cam.image_height, cam.image_width
    row0, rows, local_spp = mesh.shard(h, samples_per_pixel)
    px, py = chunk_pixels(0, row0, w, rows, scene.normal.device)
    xyz = render_tile_xyz(scene, cam, px, py, fold(key, mesh.ti, mesh.si), local_spp, bounce_limit,
                          vertex_warp=vertex_warp, fuzz_warp=fuzz_warp, draws=draws)
    return row0, rows, mesh.sum(xyz, SAMPLE_AXIS).reshape(rows, w, 3)


def render_image_sharded(scene, cam, key: int, samples_per_pixel: int, bounce_limit: int, vertex_warp=None,
                         fuzz_warp=None, mesh: Mesh | None = None, draws=None) -> torch.Tensor:
    """Accumulated XYZ [H, W, 3] of the whole image through the XLA-style
    renderer (render.py:41), on every rank of ``mesh``. ``draws``: this
    rank's shard's draws (render/wavefront.py::render_tile_xyz), as are
    ``vertex_warp`` and ``fuzz_warp`` (EdgeSets). Differentiable; each
    rank's gradient is its shard's share, and their sum over every rank the
    gradient of the whole image."""
    mesh = _mesh(mesh, scene.normal.device)
    row0, _, xyz = _shard_rows_xyz(scene, cam, key, mesh, samples_per_pixel, bounce_limit, vertex_warp, fuzz_warp,
                                   draws)
    return mesh.assemble_rows(xyz, row0, cam.image_height)


def render_image_sharded_pallas(scene, cam, seed: int, samples_per_pixel: int, bounce_limit: int,
                                mesh: Mesh | None = None, sched: str = "sorted") -> torch.Tensor:
    """Accumulated XYZ [H, W, 3] of the whole image through the render
    kernels (render.py:101), on every rank of ``mesh``. Each shard is one
    ops/cuda/render_kernel.py::render_chunk of its rows, dispatched as
    ``pack_scene_auto`` packs the scene: a dense scene launches the dense
    megakernel; a leaf pack of more than one leaf the sorted scheduler, or
    with ``sched="mega"`` the leaf megakernel (the JAX function reads that
    choice from BVH_SCHED). The shard's seed is seed + (ti * ns + si) *
    RENDER_SEED_STRIDE (render.py:175), and every path, the sorted one
    included, hashes its draws from it on the device: the JAX function's
    sorted path draws threefry planes instead (:176-183). The port pads no
    ray tile, so there is no ``ray_tile`` and no ``interpret``."""
    mesh = _mesh(mesh, scene.normal.device)
    h, w = cam.image_height, cam.image_width
    row0, rows, local_spp = mesh.shard(h, samples_per_pixel)
    xyz = render_chunk(scene, cam, mesh.shard_seed(seed, RENDER_SEED_STRIDE), 0, row0, w, rows, local_spp,
                       bounce_limit, sched=sched)
    return mesh.assemble_rows(mesh.sum(xyz, SAMPLE_AXIS), row0, h)


def loss_and_grads(params: dict, scene, cam, target_xyz: torch.Tensor, key: int, samples_per_pixel: int,
                   bounce_limit: int, vertex_warp: bool = False, fuzz_warp: bool = False, mesh: Mesh | None = None,
                   draws=None) -> tuple[torch.Tensor, dict]:
    """(loss, gradients) of train_step's loss, mean((xyz / spp - target)^2)
    over the whole image, with respect to every leaf of ``params``, on
    every rank of ``mesh``: each rank's rows give their part of the loss,
    summed over the tile group, and the gradients are summed over every
    rank. ``vertex_warp``: the warped-area estimator on the edges of the
    live vertex leaves (render.py:379-383); ``fuzz_warp``: the fuzz-sphere
    warp on the scene's edges (:384-386)."""
    mesh = _mesh(mesh, target_xyz.device)
    h, w = cam.image_height, cam.image_width
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        s = apply_params(scene, leaves)
        vw = fz = None
        if vertex_warp and "v0" in leaves:
            vw = edges_from_vertices(leaves["v0"], leaves["v1"], leaves["v2"])
        if fuzz_warp:
            fz = edges_from_vertices(s.v0, s.v1, s.v2)
        row0, rows, xyz = _shard_rows_xyz(s, cam, key, mesh, samples_per_pixel, bounce_limit, vw, fz, draws)
        sq = (xyz / float(samples_per_pixel) - target_xyz[row0:row0 + rows]) ** 2
        local = torch.sum(sq) / (h * w * 3)
        grads = torch.autograd.grad(local, list(leaves.values()), allow_unused=True, materialize_grads=True)
    return mesh.sum(local.detach(), TILE_AXIS), dict(zip(leaves, _sum_grads(mesh, grads)))


def train_step(params: dict, scene, cam, target_xyz: torch.Tensor, key: int, samples_per_pixel: int,
               bounce_limit: int, lr: float = 1e-2, vertex_warp: bool = False, fuzz_warp: bool = False,
               mesh: Mesh | None = None, draws=None):
    """One SGD step of inverse rendering through the XLA-style renderer and
    autograd (render.py:352): ``loss_and_grads`` of ``params`` against
    ``target_xyz`` [H, W, 3] (mean-per-sample XYZ, every rank holding all
    of it), then p - lr * g for every leaf. Returns (new_params, loss), the
    same on every rank."""
    loss, grads = loss_and_grads(params, scene, cam, target_xyz, key, samples_per_pixel, bounce_limit, vertex_warp,
                                 fuzz_warp, mesh, draws)
    with torch.no_grad():
        new_params = {k: p.detach() - lr * grads[k] for k, p in params.items()}
    return new_params, loss


def fused_loss_and_grads(params: dict, scene, cam, target_xyz: torch.Tensor, seed: int, samples_per_pixel: int,
                         bounce_limit: int, mesh: Mesh | None = None, sched: str = "sorted") -> tuple[torch.Tensor, dict]:
    """(loss, gradients) of ``train_step_fused``'s step through the fused
    kernels, on every rank of ``mesh``: each shard renders its rows with
    ``params`` (material leaves, usually {coeffs, emission_power}) in one
    residual-forward launch (the sorted scheduler's residual form for a
    multi-leaf scene, or the leaf megakernel's with ``sched="mega"``),
    seeded seed + (ti * ns + si) * FUSED_SEED_STRIDE (render.py:290), and
    the replay kernel gives its gradient.

    As in the JAX function, ``loss`` is sum((img - target)^2) / (h * w * 3)
    with img = xyz / spp, the per-tile sums summed over the tile group,
    while the gradients are those of the sum itself, not divided by
    h * w * 3, summed over every rank: the true gradient, not JAX's
    n_sample times it (module docstring). ``target_xyz`` [h, w, 3] is
    mean-per-sample XYZ on the scene's device, every rank holding all of
    it."""
    mesh = _mesh(mesh, target_xyz.device)
    h, w = cam.image_height, cam.image_width
    row0, rows, local_spp = mesh.shard(h, samples_per_pixel)
    px, py = (c.to(torch.float32) for c in chunk_pixels(0, row0, w, rows, target_xyz.device))
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    mats = dataclasses.replace(scene.materials, **leaves)
    xyz = render_rays_diff_fused(mats, scene, cam, px, py, mesh.shard_seed(seed, FUSED_SEED_STRIDE), local_spp,
                                 bounce_limit, sched=sched)
    img = mesh.sum(xyz, SAMPLE_AXIS).reshape(rows, w, 3) / samples_per_pixel
    local = torch.sum((img - target_xyz[row0:row0 + rows]) ** 2)
    grads = torch.autograd.grad(local, list(leaves.values()), allow_unused=True, materialize_grads=True)
    return mesh.sum(local.detach(), TILE_AXIS) / (h * w * 3), dict(zip(leaves, _sum_grads(mesh, grads)))


def train_step_fused(
    params: dict,
    scene,
    cam,
    target_xyz: torch.Tensor,
    seed: int,
    samples_per_pixel: int,
    bounce_limit: int,
    lr: float = 1e-2,
    mesh: Mesh | None = None,
    sched: str = "sorted",
):
    """One SGD step of inverse rendering through the fused kernels
    (render.py:269): ``fused_loss_and_grads``, then p - lr * g for every
    leaf. Returns (new_params, loss), the same on every rank."""
    with span("train.step"):
        loss, grads = fused_loss_and_grads(params, scene, cam, target_xyz, seed, samples_per_pixel, bounce_limit,
                                           mesh, sched)
        with span("train.update"), torch.no_grad():
            new_params = {k: p.detach() - lr * grads[k] for k, p in params.items()}
    return new_params, loss
