"""Differentiable rendering on the kernels: the megakernel forward with the
XLA-style backward, and the fused residual/replay pair.

Port of spectral_tpu/diff/fast.py. ``render_chunk_diff`` (:95-140) is the
"cheap value, exact gradient of an estimator" pairing: its forward is the
render kernel's chunk (ops/cuda/render_kernel.py::render_chunk), and its
backward is the VJP of the XLA-style wavefront renderer
(render/wavefront.py::render_chunk) at the same seed, with respect to the
material leaves. The two are unbiased estimators of the same integral that
draw different samples; the gradient equals ``torch.autograd.grad`` of the
XLA-style render. Scene geometry and camera get no gradient.

In the fused pair both passes are
kernels: the forward is the render megakernel in its residual form
(ops/cuda/render_kernel.py::render_rays_residuals), which records per
sample the hero wavelength, n_valid, the final power and the material of
every bounce; the backward replays those residuals against the XYZ
cotangent without tracing a ray again (ops/cuda/grad_kernel.py).

Differentiable leaves: the sigmoid-spectrum coefficients and emission power
of every material, the background SPD knots, and, with ``reparam_glass``,
the Sellmeier B/C of that glass through the hero-wavelength
reparameterization (diff/spectral_reparam.py). Fuzz, geometry and camera
get no gradient on this path (zero almost everywhere for this estimator).

Each fused entry is a ``torch.autograd.Function`` whose tensor inputs are
``coeffs``, ``emission_power``, ``sellmeier_b``, ``sellmeier_c`` and
``background_spd``; the public wrappers keep the JAX signatures and take the
dataclasses apart. Without ``rand`` the draws are the kernel's hash of
(key_seed, pixel, sample, draw); ``rand`` [spp, n_uniforms(B), N] injects
uniform planes (the tests hand over the JAX package's), and ``rand_seed``
>= 0 makes such planes from a torch generator.

Scenes above DENSE_CUTOFF triangles take their residual forward through
the leaf pack, routed as the forward render is (fast.py:46-93, here
ops/cuda/render_kernel.py::render_pack): the sorted per-bounce scheduler
(ops/cuda/wavefront_kernel.py) with more than one leaf and
``sched="sorted"``, the default, else the leaf megakernel. The residuals
come back in original ray order either way, and the replay never traces a
ray.

Not here yet: ``diff/geometry.py`` and the warp estimators (ROADMAP A10).
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.camera import camera_vector, chunk_pixels
from ..models.materials import tabulate
from ..ops.cuda.grad_kernel import render_grads
from ..ops.cuda.render_kernel import n_uniforms, pack_scene_frame, render_chunk, render_pack
from ..render import wavefront
from ..utils.trace import span
from .spectral_reparam import reparam_hero

# the material leaves render_chunk_diff differentiates (the float fields of
# Materials that tabulate reads or the renderer uses)
DIFF_LEAVES = ("coeffs", "emission_power", "fuzz", "sellmeier_b", "sellmeier_c")


def _with_materials(scene, materials):
    return dataclasses.replace(scene, materials=tabulate(materials))


class _ChunkDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, *leaves):
        materials, scene, cam, key_seed, x0, y0, width, height, spp, bounces = spec
        mats = dataclasses.replace(materials, **dict(zip(DIFF_LEAVES, leaves)))
        ctx.spec = spec
        ctx.save_for_backward(*leaves)
        return render_chunk(_with_materials(scene, mats), cam, key_seed, x0, y0, width, height, spp, bounces)

    @staticmethod
    def backward(ctx, g):
        materials, scene, cam, key_seed, x0, y0, width, height, spp, bounces = ctx.spec
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(True) for x in ctx.saved_tensors]
            mats = dataclasses.replace(materials, **dict(zip(DIFF_LEAVES, leaves)))
            xyz = wavefront.render_chunk(
                _with_materials(scene, mats), cam, key_seed, x0, y0, width, height, spp, bounces
            )
            grads = torch.autograd.grad(xyz, leaves, g, allow_unused=True, materialize_grads=True)
        return (None, *grads)


def render_chunk_diff(materials, scene, cam, key_seed: int, x0: int, y0: int, width: int, height: int,
                      spp: int, bounces: int) -> torch.Tensor:
    """Accumulated XYZ [height, width, 3] of a chunk from the render kernel
    (seeded with ``key_seed``), differentiable with respect to the
    material leaves DIFF_LEAVES of ``materials``: the backward is the VJP
    of the XLA-style render_chunk keyed by ``key_seed``
    (spectral_tpu/diff/fast.py:95-140). ``materials`` replaces
    ``scene.materials`` (its SPD table is re-tabulated)."""
    spec = (materials, scene, cam, int(key_seed), x0, y0, width, height, spp, bounces)
    return _ChunkDiff.apply(spec, *(getattr(materials, k) for k in DIFF_LEAVES))


def _rays_fwd_impl(materials, scene, cam, px, py, key_seed, spp, bounces, rand=None, sched="sorted"):
    """xyz [N, 3] and the residuals (mat, tab, hero, n_valid, power, matres)
    the backward replays."""
    cam_vec = camera_vector(cam).to(scene.normal.device)
    with span("train.pack"):
        pack = pack_scene_frame(dataclasses.replace(scene, materials=materials), cam_vec)
    with span("train.forward"):
        xyz, hero, n_valid, power, matres = render_pack(
            cam_vec, int(key_seed), pack, px, py, spp, bounces, cam.image_width, rand, residuals=True, sched=sched,
        )
    return xyz, (pack.mat, pack.tab, hero, n_valid, power, matres)


def _chunk_rays(scene, x0, y0, width, height, spp, bounces, rand_seed, rand):
    """Row-major pixel coordinates (px, py) [N] of a chunk on the scene's
    device, and its planes: ``rand``, else made from ``rand_seed`` >= 0,
    else None (hash draws)."""
    dev = scene.normal.device
    px, py = chunk_pixels(x0, y0, width, height, dev)
    if rand is None and rand_seed >= 0:
        gen = torch.Generator(device=dev).manual_seed(rand_seed)
        rand = torch.rand((spp, n_uniforms(bounces), width * height), generator=gen, device=dev)
    return px.to(torch.float32), py.to(torch.float32), rand


def _fused_fwd_impl(
    materials, scene, cam, key_seed, x0, y0, width, height, spp, bounces,
    rand_seed=-1, rand=None, sched="sorted",
):
    """Accumulated XYZ [height, width, 3] of the chunk and its residuals, in
    row-major pixel order (the port neither swizzles pixels into blocks nor
    pads them)."""
    px, py, rand = _chunk_rays(scene, x0, y0, width, height, spp, bounces, rand_seed, rand)
    xyz, residuals = _rays_fwd_impl(materials, scene, cam, px, py, key_seed, spp, bounces, rand, sched)
    return xyz.reshape(height, width, 3), residuals


@dataclasses.dataclass(frozen=True)
class _Spec:
    """The non-tensor arguments of one fused render."""

    materials: object
    scene: object
    cam: object
    px: torch.Tensor
    py: torch.Tensor
    key_seed: int
    spp: int
    bounces: int
    rand: torch.Tensor | None
    reparam_glass: int | None
    sched: str


class _FusedRays(torch.autograd.Function):
    @staticmethod
    def forward(ctx, coeffs, emission_power, sellmeier_b, sellmeier_c, background_spd, spec):
        mats = dataclasses.replace(
            spec.materials, coeffs=coeffs, emission_power=emission_power,
            sellmeier_b=sellmeier_b, sellmeier_c=sellmeier_c,
        )
        scene = dataclasses.replace(spec.scene, background_spd=background_spd)
        xyz, residuals = _rays_fwd_impl(
            mats, scene, spec.cam, spec.px, spec.py, spec.key_seed, spec.spp, spec.bounces, spec.rand,
            spec.sched,
        )
        ctx.spec = spec
        ctx.save_for_backward(sellmeier_b, sellmeier_c, *residuals)
        return xyz

    @staticmethod
    def backward(ctx, g):
        with span("train.replay"):
            spec = ctx.spec
            sell_b_in, sell_c_in, mat, tab, hero, n_valid, power, matres = ctx.saved_tensors
            glass = spec.reparam_glass
            grads = render_grads(
                mat, tab, g.to(torch.float32).contiguous(), hero, n_valid, power, matres,
                spec.spp, spec.bounces, want_bg_grads=True, want_sellmeier=glass is not None,
            )
            d_coeffs, d_power, d_bg = grads[:3]
            d_b = d_c = None
            if glass is not None:
                mats = dataclasses.replace(spec.materials, sellmeier_b=sell_b_in, sellmeier_c=sell_c_in)
                gb, gc = _sellmeier_grads_from_replay(mats, glass, hero, grads[3], grads[4])
                d_b = torch.zeros_like(sell_b_in)
                d_c = torch.zeros_like(sell_c_in)
                d_b[glass] = gb
                d_c[glass] = gc
            return d_coeffs, d_power, d_b, d_c, d_bg, None


def render_rays_diff_fused(
    materials, scene, cam, px, py, key_seed, spp, bounces, reparam_glass=None, rand=None,
    sched="sorted",
):
    """Accumulated XYZ [N, 3] for the rays of pixels (px, py) [N];
    differentiable w.r.t. the material coefficients and emission powers,
    ``scene.background_spd`` and, with ``reparam_glass`` (a material row of
    a dispersive dielectric), that glass's Sellmeier B/C. Any N: nothing
    is padded. ``sched`` picks the large-scene forward ("sorted" or
    "mega"), as in render_chunk."""
    spec = _Spec(materials, scene, cam, px, py, int(key_seed), spp, bounces, rand, reparam_glass, sched)
    return _FusedRays.apply(
        materials.coeffs, materials.emission_power, materials.sellmeier_b,
        materials.sellmeier_c, scene.background_spd, spec,
    )


def render_chunk_diff_fused(
    materials, scene, cam, key_seed, x0, y0, width, height, spp, bounces,
    rand_seed=-1, reparam_glass=None, rand=None, sched="sorted",
):
    """Accumulated XYZ [height, width, 3] of a chunk through the fused
    kernels; the backward replays the stored residuals and never traces a
    ray again."""
    px, py, rand = _chunk_rays(scene, x0, y0, width, height, spp, bounces, rand_seed, rand)
    xyz = render_rays_diff_fused(
        materials, scene, cam, px, py, key_seed, spp, bounces, reparam_glass, rand, sched
    )
    return xyz.reshape(height, width, 3)


def _sellmeier_grads_from_replay(materials, glass, hero, sell_a, sell_b):
    """Fold the replay's per-(sample, ray) reparam scalars into Sellmeier
    B/C gradients of row ``glass``: d loss / d(b, c) = sum A dw/d(b, c) +
    B dshift/d(b, c), with (shift, w) reparam_hero's hero shift and Jacobian
    weight. Exactly the gradient of sum(A * w + B * shift), second-order AD
    through the Sellmeier map."""
    h = hero.reshape(-1).detach()
    a_flat = sell_a.reshape(-1)
    b_flat = sell_b.reshape(-1)

    def scalar_fn(b, c):
        hr, wgt = reparam_hero(h, b, c)
        return torch.sum(a_flat * wgt + b_flat * (hr - h))

    b0 = materials.sellmeier_b[glass].detach()
    c0 = materials.sellmeier_c[glass].detach()
    return torch.func.grad(scalar_fn, argnums=(0, 1))(b0, c0)


def _mix_seed(seed: int, k: int) -> int:
    """Distinct 31-bit seed per (seed, chunk): a splitmix-style host hash."""
    x = (seed * 0x9E3779B9 + k * 0x85EBCA6B + 0x27D4EB2F) & 0xFFFFFFFF
    x = (x ^ (x >> 15)) * 0x2C1B3C6D & 0xFFFFFFFF
    x = (x ^ (x >> 12)) * 0x297A2D39 & 0xFFFFFFFF
    return (x ^ (x >> 15)) & 0x7FFFFFFF


def render_chunk_diff_fused_accum(
    materials, scene, cam, key_seed, x0, y0, width, height, spp, bounces,
    rand_seed=-1, spp_chunk=None, reparam_glass=None,
):
    """``render_chunk_diff_fused`` with the sample axis cut into chunks of
    ``spp_chunk`` samples, each with its own seed (``_mix_seed``): the same
    Monte Carlo estimator at the same total spp, its gradient the sum of the
    chunks'. ``spp_chunk=None`` is one launch: the residual buffers live in
    device memory and have no cap."""
    if spp_chunk is None or spp_chunk >= spp:
        return render_chunk_diff_fused(
            materials, scene, cam, key_seed, x0, y0, width, height, spp, bounces,
            rand_seed, reparam_glass,
        )
    out = None
    done, k = 0, 0
    while done < spp:
        c = min(spp_chunk, spp - done)
        part = render_chunk_diff_fused(
            materials, scene, cam, _mix_seed(key_seed, k), x0, y0, width, height, c, bounces,
            -1 if rand_seed < 0 else _mix_seed(rand_seed, k), reparam_glass,
        )
        out = part if out is None else out + part
        done += c
        k += 1
    return out
