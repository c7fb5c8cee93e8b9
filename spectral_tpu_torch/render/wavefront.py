"""The XLA-style wavefront spectral path tracer, and the framebuffer
conversion.

Port of spectral_tpu/render/wavefront.py. Where the render kernels
(ops/cuda/render_kernel.py) give each thread a whole path, this renderer
advances a batch of rays in lock step,

    generate -> [ nearest hit -> shade ] x bounce_limit -> integrate,

each stage a batched tensor operation, with the samples as an outer loop
that sums XYZ. It is differentiable by autograd end to end: the
estimators of diff/fast.py (``render_chunk_diff``) and the one-device
``parallel.train_step`` differentiate it. The nearest hit of every bounce
is the dense intersect kernel's selection (ops/intersect.py::
nearest_hit_scene), or with ``scene.bvh`` set the Karras LBVH walk
(ops/bvh.py::nearest_hit_bvh), as at wavefront.py:82-90.

Draws. A render is a pure function of (key, sample, bounce): by default
each sample and bounce draws from a generator seeded with
``utils/prng.py::fold`` of its counters (``GeneratorDraws``). The JAX
renderer draws from its own key schedule; ``render_tile_xyz`` takes any
object with the same three methods instead (``draws``), so that a test can
hand it the JAX draws and compare the two path for path.

Under autograd each bounce runs inside ``torch.utils.checkpoint``, the
counterpart of ``jax.checkpoint(bounce)`` (wavefront.py:107-115): the
backward recomputes the bounce instead of keeping its activations, which
at 256x256, 16 spp and 8 bounces would not fit. The bounce's draws are
made before the checkpointed function and passed in, so the recompute
sees the same numbers (a generator read inside it would be advanced again
and the backward would trace other paths). The warps' EdgeSets
(diff/vertex_warp.py) are inputs of the checkpointed bounce too.

The specular-chain guard (wavefront.py:34-54, :119-142): with
``vertex_warp``, ``trace_paths`` warns when more than SPECULAR_WARN_FRAC
(default 0.25) of the contributing paths crossed a metal or dielectric
bounce, whose silhouettes the warped-area estimator does not see;
SPECULAR_WARN=0 turns it off. The JAX package emits it on the CPU alone,
because the TPU plugin has no host callbacks; that is a TPU workaround, so
the port warns on any device, at the cost of one host read of one scalar
per trace, under ``vertex_warp`` only.
"""

from __future__ import annotations

import os
import warnings

import torch
from torch.utils.checkpoint import checkpoint

from ..models.camera import Camera, chunk_pixels, generate_rays
from ..models.materials import DIELECTRIC, METALLIC
from ..ops.color import to_uint8, xyz_to_srgb
from ..ops.intersect import nearest_hit_scene
from ..ops.shading import RayState, scatter_step
from ..ops.spectrum import hero_wavelengths, spectrum_to_xyz
from ..utils.constants import N_RAY_WAVELENGTHS
from ..utils.prng import fold, generator, random_in_unit_disk, random_unit_vectors

# site counters of GeneratorDraws, folded after the sample
_CAMERA, _HERO, _BOUNCE = 0, 1, 2
# the rays of one pass of render_tile_xyz: the samples of a small chunk
# are traced together (each ray's arithmetic is its own, so the paths and
# the XYZ are those of one sample at a time), which divides the number of
# PyTorch operations, and their host cost, by the samples a pass holds
RAYS_PER_PASS = 8192


class GeneratorDraws:
    """The draws of ``n`` rays keyed by ``key``: sample s's camera and hero
    draws come from ``generator(fold(key, s, site))`` and bounce b's from
    ``generator(fold(key, s, _BOUNCE, b))`` on ``device``.

    ``camera(s)`` -> (jitter [N, 2] uniforms, disk [N, 2] or None);
    ``hero(s)`` -> hero uniforms [N]; ``bounce(s, b)`` -> (u1, u2 [N, 3]
    unit vectors, u_refl [N] uniforms)."""

    def __init__(self, key: int, n: int, device, defocus: bool = False):
        self.key, self.n, self.device, self.defocus = key, n, torch.device(device), defocus

    def _gen(self, *counters) -> torch.Generator:
        return generator(fold(self.key, *counters), self.device)

    def camera(self, s: int):
        gen = self._gen(s, _CAMERA)
        jitter = torch.rand((self.n, 2), generator=gen, device=self.device)
        return jitter, random_in_unit_disk(gen, (self.n,)) if self.defocus else None

    def hero(self, s: int) -> torch.Tensor:
        return torch.rand(self.n, generator=self._gen(s, _HERO), device=self.device)

    def bounce(self, s: int, b: int):
        gen = self._gen(s, _BOUNCE, b)
        u1 = random_unit_vectors(gen, (self.n,))
        u2 = random_unit_vectors(gen, (self.n,))
        return u1, u2, torch.rand(self.n, generator=gen, device=self.device)


def _warn_specular_fraction(frac: float) -> None:
    """The vertex-gradient estimator's specular-chain guard: warn when more
    than SPECULAR_WARN_FRAC (default 0.25) of the contributing paths crossed
    a metal or dielectric bounce; silhouettes seen only through such chains
    carry no boundary term, so the gradients have a systematic deficit
    (diff/vertex_warp.py)."""
    thresh = float(os.environ.get("SPECULAR_WARN_FRAC", "0.25"))
    if frac > thresh:
        warnings.warn(
            f"vertex-gradient estimator: {frac:.0%} of contributing paths crossed a metal/dielectric bounce "
            f"(> {thresh:.0%} threshold). Silhouettes visible only through specular chains carry NO boundary "
            f"term in the warped-area estimator; vertex gradients on this scene may be systematically low "
            f"(diff/vertex_warp.py, known gaps).",
            stacklevel=3,
        )


def samples_per_pass(n: int, samples_per_pixel: int) -> int:
    """How many samples of n pixels ``render_tile_xyz`` traces together:
    as many as keep a pass within RAYS_PER_PASS rays, at least one."""
    return max(1, min(samples_per_pixel, RAYS_PER_PASS // max(n, 1)))


def _bounce(scene, tri_pack, select, vertex_warp, fuzz_warp, o, d, wavelengths, power, n_valid, alive, spec, u1,
            u2, u_refl):
    state = RayState(o, d, wavelengths, power, n_valid, alive)
    if getattr(scene, "bvh", None) is not None:
        from ..ops.bvh import nearest_hit_bvh

        rec = nearest_hit_bvh(o, d, scene, scene.bvh)
    else:
        rec = nearest_hit_scene(o, d, scene, tri_pack, select)
    if vertex_warp is not None:
        # the specular-chain monitor: paths that cross a metal or dielectric
        mt = scene.materials.mat_type[rec.mat_index]
        spec = spec | (alive & rec.hit & ((mt == METALLIC) | (mt == DIELECTRIC)))
    out = scatter_step(state, rec, scene.materials, scene.background_spd, u1, u2, u_refl, vertex_warp, fuzz_warp)
    return (*out, spec)


def trace_paths(scene, o, d, wavelengths, bounce_draws, bounce_limit: int, vertex_warp=None, fuzz_warp=None,
                select=None, samples: int = 1) -> RayState:
    """Trace a batch of rays to termination (renderer::ray_bounce,
    rendering.cu:12-40; wavefront.py:57). ``bounce_draws(b)`` gives bounce
    b's (u1, u2, u_refl); ``select`` overrides the dense selection
    (ops/intersect.py::nearest_hit_scene). ``vertex_warp``, ``fuzz_warp``:
    EdgeSets that turn on the warps of each bounce (ops/shading.py::
    scatter_step) and, with ``vertex_warp``, the specular-chain guard
    (module docstring), which holds each of ``samples`` equal runs of the
    rays (the samples of a pass) to the threshold on its own, as the JAX
    renderer traces a sample at a time. Paths still alive after the last
    bounce contribute nothing (rendering.cu:38-39)."""
    from ..ops.cuda.intersect_kernel import pack_tris

    n, w = wavelengths.shape
    dev = o.device
    state = (
        o, d, wavelengths, torch.ones((n, w), dtype=torch.float32, device=dev),
        torch.full((n,), w, dtype=torch.int64, device=dev), torch.ones(n, dtype=torch.bool, device=dev),
        torch.zeros(n, dtype=torch.bool, device=dev),
    )
    tri_pack = None
    if getattr(scene, "bvh", None) is None:
        with torch.no_grad():
            tri_pack = pack_tris(scene)
    for b in range(bounce_limit):
        draws = bounce_draws(b)
        args = (scene, tri_pack, select, vertex_warp, fuzz_warp, *state, *draws)
        state = checkpoint(_bounce, *args, use_reentrant=False) if torch.is_grad_enabled() else _bounce(*args)
    spec = state[-1]
    state = RayState(*state[:-1])
    state = state._replace(n_valid=torch.where(state.alive, torch.zeros_like(state.n_valid), state.n_valid))
    if vertex_warp is not None and os.environ.get("SPECULAR_WARN", "1") == "1":
        contrib = (state.n_valid > 0).reshape(samples, -1)
        frac = (spec.reshape(samples, -1) & contrib).sum(1) / torch.clamp_min(contrib.sum(1), 1)
        _warn_specular_fraction(float(frac.max()))
    return state


def render_tile_xyz(
    scene,
    cam: Camera,
    px: torch.Tensor,
    py: torch.Tensor,
    key: int,
    samples_per_pixel: int,
    bounce_limit: int,
    reparam_glass: int | None = None,
    reparam_frozen: tuple[torch.Tensor, torch.Tensor] | None = None,
    vertex_warp=None,
    fuzz_warp=None,
    draws=None,
    select=None,
) -> torch.Tensor:
    """Accumulated (not averaged) XYZ [N, 3] of the pixels px, py [N]
    (the sample loop of spectral_render_kernel, rendering.cu:215-228;
    wavefront.py:146).

    ``reparam_glass``: the material row of a dispersive dielectric whose
    Sellmeier B/C get exact gradients through the hero-wavelength change of
    variables (diff/spectral_reparam.py; primal values unchanged);
    ``reparam_frozen``: its explicit (b0, c0) target, for FD checks.
    ``vertex_warp``: an EdgeSet (diff/vertex_warp.py) that makes the
    vertex-position gradients exact: the camera's pixel samples and the
    lambertian bounce directions are warped so that silhouette boundary
    terms appear in autograd, and the screen warp's det multiplies each
    sample; the primal rays are the same (the sphere warp re-normalizes
    the lambertian direction, so values move at float32 rounding).
    ``fuzz_warp``: an EdgeSet that makes d/d(fuzz) exact
    (diff/fuzz_warp.py). ``draws``: the draws (``GeneratorDraws``'
    methods; default ``GeneratorDraws(key, N, ...)``). ``select``: see
    ``trace_paths``. The samples are traced ``samples_per_pass`` at a time
    (RAYS_PER_PASS)."""
    n = px.shape[0]
    screen_warp = None
    if vertex_warp is not None:
        from ..diff.vertex_warp import warp_pixel_samples

        screen_warp = lambda fx, fy: warp_pixel_samples(cam, vertex_warp, fx, fy)  # noqa: E731
    if draws is None:
        draws = GeneratorDraws(key, n, px.device, cam.defocus_angle > 0.0)
    acc = torch.zeros((n, 3), dtype=torch.float32, device=px.device)
    k = samples_per_pass(n, samples_per_pixel)
    for s0 in range(0, samples_per_pixel, k):
        ss = range(s0, min(s0 + k, samples_per_pixel))
        m = len(ss)
        cams = [draws.camera(s) for s in ss]
        jitter = torch.cat([c[0] for c in cams])
        disk = None if cams[0][1] is None else torch.cat([c[1] for c in cams])
        pxs, pys = px.repeat(m), py.repeat(m)
        cam_det = None
        if screen_warp is not None:
            o, d, cam_det = generate_rays(cam, pxs, pys, jitter, disk, screen_warp=screen_warp)
        else:
            o, d = generate_rays(cam, pxs, pys, jitter, disk)
        lam = hero_wavelengths(torch.cat([draws.hero(s) for s in ss]), n_lambdas=N_RAY_WAVELENGTHS)
        jac = None
        if reparam_glass is not None:
            from ..diff.spectral_reparam import reparam_wavelengths

            lam, jac = reparam_wavelengths(lam, scene.materials, reparam_glass, reparam_frozen)

        def bounce_draws(b, ss=ss):
            return tuple(torch.cat(parts) for parts in zip(*(draws.bounce(s, b) for s in ss)))

        state = trace_paths(scene, o, d, lam, bounce_draws, bounce_limit, vertex_warp, fuzz_warp, select,
                            samples=m)
        xyz = spectrum_to_xyz(state.wavelengths, state.power, state.n_valid)
        if jac is not None:
            xyz = xyz * jac[:, None]
        if cam_det is not None:
            xyz = xyz * cam_det[:, None]
        for i in range(m):  # the samples in order, as one at a time
            acc = acc + xyz[i * n:(i + 1) * n]
    return acc


def render_chunk(
    scene,
    cam: Camera,
    key: int,
    x0: int,
    y0: int,
    width: int,
    height: int,
    samples_per_pixel: int,
    bounce_limit: int,
    reparam_glass: int | None = None,
    reparam_frozen: tuple[torch.Tensor, torch.Tensor] | None = None,
    vertex_warp=None,
    fuzz_warp=None,
    draws=None,
    select=None,
) -> torch.Tensor:
    """Accumulated XYZ [height, width, 3] of a chunk, on the scene's device
    (wavefront.py:220). The chunk is the reference's tile
    (render_manager.cu:3-66). The arguments are ``render_tile_xyz``'s."""
    px, py = chunk_pixels(x0, y0, width, height, scene.normal.device)
    xyz = render_tile_xyz(
        scene, cam, px, py, key, samples_per_pixel, bounce_limit, reparam_glass, reparam_frozen,
        vertex_warp, fuzz_warp, draws, select,
    )
    return xyz.reshape(height, width, 3)


def xyz_to_image(xyz_sum: torch.Tensor, samples_per_pixel: int) -> torch.Tensor:
    """XYZ accumulator [..., 3] -> uint8 sRGB on the same device
    (save_to_fb, rendering.cu:140-149 + frame_buffer uchar conversion)."""
    spp = torch.tensor(float(samples_per_pixel), dtype=xyz_sum.dtype, device=xyz_sum.device)
    return to_uint8(xyz_to_srgb(xyz_sum / spp))
