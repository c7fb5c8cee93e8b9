"""Branchless spectral material shading: the XLA-style renderer's bounce.

Port of spectral_tpu/ops/shading.py. As the reference's
material::unified_scatter (materials/material.cu:138-183), every ray
computes the lambertian, metallic and dielectric scatter directions and
one-hot material weights blend them:
- lambertian: normal + a uniform unit vector, degenerate -> normal
  (material.cu:8-19);
- metallic: mirror + fuzz * a unit vector, absorbed (every wavelength
  zeroed) when that dips below the surface (material.cu:22-37, 64-68);
- dielectric: Sellmeier n(hero), Schlick-probabilistic reflect or refract;
  a refraction collapses the ray to its hero wavelength (material.cu:73-80,
  102-136);
- emissive: the emission SPD, then the path ends (material.cu:83-86);
- every scatter multiplies the ray spectrum by the material SPD and offsets
  the origin by +-EPSILON along the normal (material.cu:95-97);
- a miss multiplies by the background SPD and ends (rendering.cu:24-27).
Dead wavelengths (beyond the ``n_valid`` prefix) are multiplied like the
others and never read.

Gradient policy: the discrete decisions (material index, Schlick branch,
absorb test, degenerate direction, the draws) are detached; directions, the
Sellmeier index, SPD weights and hit geometry carry gradients. Both square
roots keep the JAX module's 1e-24 floor (shading.py:78-83, :227-229): at an
argument of exactly 0 the root's backward is inf, and ``torch.where`` times
a zero cotangent makes it NaN, as in JAX.

The draws come in as tensors (render/wavefront.py makes them outside the
checkpointed bounce, so a recompute sees the same ones). The arithmetic is
XLA's on the CPU (ops/fp32.py): the renderer's decisions hang on the last
bits of origins and directions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.materials import DIELECTRIC, EMISSIVE, METALLIC
from ..utils.constants import EPSILON
from .fp32 import fma, sqrt, sum3
from .intersect import HitRecord
from .sellmeier import sellmeier_index
from .spectrum import interp_rows, spectrum_interp

# where the lanes that do not evaluate a warp are parked (shading.py:166-173)
_FAR = (1.0e4, 2.0e4, 3.0e4)
_ZHAT = (0.0, 0.0, 1.0)


class RayState(NamedTuple):
    """Wavefront SoA ray state (reference ray/ray.cuh:15-78)."""

    o: torch.Tensor  # [N, 3] origin
    d: torch.Tensor  # [N, 3] direction (not normalized)
    wavelengths: torch.Tensor  # [N, W], hero at index 0
    power: torch.Tensor  # [N, W]
    n_valid: torch.Tensor  # [N] int64 prefix count of live wavelengths
    alive: torch.Tensor  # [N] bool: still bouncing


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp_min(sqrt(sum3(v, v)), 1e-12)[..., None]


def _park(use: torch.Tensor, x: torch.Tensor, row: tuple) -> torch.Tensor:
    """x [N, 3] where ``use`` [N, 1], the constant ``row`` elsewhere."""
    return torch.where(use, x, torch.tensor(row, dtype=x.dtype, device=x.device))


def _reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """v - 2 (v . n) n (math/vec3.cuh:179-183)."""
    return fma(-2.0 * sum3(v, n)[..., None], n, v)


def _refract(uv: torch.Tensor, n: torch.Tensor, ratio: torch.Tensor) -> torch.Tensor:
    """Snell refraction (math/vec3.cuh:198-205): r_perp - par * n with
    r_perp = ratio * (uv + cos * n), the ratio's product fused into the
    difference."""
    cos_theta = torch.clamp_max(sum3(-uv, n), 1.0)
    inner = fma(cos_theta[..., None], n, uv)
    r_perp = ratio[..., None] * inner
    # the 1e-24 floor keeps the root's backward finite (module docstring)
    par_mag = sqrt(torch.clamp_min(1.0 - sum3(r_perp, r_perp), 1e-24))
    return fma(ratio[..., None], inner, -(par_mag[..., None] * n))


def _schlick(cosine: torch.Tensor, ref_idx: torch.Tensor) -> torch.Tensor:
    """Schlick reflectance (material.cu:39-53); the powers multiplied as
    ``jax.lax.integer_pow`` does."""
    q = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = q * q
    x = 1.0 - cosine
    x2 = x * x
    return fma(1.0 - r0, x * (x2 * x2), r0)


def scatter_step(
    state: RayState,
    rec: HitRecord,
    materials,
    background_spd: torch.Tensor,
    u1: torch.Tensor,
    u2: torch.Tensor,
    u_refl: torch.Tensor,
    vertex_warp=None,
    fuzz_warp=None,
) -> RayState:
    """One wavefront bounce over the whole batch: classify, scatter,
    attenuate, terminate (renderer::ray_bounce, rendering.cu:12-40;
    spectral_tpu/ops/shading.py:115).

    ``u1``, ``u2`` [N, 3]: unit vectors of the lambertian and metallic
    lobes (utils/prng.py::random_unit_vectors); ``u_refl`` [N]: the
    Schlick uniform. Rays that had ended keep their state.

    ``vertex_warp``: an EdgeSet (diff/vertex_warp.py) that turns on the
    warped-area vertex-gradient estimator on the lambertian bounce
    (shading.py:158-194): the direction is sampled about the detached
    normal, warped with the silhouettes, and its det x density-ratio
    factor (value 1 at the primal) multiplies the power. ``fuzz_warp``: an
    EdgeSet that turns on exact d/d(fuzz) on the metallic lobe
    (diff/fuzz_warp.py; geometry detached), on live metallic hits whose
    fuzz is above FUZZ_MIN. Only the lanes that warp evaluate it; the
    others are parked at a far point with normal z-hat: a dead lane's hit
    point is the origin, a Cornell box corner on three edges at once, whose
    masked warp derivatives would give 0 * inf in the shared backward
    sums. Both warps take the same u1, u2 as the plain lobes."""
    active = state.alive
    hit = rec.hit & active
    miss = ~rec.hit & active

    mi = rec.mat_index.detach()
    mtype = materials.mat_type[mi]
    spd = materials.spd[mi]
    fuzz = materials.fuzz[mi]
    sell_b = materials.sellmeier_b[mi]
    sell_c = materials.sellmeier_c[mi]

    unit_in = _normalize(state.d)
    normal = rec.normal

    is_metal = mtype == METALLIC
    is_diel = mtype == DIELECTRIC
    is_emis = mtype == EMISSIVE
    # LAMBERTIAN is the reference's switch default (material.cu:88-92), so
    # any other type scatters lambertian
    is_lamb = ~is_metal & ~is_diel & ~is_emis
    f32 = torch.float32

    # lambertian lobe (material.cu:8-19)
    warp_factor = None
    if vertex_warp is None:
        lamb_dir = normal + u1
        degen = (lamb_dir.abs() < 1e-8).all(dim=-1)
        lamb_dir = torch.where(degen[:, None], normal, lamb_dir)
    else:
        from ..diff.vertex_warp import warp_directions

        n_frozen = normal.detach()
        d0 = n_frozen + u1
        degen = (d0.abs() < 1e-8).all(dim=-1)
        d0 = torch.where(degen[:, None], n_frozen, d0)
        use_warp = (hit & is_lamb)[:, None]
        o_safe = _park(use_warp, rec.p, _FAR)
        n_safe = _park(use_warp, normal, _ZHAT)
        lamb_dir, warp_factor = warp_directions(o_safe, n_safe, _normalize(d0), vertex_warp)
        lamb_dir = torch.where(use_warp, lamb_dir, d0)
        warp_factor = torch.where(use_warp[:, 0], warp_factor, torch.ones_like(warp_factor))

    # metallic lobe (material.cu:22-37)
    refl = _reflect(unit_in, normal)
    fuzz_factor = None
    if fuzz_warp is None:
        metal_dir = fma(fuzz[:, None], u2, refl)
    else:
        from ..diff.fuzz_warp import FUZZ_MIN, warp_fuzz

        use_fw = (hit & is_metal & (fuzz > FUZZ_MIN).detach())[:, None]
        o_safe = _park(use_fw, rec.p, _FAR)
        r_safe = _park(use_fw, refl.detach(), _ZHAT)
        n_safe = _park(use_fw, normal.detach(), _ZHAT)
        s_w, fdet = warp_fuzz(u2, o_safe, r_safe, n_safe, fuzz, fuzz_warp)
        metal_dir = fma(fuzz[:, None], torch.where(use_fw, s_w, u2), refl)
        fuzz_factor = torch.where(use_fw[:, 0], fdet, torch.ones_like(fdet))
    metal_ok = sum3(metal_dir, normal) > 0.0

    # dielectric lobe (material.cu:73-80, 102-136)
    ir = sellmeier_index(sell_b, sell_c, state.wavelengths[:, 0])
    ratio = torch.where(rec.front_face, 1.0 / ir, ir)
    cos_theta = torch.clamp_max(sum3(-unit_in, normal), 1.0)
    sin_theta = sqrt(torch.clamp_min(fma(-cos_theta, cos_theta, 1.0), 1e-24))
    cannot_refract = ((ratio * sin_theta > 1.0) | (_schlick(cos_theta, ratio) > u_refl)).detach()
    diel_dir = torch.where(cannot_refract[:, None], refl, _refract(unit_in, normal, ratio))
    refracted = ~cannot_refract

    # one-hot blend (unified_scatter)
    new_dir = (
        is_lamb[:, None].to(f32) * lamb_dir
        + is_metal[:, None].to(f32) * metal_dir
        + is_diel[:, None].to(f32) * diel_dir
    )

    # a refracting dielectric pushes through the surface (material.cu:95-97)
    eps_sign = torch.where(is_diel & refracted, -EPSILON, EPSILON).to(f32)
    new_o = fma(eps_sign[:, None], normal, rec.p)

    # spectrum updates
    mat_weight = interp_rows(spd, state.wavelengths)
    bg_weight = spectrum_interp(background_spd, state.wavelengths)
    one = torch.ones_like(mat_weight)
    weight = torch.where(hit[:, None], mat_weight, torch.where(miss[:, None], bg_weight, one))
    power = state.power * weight
    if warp_factor is not None:
        # the lambertian warp's det x density ratio: the boundary and
        # normal-tilt terms
        power = power * torch.where(hit & is_lamb, warp_factor, torch.ones_like(warp_factor))[:, None]
    if fuzz_factor is not None:
        # the fuzz-sphere warp's det: the metal lobe's boundary terms
        power = power * torch.where(hit & is_metal, fuzz_factor, torch.ones_like(fuzz_factor))[:, None]

    # refraction keeps the hero alone (material.cu:78-79); a metal absorb
    # zeroes the spectrum (material.cu:66-68)
    n_valid = state.n_valid
    n_valid = torch.where(hit & is_diel & refracted, torch.ones_like(n_valid), n_valid)
    n_valid = torch.where(hit & is_metal & ~metal_ok, torch.zeros_like(n_valid), n_valid)

    terminated = miss | (hit & is_emis) | (hit & is_metal & ~metal_ok)
    alive = active & ~terminated

    # rays that had already ended keep their state
    frozen = ~active
    return RayState(
        o=torch.where(frozen[:, None], state.o, new_o),
        d=torch.where((frozen | terminated)[:, None], state.d, new_dir),
        wavelengths=state.wavelengths,
        power=torch.where(frozen[:, None], state.power, power),
        n_valid=torch.where(frozen, state.n_valid, n_valid),
        alive=alive,
    )
