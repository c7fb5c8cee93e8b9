"""Dense spectral path-tracing megakernel: the CUDA kernel, its plain
version and the chunk renderer around them.

Port of the dense form of spectral_tpu/ops/pallas/render_kernel.py
(pack_scene :71, n_uniforms :2314, render_rays_pallas :2603,
render_rays_pallas_residuals :2421, camera_vector :3240,
render_chunk_pallas :3407). ``render_rays`` and ``render_rays_residuals``
launch csrc/render_kernel.cu for CUDA tensors and run
``render_rays_reference``, the plain PyTorch version, for CPU tensors; there
is no other fallback.

The residual form also returns what the fused backward replays
(ops/cuda/grad_kernel.py), in the JAX layout: hero [spp, N], n_valid
[spp, N], power [spp, W, N] and the per-bounce material residual matres
[spp, B, N] int32 (mat + 1 for a hit, -1 for a background miss, 0 once the
path has ended).

The plain version repeats the JAX kernel's arithmetic on [N] tensors, op for
op and in the same order, with fused multiply-adds exactly where XLA's CPU
backend contracts that kernel (ops/fp32.py); the CUDA kernel does the same.
It is vectorised over rays and, for the sweep, over [rays, triangles]. Dead
paths are frozen as in the JAX kernel, so it and the CUDA kernel (which
stops a path when it terminates) give the same results.

Random numbers: with ``rand`` [spp, n_uniforms(B), N] both versions read
the injected planes in the JAX kernel's draw order; without it they hash
(chunk seed, global pixel index, sample, draw) with ``hash_uniforms``'s
uint32 arithmetic, which the CUDA source writes identically.
"""

from __future__ import annotations

import torch

from ...models.camera import camera_vector
from ...models.materials import DIELECTRIC, EMISSIVE, METALLIC
from ...utils.constants import (
    EPSILON,
    LAMBDA_MAX,
    LAMBDA_MIN,
    N_CIE_SAMPLES,
    N_RAY_WAVELENGTHS,
    cie_d65_normalized,
    cie_x,
    cie_y,
    cie_z,
    to,
)
from ..fp32 import dot3, fma
from ..intersect import nearest_hit
from . import build

W = N_RAY_WAVELENGTHS  # 7 wavelengths, hero at index 0
# tri pack [T, 17]: normal(0:3), d(3), edge_g(4:13), edge_c(13:16),
# mat_index(16, as float)
TRI_PACK_WIDTH = 17
# material pack [M, 16]: coeffs(0:3), is_lamb(3), is_metal(4), is_diel(5),
# is_emis(6), fuzz(7), power_sq(8), sellmeier_b(9:12), sellmeier_c(12:15)
MAT_PACK_WIDTH = 16
# curve tables [5, 95]: CIE x, y, z, normalized D65, background SPD
N_TABLES = 5
# The dense sweep covers scenes up to this many triangles (the JAX
# package's cutoff too); larger scenes need the BVH slice (ROADMAP B5).
DENSE_CUTOFF = 128

_SPAN = LAMBDA_MAX - LAMBDA_MIN
_TWO_PI = 2.0 * 3.14159265358979
_CELL_SCALE = (N_CIE_SAMPLES - 1) / (LAMBDA_MAX - LAMBDA_MIN)
_DELTA = _SPAN / float(W)
_M32 = 0xFFFFFFFF


def pack_scene(scene) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(tri_pack [T, 17], mat_pack [M, 16], tables [5, 95]) float32 tensors
    on the scene's device."""
    tri = torch.cat(
        [
            scene.normal,
            scene.d[:, None],
            scene.edge_g.reshape(-1, 9),
            scene.edge_c,
            scene.mat_index[:, None].to(torch.float32),
        ],
        dim=1,
    ).to(torch.float32)

    m = scene.materials
    t = m.mat_type
    is_metal = (t == METALLIC).to(torch.float32)
    is_diel = (t == DIELECTRIC).to(torch.float32)
    is_emis = (t == EMISSIVE).to(torch.float32)
    is_lamb = torch.clamp(1.0 - is_metal - is_diel - is_emis, 0.0, 1.0)
    mat = torch.cat(
        [
            m.coeffs,
            is_lamb[:, None],
            is_metal[:, None],
            is_diel[:, None],
            is_emis[:, None],
            m.fuzz[:, None],
            (m.emission_power**2)[:, None],
            m.sellmeier_b,
            m.sellmeier_c,
            torch.zeros((t.shape[0], 1), dtype=torch.float32, device=t.device),
        ],
        dim=1,
    ).to(torch.float32)

    dev = scene.normal.device
    tab = torch.stack(
        [to(cie_x, dev), to(cie_y, dev), to(cie_z, dev), to(cie_d65_normalized, dev), scene.background_spd.to(torch.float32)]
    )
    return tri.contiguous(), mat.contiguous(), tab.contiguous()


def n_uniforms(bounces: int) -> int:
    """Uniform draws per sample: jitter(2) + hero(1) + 3 per bounce +
    defocus disk(2, at the tail)."""
    return 5 + 3 * bounces


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """uint32 lowbias32 hash of int64 values in [0, 2^32). The products may
    wrap the int64 range; the low 32 bits, all that is kept, are exact."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def pixel_keys(seed: int, px: torch.Tensor, py: torch.Tensor, image_width: int) -> torch.Tensor:
    """Per-ray stream keys: hash32(seed ^ hash32(py * image_width + px))."""
    pixel = (py.to(torch.int64) * image_width + px.to(torch.int64)) & _M32
    return _hash32((seed & _M32) ^ _hash32(pixel))


def hash_uniforms(keys: torch.Tensor, sample: int, n_draws: int) -> torch.Tensor:
    """Draws [n_draws, N] in [0, 1) with 24 bits for one sample: draw j of
    sample s is hash32(hash32(key + s * 0x85EBCA6B) + j * 0x9E3779B9) >> 8."""
    k = _hash32((keys + ((sample * 0x85EBCA6B) & _M32)) & _M32)
    j = torch.arange(n_draws, dtype=torch.int64, device=keys.device)[:, None]
    h = _hash32((k[None, :] + ((j * 0x9E3779B9) & _M32)) & _M32)
    return (h >> 8).to(torch.float32) * (1.0 / 16777216.0)


def lut(row: torch.Tensor, cell: torch.Tensor, frac: torch.Tensor) -> torch.Tensor:
    """Lerp of a 95-sample curve at cells/fractions (spectrum.cu:11-22)."""
    return fma(1.0 - frac, row[cell], frac * row[cell + 1])


def comb_cell(hero: torch.Tensor, w: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Wavelength w of the hero comb (spectrum.cu:31-48, with the wrap) and
    its table cell (int64) and fraction; csrc/spectrum.cuh::comb_cell."""
    lw = hero + w * (_SPAN / float(W))
    lw = torch.where(lw > LAMBDA_MAX, lw - _SPAN, lw)
    xg = (lw - LAMBDA_MIN) * _CELL_SCALE
    cw = xg.to(torch.int32).clamp(0, N_CIE_SAMPLES - 2).long()
    return lw, cw, xg - cw.to(torch.float32)


def _check(cam_vec, tri_pack, mat_pack, tables, px, py, spp, bounces, rand, steps):
    n = px.shape[0]
    dev = px.device
    if cam_vec.shape != (20,) or py.shape != (n,) or px.ndim != 1:
        raise ValueError(f"bad shapes cam_vec {tuple(cam_vec.shape)}, px {tuple(px.shape)}, py {tuple(py.shape)}")
    if tri_pack.ndim != 2 or tri_pack.shape[1] != TRI_PACK_WIDTH:
        raise ValueError(f"tri_pack must be [T, {TRI_PACK_WIDTH}], got {tuple(tri_pack.shape)}")
    if tri_pack.shape[0] > DENSE_CUTOFF:
        raise NotImplementedError(
            f"{tri_pack.shape[0]} triangles: scenes above {DENSE_CUTOFF} need "
            "the BVH sweep, which is not ported yet (ROADMAP B5)"
        )
    if mat_pack.ndim != 2 or mat_pack.shape[1] != MAT_PACK_WIDTH:
        raise ValueError(f"mat_pack must be [M, {MAT_PACK_WIDTH}], got {tuple(mat_pack.shape)}")
    if tables.shape != (N_TABLES, N_CIE_SAMPLES):
        raise ValueError(f"tables must be [{N_TABLES}, {N_CIE_SAMPLES}], got {tuple(tables.shape)}")
    if spp < 1 or bounces < 1:
        raise ValueError(f"spp {spp} and bounces {bounces} must be >= 1")
    if rand is not None and rand.shape != (spp, n_uniforms(bounces), n):
        raise ValueError(f"rand must be [{spp}, {n_uniforms(bounces)}, {n}], got {tuple(rand.shape)}")
    if steps is not None and (steps.shape != (n,) or steps.dtype != torch.int32):
        raise ValueError("steps must be an int32 [N] tensor")
    for name, x in (("cam_vec", cam_vec), ("tri_pack", tri_pack), ("mat_pack", mat_pack),
                    ("tables", tables), ("py", py), ("rand", rand), ("steps", steps)):
        if x is not None and x.device != dev:
            raise ValueError(f"{name} is on {x.device}, px on {dev}")


def render_rays_reference(
    cam_vec, seed, tri_pack, mat_pack, tables, px, py, spp, bounces,
    image_width, rand=None, steps=None, residuals=False,
):
    """The plain PyTorch version of the megakernel: XYZ [N, 3] summed over
    spp; with ``residuals``, the tuple (xyz, hero, n_valid, power, matres).
    ``steps`` (int32 [N]), when given, receives each ray's count of live
    ray-steps (bounces traced while its path was alive)."""
    n = px.shape[0]
    dev = px.device
    f32 = torch.float32
    one = torch.ones(n, dtype=f32, device=dev)
    zero = torch.zeros(n, dtype=f32, device=dev)
    (cx, cy, cz, p0x, p0y, p0z, dux, duy, duz, dvx, dvy, dvz,
     ddux, dduy, dduz, ddvx, ddvy, ddvz, has_defocus, _) = cam_vec.tolist()
    tri_pack = tri_pack.to(f32)
    px = px.to(f32)
    py = py.to(f32)
    n_draws = n_uniforms(bounces)
    keys = None if rand is not None else pixel_keys(seed, px, py, image_width)
    accx, accy, accz = zero, zero, zero
    live = torch.zeros(n, dtype=torch.int32, device=dev)
    if residuals:
        res_hero = torch.empty((spp, n), dtype=f32, device=dev)
        res_nvalid = torch.empty((spp, n), dtype=f32, device=dev)
        res_power = torch.empty((spp, W, n), dtype=f32, device=dev)
        res_mat = torch.empty((spp, bounces, n), dtype=torch.int32, device=dev)

    for s in range(spp):
        u = rand[s] if rand is not None else hash_uniforms(keys, s, n_draws)
        # camera ray (get_ray, rendering.cu:66-87) with the thin-lens disk
        fx = px + (u[0] - 0.5)
        fy = py + (u[1] - 0.5)
        dr = torch.sqrt(u[3 + 3 * bounces]) * has_defocus
        dth = _TWO_PI * u[4 + 3 * bounces]
        du = dr * torch.cos(dth)
        dv = dr * torch.sin(dth)
        ox = fma(dv, ddvx, fma(du, ddux, cx))
        oy = fma(dv, ddvy, fma(du, dduy, cy))
        oz = fma(dv, ddvz, fma(du, dduz, cz))
        dx = fma(fy, dvx, fma(fx, dux, p0x)) - ox
        dy = fma(fy, dvy, fma(fx, duy, p0y)) - oy
        dz = fma(fy, dvz, fma(fx, duz, p0z)) - oz

        # hero wavelengths (spectrum.cu:31-48) and their table cells
        hero = fma(_SPAN, u[2], LAMBDA_MIN)
        if residuals:
            res_hero[s] = hero
        lam, cell, frac, d65w, bgw = [], [], [], [], []
        for w in range(W):
            lw, cw, fw = comb_cell(hero, w)
            lam.append(lw)
            cell.append(cw)
            frac.append(fw)
            d65w.append(lut(tables[3], cw, fw))
            bgw.append(lut(tables[4], cw, fw))

        power = [one] * W
        alive = one
        n_valid = torch.full((n,), float(W), dtype=f32, device=dev)
        for b in range(bounces):
            live += (alive > 0.0).to(torch.int32)
            t, idx, best_hit_b, front = nearest_hit(
                torch.stack([ox, oy, oz], 1), torch.stack([dx, dy, dz], 1), tri_pack
            )
            best_hit = best_hit_b.to(f32)
            hit = best_hit * alive
            miss = (1.0 - best_hit) * alive
            t_safe = torch.where(best_hit_b, t, zero)
            hx = fma(t_safe, dx, ox)
            hy = fma(t_safe, dy, oy)
            hz = fma(t_safe, dz, oz)
            # normal flipped toward the ray; material 0, zero normal on a miss
            tp = tri_pack[idx.long()]
            nb = [torch.where(best_hit_b, torch.where(front, tp[:, k], -tp[:, k]), zero) for k in range(3)]
            nbx, nby, nbz = nb
            mat_i = torch.where(best_hit_b, tp[:, 16].to(torch.int32), torch.zeros_like(idx))
            if residuals:
                none = torch.zeros_like(mat_i)
                res_mat[s, b] = torch.where(hit > 0.0, mat_i + 1, torch.where(miss > 0.0, none - 1, none))
            mr = mat_pack[mat_i.long()]
            c0, c1, c2 = mr[:, 0], mr[:, 1], mr[:, 2]
            is_lamb, is_metal, is_diel, is_emis = mr[:, 3], mr[:, 4], mr[:, 5], mr[:, 6]
            fuzz, power_sq = mr[:, 7], mr[:, 8]
            b0, b1, b2 = mr[:, 9], mr[:, 10], mr[:, 11]
            sc0, sc1, sc2 = mr[:, 12], mr[:, 13], mr[:, 14]

            # spectral weight per wavelength (material.cuh:71-84)
            new_power = []
            for w in range(W):
                x = fma(fma(c0, lam[w], c1), lam[w], c2)
                sig = 0.5 * x / torch.sqrt(fma(x, x, 1.0)) + 0.5
                spd = is_diel + is_emis * power_sq * sig * d65w[w] + (is_lamb + is_metal) * sig
                weight = hit * spd + miss * bgw[w] + (1.0 - alive)
                new_power.append(power[w] * weight)

            # scatter directions
            ilen = one / torch.sqrt(dot3(dx, dy, dz, dx, dy, dz))
            ux, uy, uz = dx * ilen, dy * ilen, dz * ilen
            sz = 2.0 * u[3 + 3 * b] - 1.0
            sphi = _TWO_PI * u[4 + 3 * b]
            sr = torch.sqrt(torch.clamp_min(fma(-sz, sz, 1.0), 0.0))
            sx = sr * torch.cos(sphi)
            sy = sr * torch.sin(sphi)

            # lambertian (material.cu:8-19); degenerate -> normal
            lx, ly, lz = nbx + sx, nby + sy, nbz + sz
            degen = (lx.abs() < 1e-8) & (ly.abs() < 1e-8) & (lz.abs() < 1e-8)
            lx = torch.where(degen, nbx, lx)
            ly = torch.where(degen, nby, ly)
            lz = torch.where(degen, nbz, lz)

            # metallic (material.cu:22-37)
            dn = dot3(ux, uy, uz, nbx, nby, nbz)
            rx = fma(-(2.0 * dn), nbx, ux)
            ry = fma(-(2.0 * dn), nby, uy)
            rz = fma(-(2.0 * dn), nbz, uz)
            mx = fma(fuzz, sx, rx)
            my = fma(fuzz, sy, ry)
            mz = fma(fuzz, sz, rz)
            metal_ok = dot3(mx, my, mz, nbx, nby, nbz) > 0.0

            # dielectric (material.cu:73-80, 102-136): Sellmeier n(hero)
            hl = lam[0] * 1e-3
            hero_um2 = hl * hl
            n2 = (
                1.0
                + b0 * hero_um2 / (hero_um2 - sc0)
                + b1 * hero_um2 / (hero_um2 - sc1)
                + b2 * hero_um2 / (hero_um2 - sc2)
            )
            ir = torch.sqrt(torch.clamp_min(n2, 1e-6))
            ratio = torch.where(front, one / ir, ir)
            cos_t = torch.clamp_max(-dn, 1.0)
            sin_t = torch.sqrt(torch.clamp_min(fma(-cos_t, cos_t, 1.0), 0.0))
            q = (1.0 - ratio) / (1.0 + ratio)
            r0 = q * q
            om = 1.0 - cos_t
            om2 = om * om
            schlick = fma(1.0 - r0, om * (om2 * om2), r0)
            must_reflect = (ratio * sin_t > 1.0) | (schlick > u[5 + 3 * b])
            # refract (vec3.cuh:198-205)
            qx = ratio * fma(cos_t, nbx, ux)
            qy = ratio * fma(cos_t, nby, uy)
            qz = ratio * fma(cos_t, nbz, uz)
            par = torch.sqrt(torch.clamp_min(1.0 - dot3(qx, qy, qz, qx, qy, qz), 0.0))
            gx = torch.where(must_reflect, rx, fma(-par, nbx, qx))
            gy = torch.where(must_reflect, ry, fma(-par, nby, qy))
            gz = torch.where(must_reflect, rz, fma(-par, nbz, qz))
            refracted = is_diel * torch.where(must_reflect, zero, one)

            ndx = is_lamb * lx + is_metal * mx + is_diel * gx
            ndy = is_lamb * ly + is_metal * my + is_diel * gy
            ndz = is_lamb * lz + is_metal * mz + is_diel * gz
            eps_sign = 1.0 - 2.0 * refracted

            # wavelength bookkeeping + termination
            hit_b = hit > 0.0
            n_valid = torch.where(hit_b & (refracted > 0.0), one, n_valid)
            n_valid = torch.where(hit_b & (is_metal > 0.0) & ~metal_ok, zero, n_valid)
            terminated = torch.maximum(
                miss, hit * torch.maximum(is_emis, is_metal * (1.0 - metal_ok.to(f32)))
            )
            frozen = alive == 0.0
            scat = (alive > 0.0) & (terminated == 0.0)
            ox = torch.where(frozen, ox, fma(eps_sign * EPSILON, nbx, hx))
            oy = torch.where(frozen, oy, fma(eps_sign * EPSILON, nby, hy))
            oz = torch.where(frozen, oz, fma(eps_sign * EPSILON, nbz, hz))
            dx = torch.where(scat, ndx, dx)
            dy = torch.where(scat, ndy, dy)
            dz = torch.where(scat, ndz, dz)
            power = [torch.where(frozen, power[w], new_power[w]) for w in range(W)]
            alive = alive * (1.0 - terminated)

        # bounce-limit exhaustion contributes nothing (rendering.cu:38-39)
        n_valid = torch.where(alive > 0.0, zero, n_valid)
        if residuals:
            res_nvalid[s] = n_valid
            res_power[s] = torch.stack(power)

        # XYZ integration (dev_spectrum_to_XYZ, color.cu:88-104)
        sx_, sy_, sz_ = zero, zero, zero
        delta = torch.full((n,), _DELTA, dtype=f32, device=dev)
        for w in range(W):
            contrib = power[w] * torch.where(float(w) < n_valid, delta, zero)
            sx_ = fma(contrib, lut(tables[0], cell[w], frac[w]), sx_)
            sy_ = fma(contrib, lut(tables[1], cell[w], frac[w]), sy_)
            sz_ = fma(contrib, lut(tables[2], cell[w], frac[w]), sz_)
        accx, accy, accz = accx + sx_, accy + sy_, accz + sz_

    if steps is not None:
        steps.copy_(live)
    xyz = torch.stack([accx, accy, accz], dim=1)
    if residuals:
        return xyz, res_hero, res_nvalid, res_power, res_mat
    return xyz


def render_rays(
    cam_vec, seed, tri_pack, mat_pack, tables, px, py, spp, bounces,
    image_width, rand=None, steps=None,
) -> torch.Tensor:
    """Accumulated XYZ [N, 3] for the rays of pixels (px, py) [N] f32.

    ``seed``: the chunk seed of the hash draws (ignored with ``rand``);
    ``image_width``: the frame width, for the global pixel index of the
    hash; ``rand``: injected planes [spp, n_uniforms(bounces), N] f32;
    ``steps``: optional int32 [N] output of live ray-steps per ray.
    CUDA tensors launch the kernel, CPU tensors run the plain version."""
    _check(cam_vec, tri_pack, mat_pack, tables, px, py, spp, bounces, rand, steps)
    if px.device.type == "cpu":
        return render_rays_reference(
            cam_vec, seed, tri_pack, mat_pack, tables, px, py, spp, bounces,
            image_width, rand, steps,
        )
    xyz = torch.empty((px.shape[0], 3), dtype=torch.float32, device=px.device)
    _launch(
        build.RENDER, cam_vec, seed, tri_pack, mat_pack, tables, px, py, spp, bounces,
        image_width, rand, xyz, steps,
    )
    return xyz


def _launch(kernel, cam_vec, seed, tri_pack, mat_pack, tables, px, py, spp, bounces,
            image_width, rand, xyz, steps, residuals=()):
    """Launch the megakernel or its residual form on CUDA tensors, writing
    xyz, steps (or None) and the residual buffers."""
    if px.device.type != "cuda":
        raise ValueError(f"unsupported device {px.device}")
    f32 = torch.float32
    cam_vec, tri_pack, mat_pack, tables, px, py = (
        x.to(f32).contiguous() for x in (cam_vec, tri_pack, mat_pack, tables, px, py)
    )
    if rand is not None:
        rand = rand.to(f32).contiguous()
    kernel.launch(
        px.device,
        cam_vec.data_ptr(), seed & _M32,
        tri_pack.data_ptr(), tri_pack.shape[0],
        mat_pack.data_ptr(), mat_pack.shape[0],
        tables.data_ptr(), px.data_ptr(), py.data_ptr(), px.shape[0], image_width,
        spp, bounces,
        None if rand is None else rand.data_ptr(),
        xyz.data_ptr(),
        None if steps is None else steps.data_ptr(),
        *(r.data_ptr() for r in residuals),
    )


def render_rays_residuals(
    cam_vec, seed, tri_pack, mat_pack, tables, px, py, spp, bounces,
    image_width, rand=None, steps=None, out=None,
):
    """``render_rays`` that also records the path residuals: returns
    (xyz [N, 3], hero [spp, N], n_valid [spp, N], power [spp, W, N],
    matres int32 [spp, bounces, N]). The xyz equals ``render_rays``'s on
    the same draws. ``out``: preallocated (hero, n_valid, power, matres) to
    write into; every element is written. CUDA tensors launch the kernel's
    residual form (its own launch count), CPU tensors run the plain
    version."""
    _check(cam_vec, tri_pack, mat_pack, tables, px, py, spp, bounces, rand, steps)
    n = px.shape[0]
    dev = px.device
    shapes = ((spp, n), (spp, n), (spp, W, n), (spp, bounces, n))
    dtypes = (torch.float32, torch.float32, torch.float32, torch.int32)
    if out is not None and any(
        o.shape != sh or o.dtype != dt or o.device != dev or not o.is_contiguous()
        for o, sh, dt in zip(out, shapes, dtypes)
    ):
        raise ValueError(f"out must be contiguous tensors of shapes {shapes} and types {dtypes} on {dev}")
    if px.device.type == "cpu":
        xyz, *res = render_rays_reference(
            cam_vec, seed, tri_pack, mat_pack, tables, px, py, spp, bounces,
            image_width, rand, steps, residuals=True,
        )
        if out is None:
            return (xyz, *res)
        for o, r in zip(out, res):
            o.copy_(r)
        return (xyz, *out)
    xyz = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if out is None:
        out = tuple(torch.empty(sh, dtype=dt, device=dev) for sh, dt in zip(shapes, dtypes))
    _launch(
        build.RENDER_RESIDUALS, cam_vec, seed, tri_pack, mat_pack, tables, px, py, spp, bounces,
        image_width, rand, xyz, steps, out,
    )
    return (xyz, *out)


def render_chunk(
    scene, cam, seed: int, x0: int, y0: int, width: int, height: int,
    spp: int, bounces: int, rand: torch.Tensor | None = None,
) -> torch.Tensor:
    """Accumulated-XYZ chunk [height, width, 3] on the scene's device: one
    launch of the megakernel (counterpart of render_chunk_pallas). Pixels
    are row-major; ``rand`` [spp, n_uniforms(bounces), height * width]
    injects the draws in that order, else they are hashed from ``seed``."""
    tri, mat, tab = pack_scene(scene)
    dev = tri.device
    ys, xs = torch.meshgrid(
        torch.arange(y0, y0 + height, device=dev),
        torch.arange(x0, x0 + width, device=dev),
        indexing="ij",
    )
    xyz = render_rays(
        camera_vector(cam).to(dev), seed, tri, mat, tab,
        xs.reshape(-1).to(torch.float32), ys.reshape(-1).to(torch.float32),
        spp, bounces, cam.image_width, rand,
    )
    return xyz.reshape(height, width, 3)
