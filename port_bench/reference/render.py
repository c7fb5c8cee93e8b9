"""The plain reference of the spectral path tracer: one path per (pixel,
sample), traced bounce by bounce in plain PyTorch over [paths] tensors and a
dense [paths, triangles] nearest hit.

It follows the published algorithm (the CUDA-spectral-ray-tracer's
rendering.cu, material.cu, tri.cu, spectrum.cu and color.cu) with the
program's documented draw schedule, so that both trace the same paths from
the same inputs: the pixel key hash32(seed ^ hash32(y * width + x)), draw j
of sample s = hash32(hash32(key + s * 0x85EBCA6B) + j * 0x9E3779B9) >> 8
over 2^24 (jitter 2, hero 1, three a bounce, then the lens disk 2), the
hero comb of 7 wavelengths, and float32 arithmetic with a fused
multiply-add wherever the reference kernel fuses one.

``Arith`` says how the arithmetic is carried out: ``exact`` (float32, each
fused multiply-add rounded once: the program's rounding, so that both take
the same decisions), ``f64hit`` (as ``exact``, with the triangle tests in
float64 by matrix products: several times cheaper on the card, and apart
from ``exact`` only where a decision hangs on the last bit, a ray that
grazes an edge or starts within rounding of a surface) and ``bf16`` (every value and operation in bfloat16:
the lower precision that the correctness control computes in).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np
import torch

W = 7
LAMBDA_MIN, LAMBDA_MAX, N_SAMPLES = 360.0, 830.0, 95
SPAN = LAMBDA_MAX - LAMBDA_MIN
CELL_SCALE = (N_SAMPLES - 1) / SPAN
DELTA = SPAN / float(W)
TWO_PI = 2.0 * 3.14159265358979
EPSILON = 1e-4
DENOM_EPS = 1e-8
BIG = 3.4e38
M32 = 0xFFFFFFFF
# [paths x triangles] elements of one block of the dense nearest hit
HIT_BLOCK = 1 << 26


def n_draws(bounces: int) -> int:
    return 5 + 3 * bounces


def hash32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 of int64 values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & M32
    return x ^ (x >> 16)


def draws(seed: torch.Tensor, px: torch.Tensor, py: torch.Tensor, width: int, sample: torch.Tensor,
          count: int) -> torch.Tensor:
    """[count, N] float32 uniforms of paths with chunk seeds ``seed``,
    pixels (px, py) and sample indices ``sample`` (int64 [N] each)."""
    key = hash32((seed & M32) ^ hash32((py * width + px) & M32))
    k = hash32((key + ((sample * 0x85EBCA6B) & M32)) & M32)
    j = torch.arange(count, dtype=torch.int64, device=key.device)[:, None]
    h = hash32((k[None, :] + ((j * 0x9E3779B9) & M32)) & M32)
    return (h >> 8).to(torch.float32) * (1.0 / 16777216.0)


@functools.lru_cache(maxsize=None)
def _libm(name: str):
    fn = getattr(ctypes.CDLL(ctypes.util.find_library("m")), name)
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    return np.frompyfunc(fn, 1, 1)


class Arith:
    """The arithmetic of one reference computation (module docstring)."""

    def __init__(self, mode: str = "exact"):
        if mode not in ("exact", "f64hit", "bf16"):
            raise ValueError(f"unknown arithmetic {mode!r}")
        self.mode = mode
        self.dtype = torch.bfloat16 if mode == "bf16" else torch.float32

    def fma(self, a, b, c):
        if self.mode == "bf16":
            return a * b + c
        if all(isinstance(x, torch.Tensor) and x.device.type == "cuda" for x in (a, b, c)):
            # on the card, addcmul's float32 kernel is one fused
            # multiply-add (bit-equal to the float64 form below, checked
            # on an H100 over 2^26 random triples)
            return torch.addcmul(c, a, b)
        f64 = lambda x: x.double() if isinstance(x, torch.Tensor) else float(x)  # noqa: E731
        return (f64(a) * f64(b) + f64(c)).to(torch.float32)

    def dot3(self, a0, a1, a2, b0, b1, b2):
        return self.fma(a2, b2, self.fma(a0, b0, a1 * b1))

    def sqrt(self, x):
        return torch.sqrt(x)

    def _trig(self, name, x):
        if self.mode != "bf16" and x.device.type == "cpu":
            flat = x.detach().contiguous().view(-1).numpy()
            return torch.from_numpy(_libm(name + "f")(flat).astype(np.float32)).view(x.shape)
        return getattr(torch, name)(x)

    def sin(self, x):
        return self._trig("sin", x)

    def cos(self, x):
        return self._trig("cos", x)


def nearest_hit(ar: Arith, o, d, tris):
    """(t, row, hit, front) of rays o, d (three [N] tensors each) over the
    triangle pack [T, 17]: the nearest triangle whose plane distance is
    non-negative and whose edge functionals accept the hit point, the lower
    row on a tie; taken over blocks of triangles."""
    n, t_all = o[0].shape[0], tris.shape[0]
    dev, dt = o[0].device, o[0].dtype
    big = min(BIG, float(torch.finfo(dt).max))
    best_t = torch.full((n,), big, dtype=dt, device=dev)
    best_row = torch.zeros(n, dtype=torch.int64, device=dev)
    best_nd = torch.zeros(n, dtype=dt, device=dev)
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    step = max(1, HIT_BLOCK // max(n, 1))
    ox, oy, oz = (x[:, None] for x in o)
    dx, dy, dz = (x[:, None] for x in d)
    for t0 in range(0, t_all, step):
        tp = tris[t0:t0 + step]
        col = lambda k: tp[:, k][None, :]  # noqa: E731
        if ar.mode == "f64hit":
            f64 = torch.float64
            cols = torch.cat([tp[:, 0:3], tp[:, 4:7], tp[:, 7:10], tp[:, 10:13]], 0).to(f64).T  # [3, 4 Tb]
            ad_all = torch.stack(d, 1).to(f64) @ cols
            ao_all = torch.stack(o, 1).to(f64) @ cols
            tb = tp.shape[0]
            nd = ad_all[:, :tb]
            tt = (tp[:, 3].to(f64)[None, :] - ao_all[:, :tb]) / nd
            inside = torch.ones_like(tt, dtype=torch.bool)
            for k in range(3):
                sl = slice((k + 1) * tb, (k + 2) * tb)
                inside &= tt * ad_all[:, sl] + (ao_all[:, sl] + tp[:, 13 + k].to(f64)[None, :]) >= 0.0
            tt = tt.to(dt)
            nd = nd.to(dt)
        else:
            nd = ar.dot3(col(0), col(1), col(2), dx, dy, dz)
            no = ar.dot3(col(0), col(1), col(2), ox, oy, oz)
            tt = (col(3) - no) / nd
            inside = torch.ones_like(tt, dtype=torch.bool)
            for k in range(3):
                g0, g1, g2, c = col(4 + 3 * k), col(5 + 3 * k), col(6 + 3 * k), col(13 + k)
                ao = ar.dot3(g0, g1, g2, ox, oy, oz) + c
                ad = ar.dot3(g0, g1, g2, dx, dy, dz)
                inside &= ar.fma(tt, ad, ao) >= 0.0
        valid = inside & (nd.abs() >= DENOM_EPS) & (tt >= 0.0) & (tt < big)
        tm = torch.where(valid, tt, torch.full_like(tt, big))
        bi = torch.argmin(tm, dim=1)
        bt = tm.gather(1, bi[:, None])[:, 0]
        bhit = valid.any(dim=1)
        better = bhit & (~hit | (bt < best_t))
        best_t = torch.where(better, bt, best_t)
        best_row = torch.where(better, bi + t0, best_row)
        best_nd = torch.where(better, nd.gather(1, bi[:, None])[:, 0], best_nd)
        hit |= bhit
    return best_t, best_row, hit, hit & (best_nd < 0.0)


def lut(row, cell, frac, ar: Arith):
    return ar.fma(1.0 - frac, row[cell], frac * row[cell + 1])


def hero_comb(hero, tables, ar: Arith):
    """Per wavelength of the comb: (lambda, cell, frac, d65, sky)."""
    out = []
    for w in range(W):
        lw = hero + w * (SPAN / float(W))
        lw = torch.where(lw > LAMBDA_MAX, lw - SPAN, lw)
        xg = (lw - LAMBDA_MIN) * CELL_SCALE
        cw = xg.to(torch.int32).clamp(0, N_SAMPLES - 2).long()
        fw = xg - cw.to(lw.dtype)
        out.append((lw, cw, fw, lut(tables[3], cw, fw, ar), lut(tables[4], cw, fw, ar)))
    return out


def spectral_weight(mr, lam, d65w, ar: Arith, power_sq=None):
    """SPD of material rows ``mr`` [N, 16] at ``lam`` (material.cuh:71-84):
    the dielectric's 1, the emitter's power^2 * sigmoid * D65, the
    reflectors' sigmoid."""
    x = ar.fma(ar.fma(mr[:, 0], lam, mr[:, 1]), lam, mr[:, 2])
    sig = 0.5 * x / ar.sqrt(ar.fma(x, x, 1.0)) + 0.5
    psq = mr[:, 8] if power_sq is None else power_sq
    return mr[:, 5] + mr[:, 6] * psq * sig * d65w + (mr[:, 3] + mr[:, 4]) * sig


def camera_rays(cam, px, py, u, ar: Arith):
    """Origins and directions (rendering.cu:66-87) of pixels (px, py) [N]
    with jitter draws u[0], u[1] and lens draws u[2], u[3]; ``cam`` [N, 20]
    or [20]: centre, pixel00, delta u, delta v, defocus u, defocus v, the
    defocus flag, pad."""
    c = lambda k: cam[..., k]  # noqa: E731
    fx = px + (u[0] - 0.5)
    fy = py + (u[1] - 0.5)
    dr = ar.sqrt(u[2]) * c(18)
    dth = TWO_PI * u[3]
    du, dv = dr * ar.cos(dth), dr * ar.sin(dth)
    o = [ar.fma(dv, c(15 + k), ar.fma(du, c(12 + k), c(k))) for k in range(3)]
    d = [ar.fma(fy, c(9 + k), ar.fma(fx, c(6 + k), c(3 + k))) - o[k] for k in range(3)]
    return o, d


def trace(scene, cam, seed, px, py, sample, width: int, bounces: int, ar: Arith | None = None):
    """Trace one path for each (pixel, sample): ``seed``, ``px``, ``py``,
    ``sample`` int64 [N], ``cam`` [N, 20] or [20]. Returns (xyz [N, 3],
    record), record = dict(hero [N], n_valid [N], matres int8 [bounces, N]
    (material + 1 on a hit, -1 on a sky miss, 0 once the path has ended),
    live [N] the bounces traced while alive)."""
    ar = ar or Arith()
    dt = ar.dtype
    dev = px.device
    tris, mats, tables = (x.to(dev, dt) for x in (scene.tris, scene.mats, scene.tables))
    u = draws(seed, px, py, width, sample, n_draws(bounces)).to(dt)
    n = px.shape[0]
    o, d = camera_rays(cam.to(dt), px.to(dt), py.to(dt), [u[0], u[1], u[3 + 3 * bounces], u[4 + 3 * bounces]], ar)
    hero = ar.fma(SPAN, u[2], LAMBDA_MIN)
    comb = hero_comb(hero, tables, ar)
    one = torch.ones(n, dtype=dt, device=dev)
    zero = torch.zeros(n, dtype=dt, device=dev)
    power = [one] * W
    alive = one
    n_valid = torch.full((n,), float(W), dtype=dt, device=dev)
    matres = torch.zeros((bounces, n), dtype=torch.int8, device=dev)
    live = torch.zeros(n, dtype=torch.int32, device=dev)
    for b in range(bounces):
        live += (alive > 0.0).to(torch.int32)
        ua, ub, uc = u[3 + 3 * b], u[4 + 3 * b], u[5 + 3 * b]
        t, row, hit_b, front = nearest_hit(ar, o, d, tris)
        hitf = hit_b.to(dt)
        hit = hitf * alive
        miss = (1.0 - hitf) * alive
        ts = torch.where(hit_b, t, zero)
        h = [ar.fma(ts, d[k], o[k]) for k in range(3)]
        tp = tris[row]
        nb = [torch.where(hit_b, torch.where(front, tp[:, k], -tp[:, k]), zero) for k in range(3)]
        mat_i = torch.where(hit_b, tp[:, 16].float().to(torch.int64), torch.zeros_like(row))
        matres[b] = torch.where(hit > 0.0, mat_i + 1, torch.where(miss > 0.0, -1, 0)).to(torch.int8)
        mr = mats[mat_i]
        new_power = []
        for w in range(W):
            lam, _, _, d65w, skyw = comb[w]
            spd = spectral_weight(mr, lam, d65w, ar)
            new_power.append(power[w] * (hit * spd + miss * skyw + (1.0 - alive)))
        ilen = one / ar.sqrt(ar.dot3(d[0], d[1], d[2], d[0], d[1], d[2]))
        un = [x * ilen for x in d]
        sz = 2.0 * ua - 1.0
        sphi = TWO_PI * ub
        sr = ar.sqrt(torch.clamp_min(ar.fma(-sz, sz, 1.0), 0.0))
        s = [sr * ar.cos(sphi), sr * ar.sin(sphi), sz]
        lamb = [nb[k] + s[k] for k in range(3)]
        degen = (lamb[0].abs() < 1e-8) & (lamb[1].abs() < 1e-8) & (lamb[2].abs() < 1e-8)
        lamb = [torch.where(degen, nb[k], lamb[k]) for k in range(3)]
        dn = ar.dot3(*un, *nb)
        refl = [ar.fma(-(2.0 * dn), nb[k], un[k]) for k in range(3)]
        fuzz = mr[:, 7]
        met = [ar.fma(fuzz, s[k], refl[k]) for k in range(3)]
        metal_ok = ar.dot3(*met, *nb) > 0.0
        hl = comb[0][0] * 1e-3
        h2 = hl * hl
        n2 = 1.0 + mr[:, 9] * h2 / (h2 - mr[:, 12]) + mr[:, 10] * h2 / (h2 - mr[:, 13]) + mr[:, 11] * h2 / (h2 - mr[:, 14])
        ir = ar.sqrt(torch.clamp_min(n2, 1e-6))
        ratio = torch.where(front, one / ir, ir)
        cos_t = torch.clamp_max(-dn, 1.0)
        sin_t = ar.sqrt(torch.clamp_min(ar.fma(-cos_t, cos_t, 1.0), 0.0))
        q = (1.0 - ratio) / (1.0 + ratio)
        r0 = q * q
        om = 1.0 - cos_t
        om2 = om * om
        schlick = ar.fma(1.0 - r0, om * (om2 * om2), r0)
        reflect = (ratio * sin_t > 1.0) | (schlick > uc)
        qv = [ratio * ar.fma(cos_t, nb[k], un[k]) for k in range(3)]
        par = ar.sqrt(torch.clamp_min(1.0 - ar.dot3(*qv, *qv), 0.0))
        glass = [torch.where(reflect, refl[k], ar.fma(-par, nb[k], qv[k])) for k in range(3)]
        is_lamb, is_metal, is_diel, is_emis = mr[:, 3], mr[:, 4], mr[:, 5], mr[:, 6]
        refracted = is_diel * torch.where(reflect, zero, one)
        nd_ = [is_lamb * lamb[k] + is_metal * met[k] + is_diel * glass[k] for k in range(3)]
        eps_sign = 1.0 - 2.0 * refracted
        hit_pos = hit > 0.0
        n_valid = torch.where(hit_pos & (refracted > 0.0), one, n_valid)
        n_valid = torch.where(hit_pos & (is_metal > 0.0) & ~metal_ok, zero, n_valid)
        ended = torch.maximum(miss, hit * torch.maximum(is_emis, is_metal * (1.0 - metal_ok.to(dt))))
        frozen = alive == 0.0
        scat = (alive > 0.0) & (ended == 0.0)
        o = [torch.where(frozen, o[k], ar.fma(eps_sign * EPSILON, nb[k], h[k])) for k in range(3)]
        d = [torch.where(scat, nd_[k], d[k]) for k in range(3)]
        power = [torch.where(frozen, power[w], new_power[w]) for w in range(W)]
        alive = alive * (1.0 - ended)
    n_valid = torch.where(alive > 0.0, zero, n_valid)
    xyz = path_xyz(power, n_valid, comb, tables, ar)
    return torch.stack(xyz, 1), dict(hero=hero, n_valid=n_valid, matres=matres, live=live)


def path_xyz(power, n_valid, comb, tables, ar: Arith):
    """XYZ of finished paths (color.cu:88-104): the comb's wavelengths below
    ``n_valid`` weighted by the colour-matching functions."""
    zero = torch.zeros_like(n_valid)
    delta = torch.full_like(n_valid, DELTA)
    acc = [zero, zero, zero]
    for w in range(W):
        _, cell, frac, _, _ = comb[w]
        contrib = power[w] * torch.where(float(w) < n_valid, delta, zero)
        acc = [ar.fma(contrib, lut(tables[k], cell, frac, ar), acc[k]) for k in range(3)]
    return acc


def xyz_from_record(mats, tables, record, ar: Arith, coeffs=None, emission_power=None):
    """XYZ [N, 3] of traced paths recomputed from their record and the
    materials, differentiable in ``coeffs`` [M, 3] and ``emission_power``
    [M] (which replace the pack's): a path's power at each wavelength is the
    product, over the materials, of the material's spectral weight to the
    power of its bounces on the path, and of the sky's for a miss. The same
    product as ``trace`` forms bounce by bounce, in another order; the
    weights are computed per material over all paths, so that the gradient
    gathers by sums and not by scattering into a handful of rows."""
    hero, n_valid, matres = record["hero"], record["n_valid"], record["matres"]
    comb = hero_comb(hero, tables, ar)
    n_mats = mats.shape[0]
    coeffs = mats[:, 0:3] if coeffs is None else coeffs
    psq = mats[:, 8] if emission_power is None else emission_power**2
    codes = matres.long()
    visits = [(codes == m + 1).sum(0) for m in range(n_mats)]
    k_sky = (codes == -1).sum(0)
    one = torch.ones_like(hero)
    power = []
    for w in range(W):
        lam, _, _, d65w, skyw = comb[w]
        p = torch.where(k_sky > 0, skyw, one) ** k_sky.to(hero.dtype)
        for m in range(n_mats):
            k = visits[m]
            x = ar.fma(ar.fma(coeffs[m, 0], lam, coeffs[m, 1]), lam, coeffs[m, 2])
            sig = 0.5 * x / ar.sqrt(ar.fma(x, x, 1.0)) + 0.5
            spd = mats[m, 5] + mats[m, 6] * psq[m] * sig * d65w + (mats[m, 3] + mats[m, 4]) * sig
            p = p * torch.where(k > 0, spd, one) ** k.to(hero.dtype)
        power.append(p)
    return torch.stack(path_xyz(power, n_valid, comb, tables, ar), 1)


def srgb_u8(xyz_mean: torch.Tensor) -> torch.Tensor:
    """uint8 sRGB of mean-per-sample XYZ [..., 3] (color.cu:15-49): the
    XYZ -> linear sRGB matrix, the gamma with exponent 0.416666, the
    truncation of v * 255.99."""
    m = ((3.2404542, -1.5371385, -0.4985314), (-0.9692660, 1.8760108, 0.0415560),
         (0.0556434, -0.2040259, 1.0572252))
    x, y, z = xyz_mean[..., 0], xyz_mean[..., 1], xyz_mean[..., 2]
    lin = torch.stack([m[i][0] * x + m[i][1] * y + m[i][2] * z for i in range(3)], -1)
    pw = 1.055 * torch.pow(torch.clamp_min(lin, 1e-30), 0.416666) - 0.055
    g = torch.where(lin < 0.0031308, 12.92 * lin, torch.where(lin < 1.0, pw, torch.ones_like(lin)))
    g = torch.where(lin < 0.0, torch.zeros_like(lin), g)
    return torch.clamp(torch.trunc(g * 255.99), 0.0, 255.0).to(torch.uint8)
