"""Residual replay, the fused backward of the render megakernel: the CUDA
kernel and its plain version.

Port of spectral_tpu/ops/pallas/grad_kernel.py (``render_grads_pallas``
:289, ``_grad_kernel`` :63, ``_lut_slope`` :51). ``render_grads`` launches
csrc/grad_kernel.cu for CUDA tensors and runs ``render_grads_reference``,
the plain PyTorch version (vectorised over rays, one sample at a time), for
CPU tensors; there is no other fallback.

The residuals are those of ops/cuda/render_kernel.py::render_rays_residuals.
Any number of materials works: there is no padding of M. The return
convention is render_grads_pallas's: (d_coeffs [M, 3], d_power [M]
[, d_bg [95]] [, sell_a [spp, N], sell_b [spp, N]]).
"""

from __future__ import annotations

import ctypes

import torch

from ...utils.constants import LAMBDA_MAX, LAMBDA_MIN, N_CIE_SAMPLES
from ..fp32 import fma
from . import build
from .render_kernel import MAT_PACK_WIDTH, N_TABLES, W, comb_cell, lut

_CSCALE = (N_CIE_SAMPLES - 1) / (LAMBDA_MAX - LAMBDA_MIN)
_DELTA = (LAMBDA_MAX - LAMBDA_MIN) / float(W)
_TINY = 1e-30


def lut_slope(row: torch.Tensor, cell: torch.Tensor) -> torch.Tensor:
    """tab[cell + 1] - tab[cell]: the lerp's exact a.e. slope per cell
    (times (N_CIE_SAMPLES - 1) / span for d/dlambda)."""
    return row[cell + 1] - row[cell]


def _check(mat_pack, tables, g, hero, n_valid, power, matres, spp, bounces):
    n = g.shape[0]
    dev = g.device
    want = {
        "mat_pack": (mat_pack, (mat_pack.shape[0], MAT_PACK_WIDTH), torch.float32),
        "tables": (tables, (N_TABLES, N_CIE_SAMPLES), torch.float32),
        "g": (g, (n, 3), torch.float32),
        "hero": (hero, (spp, n), torch.float32),
        "n_valid": (n_valid, (spp, n), torch.float32),
        "power": (power, (spp, W, n), torch.float32),
        "matres": (matres, (spp, bounces, n), torch.int32),
    }
    for name, (x, shape, dtype) in want.items():
        if tuple(x.shape) != shape or x.dtype != dtype or x.device != dev:
            raise ValueError(
                f"{name} must be {dtype} {shape} on {dev}, got {x.dtype} {tuple(x.shape)} on {x.device}"
            )
    if n < 1 or spp < 1 or bounces < 1 or mat_pack.shape[0] < 1:
        raise ValueError(f"empty replay: {n} rays, {spp} spp, {bounces} bounces, {mat_pack.shape[0]} materials")


def render_grads_reference(
    mat_pack, tables, g, hero, n_valid, power, matres, spp, bounces,
    want_bg_grads=False, want_sellmeier=False,
):
    """The plain PyTorch version of the replay kernel, in its arithmetic."""
    n = g.shape[0]
    n_mats = mat_pack.shape[0]
    dev = g.device
    f32 = torch.float32
    gx, gy, gz = g[:, 0], g[:, 1], g[:, 2]
    acc = torch.zeros((n_mats, 4), dtype=f32, device=dev)
    acc_bg = torch.zeros(N_CIE_SAMPLES, dtype=f32, device=dev)
    sell_a = torch.empty((spp, n), dtype=f32, device=dev)
    sell_b = torch.empty((spp, n), dtype=f32, device=dev)
    zero = torch.zeros(n, dtype=f32, device=dev)
    delta = torch.full((n,), _DELTA, dtype=f32, device=dev)

    for s in range(spp):
        mt = matres[s]
        missed = (mt == -1).any(0).to(f32)
        lam, a, d65, d65s, tail = [], [], [], [], []
        for w in range(W):
            lw, cell, frac = comb_cell(hero[s], w)
            resp = gx * lut(tables[0], cell, frac) + gy * lut(tables[1], cell, frac) + gz * lut(tables[2], cell, frac)
            mask = torch.where(float(w) < n_valid[s], delta, zero)
            p = power[s, w]
            aw = resp * mask * p
            lam.append(lw)
            a.append(aw)
            if want_bg_grads or want_sellmeier:
                bgw = lut(tables[4], cell, frac)
            if want_bg_grads:
                common = aw * missed / torch.clamp_min(bgw, _TINY)
                acc_bg.index_add_(0, cell, common * (1.0 - frac))
                acc_bg.index_add_(0, cell + 1, common * frac)
            if want_sellmeier:
                d65.append(lut(tables[3], cell, frac))
                d65s.append(lut_slope(tables[3], cell) * _CSCALE)
                respslope = (
                    gx * lut_slope(tables[0], cell) + gy * lut_slope(tables[1], cell) + gz * lut_slope(tables[2], cell)
                ) * _CSCALE
                bgslope = lut_slope(tables[4], cell) * _CSCALE
                tail.append(mask * p * respslope + aw * missed * bgslope / torch.clamp_min(bgw, _TINY))

        sellb = zero
        for m in range(n_mats):
            k_m = (mt == m + 1).sum(0).to(f32)
            if not bool(k_m.any()):
                continue
            mr = mat_pack[m]
            c0, c1, c2 = mr[0], mr[1], mr[2]
            is_diel, is_emis, power_sq = mr[5], mr[6], mr[8]
            two_over_p = 2.0 / torch.sqrt(torch.clamp_min(power_sq, _TINY))
            dc0 = dc1 = dc2 = dp = zero
            for w in range(W):
                x = fma(fma(c0, lam[w], c1), lam[w], c2)
                inv_sq = 1.0 / fma(x, x, 1.0)
                sq = torch.sqrt(inv_sq)
                sig = fma(0.5 * x, sq, 0.5)
                dsig = 0.5 * inv_sq * sq
                dlog_dx = (1.0 - is_diel) * dsig / torch.clamp_min(sig, _TINY)
                base = a[w] * k_m
                common = base * dlog_dx
                dc0 = dc0 + common * lam[w] * lam[w]
                dc1 = dc1 + common * lam[w]
                dc2 = dc2 + common
                dp = dp + base * is_emis * two_over_p
                if want_sellmeier:
                    dxdlam = 2.0 * c0 * lam[w] + c1
                    dlog_lam = dlog_dx * dxdlam + is_emis * (d65s[w] / torch.clamp_min(d65[w], _TINY))
                    sellb = sellb + base * dlog_lam
            acc[m] += torch.stack([dc0.sum(), dc1.sum(), dc2.sum(), dp.sum()])
        if want_sellmeier:
            sa = zero
            for w in range(W):
                sa = sa + a[w]
                sellb = sellb + tail[w]
            sell_a[s] = sa
            sell_b[s] = sellb

    ret = [acc[:, :3].clone(), acc[:, 3].clone()]
    if want_bg_grads:
        ret.append(acc_bg)
    if want_sellmeier:
        ret.extend([sell_a, sell_b])
    return tuple(ret)


def launch_shape(n, n_mats, bounces, want_bg_grads, want_sellmeier, device) -> dict:
    """How render_grads launches the kernel on a CUDA ``device``: ``grid``
    blocks of ``block`` threads (the block size of most resident warps),
    ``blocks_per_sm`` resident (occupancy API), ``smem`` dynamic shared
    bytes a block, and ``packed``: 1 for the form that packs the bounce
    counts into registers (at most 16 materials and 15 bounces)."""
    fn = build.GRAD.symbol("grad_grid", [build.I] * 5 + [ctypes.POINTER(ctypes.c_int)])
    shape = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        rc = fn(n, n_mats, bounces, int(want_bg_grads), int(want_sellmeier), shape)
    if rc != 0:
        raise RuntimeError(f"grad: sizing the launch failed with CUDA error {rc}")
    return dict(zip(("grid", "block", "blocks_per_sm", "smem", "packed"), shape))


def render_grads(
    mat_pack, tables, g, hero, n_valid, power, matres, spp, bounces,
    want_bg_grads=False, want_sellmeier=False,
):
    """Fused backward: residuals + cotangent g = d loss / d xyz [N, 3] ->
    (d_coeffs [M, 3], d_power [M][, d_bg [95]][, sell_a [spp, N],
    sell_b [spp, N]]). The sell pair are the per-(sample, ray) reparam
    scalars that diff/fast.py folds into Sellmeier B/C gradients. CUDA
    tensors launch the kernel, CPU tensors run the plain version."""
    _check(mat_pack, tables, g, hero, n_valid, power, matres, spp, bounces)
    if g.device.type == "cpu":
        return render_grads_reference(
            mat_pack, tables, g, hero, n_valid, power, matres, spp, bounces,
            want_bg_grads, want_sellmeier,
        )
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    dev = g.device
    n, n_mats = g.shape[0], mat_pack.shape[0]
    mat_pack, tables, g, hero, n_valid, power, matres = (
        x.contiguous() for x in (mat_pack, tables, g, hero, n_valid, power, matres)
    )
    shape = launch_shape(n, n_mats, bounces, want_bg_grads, want_sellmeier, dev)
    row = 4 * n_mats + (N_CIE_SAMPLES if want_bg_grads else 0)
    partial = torch.empty((shape["grid"], row), dtype=torch.float32, device=dev)
    out = torch.empty(row, dtype=torch.float32, device=dev)
    sell = [torch.empty((spp, n), dtype=torch.float32, device=dev) for _ in range(2)] if want_sellmeier else [None, None]
    build.GRAD.launch(
        dev,
        mat_pack.data_ptr(), n_mats, tables.data_ptr(), g.data_ptr(),
        hero.data_ptr(), n_valid.data_ptr(), power.data_ptr(), matres.data_ptr(),
        n, spp, bounces, int(want_bg_grads), int(want_sellmeier), shape["grid"], shape["block"],
        partial.data_ptr(), out.data_ptr(),
        None if sell[0] is None else sell[0].data_ptr(),
        None if sell[1] is None else sell[1].data_ptr(),
    )
    per_mat = out[: 4 * n_mats].view(n_mats, 4)
    ret = [per_mat[:, :3], per_mat[:, 3]]
    if want_bg_grads:
        ret.append(out[4 * n_mats :])
    if want_sellmeier:
        ret.extend(sell)
    return tuple(ret)
