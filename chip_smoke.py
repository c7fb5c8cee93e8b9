#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spectral_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel from csrc/ with nvcc, all sources at once,
   check with ``cuobjdump -sass`` that the dense render kernels read the
   scene with 128-bit shared loads and the leaf sweeps (the leaf forms of
   the render kernel, the sorted camera and bounce kernels) with 128-bit
   global loads, and time the render kernel's first launch in this process
   (1 pixel) beside a second one;
3. each kernel against its plain PyTorch version on the card, at 64x64,
   8 spp, 5 bounces on each scene, with injected uniform planes and with
   the hash draws: the render megakernel and its residual form (residual
   buffers filled with garbage first), each bit-equal to the plain version
   in xyz, live ray-steps and every residual, and the residual
   form's xyz equal to the forward kernel's; the replay kernel on those
   residuals (background gradients on, Sellmeier scalars on for PRISM; two
   launches bit-identical);
4. each kernel at its path's shapes, timed beside its plain version and the
   card's bound, and held against the plain version there too: the render
   megakernel on the default Cornell frame (600x600, 500 spp, 10 bounces,
   hash draws; bit-equal), the intersect kernel on random rays against
   CORNELL at that frame's ray count, the residual (bit-equal) and replay
   kernels on the training frame (Cornell 1920x1080, 16 spp, 8 bounces);
   the lane efficiency of the render and residual kernels there, live
   ray-steps / (32 x warp sweeps);
5. the main path, once, as a user runs it: ``python -m
   spectral_tpu_torch.main --save`` with the default Cornell box into a
   temporary directory; the megakernel's launch count must equal the chunk
   count and the BMP must show the lit box;
6. the training path: three ``train_step_fused`` steps on the training
   frame from a perturbed white wall against a target rendered at the true
   materials, timed with CUDA events; one launch of each fused kernel per
   step, and a falling loss;
7. the dispersion path: ``render_rays_diff_fused`` with reparam_glass = 2
   on PRISM's 64x32 crop, 64 spp, 6 bounces (the fused configuration of
   examples/inverse_dispersion.py); a finite, nonzero Sellmeier gradient;
8. the large-scene kernels against their plain versions on
   build_tri_field(520, seed=3), on the 10k field (10008, seed=0), with
   planes and with hash draws, and on the 200k field (200064, seed=0) with
   hash draws, at 128x64, 4 spp, 5 bounces: the leaf megakernel, forward and
   residual (into garbage-filled buffers); the sorted scheduler's three
   kernels, forward and residual; the sorted scheduler against the leaf
   megakernel (one source of arithmetic: equal paths); and the leaf
   megakernel on CORNELL with 8-triangle leaves against the dense
   megakernel. All bit-equal: xyz, every residual, live ray-steps and the
   leaves, groups and super-groups entered;
9. the large-scene kernels at the field's shapes (10k field, 512x256, 4 spp,
   6 bounces, hash draws; bench.py:29-98), each timed beside its plain
   version and its bound (counted from the run's boxes entered, and for
   comparison under the flat sweep over the same pack), with the slab
   tests a live ray-step at each level, and held bit-equal to the plain
   version there;
10. the field render as a user runs it: RenderManager with one chunk the
   size of the frame, through render_chunk into the sorted scheduler; the
   same frame through the leaf megakernel (sched="mega"), equal; then the
   200k field (bench.py:281-287) on the same frame, both schedulers equal,
   and its sorted kernels timed with their bounds and counts;
11. the field training path: three ``train_step_fused`` steps on the 10k
   field at 512x256, 4 spp, 6 bounces (bench.py:228-280), from a perturbed
   white against a target at the true materials, and one fused gradient
   through the leaf megakernel's residual form (sched="mega").

Launch counts are set to 0 just before each of phases 5-7 and 10-11 and
read just after. Prints a ``{"kernels": [...]}`` line after phase 11, with
each kernel's launches on its path (the render megakernel's from phase 5,
the fused kernels' from phase 6, the leaf megakernel's and the sorted
kernels' from phase 10, the leaf residual form's from phase 11), then the
nvidia-smi line, and last ``{"ok": true, "device": {...}}``. Exits
non-zero, printing no result, without a CUDA device or outside a checkout
of the repository.

``python3 chip_smoke.py --leaf-sizes`` instead times both large-scene
schedulers on the 10k and 200k fields at leaf sizes 8 to 128 (the sweep
behind ops/cuda/render_kernel.py::LEAF_SIZE) and prints one JSON line.

``python3 chip_smoke.py --ab BASE [OTHER ...]`` times the render kernels
(B2 at the default frame, B3 at the training frame, B5 and the sorted
kernels at the 10k field frame, the sorted kernels at the 200k field
frame) of other checkouts of the port against this one's, one process
each, in the order BASE, this, OTHER..., this, BASE: a checkout is any
directory holding a ``spectral_tpu_torch`` package, such as an unpacked
parent commit (``git archive``) or a copy with one compiled choice
changed. Every output must be bit-equal to this checkout's (digests of
the renders and residuals). ``--time ROOT`` is one such process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# render tolerance (tests/test_torch_render.py): per value and mean
ATOL, RTOL, MEAN_TOL = 2e-3, 1e-5, 2e-5
# FP32 operations counted from the sources (csrc/*.cu notes)
SWEEP_FLOPS_PER_TRI = 51
SHADE_FLOPS_PER_STEP = 340
SAMPLE_FLOPS = 340
# the replay (csrc/grad_kernel.cu): per sample-ray, per sample-ray with a
# background miss, per material present in a sample-ray's path, and the
# Sellmeier scalars' share of the first and third
GRAD_FLOPS_PER_SAMPLE = 189
GRAD_FLOPS_PER_MISS = 56
GRAD_FLOPS_PER_MATERIAL = 203
SELL_FLOPS_PER_SAMPLE = 189
SELL_FLOPS_PER_MATERIAL = 70
# power residual tolerance (tests/test_wavefront_sorted.py:127); replay
# gradients per column within REPLAY_REL of the column's largest value
POWER_RTOL, POWER_ATOL = 2e-4, 1e-5
REPLAY_REL = 2e-4
# the leaf sweep (csrc/leaf_sweep.cuh): a valid leaf's slab test per live
# ray-step; the curves the sorted kernels recompute from the hero per
# launch; the XYZ tail the integrate kernel computes per sample-ray
SLAB_FLOPS_PER_LEAF = 25
N_TABLES_FLOATS = 5 * 95
CURVE_FLOPS = 100
XYZ_FLOPS = 150
# the ray state (ops/cuda/wavefront_kernel.py): 17 floats a sample-ray
STATE_BYTES = 4 * 17
# the field configurations (bench.py:29-98, 228-287)
FIELD_W, FIELD_H, FIELD_SPP, FIELD_BOUNCES = 512, 256, 4, 6
FIELD_TRIS, BIG_FIELD_TRIS = 10008, 200064
FIELD_SEED = 4321
FIELD_LR = 1e-13 * 256 / (FIELD_W * FIELD_H)
# the training path: the JAX package's fused-gradient configuration
# (BASELINE.md:44,46), at the full frame
TRAIN_W, TRAIN_H, TRAIN_SPP, TRAIN_BOUNCES, TRAIN_SEED = 1920, 1080, 16, 8, 1234
# SGD on the un-normalized sum, whose c0 gradient (it multiplies lambda^2)
# grows with the pixel count: 1e-13 per 256 pixels
TRAIN_LR = 1e-13 * 256 / (TRAIN_W * TRAIN_H)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def sass_loads(lib, op: str, name: str) -> dict:
    """The load instructions ``op`` (LDS or LDG) of each kernel whose mangled
    name holds ``name`` followed by its bool template arguments, in a built
    library, by width and kind, from ``cuobjdump -sass``; keyed by the
    template arguments, e.g. "<0,1>"."""
    from spectral_tpu_torch.ops.cuda.build import find_nvcc

    cuobjdump = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True, timeout=300,
                          check=True).stdout
    loads = {}
    for fn, body in re.findall(r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", sass, re.S):
        form = re.search(rf"\d{name}((?:ILb\d|ELb\d)+)E", fn)
        if form:
            kinds = [m.group(1) or ".32" for m in re.finditer(rf"\b{op}((?:\.\w+)*)", body)]
            key = "<" + ",".join(re.findall(r"Lb(\d)", form.group(1))) + ">"
            loads[key] = {k: kinds.count(k) for k in sorted(set(kinds))}
    return loads


def warp_buffer(n: int, dev):
    """An int32 [ceil(n / 32)] buffer of warp sweeps, filled with -1."""
    return torch.full((-(-n // 32),), -1, dtype=torch.int32, device=dev)


def lane_efficiency(name: str, steps, warps, persistent: bool) -> float:
    """Live ray-steps over the lane-sweeps of the warps that ran them. A
    regenerating warp of 32 consecutive rays sweeps as often as its busiest
    lane has live ray-steps; a persistent grid's warps run at most 32 live
    ray-steps a sweep."""
    live = steps.to(torch.int64)
    sweeps = int(warps.to(torch.int64).sum())
    if persistent:
        ok = int(warps.min()) >= 0 and int(live.sum()) <= 32 * sweeps
    else:
        busiest = torch.nn.functional.pad(live, (0, 32 * warps.numel() - live.numel())).reshape(-1, 32).amax(1)
        ok = torch.equal(warps.to(torch.int64), busiest)
    if not ok:
        raise SystemExit(f"{name}: the warp sweeps do not fit the kernel's loop")
    return int(live.sum()) / (32 * sweeps)


def check_render(name: str, args) -> tuple[float, float, int, float, float]:
    """One render through the dense kernel and through its plain version on
    the same inputs: the XYZ and the live ray-step counts must be equal (one
    source of float32 operations, in one order). Returns max abs, mean abs,
    live ray-steps, the plain version's wall time in ms and the kernel's
    lane efficiency."""
    from spectral_tpu_torch.ops.cuda.render_kernel import render_rays, render_rays_reference

    n, dev = args[5].numel(), args[5].device
    steps = torch.zeros(n, dtype=torch.int32, device=dev)
    ref_steps = torch.zeros_like(steps)
    warps = warp_buffer(n, dev)
    got = render_rays(*args, steps, warp_steps=warps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = render_rays_reference(*args, ref_steps)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    err = (got - ref).abs()
    mx, mean = float(err.max()), float(err.mean())
    live = int(steps.to(torch.int64).sum())
    eff = lane_efficiency(f"render {name}", steps, warps, persistent=True)
    log(f"  {name}: max abs {mx:.3g}, mean abs {mean:.3g}, lane efficiency {eff:.4f}")
    if not torch.equal(steps, ref_steps):
        raise SystemExit(f"render {name}: live ray-steps differ from the plain version")
    if float(ref.sum()) <= 0:
        raise SystemExit(f"render {name}: black image")
    if not torch.equal(got, ref) or not torch.isfinite(got).all():
        raise SystemExit(f"render {name}: kernel differs from its plain version or is not finite")
    return mx, mean, live, plain_ms, eff


def check_residuals(name: str, args):
    """The dense residual kernel (into buffers filled with garbage) against
    its plain version and against the forward kernel: xyz, every residual
    and the live ray-steps equal. Returns (residuals, max
    abs error of xyz and power, mean abs error of xyz, plain ms, live
    ray-steps, lane efficiency)."""
    from spectral_tpu_torch.ops.cuda.render_kernel import (
        render_rays, render_rays_reference, render_rays_residuals,
    )

    n, spp, bounces = args[5].numel(), args[7], args[8]
    dev = args[5].device
    steps = torch.zeros(n, dtype=torch.int32, device=dev)
    ref_steps = torch.zeros_like(steps)
    warps = warp_buffer(n, dev)
    xyz, *res = render_rays_residuals(*args, steps, out=garbage(spp, bounces, n, dev), warp_steps=warps)
    fwd = render_rays(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_xyz, *ref = render_rays_reference(*args, ref_steps, residuals=True)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    for k, what in ((0, "hero"), (1, "n_valid"), (2, "power"), (3, "matres")):
        if not torch.equal(res[k], ref[k]):
            raise SystemExit(f"residuals {name}: {what} differs from the plain version")
    if not torch.equal(xyz, fwd):
        raise SystemExit(f"residuals {name}: xyz differs from the forward kernel's")
    if not torch.equal(steps, ref_steps):
        raise SystemExit(f"residuals {name}: live ray-steps differ from the plain version")
    p_err = (res[2] - ref[2]).abs()
    x_err = (xyz - ref_xyz).abs()
    mx, mean = max(float(p_err.max()), float(x_err.max())), float(x_err.mean())
    ended = int((res[3] == 0).sum())
    live = int(steps.to(torch.int64).sum())
    eff = lane_efficiency(f"residuals {name}", steps, warps, persistent=False)
    log(f"  {name}: xyz/power max abs {mx:.3g}, xyz mean abs {mean:.3g}, lane efficiency {eff:.4f}, "
        f"{ended} matres entries after a path ended")
    if not torch.equal(xyz, ref_xyz) or not torch.isfinite(xyz).all() or float(ref_xyz.sum()) <= 0:
        raise SystemExit(f"residuals {name}: kernel differs from its plain version")
    return res, mx, mean, plain_ms, live, eff


def check_replay(name: str, mat, tab, g, res, spp: int, bounces: int, sell: bool):
    """The replay kernel, launched twice (bit-identical), against its plain
    version. Returns (max abs error, largest error over a column's largest
    value, plain ms)."""
    from spectral_tpu_torch.ops.cuda.grad_kernel import render_grads, render_grads_reference

    got = render_grads(mat, tab, g, *res, spp, bounces, want_bg_grads=True, want_sellmeier=sell)
    again = render_grads(mat, tab, g, *res, spp, bounces, want_bg_grads=True, want_sellmeier=sell)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise SystemExit(f"replay {name}: two launches differ")
    t0 = time.perf_counter()
    ref = render_grads_reference(mat, tab, g, *res, spp, bounces, want_bg_grads=True, want_sellmeier=sell)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    mx, rel = 0.0, 0.0
    cols = [got[0], got[1][:, None], got[2][:, None]]
    ref_cols = [ref[0], ref[1][:, None], ref[2][:, None]]
    for a, b in zip(cols, ref_cols):
        for j in range(b.shape[1]):
            err, scale = float((a[:, j] - b[:, j]).abs().max()), float(b[:, j].abs().max())
            mx, rel = max(mx, err), max(rel, err / scale if scale > 0 else (0.0 if err == 0 else float("inf")))
    bad = 0
    for a, b in zip(got[3:], ref[3:]):
        err = (a - b).abs()
        bad += int((err > 1e-6 * float(b.abs().max()) + 2e-4 * b.abs()).sum())
        mx = max(mx, float(err.max()))
    log(f"  {name}: max abs {mx:.3g}, largest column error / column max {rel:.3g}, sell values off {bad}")
    if rel > REPLAY_REL or bad or float(got[0].abs().sum()) <= 0 or not all(torch.isfinite(x).all() for x in got):
        raise SystemExit(f"replay {name}: kernel disagrees with its plain version")
    return mx, rel, plain_ms


def replay_work(matres, n_mats: int, sell: bool) -> tuple[float, float]:
    """FP32 operations and bytes of one replay of these residuals: what the
    data needs (materials present per sample-ray, background misses)."""
    spp, bounces, n = matres.shape
    present = sum(int((matres == m + 1).any(1).sum()) for m in range(n_mats))
    misses = int((matres == -1).any(1).sum())
    flops = spp * n * GRAD_FLOPS_PER_SAMPLE + misses * GRAD_FLOPS_PER_MISS + present * GRAD_FLOPS_PER_MATERIAL
    nbytes = 4 * spp * n * (2 + 7 + bounces) + 12 * n
    if sell:
        flops += spp * n * SELL_FLOPS_PER_SAMPLE + present * SELL_FLOPS_PER_MATERIAL
        nbytes += 8 * spp * n
    return flops, nbytes


def garbage(spp: int, bounces: int, n: int, dev) -> tuple:
    """Residual buffers filled with 7s: a kernel must write every element."""
    return (
        torch.full((spp, n), 7.0, device=dev), torch.full((spp, n), 7.0, device=dev),
        torch.full((spp, 7, n), 7.0, device=dev), torch.full((spp, bounces, n), 7, dtype=torch.int32, device=dev),
    )


def compare_residuals(name: str, got, ref) -> tuple[float, float]:
    """(xyz, hero, n_valid, power, matres) against a reference: discrete
    residuals and hero equal, power and xyz within tolerance. Returns the
    largest error of xyz and power, and the mean error of xyz."""
    for k, what in ((1, "hero"), (2, "n_valid"), (4, "matres")):
        if not torch.equal(got[k], ref[k]):
            raise SystemExit(f"{name}: {what} differs")
    p_err = (got[3] - ref[3]).abs()
    x_err = (got[0] - ref[0]).abs()
    bad = int((p_err > POWER_ATOL + POWER_RTOL * ref[3].abs()).sum()) + int((x_err > ATOL + RTOL * ref[0].abs()).sum())
    mean = float(x_err.mean())
    if bad or mean > MEAN_TOL or not torch.isfinite(got[0]).all() or float(ref[0].sum()) <= 0:
        raise SystemExit(f"{name}: values off {bad}, xyz mean abs {mean}")
    return max(float(p_err.max()), float(x_err.max())), mean


def field_args(scene, w: int, h: int, spp: int, bounces: int, rand, seed: int, leaf_size=None):
    """The arguments of the large-scene renders of ``scene`` at w x h and
    its leaf pack, near-to-far from the Cornell camera."""
    from spectral_tpu_torch.models.camera import camera_vector
    from spectral_tpu_torch.models.scenes import CORNELL, scene_camera
    from spectral_tpu_torch.ops.cuda.render_kernel import LEAF_SIZE, pack_scene_auto

    dev = scene.normal.device
    cam = camera_vector(scene_camera(CORNELL, w, h, dev))
    tri, mat, tab, leaf = pack_scene_auto(scene, cam, leaf_size or LEAF_SIZE)
    px = (torch.arange(w * h, device=dev) % w).float()
    py = (torch.arange(w * h, device=dev) // w).float()
    return (cam, seed, tri, mat, tab, px, py, spp, bounces, w, rand), leaf


def check_leaves(name: str, args, leaf) -> dict:
    """The leaf megakernel (forward, and residual into garbage) and the
    sorted scheduler (forward and residual) against their plain versions,
    and the two schedulers against each other: xyz, every residual, live
    ray-steps and the leaves, groups and super-groups entered, all
    bit-equal. Returns the largest errors, the plain versions' times in ms
    and the counts."""
    from spectral_tpu_torch.ops.cuda.render_kernel import render_rays, render_rays_reference, render_rays_residuals
    from spectral_tpu_torch.ops.cuda.wavefront_kernel import render_rays_wavefront, render_rays_wavefront_reference

    n, spp, bounces = args[5].numel(), args[7], args[8]
    dev = args[5].device
    wf = (*args[:5], leaf, *args[5:])
    names = ("steps", "visits", "group_visits", "super_visits")
    c = [dict(zip(names, (torch.zeros(n, dtype=torch.int32, device=dev) for _ in names))) for _ in range(2)]
    wc = [dict(zip(names, (torch.zeros((spp, n), dtype=torch.int32, device=dev) for _ in names))) for _ in range(2)]
    fwd = render_rays(*args, c[0]["steps"], leaf_pack=leaf, **{k: v for k, v in c[0].items() if k != "steps"})
    res = render_rays_residuals(*args, out=garbage(spp, bounces, n, dev), leaf_pack=leaf)
    wres = render_rays_wavefront(*wf, save_residuals=True, out=garbage(spp, bounces, n, dev), **wc[0])
    wfwd = render_rays_wavefront(*wf)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = render_rays_reference(*args, c[1]["steps"], residuals=True, leaf_pack=leaf,
                                **{k: v for k, v in c[1].items() if k != "steps"})
    torch.cuda.synchronize()
    mega_plain_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    wref = render_rays_wavefront_reference(*wf, save_residuals=True, **wc[1])
    torch.cuda.synchronize()
    sorted_plain_ms = 1e3 * (time.perf_counter() - t0)
    for k in names:
        if not (torch.equal(c[0][k], c[1][k]) and torch.equal(wc[0][k], wc[1][k])):
            raise SystemExit(f"{name}: {k} differ from the plain versions")
        if not torch.equal(wc[0][k].sum(0), c[0][k]):
            raise SystemExit(f"{name}: the schedulers' {k} differ")
    if not torch.equal(res[0], fwd) or not torch.equal(wres[0], wfwd):
        raise SystemExit(f"{name}: a residual form's xyz differs from its forward's")
    mega_err, mega_mean = compare_residuals(f"{name} leaf megakernel", res, ref)
    sorted_err, sorted_mean = compare_residuals(f"{name} sorted", wres, wref)
    between, _ = compare_residuals(f"{name} sorted vs leaf megakernel", wres, res)
    for what, x, y in (("leaf megakernel vs plain", res, ref), ("sorted vs plain", wres, wref),
                       ("sorted vs leaf megakernel", wres, res)):
        if not all(torch.equal(a, b) for a, b in zip(x, y)):
            raise SystemExit(f"{name}: {what} not bit-equal")
    counts = {k: int(v.to(torch.int64).sum()) for k, v in c[0].items()}
    log(
        f"  {name}: leaf megakernel, sorted scheduler and their plain versions bit-equal in xyz, residuals and "
        f"counts; {counts['steps']} live ray-steps, {counts['visits']} leaves, {counts['group_visits']} groups, "
        f"{counts['super_visits']} super-groups entered; plain {mega_plain_ms:.0f} / {sorted_plain_ms:.0f} ms"
    )
    return dict(mega_err=mega_err, mega_mean=mega_mean, sorted_err=sorted_err, sorted_mean=sorted_mean,
                between=between, counts=counts, mega_plain_ms=mega_plain_ms, sorted_plain_ms=sorted_plain_ms)


def timed_sorted(args, leaf, plain: bool, reps: int = 1):
    """One sorted-scheduler render through the kernels (or their plain
    versions), the glue of ops/cuda/wavefront_kernel.py repeated here so
    that each launch is timed with CUDA events; the best of ``reps``
    renders after a warm-up. Returns (ms of the camera launch, ms of the
    bounce launches together, ms of the integrate launch, ms of the sort
    and gather glue, live ray-steps of bounces >= 1, boxes entered by the
    camera launch and by the bounce launches (dicts: leaves, groups,
    super-groups), xyz per sample-ray). A checkout from before the group
    tables counts leaves only."""
    import inspect

    from spectral_tpu_torch.ops.cuda import render_kernel as rk
    from spectral_tpu_torch.ops.cuda import wavefront_kernel as wk

    cam, seed, tri, mat, tab, px, py, spp, bounces, w, rand = args
    camera, bounce, integrate = wk._PLAIN if plain else wk._CUDA
    grouped = "sweep" in inspect.signature(camera).parameters
    n = px.numel()
    nrays = spp * n
    dev = px.device
    sweep = {"sweep": rk.leaf_tables(tri, leaf)} if grouped else {}
    levels = ("visits", "group_visits", "super_visits") if grouped else ("visits",)
    best = None
    for rep in range(reps + 1):
        steps = torch.zeros((spp, n), dtype=torch.int32, device=dev)
        boxes = {k: torch.zeros_like(steps) for k in levels}
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4 * bounces + 2)]
        state = torch.empty((wk.STATE_ROWS, nrays), device=dev)
        ev[0].record()
        camera(cam, seed, tri, mat, tab, leaf, px, py, spp, bounces, w, rand, state, None, steps, **boxes, **sweep)
        ev[1].record()
        b_cam = {k: int(v.to(torch.int64).sum()) for k, v in boxes.items()}
        orig = torch.arange(nrays, dtype=torch.int32, device=dev)
        lo, inv_ext = wk._key_box(leaf)
        k = 2
        for b in range(1, bounces):
            ev[k].record()
            perm = torch.argsort(wk._sort_keys(state, lo, inv_ext), stable=True)
            state = state.index_select(1, perm)
            orig = orig.index_select(0, perm)
            ev[k + 1].record()
            bounce(seed, tri, mat, tab, leaf, px, py, spp, bounces, b, w, rand, state, orig, None, steps, **boxes,
                   **sweep)
            ev[k + 2].record()
            k += 3
        xyz = torch.empty((nrays, 3), device=dev)
        ev[k].record()
        integrate(tab, state, orig, n, spp, xyz)
        ev[k + 1].record()
        torch.cuda.synchronize()
        t_cam = ev[0].elapsed_time(ev[1])
        t_glue = sum(ev[2 + 3 * i].elapsed_time(ev[3 + 3 * i]) for i in range(bounces - 1))
        t_bounce = sum(ev[3 + 3 * i].elapsed_time(ev[4 + 3 * i]) for i in range(bounces - 1))
        t_int = ev[k].elapsed_time(ev[k + 1])
        b_all = {k: int(v.to(torch.int64).sum()) - b_cam[k] for k, v in boxes.items()}
        out = (t_cam, t_bounce, t_int, t_glue, int(steps.sum()) - nrays, b_cam, b_all, xyz)
        if rep > 0 and (best is None or sum(out[:3]) < sum(best[:3])):
            best = out
    return best


def sweep_work(live: int, boxes: dict, leaf, k_size: int) -> tuple[float, float, dict]:
    """FP32 operations of the leaf sweeps of ``live`` ray-steps that entered
    ``boxes`` (visits, group_visits, super_visits) of the leaf pack
    ``leaf`` (``k_size`` triangles a leaf): a slab test for every valid super-group, each group of a
    super-group entered and each leaf of a group entered (the fan-out: at
    most, as the ragged last box has fewer), and 51 a triangle of each leaf
    entered. Returns (flops, flops of the flat sweep over the same pack,
    which tests every valid leaf, and the slab tests per live ray-step by
    level)."""
    from spectral_tpu_torch.ops.intersect import GROUP_SIZE, SUPER_SIZE, leaf_groups

    n_valid = int((leaf[:, 6] != 0).sum())
    n_supers = int((leaf_groups(leaf)[1][:, 6] != 0).sum())
    tests = {"super-groups": live * n_supers, "groups": SUPER_SIZE * boxes["super_visits"],
             "leaves": GROUP_SIZE * boxes["group_visits"]}
    tri_flops = boxes["visits"] * k_size * SWEEP_FLOPS_PER_TRI
    flops = SLAB_FLOPS_PER_LEAF * sum(tests.values()) + tri_flops
    flat = SLAB_FLOPS_PER_LEAF * live * n_valid + tri_flops
    return flops, flat, {k: v / max(live, 1) for k, v in tests.items()}


def leaf_work(args, leaf) -> tuple[float, float, int]:
    """(scene bytes, ray bytes read and written by a forward, leaf size) of
    a large-scene render: the scene as the kernels read it, the leaf tables
    (ops/cuda/render_kernel.py::leaf_tables; a checkout from before them
    reads the leaf pack), the materials, curves and camera."""
    from spectral_tpu_torch.ops.cuda import render_kernel as rk

    cam, _, tri, mat, tab, px, *_ = args
    tables = rk.leaf_tables(tri, leaf)[1:] if hasattr(rk, "leaf_tables") else (tri, leaf)
    scene_bytes = sum(x.numel() * x.element_size() for x in (*tables, mat, tab, cam))
    return scene_bytes, 4 * 5 * px.numel(), tri.shape[0] // leaf.shape[0]


def sorted_report(name: str, args, leaf, plain: bool) -> dict:
    """The sorted kernels on one frame, timed per launch (timed_sorted, the
    best of 3) and, with ``plain``, held bit-equal to their plain versions
    in xyz and every count; the bounds of the camera and bounce launches
    under the group hierarchy and, for comparison, under the flat sweep
    over the same pack; slab tests per live ray-step by level."""
    scene_bytes, _, k_size = leaf_work(args, leaf)
    n_rays, spp, bounces = args[5].numel(), args[7], args[8]
    samples = n_rays * spp
    t = timed_sorted(args, leaf, False, reps=3)
    r = dict(cam_ms=t[0], bounce_ms=t[1], int_ms=t[2], glue_ms=t[3], live=t[4], b_cam=t[5], b_bounce=t[6])
    if plain:
        p = timed_sorted(args, leaf, True)
        if p[4:7] != t[4:7] or not torch.equal(p[7], t[7]):
            raise SystemExit(f"sorted scheduler, {name}: the kernels differ from their plain versions")
        r.update(p_cam=p[0], p_bounce=p[1], p_int=p[2])
    cam_sw, cam_flat, r["cam_tests"] = sweep_work(samples, t[5], leaf, k_size)
    b_sw, b_flat, r["b_tests"] = sweep_work(t[4], t[6], leaf, k_size)
    cam_bytes = scene_bytes + 8 * n_rays + STATE_BYTES * samples
    b_bytes = (bounces - 1) * (scene_bytes + 8 * samples) + 2 * STATE_BYTES * t[4]
    cam_base = samples * (SAMPLE_FLOPS + SHADE_FLOPS_PER_STEP)
    b_base = t[4] * (SHADE_FLOPS_PER_STEP + CURVE_FLOPS)
    r["cam_bound"], r["cam_by"] = bound_ms(cam_base + cam_sw, cam_bytes)
    r["cam_flat_bound"], _ = bound_ms(cam_base + cam_flat, cam_bytes)
    r["b_bound"], r["b_by"] = bound_ms(b_base + b_sw, b_bytes)
    r["b_flat_bound"], _ = bound_ms(b_base + b_flat, b_bytes)
    r["int_bound"], r["int_by"] = bound_ms(samples * XYZ_FLOPS, 4 * N_TABLES_FLOATS + samples * (40 + 4 + 12))
    plain_ms = f" (plain {r['p_cam']} / {r['p_bounce']} / {r['p_int']})" if plain else ""
    log(f"  sorted, {name}: camera {r['cam_ms']} ms, {bounces - 1} bounces {r['bounce_ms']} ms, integrate "
        f"{r['int_ms']} ms{plain_ms}, sort and gather {r['glue_ms']} ms; bounds {r['cam_bound']} ({r['cam_by']}; flat "
        f"sweep {r['cam_flat_bound']}), {r['b_bound']} ({r['b_by']}; flat sweep {r['b_flat_bound']}), "
        f"{r['int_bound']} ({r['int_by']}) ms; {r['live']} live ray-steps of bounces >= 1; boxes entered: camera "
        f"{r['b_cam']}, bounces {r['b_bounce']}; slab tests a live ray-step: camera {r['cam_tests']}, bounces "
        f"{r['b_tests']}")
    return r


def leaf_size_sweep(dev) -> int:
    """Both schedulers on the 10k and 200k fields at leaf sizes 8-128, at
    the field frame (hash draws); prints one JSON line."""
    from spectral_tpu_torch.models.scenes import build_tri_field
    from spectral_tpu_torch.ops.cuda.render_kernel import render_rays
    from spectral_tpu_torch.ops.cuda.wavefront_kernel import render_rays_wavefront

    rows = []
    for n_tris in (FIELD_TRIS, BIG_FIELD_TRIS):
        scene = build_tri_field(n_tris, 0, device=dev)
        for k in (8, 16, 32, 64, 128):
            args, leaf = field_args(scene, FIELD_W, FIELD_H, FIELD_SPP, FIELD_BOUNCES, None, FIELD_SEED, k)
            wf = (*args[:5], leaf, *args[5:])
            sorted_ms = cuda_ms(lambda: render_rays_wavefront(*wf), 2)
            mega_ms = cuda_ms(lambda: render_rays(*args, leaf_pack=leaf), 1) if n_tris == FIELD_TRIS else None
            rows.append({"tris": n_tris, "leaf_size": k, "leaves": leaf.shape[0], "sorted_ms": sorted_ms, "mega_ms": mega_ms})
            log(f"  {n_tris} tris, leaf size {k} ({leaf.shape[0]} leaves): sorted {sorted_ms} ms, leaf megakernel {mega_ms} ms")
    print(json.dumps({"leaf_sizes": rows, "frame": f"{FIELD_W}x{FIELD_H}, {FIELD_SPP} spp, {FIELD_BOUNCES} bounces"}), flush=True)
    return 0


def time_kernels(root: str) -> int:
    """``--time ROOT``: build the port found at ROOT and time its render
    kernels at their paths' shapes, warmed, with CUDA events; print one JSON
    line with each kernel's ms, a digest of its outputs, the lane
    efficiency (where the port reports warp sweeps) and ptxas's lines for
    the render kernels."""
    import hashlib
    import inspect

    sys.path.insert(0, os.path.abspath(root))
    import spectral_tpu_torch
    from spectral_tpu_torch.models.camera import camera_vector
    from spectral_tpu_torch.models.scenes import CORNELL, build_scene, build_tri_field, scene_camera
    from spectral_tpu_torch.ops.cuda import build
    from spectral_tpu_torch.ops.cuda import render_kernel as rk
    from spectral_tpu_torch.ops.cuda.wavefront_kernel import render_rays_wavefront
    from spectral_tpu_torch.runtime.render_manager import chunk_seed

    if not spectral_tpu_torch.__file__.startswith(os.path.abspath(root)):
        raise SystemExit(f"--time {root}: imported {spectral_tpu_torch.__file__} instead")
    dev = torch.device("cuda")
    build.build_all(build.KERNELS.values())
    ptxas = [ln.split(":", 1)[-1].strip() for k in (build.RENDER, build.WAVEFRONT_CAMERA)
             for ln in k.build_log.splitlines() if "registers" in ln or "spill" in ln]
    tri, mat, tab = rk.pack_scene(build_scene(CORNELL, dev))

    def frame(w, h, spp, bounces, seed):
        cam = camera_vector(scene_camera(CORNELL, w, h, dev))
        px = (torch.arange(w * h, device=dev) % w).float()
        py = (torch.arange(w * h, device=dev) // w).float()
        return (cam, seed, tri, mat, tab, px, py, spp, bounces, w, None)

    a2 = frame(600, 600, 500, 10, chunk_seed(0, 0, 600))
    a3 = frame(TRAIN_W, TRAIN_H, TRAIN_SPP, TRAIN_BOUNCES, TRAIN_SEED)
    fa, leaf = field_args(build_tri_field(FIELD_TRIS, 0, device=dev), FIELD_W, FIELD_H, FIELD_SPP, FIELD_BOUNCES,
                          None, chunk_seed(0, 0, FIELD_W))
    runs = {
        "render": (a2, {}, rk.render_rays, 2),
        "render_residuals": (a3, {}, rk.render_rays_residuals, 5),
        "render_leaves": (fa, {"leaf_pack": leaf}, rk.render_rays, 5),
        "render_leaves_residuals": (fa, {"leaf_pack": leaf}, rk.render_rays_residuals, 5),
    }
    ms, digest, lanes = {}, {}, {}
    warps = "warp_steps" in inspect.signature(rk.render_rays).parameters

    def sha(tensors) -> str:
        h = hashlib.sha256()
        for x in tensors:
            h.update(x.contiguous().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    for name, (args, kw, fn, reps) in runs.items():
        steps = torch.zeros(args[5].numel(), dtype=torch.int32, device=dev)
        extra = {"warp_steps": warp_buffer(args[5].numel(), dev)} if warps and not kw else {}
        out = fn(*args, steps, **kw, **extra)
        out = out if isinstance(out, tuple) else (out,)
        digest[name] = sha((*out, steps))
        if extra:
            live = int(steps.to(torch.int64).sum())
            lanes[name] = live / (32 * int(extra["warp_steps"].to(torch.int64).sum()))
        ms[name] = cuda_ms(lambda: fn(*args, **kw), reps)
    boxes = {}
    big = field_args(build_tri_field(BIG_FIELD_TRIS, 0, device=dev), FIELD_W, FIELD_H, FIELD_SPP, FIELD_BOUNCES,
                     None, chunk_seed(0, 0, FIELD_W))
    for tag, (args, lf) in (("", (fa, leaf)), ("_200k", big)):
        wf = (*args[:5], lf, *args[5:])
        digest["sorted" + tag] = sha(render_rays_wavefront(*wf, save_residuals=True))
        cam_ms, bounce_ms, int_ms, glue_ms, live, b_cam, b_bounce, _ = timed_sorted(args, lf, False, reps=3)
        ms.update({"wavefront_camera" + tag: cam_ms, "wavefront_bounce" + tag: bounce_ms,
                   "wavefront_integrate" + tag: int_ms, "sort_and_gather" + tag: glue_ms})
        boxes["sorted" + tag] = {"bounce_live_steps": live, "camera": b_cam, "bounces": b_bounce}
    print(json.dumps({"root": os.path.abspath(root), "ms": ms, "digest": digest, "lane_efficiency": lanes,
                      "boxes": boxes, "ptxas": ptxas}), flush=True)
    return 0


def ab_runs(roots: list[str]) -> int:
    """``--ab BASE [OTHER ...]``: ``--time`` of each checkout, one process
    each, in the order BASE, this, OTHER..., this, BASE; one JSON line with
    every run and whether its outputs are bit-equal to this checkout's."""
    here = os.path.dirname(os.path.abspath(__file__))
    roots = [os.path.abspath(r) for r in roots]
    order = [roots[0], here, *roots[1:], here, roots[0]]
    smi = smi_line()
    log(smi)
    runs = []
    for root in order:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--time", root], cwd=root,
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"--time {root} failed")
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        log(json.dumps({k: runs[-1].get(k) for k in ("root", "ms", "lane_efficiency", "boxes")}))
    ref = runs[1]["digest"]
    for r in runs:
        r["bit_equal"] = {k: r["digest"].get(k) == v for k, v in ref.items()}
    print(json.dumps({"ab": runs, "device": smi}), flush=True)
    if not all(all(r["bit_equal"].values()) for r in runs):
        raise SystemExit("--ab: a checkout's outputs differ from this one's")
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: PyTorch sees no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--time"] and len(sys.argv) == 3:
        return time_kernels(sys.argv[2])
    if sys.argv[1:2] == ["--ab"] and len(sys.argv) >= 3:
        return ab_runs(sys.argv[2:])
    try:
        from spectral_tpu_torch import main as cli
        from spectral_tpu_torch.diff import render_rays_diff_fused
        from spectral_tpu_torch.io.image import decode_bmp
        from spectral_tpu_torch.models.camera import camera_vector
        from spectral_tpu_torch.config import RenderParams
        from spectral_tpu_torch.diff import render_chunk_diff_fused
        from spectral_tpu_torch.models.scenes import CORNELL, PRISM, TRIS, build_scene, build_tri_field, scene_camera
        from spectral_tpu_torch.ops.cuda import build
        from spectral_tpu_torch.ops.cuda.grad_kernel import render_grads
        from spectral_tpu_torch.ops.cuda.intersect_kernel import intersect, pack_tris
        from spectral_tpu_torch.ops.cuda.render_kernel import (
            n_uniforms, order_leaves_near_to_far, pack_scene, pack_scene_leaves, render_chunk, render_rays,
            render_rays_reference, render_rays_residuals,
        )
        from spectral_tpu_torch.ops.intersect import nearest_hit
        from spectral_tpu_torch.parallel import train_step_fused, trainable_params
        from spectral_tpu_torch.runtime.render_manager import RenderManager, chunk_seed
        from spectral_tpu_torch.utils.logging import get_log_context
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 1

    dev = torch.device("cuda")
    torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    smi = smi_line()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    log(f"import of torch and the port, and the CUDA context: {time.perf_counter() - T_START} s")
    if sys.argv[1:] == ["--leaf-sizes"]:
        build.build_all(build.KERNELS.values())
        return leaf_size_sweep(dev)

    # ---- 2. build, and the first launch ----------------------------------
    t0 = time.perf_counter()
    build.build_all(build.KERNELS.values())
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for k in build.KERNELS.values():
        if k.name == "render_residuals":
            continue  # render_kernel.cu's log, printed for "render"
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  {k.source.name}: {line.strip()}")
    # the dense sweep reads each triangle as four 128-bit shared loads, the
    # leaf sweep as four 128-bit global loads
    loads = sass_loads(build.RENDER.library(), "LDS", "render_kernel")
    log(f"  render_kernel<kSaveResiduals,kLeaves> shared loads by width (cuobjdump -sass): {loads}")
    if not all(any("128" in k for k in loads.get(form, {})) for form in ("<0,0>", "<1,0>")):
        raise SystemExit("the dense render kernels have no 128-bit shared loads")
    for name in ("render_kernel", "camera_bounce_kernel", "bounce_kernel"):
        lib = (build.RENDER if name == "render_kernel" else build.WAVEFRONT_CAMERA).library()
        g_loads = sass_loads(lib, "LDG", name)
        log(f"  {name} global loads by width (cuobjdump -sass): {g_loads}")
        forms = [f for f in g_loads if name != "render_kernel" or f.endswith(",1>")]
        if len(forms) != 2 or not all(any("128" in k for k in g_loads[f]) for f in forms):
            raise SystemExit(f"the leaf sweep of {name} has no 128-bit global loads")
    cornell = build_scene(CORNELL, dev)
    tri, mat, tab = pack_scene(cornell)
    cam1 = camera_vector(scene_camera(CORNELL, 1, 1, dev))
    one = torch.zeros(1, device=dev)
    t0 = time.perf_counter()
    build.RENDER.function()
    load_ms = 1e3 * (time.perf_counter() - t0)
    first = []
    for _ in range(2):
        t0 = time.perf_counter()
        render_rays(cam1, 1, tri, mat, tab, one, one, 1, 1, 1)
        torch.cuda.synchronize()
        first.append(1e3 * (time.perf_counter() - t0))
    log(f"render kernel library load {load_ms} ms; 1-pixel launch: first {first[0]} ms, second {first[1]} ms")

    # ---- 3. the render kernel against its plain version, 64x64 ------------
    rng = np.random.default_rng(1984)
    w = h = 64
    c_spp, c_bounces = 8, 5
    px = (torch.arange(w * h, device=dev) % w).float()
    py = (torch.arange(w * h, device=dev) // w).float()
    render_err, render_mean = 0.0, 0.0
    res_err, res_mean, grad_err, grad_rel = 0.0, 0.0, 0.0, 0.0
    log(f"render megakernel, its residual form and the replay vs plain, {w}x{h}, {c_spp} spp, {c_bounces} bounces:")
    for sid, sname in ((CORNELL, "cornell"), (PRISM, "prism"), (TRIS, "tris")):
        s_tri, s_mat, s_tab = pack_scene(build_scene(sid, dev))
        cam = camera_vector(scene_camera(sid, w, h, dev))
        planes = rng.uniform(size=(c_spp, n_uniforms(c_bounces), w * h)).astype(np.float32)
        for mode, rand in (("planes", torch.from_numpy(planes).to(dev)), ("hash", None)):
            seed = chunk_seed(0, 0, w) + sid
            args = (cam, seed, s_tri, s_mat, s_tab, px, py, c_spp, c_bounces, w, rand)
            mx, mean, *_ = check_render(f"{sname}/{mode}", args)
            render_err, render_mean = max(render_err, mx), max(render_mean, mean)
            res, mx, mean, *_ = check_residuals(f"{sname}/{mode} residuals", args)
            res_err, res_mean = max(res_err, mx), max(res_mean, mean)
            g = torch.from_numpy(rng.normal(size=(w * h, 3)).astype(np.float32)).to(dev)
            mx, rel, _ = check_replay(f"{sname}/{mode} replay", s_mat, s_tab, g, res, c_spp, c_bounces, sid == PRISM)
            grad_err, grad_rel = max(grad_err, mx), max(grad_rel, rel)

    # ---- 4. the kernels at the main path's shapes --------------------------
    width = height = 600
    spp, bounces = 500, 10
    n_rays = width * height
    nominal = n_rays * spp * bounces
    cam = camera_vector(scene_camera(CORNELL, width, height, dev))
    fpx = (torch.arange(n_rays, device=dev) % width).float()
    fpy = (torch.arange(n_rays, device=dev) // width).float()
    seed = chunk_seed(0, 0, width)
    args = (cam, seed, tri, mat, tab, fpx, fpy, spp, bounces, width, None)
    log(f"render megakernel vs plain, Cornell {width}x{height}, {spp} spp, {bounces} bounces, hash draws:")
    mx, mean, live, render_plain_ms, render_eff = check_render("cornell/full", args)
    render_ms = cuda_ms(lambda: render_rays(*args), 3)
    render_err, render_mean = max(render_err, mx), max(render_mean, mean)
    n_tris = tri.shape[0]
    r_flops = live * (SWEEP_FLOPS_PER_TRI * n_tris + SHADE_FLOPS_PER_STEP) + n_rays * spp * SAMPLE_FLOPS
    r_bytes = 4 * (tri.numel() + mat.numel() + tab.numel() + 20 + 2 * n_rays + 3 * n_rays)
    r_bound, r_by = bound_ms(r_flops, r_bytes)
    log(
        f"  kernel {render_ms} ms (plain {render_plain_ms} ms), {live} live ray-steps of {nominal} nominal, "
        f"bound {r_bound} ms ({r_by}); live ray-steps / (32 x warp sweeps) = {render_eff}"
    )

    tri16 = pack_tris(cornell)
    o = torch.from_numpy(rng.uniform([20, 20, -400], [535, 535, 535], (n_rays, 3)).astype(np.float32)).to(dev)
    d = torch.from_numpy(rng.normal(size=(n_rays, 3)).astype(np.float32)).to(dev)
    log("intersect kernel vs plain, CORNELL, %d random rays:" % n_rays)
    got = intersect(o, d, tri16)
    ref = nearest_hit(o, d, tri16)
    torch.cuda.synchronize()
    for a, b, what in zip(got[1:], ref[1:], ("idx", "hit", "front")):
        if not torch.equal(a, b):
            raise SystemExit(f"intersect: {what} differs from the plain version")
    hit = ref[2]
    t_err = (got[0] - ref[0]).abs()[hit]
    if not bool((t_err <= 1e-6 * ref[0].abs()[hit]).all()):
        raise SystemExit("intersect: t differs from the plain version beyond rtol 1e-6")
    isect_err, isect_mean = float(t_err.max()), float(t_err.mean())
    i_ms = cuda_ms(lambda: intersect(o, d, tri16), 20)
    i_plain_ms = cuda_ms(lambda: nearest_hit(o, d, tri16), 3)
    i_flops = n_rays * tri16.shape[0] * SWEEP_FLOPS_PER_TRI
    i_bytes = 4 * tri16.numel() + n_rays * (24 + 4 + 4 + 1 + 1)
    i_bound, i_by = bound_ms(i_flops, i_bytes)
    log(
        f"  idx/hit/front equal; t max abs {isect_err:.3g}, mean abs {isect_mean:.3g} over {int(hit.sum())} hits; "
        f"{n_rays} rays x {tri16.shape[0]} tris: {i_ms} ms (plain {i_plain_ms} ms), bound {i_bound} ms ({i_by})"
    )

    # the residual and replay kernels at the training shape
    tw, th, t_spp, t_b = TRAIN_W, TRAIN_H, TRAIN_SPP, TRAIN_BOUNCES
    t_rays = tw * th
    t_cam = scene_camera(CORNELL, tw, th, dev)
    t_camv = camera_vector(t_cam)
    tpx = (torch.arange(t_rays, device=dev) % tw).float()
    tpy = (torch.arange(t_rays, device=dev) // tw).float()
    t_args = (t_camv, TRAIN_SEED, tri, mat, tab, tpx, tpy, t_spp, t_b, tw, None)
    log(f"residual kernel vs plain, Cornell {tw}x{th}, {t_spp} spp, {t_b} bounces, hash draws:")
    t_res, mx, mean, res_plain_ms, t_live, res_eff = check_residuals("cornell/train", t_args)
    res_err, res_mean = max(res_err, mx), max(res_mean, mean)
    res_bytes = sum(x.numel() * x.element_size() for x in t_res)
    res_ms = cuda_ms(lambda: render_rays_residuals(*t_args), 3)
    rr_flops = t_live * (SWEEP_FLOPS_PER_TRI * n_tris + SHADE_FLOPS_PER_STEP) + t_rays * t_spp * SAMPLE_FLOPS
    rr_bytes = res_bytes + 4 * (tri.numel() + mat.numel() + tab.numel() + 20 + 2 * t_rays + 3 * t_rays)
    rr_bound, rr_by = bound_ms(rr_flops, rr_bytes)
    log(
        f"  kernel {res_ms} ms (plain {res_plain_ms} ms), {t_live} live ray-steps of {t_rays * t_spp * t_b} nominal, "
        f"residuals {res_bytes} bytes, bound {rr_bound} ms ({rr_by}); live ray-steps / (32 x warp sweeps) = {res_eff}"
    )
    log(f"replay kernel vs plain, on those residuals:")
    g = torch.from_numpy(rng.normal(size=(t_rays, 3)).astype(np.float32)).to(dev)
    mx, rel, grad_plain_ms = check_replay("cornell/train", mat, tab, g, t_res, t_spp, t_b, False)
    grad_err, grad_rel = max(grad_err, mx), max(grad_rel, rel)
    grad_ms = cuda_ms(lambda: render_grads(mat, tab, g, *t_res, t_spp, t_b, want_bg_grads=True), 10)
    gr_flops, gr_bytes = replay_work(t_res[3], mat.shape[0], False)
    gr_bound, gr_by = bound_ms(gr_flops, gr_bytes)
    log(f"  kernel {grad_ms} ms (plain {grad_plain_ms} ms), {gr_flops} flops, {gr_bytes} bytes, bound {gr_bound} ms ({gr_by})")
    del t_res, g
    torch.cuda.empty_cache()

    # ---- 5. the main path, as a user runs it ------------------------------
    for k in build.KERNELS.values():
        k.launches = 0
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            rc = cli.main(["--save", "--no-show", "--do-log", "-t", "smoke"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            bmps = sorted(os.listdir("renders"))
            with open(os.path.join("renders", bmps[0]), "rb") as f:
                img = decode_bmp(f.read())
        finally:
            os.chdir(cwd)
    launches = {k.name: k.launches for k in build.KERNELS.values()}
    entries = dict(get_log_context().items())
    chunks = int(entries["chunks"])
    render_s = float(entries["total rendering time (seconds)"])
    log(
        f"main path: rc {rc}, {width}x{height}, {spp} spp, {bounces} bounces, {chunks} chunk(s), "
        f"{seconds} s end to end, render {render_s} s, "
        f"{nominal / render_s / 1e6} nominal Mrays/s (render), "
        f"{nominal / seconds / 1e6} (end to end); launches {launches}"
    )
    if rc != 0 or launches["render"] != chunks or chunks < 1:
        raise SystemExit("main path did not go through the render kernel once per chunk")
    lum = img.astype(np.float64).mean(-1)
    light = lum[83:95, 270:330]  # inside the ceiling light, top centre
    log(f"  image {img.shape}, mean {lum.mean():.1f}, ceiling-light region mean {light.mean():.1f}")
    if img.shape != (height, width, 3) or lum.mean() < 5 or light.mean() < 200:
        raise SystemExit("main path image is black or unlit")

    # ---- 6. the training path: three fused SGD steps ----------------------
    with torch.no_grad():
        target = render_rays(*t_args).reshape(th, tw, 3) / t_spp
    params = {k: v.clone() for k, v in trainable_params(cornell).items() if k in ("coeffs", "emission_power")}
    params["coeffs"][3, 2] += 1.5  # the white wall, as examples/inverse_rendering.py:51
    for k in build.KERNELS.values():
        k.launches = 0
    losses, step_ms = [], []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        params, loss = train_step_fused(params, cornell, t_cam, target, TRAIN_SEED, t_spp, t_b, lr=TRAIN_LR)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(loss))
    train_launches = {k.name: k.launches for k in build.KERNELS.values()}
    log(
        f"training path: Cornell {tw}x{th}, {t_spp} spp, {t_b} bounces, lr {TRAIN_LR}: ms per step {step_ms}, "
        f"loss {losses}, residuals {res_bytes} bytes a step, launches {train_launches}"
    )
    if train_launches["render_residuals"] != 3 or train_launches["grad"] != 3:
        raise SystemExit("training path did not launch each fused kernel once per step")
    if not (losses[0] > losses[1] > losses[2]) or not all(torch.isfinite(v).all() for v in params.values()):
        raise SystemExit("training path: the loss did not fall")
    del target
    torch.cuda.empty_cache()

    # ---- 7. the dispersion path: Sellmeier gradients through the replay ---
    prism = build_scene(PRISM, dev)
    d_size, d_spp, d_bounces, glass = 64, 64, 6, 2
    crop_w, crop_h = d_size, d_size // 2
    d_cam = scene_camera(PRISM, d_size, d_size, dev)
    dpx = (torch.arange(crop_w * crop_h, device=dev) % crop_w).float()
    dpy = (torch.arange(crop_w * crop_h, device=dev) // crop_w).float()
    sb = prism.materials.sellmeier_b.clone().requires_grad_(True)
    d_mats = dataclasses.replace(prism.materials, sellmeier_b=sb)
    for k in build.KERNELS.values():
        k.launches = 0
    out = render_rays_diff_fused(d_mats, prism, d_cam, dpx, dpy, 77, d_spp, d_bounces, reparam_glass=glass) / d_spp
    out[:, 1].sum().backward()
    torch.cuda.synchronize()
    disp_launches = {k.name: k.launches for k in build.KERNELS.values()}
    d_b = sb.grad[glass]
    log(f"dispersion path: PRISM {crop_w}x{crop_h} of {d_size}x{d_size}, {d_spp} spp, {d_bounces} bounces: "
        f"d(sum Y)/d B[glass] = {d_b.tolist()}, launches {disp_launches}")
    if disp_launches["render_residuals"] != 1 or disp_launches["grad"] != 1:
        raise SystemExit("dispersion path did not go through the fused kernels")
    if not torch.isfinite(d_b).all() or float(d_b.abs().max()) <= 0 or not torch.isfinite(out).all():
        raise SystemExit("dispersion path: the Sellmeier gradient is not finite and nonzero")

    # ---- 8. the large-scene kernels against their plain versions ----------
    lw, lh, l_spp, l_bounces = 128, 64, 4, 5
    leaf_errs = []
    log(f"leaf megakernel and sorted scheduler vs plain, {lw}x{lh}, {l_spp} spp, {l_bounces} bounces:")
    field = build_tri_field(FIELD_TRIS, 0, device=dev)
    t0 = time.perf_counter()
    big = build_tri_field(BIG_FIELD_TRIS, 0, device=dev)
    big_build_s = time.perf_counter() - t0
    for sname, scene in (("field520", build_tri_field(520, 3, device=dev)), ("field10k", field), ("field200k", big)):
        planes = rng.uniform(size=(l_spp, n_uniforms(l_bounces), lw * lh)).astype(np.float32)
        for mode, rand in (("planes", torch.from_numpy(planes).to(dev)), ("hash", None)):
            if sname == "field200k" and mode == "planes":
                continue
            args, leaf = field_args(scene, lw, lh, l_spp, l_bounces, rand, chunk_seed(0, 0, lw) + 7)
            leaf_errs.append(check_leaves(f"{sname}/{mode}", args, leaf))
    c_tri, c_mat, c_tab, c_leaf = pack_scene_leaves(cornell, leaf_size=8)
    c_cam = camera_vector(scene_camera(CORNELL, lw, lh, dev))
    c_tri, c_leaf = order_leaves_near_to_far(c_tri, c_leaf, c_cam[0:3])
    c_px = (torch.arange(lw * lh, device=dev) % lw).float()
    c_py = (torch.arange(lw * lh, device=dev) // lw).float()
    c_args = (c_cam, 99, c_tri, c_mat, c_tab, c_px, c_py, l_spp, l_bounces, lw, None)
    dense = render_rays_residuals(c_cam, 99, tri, mat, tab, c_px, c_py, l_spp, l_bounces, lw, None)
    on_cornell, _ = compare_residuals("leaf megakernel on CORNELL vs dense", render_rays_residuals(*c_args, leaf_pack=c_leaf), dense)
    log(f"  cornell/hash, {c_leaf.shape[0]} leaves of 8: leaf megakernel vs dense megakernel max abs {on_cornell:.3g}")
    mega_err = max([e["mega_err"] for e in leaf_errs] + [on_cornell])
    mega_mean = max(e["mega_mean"] for e in leaf_errs)
    sorted_err = max(max(e["sorted_err"], e["between"]) for e in leaf_errs)
    sorted_mean = max(e["sorted_mean"] for e in leaf_errs)

    # ---- 9. the large-scene kernels at the field's shapes ------------------
    fw, fh, f_spp, f_b = FIELD_W, FIELD_H, FIELD_SPP, FIELD_BOUNCES
    f_rays, f_samples = fw * fh, fw * fh * FIELD_SPP
    f_args, f_leaf = field_args(field, fw, fh, f_spp, f_b, None, chunk_seed(0, 0, fw))
    scene_bytes, ray_bytes, k_size = leaf_work(f_args, f_leaf)
    log(f"leaf megakernel and sorted scheduler, 10k field ({field.num_tris} tris, {f_leaf.shape[0]} leaves of "
        f"{k_size}), {fw}x{fh}, {f_spp} spp, {f_b} bounces, hash draws:")
    box_names = ("visits", "group_visits", "super_visits")
    f_steps = torch.zeros(f_rays, dtype=torch.int32, device=dev)
    f_boxes = {k: torch.zeros_like(f_steps) for k in box_names}
    f_res = render_rays_residuals(*f_args, f_steps, leaf_pack=f_leaf, **f_boxes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f_ref = render_rays_reference(*f_args, residuals=True, leaf_pack=f_leaf)
    torch.cuda.synchronize()
    lm_plain_ms = 1e3 * (time.perf_counter() - t0)
    e, m = compare_residuals("leaf megakernel at the field shape", f_res, f_ref)
    if not all(torch.equal(a, b) for a, b in zip(f_res, f_ref)):
        raise SystemExit("leaf megakernel at the field shape: not bit-equal to its plain version")
    mega_err, mega_mean = max(mega_err, e), max(mega_mean, m)
    del f_ref
    lm_ms = cuda_ms(lambda: render_rays(*f_args, leaf_pack=f_leaf), 3)
    lmr_ms = cuda_ms(lambda: render_rays_residuals(*f_args, leaf_pack=f_leaf), 3)
    f_live = int(f_steps.to(torch.int64).sum())
    f_box = {k: int(v.to(torch.int64).sum()) for k, v in f_boxes.items()}
    lm_sw, lm_flat, lm_tests = sweep_work(f_live, f_box, f_leaf, k_size)
    lm_base = f_live * SHADE_FLOPS_PER_STEP + f_samples * SAMPLE_FLOPS
    f_res_bytes = sum(x.numel() * x.element_size() for x in f_res[1:])
    lm_bound, lm_by = bound_ms(lm_base + lm_sw, scene_bytes + ray_bytes)
    lm_flat_bound, _ = bound_ms(lm_base + lm_flat, scene_bytes + ray_bytes)
    lmr_bound, lmr_by = bound_ms(lm_base + lm_sw, scene_bytes + ray_bytes + f_res_bytes)
    log(f"  leaf megakernel {lm_ms} ms, residual form {lmr_ms} ms (plain {lm_plain_ms} ms); {f_live} live ray-steps of "
        f"{f_samples * f_b} nominal, boxes entered {f_box}; bounds {lm_bound} ms ({lm_by}; flat sweep "
        f"{lm_flat_bound}), {lmr_bound} ms ({lmr_by}); slab tests a live ray-step {lm_tests}")
    wf = sorted_report("10k field", f_args, f_leaf, plain=True)
    if wf["live"] + f_samples != f_live or any(wf["b_cam"][k] + wf["b_bounce"][k] != f_box[k] for k in box_names):
        raise SystemExit("sorted scheduler: live ray-steps or boxes entered differ from the leaf megakernel's")

    # ---- 10. the field render as a user runs it ---------------------------
    f_cam = scene_camera(CORNELL, fw, fh, dev)
    f_params = RenderParams(xres=fw, aspect_ratio=fw / fh, nsamples=f_spp, bounce_limit=f_b, show=False)
    for k in build.KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    rm = RenderManager(field, f_cam, f_params)
    f_img = rm.render()
    field_s = time.perf_counter() - t0
    field_launches = {k.name: k.launches for k in build.KERNELS.values()}
    mega_xyz = render_chunk(field, f_cam, chunk_seed(0, 0, fw), 0, 0, fw, fh, f_spp, f_b, sched="mega")
    mega_launches = {k.name: k.launches - field_launches[k.name] for k in build.KERNELS.values()}
    same = np.array_equal(mega_xyz.cpu().numpy(), rm._fb_xyz)
    log(f"field render: {fw}x{fh}, {f_spp} spp, {f_b} bounces, 1 chunk, {field_s} s, "
        f"{f_samples * f_b / field_s / 1e6} nominal Mrays/s; launches {field_launches}; the same frame through "
        f"the leaf megakernel: launches {mega_launches}, equal: {same}")
    if (field_launches["wavefront_camera"], field_launches["wavefront_bounce"], field_launches["wavefront_integrate"]) != (1, f_b - 1, 1):
        raise SystemExit("field render did not go through the sorted scheduler's kernels")
    if mega_launches["render_leaves"] != 1 or not same:
        raise SystemExit("the leaf megakernel's frame differs from the sorted scheduler's")
    lum = f_img.astype(np.float64).mean(-1)
    log(f"  image {f_img.shape}, mean {lum.mean():.2f}, max {lum.max():.0f}, lit pixels {(lum > 0).mean():.4f}")
    if f_img.shape != (fh, fw, 3) or lum.mean() < 1 or lum.max() < 255 or not np.isfinite(rm._fb_xyz).all():
        raise SystemExit("field render: the image is black, unlit or not finite")
    del mega_xyz
    for k in build.KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    big_rm = RenderManager(big, f_cam, f_params)
    big_img = big_rm.render()
    big_s = time.perf_counter() - t0
    big_launches = {k.name: k.launches for k in build.KERNELS.values() if k.launches}
    big_lum = big_img.astype(np.float64).mean(-1)
    big_mega = render_chunk(big, f_cam, chunk_seed(0, 0, fw), 0, 0, fw, fh, f_spp, f_b, sched="mega")
    big_same = np.array_equal(big_mega.cpu().numpy(), big_rm._fb_xyz)
    log(f"200k field: {big.num_tris} tris (built in {big_build_s} s), {big_s} s, "
        f"{f_samples * f_b / big_s / 1e6} nominal Mrays/s, image mean {big_lum.mean():.2f}, max {big_lum.max():.0f}, "
        f"launches {big_launches}; the same frame through the leaf megakernel equal: {big_same}")
    if big_launches.get("wavefront_bounce") != f_b - 1 or big_lum.mean() < 1 or big_lum.max() < 255:
        raise SystemExit("200k field render failed")
    if not big_same:
        raise SystemExit("the leaf megakernel's 200k frame differs from the sorted scheduler's")
    big_args, big_leaf = field_args(big, fw, fh, f_spp, f_b, None, chunk_seed(0, 0, fw))
    big_wf = sorted_report(f"200k field ({big_leaf.shape[0]} leaves)", big_args, big_leaf, plain=False)
    del big, big_args, big_leaf, big_rm, big_mega
    torch.cuda.empty_cache()

    # ---- 11. the field training path ---------------------------------------
    with torch.no_grad():
        f_target = render_chunk(field, f_cam, FIELD_SEED, 0, 0, fw, fh, f_spp, f_b) / f_spp
    params = {k: v.clone() for k, v in trainable_params(field).items() if k in ("coeffs", "emission_power")}
    params["coeffs"][0, 2] += 1.5  # the white of walls and boxes
    for k in build.KERNELS.values():
        k.launches = 0
    f_losses, f_step_ms = [], []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        params, loss = train_step_fused(params, field, f_cam, f_target, FIELD_SEED, f_spp, f_b, lr=FIELD_LR)
        end.record()
        torch.cuda.synchronize()
        f_step_ms.append(start.elapsed_time(end))
        f_losses.append(float(loss))
    ftrain_launches = {k.name: k.launches for k in build.KERNELS.values()}
    log(f"field training path: {fw}x{fh}, {f_spp} spp, {f_b} bounces, lr {FIELD_LR}: ms per step {f_step_ms}, "
        f"loss {f_losses}, launches {ftrain_launches}")
    want = {"wavefront_camera": 3, "wavefront_bounce": 3 * (f_b - 1), "wavefront_integrate": 3, "grad": 3}
    if any(ftrain_launches[k] != v for k, v in want.items()):
        raise SystemExit("field training path did not launch the sorted kernels and the replay as expected")
    if not (f_losses[0] > f_losses[1] > f_losses[2]) or not all(torch.isfinite(v).all() for v in params.values()):
        raise SystemExit("field training path: the loss did not fall")
    for k in build.KERNELS.values():
        k.launches = 0
    coeffs = field.materials.coeffs.clone().requires_grad_(True)
    f_mats = dataclasses.replace(field.materials, coeffs=coeffs)
    img = render_chunk_diff_fused(f_mats, field, f_cam, FIELD_SEED, 0, 0, fw, fh, f_spp, f_b, sched="mega")
    img[..., 1].sum().backward()
    torch.cuda.synchronize()
    fmega_launches = {k.name: k.launches for k in build.KERNELS.values() if k.launches}
    log(f"  fused gradient through the leaf megakernel: |d(sum Y) / d coeffs| max {float(coeffs.grad.abs().max())}, "
        f"launches {fmega_launches}")
    if fmega_launches.get("render_leaves_residuals") != 1 or fmega_launches.get("grad") != 1:
        raise SystemExit("the fused gradient did not go through the leaf megakernel's residual form")
    if not torch.isfinite(coeffs.grad).all() or float(coeffs.grad.abs().max()) <= 0:
        raise SystemExit("the fused gradient through the leaf megakernel is not finite and nonzero")
    del f_target, field, img
    torch.cuda.empty_cache()


    kernels = [
        {
            "name": "render",
            "route": "cuda",
            "source": "spectral_tpu_torch/csrc/render_kernel.cu",
            "replaces": "spectral_tpu/ops/pallas/render_kernel.py:1852",
            "launches": launches["render"],
            "max_abs_err": render_err,
            "mean_abs_err": render_mean,
            "ms": render_ms,
            "plain_ms": render_plain_ms,
            "bound_ms": r_bound,
            "bound_by": r_by,
            "library_ms": None,
            "lane_efficiency": render_eff,
            "shape": f"{width}x{height} px, {spp} spp, {bounces} bounces, {n_tris} tris, {live} live ray-steps",
        },
        {
            "name": "render_residuals",
            "route": "cuda",
            "source": "spectral_tpu_torch/csrc/render_kernel.cu",
            "replaces": "spectral_tpu/ops/pallas/render_kernel.py:2421",
            "launches": train_launches["render_residuals"],
            "max_abs_err": res_err,
            "mean_abs_err": res_mean,
            "ms": res_ms,
            "plain_ms": res_plain_ms,
            "bound_ms": rr_bound,
            "bound_by": rr_by,
            "library_ms": None,
            "lane_efficiency": res_eff,
            "shape": f"{tw}x{th} px, {t_spp} spp, {t_b} bounces, {n_tris} tris, {t_live} live ray-steps, "
                     f"{res_bytes} residual bytes",
        },
        {
            "name": "grad",
            "route": "cuda",
            "source": "spectral_tpu_torch/csrc/grad_kernel.cu",
            "replaces": "spectral_tpu/ops/pallas/grad_kernel.py:63",
            "launches": train_launches["grad"],
            "max_abs_err": grad_err,
            "max_column_rel_err": grad_rel,
            "ms": grad_ms,
            "plain_ms": grad_plain_ms,
            "bound_ms": gr_bound,
            "bound_by": gr_by,
            "library_ms": None,
            "shape": f"{tw}x{th} rays, {t_spp} spp, {t_b} bounces, {mat.shape[0]} materials, background gradients",
        },
        {
            "name": "intersect",
            "route": "cuda",
            "source": "spectral_tpu_torch/csrc/intersect_kernel.cu",
            "replaces": "spectral_tpu/ops/pallas/intersect_kernel.py:52",
            "launches": launches["intersect"],
            "on_main_path": False,
            "max_abs_err": isect_err,
            "mean_abs_err": isect_mean,
            "ms": i_ms,
            "plain_ms": i_plain_ms,
            "bound_ms": i_bound,
            "bound_by": i_by,
            "library_ms": None,
            "shape": f"{n_rays} rays, {tri16.shape[0]} tris",
        },
        {
            "name": "render_leaves",
            "route": "cuda",
            "source": "spectral_tpu_torch/csrc/render_kernel.cu",
            "replaces": "spectral_tpu/ops/pallas/render_kernel.py:565",
            "launches": mega_launches["render_leaves"],
            "max_abs_err": mega_err,
            "mean_abs_err": mega_mean,
            "ms": lm_ms,
            "plain_ms": lm_plain_ms,
            "bound_ms": lm_bound,
            "bound_by": lm_by,
            "flat_sweep_bound_ms": lm_flat_bound,
            "library_ms": None,
            "slab_tests_per_live_step": lm_tests,
            "shape": f"{fw}x{fh} px, {f_spp} spp, {f_b} bounces, {FIELD_TRIS} tris in {f_leaf.shape[0]} leaves of "
                     f"{k_size}, {f_live} live ray-steps, boxes entered {f_box}",
        },
        {
            "name": "render_leaves_residuals",
            "route": "cuda",
            "source": "spectral_tpu_torch/csrc/render_kernel.cu",
            "replaces": "spectral_tpu/ops/pallas/render_kernel.py:2421",
            "launches": fmega_launches["render_leaves_residuals"],
            "max_abs_err": mega_err,
            "mean_abs_err": mega_mean,
            "ms": lmr_ms,
            "plain_ms": lm_plain_ms,
            "bound_ms": lmr_bound,
            "bound_by": lmr_by,
            "library_ms": None,
            "shape": f"as render_leaves, {f_res_bytes} residual bytes",
        },
        {
            "name": "wavefront_camera",
            "route": "cuda",
            "source": "spectral_tpu_torch/csrc/wavefront_kernel.cu",
            "replaces": "spectral_tpu/ops/pallas/wavefront_kernel.py:188",
            "launches": field_launches["wavefront_camera"],
            "launches_per_train_step": ftrain_launches["wavefront_camera"] // 3,
            "max_abs_err": sorted_err,
            "mean_abs_err": sorted_mean,
            "ms": wf["cam_ms"],
            "plain_ms": wf["p_cam"],
            "bound_ms": wf["cam_bound"],
            "bound_by": wf["cam_by"],
            "flat_sweep_bound_ms": wf["cam_flat_bound"],
            "library_ms": None,
            "slab_tests_per_live_step": wf["cam_tests"],
            "at_200k": {k: big_wf[k] for k in ("cam_ms", "cam_bound", "cam_flat_bound", "b_cam", "cam_tests")},
            "shape": f"{f_samples} sample-rays, {FIELD_TRIS} tris, boxes entered {wf['b_cam']}",
        },
        {
            "name": "wavefront_bounce",
            "route": "cuda",
            "source": "spectral_tpu_torch/csrc/wavefront_kernel.cu",
            "replaces": "spectral_tpu/ops/pallas/wavefront_kernel.py:270",
            "launches": field_launches["wavefront_bounce"],
            "launches_per_train_step": ftrain_launches["wavefront_bounce"] // 3,
            "max_abs_err": sorted_err,
            "mean_abs_err": sorted_mean,
            "ms": wf["bounce_ms"],
            "plain_ms": wf["p_bounce"],
            "bound_ms": wf["b_bound"],
            "bound_by": wf["b_by"],
            "flat_sweep_bound_ms": wf["b_flat_bound"],
            "library_ms": None,
            "slab_tests_per_live_step": wf["b_tests"],
            "at_200k": {k: big_wf[k] for k in ("bounce_ms", "b_bound", "b_flat_bound", "live", "b_bounce", "b_tests")},
            "shape": f"{f_b - 1} launches together: {wf['live']} live ray-steps, boxes entered {wf['b_bounce']}",
        },
        {
            "name": "wavefront_integrate",
            "route": "cuda",
            "source": "spectral_tpu_torch/csrc/wavefront_kernel.cu",
            "replaces": "spectral_tpu/ops/pallas/wavefront_kernel.py:338",
            "launches": field_launches["wavefront_integrate"],
            "launches_per_train_step": ftrain_launches["wavefront_integrate"] // 3,
            "max_abs_err": sorted_err,
            "mean_abs_err": sorted_mean,
            "ms": wf["int_ms"],
            "plain_ms": wf["p_int"],
            "bound_ms": wf["int_bound"],
            "bound_by": wf["int_by"],
            "library_ms": None,
            "shape": f"{f_samples} sample-rays",
        },
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
