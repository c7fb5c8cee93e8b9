#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spectral_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel from csrc/ with nvcc, all sources at once, and
   time the render kernel's first launch in this process (1 pixel) beside
   a second one;
3. each kernel against its plain PyTorch version on the card, at 64x64,
   8 spp, 5 bounces on each scene, with injected uniform planes and with
   the hash draws: the render megakernel; its residual form (residual
   buffers filled with garbage first; integer residuals, hero and n_valid
   equal, power and xyz within tolerance, xyz equal to the forward
   kernel's); the replay kernel on those residuals (background gradients
   on, Sellmeier scalars on for PRISM; two launches bit-identical);
4. each kernel at its path's shapes, timed beside its plain version and the
   card's bound, and held against the plain version there too: the render
   megakernel on the default Cornell frame (600x600, 500 spp, 10 bounces,
   hash draws; live ray-steps equal), the intersect kernel on random rays
   against CORNELL at that frame's ray count, the residual and replay
   kernels on the training frame (Cornell 1920x1080, 16 spp, 8 bounces);
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
   examples/inverse_dispersion.py); a finite, nonzero Sellmeier gradient.

Launch counts are set to 0 just before each of phases 5-7 and read just
after. Prints a ``{"kernels": [...]}`` line after phase 7, with each
kernel's launches on its path (the render megakernel's from phase 5, the
fused kernels' from phase 6), then the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without a CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
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


def check_render(name: str, kernel, plain, args) -> tuple[float, float, int, float]:
    """One render through the kernel and through its plain version on the
    same inputs: the live ray-step counts must be equal and the XYZ within
    the render tolerance. Returns max abs, mean abs, live ray-steps and the
    plain version's wall time in ms."""
    steps = torch.zeros(args[5].numel(), dtype=torch.int32, device=args[5].device)
    ref_steps = torch.zeros_like(steps)
    got = kernel(*args, steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = plain(*args, ref_steps)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    err = (got - ref).abs()
    bad = int((err > ATOL + RTOL * ref.abs()).sum())
    mx, mean = float(err.max()), float(err.mean())
    log(f"  {name}: max abs {mx:.3g}, mean abs {mean:.3g}, values off {bad}")
    if not torch.equal(steps, ref_steps):
        raise SystemExit(f"render {name}: live ray-steps differ from the plain version")
    if float(ref.sum()) <= 0:
        raise SystemExit(f"render {name}: black image")
    if bad or mean > MEAN_TOL or not torch.isfinite(got).all():
        raise SystemExit(f"render {name}: kernel disagrees with its plain version")
    return mx, mean, int(steps.to(torch.int64).sum()), plain_ms


def check_residuals(name: str, args, with_steps: bool = False):
    """The residual kernel (into buffers filled with garbage) against its
    plain version and against the forward kernel. Returns (residuals, max
    abs error of xyz and power, mean abs error of xyz, plain ms, live
    ray-steps)."""
    from spectral_tpu_torch.ops.cuda.render_kernel import (
        render_rays, render_rays_reference, render_rays_residuals,
    )

    n, spp, bounces = args[5].numel(), args[7], args[8]
    dev = args[5].device
    out = (
        torch.full((spp, n), 7.0, device=dev), torch.full((spp, n), 7.0, device=dev),
        torch.full((spp, 7, n), 7.0, device=dev), torch.full((spp, bounces, n), 7, dtype=torch.int32, device=dev),
    )
    steps = torch.zeros(n, dtype=torch.int32, device=dev) if with_steps else None
    xyz, *res = render_rays_residuals(*args, steps, out=out)
    fwd = render_rays(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_steps = torch.zeros_like(steps) if with_steps else None
    ref_xyz, *ref = render_rays_reference(*args, ref_steps, residuals=True)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    for k, what in ((0, "hero"), (1, "n_valid"), (3, "matres")):
        if not torch.equal(res[k], ref[k]):
            raise SystemExit(f"residuals {name}: {what} differs from the plain version")
    if not torch.equal(xyz, fwd):
        raise SystemExit(f"residuals {name}: xyz differs from the forward kernel's")
    if with_steps and not torch.equal(steps, ref_steps):
        raise SystemExit(f"residuals {name}: live ray-steps differ from the plain version")
    p_err = (res[2] - ref[2]).abs()
    x_err = (xyz - ref_xyz).abs()
    bad = int((p_err > POWER_ATOL + POWER_RTOL * ref[2].abs()).sum()) + int((x_err > ATOL + RTOL * ref_xyz.abs()).sum())
    mx, mean = max(float(p_err.max()), float(x_err.max())), float(x_err.mean())
    ended = int((res[3] == 0).sum())
    log(f"  {name}: xyz/power max abs {mx:.3g}, xyz mean abs {mean:.3g}, values off {bad}, "
        f"{ended} matres entries after a path ended")
    if bad or mean > MEAN_TOL or not torch.isfinite(xyz).all() or float(ref_xyz.sum()) <= 0:
        raise SystemExit(f"residuals {name}: kernel disagrees with its plain version")
    live = int(steps.to(torch.int64).sum()) if with_steps else 0
    return res, mx, mean, plain_ms, live


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: PyTorch sees no CUDA device", file=sys.stderr)
        return 1
    try:
        from spectral_tpu_torch import main as cli
        from spectral_tpu_torch.diff import render_rays_diff_fused
        from spectral_tpu_torch.io.image import decode_bmp
        from spectral_tpu_torch.models.camera import camera_vector
        from spectral_tpu_torch.models.scenes import CORNELL, PRISM, TRIS, build_scene, scene_camera
        from spectral_tpu_torch.ops.cuda import build
        from spectral_tpu_torch.ops.cuda.grad_kernel import render_grads
        from spectral_tpu_torch.ops.cuda.intersect_kernel import intersect, pack_tris
        from spectral_tpu_torch.ops.cuda.render_kernel import (
            n_uniforms, pack_scene, render_rays, render_rays_reference, render_rays_residuals,
        )
        from spectral_tpu_torch.ops.intersect import nearest_hit
        from spectral_tpu_torch.parallel import train_step_fused, trainable_params
        from spectral_tpu_torch.runtime.render_manager import chunk_seed
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
            mx, mean, _, _ = check_render(f"{sname}/{mode}", render_rays, render_rays_reference, args)
            render_err, render_mean = max(render_err, mx), max(render_mean, mean)
            res, mx, mean, _, _ = check_residuals(f"{sname}/{mode} residuals", args)
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
    mx, mean, live, render_plain_ms = check_render("cornell/full", render_rays, render_rays_reference, args)
    render_ms = cuda_ms(lambda: render_rays(*args), 3)
    render_err, render_mean = max(render_err, mx), max(render_mean, mean)
    n_tris = tri.shape[0]
    r_flops = live * (SWEEP_FLOPS_PER_TRI * n_tris + SHADE_FLOPS_PER_STEP) + n_rays * spp * SAMPLE_FLOPS
    r_bytes = 4 * (tri.numel() + mat.numel() + tab.numel() + 20 + 2 * n_rays + 3 * n_rays)
    r_bound, r_by = bound_ms(r_flops, r_bytes)
    log(
        f"  kernel {render_ms} ms (plain {render_plain_ms} ms), {live} live ray-steps of {nominal} nominal, "
        f"bound {r_bound} ms ({r_by})"
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
    t_res, mx, mean, res_plain_ms, t_live = check_residuals("cornell/train", t_args, with_steps=True)
    res_err, res_mean = max(res_err, mx), max(res_mean, mean)
    res_bytes = sum(x.numel() * x.element_size() for x in t_res)
    res_ms = cuda_ms(lambda: render_rays_residuals(*t_args), 3)
    rr_flops = t_live * (SWEEP_FLOPS_PER_TRI * n_tris + SHADE_FLOPS_PER_STEP) + t_rays * t_spp * SAMPLE_FLOPS
    rr_bytes = res_bytes + 4 * (tri.numel() + mat.numel() + tab.numel() + 20 + 2 * t_rays + 3 * t_rays)
    rr_bound, rr_by = bound_ms(rr_flops, rr_bytes)
    log(
        f"  kernel {res_ms} ms (plain {res_plain_ms} ms), {t_live} live ray-steps of {t_rays * t_spp * t_b} nominal, "
        f"residuals {res_bytes} bytes, bound {rr_bound} ms ({rr_by})"
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
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
