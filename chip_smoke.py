#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spectral_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel from csrc/ with nvcc, all sources at once, and
   time the render kernel's first launch in this process (1 pixel) beside
   a second one;
3. each kernel against its plain PyTorch version on the card: the render
   megakernel at 64x64, 8 spp, 5 bounces on each scene, with injected
   uniform planes and with its own hash draws;
4. each kernel at the main path's shapes, timed beside its plain version
   and the card's bound, and held against the plain version there too: the
   render megakernel on the default Cornell frame (600x600, 500 spp, 10
   bounces, hash draws; live ray-steps equal), the intersect kernel on
   random rays against CORNELL at that frame's ray count;
5. the main path, once, as a user runs it: ``python -m
   spectral_tpu_torch.main --save`` with the default Cornell box into a
   temporary directory; the megakernel's launch count must equal the chunk
   count and the BMP must show the lit box.

Prints a ``{"kernels": [...]}`` line after phase 5, since its launch counts
are those of the main path's run, then the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without a CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: PyTorch sees no CUDA device", file=sys.stderr)
        return 1
    try:
        from spectral_tpu_torch import main as cli
        from spectral_tpu_torch.io.image import decode_bmp
        from spectral_tpu_torch.models.camera import camera_vector
        from spectral_tpu_torch.models.scenes import CORNELL, PRISM, TRIS, build_scene, scene_camera
        from spectral_tpu_torch.ops.cuda import build
        from spectral_tpu_torch.ops.cuda.intersect_kernel import intersect, pack_tris
        from spectral_tpu_torch.ops.cuda.render_kernel import (
            n_uniforms, pack_scene, render_rays, render_rays_reference,
        )
        from spectral_tpu_torch.ops.intersect import nearest_hit
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
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
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
    log(f"render megakernel vs plain, {w}x{h}, {c_spp} spp, {c_bounces} bounces:")
    for sid, sname in ((CORNELL, "cornell"), (PRISM, "prism"), (TRIS, "tris")):
        s_tri, s_mat, s_tab = pack_scene(build_scene(sid, dev))
        cam = camera_vector(scene_camera(sid, w, h, dev))
        planes = rng.uniform(size=(c_spp, n_uniforms(c_bounces), w * h)).astype(np.float32)
        for mode, rand in (("planes", torch.from_numpy(planes).to(dev)), ("hash", None)):
            seed = chunk_seed(0, 0, w) + sid
            mx, mean, _, _ = check_render(
                f"{sname}/{mode}", render_rays, render_rays_reference,
                (cam, seed, s_tri, s_mat, s_tab, px, py, c_spp, c_bounces, w, rand),
            )
            render_err, render_mean = max(render_err, mx), max(render_mean, mean)

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
