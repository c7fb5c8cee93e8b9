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
   CORNELL at that frame's ray count (every output equal; its device time
   with the host kept ahead by a sleep of the card, the host's µs a call,
   and its issue bound from the instructions of its loop in the SASS and
   the SM's top clock), the residual (bit-equal) and replay
   kernels on the training frame (Cornell 1920x1080, 16 spp, 8 bounces);
   the lane efficiency of the render and residual kernels there, live
   ray-steps / (32 x warp sweeps); the replay's time beside its bound and
   the card's name and power limit, its launch shape (block size, resident
   blocks an SM from the occupancy API) for the training frame and for 70
   materials and 20 bounces (the unpacked form), and ptxas's registers and
   spills of each of its instantiations;
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
   version there; the integrate step (the integrate launch with the spp
   sum that follows it), forward and residual, beside its bytes bound;
10. the field render as a user runs it: RenderManager with one chunk the
   size of the frame, through render_chunk into the sorted scheduler; the
   same frame through the leaf megakernel (sched="mega"), equal; then the
   200k field (bench.py:281-287) on the same frame, both schedulers equal,
   and its sorted kernels timed with their bounds and counts;
11. the field training path: three ``train_step_fused`` steps on the 10k
   field at 512x256, 4 spp, 6 bounces (bench.py:228-280), from a perturbed
   white against a target at the true materials, and one fused gradient
   through the leaf megakernel's residual form (sched="mega");
12. the XLA-style renderer (render/wavefront.py), whose nearest hits the
   intersect kernel selects: CORNELL at the JAX bench row's 1920x135, 16
   spp, 8 bounces (bench.py:163-180) under no_grad, bit-equal to the same
   render with the plain version selecting, one intersect launch a sample
   and bounce, its ms, nominal Mrays/s and the intersect's share (CUDA
   events around each selection); the intersect kernel as the path launches
   it (the dots in the XLA order) on the path's first selection, held
   equal to its plain version and timed beside it, its bound and its issue
   bound; the CLI with ``--impl xla`` (256x256, 16
   spp, 8 bounces: a lit box in the BMP); render_chunk_diff (the kernel
   forward, the XLA-style VJP backward) on CORNELL 256x256, 16 spp, 8
   bounces, timed with its peak memory, with one render launch forward and
   two intersect launches a sample and bounce backward (the XLA-style
   forward and its recompute under the checkpoint), its forward bit-equal
   to the plain render at the same seed; the reparameterized PRISM
   Sellmeier gradient at examples/inverse_dispersion.py's XLA shape (the
   32x16 crop of 32x32, 16 spp, 6 bounces; finite and nonzero); three
   autograd ``train_step``s at examples/inverse_rendering.py's shape
   (Cornell 32x32, 8 spp, 4 bounces; a falling loss); the LBVH walk on
   with_bvh(build_tri_field(10008, 0), 8) over a 64x32 crop, 2 spp, 3
   bounces, against the dense selection (10,008 triangles, in tiles) on the
   same draws (more than 99% of values within rtol 2e-4 / atol 1e-5, the
   JAX package's tests/test_bvh.py:151-169); and the parity contract of the
   two renderers (tests/test_parity_contract.py's method on CORNELL and
   PRISM at 128x128, 256 spp, 5 bounces: the kernel image's
   block-downsampled error against the XLA-style images at most 1.1x their
   reseed error, mean luminance within 2%, BASELINE.md's on-chip contract);
13. the warp estimators (diff/vertex_warp.py, diff/fuzz_warp.py) on the
   XLA-style renderer: one warped vertex gradient at
   examples/inverse_geometry.py's shape (16x16, 8 spp, 3 bounces) with
   exactly 2 x 8 x 3 intersect launches (forward and the checkpoint's
   recompute) and no other; the JAX suite's statistical checks, each with
   its scene, loss, spp, bounces, K and band (tests/test_diff.py): the
   screen silhouette (K = 48, [0.90, 1.06] x 4737 +- 3 sem), the shadow
   (K = 48, [0.80, 1.20] x 934 +- 3 sem), the non-rigid corner (K = 12,
   N = 20000, within 15% of 0.0403 + 3 sem) and the fuzz (K = 160, [0.3,
   2.0] x 522 +- 3 sem); the primal identities (warped and plain Cornell
   16x16, 2 spp, 3 bounces, and the fuzz scene with and without its warp:
   max-abs < 2e-5) and the plain estimator's vertex and fuzz gradients
   exactly 0; both warp examples in full (python -m
   spectral_tpu_torch.examples.inverse_geometry / inverse_fuzz), their
   recovery asserts the gate; the full-width case (scratch/r5_vwarp_chip.py:
   the 520-triangle all-diffuse field at 64x64, 8 spp, 3 bounces, every box
   moving in +x, 8 x 8 block rademacher weights, th = 0) through the LBVH
   and through the intersect kernel's dense selection, the two gradients
   equal within rtol 2e-4 on the same draws, then for each the ms of an
   estimate (CUDA events, warm), its peak memory, the warp's forward ms and
   the intersect kernel's ms in it (events around each call), and the AD
   mean +- sem of as many estimates as fit in WARP_SECONDS (all finite, the
   mean nonzero);
14. the sharded paths on torch.distributed (parallel/), one process per
   rank, each started by this script (``--rank SPEC``) after the build, so
   that no rank builds a kernel: a world of two gloo ranks that share the
   one card and all-reduce CUDA tensors, with the meshes (2, 1) and (1, 2),
   then a world of one NCCL rank (the 1 x 1 mesh, its collectives on the
   card). On each mesh, every rank: the default render (Cornell 600x600,
   500 spp, 10 bounces) and the 10k field frame through the sorted
   scheduler and the leaf megakernel (render_image_sharded_pallas), each
   bit-equal to what one process composes from the shards' one-device
   renders at the shard seeds; train_step_fused on the training frame
   (B3 + B4) and on the field frame (the sorted residual forward, and the
   leaf megakernel's, + B4), its loss within 1e-6 of the composition's and
   its gradient within REPLAY_REL of the true gradient composed in one
   process by autograd over the shards, the ratio printed (1, where JAX's
   fused step gives n_sample: ROADMAP C8); render_image_sharded and
   train_step (the XLA-style renderer, B1) at 32x32, 8 spp, 4 bounces,
   within 1e-6 of their composition; every kernel launched on every rank;
   examples/inverse_rendering.py in full on the (1, 2) mesh and on one
   device, with its wall time and its own verdict (SPD error under 0.03),
   each taking at least EXAMPLE_SHARE of the SPD error away. Each path runs
   twice; each rank's ms (CUDA events around the second call, the first
   beside it), the count and host ms of its ``mesh.all_reduce`` spans
   (utils/trace.py; with gloo on a CUDA tensor the host waits for the
   all-reduce, with NCCL it enqueues it: the device's NCCL time is the
   benchmark's ``collective_ms``) and its peak memory stand beside the
   one-device numbers of the same frames: processes that share one card,
   not scaling. A rank that fails, or a world that runs
   out of WORLD_SECONDS, fails the phase;
15. the general-colour rgb2spec (ops/rgb2spec.py) on CUDA tensors against
   its CPU results (the table lookup and the LM fit of the stored case's 39
   colours), then the last two examples as a user runs them, their gates
   raised: examples/inverse_field.py in full (the 10k glass field, 192x96,
   4 spp, 5 bounces, 80 Adam steps through the sorted residual forward and
   the replay; at least 70% of the green SPD's perturbation recovered), with
   one camera, 4 bounce and one integrate launch a step and the target, and
   a replay a step; examples/inverse_dispersion.py --impl fused in full (260
   steps of 8 estimates: two render launches, a residual launch and a
   replay an estimate; |B0 - B0*| under 0.35 of its start) and --impl xla
   for DISP_XLA_STEPS steps (not gated; 4 x 6 intersect launches an
   estimate: a pass and bounce in each render of the CRN pair, forward and
   in the checkpoint's recompute in the gradient factor), each with its wall
   time, ms a step or an estimate and launch counts.

Launch counts are set to 0 just before each of phases 5-7, 10-11 and the
XLA-style render, the CLI and each render_chunk_diff pass of phase 12, the
warped gradient of phase 13, each call of phase 14 on each rank and each
example of phase 15, and read just after. Prints a ``{"kernels": [...]}``
line after phase 15, with
each kernel's launches on its path (the render megakernel's from phase 5
and, beside them, from render_chunk_diff's forward, the fused kernels'
from phase 6, the leaf megakernel's and the sorted kernels' from phase 10,
the leaf residual form's from phase 11, the intersect kernel's from phase
12, whose times are those of its instantiation on that path, with phase
4's beside them, and its launches on phase 13's warped gradient) and each
kernel's launches per rank on each mesh of phase 14 and its launches in
each example of phase 15, then the nvidia-smi
line, and last ``{"ok": true, "device": {...}}``. Exits non-zero, printing
no result, without a CUDA device or outside a checkout of the repository.

``python3 chip_smoke.py --xla`` runs phase 12 alone (after the build) and
prints what it measured as one JSON line; ``--warp`` does the same for
phase 13, ``--parallel`` for phase 14 and ``--examples`` for phase 15.
``--parallel-cards``, on a
machine with more than one card, runs phase 14's paths in one NCCL world
of a rank on each card instead.

``python3 chip_smoke.py --leaf-sizes`` instead times both large-scene
schedulers on the 10k and 200k fields at leaf sizes 8 to 128 (the sweep
behind ops/cuda/render_kernel.py::LEAF_SIZE) and prints one JSON line.

``python3 chip_smoke.py --ab BASE [OTHER ...]`` times the render kernels
(B2 at the default frame, B3 at the training frame, B5 and the sorted
kernels at the 10k field frame, the sorted kernels and the integrate step
at the 200k field frame), the replay (B4, on B3's residuals of the
training frame, with and without the background knots, and on B5's
residuals of the 10k field frame) and the dense intersect (device time,
host µs a call, back-to-back events, issue bound) of other checkouts of
the port against this one's, one process each, in the order BASE, this,
OTHER..., this, BASE: a checkout is any directory holding a
``spectral_tpu_torch`` package, such as an unpacked parent commit (``git
archive``) or a copy with one compiled choice changed
(scripts/kernel_variants.py). Every render, integrate-step and intersect
output must be bit-equal to this checkout's (digests), and every replay
output within REPLAY_REL of its column's largest value (the replay sums
over rays in an order its launch shape sets); a checkout holding a
TIMING_ONLY file (a build with part of a kernel compiled out) is timed and
not held to them. ``--time ROOT`` is one such process.
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

# the card's published peaks and the FP32 operations of a unit of work, as
# the benchmark counts them
from port_bench.roofline import (  # noqa: E402
    GRAD_FLOPS_PER_MATERIAL,
    GRAD_FLOPS_PER_MISS,
    GRAD_FLOPS_PER_SAMPLE,
    PEAK_BYTES,
    PEAK_FP32_FLOPS,
    SAMPLE_FLOPS,
    SHADE_FLOPS_PER_STEP,
    SWEEP_FLOPS_PER_TRI,
)

# render tolerance (tests/test_torch_render.py): per value and mean
ATOL, RTOL, MEAN_TOL = 2e-3, 1e-5, 2e-5
# the Sellmeier scalars' share of the replay's operations per sample-ray
# and per material present in a sample-ray's path (csrc/grad_kernel.cu)
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
# the ray state (ops/cuda/wavefront_kernel.py): 17 floats a sample-ray;
# the integrate step reads 10 of its rows and the original index a
# sample-ray, writes 12 bytes a pixel, and in the residual form 36 bytes a
# sample-ray more (hero, n_valid, 7 powers)
STATE_BYTES = 4 * 17
INTEGRATE_READ_BYTES = 4 * (10 + 1)
INTEGRATE_RESIDUAL_BYTES = 4 * 9
# the device sleep that keeps the host ahead of timed launches: ~20 ms at
# the H100's 1.98 GHz boost clock
SLEEP_CYCLES = 40_000_000
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
# the XLA-style renderer at the JAX bench row's shape (bench.py:163-180)
XLA_W, XLA_H, XLA_SPP, XLA_BOUNCES = 1920, 135, 16, 8
# the parity contract of the two renderers (BASELINE.md round 2, on chip)
PARITY_SIZE, PARITY_SPP, PARITY_BOUNCES, PARITY_CHUNK = 128, 256, 5, 16
PARITY_RATIO, PARITY_LUM = 1.1, 0.02
# autograd SGD on the mean loss at 32x32 (examples/inverse_rendering.py):
# the fused path's rate for the un-normalized sum times the 3 * 32 * 32
# terms of the mean
XLA_TRAIN_LR = 1e-13 * 256 / (32 * 32) * (3 * 32 * 32)


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


def device_ms(fn, reps: int) -> tuple[float, float]:
    """(device ms, host µs) a call of fn(), after one warm-up. The reps
    calls are queued behind a sleep of the card, so that the host is ahead
    and the events around the calls time the device alone; the host's
    clock over the same loop gives its µs a call. Raises if the sleep ended
    before the host had queued the calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    ahead = not start.query()
    end.record()
    torch.cuda.synchronize()
    if not ahead:
        raise SystemExit(f"device_ms: the host took {host_s} s for {reps} calls, longer than the card's sleep")
    return start.elapsed_time(end) / reps, 1e6 * host_s / reps


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


def intersect_rays(rng, n: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """n random rays (o, d [n, 3]) in and around the Cornell box."""
    o = rng.uniform([20, 20, -400], [535, 535, 535], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)


def sass_loop(lib, name: str, marker: str = "MUFU.RCP") -> tuple[int, int]:
    """(instructions, ``marker`` instructions) of the innermost loop of the
    kernel ``name`` in a built library (``cuobjdump -sass``) that holds the
    most ``marker`` instructions: a loop is the range from a backward
    branch's target to the branch. Each triangle test has one IEEE divide,
    whose fast path holds one MUFU.RCP, so the second count is the tests an
    iteration."""
    from spectral_tpu_torch.ops.cuda.build import find_nvcc

    cuobjdump = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True, timeout=300,
                          check=True).stdout
    best = None
    for fn, body in re.findall(r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", sass, re.S):
        if name not in fn:
            continue
        ins = [(int(a, 16), op) for a, op in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
        for addr, op in ins:
            jump = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", op)
            if not jump or int(jump.group(1), 16) >= addr:
                continue
            loop = [o for a, o in ins if int(jump.group(1), 16) <= a <= addr]
            key = (sum(marker in o for o in loop), -len(loop))
            if best is None or key > best[0]:
                best = (key, len(loop))
    if best is None or best[0][0] == 0:
        raise SystemExit(f"no loop with {marker} in {name} of {lib}")
    return best[1], best[0][0]


def intersect_issue_bound(tests: int, form: str = "") -> dict:
    """The least time the card could issue the dense intersect's triangle
    tests: the instructions of its loop a test (sass_loop) x tests over
    (132 SMs x 128 lanes x the SM's top clock, nvidia-smi). ``form``: the
    mangled template arguments of one instantiation (``ILb1ELb0E`` is
    intersect_kernel<true, false>), else the loop of any."""
    from spectral_tpu_torch.ops.cuda import build

    n_ins, per_iter = sass_loop(build.INTERSECT.library(), "intersect_kernel" + form)
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    mhz = float(out.stdout.strip().splitlines()[0])
    per_test = n_ins / per_iter
    return {"ms": 1e3 * tests * per_test / (132 * 128 * mhz * 1e6), "per_test": per_test,
            "loop_instructions": n_ins, "tests_per_iteration": per_iter, "mhz": mhz}


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

    n, dev = args[3].numel(), args[3].device
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

    n, spp, bounces = args[3].numel(), args[5], args[6]
    dev = args[3].device
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


def replay_shapes(dev, n: int, n_mats: int, bounces: int) -> None:
    """Print the replay's launch shape (occupancy API) for the training
    frame and each option, and ptxas's registers and spills of each
    instantiation of csrc/grad_kernel.cu."""
    from spectral_tpu_torch.ops.cuda import build
    from spectral_tpu_torch.ops.cuda.grad_kernel import launch_shape

    for bg, sell in ((True, False), (True, True), (False, False), (False, True)):
        for m, b in ((n_mats, bounces), (70, 20)):
            shape = launch_shape(n, m, b, bg, sell, dev)
            log(f"  launch shape, {m} materials, {b} bounces, want_bg {bg}, want_sell {sell}: {shape}, "
                f"{shape['blocks_per_sm'] * shape['block'] // 32} resident warps an SM")
    name = None
    for line in build.GRAD.build_log.splitlines():
        found = re.search(r"Compiling entry function '(\S+)'", line)
        if found:
            name = found.group(1)
            form = re.search(r"replay_kernelILb(\d)ELb(\d)ELb(\d)E", name)
            name = f"replay_kernel<{','.join(form.groups())}>" if form else name
        elif name and ("registers" in line or "spill" in line):
            log(f"  {name} (kWantBg, kWantSell, kPacked): {line.split(':', 1)[-1].strip()}")


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
    """The arguments of the large-scene renders of ``scene`` at w x h, its
    pack from the Cornell camera (leaves near to far) among them, and the
    pack's leaves."""
    from spectral_tpu_torch.models.camera import camera_vector
    from spectral_tpu_torch.models.scenes import CORNELL, scene_camera
    from spectral_tpu_torch.ops.cuda.render_kernel import LEAF_SIZE, pack_scene_frame

    dev = scene.normal.device
    cam = camera_vector(scene_camera(CORNELL, w, h, dev))
    pack = pack_scene_frame(scene, cam, leaf_size or LEAF_SIZE)
    px = (torch.arange(w * h, device=dev) % w).float()
    py = (torch.arange(w * h, device=dev) // w).float()
    return (cam, seed, pack, px, py, spp, bounces, w, rand), pack.leaf


def check_leaves(name: str, args) -> dict:
    """The leaf megakernel (forward, and residual into garbage) and the
    sorted scheduler (forward and residual) against their plain versions,
    and the two schedulers against each other: xyz, every residual, live
    ray-steps and the leaves, groups and super-groups entered, all
    bit-equal. Returns the largest errors, the plain versions' times in ms
    and the counts."""
    from spectral_tpu_torch.ops.cuda.render_kernel import render_rays, render_rays_reference, render_rays_residuals
    from spectral_tpu_torch.ops.cuda.wavefront_kernel import render_rays_wavefront, render_rays_wavefront_reference

    n, spp, bounces = args[3].numel(), args[5], args[6]
    dev = args[3].device
    names = ("steps", "visits", "group_visits", "super_visits")
    c = [dict(zip(names, (torch.zeros(n, dtype=torch.int32, device=dev) for _ in names))) for _ in range(2)]
    wc = [dict(zip(names, (torch.zeros((spp, n), dtype=torch.int32, device=dev) for _ in names))) for _ in range(2)]
    fwd = render_rays(*args, c[0]["steps"], **{k: v for k, v in c[0].items() if k != "steps"})
    res = render_rays_residuals(*args, out=garbage(spp, bounces, n, dev))
    wres = render_rays_wavefront(*args, save_residuals=True, out=garbage(spp, bounces, n, dev), **wc[0])
    wfwd = render_rays_wavefront(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = render_rays_reference(*args, c[1]["steps"], residuals=True, **{k: v for k, v in c[1].items() if k != "steps"})
    torch.cuda.synchronize()
    mega_plain_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    wref = render_rays_wavefront_reference(*args, save_residuals=True, **wc[1])
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


def integrate_step(integrate, tab, state, orig, n: int, spp: int, res=(), launched=None):
    """The integrate step of ops/cuda/wavefront_kernel.py::_wavefront on a
    final state: XYZ [N, 3] summed over the samples in ascending order, and
    with ``res`` = (hero, n_valid, power) the residuals; ``launched``, an
    event, is recorded just after the integrate launch."""
    xyz = torch.empty((n, 3), device=state.device)
    integrate(tab, state, orig, n, spp, xyz, *res)
    if launched is not None:
        launched.record()
    return xyz


def timed_sorted(args, plain: bool, reps: int = 1, check: bool = True) -> dict:
    """One sorted-scheduler render through the kernels (or their plain
    versions), the glue of ops/cuda/wavefront_kernel.py repeated here so
    that each launch is timed with CUDA events; the best of ``reps``
    renders after a warm-up. Returns the ms of the camera launch
    (``cam_ms``), of the bounce launches together (``bounce_ms``), of the
    sort and gather glue (``glue_ms``), of the integrate launch
    (``int_ms``) and of the integrate step, the launch with the spp sum
    that follows it (``step_ms``; ``step_res_ms`` for the residual form,
    run again on the same final state); the live ray-steps of bounces >= 1
    (``live``), the boxes entered by the camera launch and by the bounce
    launches (``b_cam``, ``b_bounce``: dicts of leaves, groups,
    super-groups), the lanes at work over 32 x warp passes of the kernels
    (``lanes_cam``, ``lanes_bounce``) and the outputs of the two integrate
    steps (``out``: xyz [N, 3], hero, n_valid, power); with ``check``, the
    two steps' xyz must be equal."""
    from spectral_tpu_torch.ops.cuda import wavefront_kernel as wk

    cam, seed, pack, px, py, spp, bounces, w, rand = args
    camera, bounce, integrate = wk._PLAIN if plain else wk._CUDA
    n = px.numel()
    nrays = spp * n
    dev = px.device
    levels = ("visits", "group_visits", "super_visits")
    best = None
    for rep in range(reps + 1):
        steps = torch.zeros((spp, n), dtype=torch.int32, device=dev)
        boxes = {k: torch.zeros_like(steps) for k in levels}
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3 * bounces + 6)]
        state = torch.empty((wk.STATE_ROWS, nrays), device=dev)
        # each tracing launch's warp passes and lanes at work (the kernels count them)
        passes = None if plain else torch.zeros((bounces, 2), dtype=torch.int64, device=dev)
        wp = (lambda b: {}) if plain else (lambda b: {"warp_passes": passes[b]})
        ev[0].record()
        camera(cam, seed, pack, px, py, spp, bounces, w, rand, state, None, steps, **boxes, **wp(0))
        ev[1].record()
        b_cam = {k: int(v.to(torch.int64).sum()) for k, v in boxes.items()}
        orig = torch.arange(nrays, dtype=torch.int32, device=dev)
        lo, inv_ext = pack.key_box
        k = 2
        for b in range(1, bounces):
            ev[k].record()
            perm = torch.argsort(wk._sort_keys(state, lo, inv_ext), stable=True)
            state = state.index_select(1, perm)
            orig = orig.index_select(0, perm)
            ev[k + 1].record()
            bounce(seed, pack, px, py, spp, bounces, b, w, rand, state, orig, None, steps, **boxes, **wp(b))
            ev[k + 2].record()
            k += 3
        res = (torch.empty((spp, n), device=dev), torch.empty((spp, n), device=dev),
               torch.empty((spp, 7, n), device=dev))
        ev[k].record()
        xyz = integrate_step(integrate, pack.tab, state, orig, n, spp, launched=ev[k + 1])
        ev[k + 2].record()
        xyz_res = integrate_step(integrate, pack.tab, state, orig, n, spp, res)
        ev[k + 3].record()
        torch.cuda.synchronize()
        out = dict(
            cam_ms=ev[0].elapsed_time(ev[1]),
            glue_ms=sum(ev[2 + 3 * i].elapsed_time(ev[3 + 3 * i]) for i in range(bounces - 1)),
            bounce_ms=sum(ev[3 + 3 * i].elapsed_time(ev[4 + 3 * i]) for i in range(bounces - 1)),
            int_ms=ev[k].elapsed_time(ev[k + 1]),
            step_ms=ev[k].elapsed_time(ev[k + 2]),
            step_res_ms=ev[k + 2].elapsed_time(ev[k + 3]),
            live=int(steps.sum()) - nrays,
            b_cam=b_cam,
            b_bounce={k: int(v.to(torch.int64).sum()) - b_cam[k] for k, v in boxes.items()},
            out=(xyz, *res),
        )
        if passes is not None:
            # lanes at work over 32 x passes: camera launch, bounce launches
            p = passes.tolist()
            out["lanes_cam"] = p[0][1] / (32 * p[0][0])
            out["lanes_bounce"] = sum(q[1] for q in p[1:]) / (32 * max(sum(q[0] for q in p[1:]), 1))
        if check and not torch.equal(xyz, xyz_res):
            raise SystemExit("integrate step: the residual form's xyz differs from the forward's")
        key = ("cam_ms", "bounce_ms", "step_ms")
        if rep > 0 and (best is None or sum(out[q] for q in key) < sum(best[q] for q in key)):
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


def leaf_work(args) -> tuple[float, float, int]:
    """(scene bytes, ray bytes read and written by a forward, leaf size) of
    a large-scene render: the scene as the kernels read it, the leaf tables
    of the pack (ops/cuda/render_kernel.py::leaf_tables), the materials,
    curves and camera."""
    cam, _, pack, px, *_ = args
    scene_bytes = sum(x.numel() * x.element_size() for x in (*pack.sweep[1:], pack.mat, pack.tab, cam))
    return scene_bytes, 4 * 5 * px.numel(), pack.tri.shape[0] // pack.leaf.shape[0]


def integrate_bound(n: int, spp: int) -> tuple[float, str, float]:
    """(bound ms, what bounds it, bound ms of the residual form) of the
    integrate step on N pixels: each sample-ray's state rows and original
    index read once, each pixel's XYZ written once (and each sample-ray's
    residuals); the tables; the XYZ arithmetic."""
    samples = n * spp
    read = 4 * N_TABLES_FLOATS + samples * INTEGRATE_READ_BYTES
    fwd, by = bound_ms(samples * XYZ_FLOPS, read + 12 * n)
    res, _ = bound_ms(samples * XYZ_FLOPS, read + 12 * n + samples * INTEGRATE_RESIDUAL_BYTES)
    return fwd, by, res


def sorted_report(name: str, args, plain: bool) -> dict:
    """The sorted kernels on one frame, timed per launch (timed_sorted, the
    best of 3) and, with ``plain``, held bit-equal to their plain versions
    in xyz, the integrate step's residuals and every count; the bounds of
    the camera and bounce launches under the group hierarchy and, for
    comparison, under the flat sweep over the same pack, and of the
    integrate step; slab tests per live ray-step by level."""
    scene_bytes, _, k_size = leaf_work(args)
    leaf, n_rays, spp, bounces = args[2].leaf, args[3].numel(), args[5], args[6]
    samples = n_rays * spp
    r = timed_sorted(args, False, reps=3)
    if plain:
        p = timed_sorted(args, True)
        same = all(p[k] == r[k] for k in ("live", "b_cam", "b_bounce"))
        if not same or not all(torch.equal(a, b) for a, b in zip(p["out"], r["out"])):
            raise SystemExit(f"sorted scheduler, {name}: the kernels differ from their plain versions")
        r.update(p_cam=p["cam_ms"], p_bounce=p["bounce_ms"], p_int=p["step_ms"])
    del r["out"]
    cam_sw, cam_flat, r["cam_tests"] = sweep_work(samples, r["b_cam"], leaf, k_size)
    b_sw, b_flat, r["b_tests"] = sweep_work(r["live"], r["b_bounce"], leaf, k_size)
    cam_bytes = scene_bytes + 8 * n_rays + STATE_BYTES * samples
    b_bytes = (bounces - 1) * (scene_bytes + 8 * samples) + 2 * STATE_BYTES * r["live"]
    cam_base = samples * (SAMPLE_FLOPS + SHADE_FLOPS_PER_STEP)
    b_base = r["live"] * (SHADE_FLOPS_PER_STEP + CURVE_FLOPS)
    r["cam_bound"], r["cam_by"] = bound_ms(cam_base + cam_sw, cam_bytes)
    r["cam_flat_bound"], _ = bound_ms(cam_base + cam_flat, cam_bytes)
    r["b_bound"], r["b_by"] = bound_ms(b_base + b_sw, b_bytes)
    r["b_flat_bound"], _ = bound_ms(b_base + b_flat, b_bytes)
    r["int_bound"], r["int_by"], r["int_res_bound"] = integrate_bound(n_rays, spp)
    plain_ms = f" (plain {r['p_cam']} / {r['p_bounce']} / {r['p_int']})" if plain else ""
    lanes = (f"; lane efficiency (lanes at work / 32 x warp passes): camera {r['lanes_cam']:.3f}, bounces "
             f"{r['lanes_bounce']:.3f}")
    log(f"  sorted, {name}: camera {r['cam_ms']} ms, {bounces - 1} bounces {r['bounce_ms']} ms, integrate step "
        f"{r['step_ms']} ms (its launch {r['int_ms']} ms; residual form {r['step_res_ms']} ms){plain_ms}, sort and "
        f"gather {r['glue_ms']} ms; bounds {r['cam_bound']} ({r['cam_by']}; flat sweep {r['cam_flat_bound']}), "
        f"{r['b_bound']} ({r['b_by']}; flat sweep {r['b_flat_bound']}), integrate step {r['int_bound']} "
        f"({r['int_by']}; residual form {r['int_res_bound']}) ms; {r['live']} live ray-steps of bounces >= 1; boxes "
        f"entered: camera {r['b_cam']}, bounces {r['b_bounce']}; slab tests a live ray-step: camera "
        f"{r['cam_tests']}, bounces {r['b_tests']}{lanes}")
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
            sorted_ms = cuda_ms(lambda: render_rays_wavefront(*args), 2)
            mega_ms = cuda_ms(lambda: render_rays(*args), 1) if n_tris == FIELD_TRIS else None
            rows.append({"tris": n_tris, "leaf_size": k, "leaves": leaf.shape[0], "sorted_ms": sorted_ms, "mega_ms": mega_ms})
            log(f"  {n_tris} tris, leaf size {k} ({leaf.shape[0]} leaves): sorted {sorted_ms} ms, leaf megakernel {mega_ms} ms")
    print(json.dumps({"leaf_sizes": rows, "frame": f"{FIELD_W}x{FIELD_H}, {FIELD_SPP} spp, {FIELD_BOUNCES} bounces"}), flush=True)
    return 0


def end_to_end(dev, field, big_field) -> dict:
    """Wall ms of the paths a user runs, each the least of 3 after a
    warm-up, the host clock around work that ends in a synchronize: the
    default render through RenderManager (Cornell 600x600, 500 spp, 10
    bounces), the 10k and 200k field frames through RenderManager, and one
    train_step_fused on the Cornell training frame and on the 10k field
    frame."""
    from spectral_tpu_torch.config import RenderParams
    from spectral_tpu_torch.models.scenes import CORNELL, build_scene, scene_camera
    from spectral_tpu_torch.ops.cuda.render_kernel import render_chunk
    from spectral_tpu_torch.parallel import train_step_fused, trainable_params
    from spectral_tpu_torch.runtime.render_manager import RenderManager

    def best(fn) -> float:
        fn()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return min(times)

    cornell = build_scene(CORNELL, dev)
    frame = RenderParams(xres=FIELD_W, aspect_ratio=FIELD_W / FIELD_H, nsamples=FIELD_SPP,
                         bounce_limit=FIELD_BOUNCES, show=False)
    out = {"e2e_default_render": best(
        lambda: RenderManager(cornell, scene_camera(CORNELL, 600, 600, dev), RenderParams(show=False)).render())}
    for tag, scene in (("e2e_field_frame", field), ("e2e_field_frame_200k", big_field)):
        out[tag] = best(lambda: RenderManager(scene, scene_camera(CORNELL, FIELD_W, FIELD_H, dev), frame).render())
    for tag, scene, (w, h, spp, bounces, seed, lr) in (
        ("e2e_cornell_train_step", cornell, (TRAIN_W, TRAIN_H, TRAIN_SPP, TRAIN_BOUNCES, TRAIN_SEED, TRAIN_LR)),
        ("e2e_field_train_step", field, (FIELD_W, FIELD_H, FIELD_SPP, FIELD_BOUNCES, FIELD_SEED, FIELD_LR)),
    ):
        cam = scene_camera(CORNELL, w, h, dev)
        with torch.no_grad():
            target = render_chunk(scene, cam, seed, 0, 0, w, h, spp, bounces) / spp
        params = {k: v.clone() for k, v in trainable_params(scene).items() if k in ("coeffs", "emission_power")}
        out[tag] = best(lambda: train_step_fused(params, scene, cam, target, seed, spp, bounces, lr=lr))
        del target
    return out


def time_kernels(root: str) -> int:
    """``--time ROOT``: build the port found at ROOT and time its render
    kernels at their paths' shapes, the replay, the sorted scheduler's
    integrate step and the dense intersect, warmed, with CUDA events, and
    the end-to-end paths (end_to_end); print one JSON line with each ms
    (the intersect's also as host µs a call), a digest of the kernels'
    outputs, the lane efficiency (where the port reports warp sweeps) and
    ptxas's lines for the render kernels."""
    import hashlib

    sys.path.insert(0, os.path.abspath(root))
    import spectral_tpu_torch
    from spectral_tpu_torch.models.camera import camera_vector
    from spectral_tpu_torch.models.scenes import CORNELL, build_scene, build_tri_field, scene_camera
    from spectral_tpu_torch.ops.cuda import build
    from spectral_tpu_torch.ops.cuda import render_kernel as rk
    from spectral_tpu_torch.ops.cuda.grad_kernel import render_grads as rk_grads
    from spectral_tpu_torch.ops.cuda.intersect_kernel import intersect, pack_tris
    from spectral_tpu_torch.ops.cuda.wavefront_kernel import render_rays_wavefront
    from spectral_tpu_torch.runtime.render_manager import chunk_seed

    if not spectral_tpu_torch.__file__.startswith(os.path.abspath(root)):
        raise SystemExit(f"--time {root}: imported {spectral_tpu_torch.__file__} instead")
    dev = torch.device("cuda")
    build.build_all(build.KERNELS.values())
    ptxas = [ln.split(":", 1)[-1].strip() for k in (build.RENDER, build.WAVEFRONT_CAMERA, build.GRAD)
             for ln in k.build_log.splitlines() if "registers" in ln or "spill" in ln]
    pack = rk.scene_pack(*rk.pack_scene(build_scene(CORNELL, dev)))

    def frame(w, h, spp, bounces, seed):
        cam = camera_vector(scene_camera(CORNELL, w, h, dev))
        px = (torch.arange(w * h, device=dev) % w).float()
        py = (torch.arange(w * h, device=dev) // w).float()
        return (cam, seed, pack, px, py, spp, bounces, w, None)

    a2 = frame(600, 600, 500, 10, chunk_seed(0, 0, 600))
    a3 = frame(TRAIN_W, TRAIN_H, TRAIN_SPP, TRAIN_BOUNCES, TRAIN_SEED)
    field = build_tri_field(FIELD_TRIS, 0, device=dev)
    fa, _ = field_args(field, FIELD_W, FIELD_H, FIELD_SPP, FIELD_BOUNCES, None, chunk_seed(0, 0, FIELD_W))
    runs = {
        "render": (a2, rk.render_rays, 2),
        "render_residuals": (a3, rk.render_rays_residuals, 5),
        "render_leaves": (fa, rk.render_rays, 5),
        "render_leaves_residuals": (fa, rk.render_rays_residuals, 5),
    }
    ms, digest, lanes = {}, {}, {}

    def sha(tensors) -> str:
        h = hashlib.sha256()
        for x in tensors:
            h.update(x.contiguous().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    replay_in = {}
    for name, (args, fn, reps) in runs.items():
        steps = torch.zeros(args[3].numel(), dtype=torch.int32, device=dev)
        extra = {"warp_steps": warp_buffer(args[3].numel(), dev)} if args[2].leaf is None else {}
        out = fn(*args, steps, **extra)
        out = out if isinstance(out, tuple) else (out,)
        digest[name] = sha((*out, steps))
        if extra:
            live = int(steps.to(torch.int64).sum())
            lanes[name] = live / (32 * int(extra["warp_steps"].to(torch.int64).sum()))
        ms[name] = cuda_ms(lambda: fn(*args), reps)
        if name.endswith("residuals"):
            replay_in[name] = (args[2].mat, args[2].tab, out[1:], args[5], args[6])
        del out
    # the replay on those residuals (its sums over rays are ordered by the
    # launch shape, so its values are compared within REPLAY_REL, not by digest)
    grads, shapes = {}, {}
    for name, src in (("grad", "render_residuals"), ("grad_field", "render_leaves_residuals")):
        r_mat, r_tab, res, r_spp, r_b = replay_in.pop(src)
        g = torch.from_numpy(np.random.default_rng(5).normal(size=(res[0].shape[1], 3)).astype(np.float32)).to(dev)
        replay = lambda: rk_grads(r_mat, r_tab, g, *res, r_spp, r_b, want_bg_grads=True)  # noqa: E731
        got = replay()
        grads[name] = [x.double().cpu().flatten().tolist() for x in got]
        ms[name] = cuda_ms(replay, 10)
        if name == "grad":
            # the same replay without the background knots, and its launch shape
            ms["grad_nobg"] = cuda_ms(lambda: rk_grads(r_mat, r_tab, g, *res, r_spp, r_b), 10)
            shape_fn = getattr(sys.modules[rk_grads.__module__], "launch_shape", None)
            if shape_fn is not None:
                shapes["grad"] = shape_fn(res[0].shape[1], r_mat.shape[0], r_b, True, False, dev)
        del res, g, got
    torch.cuda.empty_cache()
    # the dense intersect on random rays at the default frame's ray count:
    # device time with the host kept ahead, the host's µs a call, and the
    # events around back-to-back calls as earlier runs timed it
    o, d = intersect_rays(np.random.default_rng(11), 600 * 600, dev)
    tri16 = pack_tris(build_scene(CORNELL, dev))
    digest["intersect"] = sha(intersect(o, d, tri16))
    ms["intersect"], ms["intersect_host_us"] = device_ms(lambda: intersect(o, d, tri16), 20)
    ms["intersect_back_to_back"] = cuda_ms(lambda: intersect(o, d, tri16), 20)
    issue = intersect_issue_bound(o.shape[0] * tri16.shape[0])
    boxes = {}
    big_field = build_tri_field(BIG_FIELD_TRIS, 0, device=dev)
    big, _ = field_args(big_field, FIELD_W, FIELD_H, FIELD_SPP, FIELD_BOUNCES, None, chunk_seed(0, 0, FIELD_W))
    for tag, args in (("", fa), ("_200k", big)):
        digest["sorted" + tag] = sha(render_rays_wavefront(*args, save_residuals=True))
        t = timed_sorted(args, False, reps=3, check=not os.path.exists(os.path.join(root, "TIMING_ONLY")))
        digest["integrate_step" + tag] = sha(t["out"])
        ms.update({"wavefront_camera" + tag: t["cam_ms"], "wavefront_bounce" + tag: t["bounce_ms"],
                   "wavefront_integrate" + tag: t["int_ms"], "integrate_step" + tag: t["step_ms"],
                   "integrate_step_residuals" + tag: t["step_res_ms"], "sort_and_gather" + tag: t["glue_ms"]})
        boxes["sorted" + tag] = {"bounce_live_steps": t["live"], "camera": t["b_cam"], "bounces": t["b_bounce"],
                                 "lane_efficiency": [t["lanes_cam"], t["lanes_bounce"]]}
    ms.update(end_to_end(dev, field, big_field))
    print(json.dumps({"root": os.path.abspath(root), "ms": ms, "digest": digest, "lane_efficiency": lanes,
                      "boxes": boxes, "ptxas": ptxas, "grads": grads, "replay_shape": shapes,
                      "intersect_issue": issue}), flush=True)
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
        log(json.dumps({k: runs[-1].get(k) for k in ("root", "ms", "lane_efficiency", "boxes", "replay_shape",
                                                      "intersect_issue")}))
    ref, ref_grads = runs[1]["digest"], runs[1]["grads"]
    for root, r in zip(order, runs):
        r["bit_equal"] = {k: r["digest"].get(k) == v for k, v in ref.items()}
        grads = r.pop("grads")
        r["replay_rel"] = {k: replay_rel(grads[k], v) for k, v in ref_grads.items()}
        r["timing_only"] = os.path.exists(os.path.join(root, "TIMING_ONLY"))
    print(json.dumps({"ab": runs, "device": smi}), flush=True)
    held = [r for r in runs if not r["timing_only"]]
    if not all(all(r["bit_equal"].values()) for r in held):
        raise SystemExit("--ab: a checkout's outputs differ from this one's")
    if not all(v <= REPLAY_REL for r in held for v in r["replay_rel"].values()):
        raise SystemExit("--ab: a checkout's replay differs from this one's beyond REPLAY_REL")
    return 0


def replay_rel(got: list, ref: list) -> float:
    """The largest error of a replay's outputs (d_coeffs [M, 3], d_power,
    d_bg) against another's, over the largest value of its column."""
    worst = 0.0
    for a, b, width in zip(got, ref, (3, 1, 1)):
        a, b = np.asarray(a).reshape(-1, width), np.asarray(b).reshape(-1, width)
        for j in range(width):
            err, scale = float(np.abs(a[:, j] - b[:, j]).max()), float(np.abs(b[:, j]).max())
            worst = max(worst, err / scale if scale > 0 else (0.0 if err == 0 else float("inf")))
    return worst


def block_rel(a: np.ndarray, b: np.ndarray, block: int = 8) -> float:
    """tests/test_parity_contract.py's error of two images [H, W, 3]: the
    mean over 8x8 blocks of |a - b|_1 / (|a|_1 + 1e-3) of the block means."""
    def down(img):
        h, w, c = img.shape
        return img.reshape(h // block, block, w // block, block, c).mean((1, 3))

    da, db = down(a), down(b)
    return float((np.abs(da - db).sum(-1) / (np.abs(da).sum(-1) + 1e-3)).mean())


def xla_phase(dev, smi: str) -> dict:
    """Phase 12: the XLA-style renderer, its CLI, its autograd paths, the
    LBVH and the parity contract. Returns what the kernels line reports."""
    import dataclasses as dc

    from spectral_tpu_torch import main as cli
    from spectral_tpu_torch.diff import render_chunk_diff
    from spectral_tpu_torch.io.image import decode_bmp
    from spectral_tpu_torch.models.camera import camera_vector
    from spectral_tpu_torch.models.materials import tabulate
    from spectral_tpu_torch.models.scenes import CORNELL, PRISM, build_scene, build_tri_field, scene_camera, with_bvh
    from spectral_tpu_torch.ops.cuda import build
    from spectral_tpu_torch.ops.cuda.intersect_kernel import intersect
    from spectral_tpu_torch.ops.cuda.render_kernel import pack_scene_frame, render_rays_reference
    from spectral_tpu_torch.ops.cuda.render_kernel import render_chunk as kernel_chunk
    from spectral_tpu_torch.ops.intersect import nearest_hit
    from spectral_tpu_torch.parallel import render_image_sharded, train_step
    from spectral_tpu_torch.render import wavefront

    cornell = build_scene(CORNELL, dev)
    w, h, spp, b = XLA_W, XLA_H, XLA_SPP, XLA_BOUNCES
    cam = scene_camera(CORNELL, w, h, dev)
    nominal = w * h * spp * b
    for k in build.KERNELS.values():
        k.launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.no_grad():
        start.record()
        xyz = wavefront.render_chunk(cornell, cam, 1984, 0, 0, w, h, spp, b)
        end.record()
        torch.cuda.synchronize()
    launches = {k.name: k.launches for k in build.KERNELS.values() if k.launches}
    first_ms = start.elapsed_time(end)
    if launches.get("intersect") != spp * b or len(launches) != 1:
        raise SystemExit(f"XLA-style render: launches {launches}, not one intersect launch a sample and bounce")
    with torch.no_grad():
        start.record()
        wavefront.render_chunk(cornell, cam, 1984, 0, 0, w, h, spp, b)
        end.record()
        torch.cuda.synchronize()
        x_ms = start.elapsed_time(end)
        spans, first_call = [], []

        def timed(o, d, tri):
            if not first_call:
                first_call.append((o, d, tri))
            a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = intersect(o, d, tri, xla=True)
            z.record()
            spans.append((a, z))
            return out

        start.record()
        timed_xyz = wavefront.render_chunk(cornell, cam, 1984, 0, 0, w, h, spp, b, select=timed)
        end.record()
        torch.cuda.synchronize()
        timed_ms = start.elapsed_time(end)
        b1_ms = sum(a.elapsed_time(z) for a, z in spans)
        t0 = time.perf_counter()
        plain = wavefront.render_chunk(cornell, cam, 1984, 0, 0, w, h, spp, b,
                                       select=lambda o, d, t: nearest_hit(o, d, t, xla=True))
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    if not (torch.equal(xyz, plain) and torch.equal(xyz, timed_xyz)):
        raise SystemExit("XLA-style render: the intersect kernel's selection differs from the plain version's")
    lum = xyz[..., 1] / spp
    if not torch.isfinite(xyz).all() or float(lum.mean()) <= 0.0:
        raise SystemExit("XLA-style render: not finite or black")
    log(f"XLA-style render: Cornell {w}x{h}, {spp} spp, {b} bounces, no_grad: {x_ms} ms (first {first_ms} ms), "
        f"{nominal / x_ms / 1e3} nominal Mrays/s; launches {launches}; the intersect kernel {b1_ms} ms of a "
        f"{timed_ms} ms render with events around each selection ({b1_ms / timed_ms:.4f}); bit-equal to the "
        f"render with the plain selection ({plain_s} s); mean Y {float(lum.mean())}; {smi}")
    del xyz, plain, timed_xyz

    # the intersect kernel as the path launches it (xla=True: intersect_kernel<true, false>) on the path's
    # first selection (sample 0, bounce 0: the camera rays)
    po, pd, ptri = first_call[0]
    got = intersect(po, pd, ptri, xla=True)
    ref = nearest_hit(po, pd, ptri, xla=True)
    torch.cuda.synchronize()
    for a, z, what in zip(got, ref, ("t", "idx", "hit", "front")):
        if not torch.equal(a, z):
            raise SystemExit(f"intersect (xla order): {what} differs from the plain version")
    p_err = float((got[0] - ref[0]).abs().max())
    p_ms, p_host_us = device_ms(lambda: intersect(po, pd, ptri, xla=True), 20)
    p_b2b_ms = cuda_ms(lambda: intersect(po, pd, ptri, xla=True), 20)
    p_plain_ms = cuda_ms(lambda: nearest_hit(po, pd, ptri, xla=True), 3)
    p_n, p_t = po.shape[0], ptri.shape[0]
    p_bound, p_by = bound_ms(p_n * p_t * SWEEP_FLOPS_PER_TRI, 4 * ptri.numel() + p_n * (24 + 4 + 4 + 1 + 1))
    p_issue = intersect_issue_bound(p_n * p_t, "ILb1ELb0E")
    log(f"intersect kernel (xla order) on the path's first selection, {p_n} rays x {p_t} tris: t, idx, hit, front "
        f"equal ({int(ref[2].sum())} hits); device {p_ms} ms a call (queued behind a sleep), host {p_host_us} us a "
        f"call, back-to-back events {p_b2b_ms} ms; plain {p_plain_ms} ms; bound {p_bound} ms ({p_by}); issue bound "
        f"{p_issue['ms']} ms ({p_issue['per_test']} instructions a test in the SASS loop); {smi}")
    path_b1 = {"ms": p_ms, "host_us_per_call": p_host_us, "back_to_back_ms": p_b2b_ms, "plain_ms": p_plain_ms,
               "bound_ms": p_bound, "bound_by": p_by, "issue_bound": p_issue, "max_abs_err": p_err,
               "shape": f"{p_n} rays (the path's sample 0, bounce 0), {p_t} tris"}
    del first_call, po, pd, got, ref

    # the CLI through the XLA-style renderer
    for k in build.KERNELS.values():
        k.launches = 0
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            rc = cli.main(["--impl", "xla", "-xr", "256", "-ns", "16", "-bl", "8", "--save", "--no-show", "-t", "xla"])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            bmps = sorted(os.listdir("renders"))
            with open(os.path.join("renders", bmps[0]), "rb") as f:
                img = decode_bmp(f.read())
        finally:
            os.chdir(cwd)
    cli_launches = {k.name: k.launches for k in build.KERNELS.values() if k.launches}
    ilum = img.astype(np.float64).mean(-1)
    light = ilum[36:40, 118:138]  # inside the ceiling light (the 600x600 frame's rows 83-95, cols 270-330)
    log(f"CLI --impl xla: rc {rc}, 256x256, 16 spp, 8 bounces, {cli_s} s end to end, launches {cli_launches}, "
        f"image mean {ilum.mean():.1f}, ceiling-light region mean {light.mean():.1f}")
    if rc != 0 or cli_launches != {"intersect": 16 * 8} or img.shape != (256, 256, 3):
        raise SystemExit("CLI --impl xla did not render through the XLA-style renderer")
    if ilum.mean() < 5 or light.mean() < 200:
        raise SystemExit("CLI --impl xla: the image is black or unlit")

    # render_chunk_diff: the kernel forward, the XLA-style VJP backward
    cam256 = scene_camera(CORNELL, 256, 256, dev)
    d_spp, d_b = 16, 8
    keys = ("coeffs", "emission_power")
    leaves = {k: getattr(cornell.materials, k).clone().requires_grad_(True) for k in keys}
    mats = dc.replace(cornell.materials, **leaves)
    cot = torch.from_numpy(np.random.default_rng(5).normal(size=(256, 256, 3)).astype(np.float32)).to(dev)
    diff_ms, diff_mem, diff_launches = [], [], []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        for k in build.KERNELS.values():
            k.launches = 0
        start.record()
        out = render_chunk_diff(mats, cornell, cam256, 77, 0, 0, 256, 256, d_spp, d_b)
        fwd = {k.name: k.launches for k in build.KERNELS.values() if k.launches}
        for k in build.KERNELS.values():
            k.launches = 0
        grads = torch.autograd.grad((out * cot).sum(), list(leaves.values()))
        end.record()
        bwd = {k.name: k.launches for k in build.KERNELS.values() if k.launches}
        torch.cuda.synchronize()
        diff_ms.append(start.elapsed_time(end))
        diff_mem.append(torch.cuda.max_memory_allocated(dev) - base)
        diff_launches.append({"forward": fwd, "backward": bwd})
        # the backward traces each bounce twice: the XLA-style forward, and its recompute under the checkpoint
        if fwd != {"render": 1} or bwd != {"intersect": 2 * d_spp * d_b}:
            raise SystemExit(f"render_chunk_diff: launches {diff_launches[-1]}, not one render launch forward and "
                             f"two intersect launches a sample and bounce backward")
    # the forward against the plain render at the same seed and shape
    with torch.no_grad():
        d_mats = tabulate(dc.replace(cornell.materials, **{k: v.detach() for k, v in leaves.items()}))
        d_cam = camera_vector(cam256).to(dev)
        d_pack = pack_scene_frame(dc.replace(cornell, materials=d_mats), d_cam)
        if d_pack.leaf is not None:
            raise SystemExit("render_chunk_diff: Cornell packed into leaves")
        dpx, dpy = wavefront.chunk_pixels(0, 0, 256, 256, dev)
        t0 = time.perf_counter()
        d_plain = render_rays_reference(d_cam, 77, d_pack, dpx.float(), dpy.float(), d_spp, d_b,
                                        cam256.image_width).reshape(256, 256, 3)
        torch.cuda.synchronize()
        d_plain_s = time.perf_counter() - t0
    d_err = float((out.detach() - d_plain).abs().max())
    if not torch.equal(out.detach(), d_plain):
        raise SystemExit(f"render_chunk_diff: the forward differs from the plain render (max abs {d_err})")
    if not all(torch.isfinite(g).all() for g in grads) or float(grads[0].abs().max()) <= 0:
        raise SystemExit("render_chunk_diff: the gradient is not finite and nonzero")
    log(f"render_chunk_diff: Cornell 256x256, {d_spp} spp, {d_b} bounces, forward + backward {diff_ms} ms, peak "
        f"memory {[m / 2**20 for m in diff_mem]} MiB above the {base / 2**20:.1f} MiB held before; launches "
        f"{diff_launches[-1]}; the forward bit-equal to the plain render ({d_plain_s} s); |d/d coeffs| max "
        f"{float(grads[0].abs().max())}")
    diff_b2 = {"launches": diff_launches[-1]["forward"]["render"], "max_abs_err": d_err,
               "forward_and_backward_ms": diff_ms, "plain_s": d_plain_s,
               "shape": f"Cornell 256x256 px, {d_spp} spp, {d_b} bounces"}
    del out, grads, d_plain

    # the reparameterized PRISM gradient at inverse_dispersion.py's XLA shape
    prism = build_scene(PRISM, dev)
    pcam = scene_camera(PRISM, 32, 32, dev)
    sb = prism.materials.sellmeier_b.clone().requires_grad_(True)
    sc = prism.materials.sellmeier_c.clone().requires_grad_(True)
    pm = dc.replace(prism.materials, sellmeier_b=sb, sellmeier_c=sc)
    torch.cuda.reset_peak_memory_stats(dev)
    start.record()
    pimg = wavefront.render_chunk(dc.replace(prism, materials=pm), pcam, 9, 0, 0, 32, 16, 16, 6, reparam_glass=2)
    gb, gc = torch.autograd.grad(pimg[..., 1].sum() / 16, [sb, sc])
    end.record()
    torch.cuda.synchronize()
    log(f"PRISM Sellmeier gradient (reparam_glass 2, 32x16 of 32x32, 16 spp, 6 bounces): {start.elapsed_time(end)} "
        f"ms, peak memory {torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB; d(sum Y)/d B[2] = {gb[2].tolist()}, "
        f"d/d C[2] = {gc[2].tolist()}")
    if not (torch.isfinite(gb).all() and torch.isfinite(gc).all()) or float(gb[2].abs().max()) <= 0:
        raise SystemExit("PRISM Sellmeier gradient: not finite and nonzero")

    # three autograd train steps (examples/inverse_rendering.py's shape)
    tcam = scene_camera(CORNELL, 32, 32, dev)
    with torch.no_grad():
        target = render_image_sharded(cornell, tcam, 0, 8, 4) / 8
    params = {k: getattr(cornell.materials, k).clone() for k in keys}
    params["coeffs"][3, 2] += 1.5  # the white wall, as examples/inverse_rendering.py:51
    losses, step_ms = [], []
    for _ in range(3):
        start.record()
        params, loss = train_step(params, cornell, tcam, target, 0, 8, 4, lr=XLA_TRAIN_LR)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(loss))
    log(f"autograd train_step: Cornell 32x32, 8 spp, 4 bounces, lr {XLA_TRAIN_LR}: ms per step {step_ms}, "
        f"loss {losses}")
    if not (losses[0] > losses[1] > losses[2]) or not all(torch.isfinite(v).all() for v in params.values()):
        raise SystemExit("autograd train_step: the loss did not fall")

    # the LBVH walk against the dense selection, same draws
    field = build_tri_field(10008, 0, device=dev)
    t0 = time.perf_counter()
    accel = with_bvh(field, 8)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    fcam = scene_camera(CORNELL, FIELD_W, FIELD_H, dev)
    x0, y0 = (FIELD_W - 64) // 2, (FIELD_H - 32) // 2
    with torch.no_grad():
        start.record()
        walked = wavefront.render_chunk(accel, fcam, 5, x0, y0, 64, 32, 2, 3)
        end.record()
        torch.cuda.synchronize()
        bvh_ms = start.elapsed_time(end)
        start.record()
        dense = wavefront.render_chunk(field, fcam, 5, x0, y0, 64, 32, 2, 3)
        end.record()
        torch.cuda.synchronize()
        dense_ms = start.elapsed_time(end)
    close = float(torch.isclose(walked, dense, rtol=2e-4, atol=1e-5).float().mean())
    log(f"LBVH: build_tri_field(10008, 0) ({field.num_tris} tris), {accel.bvh.leaf_start.shape[0]} leaves of 8 "
        f"(built in {build_s} s); 64x32 crop, 2 spp, 3 bounces: walk {bvh_ms} ms, dense {dense_ms} ms; "
        f"{close:.6f} of values within rtol 2e-4 / atol 1e-5; mean Y {float(dense[..., 1].mean())}")
    if close <= 0.99 or float(dense.abs().max()) <= 0:
        raise SystemExit("LBVH render differs from the dense render")
    del accel, field, walked, dense

    # the parity contract of the kernel and XLA-style renderers
    parity = {}
    n, pspp, pb = PARITY_SIZE, PARITY_SPP, PARITY_BOUNCES
    t0 = time.perf_counter()
    for sid, sname in ((CORNELL, "cornell"), (PRISM, "prism")):
        scene = build_scene(sid, dev)
        pc = scene_camera(sid, n, n, dev)
        with torch.no_grad():
            def xla_img(base):
                acc = 0
                for i in range(pspp // PARITY_CHUNK):
                    acc = acc + wavefront.render_chunk(scene, pc, base + i, 0, 0, n, n, PARITY_CHUNK, pb)
                return (acc / pspp).cpu().numpy()

            x1, x2 = xla_img(100), xla_img(900)
            p1 = (kernel_chunk(scene, pc, 4242, 0, 0, n, n, pspp, pb) / pspp).cpu().numpy()
        noise = block_rel(x1, x2)
        cross = block_rel(p1, 0.5 * (x1 + x2))
        lum = float(p1[..., 1].mean() / max(0.5 * (x1 + x2)[..., 1].mean(), 1e-9))
        parity[sname] = {"cross": cross, "noise": noise, "ratio": cross / noise, "lum": lum}
    log(f"parity contract, {n}x{n}, {pspp} spp, {pb} bounces (kernel vs XLA-style; XLA-style reseeded): {parity}, "
        f"{time.perf_counter() - t0} s")
    for sname, v in parity.items():
        if not (v["ratio"] <= PARITY_RATIO and abs(v["lum"] - 1.0) <= PARITY_LUM):
            raise SystemExit(f"parity contract broken on {sname}: {v}")
    return {"launches": launches["intersect"], "render_ms": x_ms, "intersect_ms": b1_ms, "timed_render_ms": timed_ms,
            "share": b1_ms / timed_ms, "mrays": nominal / x_ms / 1e3, "path_intersect": path_b1, "diff": diff_b2,
            "diff_ms": diff_ms, "diff_peak_bytes": diff_mem,
            "lbvh_ms": bvh_ms, "parity": parity}


# the warp phase (13): the JAX suite's statistical checks (tests/test_diff.py
# TestVertexWarp, TestFuzzWarp), each with its scene, loss, spp, bounces, K
# and band; the signs of the JAX suite's rademacher weights, W =
# rademacher(PRNGKey(42), 256) of the fuzz check and the 8 x 8 block signs
# 2 bernoulli(PRNGKey(7), 0.5) - 1 of the full-width case, as hex bits
FUZZ_W_HEX = "8a222eb193a459cdd7668e1a933c91e44ca8c361a99a316ed8f9c3e88cb12d8b"
BLOCK_W_HEX = "33e5a65569b2f89b"
# the full-width case (scratch/r5_vwarp_chip.py:40-95): the 520-triangle
# all-diffuse field at 64x64, 8 spp, 3 bounces, every box moving in +x,
# 8 x 8 block-constant weights, gradients at th = 0; the seconds of
# estimates a route (30, down from 60 with phase 14's ~70 s: the whole
# script took ~600 s on a slow host with 60)
WARP_SIZE, WARP_SPP, WARP_BOUNCES, WARP_BLOCK, WARP_SECONDS = 64, 8, 3, 8, 30.0


def signs(hex_bits: str) -> np.ndarray:
    return 2.0 * np.unpackbits(np.frombuffer(bytes.fromhex(hex_bits), np.uint8)).astype(np.float32) - 1.0


def screen_scene(dev):
    """tests/test_diff.py:739's screen scene: a dark quad before an
    emissive one, 16x16; its moving triangles start at 2."""
    from spectral_tpu_torch.models.camera import make_camera
    from spectral_tpu_torch.models.geometry import TriSoup
    from spectral_tpu_torch.models.materials import MaterialBuilder
    from spectral_tpu_torch.models.scenes import scene_from_soup

    mb = MaterialBuilder()
    dark = mb.lambertian((0.1, 0.1, 0.1))
    light = mb.emissive((1.0, 1.0, 1.0), 4.0)
    soup = TriSoup()
    soup.quad((-4.0, -4.0, 3.0), (8.0, 0.0, 0.0), (0.0, 8.0, 0.0), light)
    soup.quad((-3.0, -2.0, 1.0), (3.0, 0.0, 0.0), (0.0, 4.0, 0.0), dark)
    cam = make_camera(16, 16, vfov=60.0, lookfrom=(0, 0, -2), lookat=(0, 0, 0), device=dev)
    return scene_from_soup(soup, mb.build(), dev), cam


def vertex_grad(scene, cam, first: int, key: int, spp: int, bounces: int, warp: bool, weights=None, frame=None,
                select=None) -> float:
    """d loss / d th at th = 0, the triangles from ``first`` on moving by th
    in +x (test_diff.py:775-791): loss = sum(w * Y) of the accumulated XYZ
    (w = 1 by default), with the warp's edges those of the live vertices."""
    from spectral_tpu_torch.diff import scene_with_vertices
    from spectral_tpu_torch.diff.vertex_warp import edges_from_vertices
    from spectral_tpu_torch.render import wavefront

    dev = scene.v0.device
    move = (torch.arange(scene.num_tris, device=dev) >= first).float()[:, None] * torch.tensor([1.0, 0.0, 0.0],
                                                                                             device=dev)
    th = torch.zeros((), device=dev, requires_grad=True)
    vs = [getattr(scene, k) + th * move for k in ("v0", "v1", "v2")]
    x0, y0, w, h = frame or (0, 0, cam.image_width, cam.image_height)
    out = wavefront.render_chunk(scene_with_vertices(scene, *vs), cam, key, x0, y0, w, h, spp, bounces,
                                 vertex_warp=edges_from_vertices(*vs) if warp else None, select=select)
    y = out[..., 1].reshape(-1)
    loss = (y if weights is None else y * weights).sum()
    if not loss.requires_grad:
        return 0.0
    return float(torch.autograd.grad(loss, th, allow_unused=True, materialize_grads=True)[0])


def fuzz_grad(prob, weights, key: int, warp: bool) -> float:
    """d sum(W * Y) / d fuzz at 0.25 on the fuzz scene, 4 spp, 2 bounces
    (test_diff.py:1008-1027)."""
    from spectral_tpu_torch.render import wavefront

    f = torch.tensor(0.25, device=weights.device, requires_grad=True)
    mats = prob.scene.materials
    s = dataclasses.replace(prob.scene, materials=dataclasses.replace(
        mats, fuzz=torch.where(prob.hot.bool(), f, mats.fuzz)))
    xyz = wavefront.render_tile_xyz(s, prob.cam, prob.px, prob.py, key, 4, 2,
                                    fuzz_warp=prob.edges if warp else None)
    loss = (weights * xyz[:, 1]).sum()
    if not loss.requires_grad:
        return 0.0
    return float(torch.autograd.grad(loss, f, allow_unused=True, materialize_grads=True)[0])


def nonrigid_grad(dev, key: int, n: int = 20000) -> float:
    """test_diff.py:851-919: one corner of a quad light skews while the
    others stay; the lambertian sphere warp of n cosine samples about y-hat
    at the origin, d mean(lit * factor) / d th at 0."""
    import math

    from spectral_tpu_torch.diff.vertex_warp import EdgeSet, warp_directions
    from spectral_tpu_torch.utils.prng import fold, generator

    zh, xe = 0.6, 0.5
    th = torch.zeros((), device=dev, requires_grad=True)
    one = torch.ones((), device=dev)
    c1 = torch.stack([xe + th, 2.0 * one, zh * one])
    c2 = torch.tensor([xe, 2.0, -zh], device=dev)
    c3 = torch.tensor([-1.5, 2.0, -zh], device=dev)
    c4 = torch.tensor([-1.5, 2.0, zh], device=dev)
    edges = EdgeSet(a=torch.stack([c2, c1, c4, c3]), b=torch.stack([c1, c4, c3, c2]))
    gen = generator(fold(0x5EED, key), dev)
    u1, u2 = torch.rand(n, generator=gen, device=dev), torch.rand(n, generator=gen, device=dev)
    rr, phi = torch.sqrt(u1), 2.0 * math.pi * u2
    nrm = torch.tensor([0.0, 1.0, 0.0], device=dev)
    w0 = torch.stack([rr * torch.cos(phi), torch.sqrt(torch.clamp_min(1.0 - u1, 0.0)), rr * torch.sin(phi)], -1)
    wp, factor = warp_directions(torch.zeros((n, 3), device=dev), nrm.expand(n, 3), w0, edges)
    t = 2.0 / torch.clamp_min(wp[:, 1], 1e-6)
    x, z = wp[:, 0] * t, wp[:, 2] * t
    xe_th = xe + th * (z + zh) / (2 * zh)
    lit = ((x <= xe_th) & (z.abs() <= zh) & (x >= -1.5) & (wp[:, 1] > 0)).float()
    return float(torch.autograd.grad((lit * factor).mean(), th)[0])


def band_check(name: str, fn, k: int, check) -> dict:
    """k estimates fn(i), their mean and sem, held to check(mean, sem)."""
    t0 = time.perf_counter()
    ads = np.array([fn(i) for i in range(k)])
    secs = time.perf_counter() - t0
    mean, sem = float(ads.mean()), float(ads.std() / np.sqrt(k))
    ok, band = check(mean, sem)
    log(f"  {name}: K={k}, AD mean {mean} +- {sem} (sem), band {band}: {'ok' if ok else 'OUT'} ({secs:.1f} s)")
    if not np.all(np.isfinite(ads)) or not ok:
        raise SystemExit(f"warp check {name} failed: mean {mean} +- {sem}, band {band}")
    return {"k": k, "mean": mean, "sem": sem, "band": band, "s": secs}


def warp_phase(dev, smi: str) -> dict:
    """Phase 13: the warp estimators on the card. Returns what the kernels
    line and PERF.md report."""
    from spectral_tpu_torch.diff import vertex_warp
    from spectral_tpu_torch.diff.vertex_warp import edges_from_vertices
    from spectral_tpu_torch.examples import inverse_fuzz, inverse_geometry
    from spectral_tpu_torch.models.scenes import CORNELL, build_diffuse_field, build_scene, scene_camera, with_bvh
    from spectral_tpu_torch.ops.cuda import build
    from spectral_tpu_torch.ops.cuda.intersect_kernel import intersect
    from spectral_tpu_torch.render import wavefront

    out = {}
    # launch counts around one warped gradient at the example's shape
    shadow, scam = inverse_geometry.build(dev)
    for k in build.KERNELS.values():
        k.launches = 0
    g = vertex_grad(shadow, scam, inverse_geometry.FIRST_OCCLUDER_TRI, 1, inverse_geometry.SPP,
                    inverse_geometry.BOUNCES, True)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in build.KERNELS.values() if k.launches}
    spp = inverse_geometry.SPP
    passes = -(-spp // wavefront.samples_per_pass(16 * 16, spp))
    want = 2 * passes * inverse_geometry.BOUNCES
    log(f"warped gradient, shadow scene 16x16, {spp} spp ({passes} pass of render_tile_xyz), "
        f"{inverse_geometry.BOUNCES} bounces: d/dth {g}, launches {launches}")
    if launches != {"intersect": want} or not np.isfinite(g):
        raise SystemExit(f"warped gradient: launches {launches}, not {want} intersect launches (a pass and bounce "
                         "forward, and again in the checkpoint's recompute)")
    out["launches"], out["passes"] = launches["intersect"], passes

    # the JAX suite's statistical checks
    t0 = time.perf_counter()
    screen, ccam = screen_scene(dev)
    stats = {}
    stats["screen"] = band_check(
        "screen silhouette (-4737)", lambda i: vertex_grad(screen, ccam, 2, i, 4, 2, True), 48,
        lambda m, e: (m < 0 and abs(m) > 5 * e and 0.90 * 4737 - 3 * e <= -m <= 1.06 * 4737 + 3 * e,
                      [0.90 * 4737 - 3 * e, 1.06 * 4737 + 3 * e]))
    stats["shadow"] = band_check(
        "shadow (-934)", lambda i: vertex_grad(shadow, scam, 4, i, 4, 3, True), 48,
        lambda m, e: (m < 0 and abs(m) > 3 * e and 0.80 * 934 - 3 * e <= -m <= 1.20 * 934 + 3 * e,
                      [0.80 * 934 - 3 * e, 1.20 * 934 + 3 * e]))
    stats["nonrigid"] = band_check(
        "non-rigid corner (+0.0403)", lambda i: nonrigid_grad(dev, i), 12,
        lambda m, e: (m > 0 and m > 5 * e and abs(m - 0.0403) < 0.15 * 0.0403 + 3 * e,
                      [0.0403 - 0.15 * 0.0403 - 3 * e, 0.0403 + 0.15 * 0.0403 + 3 * e]))
    fprob = inverse_fuzz.Problem(dev)
    fw = torch.from_numpy(signs(FUZZ_W_HEX)).to(dev)
    stats["fuzz"] = band_check(
        "fuzz (-522)", lambda i: fuzz_grad(fprob, fw, i, True), 160,
        lambda m, e: (m < 0 and abs(m) > 2 * e and 0.3 * 522 - 3 * e <= -m <= 2.0 * 522 + 3 * e,
                      [0.3 * 522 - 3 * e, 2.0 * 522 + 3 * e]))
    # the primal identities, and the plain estimator's zero gradients
    cornell = build_scene(CORNELL, dev)
    ccam16 = scene_camera(CORNELL, 16, 16, dev)
    with torch.no_grad():
        base = wavefront.render_chunk(cornell, ccam16, 11, 0, 0, 16, 16, 2, 3)
        warped = wavefront.render_chunk(cornell, ccam16, 11, 0, 0, 16, 16, 2, 3,
                                        vertex_warp=edges_from_vertices(cornell.v0, cornell.v1, cornell.v2))
        f0 = torch.tensor(0.25, device=dev)
        fplain, fwarped = fprob.render(f0, 0, False), fprob.render(f0, 0, True)
    vid = float((base - warped).abs().max())
    fid = float((fplain - fwarped).abs().max())
    floss = (float((fw * fplain[:, 1]).sum()), float((fw * fwarped[:, 1]).sum()))
    zero_v = vertex_grad(screen, ccam, 2, 0, 4, 2, False)
    zero_f = fuzz_grad(fprob, fw, 0, False)
    log(f"  primal identities: Cornell 16x16, 2 spp, 3 bounces, warped vs plain max-abs {vid}; fuzz scene {fid} "
        f"(weighted loss plain, warped: {floss}); plain estimator's vertex gradient {zero_v}, fuzz gradient "
        f"{zero_f}")
    if not (vid < 2e-5 and fid < 2e-5 and zero_v == 0.0 and zero_f == 0.0 and float(base.max()) > 1.0):
        raise SystemExit("warp primal identities or zero plain gradients broken")
    out.update(stats=stats, identity_cornell=vid, identity_fuzz=fid, fuzz_losses=floss,
               checks_s=time.perf_counter() - t0)

    # both examples in full
    for name, mod in (("inverse_geometry", inverse_geometry), ("inverse_fuzz", inverse_fuzz)):
        t0 = time.perf_counter()
        try:
            res = mod.main(device=dev, log=lambda m, name=name: log(f"  {name}: {m}"))
        except AssertionError as e:
            raise SystemExit(f"{name}: {e}")
        out[name] = dict(res, s=time.perf_counter() - t0, steps=mod.STEPS)
        log(f"  {name}: {mod.STEPS} steps in {out[name]['s']:.1f} s")

    # the full-width case, through the LBVH and through the dense intersect
    field = build_diffuse_field(520, 0, dev)
    accel = with_bvh(field, 8)
    fcam = scene_camera(CORNELL, WARP_SIZE, WARP_SIZE, dev)
    n_walls, size, spp, b = 12, WARP_SIZE, WARP_SPP, WARP_BOUNCES
    blocks = signs(BLOCK_W_HEX).reshape(size // WARP_BLOCK, size // WARP_BLOCK)
    wts = torch.from_numpy(np.repeat(np.repeat(blocks, WARP_BLOCK, 0), WARP_BLOCK, 1).reshape(-1)).to(dev) / spp
    spans = {"b1": [], "warp": []}

    def timed(kind, fn):
        def wrapped(*a, **k):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            r = fn(*a, **k)
            e1.record()
            spans[kind].append((e0, e1))
            return r
        return wrapped

    b1 = timed("b1", lambda o, d, t: intersect(o, d, t, xla=True))
    same = [vertex_grad(sc, fcam, n_walls, 0, spp, b, True, wts) for sc in (accel, field)]
    log(f"  full width, the same draws: LBVH {same[0]}, dense {same[1]}")
    if not np.isclose(same[0], same[1], rtol=2e-4, atol=0.0):
        raise SystemExit(f"full-width warped gradient: LBVH {same[0]} vs dense {same[1]} on the same draws")
    full = {"same_draws": same, "tris": field.num_tris}
    originals = vertex_warp.warp_directions, vertex_warp.warp_pixel_samples
    for route, scene in (("lbvh", accel), ("dense", field)):
        sel = b1 if route == "dense" else None
        vertex_grad(scene, fcam, n_walls, 1, spp, b, True, wts, select=sel)  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for v in spans.values():
            v.clear()
        vertex_warp.warp_directions = timed("warp", originals[0])
        vertex_warp.warp_pixel_samples = timed("warp", originals[1])
        try:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            vertex_grad(scene, fcam, n_walls, 2, spp, b, True, wts, select=sel)
            e1.record()
            torch.cuda.synchronize()
        finally:
            vertex_warp.warp_directions, vertex_warp.warp_pixel_samples = originals
        ms = e0.elapsed_time(e1)
        r = {"ms": ms, "peak_bytes": torch.cuda.max_memory_allocated(),
             "warp_fwd_ms": sum(a.elapsed_time(z) for a, z in spans["warp"]), "warp_calls": len(spans["warp"])}
        if route == "dense":
            r.update(b1_ms=sum(a.elapsed_time(z) for a, z in spans["b1"]), b1_calls=len(spans["b1"]))
        ads, t0 = [], time.perf_counter()
        while time.perf_counter() - t0 < WARP_SECONDS:
            ads.append(vertex_grad(scene, fcam, n_walls, 100 + len(ads), spp, b, True, wts, select=sel))
        ads = np.array(ads)
        r.update(k=len(ads), mean=float(ads.mean()), sem=float(ads.std() / np.sqrt(len(ads))),
                 s_per_estimate=(time.perf_counter() - t0) / len(ads))
        if not (np.all(np.isfinite(ads)) and r["mean"] != 0.0):
            raise SystemExit(f"full-width warped gradient ({route}): estimates not finite or mean zero")
        full[route] = r
        log(f"  full width ({route}): {field.num_tris} tris, {size}x{size}, {spp} spp, {b} bounces: {r}")
    out["full_width"] = full
    log(f"  {smi}")
    return out


# ---- phase 15: the last examples, and the general-colour rgb2spec -------------
# the colours of the stored rgb2spec case (tests/torch_jax_refs.py): 32 of
# seed 5 in [0.05, 0.95], four grays and the three primaries
RGB2SPEC_SEED, RGB2SPEC_GRAYS = 5, (0.0, 0.25, 0.73, 1.0)
# the XLA-style dispersion's steps inside the script, of the example's 260
# (8 estimates a step): a full run does not fit the script's time
DISP_XLA_STEPS = 8


def rgb2spec_on_card(dev) -> dict:
    """lookup_sigmoid_coeffs and the LM fit on CUDA tensors against their
    CPU results: the table within rtol 1e-5 / atol 1e-6, the fit's SPDs
    within 1e-4 and its raw coefficients (grays excepted) at rtol 1e-3."""
    from spectral_tpu_torch.ops import rgb2spec

    rng = np.random.default_rng(RGB2SPEC_SEED)
    grays = np.repeat(np.asarray(RGB2SPEC_GRAYS)[:, None], 3, axis=1)
    rgb = torch.from_numpy(np.concatenate([rng.uniform(0.05, 0.95, (32, 3)), grays, np.eye(3)]).astype(np.float32))
    colour = ~((rgb[:, 0] == rgb[:, 1]) & (rgb[:, 1] == rgb[:, 2]))
    out = {}
    for name, fn in (("lookup", rgb2spec.lookup_sigmoid_coeffs), ("lm_fit", rgb2spec.lm_fit_coeffs)):
        host = fn(rgb)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = fn(rgb.to(dev))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        card = card.cpu()
        spd = float((rgb2spec.spd_from_coeffs_reflectance(card) - rgb2spec.spd_from_coeffs_reflectance(host))
                    .abs().max())
        rel = float(((card - host).abs() / host.abs().clamp_min(1e-30))[colour].max())
        out[name] = {"ms": ms, "spd_max_abs": spd, "coeff_max_rel": rel}
        ok = (torch.allclose(card, host, rtol=1e-5, atol=1e-6) if name == "lookup"
              else spd <= 1e-4 and rel <= 1e-3)
        log(f"  rgb2spec {name} of {rgb.shape[0]} colours on the card vs the CPU: {out[name]}")
        if not ok or not torch.isfinite(card).all():
            raise SystemExit(f"rgb2spec {name}: the card's coefficients differ from the CPU's")
    return out


def examples_phase(dev, smi: str) -> dict:
    """Phase 15: the general-colour rgb2spec on the card, then
    examples/inverse_field.py and examples/inverse_dispersion.py (fused in
    full, XLA-style for DISP_XLA_STEPS steps) as a user runs them, their
    gates raised, their launches counted. Returns what the kernels line and
    PERF.md report."""
    from spectral_tpu_torch.examples import inverse_dispersion, inverse_field
    from spectral_tpu_torch.ops.cuda import build
    from spectral_tpu_torch.render import wavefront

    def counted(name, fn):
        for k in build.KERNELS.values():
            k.launches = 0
        t0 = time.perf_counter()
        try:
            res = fn(lambda m: log(f"  {name}: {m}"))
        except AssertionError as e:
            raise SystemExit(f"{name}: {e}")
        torch.cuda.synchronize()
        res["s"] = time.perf_counter() - t0
        res["launches"] = {k.name: k.launches for k in build.KERNELS.values() if k.launches}
        return res

    out = {"rgb2spec": rgb2spec_on_card(dev)}
    # the field: a target render, then a sorted residual forward and a replay a step
    steps = inverse_field.STEPS
    res = counted("inverse_field", lambda lg: inverse_field.main(steps, dev, log=lg))
    b = inverse_field.BOUNCES
    want = {"wavefront_camera": steps + 1, "wavefront_bounce": (steps + 1) * (b - 1),
            "wavefront_integrate": steps + 1, "grad": steps}
    log(f"inverse_field: {res['n_tris']} tris, {inverse_field.SIZE}x{inverse_field.SIZE // 2}, {inverse_field.SPP} "
        f"spp, {b} bounces, {steps} steps in {res['s']:.1f} s ({res['setup_s']:.1f} s scene and target): "
        f"{res['ms_per_step']} ms a step, {res['recovered']:.1f}% recovered, launches {res['launches']}")
    if res["launches"] != want:
        raise SystemExit(f"inverse_field: launches {res['launches']}, not {want}")
    res.pop("losses")
    out["inverse_field"] = res
    # the dispersion, fused: two render launches (the CRN pair), a residual
    # launch and a replay an estimate
    steps, m = inverse_dispersion.STEPS, inverse_dispersion.M
    res = counted("inverse_dispersion fused", lambda lg: inverse_dispersion.main("fused", steps, dev, log=lg))
    n = steps * m
    want = {"render": 2 * n, "render_residuals": n, "grad": n}
    log(f"inverse_dispersion --impl fused: {steps} steps of {m} estimates in {res['s']:.1f} s, "
        f"{res['ms_per_estimate']} ms an estimate, |B0 - B0*| {res['err0']:.4f} -> {res['err']:.4f} "
        f"({100 * res['recovered']:.1f}% recovered), launches {res['launches']}")
    if res["launches"] != want:
        raise SystemExit(f"inverse_dispersion fused: launches {res['launches']}, not {want}")
    out["inverse_dispersion_fused"] = {k: v for k, v in res.items() if k != "errs"}
    # the dispersion, XLA-style: an intersect launch a pass and bounce in each
    # CRN render, and forward and in the checkpoint's recompute in the factor
    steps = DISP_XLA_STEPS
    res = counted("inverse_dispersion xla", lambda lg: inverse_dispersion.main("xla", steps, dev, log=lg))
    size, spp = inverse_dispersion.IMPLS["xla"]
    px = size * (size // 2)
    passes = -(-spp // wavefront.samples_per_pass(px, spp))
    n = steps * m
    want = {"intersect": 4 * passes * inverse_dispersion.BOUNCES * n}
    log(f"inverse_dispersion --impl xla: {steps} of {inverse_dispersion.STEPS} steps ({n} estimates) in "
        f"{res['s']:.1f} s, {res['ms_per_step']} ms a step, |B0 - B0*| {res['err0']:.4f} -> {res['err']:.4f} "
        f"(not gated), launches {res['launches']}")
    if res["launches"] != want or not np.isfinite(res["err"]):
        raise SystemExit(f"inverse_dispersion xla: launches {res['launches']}, not {want}, or B0 not finite")
    out["inverse_dispersion_xla"] = {k: v for k, v in res.items() if k != "errs"}
    log(f"  {smi}")
    return out


# ---- phase 14: the sharded paths on torch.distributed ------------------------
# the default frame (config.py:25-33) and phase 12's training shape
# (examples/inverse_rendering.py), with the seeds of phase 14's paths
PAR_SIZE, PAR_SPP, PAR_BOUNCES, PAR_SEED = 600, 500, 10, 2024
XLA_TRAIN = (32, 8, 4)
# the meshes of the two-rank gloo world, which share the one card, and the
# time each world has
GLOO_MESHES = ((2, 1), (1, 2))
WORLD_SECONDS = 400
# the share of the white wall's SPD error that examples/inverse_rendering.py
# must take away in its 120 steps. Its own verdict (SPD error under 0.03,
# printed) is not a reliable gate: JAX's example ends at 0.0315, 0.0316,
# 0.0346 and 0.0258 (84-88% recovered) on 1, 2, 4 and 8 CPU devices
EXAMPLE_SHARE = 0.8
# the XLA-style paths and the losses against their composition (relative
# to the largest value)
PAR_XLA_REL, PAR_LOSS_REL = 1e-6, 1e-6


def par_problem(dev) -> dict:
    """Phase 14's scenes, cameras, targets and starting parameters, built
    the same in every process: Cornell and the 10k field; the default
    frame, the field frame, the training frame and the XLA-style training
    shape; targets rendered on one device at the true materials; the white
    (Cornell's wall 3, the field's material 0) third coefficient + 1.5."""
    from spectral_tpu_torch.models.scenes import CORNELL, build_scene, build_tri_field, scene_camera
    from spectral_tpu_torch.parallel import render_image_sharded, render_image_sharded_pallas

    size, spp, bounces = XLA_TRAIN
    p = {"cornell": build_scene(CORNELL, dev), "field": build_tri_field(FIELD_TRIS, 0, device=dev),
         "cam": scene_camera(CORNELL, PAR_SIZE, PAR_SIZE, dev), "fcam": scene_camera(CORNELL, FIELD_W, FIELD_H, dev),
         "tcam": scene_camera(CORNELL, TRAIN_W, TRAIN_H, dev), "xcam": scene_camera(CORNELL, size, size, dev)}
    with torch.no_grad():
        p["t_target"] = render_image_sharded_pallas(p["cornell"], p["tcam"], TRAIN_SEED, TRAIN_SPP,
                                                    TRAIN_BOUNCES) / TRAIN_SPP
        p["f_target"] = render_image_sharded_pallas(p["field"], p["fcam"], FIELD_SEED, FIELD_SPP,
                                                    FIELD_BOUNCES) / FIELD_SPP
        p["x_target"] = render_image_sharded(p["cornell"], p["xcam"], 0, spp, bounces) / spp
    for name, scene, row in (("t_params", "cornell", 3), ("f_params", "field", 0), ("x_params", "cornell", 3)):
        p[name] = {k: getattr(p[scene].materials, k).clone() for k in ("coeffs", "emission_power")}
        p[name]["coeffs"][row, 2] += 1.5
    return p


def par_renders(p) -> dict:
    """The image paths: name -> (scene, camera, seed or key, spp, bounces,
    sched; None for the XLA-style renderer)."""
    size, spp, bounces = XLA_TRAIN
    return {
        "render": (p["cornell"], p["cam"], PAR_SEED, PAR_SPP, PAR_BOUNCES, "sorted"),
        "field_sorted": (p["field"], p["fcam"], FIELD_SEED, FIELD_SPP, FIELD_BOUNCES, "sorted"),
        "field_mega": (p["field"], p["fcam"], FIELD_SEED, FIELD_SPP, FIELD_BOUNCES, "mega"),
        "xla_render": (p["cornell"], p["xcam"], 0, spp, bounces, None),
    }


def par_steps(p) -> dict:
    """The training paths: name -> (params, scene, camera, target, seed or
    key, spp, bounces, lr, sched; None for the autograd train_step)."""
    size, spp, bounces = XLA_TRAIN
    t = (p["cornell"], p["tcam"], p["t_target"], TRAIN_SEED, TRAIN_SPP, TRAIN_BOUNCES, TRAIN_LR)
    f = (p["field"], p["fcam"], p["f_target"], FIELD_SEED, FIELD_SPP, FIELD_BOUNCES, FIELD_LR)
    return {
        "fused_cornell": (p["t_params"], *t, "sorted"),
        "fused_field": (p["f_params"], *f, "sorted"),
        "fused_field_mega": (p["f_params"], *f, "mega"),
        "xla_train": (p["x_params"], p["cornell"], p["xcam"], p["x_target"], 1, spp, bounces, XLA_TRAIN_LR, None),
    }


def par_timed(mesh, fn):
    """fn()'s value and, on this rank: its ms from CUDA events, the count
    and host ms of its ``mesh.all_reduce`` spans (recorded around fn()), the
    peak memory and the launches of each kernel."""
    from spectral_tpu_torch.ops.cuda import build
    from spectral_tpu_torch.utils import trace

    for k in build.KERNELS.values():
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trace.reset()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with trace.recording():
        start.record()
        value = fn()
        end.record()
    torch.cuda.synchronize()
    s = trace.summary()
    reduce = s["spans"].get("mesh.all_reduce", {"count": 0, "total_s": 0.0})
    return value, {
        "ms": start.elapsed_time(end),
        "all_reduce_host_ms": 1e3 * reduce["total_s"],
        "all_reduces": reduce["count"],
        "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
        "launches": s["launches"],
    }


def all_reduce_spans(res, name) -> list:
    """Each rank's (count, host ms) of path ``name``'s mesh.all_reduce spans."""
    return [(r[name]["stats"]["all_reduces"], r[name]["stats"]["all_reduce_host_ms"]) for r in res]


def par_twice(mesh, fn):
    """fn()'s first value, with the par_timed stats of a second call and
    the first call's ms and all-reduce host ms (which hold the warm-up: lazy
    CUDA modules, a backend's first communicator)."""
    value, first = par_timed(mesh, fn)
    _, stats = par_timed(mesh, fn)
    stats.update(first_ms=first["ms"], first_all_reduce_host_ms=first["all_reduce_host_ms"])
    return value, stats


def par_run(p, mesh) -> dict:
    """Every path of phase 14 twice on ``mesh`` (None: one device, no
    process group): the value of the first call (on the host) and the
    par_twice stats; for the training paths also the loss and the
    gradients of the step (``fused_loss_and_grads`` / ``loss_and_grads``,
    run after the timed steps)."""
    from spectral_tpu_torch.parallel import (
        fused_loss_and_grads, loss_and_grads, render_image_sharded, render_image_sharded_pallas, train_step,
        train_step_fused,
    )

    out = {}
    for name, (scene, cam, seed, spp, bounces, sched) in par_renders(p).items():
        if sched is None:
            fn = lambda: render_image_sharded(scene, cam, seed, spp, bounces, mesh=mesh)  # noqa: E731
        else:
            fn = lambda: render_image_sharded_pallas(scene, cam, seed, spp, bounces, mesh=mesh, sched=sched)  # noqa: E731
        with torch.no_grad():
            img, stats = par_twice(mesh, fn)
        out[name] = {"image": img.cpu(), "stats": stats}
    for name, (params, scene, cam, target, seed, spp, bounces, lr, sched) in par_steps(p).items():
        if sched is None:
            fn = lambda: train_step(params, scene, cam, target, seed, spp, bounces, lr, mesh=mesh)  # noqa: E731
            grad_fn = lambda: loss_and_grads(params, scene, cam, target, seed, spp, bounces, mesh=mesh)  # noqa: E731
        else:
            fn = lambda: train_step_fused(params, scene, cam, target, seed, spp, bounces, lr, mesh=mesh,  # noqa: E731
                                          sched=sched)
            grad_fn = lambda: fused_loss_and_grads(params, scene, cam, target, seed, spp, bounces,  # noqa: E731
                                                   mesh=mesh, sched=sched)
        (new, loss), stats = par_twice(mesh, fn)
        g_loss, grads = grad_fn()
        out[name] = {"loss": float(loss), "grad_loss": float(g_loss), "grads": {k: g.cpu() for k, g in grads.items()},
                     "finite": bool(all(torch.isfinite(v).all() for v in new.values())), "stats": stats}
    return out


def par_example(mesh, dev, log) -> dict:
    """examples/inverse_rendering.py in full on ``mesh`` (None: ``dev``),
    with its wall time."""
    from spectral_tpu_torch.examples import inverse_rendering

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = inverse_rendering.main(mesh=mesh, device=dev, log=log)
    torch.cuda.synchronize()
    return {"seconds": time.perf_counter() - t0, "spd_err0": r["spd_err0"], "spd_err": r["spd_err"],
            "share": 1.0 - r["spd_err"] / r["spd_err0"], "recovered": r["recovered"], "first_loss": r["losses"][0],
            "last_loss": r["losses"][-1]}


def rank_main(spec_path: str) -> int:
    """One rank of a phase-14 world (``--rank SPEC``): joins the world of
    SPECTRAL_COORD / SPECTRAL_NPROC / SPECTRAL_PROC_ID on the spec's
    backend, runs every path on each of the spec's meshes (the example too
    on the meshes the spec names) and saves what it got for the parent."""
    import torch.distributed as dist

    from spectral_tpu_torch.parallel import init_distributed, mesh_of_shape

    with open(spec_path) as f:
        spec = json.load(f)
    init_distributed(backend=spec["backend"], device=spec["device"])
    try:
        rank = dist.get_rank()
        dev = torch.device("cuda", rank % torch.cuda.device_count()) if spec["device"] == "cuda" else torch.device("cpu")
        p = par_problem(dev)
        out = {"rank": rank, "meshes": {}}
        for shape in spec["meshes"]:
            mesh = mesh_of_shape(*shape, device=dev)
            res = par_run(p, mesh)
            for name, r in res.items():
                log(f"{spec['backend']} rank {rank}, mesh {tuple(shape)}, {name}: {r['stats']}")
            if list(shape) in spec["example_meshes"]:
                res["example"] = par_example(mesh, dev, lambda *_: None)
                log(f"{spec['backend']} rank {rank}, mesh {tuple(shape)}, inverse_rendering: {res['example']}")
            out["meshes"][str(tuple(shape))] = res
        torch.save(out, os.path.join(spec["dir"], f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def spawn_world(n: int, backend: str, meshes, example_meshes, root: str, device: str = "cuda") -> list[dict]:
    """Runs ``n`` ranks of this script (``--rank``) on ``device`` in a world
    of ``backend`` with a file:// rendezvous, waits for all of them within
    WORLD_SECONDS, prints their logs and returns each rank's results.
    Exits if a rank fails or the time runs out; kills every rank it
    started either way."""
    d = tempfile.mkdtemp(prefix=f"world_{backend}_", dir=root)
    spec_path = os.path.join(d, "spec.json")
    with open(spec_path, "w") as f:
        json.dump({"backend": backend, "device": device, "meshes": [list(m) for m in meshes],
                   "example_meshes": [list(m) for m in example_meshes], "dir": d}, f)
    env = dict(os.environ, SPECTRAL_COORD=f"file://{d}/rendezvous", SPECTRAL_NPROC=str(n))
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for r in range(n):
            logs.append(open(os.path.join(d, f"rank{r}.log"), "w"))
            procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", spec_path],
                                          env=dict(env, SPECTRAL_PROC_ID=str(r)), stdout=logs[-1],
                                          stderr=subprocess.STDOUT))
        for p in procs:
            p.wait(timeout=max(1.0, WORLD_SECONDS - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    seconds = time.perf_counter() - t0
    for r in range(n):
        with open(os.path.join(d, f"rank{r}.log")) as f:
            text = f.read()
        for line in text.splitlines()[-60:]:
            log(f"  [{backend} rank {r}] {line}")
    if any(p.returncode != 0 for p in procs):
        raise SystemExit(f"phase 14: a rank of the {backend} world failed or ran out of time "
                         f"(exit codes {[p.returncode for p in procs]})")
    log(f"  {backend} world of {n}: {seconds} s, process start and the CUDA context included")
    return [torch.load(os.path.join(d, f"rank{r}.pt")) for r in range(n)]


def par_composed_image(name, spec, shape):
    """What one process composes from the shards' one-device renders: each
    tile's sample shards summed in rank order, the tiles stacked."""
    from functools import reduce

    from spectral_tpu_torch.ops.cuda.render_kernel import render_chunk
    from spectral_tpu_torch.parallel.render import RENDER_SEED_STRIDE
    from spectral_tpu_torch.render.wavefront import chunk_pixels, render_tile_xyz
    from spectral_tpu_torch.utils.prng import fold

    scene, cam, seed, spp, bounces, sched = spec
    nt, ns = shape
    h, w = cam.image_height, cam.image_width
    rows, lspp = h // nt, spp // ns
    tiles = []
    with torch.no_grad():
        for ti in range(nt):
            if sched is None:
                px, py = chunk_pixels(0, ti * rows, w, rows, scene.normal.device)
                parts = [render_tile_xyz(scene, cam, px, py, fold(seed, ti, si), lspp, bounces).reshape(rows, w, 3)
                         for si in range(ns)]
            else:
                parts = [render_chunk(scene, cam, seed + (ti * ns + si) * RENDER_SEED_STRIDE, 0, ti * rows, w, rows,
                                      lspp, bounces, sched=sched) for si in range(ns)]
            tiles.append(reduce(torch.add, parts))
    return torch.cat(tiles).cpu()


def par_composed_grads(spec, shape):
    """The true loss and gradient composed in one process by autograd over
    the shards' one-device renders (the fused kernels, or the XLA-style
    renderer with the shards' keys fold(key, ti, si)): the sample shards
    summed, each tile's part of the loss summed over the tiles."""
    from functools import reduce

    from spectral_tpu_torch.diff import render_rays_diff_fused
    from spectral_tpu_torch.parallel import apply_params
    from spectral_tpu_torch.parallel.render import FUSED_SEED_STRIDE
    from spectral_tpu_torch.render.wavefront import chunk_pixels, render_tile_xyz
    from spectral_tpu_torch.utils.prng import fold

    params, scene, cam, target, seed, spp, bounces, _, sched = spec
    nt, ns = shape
    h, w = cam.image_height, cam.image_width
    rows, lspp = h // nt, spp // ns
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    total = 0.0
    with torch.enable_grad():
        if sched is None:
            s = apply_params(scene, leaves)
        else:
            mats = dataclasses.replace(scene.materials, **leaves)
        for ti in range(nt):
            px, py = chunk_pixels(0, ti * rows, w, rows, scene.normal.device)
            if sched is None:
                parts = [render_tile_xyz(s, cam, px, py, fold(seed, ti, si), lspp, bounces) for si in range(ns)]
                sq = (reduce(torch.add, parts).reshape(rows, w, 3) / float(spp) - target[ti * rows:(ti + 1) * rows]) ** 2
                total = total + torch.sum(sq) / (h * w * 3)
            else:
                parts = [render_rays_diff_fused(mats, scene, cam, px.float(), py.float(),
                                                seed + (ti * ns + si) * FUSED_SEED_STRIDE, lspp, bounces, sched=sched)
                         for si in range(ns)]
                img = reduce(torch.add, parts).reshape(rows, w, 3) / spp
                total = total + torch.sum((img - target[ti * rows:(ti + 1) * rows]) ** 2)
        grads = torch.autograd.grad(total, list(leaves.values()))
    loss = float(total.detach()) if sched is None else float(total.detach()) / (h * w * 3)
    return loss, {k: g.cpu() for k, g in zip(leaves, grads)}


def parallel_phase(dev, smi: str, cards: int = 1) -> dict:
    """Phase 14: the sharded paths on torch.distributed. Returns what the
    kernels line and PERF.md report. With ``cards`` > 1
    (``--parallel-cards``): one NCCL world of a rank on each card instead,
    on the meshes factor_devices(cards), (cards, 1) and (1, cards), without
    the example; an image whose group has more than two ranks is held to
    PAR_XLA_REL, since such an all-reduce may associate its sums otherwise
    than the composition."""
    from spectral_tpu_torch.ops.cuda import build
    from spectral_tpu_torch.parallel import factor_devices

    root = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    if cards == 1:
        gloo = spawn_world(2, "gloo", GLOO_MESHES, [(1, 2)], root, dev.type)
        nccl = spawn_world(1, "nccl", [(1, 1)], [], root, dev.type)
        worlds = [("gloo", shape, gloo) for shape in GLOO_MESHES] + [("nccl", (1, 1), nccl)]
        log("phase 14 (two gloo ranks share the one card, on CUDA tensors; a one-rank NCCL world): times are of "
            "processes sharing one card, not scaling")
    else:
        meshes = list(dict.fromkeys([factor_devices(cards), (cards, 1), (1, cards)]))
        ranks = spawn_world(cards, "nccl", meshes, [], root, dev.type)
        worlds = [("nccl", shape, ranks) for shape in meshes]
        log(f"phase 14 on {cards} cards, an NCCL rank on each")

    p = par_problem(dev)
    one = par_run(p, None)
    one_example = par_example(None, dev, lambda *_: None) if cards == 1 else None
    out = {"one_device": {k: v["stats"] for k, v in one.items()}, "worlds": {}, "launches": {}}
    out["one_device"]["example"] = one_example
    renders, steps = par_renders(p), par_steps(p)
    expected = {k.name for k in build.KERNELS.values()}
    for backend, shape, ranks in worlds:
        key = f"{backend} {shape}"
        res = [r["meshes"][str(tuple(shape))] for r in ranks]
        summary = {}
        for name, spec in renders.items():
            want = par_composed_image(name, spec, shape)
            if spec[5] is None or max(shape) > 2:
                err = max(float((r[name]["image"] - want).abs().max()) for r in res) / float(want.abs().max())
                ok = err <= PAR_XLA_REL
            else:
                err = 0.0 if all(torch.equal(r[name]["image"], want) for r in res) else float("inf")
                ok = err == 0.0
            summary[name] = {"rel_err": err, "ranks": [r[name]["stats"] for r in res]}
            log(f"{key} {name}: against the composition {'bit-equal' if err == 0.0 else err}; one device "
                f"{one[name]['stats']['ms']} ms; ranks {[r[name]['stats']['ms'] for r in res]} ms, all-reduce "
                f"spans {all_reduce_spans(res, name)} (count, host ms; the device's NCCL time is the benchmark's "
                f"collective_ms), peak "
                f"{[r[name]['stats']['peak_mib'] for r in res]} MiB (one device {one[name]['stats']['peak_mib']})")
            if not ok:
                raise SystemExit(f"phase 14: {key} {name} differs from its composition ({err})")
        for name, spec in steps.items():
            loss, grads = par_composed_grads(spec, shape)
            tol = PAR_XLA_REL if spec[8] is None else REPLAY_REL
            rel = {}
            for r in res:
                got = r[name]
                if not got["finite"] or abs(got["grad_loss"] - loss) > PAR_LOSS_REL * abs(loss) \
                        or abs(got["loss"] - loss) > PAR_LOSS_REL * abs(loss):
                    raise SystemExit(f"phase 14: {key} {name} loss {got['loss']} / {got['grad_loss']} against {loss}")
                for k, want in grads.items():
                    scale = float(want.abs().max())
                    rel[k] = max(rel.get(k, 0.0), float((got["grads"][k] - want).abs().max()) / max(scale, 1e-30))
            g, want = res[0][name]["grads"]["coeffs"], grads["coeffs"]
            ratio = float((g * want).sum() / (want * want).sum())
            summary[name] = {"rel_err": rel, "ratio": ratio, "loss": loss, "ranks": [r[name]["stats"] for r in res]}
            log(f"{key} {name}: loss {res[0][name]['loss']} (composed {loss}), gradient against the true one "
                f"composed in one process {rel} of each leaf's largest, ratio {ratio} (1, not n_sample = {shape[1]}); "
                f"one device {one[name]['stats']['ms']} ms; ranks {[r[name]['stats']['ms'] for r in res]} ms, "
                f"all-reduce spans {all_reduce_spans(res, name)} (count, host ms; the device's NCCL time is the "
                f"benchmark's collective_ms), peak "
                f"{[r[name]['stats']['peak_mib'] for r in res]} MiB (one device {one[name]['stats']['peak_mib']})")
            if any(v > tol for v in rel.values()) or abs(ratio - 1.0) > tol:
                raise SystemExit(f"phase 14: {key} {name} gradient is not the true one ({rel}, ratio {ratio})")
        launches = []
        for r in res:
            n = {}
            for name in (*renders, *steps):
                for k, v in r[name]["stats"]["launches"].items():
                    n[k] = n.get(k, 0) + v
            launches.append(n)
        missing = [sorted(expected - set(n)) for n in launches]
        log(f"{key}: launches per rank {launches}")
        if any(missing):
            raise SystemExit(f"phase 14: {key}: kernels not launched on a rank: {missing}")
        if "example" in res[0]:
            summary["example"] = [r["example"] for r in res]
            log(f"{key} inverse_rendering: {summary['example']}; one device {one_example}")
            if not all(e["share"] >= EXAMPLE_SHARE and e["last_loss"] < e["first_loss"] for e in summary["example"]):
                raise SystemExit(f"phase 14: inverse_rendering recovered less than {EXAMPLE_SHARE} on the {key} mesh")
        out["worlds"][key] = summary
        out["launches"][key] = launches
    log(f"one device inverse_rendering: {one_example}")
    if one_example is not None and (one_example["share"] < EXAMPLE_SHARE
                                    or one_example["last_loss"] >= one_example["first_loss"]):
        raise SystemExit(f"phase 14: inverse_rendering recovered less than {EXAMPLE_SHARE} on one device")
    log(f"  {smi}")
    return out


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
            render_rays_reference, render_rays_residuals, scene_pack,
        )
        from spectral_tpu_torch.ops.intersect import nearest_hit
        from spectral_tpu_torch.parallel import train_step_fused, trainable_params
        from spectral_tpu_torch.runtime.render_manager import RenderManager, chunk_seed
        from spectral_tpu_torch.utils.logging import get_log_context
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--rank"] and len(sys.argv) == 3:
        return rank_main(sys.argv[2])

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
    if sys.argv[1:] == ["--xla"]:
        build.build_all(build.KERNELS.values())
        print(json.dumps({"xla": xla_phase(dev, smi)}), flush=True)
        return 0
    if sys.argv[1:] == ["--warp"]:
        build.build_all(build.KERNELS.values())
        print(json.dumps({"warp": warp_phase(dev, smi)}), flush=True)
        return 0
    if sys.argv[1:] == ["--examples"]:
        build.build_all(build.KERNELS.values())
        print(json.dumps({"examples": examples_phase(dev, smi)}), flush=True)
        return 0
    if sys.argv[1:] == ["--parallel"]:
        build.build_all(build.KERNELS.values())
        print(json.dumps({"parallel": parallel_phase(dev, smi)}), flush=True)
        return 0
    if sys.argv[1:] == ["--parallel-cards"]:
        if torch.cuda.device_count() < 2:
            raise SystemExit("--parallel-cards needs more than one card")
        build.build_all(build.KERNELS.values())
        print(json.dumps({"parallel_cards": parallel_phase(dev, smi, torch.cuda.device_count())}), flush=True)
        return 0

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
    pack = scene_pack(tri, mat, tab)
    cam1 = camera_vector(scene_camera(CORNELL, 1, 1, dev))
    one = torch.zeros(1, device=dev)
    t0 = time.perf_counter()
    build.RENDER.function()
    load_ms = 1e3 * (time.perf_counter() - t0)
    first = []
    for _ in range(2):
        t0 = time.perf_counter()
        render_rays(cam1, 1, pack, one, one, 1, 1, 1)
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
        s_pack = scene_pack(*pack_scene(build_scene(sid, dev)))
        cam = camera_vector(scene_camera(sid, w, h, dev))
        planes = rng.uniform(size=(c_spp, n_uniforms(c_bounces), w * h)).astype(np.float32)
        for mode, rand in (("planes", torch.from_numpy(planes).to(dev)), ("hash", None)):
            seed = chunk_seed(0, 0, w) + sid
            args = (cam, seed, s_pack, px, py, c_spp, c_bounces, w, rand)
            mx, mean, *_ = check_render(f"{sname}/{mode}", args)
            render_err, render_mean = max(render_err, mx), max(render_mean, mean)
            res, mx, mean, *_ = check_residuals(f"{sname}/{mode} residuals", args)
            res_err, res_mean = max(res_err, mx), max(res_mean, mean)
            g = torch.from_numpy(rng.normal(size=(w * h, 3)).astype(np.float32)).to(dev)
            mx, rel, _ = check_replay(f"{sname}/{mode} replay", s_pack.mat, s_pack.tab, g, res, c_spp, c_bounces, sid == PRISM)
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
    args = (cam, seed, pack, fpx, fpy, spp, bounces, width, None)
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
    o, d = intersect_rays(rng, n_rays, dev)
    log("intersect kernel vs plain, CORNELL, %d random rays:" % n_rays)
    got = intersect(o, d, tri16)
    ref = nearest_hit(o, d, tri16)
    torch.cuda.synchronize()
    for a, b, what in zip(got, ref, ("t", "idx", "hit", "front")):
        if not torch.equal(a, b):
            raise SystemExit(f"intersect: {what} differs from the plain version")
    hit = ref[2]
    isect_err = float((got[0] - ref[0]).abs().max())
    i_ms, i_host_us = device_ms(lambda: intersect(o, d, tri16), 20)
    i_b2b_ms = cuda_ms(lambda: intersect(o, d, tri16), 20)
    i_plain_ms = cuda_ms(lambda: nearest_hit(o, d, tri16), 3)
    i_flops = n_rays * tri16.shape[0] * SWEEP_FLOPS_PER_TRI
    i_bytes = 4 * tri16.numel() + n_rays * (24 + 4 + 4 + 1 + 1)
    i_bound, i_by = bound_ms(i_flops, i_bytes)
    i_issue = intersect_issue_bound(n_rays * tri16.shape[0], "ILb0ELb0E")
    log(
        f"  t, idx, hit, front equal ({int(hit.sum())} hits); {n_rays} rays x {tri16.shape[0]} tris: device "
        f"{i_ms} ms a call (queued behind a sleep), host {i_host_us} us a call, back-to-back events {i_b2b_ms} "
        f"ms; plain {i_plain_ms} ms; bound {i_bound} ms ({i_by}); issue bound {i_issue['ms']} ms "
        f"({i_issue['per_test']} instructions a test in the SASS loop, SM clock {i_issue['mhz']} MHz); {smi}"
    )

    # the residual and replay kernels at the training shape
    tw, th, t_spp, t_b = TRAIN_W, TRAIN_H, TRAIN_SPP, TRAIN_BOUNCES
    t_rays = tw * th
    t_cam = scene_camera(CORNELL, tw, th, dev)
    t_camv = camera_vector(t_cam)
    tpx = (torch.arange(t_rays, device=dev) % tw).float()
    tpy = (torch.arange(t_rays, device=dev) // tw).float()
    t_args = (t_camv, TRAIN_SEED, pack, tpx, tpy, t_spp, t_b, tw, None)
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
    log(f"  kernel {grad_ms} ms (plain {grad_plain_ms} ms), {gr_flops} flops, {gr_bytes} bytes, bound {gr_bound} ms "
        f"({gr_by}), {grad_ms / gr_bound:.2f}x the bound; {smi}")
    replay_shapes(dev, t_rays, mat.shape[0], t_b)
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
            args, _ = field_args(scene, lw, lh, l_spp, l_bounces, rand, chunk_seed(0, 0, lw) + 7)
            leaf_errs.append(check_leaves(f"{sname}/{mode}", args))
    c_tri, c_mat, c_tab, c_leaf = pack_scene_leaves(cornell, leaf_size=8)
    c_cam = camera_vector(scene_camera(CORNELL, lw, lh, dev))
    c_tri, c_leaf = order_leaves_near_to_far(c_tri, c_leaf, c_cam[0:3])
    c_px = (torch.arange(lw * lh, device=dev) % lw).float()
    c_py = (torch.arange(lw * lh, device=dev) // lw).float()
    c_args = (c_cam, 99, scene_pack(c_tri, c_mat, c_tab, c_leaf), c_px, c_py, l_spp, l_bounces, lw, None)
    dense = render_rays_residuals(c_cam, 99, pack, c_px, c_py, l_spp, l_bounces, lw, None)
    on_cornell, _ = compare_residuals("leaf megakernel on CORNELL vs dense", render_rays_residuals(*c_args), dense)
    log(f"  cornell/hash, {c_leaf.shape[0]} leaves of 8: leaf megakernel vs dense megakernel max abs {on_cornell:.3g}")
    mega_err = max([e["mega_err"] for e in leaf_errs] + [on_cornell])
    mega_mean = max(e["mega_mean"] for e in leaf_errs)
    sorted_err = max(max(e["sorted_err"], e["between"]) for e in leaf_errs)
    sorted_mean = max(e["sorted_mean"] for e in leaf_errs)

    # ---- 9. the large-scene kernels at the field's shapes ------------------
    fw, fh, f_spp, f_b = FIELD_W, FIELD_H, FIELD_SPP, FIELD_BOUNCES
    f_rays, f_samples = fw * fh, fw * fh * FIELD_SPP
    f_args, f_leaf = field_args(field, fw, fh, f_spp, f_b, None, chunk_seed(0, 0, fw))
    scene_bytes, ray_bytes, k_size = leaf_work(f_args)
    log(f"leaf megakernel and sorted scheduler, 10k field ({field.num_tris} tris, {f_leaf.shape[0]} leaves of "
        f"{k_size}), {fw}x{fh}, {f_spp} spp, {f_b} bounces, hash draws:")
    box_names = ("visits", "group_visits", "super_visits")
    f_steps = torch.zeros(f_rays, dtype=torch.int32, device=dev)
    f_boxes = {k: torch.zeros_like(f_steps) for k in box_names}
    f_res = render_rays_residuals(*f_args, f_steps, **f_boxes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f_ref = render_rays_reference(*f_args, residuals=True)
    torch.cuda.synchronize()
    lm_plain_ms = 1e3 * (time.perf_counter() - t0)
    e, m = compare_residuals("leaf megakernel at the field shape", f_res, f_ref)
    if not all(torch.equal(a, b) for a, b in zip(f_res, f_ref)):
        raise SystemExit("leaf megakernel at the field shape: not bit-equal to its plain version")
    mega_err, mega_mean = max(mega_err, e), max(mega_mean, m)
    del f_ref
    lm_ms = cuda_ms(lambda: render_rays(*f_args), 3)
    lmr_ms = cuda_ms(lambda: render_rays_residuals(*f_args), 3)
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
    wf = sorted_report("10k field", f_args, plain=True)
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
    big_wf = sorted_report(f"200k field ({big_leaf.shape[0]} leaves)", big_args, plain=False)
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

    # ---- 12. the XLA-style renderer ----------------------------------------
    t0 = time.perf_counter()
    xla = xla_phase(dev, smi)
    log(f"phase 12: {time.perf_counter() - t0} s")

    # ---- 13. the warp estimators -------------------------------------------
    t0 = time.perf_counter()
    warp = warp_phase(dev, smi)
    log(f"phase 13: {time.perf_counter() - t0} s")

    # ---- 14. the sharded paths on torch.distributed -------------------------
    t0 = time.perf_counter()
    par = parallel_phase(dev, smi)
    log(f"phase 14: {time.perf_counter() - t0} s")

    # ---- 15. the last examples, and the general-colour rgb2spec --------------
    t0 = time.perf_counter()
    ex = examples_phase(dev, smi)
    log(f"phase 15: {time.perf_counter() - t0} s")

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
            "render_chunk_diff": xla["diff"],
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
            "launches": xla["launches"],
            "path": f"the XLA-style render (render/wavefront.py), Cornell {XLA_W}x{XLA_H}, {XLA_SPP} spp, "
                    f"{XLA_BOUNCES} bounces: one launch a sample and bounce",
            "share_of_xla_render": xla["share"],
            "xla_render_ms": xla["render_ms"],
            **{k: xla["path_intersect"][k] for k in ("max_abs_err", "ms", "host_us_per_call", "back_to_back_ms",
                                                     "plain_ms", "bound_ms", "bound_by", "issue_bound")},
            "library_ms": None,
            "shape": xla["path_intersect"]["shape"] + ", intersect_kernel<true,false> (the dots in the XLA order)",
            "warp_path": {
                "launches": warp["launches"],
                "path": "a warped vertex gradient (diff/vertex_warp.py through render/wavefront.py), the shadow "
                        f"scene of examples/inverse_geometry.py, 16x16, 8 spp ({warp['passes']} pass of "
                        "render_tile_xyz), 3 bounces: a launch a pass and bounce forward and another in the "
                        "checkpoint's recompute",
                "full_width_b1_share": warp["full_width"]["dense"]["b1_ms"] / warp["full_width"]["dense"]["ms"],
            },
            "default_order": {
                "max_abs_err": isect_err,
                "ms": i_ms,
                "host_us_per_call": i_host_us,
                "back_to_back_ms": i_b2b_ms,
                "plain_ms": i_plain_ms,
                "bound_ms": i_bound,
                "bound_by": i_by,
                "issue_bound": i_issue,
                "shape": f"{n_rays} random rays, {tri16.shape[0]} tris, intersect_kernel<false,false>",
            },
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
            "ms": wf["step_ms"],
            "residual_form_ms": wf["step_res_ms"],
            "plain_ms": wf["p_int"],
            "bound_ms": wf["int_bound"],
            "bound_by": wf["int_by"],
            "residual_form_bound_ms": wf["int_res_bound"],
            "library_ms": None,
            "at_200k": {k: big_wf[k] for k in ("step_ms", "step_res_ms", "int_bound")},
            "shape": f"the integrate step (the launch and the spp sum): {f_samples} sample-rays, {f_rays} pixels",
        },
    ]
    for entry in kernels:
        entry["phase14_launches_per_rank"] = {w: [n.get(entry["name"], 0) for n in ranks]
                                              for w, ranks in par["launches"].items()}
        entry["phase15_launches"] = {name: ex[name]["launches"].get(entry["name"], 0)
                                     for name in ("inverse_field", "inverse_dispersion_fused", "inverse_dispersion_xla")}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
