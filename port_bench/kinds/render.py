"""Traffic kind ``render``: a closed loop of one client that renders frame
after frame through the program's ``RenderManager``, each from a new camera
pose, and waits for each uint8 image on the host.

Traffic parameters: ``frame`` (the configuration's frame), ``yaw_deg`` (the
poses turn ``lookfrom`` about the vertical axis through ``lookat`` within
plus or minus this many degrees), ``strata`` (the poses of every ``strata``
consecutive frames fall one in each of as many equal bands of yaw, in an
order and at places within each band drawn from the seed: every seed renders
the same spread of poses). The configuration's ``check.render`` gives how
many frames of the window (``frames``), drawn from the seed, the reference
checks, and how many pixels of each (``pixels``).

``controls`` gives the readings of the cell's control (see
``port_bench.calibrate``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import check, devices, program
from ..context import Run
from ..reference import render as rr
from ..trace import Tracer, span


def yaw(run: Run, i: int) -> float:
    """Yaw in degrees of frame ``i`` (frame -1, the warm-up, looks straight)."""
    if i < 0:
        return 0.0
    k = int(run.traffic["strata"])
    cycle, pos = divmod(i, k)
    rng = run.rng(cycle, 17)
    band = rng.permutation(k)[pos]
    u = run.rng(i, 23).random()
    a = float(run.traffic["yaw_deg"])
    return -a + 2.0 * a * (band + u) / k


def pixels(run: Run, i: int, n_pixels: int) -> np.ndarray:
    """The pixels of frame ``i`` that the check may read, drawn from the seed."""
    rng = run.rng(i, 29)
    return rng.choice(n_pixels, size=min(int(run.config["check"]["render"]["pixels"]), n_pixels), replace=False)


def run_cell(run: Run) -> None:
    from spectral_tpu_torch import RenderParams
    from spectral_tpu_torch.runtime.render_manager import RenderManager

    fr = run.frame()
    w, h, spp, bounces = fr["width"], fr["height"], fr["spp"], fr["bounces"]
    dev = torch.device(run.device)
    with run.clock("scene_build_s"):
        scene = program.build_scene(run.config["scene"], dev)
        program.pack(scene, program.camera(run.config["camera"], w, h, 0.0, dev))
        devices.sync(dev)
    params = RenderParams(xres=w, aspect_ratio=w / h, nsamples=spp, bounce_limit=bounces, device=dev.type,
                          show=False)

    def frame(i: int):
        cam = program.camera(run.config["camera"], w, h, yaw(run, i), dev)
        idx = pixels(run, i, w * h)
        got = {}

        def on_chunk(_chunk, fb_xyz):
            got["xyz"] = fb_xyz.reshape(-1, 3)[idx].copy()

        img = RenderManager(scene, cam, params).render(on_chunk=on_chunk)
        return idx, img.reshape(-1, 3)[idx].copy(), got["xyz"]

    frame(-1)
    devices.sync(dev)
    devices.reset_peak(dev)
    run.end_setup()

    tracer = Tracer(run.trace)
    tracer.start()
    done = []
    t_start = t = time.perf_counter()
    while True:
        with span("frame"):
            out = frame(len(done))
        t1 = time.perf_counter()
        done.append(out)
        run.latencies_s.append(t1 - t)
        t = t1
        if t1 - t_start >= run.seconds:
            break
    run.window_s = t - t_start
    tracer.stop(run.window_s)
    run.memory_peak_bytes = devices.peak_bytes(dev)
    if tracer.summary is not None:
        run.traces.append(tracer.summary)
    run.attempted = len(done)
    run.work["frames"] = len(done)
    run.work["ray_steps"] = len(done) * w * h * spp * bounces
    del scene
    devices.free(dev)

    rng = run.rng(31)
    n_check = min(int(run.config["check"]["render"]["frames"]), len(done))
    chosen = sorted(rng.choice(len(done), size=n_check, replace=False))
    frames = [check.Frame(yaw(run, int(i)), *done[i]) for i in chosen]
    check.check_render(run, frames, dev)


def controls(run: Run, dev) -> dict:
    """The control: the plain reference computed in bfloat16 put in the
    program's place on the frames and pixels that a run of this seed checks
    first, held to the same comparison."""
    fr = run.frame()
    n = int(run.config["check"]["render"]["frames"])
    frames = []
    for i in range(n):
        idx = pixels(run, i, fr["width"] * fr["height"])
        frames.append(check.Frame(yaw(run, i), idx, None, None))
    scene = check.reference_scene(run, dev)
    xyz, _ = check.reference_pixels(run, scene, frames, dev, rr.Arith("bf16"))
    u8 = rr.srgb_u8(xyz / torch.tensor(float(fr["spp"]), device=xyz.device)).cpu().numpy()
    check.check_render(run, frames, dev, prog=(xyz.cpu().numpy(), u8))
    return {"bf16": {k: v for k, (v, _) in run.checks.items()}}
