"""Traffic kind ``train``: fused inverse rendering, a closed loop of SGD
steps of the program's ``train_step_fused`` on the configuration's training
frame, with the loss read back on the host after every step (as the
examples read it).

Traffic parameters: ``frame`` (the configuration's frame), ``mesh``
([tiles, samples]: one process a card, spawned by the run when it holds more
than one), ``leaves`` (the trained material leaves), ``lr`` (per pixel of
the frame: the step is lr / (width * height) times the gradient of the
un-normalized squared error), ``perturb`` (the start is each leaf of the
true materials times 1 + perturb * N(0, 1), drawn from the seed),
``target_spp`` and ``target_seed`` (the reference's render of the true
materials that the loss compares with), ``follow_steps`` (the first steps,
run in set-up through the same call, that the reference follows).

Step k's seed is drawn from (seed, k), so no two steps trace the same paths.
The reference's own set-up (its scene and the target) is left out of
``setup_s``. After the window the reference also takes the window's last
step again, from the parameters the program held before it, and on several
ranks the check compares the parameters that every rank holds after the
window.
``controls`` gives the readings of the cell's control and faults (see
``port_bench.calibrate``).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import check, devices, program
from ..context import Run
from ..reference import render as rr
from ..trace import Tracer, span

STOP_FILE = "stop"


def step_seed(run: Run, k: int) -> int:
    return int(run.rng(k, 41).integers(1, 1 << 31))


def start_params(run: Run, truth: dict) -> dict:
    rng = run.rng(43)
    out = {}
    for k in run.traffic["leaves"]:
        v = truth[k].detach().cpu()
        noise = torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(np.float32))
        out[k] = v * (1.0 + float(run.traffic["perturb"]) * noise)
    return out


def _mesh(run: Run):
    nt, ns = run.traffic["mesh"]
    if nt * ns == 1:
        return None
    from spectral_tpu_torch.parallel.distributed import init_distributed
    from spectral_tpu_torch.parallel.mesh import mesh_of_shape

    init_distributed(f"file://{os.path.join(run.rendezvous, 'store')}", run.world, run.rank,
                     backend="nccl" if run.device == "cuda" else "gloo", device=run.device)
    return mesh_of_shape(nt, ns, device=run.device)


def run_cell(run: Run) -> None:
    import torch.distributed as dist
    from spectral_tpu_torch.parallel import train_step_fused, trainable_params

    fr = run.frame()
    w, h, spp, bounces = fr["width"], fr["height"], fr["spp"], fr["bounces"]
    lr = float(run.traffic["lr"]) / (w * h)
    mesh = _mesh(run)
    dev = mesh.device if mesh is not None else torch.device(run.device)
    distributed = mesh is not None and mesh.distributed
    with run.clock("scene_build_s"):
        scene = program.build_scene(run.config["scene"], dev)
        cam = program.camera(run.config["camera"], w, h, 0.0, dev)
        program.pack(scene, cam)
        devices.sync(dev)
    with run.aside():
        ref_scene = check.reference_scene(run, dev)
        if run.rank == 0:
            target = check.target_xyz(run, ref_scene, dev)
        else:
            target = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    if distributed:
        dist.broadcast(target, 0)
    truth = trainable_params(scene)
    params = {k: v.to(dev) for k, v in start_params(run, truth).items()}
    rec = {"p0": {k: v.cpu().clone() for k, v in params.items()}, "losses": []}

    def one_step(k: int) -> float:
        nonlocal params
        params, loss = train_step_fused(params, scene, cam, target, step_seed(run, k), spp, bounces, lr, mesh)
        return float(loss)

    n_follow = int(run.traffic["follow_steps"])
    for k in range(1, n_follow + 1):
        rec["losses"].append(one_step(k))
        if k == 1:
            rec["p1"] = {key: v.cpu().clone() for key, v in params.items()}
    rec["pn"] = {key: v.cpu().clone() for key, v in params.items()}
    devices.sync(dev)
    devices.reset_peak(dev)
    if distributed:
        dist.barrier()
    run.end_setup()

    tracer = Tracer(run.trace)
    tracer.start()
    stop_at = None
    stop_file = os.path.join(run.rendezvous, STOP_FILE) if distributed else ""
    k = n_follow + 1
    t_start = t = time.perf_counter()
    while True:
        prev = params
        with span("step"):
            last_loss = one_step(k)
        t1 = time.perf_counter()
        run.latencies_s.append(t1 - t)
        t = t1
        if not distributed:
            if t1 - t_start >= run.seconds:
                break
        else:
            # rank 0 decides, one step ahead: no rank can finish step k + 1
            # before rank 0 has joined its collectives, so every rank reads
            # the decision by then
            if stop_at is None:
                if run.rank == 0 and t1 - t_start >= run.seconds:
                    stop_at = k + 1
                    with open(stop_file + ".tmp", "w") as f:
                        f.write(str(stop_at))
                    os.replace(stop_file + ".tmp", stop_file)
                elif run.rank != 0 and os.path.exists(stop_file):
                    with open(stop_file) as f:
                        stop_at = int(f.read())
            if stop_at is not None and k >= stop_at:
                break
        k += 1
    run.window_s = t - t_start
    tracer.stop(run.window_s)
    run.memory_peak_bytes = devices.peak_bytes(dev)
    run.attempted = len(run.latencies_s)
    run.work["steps"] = len(run.latencies_s)
    rec["window"] = {"last_loss": last_loss, "seed": step_seed(run, k),
                     "prev": {key: v.cpu().clone() for key, v in prev.items()},
                     "pend": {key: v.cpu().clone() for key, v in params.items()}}
    if tracer.summary is not None:
        run.traces.append(tracer.summary)
    if distributed:
        if run.rank != 0:
            torch.save({"trace": tracer.summary, "pend": rec["window"]["pend"],
                        "memory_peak_bytes": run.memory_peak_bytes},
                       os.path.join(run.rendezvous, f"rank{run.rank}.pt"))
        dist.barrier()
        dist.destroy_process_group()
        if run.rank != 0:
            return
    del scene, params, prev
    devices.free(dev)

    if distributed:
        others = [torch.load(os.path.join(run.rendezvous, f"rank{r}.pt"), weights_only=False)
                  for r in range(1, run.world)]
        for o in others:
            if o["trace"] is not None:
                run.traces.append(o["trace"])
            run.memory_peak_bytes = max(run.memory_peak_bytes, o["memory_peak_bytes"])
        rec["rank_params"] = [rec["window"]["pend"]] + [o["pend"] for o in others]
    seeds = [step_seed(run, k) for k in range(1, n_follow + 1)]
    ref_cam = check.camera_vector(run, w, h, 0.0).to(dev)
    ar = rr.Arith("f64hit")
    losses, grad, pn, counts = check.follow(run, ref_scene, ref_cam, target, rec["p0"], seeds, lr, dev, ar)
    w_loss, w_grad, _ = check.reference_step(run, ref_scene, ref_cam, target, rec["window"]["prev"],
                                             rec["window"]["seed"], dev, ar)
    n_ranks = int(run.traffic["mesh"][1])
    run.counts.update({k: v / n_ranks for k, v in counts.items()})
    run.counts["n_tris"], run.counts["n_mats"] = ref_scene.tris.shape[0], ref_scene.mats.shape[0]
    check.check_train(run, rec, {"losses": losses, "grad": grad, "pn": pn,
                                 "window": {"loss": w_loss, "grad": w_grad}}, lr)


def controls(run: Run, dev) -> dict:
    """The control and the faults of a training cell that the reference can
    plant at the cell's size, each followed over the traffic's steps from
    the same start and held against the float32 reference: ``bf16`` (the
    reference in bfloat16), ``half`` (half the image's rows left out, the
    loss's mean taken over the rest) and, on a mesh, ``no_exchange`` (rank
    0's samples alone). Each variant's second step stands for the window's
    last step, taken again by the float32 reference from the variant's
    parameters before it. A state left unchanged reads 1 by the measure of
    ``grad_gap``, ``change_gap`` and ``window_change_gap`` and needs no
    run."""
    fr = run.frame()
    w, h = fr["width"], fr["height"]
    lr = float(run.traffic["lr"]) / (w * h)
    scene = check.reference_scene(run, dev)
    cam = check.camera_vector(run, w, h, 0.0).to(dev)
    target = check.target_xyz(run, scene, dev)
    truth = {"coeffs": scene.mats[:, 0:3].cpu(), "emission_power": torch.sqrt(scene.mats[:, 8]).cpu()}
    p0 = start_params(run, truth)
    n = int(run.traffic["follow_steps"])
    seeds = [step_seed(run, k) for k in range(1, n + 1)]
    losses, grad, pn, _ = check.follow(run, scene, cam, target, p0, seeds, lr, dev, rr.Arith("f64hit"))
    ref = {"losses": losses, "grad": grad, "pn": pn}
    variants = {"bf16": dict(ar=rr.Arith("bf16")), "half": dict(rows=range(h // 2))}
    if int(run.traffic["mesh"][1]) > 1:
        variants["no_exchange"] = dict(ranks=[0])
    out = {}
    for name, kw in variants.items():
        ar = kw.pop("ar", rr.Arith("f64hit"))
        v_losses, v_grad, v_pn, _ = check.follow(run, scene, cam, target, p0, seeds, lr, dev, ar, **kw)
        p1 = {k: p0[k] - lr * v_grad[k] for k in p0}
        prev = check.follow(run, scene, cam, target, p0, seeds[:-1], lr, dev, ar, **kw)[2]
        w_loss, w_grad, _ = check.reference_step(run, scene, cam, target, prev, seeds[-1], dev, rr.Arith("f64hit"))
        window = {"last_loss": v_losses[-1], "prev": prev, "pend": v_pn}
        run.checks.clear()
        check.check_train(run, {"losses": v_losses, "p0": p0, "p1": p1, "pn": v_pn, "window": window},
                          {**ref, "window": {"loss": w_loss, "grad": w_grad}}, lr)
        out[name] = {k: v for k, (v, _) in run.checks.items()}
    return out
