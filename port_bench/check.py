"""Whether what the timed path produced is correct: the plain reference
(``reference/``) recomputes it from the same inputs, and each number
compared is held to the cell's limit (``limits/<workload>.json``).

Renders: for frames of the window drawn from the seed, and pixels of each
drawn from the seed, the reference traces every sample of the pixel with the
frame's camera and compares
  ``xyz_gap``  the widest distance of a pixel's mean XYZ (the framebuffer
               that the render's chunk hook handed out) from the reference's,
               over the reference's norm of that pixel or of the median
               pixel, whichever is larger;
  ``u8_gap``   the widest difference, in levels, of the uint8 image the
               render returned from the reference's conversion of its own
               XYZ.
Training: the reference follows the first steps from the same start, seeds
and target and compares
  ``loss_gap``   the widest relative gap of a step's loss;
  ``grad_gap``   of the first gradient as the update shows it,
                 (start - after one step) / lr, leaf by leaf: the gap of its
                 norm from the reference's, over the reference's norm of that
                 leaf or of the median leaf, whichever is larger; the worst
                 leaf;
  ``change_gap`` the same of the parameters' change over the steps followed,
                 over the leaves whose reference gradient is at least a
                 thousandth of the median leaf's;
and, of the window's last step, which the reference takes again from the
parameters that the program held before it, with its seed:
  ``window_loss_gap``   the relative gap of its loss (infinite where the
                        program's is not finite);
  ``window_change_gap`` as ``change_gap``, of that step's change of the
                        parameters (an update frozen in the window reads 1);
  ``rank_gap``          over several processes, the widest difference
                        between the parameters that the ranks hold after the
                        window.
"""

from __future__ import annotations

import dataclasses
import statistics

import numpy as np
import torch

from .context import Run
from .reference import camera as rcam
from .reference import render as rr
from .reference import scene as rsc

# paths a block of the reference traces at once
PATHS_PER_BLOCK = 1 << 22
# the program's chunk seed of a chunk at (x0, y0) (the one-chunk frame's is
# its (0, 0)): 1984 + (y0 * width + x0) * 1000003, masked to 31 bits
CHUNK_SEED = 1984
# the program's seed stride between the ranks of a fused training step
FUSED_SEED_STRIDE = 7919993


@dataclasses.dataclass
class Frame:
    yaw: float
    idx: np.ndarray  # flat pixel indices [K]
    u8: np.ndarray  # [K, 3] uint8, the program's image
    xyz: np.ndarray  # [K, 3] float32, the program's XYZ summed over samples


def reference_scene(run: Run, dev) -> rsc.RefScene:
    return rsc.build(run.config["scene"]).to(dev)


def camera_vector(run: Run, width: int, height: int, yaw_deg: float) -> torch.Tensor:
    c = run.config["camera"]
    return rcam.camera_vector(
        width, height, float(c["vfov"]), rcam.orbit_lookfrom(c["lookfrom"], c["lookat"], yaw_deg), c["lookat"],
        c["vup"], float(c["defocus_angle"]), float(c["focus_dist"]),
    )


def sum_samples(xyz: torch.Tensor, spp: int) -> torch.Tensor:
    """[P * spp, 3] path XYZ (pixel-major) -> [P, 3], summed in sample order."""
    x = xyz.reshape(-1, spp, 3)
    acc = torch.zeros_like(x[:, 0])
    for s in range(spp):
        acc = acc + x[:, s]
    return acc


def reference_pixels(run: Run, scene, frames, dev, ar: rr.Arith) -> tuple[torch.Tensor, float]:
    """(XYZ summed over samples [sum of K, 3], live ray-steps a path) of the
    frames' checked pixels."""
    fr = run.frame()
    w, h, spp, bounces = fr["width"], fr["height"], fr["spp"], fr["bounces"]
    cams = torch.cat([camera_vector(run, w, h, f.yaw)[None].expand(len(f.idx), 20) for f in frames])
    idx = torch.from_numpy(np.concatenate([f.idx for f in frames]).astype(np.int64))
    out, live = [], 0
    step = max(1, PATHS_PER_BLOCK // spp)
    for p0 in range(0, idx.shape[0], step):
        pix = idx[p0:p0 + step].to(dev)
        px, py = (pix % w).repeat_interleave(spp), (pix // w).repeat_interleave(spp)
        sample = torch.arange(spp, device=dev).repeat(pix.shape[0])
        cam = cams[p0:p0 + step].to(dev).repeat_interleave(spp, 0)
        seed = torch.full_like(px, CHUNK_SEED)
        xyz, rec = rr.trace(scene, cam, seed, px, py, sample, w, bounces, ar)
        out.append(sum_samples(xyz.float(), spp))
        live += int(rec["live"].sum())
    return torch.cat(out), live / (idx.shape[0] * spp)


def xyz_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    """Widest distance of the program's pixels [N, 3] from the reference's,
    over the reference pixel's norm or the median pixel's, whichever is
    larger; infinite where the program's value is not finite."""
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    if not np.isfinite(prog).all():
        return float("inf")
    rn = np.linalg.norm(ref, axis=1)
    scale = np.maximum(rn, max(float(np.median(rn)), 1e-30))
    return float(np.max(np.linalg.norm(prog - ref, axis=1) / scale))


def check_render(run: Run, frames: list[Frame], dev, prog=None) -> None:
    """Compare the checked frames with the reference; ``prog`` replaces the
    program's (XYZ, u8) of those pixels (the control)."""
    spp = run.frame()["spp"]
    scene = reference_scene(run, dev)
    ref, live = reference_pixels(run, scene, frames, dev, rr.Arith("exact"))
    ref_u8 = rr.srgb_u8(ref / torch.tensor(float(spp), device=ref.device)).cpu().numpy()
    if prog is None:
        prog = (np.concatenate([f.xyz for f in frames]), np.concatenate([f.u8 for f in frames]))
    ref = ref.cpu().numpy()
    run.check("xyz_gap", xyz_gap(prog[0] / spp, ref / spp))
    run.check("u8_gap", float(np.max(np.abs(prog[1].astype(np.int64) - ref_u8.astype(np.int64)))))
    run.counts["live_per_path"] = live
    run.counts["n_tris"], run.counts["n_mats"] = scene.tris.shape[0], scene.mats.shape[0]
    run.counts["checked_pixels"] = int(ref.shape[0])


# ---- training ------------------------------------------------------------------


def target_xyz(run: Run, scene, dev) -> torch.Tensor:
    """Mean-per-sample XYZ [H, W, 3] of the true materials: the reference's
    render of the whole frame at the traffic's target spp and seed, with its
    triangle tests in float64 (``f64hit``)."""
    fr = run.frame()
    w, h, bounces = fr["width"], fr["height"], fr["bounces"]
    spp = int(run.traffic["target_spp"])
    cam = camera_vector(run, w, h, 0.0).to(dev)
    ar = rr.Arith("f64hit")
    out = []
    step = max(1, PATHS_PER_BLOCK // spp)
    with torch.no_grad():
        for p0 in range(0, w * h, step):
            pix = torch.arange(p0, min(p0 + step, w * h), device=dev)
            px, py = (pix % w).repeat_interleave(spp), (pix // w).repeat_interleave(spp)
            sample = torch.arange(spp, device=dev).repeat(pix.shape[0])
            seed = torch.full_like(px, int(run.traffic["target_seed"]))
            xyz, _ = rr.trace(scene, cam, seed, px, py, sample, w, bounces, ar)
            out.append(sum_samples(xyz, spp) / spp)
    return torch.cat(out).reshape(h, w, 3)


def reference_step(run: Run, scene, cam, target, params: dict, seed: int, dev, ar: rr.Arith,
                   ranks=None, rows=None) -> tuple[float, dict, dict]:
    """(loss, gradients, counts) of one fused step at ``params``
    ({"coeffs", "emission_power"}): each rank r of the sample axis traces
    spp / ranks samples a pixel from seed + r * FUSED_SEED_STRIDE, the XYZ
    is summed over the ranks, the loss is sum((xyz / spp - target)^2) over
    h * w * 3 and the gradients are those of the sum. ``ranks``: the ranks
    whose samples are summed (default all); ``rows``: the image rows that
    count (default all; the loss is then over those rows' values)."""
    fr = run.frame()
    w, h, spp, bounces = fr["width"], fr["height"], fr["spp"], fr["bounces"]
    ns = int(run.traffic["mesh"][1])
    local = spp // ns
    ranks = range(ns) if ranks is None else ranks
    rows = range(h) if rows is None else rows
    leaves = {k: v.detach().to(dev).clone().requires_grad_(True) for k, v in params.items()}
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    loss = 0.0
    counts = {"live": 0, "misses": 0, "present": 0}
    n_mats = scene.mats.shape[0]
    pix_all = torch.arange(rows.start * w, rows.stop * w, device=dev)
    step = max(1, PATHS_PER_BLOCK // local)
    for p0 in range(0, pix_all.shape[0], step):
        pix = pix_all[p0:p0 + step]
        px, py = (pix % w).repeat_interleave(local), (pix // w).repeat_interleave(local)
        sample = torch.arange(local, device=dev).repeat(pix.shape[0])
        xyz = 0.0
        for r in ranks:
            seed_r = torch.full_like(px, (seed + r * FUSED_SEED_STRIDE) & rr.M32)
            with torch.no_grad():
                _, rec = rr.trace(scene, cam, seed_r, px, py, sample, w, bounces, ar)
            counts["live"] += int(rec["live"].sum())
            mr = rec["matres"]
            counts["misses"] += int((mr == -1).any(0).sum())
            counts["present"] += sum(int((mr == m + 1).any(0).sum()) for m in range(n_mats))
            path = rr.xyz_from_record(scene.mats, scene.tables, rec, ar, leaves["coeffs"], leaves["emission_power"])
            xyz = xyz + sum_samples(path.float(), local)
        img = xyz / spp
        part = torch.sum((img - target.reshape(-1, 3)[pix]) ** 2)
        gs = torch.autograd.grad(part, list(leaves.values()))
        for k, g in zip(leaves, gs):
            grads[k] += g
        loss += float(part.detach())
    return loss / (len(rows) * w * 3), {k: g.cpu() for k, g in grads.items()}, counts


def follow(run: Run, scene, cam, target, p0: dict, seeds: list[int], lr: float, dev, ar: rr.Arith, **kw):
    """The reference's losses, first gradients, parameters after the steps
    and mean counts a step, from ``p0`` over ``seeds``."""
    p = {k: v.detach().cpu().clone() for k, v in p0.items()}
    losses, first, totals = [], None, {}
    for s in seeds:
        loss, g, counts = reference_step(run, scene, cam, target, p, s, dev, ar, **kw)
        losses.append(loss)
        first = g if first is None else first
        p = {k: p[k] - lr * g[k] for k in p}
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v / len(seeds)
    return losses, first, p, totals


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap of norms, each over the reference's norm of that
    leaf or of the median leaf, whichever is larger."""
    pn, rn = _norms(prog), _norms(ref)
    keys = [k for k in rn if keep is None or k in keep]
    if any(not np.isfinite(pn[k]) for k in keys):
        return float("inf")
    med = statistics.median(rn.values())
    return max(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-300) for k in keys)


def moved_leaves(grad: dict) -> set:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's (the others move under the update by rounding alone)."""
    gn = _norms(grad)
    med = statistics.median(gn.values())
    return {k for k, v in gn.items() if v >= 1e-3 * med}


def check_train(run: Run, prog: dict, ref: dict, lr: float) -> None:
    """``prog``: dict(losses, p0, p1, pn) of the followed steps, ``window``:
    dict(last_loss, prev, pend), the window's last loss and the parameters
    before and after its last step, and over several processes
    ``rank_params``, every rank's parameters after the window. ``ref``:
    dict(losses, grad, pn) of the followed steps (``grad`` the first
    gradient) and ``window``: dict(loss, grad) of the last step taken from
    ``prev``."""
    gaps = [abs(a - b) / abs(b) if b else float("inf") for a, b in zip(prog["losses"], ref["losses"])]
    run.check("loss_gap", max(gaps) if all(np.isfinite(prog["losses"])) else float("inf"))
    g_prog = {k: (prog["p0"][k] - prog["p1"][k]) / lr for k in prog["p0"]}
    run.check("grad_gap", leaf_gap(g_prog, ref["grad"]))
    d_prog = {k: prog["pn"][k] - prog["p0"][k] for k in prog["p0"]}
    d_ref = {k: ref["pn"][k] - prog["p0"][k] for k in prog["p0"]}
    run.check("change_gap", leaf_gap(d_prog, d_ref, moved_leaves(ref["grad"])))
    win, rwin = prog["window"], ref["window"]
    last = float(win["last_loss"])
    gap = abs(last - rwin["loss"]) / abs(rwin["loss"]) if rwin["loss"] else float("inf")
    run.check("window_loss_gap", gap if np.isfinite(last) else float("inf"))
    w_prog = {k: win["pend"][k] - win["prev"][k] for k in win["prev"]}
    w_ref = {k: (win["prev"][k] - lr * rwin["grad"][k]) - win["prev"][k] for k in win["prev"]}
    run.check("window_change_gap", leaf_gap(w_prog, w_ref, moved_leaves(rwin["grad"])))
    if "rank_params" in prog:
        base = prog["rank_params"][0]
        run.check("rank_gap", max(float((r[k] - base[k]).abs().max()) for r in prog["rank_params"] for k in base))
