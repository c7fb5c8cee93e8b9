"""Recover a material's reflectance spectrum from a target image.

Port of examples/inverse_rendering.py. A target Cornell image is rendered,
the white wall's third sigmoid coefficient is pushed +1.5, and Adam on the
L2 pixel loss walks it back through the XLA-style renderer's gradients
(parallel/render.py::loss_and_grads). The loss renders with the target's
key, so its noise is fixed and its minimum is the truth (fixed-noise
inverse Monte Carlo). The coefficient basis is degenerate (many triples
give nearly the same spectrum), so success is measured on the spectrum:
the largest deviation of ``spd_from_coeffs_reflectance`` from the truth's
under RECOVERED.

Cornell 32x32, 8 spp, 4 bounces, 120 steps of optax.adam(0.05) (b1 0.9,
b2 0.999, eps 1e-8, bias-corrected), written out in ``adam_update``: the
update of ``coeffs`` is scaled per coordinate by COEFF_SCALE (c0 multiplies
lambda^2 ~ 4e5, so its natural step is ~1e-6 of c2's), which
``torch.optim.Adam`` cannot do.

One device by default; in a world of processes (parallel/distributed.py:
SPECTRAL_COORD, SPECTRAL_NPROC, SPECTRAL_PROC_ID for each process, a card
each, or the CPU) on the mesh over the world, rank 0 printing:

    python -m spectral_tpu_torch.examples.inverse_rendering [--device cuda|cpu] [--steps N]
"""

from __future__ import annotations

import argparse

import torch
import torch.distributed as dist

from ..models.scenes import CORNELL, build_scene, scene_camera
from ..ops.rgb2spec import spd_from_coeffs_reflectance
from ..parallel import Mesh, init_distributed, loss_and_grads, make_global_mesh, render_image_sharded, trainable_params
from ..utils.device import resolve_device

SIZE, SPP, BOUNCES, STEPS, KEY = 32, 8, 4, 120, 0
WALL = 3  # the white wall's material row (inverse_rendering.py:51)
LR, B1, B2, EPS = 0.05, 0.9, 0.999, 1e-8
COEFF_SCALE = (1e-5, 5e-3, 1.0)
RECOVERED = 0.03


def adam_update(grads: dict, moments: dict, step: int) -> dict:
    """optax.adam(LR)'s update of step ``step`` (from 1) for ``grads``,
    advancing ``moments`` ({leaf: (m, v)}) in place: m = (1 - b1) g + b1 m,
    v = (1 - b2) g^2 + b2 v, update = -LR m^ / (sqrt(v^) + eps) with the
    bias-corrected m^ = m / (1 - b1^t), v^ = v / (1 - b2^t)."""
    out = {}
    for k, g in grads.items():
        m, v = moments[k]
        m = (1.0 - B1) * g + B1 * m
        v = (1.0 - B2) * g * g + B2 * v
        moments[k] = (m, v)
        out[k] = -LR * (m / (1.0 - B1**step)) / (torch.sqrt(v / (1.0 - B2**step)) + EPS)
    return out


def spd_error(coeffs: torch.Tensor, truth: torch.Tensor) -> float:
    """The largest deviation of the wall's reflectance spectrum from the
    truth's (the identifiable quantity)."""
    return float((spd_from_coeffs_reflectance(coeffs[WALL]) - spd_from_coeffs_reflectance(truth[WALL])).abs().max())


def main(steps: int = STEPS, device: torch.device | str = "cuda", size: int = SIZE, mesh: Mesh | None = None,
         log=print) -> dict:
    """Adam from the perturbed wall for ``steps`` steps at ``size`` x
    ``size`` on ``mesh`` (None: one ``device``); returns the spectrum's
    error at the start and the end, whether it is under RECOVERED, and the
    loss of every step."""
    dev = resolve_device(device) if mesh is None else mesh.device
    scene = build_scene(CORNELL, dev)
    cam = scene_camera(CORNELL, size, size, dev)
    with torch.no_grad():
        target = render_image_sharded(scene, cam, KEY, SPP, BOUNCES, mesh=mesh) / SPP
    truth = trainable_params(scene)
    params = {k: v.clone() for k, v in truth.items()}
    params["coeffs"][WALL, 2] += 1.5
    scale = torch.tensor(COEFF_SCALE, dtype=torch.float32, device=dev)
    moments = {k: (torch.zeros_like(v), torch.zeros_like(v)) for k, v in params.items()}
    err0 = spd_error(params["coeffs"], truth["coeffs"])
    losses = []
    for step in range(1, steps + 1):
        loss, grads = loss_and_grads(params, scene, cam, target, KEY, SPP, BOUNCES, mesh=mesh)
        losses.append(float(loss))
        if step == 1:
            log(f"initial: spd err {err0:.4f}  loss {losses[0]:.3e}")
        updates = adam_update(grads, moments, step)
        updates["coeffs"] = updates["coeffs"] * scale
        params = {k: p + updates[k] for k, p in params.items()}
        if step % 30 == 0:
            log(f"step {step:3d}  loss {losses[-1]:.3e}  spd err {spd_error(params['coeffs'], truth['coeffs']):.4f}")
    err = spd_error(params["coeffs"], truth["coeffs"])
    log(f"{'recovered' if err < RECOVERED else 'partial recovery'} (spd err {err:.4f})")
    return {"spd_err0": err0, "spd_err": err, "recovered": err < RECOVERED, "losses": losses}


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, default=STEPS)
    a = ap.parse_args(argv)
    init_distributed(device=a.device)  # NCCL on the card, gloo on the CPU
    try:
        mesh = make_global_mesh(a.device) if dist.is_initialized() else None
        quiet = mesh is not None and mesh.rank != 0
        main(a.steps, a.device, mesh=mesh, log=(lambda *_: None) if quiet else print)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
