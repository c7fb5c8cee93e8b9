"""One rank of the gloo world of tests/test_torch_parallel.py, on the CPU,
or of tests/test_torch_cuda.py's, on the card.

    SPECTRAL_COORD=file:///DIR/rendezvous SPECTRAL_NPROC=4 SPECTRAL_PROC_ID=R \\
        python tests/torch_parallel_worker.py INPUTS OUT_DIR

joins the world, builds the mesh over it (2 x 2 for four ranks) and runs
every sharded function of spectral_tpu_torch.parallel on its shard with
the plain versions: the XLA-style render and train step on the JAX draws
of its shard (INPUTS, a pickle the test wrote from the stored cases
par_render and par_train), the kernel renders (dense Cornell, the
520-triangle field through the sorted scheduler and the leaf megakernel)
and the fused gradients (dense Cornell, the field). It writes what it got
to OUT_DIR/rank{R}.npz; the test holds it to JAX's outputs and to the
per-shard composition. No JAX here.

    ... python tests/torch_parallel_worker.py --card OUT_DIR

instead renders CARD_RUN through the dense megakernel on the card, its
ranks sharing it over gloo.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from spectral_tpu_torch.models.camera import camera_from_numpy  # noqa: E402
from spectral_tpu_torch.models.scenes import CORNELL, build_scene, build_tri_field, scene_camera  # noqa: E402
from spectral_tpu_torch.models.scenes import scene_from_numpy  # noqa: E402
from spectral_tpu_torch.parallel import (  # noqa: E402
    fused_loss_and_grads,
    init_distributed,
    local_row_block,
    loss_and_grads,
    make_global_mesh,
    make_mesh,
    render_image_sharded,
    render_image_sharded_pallas,
    train_step,
)

torch.set_num_threads(1)

# the kernel paths' configurations: (name, scene, size (w, h), spp, bounces,
# seed, sched); the test composes the same
KERNEL_RUNS = (
    ("cornell", "cornell", (16, 16), 4, 3, 5, "sorted"),
    ("field_sorted", "field", (64, 32), 2, 3, 9, "sorted"),
    ("field_mega", "field", (64, 32), 2, 3, 9, "mega"),
)
# the card test's run: dense Cornell, (w, h), spp, bounces, seed
CARD_RUN = ((64, 64), 8, 5, 77)
FUSED_RUNS = (
    ("cornell", "cornell", (16, 16), 4, 3, 7, "sorted"),
    ("field", "field", (64, 32), 2, 3, 13, "sorted"),
)


class ShardDraws:
    """A shard's stored JAX draws in render/wavefront.py::GeneratorDraws'
    methods."""

    def __init__(self, draws: dict):
        self.d = {k: torch.from_numpy(v) for k, v in draws.items()}

    def camera(self, s):
        return self.d["jitter"][s], None

    def hero(self, s):
        return self.d["hero"][s]

    def bounce(self, s, b):
        return self.d["u1"][s, b], self.d["u2"][s, b], self.d["u_refl"][s, b]


def scenes() -> dict:
    return {"cornell": build_scene(CORNELL, "cpu"), "field": build_tri_field(520, 3, device="cpu")}


def fused_problem(scene, size: tuple[int, int]):
    """(params, target) of a fused run: the first material's third
    coefficient + 1.5, a target of seed 21."""
    params = {k: getattr(scene.materials, k).clone() for k in ("coeffs", "emission_power")}
    params["coeffs"][0, 2] += 1.5
    target = np.random.default_rng(21).uniform(0.0, 0.3, (size[1], size[0], 3)).astype(np.float32)
    return params, torch.from_numpy(target)


def _xla_case(case: dict, mesh):
    x, shard_draws = case
    scene, cam = scene_from_numpy(x["scene"], "cpu"), camera_from_numpy(x["cam"], "cpu")
    return x, scene, cam, ShardDraws(shard_draws[mesh.rank])


def run(mesh, inputs: dict) -> dict:
    out = {"shape": np.asarray([mesh.shape["tile"], mesh.shape["sample"]]), "coords": np.asarray([mesh.ti, mesh.si])}
    gmesh = make_global_mesh("cpu")
    out["global_shape"] = np.asarray([gmesh.shape["tile"], gmesh.shape["sample"]])
    out["global_coords"] = np.asarray([gmesh.ti, gmesh.si])
    out["row_block"] = np.asarray(local_row_block(16, mesh))

    x, scene, cam, draws = _xla_case(inputs["par_render"], mesh)
    with torch.no_grad():
        out["xla_image"] = render_image_sharded(scene, cam, int(x["seed"]), int(x["spp"]), int(x["bounces"]),
                                                mesh=mesh, draws=draws).numpy()

    x, scene, cam, draws = _xla_case(inputs["par_train"], mesh)
    params = {"coeffs": torch.from_numpy(x["coeffs"]), "emission_power": torch.from_numpy(x["power"])}
    target = torch.from_numpy(x["target"])
    args = (scene, cam, target, int(x["seed"]), int(x["spp"]), int(x["bounces"]))
    loss, grads = loss_and_grads(params, *args, mesh=mesh, draws=draws)
    new, step_loss = train_step(params, *args, float(x["lr"]), mesh=mesh, draws=draws)
    out.update(xla_loss=loss.numpy(), xla_step_loss=step_loss.numpy(), **{f"xla_d_{k}": g.numpy() for k, g in grads.items()},
               **{f"xla_new_{k}": v.numpy() for k, v in new.items()})

    sc = scenes()
    for name, s, (w, h), spp, bounces, seed, sched in KERNEL_RUNS:
        cam = scene_camera(CORNELL, w, h, "cpu")
        out[f"kernel_{name}"] = render_image_sharded_pallas(sc[s], cam, seed, spp, bounces, mesh=mesh,
                                                            sched=sched).numpy()
    for name, s, (w, h), spp, bounces, seed, sched in FUSED_RUNS:
        cam = scene_camera(CORNELL, w, h, "cpu")
        params, target = fused_problem(sc[s], (w, h))
        loss, grads = fused_loss_and_grads(params, sc[s], cam, target, seed, spp, bounces, mesh=mesh, sched=sched)
        out[f"fused_{name}_loss"] = loss.numpy()
        out.update({f"fused_{name}_d_{k}": g.numpy() for k, g in grads.items()})
    out["collectives"] = np.asarray(mesh.collectives)
    return out


def run_card(mesh) -> dict:
    (w, h), spp, bounces, seed = CARD_RUN
    scene = build_scene(CORNELL, mesh.device)
    cam = scene_camera(CORNELL, w, h, mesh.device)
    img = render_image_sharded_pallas(scene, cam, seed, spp, bounces, mesh=mesh)
    return {"image": img.cpu().numpy(), "coords": np.asarray([mesh.ti, mesh.si])}


def main(argv) -> int:
    card = argv[0] == "--card"
    if card:
        out_dir = argv[1]
    else:
        inputs_path, out_dir = argv[:2]
        with open(inputs_path, "rb") as f:
            inputs = pickle.load(f)  # written by the test that started this process
    device = "cuda" if card else "cpu"
    init_distributed(backend="gloo", device=device)
    try:
        mesh = make_mesh(device=device)
        out = run_card(mesh) if card else run(mesh, inputs)
        np.savez(os.path.join(out_dir, f"rank{dist.get_rank()}.npz"), **out)
    finally:
        dist.destroy_process_group()
    return 0


def spawn(n: int, args: list[str], tmp, timeout: float) -> list[dict]:
    """Runs n ranks of this script with ``args`` in a world with a file://
    rendezvous under ``tmp``, waits for them within ``timeout`` seconds
    (killing every rank either way) and returns each rank's outputs;
    raises RuntimeError if a rank fails or the time runs out."""
    env = dict(os.environ, SPECTRAL_COORD=f"file://{tmp}/rendezvous", SPECTRAL_NPROC=str(n), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *args],
                              env=dict(env, SPECTRAL_PROC_ID=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(n)]
    logs = []
    deadline = time.perf_counter() + timeout
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.perf_counter()))[0])
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"a rank did not finish in {timeout} s") from None
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} failed:\n{log}")
    ranks = []
    for r in range(n):
        with np.load(os.path.join(tmp, f"rank{r}.npz")) as f:
            ranks.append({k: f[k] for k in f.files})
    return ranks


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
