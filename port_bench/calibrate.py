"""The readings that a cell's correctness limits are set from (on the card).

    python3 -m port_bench.calibrate --workload cornell-render --seeds 1-12 --control-seeds 101-103

For each of ``--seeds``, one run of the cell (its set-up, a window of
``--seconds``, default the manifest's ``run_seconds``, and its check) in this
process, on one card: the lower readings, the largest that sound runs give.
For each of ``--control-seeds``, the readings of the control and the faults
that the cell's loop plants itself (``controls`` of ``kinds/<kind>.py``): the
plain reference computed in bfloat16 put in the program's place on the same
inputs and held to the same comparison, and for a training cell the faults
that the reference can plant at the cell's size. A cell on several cards is
read from its own runs; here only its controls and faults are. Prints one
JSON object of every reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from port_bench.context import Run
from port_bench.manifest import Manifest, kind


def _seeds(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        if "-" in part:
            a, b = part.split("-")
            out.extend(range(int(a), int(b) + 1))
        elif part:
            out.append(int(part))
    return out


def make_run(man: Manifest, workload: str, seed: int, seconds: float) -> Run:
    cell = man.cell(workload)
    return Run(workload=workload, seed=seed, seconds=seconds, trace=False, cell=cell,
               config=man.config(cell["config"]), traffic=man.traffic(cell["traffic"]), limits=man.limits(workload),
               t0=time.perf_counter())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: PyTorch sees no CUDA device", file=sys.stderr)
        return 2
    man = Manifest()
    seconds = float(man.data["run_seconds"]) if args.seconds is None else args.seconds
    dev = torch.device("cuda")
    loop = kind(man.traffic(man.cell(args.workload)["traffic"])["kind"])
    out = {"workload": args.workload, "device": torch.cuda.get_device_name(0), "program": {}, "control": {}}
    for seed in _seeds(args.seeds):
        run = make_run(man, args.workload, seed, seconds)
        loop.run_cell(run)
        out["program"][seed] = {k: v for k, (v, _) in run.checks.items()}
        out["program"][seed]["steps_or_frames"] = run.attempted
        print(json.dumps({"seed": seed, **out["program"][seed]}), file=sys.stderr, flush=True)
    for seed in _seeds(args.control_seeds):
        run = make_run(man, args.workload, seed, seconds)
        out["control"][seed] = loop.controls(run, dev)
        print(json.dumps({"control_seed": seed, **out["control"][seed]}), file=sys.stderr, flush=True)
    print(json.dumps(out, allow_nan=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
