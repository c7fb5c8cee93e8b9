"""Run one cell of the benchmark once and print its result line.

    python3 -m port_bench.run --workload cornell-render --seed 7 --seconds 10 --trace 0

from the root of a checkout that holds ``BENCHMARK.json``, ``port_bench/``
and the program (``spectral_tpu_torch/``). The run sets up (imports, the
kernels from the build cache, the scene, the cell's warm-up), measures for
``--seconds``, checks what the timed path produced against the plain
reference, and prints as the last line of standard output one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics read from the profiler
trace), ``device``, with ``--trace 1`` ``breakdown``, and last ``checks``,
each compared number beside its limit (also the last lines of standard
error). It exits non-zero with no result line without the cards the cell
asks for, or when the process holds JAX or the JAX package after the
window. A cell on several cards starts one process a card; rank 0 prints.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402

from port_bench.manifest import Manifest, end_to_end, kind, reader  # noqa: E402


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # set by the run itself for the other ranks of a cell on several cards
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--rendezvous", default="", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def fail(msg: str, code: int = 2) -> int:
    print(f"port_bench: {msg}", file=sys.stderr, flush=True)
    return code


class Ranks:
    """The other ranks of a cell on several cards, as child processes; a
    watcher ends the run if one of them fails, so that no rank waits
    forever on a collective."""

    def __init__(self, argv: list[str], world: int):
        self.dir = tempfile.mkdtemp(prefix="port_bench_")
        self.procs = [
            subprocess.Popen([sys.executable, "-m", "port_bench.run", *argv, "--rank", str(r), "--rendezvous", self.dir],
                             stdout=subprocess.DEVNULL)
            for r in range(1, world)
        ]
        self._stop = threading.Event()
        self._watch = threading.Thread(target=self._watcher, daemon=True)
        self._watch.start()

    def _watcher(self) -> None:
        while not self._stop.wait(0.5):
            if any(p.poll() not in (None, 0) for p in self.procs):
                print("port_bench: a rank failed", file=sys.stderr, flush=True)
                self.kill()
                os._exit(1)

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def close(self, timeout: float = 120.0) -> bool:
        """Wait for every rank; True when all exited with 0."""
        self._stop.set()
        self._watch.join()
        ok = True
        deadline = time.monotonic() + timeout
        for p in self.procs:
            try:
                ok &= p.wait(timeout=max(0.0, deadline - time.monotonic())) == 0
            except subprocess.TimeoutExpired:
                ok = False
        self.kill()
        shutil.rmtree(self.dir, ignore_errors=True)
        return ok


def result(run, man: Manifest, device_name: str, chips: int) -> dict:
    metrics = {}
    if not run.trace:
        for m in man.end_to_end(run.workload):
            metrics[m["name"]] = {"value": float(end_to_end(m["name"])(run)), "unit": m["unit"]}
    else:
        for m in man.per_layer(run.workload):
            v = reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_name, "count": chips, "memory_peak_bytes": int(run.memory_peak_bytes)}
    out = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed, "metrics": metrics,
           "device": device}
    if run.trace and run.traces:
        device["busy_s"] = sum(t["busy_s"] for t in run.traces) / len(run.traces)
        device["window_s"] = run.window_s
        out["breakdown"] = {"device_ops": run.traces[0]["device_ops"], "idle_gaps": run.traces[0]["idle_gaps"]}
    # a number that is not finite (a failed control) is written as null
    out["checks"] = {k: {"value": v if math.isfinite(v) else None, "limit": lim} for k, (v, lim) in run.checks.items()}
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = _args(argv)
    man = Manifest()
    cell = man.cell(args.workload)
    config, traffic, limits = man.config(cell["config"]), man.traffic(cell["traffic"]), man.limits(cell["name"])
    chips = int(cell["chips"])

    import torch

    if not torch.cuda.is_available():
        return fail("PyTorch sees no CUDA device")
    if torch.cuda.device_count() < chips:
        return fail(f"the cell needs {chips} cards, PyTorch sees {torch.cuda.device_count()}")

    from port_bench import guard
    from port_bench.context import Run

    ranks = Ranks(argv, chips) if chips > 1 and args.rank == 0 else None
    run = Run(workload=args.workload, seed=args.seed, seconds=args.seconds, trace=bool(args.trace), cell=cell,
              config=config, traffic=traffic, limits=limits, t0=T0, rank=args.rank, world=chips,
              rendezvous=ranks.dir if ranks is not None else args.rendezvous)
    try:
        kind(traffic["kind"]).run_cell(run)
    finally:
        ranks_ok = ranks.close() if ranks is not None else True
    if args.rank != 0:
        return 0
    if not ranks_ok:
        return fail("a rank did not exit cleanly", 1)
    held = guard.forbidden_modules()
    if held:
        return fail(f"the process holds {', '.join(held)}", 3)
    out = result(run, man, torch.cuda.get_device_name(0), chips)
    for k, (v, lim) in run.checks.items():
        print(f"check {k} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out, allow_nan=False), flush=True)
    return 0 if all(math.isfinite(m["value"]) for m in out["metrics"].values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
