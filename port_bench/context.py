"""What one run of one cell knows: its arguments, the cell's configuration
and traffic, the clock, and what the window and the check found. Loops fill
it; end-to-end metrics and per-layer readers read it."""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np

from . import stats


@dataclasses.dataclass
class Run:
    workload: str
    seed: int
    seconds: float
    trace: bool
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    t0: float  # process start, perf_counter
    device: str = "cuda"
    rank: int = 0
    world: int = 1
    rendezvous: str = ""  # directory of a run over several processes
    spans: dict = dataclasses.field(default_factory=dict)  # harness clock, seconds
    setup_s: float = 0.0
    aside_s: float = 0.0  # the plain reference's seconds inside set-up
    window_s: float = 0.0
    latencies_s: list = dataclasses.field(default_factory=list)  # every request of the window
    work: dict = dataclasses.field(default_factory=dict)  # nominal work of the window
    counts: dict = dataclasses.field(default_factory=dict)  # what the reference counted
    traces: list = dataclasses.field(default_factory=list)  # one trace summary per rank
    checks: dict = dataclasses.field(default_factory=dict)  # name -> (value, limit)
    memory_peak_bytes: int = 0
    attempted: int = 0
    failed: int = 0

    @contextlib.contextmanager
    def clock(self, name: str):
        t = time.perf_counter()
        yield
        self.spans[name] = time.perf_counter() - t

    @contextlib.contextmanager
    def aside(self):
        """Time spent here in set-up is the reference's, not the program's:
        ``setup_s`` leaves it out."""
        t = time.perf_counter()
        yield
        self.aside_s += time.perf_counter() - t

    def rng(self, *keys: int) -> np.random.Generator:
        """A generator drawn from the seed and ``keys`` (any whole numbers)."""
        return np.random.default_rng([k % (1 << 64) for k in (self.seed, *keys)])

    def end_setup(self) -> None:
        self.setup_s = time.perf_counter() - self.t0 - self.aside_s

    def frame(self) -> dict:
        """The traffic's frame of the configuration: width, height, spp,
        bounces (and the rest the configuration gives it)."""
        return self.config["frames"][self.traffic["frame"]]

    def check(self, name: str, value: float) -> None:
        self.checks[name] = (float(value), float(self.limits[name]))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(v <= lim for v, lim in self.checks.values())


def p95_ms(run: Run) -> float:
    return 1e3 * stats.percentile(run.latencies_s, 95)
