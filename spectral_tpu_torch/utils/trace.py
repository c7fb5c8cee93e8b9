"""Spans of the program's layers, on the profiler's clock.

``with span("render.pack"):`` marks a layer boundary. Off, the default, a
span checks whether anything records and does nothing else. Recording is on

- while a ``torch.profiler`` profile records the process (checked at each
  span's entry), and
- inside ``with recording():`` (the CLI's ``--do-log``, tests).

A recorded span appends ``Span(name, start_ns, end_ns, parent, request)`` to
an in-memory list, on ``time.perf_counter_ns()``. Under a profiler it also
enters ``torch.profiler.record_function("spectral." + name)``, so the span
lies on the profiler's timeline with the device operations it launched
inside it. ``parent`` is the list index of the enclosing span (-1 at the
top). ``render.frame`` and ``train.step`` (REQUEST_SPANS) each open a new
request id, which every span inside them shares (0 outside any).

``summary()`` reduces the list by name when it is read: count, total and
self seconds (the duration less the child spans'), beside the kernels'
launch counts (ops/cuda/build.py) and the large scenes' leaf packs built
and served again (ops/cuda/render_kernel.py::LEAF_PACKS: a build per
geometry, a reuse per frame or step after it). ``reset()`` clears the
list.

The spans and where they are:

    render.frame      RenderManager.render, a request
    render.wait       its chunk's and image's copies to the host
    render.image      RenderManager.image
    render.pack       render_chunk's pack_scene_frame (a large scene's
                      leaf pack looked up or built, then ordered from the
                      camera)
    render.launch     render_chunk's call into the kernels
    sched.camera, sched.sort, sched.bounce, sched.integrate
                      the sorted scheduler: the camera launch, each
                      bounce's keys, argsort and gathers, the bounce
                      launches, the integrate step
    train.step        train_step_fused, a request
    train.pack, train.forward
                      the fused render's pack and residual forward
    train.replay      the fused render's backward (the replay kernel)
    train.update      the step's p - lr * g
    mesh.all_reduce   Mesh's collectives
    kernel.build, kernel.load, scene.build
                      nvcc, the library load, build_scene (set-up)

A frame's host time, waits on the card left out, is its render.frame less
the render.wait spans inside it.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import torch

PREFIX = "spectral."
REQUEST_SPANS = frozenset(("render.frame", "train.step"))

_profiling = torch._C._autograd._profiler_enabled


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int  # list index of the enclosing span, -1 at the top
    request: int  # id of the enclosing frame or step, 0 outside any


class _Recorder:
    """The process's recorded spans (None while a span is open), the open
    spans as (index, request), innermost last, and the recording() depth."""

    def __init__(self):
        self.depth = 0
        self.requests = 0
        self.spans: list[Span | None] = []
        self.open: list[tuple[int, int]] = []


_REC = _Recorder()


class span:
    """A layer boundary: ``with span("render.pack"): ...``."""

    __slots__ = ("name", "_i", "_spans", "_open", "_rf", "_parent", "_request", "_start")

    def __init__(self, name: str):
        self.name = name
        self._i = -1

    def __enter__(self):
        profiling = _profiling()
        if not (_REC.depth or profiling):
            return self
        rec = _REC
        self._parent, self._request = rec.open[-1] if rec.open else (-1, 0)
        if self.name in REQUEST_SPANS:
            rec.requests += 1
            self._request = rec.requests
        # a reset() while the span is open leaves it writing to the old lists
        self._spans, self._open = rec.spans, rec.open
        self._i = len(self._spans)
        self._spans.append(None)
        self._open.append((self._i, self._request))
        self._rf = None
        if profiling:
            self._rf = torch.profiler.record_function(PREFIX + self.name)
            self._rf.__enter__()
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._i < 0:
            return False
        end = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self._spans[self._i] = Span(self.name, self._start, end, self._parent, self._request)
        # innermost last, except where another thread (autograd's) closes a
        # span out of turn
        for k in range(len(self._open) - 1, -1, -1):
            if self._open[k][0] == self._i:
                del self._open[k]
                break
        self._i = -1
        return False


@contextlib.contextmanager
def recording():
    """Record every span inside the block, profiler or none."""
    _REC.depth += 1
    try:
        yield
    finally:
        _REC.depth -= 1


def records() -> list[Span]:
    """The closed spans recorded since the last reset(), in the order they
    were opened."""
    return [s for s in _REC.spans if s is not None]


def summary() -> dict:
    """``spans``: {name: {"count", "total_s", "self_s"}} over the closed
    spans since the last reset(), where self is the duration less that of
    the span's children; ``launches``: {kernel: launches} of the kernels
    launched since their counts were last zeroed; ``leaf_packs``:
    {"builds", "reuses"} of the large scenes' leaf packs since those counts
    were last zeroed."""
    from ..ops.cuda.build import KERNELS
    from ..ops.cuda.render_kernel import LEAF_PACKS

    spans = _REC.spans
    child_ns = [0] * len(spans)
    for s in spans:
        if s is not None and s.parent >= 0:
            child_ns[s.parent] += s.end_ns - s.start_ns
    out: dict[str, dict] = {}
    for s, c in zip(spans, child_ns):
        if s is None:
            continue
        d = out.setdefault(s.name, {"count": 0, "total_s": 0.0, "self_s": 0.0})
        dur = s.end_ns - s.start_ns
        d["count"] += 1
        d["total_s"] += dur * 1e-9
        d["self_s"] += max(dur - c, 0) * 1e-9
    return {
        "spans": out,
        "launches": {k.name: k.launches for k in KERNELS.values() if k.launches},
        "leaf_packs": {"builds": LEAF_PACKS.builds, "reuses": LEAF_PACKS.reuses},
    }


def reset() -> None:
    """Forget every recorded span."""
    _REC.spans, _REC.open, _REC.requests = [], [], 0
