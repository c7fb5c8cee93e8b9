"""The traced run: torch.profiler over the measured window, reduced to what
the per-layer readers and the result's ``device`` and ``breakdown`` need.

The harness marks its own spans with ``span(name)`` (record_function), so
that an idle gap of the device can be put down to what the host was doing.
"""

from __future__ import annotations

import bisect
import contextlib
import re

import torch
from torch.autograd import DeviceType

SPAN_PREFIX = "bench."
TOP = 10
_NAME_MAX = 160
# spans looked back through for the innermost one around a gap
_LOOKBACK = 64


@contextlib.contextmanager
def span(name: str):
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


def kernel_key(name: str) -> str:
    """A device op's name without spaces, for matching."""
    return re.sub(r"\s+", "", name)


class Tracer:
    """Profiles CPU and CUDA activity between ``start`` and ``stop`` when
    enabled; ``summary`` then holds the reduction (``summarize``)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.summary = None

    def start(self) -> None:
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()

    def stop(self, window_s: float) -> None:
        if self.prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.prof.__exit__(None, None, None)
            self.summary = summarize(self.prof.events(), window_s)
            self.prof = None


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events, window_s: float) -> dict:
    """From profiler events: ``ops`` {device op name: [count, seconds]},
    ``busy_s`` (the union of the device ops' intervals), ``window_s``,
    ``device_ops`` (the TOP ops by seconds) and ``idle_gaps`` (the device's
    idle time inside the traced activity, by the innermost harness span the
    host was in at each gap's middle; "outside any span" otherwise)."""
    dev, spans = [], []
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CPU:
            if e.name.startswith(SPAN_PREFIX):
                spans.append((tr.start, tr.end, e.name[len(SPAN_PREFIX):]))
        elif e.device_type == DeviceType.CUDA and not (
            # a span (the harness's, or PyTorch's such as "nccl:all_reduce")
            # that the profiler also draws on the device: no operation
            getattr(e, "is_user_annotation", False) or e.name.startswith(SPAN_PREFIX)
        ):
            dev.append((e.name, tr.start, tr.end))
    ops: dict[str, list] = {}
    for name, s, e in dev:
        rec = ops.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += (e - s) * 1e-6
    merged = _merge([(s, e) for _, s, e in dev])
    busy = sum(e - s for s, e in merged) * 1e-6
    spans.sort()
    starts = [s for s, _, _ in spans]
    gaps: dict[str, float] = {}
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = 0.5 * (e0 + s1)
        label = "outside any span"
        last = bisect.bisect_right(starts, mid) - 1
        for i in range(last, max(last - _LOOKBACK, -1), -1):
            s, e, name = spans[i]
            if e >= mid:
                label = name
                break
        gaps[label] = gaps.get(label, 0.0) + (s1 - e0) * 1e-6
    top = sorted(ops.items(), key=lambda kv: -kv[1][1])[:TOP]
    return {
        "ops": ops,
        "busy_s": busy,
        "window_s": window_s,
        "device_ops": [[n[:_NAME_MAX], v[1]] for n, v in top],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:TOP],
    }


def op_seconds(summary: dict, pattern: str) -> tuple[int, float]:
    """(launches, device seconds) of the ops whose space-free name matches
    the regular expression ``pattern``."""
    rx = re.compile(pattern)
    n, t = 0, 0.0
    for name, (count, secs) in summary["ops"].items():
        if rx.search(kernel_key(name)):
            n += count
            t += secs
    return n, t
