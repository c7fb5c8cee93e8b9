"""The reduction of a profiler trace: device busy time, ops by name, idle
gaps by the harness span the host was in."""

from __future__ import annotations

import types

import pytest
from torch.autograd import DeviceType

from port_bench.trace import op_seconds, summarize


def ev(name, start_us, end_us, dev=True, annotation=False):
    return types.SimpleNamespace(name=name, device_type=DeviceType.CUDA if dev else DeviceType.CPU,
                                 time_range=types.SimpleNamespace(start=start_us, end=end_us),
                                 is_user_annotation=annotation)


def test_busy_is_the_union_and_spans_are_no_device_ops():
    events = [
        ev("bench.frame", 0, 1000, dev=False), ev("bench.frame", 0, 1000, dev=True),
        ev("k<false, false>", 100, 400), ev("copy", 300, 500), ev("k<false, false>", 700, 900),
        ev("bench.frame", 1000, 2000, dev=False), ev("k<false, false>", 1200, 1300),
        ev("nccl:all_reduce", 1300, 1900, annotation=True),
    ]
    s = summarize(events, window_s=2e-3)
    assert s["busy_s"] == pytest.approx((400 + 200 + 100) * 1e-6)
    assert "bench.frame" not in s["ops"] and "nccl:all_reduce" not in s["ops"]
    assert op_seconds(s, r"k<false,false>") == (3, pytest.approx(600e-6))
    gaps = dict(s["idle_gaps"])
    assert gaps["frame"] == pytest.approx((200 + 300) * 1e-6)
