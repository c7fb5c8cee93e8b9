"""The readers of the program's spans (``host_ms``, ``pack_host_ms``,
``sched_host_ms``) on a synthetic span summary: the milliseconds they
report, and None in an untraced run, when nothing was recorded, or when
the program has no span module."""

from __future__ import annotations

import sys
import types

import pytest

from port_bench.manifest import Manifest, reader

FIELD = {
    "render.frame": {"count": 4, "total_s": 0.140, "self_s": 0.002},
    "render.wait": {"count": 8, "total_s": 0.100, "self_s": 0.100},
    "render.image": {"count": 4, "total_s": 0.010, "self_s": 0.006},
    "render.pack": {"count": 4, "total_s": 0.008, "self_s": 0.008},
    "render.launch": {"count": 4, "total_s": 0.020, "self_s": 0.004},
    "sched.tables": {"count": 4, "total_s": 0.001, "self_s": 0.001},
    "sched.camera": {"count": 4, "total_s": 0.002, "self_s": 0.002},
    "sched.sort": {"count": 20, "total_s": 0.006, "self_s": 0.006},
    "sched.bounce": {"count": 20, "total_s": 0.005, "self_s": 0.005},
    "sched.integrate": {"count": 4, "total_s": 0.002, "self_s": 0.002},
}
TRAIN = {
    "train.step": {"count": 5, "total_s": 0.015, "self_s": 0.001},
    "train.forward": {"count": 5, "total_s": 0.004, "self_s": 0.004},
    "train.replay": {"count": 5, "total_s": 0.006, "self_s": 0.006},
}


def _run(kind: str, trace: bool = True):
    return types.SimpleNamespace(trace=trace, traffic={"kind": kind})


@pytest.fixture
def spans(monkeypatch):
    """spans(d): the program's summary() gives the span summary ``d``."""
    from spectral_tpu_torch.utils import trace

    def give(d: dict):
        monkeypatch.setattr(trace, "summary", lambda: {"spans": d, "launches": {}})

    return give


@pytest.mark.parametrize("metric, kind, summary, want", [
    ("host_ms.render", "render", FIELD, 1e3 * (0.140 - 0.100) / 4),
    ("pack_host_ms", "render", FIELD, 1e3 * 0.008 / 4),
    ("sched_host_ms", "render", FIELD, 1e3 * (0.001 + 0.002 + 0.006 + 0.005 + 0.002) / 4),
    ("host_ms.train", "train", TRAIN, 1e3 * 0.015 / 5),
])
def test_reader_reports_milliseconds(spans, metric, kind, summary, want):
    spans(summary)
    assert reader(metric)(_run(kind)) == pytest.approx(want)
    assert reader(metric)(_run(kind, trace=False)) is None
    spans({})
    assert reader(metric)(_run(kind)) is None


@pytest.mark.parametrize("metric, kind", [("host_ms.render", "render"), ("host_ms.train", "train"),
                                          ("pack_host_ms", "render"), ("sched_host_ms", "render")])
def test_reader_finds_nothing_in_the_other_kind_or_an_older_program(spans, monkeypatch, metric, kind):
    """A render cell's reader in a training run, and any reader where the
    program has no span module (a checkout from before it), give None."""
    spans(TRAIN if kind == "render" else FIELD)
    assert reader(metric)(_run(kind)) is None
    import spectral_tpu_torch.utils as utils

    spans(FIELD if kind == "render" else TRAIN)
    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "spectral_tpu_torch.utils.trace", None)
    assert reader(metric)(_run(kind)) is None


def test_the_span_metrics_name_their_cells():
    man = Manifest()
    got = {m["name"]: (m["source"], m["workloads"]) for m in man.data["per_layer"] if m["source"] == "program_span"}
    assert got == {
        "host_ms.render": ("program_span", ["cornell-render", "field200k-render"]),
        "host_ms.train": ("program_span", ["cornell-train"]),
        "pack_host_ms": ("program_span", ["field200k-render"]),
        "sched_host_ms": ("program_span", ["field200k-render"]),
    }
    assert reader("host_ms.render") is reader("host_ms.train")
