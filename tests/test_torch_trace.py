"""The program's spans (spectral_tpu_torch/utils/trace.py), on the CPU; no
kernel is built.

(a) Off, a span records nothing and never enters record_function.
(b) Under recording(): self time, parents and request ids.
(c) Under a CPU torch.profiler profile, the spans are profiler events
    named spectral.<name>, nested as recorded.
(d) The layers' spans: a Cornell frame through RenderManager, a multi-leaf
    field chunk through the sorted scheduler, a fused training step.
"""

from __future__ import annotations

import types

import pytest
import torch

from spectral_tpu_torch.config import RenderParams
from spectral_tpu_torch.models.scenes import CORNELL, build_scene, build_tri_field, scene_camera
from spectral_tpu_torch.ops.cuda.render_kernel import render_chunk
from spectral_tpu_torch.parallel import train_step_fused, trainable_params
from spectral_tpu_torch.runtime.render_manager import RenderManager
from spectral_tpu_torch.utils import trace
from spectral_tpu_torch.utils.trace import recording, span

# one torch thread a process: the CPU test run's workers share the cores
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def fresh():
    trace.reset()
    yield
    trace.reset()


def _no_record_function(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("record_function entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)


def test_off_records_nothing(monkeypatch):
    """(a): no profiler and no recording(): nothing is appended, and
    record_function is not entered, off or under recording() alone."""
    _no_record_function(monkeypatch)
    with span("render.frame"):
        with span("render.pack"):
            pass
    assert trace._REC.spans == [] and trace._REC.open == [] and trace.records() == []
    assert trace.summary()["spans"] == {}
    with recording():
        with span("render.frame"):
            pass
    assert [s.name for s in trace.records()] == ["render.frame"]


def test_self_time_parents_and_requests(monkeypatch):
    """(b): on a clock that ticks 1 µs a reading."""
    ticks = iter(range(1000, 10**6, 1000))
    monkeypatch.setattr(trace, "time", types.SimpleNamespace(perf_counter_ns=lambda: next(ticks)))
    with recording():
        with span("render.frame"):  # 1000 .. 6000
            with span("render.pack"):  # 2000 .. 3000
                pass
            with span("render.wait"):  # 4000 .. 5000
                pass
        with span("render.frame"):  # 7000 .. 10000
            with span("render.launch"):  # 8000 .. 9000
                pass
        with span("kernel.load"):  # outside any request
            pass
    recs = trace.records()
    assert [(s.name, s.parent, s.request) for s in recs] == [
        ("render.frame", -1, 1), ("render.pack", 0, 1), ("render.wait", 0, 1),
        ("render.frame", -1, 2), ("render.launch", 3, 2), ("kernel.load", -1, 0),
    ]
    assert (recs[0].start_ns, recs[0].end_ns) == (1000, 6000)
    s = trace.summary()["spans"]
    assert s["render.frame"] == {"count": 2, "total_s": pytest.approx(8e-6), "self_s": pytest.approx(5e-6)}
    assert s["render.wait"] == {"count": 1, "total_s": pytest.approx(1e-6), "self_s": pytest.approx(1e-6)}
    trace.reset()
    assert trace.records() == [] and trace.summary()["spans"] == {}


def test_profiler_sees_the_spans_nested(capfd):
    """(c): recording follows the profiler alone. The profiler (Kineto)
    writes to fd 2 itself, so the test captures at the fd level."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("train.step"):
            with span("train.forward"):
                torch.ones(4).add_(1.0)
    capfd.readouterr()
    assert [(s.name, s.parent, s.request) for s in trace.records()] == [("train.step", -1, 1),
                                                                        ("train.forward", 0, 1)]
    ev = {e.name: e.time_range for e in prof.events() if e.name.startswith(trace.PREFIX)}
    outer, inner = ev["spectral.train.step"], ev["spectral.train.forward"]
    assert outer.start <= inner.start <= inner.end <= outer.end


def _tree(recs):
    return {s.name: recs[s.parent].name if s.parent >= 0 else None for s in recs}


def test_render_manager_frame_spans():
    """(d): an 8x8, 1 spp, 2 bounce Cornell frame: render.frame around the
    pack, the launch, the chunk's and the image's waits and the image, all
    of one request."""
    scene, cam = build_scene(CORNELL, "cpu"), scene_camera(CORNELL, 8, 8, "cpu")
    params = RenderParams(xres=8, aspect_ratio=1.0, nsamples=1, bounce_limit=2, device="cpu", show=False)
    with recording():
        RenderManager(scene, cam, params).render()
    recs = trace.records()
    assert sorted(s.name for s in recs) == ["render.frame", "render.image", "render.launch", "render.pack",
                                            "render.wait", "render.wait"]
    assert {s.request for s in recs} == {1}
    parents = [(s.name, recs[s.parent].name if s.parent >= 0 else None) for s in recs]
    assert sorted(parents, key=str) == sorted([
        ("render.frame", None), ("render.pack", "render.frame"), ("render.launch", "render.frame"),
        ("render.wait", "render.frame"), ("render.image", "render.frame"), ("render.wait", "render.image"),
    ], key=str)


def test_sorted_scheduler_spans():
    """(d): a 520-triangle field chunk through the sorted scheduler: one
    camera launch and integrate step, bounces - 1 sorts and bounces."""
    scene = build_tri_field(520, 3, device="cpu")
    cam = scene_camera(CORNELL, 8, 4, "cpu")
    bounces = 3
    with recording():
        render_chunk(scene, cam, 7, 0, 0, 8, 4, 1, bounces)
    s = trace.summary()["spans"]
    counts = {k: v["count"] for k, v in s.items()}
    assert counts == {"render.pack": 1, "render.launch": 1, "sched.camera": 1, "sched.sort": bounces - 1,
                      "sched.bounce": bounces - 1, "sched.integrate": 1}
    assert all(p == "render.launch" for n, p in _tree(trace.records()).items() if n.startswith("sched."))


def test_train_step_spans():
    """(d): a 4x4, 1 spp, 2 bounce fused step: train.step around the pack,
    the forward, the replay (autograd's backward) and the update."""
    scene, cam = build_scene(CORNELL, "cpu"), scene_camera(CORNELL, 4, 4, "cpu")
    params = {k: v for k, v in trainable_params(scene).items() if k in ("coeffs", "emission_power")}
    with recording():
        train_step_fused(params, scene, cam, torch.zeros((4, 4, 3)), 7, 1, 2, lr=1e-13)
    recs = trace.records()
    assert {s.request for s in recs} == {1}
    assert _tree(recs) == {"train.step": None, "train.pack": "train.step", "train.forward": "train.step",
                           "train.replay": "train.step", "train.update": "train.step"}
