"""The roofline's counts at a small shape, and the readers that divide them
by a traced kernel time."""

from __future__ import annotations

import time

import pytest

from port_bench import roofline
from port_bench.context import Run
from port_bench.manifest import reader


def test_least_seconds_is_the_larger_bound():
    assert roofline.least_seconds(67e12, 0.0) == pytest.approx(1.0)
    assert roofline.least_seconds(0.0, 3.35e12) == pytest.approx(1.0)
    assert roofline.least_seconds(67e9, 3.35e12) == pytest.approx(1.0)


def test_dense_render_work_at_a_small_shape():
    # 4 pixels, 2 spp, 10 live ray-steps, 3 triangles, 2 materials
    flops, nbytes = roofline.dense_render_work(4, 2, 10, 3, 2)
    assert flops == 10 * (51 * 3 + 340) + 4 * 2 * 340
    assert nbytes == 4 * (17 * 3 + 16 * 2 + 475 + 20 + 5 * 4)
    _, with_res = roofline.dense_render_work(4, 2, 10, 3, 2, residuals=True, bounces=5)
    assert with_res - nbytes == 4 * 4 * 2 * (2 + 7 + 5)


def test_replay_work_at_a_small_shape():
    flops, nbytes = roofline.replay_work(4, 2, 5, misses=3, present=11)
    assert flops == 8 * 189 + 3 * 56 + 11 * 203
    assert nbytes == 4 * 8 * (2 + 7 + 5) + 12 * 4


def _run(traffic=None, frame=None):
    r = Run(workload="w", seed=1, seconds=1.0, trace=True, cell={}, config={"frames": {"f": frame}},
            traffic={"frame": "f", "mesh": [1, 1], **(traffic or {})}, limits={}, t0=time.perf_counter())
    return r


def test_b2_roofline_reads_the_traced_kernel():
    r = _run(frame={"width": 10, "height": 10, "spp": 4, "bounces": 3})
    r.counts.update(live_per_path=2.5, n_tris=42, n_mats=7)
    secs = 3 * 1e-3
    r.traces = [{"ops": {"void (anonymous namespace)::render_kernel<false, false>(float const*)": [3, secs]}}]
    flops, nbytes = roofline.dense_render_work(100, 4, 2.5 * 400, 42, 7)
    want = 100.0 * roofline.least_seconds(flops, nbytes) / 1e-3
    assert reader("b2_roofline")(r) == pytest.approx(want)


def test_readers_return_nothing_without_a_trace():
    r = _run(frame={"width": 10, "height": 10, "spp": 4, "bounces": 3})
    for name in ("b2_roofline", "b3_roofline", "b4_roofline", "b6_device_ms", "glue_device_ms", "collective_ms",
                 "device_idle_pct.render", "device_idle_pct.train", "scene_build_s"):
        assert reader(name)(r) is None


def test_b4_roofline_counts_only_the_programs_reduce():
    r = _run(frame={"width": 10, "height": 10, "spp": 4, "bounces": 3})
    r.counts.update(misses=50, present=700)
    r.traces = [{"ops": {
        "void (anonymous namespace)::replay_kernel<true, false, true>(float const*)": [2, 2e-3],
        "void (anonymous namespace)::reduce_kernel<true, false, true>(float const*)": [2, 2e-4],
        "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>(float)": [9, 5.0],
    }}]
    flops, nbytes = roofline.replay_work(100, 4, 3, 50, 700)
    want = 100.0 * roofline.least_seconds(flops, nbytes) / 1.1e-3
    assert reader("b4_roofline")(r) == pytest.approx(want)
