"""Rates and tails are taken over every request of the window."""

from __future__ import annotations

import time

import numpy as np
import pytest

from port_bench import stats
from port_bench.context import Run
from port_bench.manifest import end_to_end


def _run(latencies, work, window_s):
    r = Run(workload="w", seed=1, seconds=window_s, trace=False, cell={}, config={}, traffic={}, limits={},
            t0=time.perf_counter())
    r.latencies_s, r.work, r.window_s = list(latencies), dict(work), window_s
    return r


@pytest.mark.parametrize("n", [1, 2, 7, 120, 401])
def test_percentile_is_numpys_over_all_values(n):
    xs = np.random.default_rng(n).exponential(size=n)
    for q in (50, 95, 99):
        assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)), rel=1e-12)


def test_p95_and_rate_over_all_frames_of_the_window():
    lat = [0.030] * 190 + [0.050] * 10  # a tail of 5% of the frames
    r = _run(lat, {"ray_steps": 200 * 3_145_728, "frames": 200}, sum(lat))
    assert end_to_end("frame_p95_ms")(r) == pytest.approx(1e3 * stats.percentile(lat, 95))
    assert 30.0 < end_to_end("frame_p95_ms")(r) < 50.0
    assert end_to_end("render_mrays_s")(r) == pytest.approx(200 * 3_145_728 / sum(lat) / 1e6)


def test_train_step_ms_is_the_window_over_the_steps():
    r = _run([0.02, 0.03, 0.025], {"steps": 3}, 0.075)
    assert end_to_end("train_step_ms")(r) == pytest.approx(25.0)
    assert end_to_end("train_step_p95_ms")(r) == pytest.approx(1e3 * stats.percentile([0.02, 0.03, 0.025], 95))


def test_setup_s_leaves_out_the_references_seconds():
    r = _run([], {}, 0.0)
    with r.aside():
        time.sleep(0.05)
    r.end_setup()
    assert end_to_end("setup_s")(r) == r.setup_s
    assert r.aside_s >= 0.05 and r.setup_s == pytest.approx(time.perf_counter() - r.t0 - r.aside_s, abs=0.01)


def test_rate_refuses_an_empty_window():
    with pytest.raises(ValueError):
        stats.rate(1.0, 0.0)
