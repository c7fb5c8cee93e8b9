"""Millions of nominal ray-steps (width x height x spp x bounces of every
frame finished) a second of the window."""

from port_bench import stats


def read(run):
    return stats.rate(run.work["ray_steps"], run.window_s) / 1e6
