"""The 95th percentile of every frame's time in the window, launch to the
uint8 image on the host."""

from port_bench.context import p95_ms


def read(run):
    return p95_ms(run)
