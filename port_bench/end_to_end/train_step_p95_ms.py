"""The 95th percentile of every step's time in the window, loss on the host
included."""

from port_bench.context import p95_ms


def read(run):
    return p95_ms(run)
