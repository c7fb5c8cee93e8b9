"""Device milliseconds a frame of every device operation of a sorted-scheduler
frame other than its kernels: the sort and gather of ray states, the state
set-up, the copies."""

from port_bench.trace import op_seconds

B6 = r"(camera_bounce_kernel|::bounce_kernel|integrate_kernel|sum_slots_kernel)<"


def read(run):
    if not run.traces or not run.work.get("frames"):
        return None
    n_b6, b6 = op_seconds(run.traces[0], B6)
    if not n_b6:
        return None
    total = sum(secs for _, secs in run.traces[0]["ops"].values())
    return 1e3 * (total - b6) / run.work["frames"]
