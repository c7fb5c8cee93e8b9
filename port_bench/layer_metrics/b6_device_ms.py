"""Device milliseconds a frame of the sorted scheduler's kernels (B6: the
camera bounce, the bounces, the integrate step and its spp sum;
csrc/wavefront_kernel.cu)."""

from port_bench.trace import op_seconds

B6 = r"(camera_bounce_kernel|::bounce_kernel|integrate_kernel|sum_slots_kernel)<"


def read(run):
    if not run.traces or not run.work.get("frames"):
        return None
    n, secs = op_seconds(run.traces[0], B6)
    return 1e3 * secs / run.work["frames"] if n else None
