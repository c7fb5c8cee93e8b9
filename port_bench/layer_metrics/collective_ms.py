"""Device milliseconds a step of the NCCL kernels (parallel/mesh.py's sums,
parallel/render.py's gradient all-reduce), the largest over ranks."""

from port_bench.trace import op_seconds


def read(run):
    if not run.traces or not run.work.get("steps"):
        return None
    per_rank = [op_seconds(t, r"(?i)nccl") for t in run.traces]
    if not any(n for n, _ in per_rank):
        return None
    return max(1e3 * secs / run.work["steps"] for _, secs in per_rank)
