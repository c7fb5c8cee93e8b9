"""Where the wall time of a step of the last two examples goes, on the card.

    python scripts/profile_examples.py

Runs, each under ``torch.profiler`` (CPU and CUDA activities) after one
warm call: 40 estimates of examples/inverse_dispersion.py --impl fused (and
40 of its CRN residual alone), 4 estimates of --impl xla and 20 steps of
examples/inverse_field.py, at the examples' own shapes. For each it prints
the wall ms a call under the profiler (slower than an unprofiled call), the
device's busy ms a call (the sum of the kernels' device time, the tables'
"Self CUDA time total" over the calls) and the
ATen calls a call, then the profiler's tables by self CPU time and by self
device time. Needs a CUDA device.
"""

from __future__ import annotations

import os
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from spectral_tpu_torch.examples import inverse_dispersion, inverse_field  # noqa: E402
from spectral_tpu_torch.ops.cuda import build  # noqa: E402


def report(name: str, fn, n: int) -> None:
    fn()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = prof.key_averages()
    # the kernels' own events; an operator's row repeats its kernels' time
    dev_us = sum(e.self_device_time_total for e in ev if e.device_type == DeviceType.CUDA)
    n_ops = sum(e.count for e in ev if e.key.startswith("aten::"))
    print(f"== {name}: {1e3 * wall / n:.2f} ms a call (profiled), device busy {dev_us / 1e3 / n:.3f} ms a call "
          f"({dev_us / 1e4 / wall:.1f}% of wall), {n_ops / n:.0f} aten calls a call", flush=True)
    print(ev.table(sort_by="self_cpu_time_total", row_limit=12, max_name_column_width=48), flush=True)
    print(ev.table(sort_by="self_device_time_total", row_limit=6, max_name_column_width=48), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_examples: PyTorch sees no CUDA device", file=sys.stderr)
        return 1
    build.build_all(build.KERNELS.values())
    dev = torch.device("cuda")
    keys = iter(range(1, 10**6))
    fused = inverse_dispersion.Problem("fused", dev)
    b = fused.b_true + torch.tensor([inverse_dispersion.OFFSET, 0.0, 0.0], device=dev)
    report("fused estimate", lambda: fused.one_grad(b, next(keys), next(keys)), 40)
    report("fused CRN residual", lambda: fused.residual(b, next(keys)), 40)
    xla = inverse_dispersion.Problem("xla", dev)
    report("xla estimate", lambda: xla.one_grad(b, next(keys), next(keys)), 4)
    field = inverse_field.Problem(dev)
    c = field.truth.coeffs[inverse_field.GREEN] + torch.tensor(inverse_field.OFFSET, device=dev)
    report("field step", lambda: field.loss_and_grad(c), 20)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
