"""The replay's (B4, ``replay_kernel`` and its ``reduce_kernel``) share of
its roofline, one rank's step: sky misses and (sample-ray, material) pairs
counted from the reference's paths of the followed steps."""

from port_bench import roofline
from port_bench.trace import op_seconds

REPLAY = r"\(anonymousnamespace\)::replay_kernel<"


def read(run):
    if not run.traces or "misses" not in run.counts:
        return None
    n, secs = op_seconds(run.traces[0], REPLAY)
    if n == 0:
        return None
    _, reduce_secs = op_seconds(run.traces[0], r"\(anonymousnamespace\)::reduce_kernel<")
    fr = run.frame()
    pixels, spp = fr["width"] * fr["height"], fr["spp"] // int(run.traffic["mesh"][1])
    flops, nbytes = roofline.replay_work(pixels, spp, fr["bounces"], run.counts["misses"], run.counts["present"])
    return 100.0 * roofline.least_seconds(flops, nbytes) / ((secs + reduce_secs) / n)
