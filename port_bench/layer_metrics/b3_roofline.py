"""The residual megakernel's (B3, ``render_kernel<true,false>``) share of its
roofline, a launch of one rank's step: live ray-steps counted by the
reference's trace of the followed steps, the residuals written beside the
XYZ."""

from port_bench import roofline
from port_bench.trace import op_seconds


def read(run):
    if not run.traces or "live" not in run.counts:
        return None
    n, secs = op_seconds(run.traces[0], r"render_kernel<true,false>")
    if n == 0:
        return None
    fr = run.frame()
    pixels, spp = fr["width"] * fr["height"], fr["spp"] // int(run.traffic["mesh"][1])
    flops, nbytes = roofline.dense_render_work(pixels, spp, run.counts["live"], run.counts["n_tris"],
                                               run.counts["n_mats"], residuals=True, bounces=fr["bounces"])
    return 100.0 * roofline.least_seconds(flops, nbytes) / (secs / n)
