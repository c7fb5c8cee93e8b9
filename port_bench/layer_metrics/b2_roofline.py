"""The dense megakernel's (B2, ``render_kernel<false,false>``) share of its
roofline: the least time of a frame's work over the kernel's device time a
launch. The work: every live ray-step tests every triangle and shades once,
every sample makes a camera ray and an XYZ; live ray-steps a path from the
reference's trace of the checked pixels, scaled to the frame."""

from port_bench import roofline
from port_bench.trace import op_seconds


def read(run):
    if not run.traces or "live_per_path" not in run.counts:
        return None
    n, secs = op_seconds(run.traces[0], r"render_kernel<false,false>")
    if n == 0:
        return None
    fr = run.frame()
    pixels, spp = fr["width"] * fr["height"], fr["spp"]
    flops, nbytes = roofline.dense_render_work(pixels, spp, run.counts["live_per_path"] * pixels * spp,
                                               run.counts["n_tris"], run.counts["n_mats"])
    return 100.0 * roofline.least_seconds(flops, nbytes) / (secs / n)
