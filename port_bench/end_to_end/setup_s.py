"""Seconds from process start to the first timed frame or step: imports,
CUDA context, the kernels, the scene and the cell's warm-up, less what the
plain reference spent in set-up."""


def read(run):
    return run.setup_s
