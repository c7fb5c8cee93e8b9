"""Seconds of the program's scene build and pack in set-up (models/scenes.py,
ops/rgb2spec.py, ops/cuda/render_kernel.py::pack_scene_auto), on the
harness's host clock, synchronized."""


def read(run):
    return run.spans.get("scene_build_s")
