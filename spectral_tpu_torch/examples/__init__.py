"""The port's inverse-rendering examples, each runnable as
``python -m spectral_tpu_torch.examples.<name> [--device cuda|cpu]``:
``inverse_rendering`` (a wall's reflectance spectrum, through the
XLA-style renderer's gradients, on one device or on the mesh over a world
of processes), ``inverse_geometry`` (an occluder's position from vertex
gradients) and ``inverse_fuzz`` (a metal's fuzz), both through the
warped-area estimators (diff/vertex_warp.py, diff/fuzz_warp.py)."""
