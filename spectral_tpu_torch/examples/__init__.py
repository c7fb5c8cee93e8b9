"""The port's inverse-rendering examples, each runnable as
``python -m spectral_tpu_torch.examples.<name> [--device cuda|cpu]``:
``inverse_geometry`` (an occluder's position from vertex gradients) and
``inverse_fuzz`` (a metal's fuzz), both through the warped-area estimators
(diff/vertex_warp.py, diff/fuzz_warp.py)."""
