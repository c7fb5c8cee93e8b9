"""The least time a kernel could take on the card, from the work its inputs
need: the larger of its FP32 operations at the peak rate and its bytes at the
peak bandwidth.

Peaks: NVIDIA H100 SXM data sheet (dense, 700 W): 67 TFLOP/s FP32 outside
the tensor cores, 3.35 TB/s of HBM3. Operation counts per unit of work are
counted from the algorithm as the kernels' sources write it (the triangle
test, the shading step, a sample's camera ray and XYZ, the replay's terms);
the units themselves (live ray-steps, sky misses, materials on a path) come
from the benchmark's own reference, not from the program's counters, so
that a share reads the same work whatever computes it. Bytes count each
input read once and each output written once.
"""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

SWEEP_FLOPS_PER_TRI = 51  # one ray-triangle test: plane, three edge functionals, compare
SHADE_FLOPS_PER_STEP = 340  # one bounce's material fetch, 7 spectral weights, scatter
SAMPLE_FLOPS = 340  # one sample's draws, camera ray, hero comb and XYZ
GRAD_FLOPS_PER_SAMPLE = 189  # the replay: a sample-ray's response over the comb
GRAD_FLOPS_PER_MISS = 56  # a sample-ray that met the sky: the sky's gradient
GRAD_FLOPS_PER_MATERIAL = 203  # each material on a sample-ray's path: its 4 gradients
TRI_FLOATS, MAT_FLOATS, TABLE_FLOATS, CAMERA_FLOATS = 17, 16, 5 * 95, 20
W = 7


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES)


def residual_bytes(sample_rays: float, bounces: int) -> float:
    """Hero, n_valid, 7 powers and a material code a bounce, per sample-ray."""
    return 4.0 * sample_rays * (2 + W + bounces)


def dense_render_work(pixels: float, spp: int, live_steps: float, n_tris: int, n_mats: int,
                      residuals: bool = False, bounces: int = 0) -> tuple[float, float]:
    """(FP32 operations, bytes) of the dense megakernel over ``pixels``
    pixels at ``spp``: a triangle test of every triangle and a shading step
    at each live ray-step, a camera ray and XYZ per sample; the scene, the
    pixel coordinates and the XYZ, and with ``residuals`` what the replay
    will read."""
    flops = live_steps * (SWEEP_FLOPS_PER_TRI * n_tris + SHADE_FLOPS_PER_STEP) + pixels * spp * SAMPLE_FLOPS
    nbytes = 4.0 * (TRI_FLOATS * n_tris + MAT_FLOATS * n_mats + TABLE_FLOATS + CAMERA_FLOATS + 5 * pixels)
    if residuals:
        nbytes += residual_bytes(pixels * spp, bounces)
    return flops, nbytes


def replay_work(pixels: float, spp: int, bounces: int, misses: float, present: float) -> tuple[float, float]:
    """(FP32 operations, bytes) of the replay: every sample-ray's response,
    the sky's term for each that missed, the material terms for each
    (sample-ray, material on its path); it reads the residuals and the XYZ
    cotangent."""
    flops = pixels * spp * GRAD_FLOPS_PER_SAMPLE + misses * GRAD_FLOPS_PER_MISS + present * GRAD_FLOPS_PER_MATERIAL
    nbytes = residual_bytes(pixels * spp, bounces) + 12.0 * pixels
    return flops, nbytes
