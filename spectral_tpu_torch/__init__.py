"""spectral_tpu_torch — the PyTorch/CUDA port of the spectral path tracer.

A second package beside the JAX one (``spectral_tpu``), which stays the
reference: hero-wavelength spectral path tracing of the three reference
triangle scenes and the procedural fields of ``build_tri_field``, rendered
by hand-written CUDA kernels for Hopper (sm_90a) and written out as BMP by
the same CLI. Every CUDA kernel has a plain PyTorch twin that runs when
the tensors lie on the CPU.

Public API:

    from spectral_tpu_torch import (
        build_scene, build_tri_field, scene_camera, render_chunk,
        RenderManager, RenderParams, parse_args,
    )

Differentiable rendering and inverse rendering on the fused kernels (the
residual megakernel and its replay):

    from spectral_tpu_torch.diff import render_chunk_diff_fused, render_rays_diff_fused
    from spectral_tpu_torch.parallel import trainable_params, train_step_fused

The XLA-style wavefront renderer, differentiable by autograd, whose
nearest hits the dense intersect kernel selects, and the estimators on it:

    from spectral_tpu_torch.render.wavefront import render_chunk, render_tile_xyz, trace_paths
    from spectral_tpu_torch.diff import render_chunk_diff
    from spectral_tpu_torch.parallel import render_image_sharded, train_step
    from spectral_tpu_torch.models.scenes import with_bvh   # the Karras LBVH walk

Entry points take ``device`` and default to ``"cuda"``; without a GPU they
raise unless the caller passes ``device="cpu"``.
"""

import torch as _torch

# Rendering is float32 throughout. TF32 keeps ~3 decimal digits: in the JAX
# package, reduced-precision matmuls dropped grazing hits and darkened
# renders (spectral_tpu/__init__.py:23-27), so neither matmuls nor cuDNN may
# use it here.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .config import RenderParams, parse_args  # noqa: E402
from .models.camera import Camera, camera_vector, make_camera  # noqa: E402
from .models.scenes import (  # noqa: E402
    CORNELL,
    PRISM,
    SCENE_NAMES,
    TRIS,
    Scene,
    build_scene,
    build_tri_field,
    expected_sizes,
    scene_camera,
)
from .ops.cuda.render_kernel import render_chunk  # noqa: E402
from .render.wavefront import xyz_to_image  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "RenderParams",
    "parse_args",
    "Camera",
    "make_camera",
    "camera_vector",
    "CORNELL",
    "PRISM",
    "TRIS",
    "SCENE_NAMES",
    "Scene",
    "build_scene",
    "build_tri_field",
    "expected_sizes",
    "scene_camera",
    "render_chunk",
    "xyz_to_image",
    "__version__",
]


def __getattr__(name):
    if name == "RenderManager":
        from .runtime.render_manager import RenderManager

        return RenderManager
    raise AttributeError(name)
