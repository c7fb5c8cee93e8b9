"""Pinhole / thin-lens camera with the reference's exact viewport math.

Port of spectral_tpu/models/camera.py (reference rendering/camera.cu:7-58,
rendering/camera_builder.cuh). The frame is computed in float32 on the CPU,
in the JAX package's operation order, and then moved to the device, so the
camera is the same on every device. The render kernels generate their own
rays (rendering.cu:66-87) from ``camera_vector``; the XLA-style renderer
(render/wavefront.py) takes them from ``generate_rays``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ..ops.fp32 import fma
from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Camera:
    """Precomputed camera frame (reference camera.cu:7-58 'initialize')."""

    center: torch.Tensor  # lookfrom [3]
    pixel00_loc: torch.Tensor
    pixel_delta_u: torch.Tensor
    pixel_delta_v: torch.Tensor
    defocus_disk_u: torch.Tensor
    defocus_disk_v: torch.Tensor
    background: torch.Tensor  # sRGB background color
    defocus_angle: float
    image_width: int
    image_height: int


def _v3(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).reshape(3)


def make_camera(
    image_width: int,
    image_height: int,
    vfov: float = 90.0,
    lookfrom: Any = (0.0, 0.0, -1.0),
    lookat: Any = (0.0, 0.0, 0.0),
    vup: Any = (0.0, 1.0, 0.0),
    defocus_angle: float = 0.0,
    focus_dist: float = 10.0,
    background: Any = (0.0, 0.0, 0.0),
    device: torch.device | str = "cuda",
) -> Camera:
    device = resolve_device(device)
    lookfrom, lookat, vup = _v3(lookfrom), _v3(lookat), _v3(vup)
    theta = math.radians(vfov)
    h = math.tan(theta / 2.0) * focus_dist
    viewport_height = 2.0 * h
    viewport_width = viewport_height * (float(image_width) / float(image_height))

    w = lookfrom - lookat
    w = w / torch.linalg.vector_norm(w)
    u = torch.linalg.cross(vup, w)
    u = u / torch.linalg.vector_norm(u)
    v = torch.linalg.cross(w, u)

    viewport_u = viewport_width * u
    viewport_v = viewport_height * -v
    pixel_delta_u = viewport_u / image_width
    pixel_delta_v = viewport_v / image_height

    viewport_upper_left = lookfrom - focus_dist * w - viewport_u / 2 - viewport_v / 2
    pixel00_loc = viewport_upper_left + 0.5 * (pixel_delta_u + pixel_delta_v)

    defocus_radius = focus_dist * math.tan(math.radians(defocus_angle / 2.0))
    return camera_from_numpy(
        dict(
            center=lookfrom,
            pixel00_loc=pixel00_loc,
            pixel_delta_u=pixel_delta_u,
            pixel_delta_v=pixel_delta_v,
            defocus_disk_u=u * defocus_radius,
            defocus_disk_v=v * defocus_radius,
            background=_v3(background),
            defocus_angle=defocus_angle,
            image_width=image_width,
            image_height=image_height,
        ),
        device,
    )


def camera_from_numpy(d: dict, device: torch.device | str = "cuda") -> Camera:
    """A Camera from its fields given as arrays (numpy or tensors) under the
    JAX Camera's names: carries a JAX camera into the port."""
    device = resolve_device(device)
    vec = lambda k: torch.from_numpy(np.array(d[k], np.float32)).reshape(3).to(device)  # noqa: E731
    return Camera(
        center=vec("center"),
        pixel00_loc=vec("pixel00_loc"),
        pixel_delta_u=vec("pixel_delta_u"),
        pixel_delta_v=vec("pixel_delta_v"),
        defocus_disk_u=vec("defocus_disk_u"),
        defocus_disk_v=vec("defocus_disk_v"),
        background=vec("background"),
        defocus_angle=float(d["defocus_angle"]),
        image_width=int(d["image_width"]),
        image_height=int(d["image_height"]),
    )


def camera_vector(cam: Camera) -> torch.Tensor:
    """The frame as the render kernel's 20 scalars (center, pixel00,
    delta_u, delta_v, defocus_u, defocus_v, has_defocus flag, pad);
    port of render_kernel.py:3240."""
    has_defocus = 1.0 if float(cam.defocus_angle) > 0.0 else 0.0
    return torch.cat(
        [
            cam.center,
            cam.pixel00_loc,
            cam.pixel_delta_u,
            cam.pixel_delta_v,
            cam.defocus_disk_u,
            cam.defocus_disk_v,
            torch.tensor([has_defocus, 0.0], dtype=torch.float32, device=cam.center.device),
        ]
    ).to(torch.float32)


def chunk_pixels(x0: int, y0: int, width: int, height: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-major integer pixel coordinates (px, py) [height * width] of a
    chunk."""
    ys, xs = torch.meshgrid(
        torch.arange(y0, y0 + height, device=device),
        torch.arange(x0, x0 + width, device=device),
        indexing="ij",
    )
    return xs.reshape(-1), ys.reshape(-1)


def generate_rays(
    cam: Camera,
    px: torch.Tensor,
    py: torch.Tensor,
    jitter: torch.Tensor,
    disk: torch.Tensor | None = None,
    stratify: tuple[int, int] | None = None,
    screen_warp=None,
):
    """Batched camera rays (spectral_tpu/models/camera.py:88; reference
    rendering.cu:66-87) for integer pixel coordinates px (column), py (row)
    [N]. Returns (origins [N, 3], directions [N, 3]); the directions are
    not normalized, as in the reference.

    ``jitter`` [N, 2]: uniforms in [0, 1) that place the sample in its
    pixel (pixel_sample_square, rendering.cu:49-56). ``disk`` [N, 2]:
    points in the unit disk (utils/prng.py::random_in_unit_disk) for the
    thin lens, read only when ``cam.defocus_angle > 0``.
    ``stratify=(idx, g)`` places the sample in stratum ``idx`` of a g x g
    subdivision of the pixel instead (get_ray_stratified_sample,
    rendering.cu:89-118). The sums are fused as XLA's CPU backend fuses the
    JAX expressions (ops/fp32.py).

    ``screen_warp(fx, fy)`` -> (fx', fy', det): the vertex-gradient screen
    warp (diff/vertex_warp.py::warp_pixel_samples) of the continuous pixel
    coordinates px + jitter, py + jitter (camera.py:119-147). The pixel is
    then pixel00 + fx' du + fy' dv, and (origins, directions, det) are
    returned; the caller multiplies det into the sample."""
    jit = jitter - 0.5
    if stratify is not None:
        idx, g = stratify
        cell = 1.0 / float(g)
        u = jitter * cell
        jit = torch.stack([(idx % g) * cell + u[:, 0] - 0.5, (idx // g) * cell + u[:, 1] - 0.5], dim=-1)
    n = px.shape[0]
    det = None
    if screen_warp is not None:
        fx, fy, det = screen_warp(px.to(torch.float32) + jit[:, 0], py.to(torch.float32) + jit[:, 1])
        terms = ((fx, cam.pixel_delta_u), (fy, cam.pixel_delta_v))
    else:
        terms = ((px.to(torch.float32), cam.pixel_delta_u), (py.to(torch.float32), cam.pixel_delta_v),
                 (jit[:, 0], cam.pixel_delta_u), (jit[:, 1], cam.pixel_delta_v))
    pixel = cam.pixel00_loc.expand(n, 3)
    for s, delta in terms:
        pixel = fma(s[:, None], delta, pixel)
    if cam.defocus_angle > 0.0:
        if disk is None:
            raise ValueError("a camera with defocus_angle > 0 needs disk samples")
        origin = fma(disk[:, 0:1], cam.defocus_disk_u, cam.center)
        origin = fma(disk[:, 1:2], cam.defocus_disk_v, origin)
    else:
        origin = cam.center.expand(n, 3)
    if det is not None:
        return origin, pixel - origin, det
    return origin, pixel - origin
