"""The pinhole camera's frame as the renderer reads it (camera.cu:7-58), in
float32 on the CPU: the 20 numbers centre, pixel00, delta u, delta v,
defocus u, defocus v, the defocus flag and a pad."""

from __future__ import annotations

import math

import numpy as np
import torch


def orbit_lookfrom(lookfrom, lookat, yaw_deg: float) -> tuple:
    """``lookfrom`` turned by ``yaw_deg`` degrees about the vertical axis
    through ``lookat`` (float64)."""
    t = math.radians(yaw_deg)
    c, s = math.cos(t), math.sin(t)
    rx, ry, rz = (float(a) - float(b) for a, b in zip(lookfrom, lookat))
    return (float(lookat[0]) + c * rx + s * rz, float(lookat[1]) + ry, float(lookat[2]) - s * rx + c * rz)


def camera_vector(width: int, height: int, vfov: float, lookfrom, lookat, vup=(0.0, 1.0, 0.0),
                  defocus_angle: float = 0.0, focus_dist: float = 10.0) -> torch.Tensor:
    v3 = lambda x: torch.as_tensor(np.asarray(x, np.float32)).reshape(3)  # noqa: E731
    lookfrom, lookat, vup = v3(lookfrom), v3(lookat), v3(vup)
    h = math.tan(math.radians(vfov) / 2.0) * focus_dist
    vh = 2.0 * h
    vw = vh * (float(width) / float(height))
    w = lookfrom - lookat
    w = w / torch.linalg.vector_norm(w)
    u = torch.linalg.cross(vup, w)
    u = u / torch.linalg.vector_norm(u)
    v = torch.linalg.cross(w, u)
    vu, vv = vw * u, vh * -v
    du, dv = vu / width, vv / height
    upper_left = lookfrom - focus_dist * w - vu / 2 - vv / 2
    p00 = upper_left + 0.5 * (du + dv)
    radius = focus_dist * math.tan(math.radians(defocus_angle / 2.0))
    flag = 1.0 if defocus_angle > 0.0 else 0.0
    return torch.cat([lookfrom, p00, du, dv, u * radius, v * radius, torch.tensor([flag, 0.0])]).to(torch.float32)
