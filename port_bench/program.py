"""The system under test: how the benchmark calls ``spectral_tpu_torch``.

Only the program's public entry points are called here: the scene builders
(one file a scene kind, ``scenes/<kind>.py``), the camera, and the scene
pack that each frame's render makes.
"""

from __future__ import annotations

from .manifest import load
from .reference.camera import orbit_lookfrom


def build_scene(spec: dict, device):
    """The program's scene of a configuration's ``scene`` entry."""
    return load("scenes", spec["kind"]).build(spec, device)


def camera(spec: dict, width: int, height: int, yaw_deg: float, device):
    """The configuration's camera with ``lookfrom`` turned by ``yaw_deg``."""
    import spectral_tpu_torch as st

    return st.make_camera(
        width, height, vfov=float(spec["vfov"]),
        lookfrom=orbit_lookfrom(spec["lookfrom"], spec["lookat"], yaw_deg), lookat=tuple(spec["lookat"]),
        vup=tuple(spec["vup"]), defocus_angle=float(spec["defocus_angle"]), focus_dist=float(spec["focus_dist"]),
        background=(0.0, 0.0, 0.0), device=device,
    )


def pack(scene, cam) -> None:
    """The scene pack a render of ``cam`` makes (dense, or the leaves
    ordered from the camera)."""
    from spectral_tpu_torch.models.camera import camera_vector
    from spectral_tpu_torch.ops.cuda.render_kernel import pack_scene_auto

    pack_scene_auto(scene, camera_vector(cam).to(scene.normal.device))
