"""The three hard-coded reference scenes + the Scene dataclass.

Port of spectral_tpu/models/scenes.py. Scene ids match the reference CLI
(io/params.h:15-19): CORNELL=0, PRISM=1, TRIS=2. Geometry and material
tables replicate scene/scene.cu:73-226 construction-for-construction;
cameras replicate scene.cu:259-320.

The build runs on the host (numpy geometry, float32 torch for the material
spectra) and the finished arrays move to the device in one step, so a scene
is the same on every device. ``scene_from_numpy`` is that step on its own:
given the JAX package's Scene arrays under the same names (and its LBVH
tables, when the JAX scene has one), it carries them into the port
unchanged; ``params_from_numpy`` does the same for the trainable material
leaves. ``with_bvh`` attaches a Karras LBVH (ops/bvh.py) that the XLA-style
renderer walks instead of its dense nearest hit.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..ops.rgb2spec import srgb_to_illuminance_spectrum
from ..utils.device import resolve_device
from .camera import Camera, make_camera
from .geometry import TriSoup, finalize
from .materials import MaterialBuilder, Materials

CORNELL = 0
PRISM = 1
TRIS = 2

SCENE_NAMES = {CORNELL: "cornell", PRISM: "prism", TRIS: "tris"}

# the blue of build_diffuse_field (scratch/r5_vwarp_chip.py:51)
DIFFUSE_FIELD_BLUE = (0.2, 0.3, 0.6)

# material row of the BK7 dielectric in build_tri_field(glass=True)
# (builder order: white, red, green, metal, light, then the preset)
FIELD_GLASS_MAT = 5

_TRI_FIELDS = (
    "v0", "v1", "v2", "normal", "d", "mat_index", "edge_g", "edge_c",
    "bbox_min", "bbox_max",
)


@dataclasses.dataclass(frozen=True)
class Scene:
    """Device-side scene: triangle SoA + materials + background spectrum."""

    v0: torch.Tensor  # [T, 3]
    v1: torch.Tensor
    v2: torch.Tensor
    normal: torch.Tensor  # [T, 3] unit
    d: torch.Tensor  # [T]
    mat_index: torch.Tensor  # [T] int32
    edge_g: torch.Tensor  # [T, 3, 3]
    edge_c: torch.Tensor  # [T, 3]
    bbox_min: torch.Tensor  # [T, 3]
    bbox_max: torch.Tensor  # [T, 3]
    materials: Materials
    background_spd: torch.Tensor  # [95]
    # an LBVH (ops/bvh.py): the XLA-style renderer walks it instead of the
    # dense nearest hit when set (with_bvh); the render kernels ignore it
    bvh: object = None

    @property
    def num_tris(self) -> int:
        return self.v0.shape[0]


def _tensor(x, device) -> torch.Tensor:
    t = torch.as_tensor(np.array(x))  # a copy: JAX arrays are read-only
    if t.is_floating_point():
        t = t.to(torch.float32)
    elif t.dtype != torch.bool:
        t = t.to(torch.int32)
    return t.to(device)


_BVH_TABLES = ("node_min", "node_max", "left", "right", "leaf_start", "order")


def scene_from_numpy(d: dict, device: torch.device | str = "cuda") -> Scene:
    """A Scene from its arrays under the JAX Scene's field names:
    ``d["materials"]`` holds the Materials fields, every other key a
    triangle field or ``background_spd``, and ``d["bvh"]``, when present,
    the LBVH's tables under the JAX LBVH's names with its ``leaf_size`` and
    ``n_tris``. Float arrays become float32 and integer arrays int32
    tensors on ``device`` (the LBVH's index tables int64)."""
    device = resolve_device(device)
    bvh = None
    if d.get("bvh") is not None:
        from ..ops.bvh import LBVH

        b = d["bvh"]
        tables = {k: _tensor(b[k], device) for k in _BVH_TABLES}
        tables.update({k: v.long() for k, v in tables.items() if not v.is_floating_point()})
        bvh = LBVH(**tables, leaf_size=int(b["leaf_size"]), n_tris=int(b["n_tris"]))
    mats = Materials(
        **{
            f.name: _tensor(d["materials"][f.name], device)
            for f in dataclasses.fields(Materials)
        }
    )
    return Scene(
        **{k: _tensor(d[k], device) for k in _TRI_FIELDS},
        materials=mats,
        background_spd=_tensor(d["background_spd"], device),
        bvh=bvh,
    )


def with_bvh(scene: Scene, leaf_size: int = 8) -> Scene:
    """The scene with a Karras LBVH attached (scenes.py:275): the XLA-style
    renderer then walks it instead of the dense nearest hit (worth it above
    O(128) triangles)."""
    from ..ops.bvh import build_lbvh

    return dataclasses.replace(scene, bvh=build_lbvh(scene.bbox_min, scene.bbox_max, leaf_size))


def params_from_numpy(d: dict, device: torch.device | str = "cuda") -> dict:
    """The trainable-leaf dict (parallel/render.py::trainable_params' keys)
    from numpy arrays, e.g. the JAX package's leaves, as float32 tensors on
    ``device``."""
    device = resolve_device(device)
    return {k: _tensor(v, device) for k, v in d.items()}


def _cornell_walls(soup: TriSoup, wall_mats: tuple[int, int, int, int, int], light_mat: int):
    """Shared 5-wall + ceiling-light layout (scene.cu:85-107 / 146-168 /
    193-215). wall order: bottom, back, top, left, right."""
    b, bk, t, l, r = wall_mats
    soup.quad((0, 0, 0), (0, 0, 555), (555, 0, 0), b)
    soup.quad((0, 0, 555.0), (0, 555, 0), (555, 0, 0), bk)
    soup.quad((555, 555, 555), (-555, 0, 0), (0, 0, -555), t)
    soup.quad((555, 0, 0), (0, 0, 555), (0, 555, 0), l)
    soup.quad((0, 0, 0), (0, 555, 0), (0, 0, 555), r)
    cx, cy, cz = 555.0 / 2.0, 554.0, 555.0 / 2.0
    w, dep = 100.0, 100.0
    soup.quad((cx + w / 2, cy, cz + dep / 2), (-w, 0, 0), (0, 0, -dep), light_mat)


def _boxes_and_pyramid(soup: TriSoup, box1_mats, box2_mats, pyr_mat: int):
    """box1 + box2 + pyramid block shared by CORNELL and TRIS
    (scene.cu:115-129 / 216-226)."""
    s = len(soup)
    soup.box((0, 0, 0), (165, 330, 165), box1_mats)
    soup.rotate(s, math.radians(25.0), "Y", pivot=soup.slice_bbox_center(s, len(soup)))
    soup.translate(s, (265.0, 0.0, 295.0))

    s = len(soup)
    soup.box((0, 0, 0), (165, 165, 165), box2_mats)
    soup.rotate(s, math.radians(-18.0), "Y", pivot=soup.slice_bbox_center(s, len(soup)))
    soup.translate(s, (130.0, 0.0, 65.0))

    s = len(soup)
    soup.pyramid((165.0, 166.0, 0.0), (-165.0, 0, 0), (0, 0, 165.0), (0, 165.0, 0), pyr_mat)
    # pyramid::rotate pivots on base_center() (pyramid.cu:15-37); the base
    # quad is the first 2 tris of the slice
    soup.rotate(s, math.radians(-18.0), "Y", pivot=soup.slice_vertex_mean(s, s + 2))
    soup.translate(s, (130.0, 0.0, 65.0))


def build_cornell() -> tuple[TriSoup, Materials]:
    """Cornell box, 42 tris / 7 materials (scene.cu:73-130)."""
    mb = MaterialBuilder()
    red = mb.lambertian((0.65, 0.05, 0.05))
    green = mb.lambertian((0.12, 0.45, 0.15))
    glass = mb.dielectric_preset("flint_glass")
    white = mb.lambertian((0.73, 0.73, 0.73))
    light = mb.emissive((1.0, 1.0, 1.0), 5.0)
    metal = mb.metallic((0.5, 0.5, 0.5), 0.3)
    blue = mb.lambertian((0.12, 0.15, 0.45))

    soup = TriSoup()
    _cornell_walls(soup, (white, white, white, green, blue), light)
    _boxes_and_pyramid(soup, metal, red, glass)
    return soup, mb.build()


def build_prism() -> tuple[TriSoup, Materials]:
    """Dispersive prism scene, 20 tris / 3 materials (scene.cu:132-173)."""
    mb = MaterialBuilder()
    white = mb.lambertian((0.73, 0.73, 0.73))
    light = mb.emissive((1.0, 1.0, 1.0), 5.0)
    glass = mb.dielectric_preset("flint_glass")

    soup = TriSoup()
    _cornell_walls(soup, (white, white, white, white, white), light)

    cx, cy, cz = 555.0 / 2.0, 554.0, 555.0 / 2.0
    w = 100.0
    pw, ph = 165.0, 200.0
    s = len(soup)
    soup.prism(
        (cx - w / 2.0, cy - 1.0, cz - ph / 2.0),
        (0.0, -pw, 0.0),
        (pw * math.sqrt(3.0) / 2.0, -pw / 2.0, 0.0),
        (0.0, 0.0, 200.0),
        glass,
    )
    # prism::rotate(local=true) pivots on the mean of the 6 base vertices
    # (prism.cuh:45-56); base tris are the slice's first two
    soup.rotate(s, math.radians(10.0), "Y", pivot=soup.slice_vertex_mean(s, s + 2))
    return soup, mb.build()


def build_tris() -> tuple[TriSoup, Materials]:
    """Mixed-materials scene, 42 tris / 9 materials (scene.cu:175-226)."""
    mb = MaterialBuilder()
    red = mb.lambertian((0.65, 0.05, 0.05))
    green = mb.lambertian((0.12, 0.45, 0.15))
    flint = mb.dielectric_preset("flint_glass")
    white = mb.lambertian((0.73, 0.73, 0.73))
    light = mb.emissive((1.0, 1.0, 1.0), 5.0)
    metal = mb.metallic((0.5, 0.5, 0.5), 0.3)
    blue = mb.lambertian((0.12, 0.15, 0.45))
    bk7 = mb.dielectric_preset("BK7")
    metal2 = mb.metallic((0.7, 0.7, 0.7), 0.8)

    soup = TriSoup()
    _cornell_walls(soup, (blue, green, flint, metal2, metal), light)
    _boxes_and_pyramid(
        soup,
        (white, metal2, red, green, flint, white),
        (bk7, blue, metal2, bk7, green, flint),
        flint,
    )
    return soup, mb.build()


_BUILDERS = {CORNELL: build_cornell, PRISM: build_prism, TRIS: build_tris}


def scene_camera(
    scene_id: int, image_width: int, image_height: int, device: torch.device | str = "cuda"
) -> Camera:
    """All three reference scenes share the same pose (scene.cu:259-320)."""
    return make_camera(
        image_width,
        image_height,
        vfov=40.0,
        lookfrom=(278.0, 278.0, -800.0),
        lookat=(278.0, 278.0, 0.0),
        vup=(0.0, 1.0, 0.0),
        defocus_angle=0.0,
        focus_dist=10.0,
        background=(0.0, 0.0, 0.0),
        device=device,
    )


def _scene_arrays(soup: TriSoup, mats: Materials, background=(0.0, 0.0, 0.0)) -> dict:
    """The numpy arrays of a finished soup and its materials under the
    illuminant of the sRGB colour ``background`` (scenes.py:64)."""
    d = dict(finalize(soup))
    d["materials"] = {
        f.name: getattr(mats, f.name).numpy() for f in dataclasses.fields(Materials)
    }
    d["background_spd"] = srgb_to_illuminance_spectrum(
        torch.tensor(background, dtype=torch.float32)
    ).numpy()
    return d


def scene_from_soup(soup: TriSoup, mats: Materials, device: torch.device | str = "cuda",
                    background=(0.0, 0.0, 0.0)) -> Scene:
    """A Scene of a finished soup and its materials under the sky of the
    sRGB colour ``background`` (black by default), on ``device``
    (scenes.py:64 ``_scene_from``)."""
    return scene_from_numpy(_scene_arrays(soup, mats, background), device)


@functools.lru_cache(maxsize=None)
def _host_scene(scene_id: int) -> dict:
    """The scene's arrays as numpy, built once per process."""
    return _scene_arrays(*_BUILDERS[scene_id]())


def build_scene(scene_id: int, device: torch.device | str = "cuda") -> Scene:
    return scene_from_numpy(_host_scene(scene_id), device)


def expected_sizes(scene_id: int) -> tuple[int, int]:
    """(num_tris, num_materials) golden counts (scene.cu:228-257)."""
    return {CORNELL: (42, 7), PRISM: (20, 3), TRIS: (42, 9)}[scene_id]


@functools.lru_cache(maxsize=4)
def _host_tri_field(n_tris: int, seed: int, glass: bool, diffuse: bool = False) -> dict:
    rng = np.random.RandomState(seed)
    mb = MaterialBuilder()
    white = mb.lambertian((0.73, 0.73, 0.73))
    red = mb.lambertian((0.65, 0.05, 0.05))
    green = mb.lambertian((0.12, 0.45, 0.15))
    metal = mb.lambertian(DIFFUSE_FIELD_BLUE) if diffuse else mb.metallic((0.8, 0.85, 0.88), 0.0)
    light = mb.emissive((1.0, 1.0, 1.0), 7.0)

    soup = TriSoup()
    _cornell_walls(soup, (white, white, white, green, red), light)

    box_mats = (white, red, green, metal)
    if glass:
        bk7 = mb.dielectric_preset("BK7")
        assert bk7 == FIELD_GLASS_MAT
        box_mats = (white, bk7, green, metal)
    n_boxes = max(0, -(-(n_tris - len(soup)) // 12))
    grid = int(math.ceil(math.sqrt(n_boxes)))
    cell = 520.0 / grid
    i = 0
    for gz in range(grid):
        for gx in range(grid):
            if i >= n_boxes:
                break
            w = cell * (0.25 + 0.35 * rng.rand())
            h = 10.0 + 120.0 * rng.rand() ** 2
            x = 15.0 + gx * cell + (cell - w) * rng.rand()
            z = 15.0 + gz * cell + (cell - w) * rng.rand()
            s = len(soup)
            soup.box((x, 0.0, z), (x + w, h, z + w), box_mats[i % 4])
            soup.rotate(s, math.radians(rng.rand() * 90.0), "Y", pivot=soup.slice_bbox_center(s, len(soup)))
            i += 1
    return _scene_arrays(soup, mb.build())


def build_tri_field(
    n_tris: int = 10008, seed: int = 0, glass: bool = False, device: torch.device | str = "cuda"
) -> Scene:
    """The procedural large scene (spectral_tpu/models/scenes.py:218-272):
    the Cornell shell and ceiling light plus a jittered grid of small
    rotated boxes, until there are at least ``n_tris`` triangles.
    Deterministic in ``seed``. ``glass``: every 4th box is BK7 (material
    row ``FIELD_GLASS_MAT``) instead of red. Above DENSE_CUTOFF triangles
    it renders through the leaf sweep (ops/cuda/render_kernel.py)."""
    return scene_from_numpy(_host_tri_field(int(n_tris), int(seed), bool(glass)), device)


def build_diffuse_field(n_tris: int = 520, seed: int = 0, device: torch.device | str = "cuda") -> Scene:
    """``build_tri_field``'s layout with its metal replaced by a lambertian
    blue: every surface diffuse, so that the warped-area estimator sees
    every silhouette family (the JAX package's chip-scale vertex-warp case,
    scratch/r5_vwarp_chip.py:40-76, with its blue DIFFUSE_FIELD_BLUE)."""
    return scene_from_numpy(_host_tri_field(int(n_tris), int(seed), False, True), device)
