"""Spectral path-tracing megakernel: the CUDA kernel, its plain version,
the scene packs and the chunk renderer around them.

Port of spectral_tpu/ops/pallas/render_kernel.py (pack_scene :71,
pack_scene_bvh_mxu :214 without its MXU forms, order_leaves_near_to_far
:448, pack_scene_auto :468, n_uniforms :2314, render_rays_pallas :2603,
render_rays_pallas_residuals :2421, camera_vector :3240,
render_chunk_pallas :3407). ``render_rays`` and ``render_rays_residuals``
launch csrc/render_kernel.cu for CUDA tensors and run
``render_rays_reference``, the plain PyTorch version, for CPU tensors; there
is no other fallback. A scene reaches every kernel entry point as one
``ScenePack``: ``pack_scene_frame`` makes it from a scene (a large scene's
leaf pack and its tables built once per geometry, ``LEAF_PACKS``, and
ordered from the camera each call), ``scene_pack`` from packs built by hand.
Scenes of at most DENSE_CUTOFF triangles take the dense sweep; larger ones
take the Morton-leaf sweep under its groups and super-groups of leaves
(``leaf_tables``), in this megakernel (``sched="mega"``) or in the sorted
per-bounce scheduler of ops/cuda/wavefront_kernel.py; ``render_pack``
picks the kernel for a pack.

The dense CUDA forms (forward and residual) can also report how many
sweeps each warp ran (``warp_steps``): live ray-steps / (32 x warp sweeps)
is the share of lanes that sweep a live path. It counts the kernel's own
scheduling, so the plain version has no such output.

The residual form also returns what the fused backward replays
(ops/cuda/grad_kernel.py), in the JAX layout: hero [spp, N], n_valid
[spp, N], power [spp, W, N] and the per-bounce material residual matres
[spp, B, N] int32 (mat + 1 for a hit, -1 for a background miss, 0 once the
path has ended).

The plain version repeats the JAX kernel's arithmetic on [N] tensors, op for
op and in the same order, with fused multiply-adds exactly where XLA's CPU
backend contracts that kernel (ops/fp32.py); the CUDA kernel does the same.
It is vectorised over rays and, for the sweep, over [rays, triangles]. Dead
paths are frozen as in the JAX kernel, so it and the CUDA kernel (which
stops a path when it terminates) give the same results. Its pieces
(``camera_rays``, ``hero_curves``, ``trace_bounce``, ``path_xyz``) are
those of csrc/path.cuh, and the sorted scheduler's plain version uses them
too.

Random numbers: with ``rand`` [spp, n_uniforms(B), N] both versions read
the injected planes in the JAX kernel's draw order; without it they hash
(chunk seed, global pixel index, sample, draw) with ``hash_uniforms``'s
uint32 arithmetic, which the CUDA source writes identically.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

from ...models.camera import camera_vector, chunk_pixels
from ...models.materials import DIELECTRIC, EMISSIVE, METALLIC
from ...utils.constants import (
    EPSILON,
    LAMBDA_MAX,
    LAMBDA_MIN,
    N_CIE_SAMPLES,
    N_RAY_WAVELENGTHS,
    cie_d65_normalized,
    cie_x,
    cie_y,
    cie_z,
    to,
)
from ...utils.trace import span
from ..bvh import morton_codes
from ..fp32 import cos, dot3, fma, sin
from ..intersect import (
    BIG,
    GROUP_SIZE,
    LEAF_VALID,
    SUPER_SIZE,
    box_unions,
    leaf_groups,
    nearest_hit,
    nearest_hit_leaves,
)
from . import build

W = N_RAY_WAVELENGTHS  # 7 wavelengths, hero at index 0
# tri pack [T, 17]: normal(0:3), d(3), edge_g(4:13), edge_c(13:16),
# mat_index(16, as float)
TRI_PACK_WIDTH = 17
# material pack [M, 16]: coeffs(0:3), is_lamb(3), is_metal(4), is_diel(5),
# is_emis(6), fuzz(7), power_sq(8), sellmeier_b(9:12), sellmeier_c(12:15)
MAT_PACK_WIDTH = 16
# curve tables [5, 95]: CIE x, y, z, normalized D65, background SPD
N_TABLES = 5
# lanes of a warp of the CUDA kernel (``warp_steps`` has one entry a warp)
WARP = 32
# The dense sweep covers scenes up to this many triangles (the JAX
# package's cutoff too); larger scenes take the leaf sweep.
DENSE_CUTOFF = 128
# leaf tri pack [NL * K, 18]: the tri pack row, then the original triangle
# index (as float, exact below 2^24)
LEAF_TRI_WIDTH = TRI_PACK_WIDTH + 1
# leaf pack [NL, 8]: AABB min(0:3), max(3:6), valid flag(6), spare(7)
LEAF_PACK_WIDTH = 8
# Leaf AABBs are widened by this fraction of the scene's largest coordinate
# magnitude. A triangle the dense test accepts at a vertex or an edge lies
# on its leaf's AABB face, and the slab test's rounding (1 / d, then a
# product) can put it an ulp outside: the leaf was culled and the sweep
# returned a farther hit or, on a tie, a higher index (ROADMAP C2). The
# slab and triangle tests err by ~1e-7 of the distances involved; 2^-16
# covers that many times over and adds next to no visits.
LEAF_MARGIN = 2.0**-16
# Triangles per leaf. The JAX package chose 128 for its matrix unit; a
# CUDA thread tests one triangle at a time, so a leaf costs every ray a
# slab test and each warp that enters it K triangle tests. Measured on an
# H100 (chip_smoke.py --leaf-sizes, PERF.md): 16 is the fastest size of
# 8-128 for the sorted scheduler on the 200k-triangle field and within 7%
# of the fastest on the 10k one.
LEAF_SIZE = 16
# leaves a super-group of the sweep's hierarchy
SUPER_LEAVES = GROUP_SIZE * SUPER_SIZE

_SPAN = LAMBDA_MAX - LAMBDA_MIN
_TWO_PI = 2.0 * 3.14159265358979
_CELL_SCALE = (N_CIE_SAMPLES - 1) / (LAMBDA_MAX - LAMBDA_MIN)
_DELTA = _SPAN / float(W)
_M32 = 0xFFFFFFFF


def pack_scene(scene) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(tri_pack [T, 17], mat_pack [M, 16], tables [5, 95]) float32 tensors
    on the scene's device."""
    tri = torch.cat(
        [
            scene.normal,
            scene.d[:, None],
            scene.edge_g.reshape(-1, 9),
            scene.edge_c,
            scene.mat_index[:, None].to(torch.float32),
        ],
        dim=1,
    ).to(torch.float32)
    dev = scene.normal.device
    tab = torch.stack(
        [to(cie_x, dev), to(cie_y, dev), to(cie_z, dev), to(cie_d65_normalized, dev), scene.background_spd.to(torch.float32)]
    )
    return tri.contiguous(), pack_materials(scene.materials), tab.contiguous()


def pack_materials(m) -> torch.Tensor:
    """The material pack [M, 16] float32 of ``Materials`` ``m``."""
    t = m.mat_type
    is_metal = (t == METALLIC).to(torch.float32)
    is_diel = (t == DIELECTRIC).to(torch.float32)
    is_emis = (t == EMISSIVE).to(torch.float32)
    is_lamb = torch.clamp(1.0 - is_metal - is_diel - is_emis, 0.0, 1.0)
    mat = torch.cat(
        [
            m.coeffs,
            is_lamb[:, None],
            is_metal[:, None],
            is_diel[:, None],
            is_emis[:, None],
            m.fuzz[:, None],
            (m.emission_power**2)[:, None],
            m.sellmeier_b,
            m.sellmeier_c,
            torch.zeros((t.shape[0], 1), dtype=torch.float32, device=t.device),
        ],
        dim=1,
    ).to(torch.float32)
    return mat.contiguous()


def pack_scene_leaves(scene, leaf_size: int = LEAF_SIZE):
    """(tri_pack [NL * K, 18], mat_pack, tables, leaf_pack [NL, 8]) of the
    leaf sweep, K = ``leaf_size``: the triangles in the stable order of the
    Morton codes of their bbox centres over the scene's bounds, each row
    with its original index at column 17, cut into NL = ceil(T / K) leaves
    and padded with zero rows (a zero normal never hits). Leaf rows hold
    the AABB of their triangles, widened by LEAF_MARGIN of the scene's
    largest coordinate magnitude, and a valid flag (1 when the leaf holds a
    triangle): an inverted padding AABB would pass the min/max slab test."""
    tri, mat, tab = pack_scene(scene)
    t = tri.shape[0]
    if t >= 1 << 24:
        raise ValueError(f"{t} triangles: the original index must be exact in float32")
    dev = tri.device
    lo, hi = scene.bbox_min.min(dim=0).values, scene.bbox_max.max(dim=0).values
    order = torch.argsort(morton_codes(0.5 * (scene.bbox_min + scene.bbox_max), lo, hi), stable=True)
    n_leaves = -(-t // leaf_size)
    pad = n_leaves * leaf_size - t
    f32 = torch.float32
    rows = torch.cat([tri[order], order[:, None].to(f32)], dim=1)
    rows = torch.cat([rows, torch.zeros((pad, LEAF_TRI_WIDTH), dtype=f32, device=dev)])
    bmin = torch.cat([scene.bbox_min[order], torch.full((pad, 3), BIG, dtype=f32, device=dev)])
    bmax = torch.cat([scene.bbox_max[order], torch.full((pad, 3), -BIG, dtype=f32, device=dev)])
    lmin = bmin.reshape(n_leaves, leaf_size, 3).min(dim=1).values
    lmax = bmax.reshape(n_leaves, leaf_size, 3).max(dim=1).values
    valid = (lmin <= lmax).all(dim=1)[:, None]
    margin = LEAF_MARGIN * torch.maximum(lo.abs().max(), hi.abs().max())
    lmin = torch.where(valid, lmin - margin, lmin)
    lmax = torch.where(valid, lmax + margin, lmax)
    valid = valid.to(f32)
    leaf = torch.cat([lmin, lmax, valid, torch.zeros_like(valid)], dim=1)
    return rows.contiguous(), mat, tab, leaf.contiguous()


def order_leaves_near_to_far(tri_pack, leaf_pack, cam_pos):
    """The leaves (and their rows) in whole super-groups (GROUP_SIZE *
    SUPER_SIZE consecutive leaves of the Morton order), the super-groups
    sorted stably by the squared distance from ``cam_pos`` to the centre of
    their valid leaves' union box, the leaves inside each kept in Morton
    order. The pack is first padded with invalid leaves (inverted boxes,
    zero rows) to a whole number of super-groups, so that every group and
    super-group of the sweep's hierarchy (ops/intersect.py::leaf_groups)
    stays a run of Morton-consecutive leaves, compact in space. The JAX
    package sorts single leaves (render_kernel.py:3257) and groups
    consecutive leaves of that order, which makes shell-shaped groups that
    cull poorly. Either way the first boxes a camera ray enters hold near
    hits, and the ``enter < best_t`` test skips more of the rest; the
    nearest hit does not depend on the order."""
    tri_pack, leaf_pack = _pad_super_groups(tri_pack, leaf_pack)
    units = box_unions(leaf_pack, SUPER_LEAVES)
    order = _super_group_order(0.5 * (units[:, 0:3] + units[:, 3:6]), cam_pos)
    return _take_blocks(tri_pack, order), _take_blocks(leaf_pack, order)


def _pad_super_groups(tri_pack, leaf_pack):
    """The pack padded with invalid leaves (inverted boxes, zero rows) to a
    whole number of super-groups."""
    n_leaves, width = leaf_pack.shape[0], tri_pack.shape[1]
    k_size = tri_pack.shape[0] // n_leaves
    pad = -n_leaves % SUPER_LEAVES
    if pad:
        inverted = torch.tensor([BIG] * 3 + [-BIG] * 3 + [0.0, 0.0], dtype=leaf_pack.dtype, device=leaf_pack.device)
        leaf_pack = torch.cat([leaf_pack, inverted.expand(pad, -1)])
        tri_pack = torch.cat([tri_pack, tri_pack.new_zeros((pad * k_size, width))])
    return tri_pack, leaf_pack


def _super_group_order(cent, cam_pos):
    """The super-groups' indices sorted stably by the squared distance from
    ``cam_pos`` to their centres ``cent`` [NS, 3]."""
    return torch.argsort(torch.sum((cent - cam_pos[None, :]) ** 2, dim=1), stable=True)


def _take_blocks(x, order):
    """The rows of ``x`` [R, C] as len(order) equal blocks, the blocks
    taken in ``order`` (a new contiguous tensor)."""
    return x.reshape(order.shape[0], -1, x.shape[1]).index_select(0, order).reshape(-1, x.shape[1])


def pack_scene_auto(scene, cam_vec=None, leaf_size: int = LEAF_SIZE):
    """(tri_pack, mat_pack, tables, leaf_pack): the dense pack and None at
    or below DENSE_CUTOFF triangles, the leaf pack above it, its leaves
    near-to-far from the camera when ``cam_vec`` is given
    (render_kernel.py:468). ``pack_scene_frame`` gives the same, with the
    leaf tables."""
    return pack_scene_frame(scene, cam_vec, leaf_size)[:4]


# the leaf tri pack's columns as the four float4 of csrc/hit.cuh::tri_hit4
# a triangle: (n, offset), then (g_k, c_k) for k = 0, 1, 2
_ROW4_COLUMNS = [0, 1, 2, 3, 4, 5, 6, 13, 7, 8, 9, 14, 10, 11, 12, 15]


class LeafTables(NamedTuple):
    """What the leaf sweeps read of a leaf pack (``leaf_tables``, or
    ``pack_scene_frame`` for a render from a camera): the pack, its cull
    hierarchy (ops/intersect.py::leaf_groups) and, for the CUDA kernels,
    each triangle as four float4 rows and an int32 (material, original
    index) pair. Every table is contiguous and 16-byte aligned."""

    tri: torch.Tensor  # [NL * K, 18]
    leaf: torch.Tensor  # [NL, 8]
    groups: torch.Tensor  # [NG, 8]
    supers: torch.Tensor  # [NS, 8]
    rows: torch.Tensor  # [NL * K, 16]
    ids: torch.Tensor  # [NL * K, 2] int32


def leaf_tables(tri_pack, leaf_pack) -> LeafTables:
    """The LeafTables of a leaf pack (float32 tensors on one device)."""
    tri_pack, leaf_pack = (x.to(torch.float32).contiguous() for x in (tri_pack, leaf_pack))
    if leaf_pack.data_ptr() % 16:
        leaf_pack = leaf_pack.clone()
    groups, supers = leaf_groups(leaf_pack)
    rows = tri_pack[:, _ROW4_COLUMNS].contiguous()
    ids = tri_pack[:, 16:18].to(torch.int32).contiguous()
    return LeafTables(tri_pack, leaf_pack, groups, supers, rows, ids)


def leaf_launch_args(lt: LeafTables) -> tuple:
    """The leaf scene arguments of the CUDA entry points (rows, ids, leaf,
    group, super-group pointers; leaves, leaf size, groups, super-groups)."""
    n_leaves = lt.leaf.shape[0]
    return (
        lt.rows.data_ptr(), lt.ids.data_ptr(), lt.leaf.data_ptr(), lt.groups.data_ptr(), lt.supers.data_ptr(),
        n_leaves, lt.tri.shape[0] // n_leaves, lt.groups.shape[0], lt.supers.shape[0],
    )


# the tensors of a Scene that the leaf pack reads, besides the materials
# and the background (packed on every call)
GEOMETRY = ("normal", "d", "edge_g", "edge_c", "mat_index", "bbox_min", "bbox_max")


class _MortonPack(NamedTuple):
    """The camera-independent part of a scene's leaf pack: its LeafTables in
    Morton order, padded to whole super-groups (the rows of a super-group
    are one block of each table), the super-groups' centres, the sort
    keys' box (``_key_box``) and the CIE rows of the curve tables."""

    morton: LeafTables
    cent: torch.Tensor  # [NS, 3]
    key_box: tuple[torch.Tensor, torch.Tensor]
    cie: torch.Tensor  # [4, 95]


class _Entry(NamedTuple):
    refs: tuple  # weak references to the GEOMETRY tensors other than normal
    versions: tuple[int, ...]  # the GEOMETRY tensors' _version
    leaf_size: int
    pack: _MortonPack


class LeafPacks:
    """The camera-independent leaf packs of large scenes, one per geometry
    (``pack_scene_frame``), and how often one was built or served again.

    An entry is keyed weakly by the scene's ``normal`` tensor, so that
    dropping the geometry drops it. It serves while every GEOMETRY tensor
    is the same object at the same ``_version`` (an in-place edit bumps it)
    and the leaf size is the same, and never where grad mode is on and a
    GEOMETRY tensor requires grad (that pack is built and not kept), or for
    inference tensors, which keep no version. The counts are zeroed by
    assigning 0, as the kernels' launch counts."""

    def __init__(self):
        self.entries = WeakIdKeyDictionary()
        self.builds = 0
        self.reuses = 0

    def get(self, scene, leaf_size: int) -> _MortonPack:
        geometry = [getattr(scene, k) for k in GEOMETRY]
        keep = not any(x.is_inference() for x in geometry) and not (
            torch.is_grad_enabled() and any(x.requires_grad for x in geometry)
        )
        if keep:
            versions = tuple(x._version for x in geometry)
            e = self.entries.get(scene.normal)
            if (e is not None and e.leaf_size == leaf_size and e.versions == versions
                    and all(r() is x for r, x in zip(e.refs, geometry[1:]))):
                self.reuses += 1
                return e.pack
        self.builds += 1
        pack = _morton_pack(scene, leaf_size)
        if keep:
            self.entries[scene.normal] = _Entry(tuple(weakref.ref(x) for x in geometry[1:]), versions, leaf_size,
                                                pack)
        return pack


LEAF_PACKS = LeafPacks()


def _morton_pack(scene, leaf_size: int) -> _MortonPack:
    tri, _, tab, leaf = pack_scene_leaves(scene, leaf_size)
    morton = leaf_tables(*_pad_super_groups(tri, leaf))
    cent = 0.5 * (morton.supers[:, 0:3] + morton.supers[:, 3:6])
    return _MortonPack(morton, cent, _key_box(morton.leaf), tab[:4])


def _key_box(leaf_pack: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, 1 / extent) of the union of the valid leaves' AABBs: the box
    that normalizes the sorted scheduler's sort keys."""
    valid = (leaf_pack[:, LEAF_VALID] != 0.0)[:, None]
    lo = torch.where(valid, leaf_pack[:, 0:3], BIG).min(dim=0).values
    hi = torch.where(valid, leaf_pack[:, 3:6], -BIG).max(dim=0).values
    return lo, 1.0 / torch.clamp_min(hi - lo, 1e-9)


class ScenePack(NamedTuple):
    """What every kernel entry point reads of a scene (``pack_scene_frame``
    or ``scene_pack``): the tri pack, the material pack and the curve
    tables, float32, contiguous and on one device; for a leaf pack also its
    leaves, their LeafTables and the sort keys' box (``_key_box``), each
    None for a dense pack."""

    tri: torch.Tensor
    mat: torch.Tensor
    tab: torch.Tensor
    leaf: torch.Tensor | None
    sweep: LeafTables | None
    key_box: tuple[torch.Tensor, torch.Tensor] | None


def scene_pack(tri, mat, tab, leaf=None) -> ScenePack:
    """The ScenePack of packs made by hand: the dense pack of ``pack_scene``
    without ``leaf``, else a leaf pack (``pack_scene_leaves``, maybe
    reordered by ``order_leaves_near_to_far``) with its LeafTables and the
    sort keys' box."""
    if leaf is None:
        if tri.ndim != 2 or tri.shape[1] != TRI_PACK_WIDTH:
            raise ValueError(f"tri_pack must be [T, {TRI_PACK_WIDTH}], got {tuple(tri.shape)}")
        if tri.shape[0] > DENSE_CUTOFF:
            raise ValueError(
                f"{tri.shape[0]} triangles: the dense sweep covers at most {DENSE_CUTOFF}; "
                "pass the scene's leaf pack (pack_scene_leaves)"
            )
    else:
        if leaf.ndim != 2 or leaf.shape[1] != LEAF_PACK_WIDTH or leaf.shape[0] < 1:
            raise ValueError(f"leaf_pack must be [NL, {LEAF_PACK_WIDTH}], got {tuple(leaf.shape)}")
        if tri.ndim != 2 or tri.shape[1] != LEAF_TRI_WIDTH or tri.shape[0] % leaf.shape[0] != 0:
            raise ValueError(
                f"tri_pack must be [NL * K, {LEAF_TRI_WIDTH}] for {leaf.shape[0]} leaves, got {tuple(tri.shape)}"
            )
    if mat.ndim != 2 or mat.shape[1] != MAT_PACK_WIDTH:
        raise ValueError(f"mat_pack must be [M, {MAT_PACK_WIDTH}], got {tuple(mat.shape)}")
    if tab.shape != (N_TABLES, N_CIE_SAMPLES):
        raise ValueError(f"tables must be [{N_TABLES}, {N_CIE_SAMPLES}], got {tuple(tab.shape)}")
    for name, x in (("mat_pack", mat), ("tables", tab), ("leaf_pack", leaf)):
        if x is not None and x.device != tri.device:
            raise ValueError(f"{name} is on {x.device}, tri_pack on {tri.device}")
    mat, tab = (x.to(torch.float32).contiguous() for x in (mat, tab))
    if leaf is None:
        return ScenePack(tri.to(torch.float32).contiguous(), mat, tab, None, None, None)
    sweep = leaf_tables(tri, leaf)
    return ScenePack(sweep.tri, mat, tab, sweep.leaf, sweep, _key_box(sweep.leaf))


def pack_scene_frame(scene, cam_vec=None, leaf_size: int = LEAF_SIZE) -> ScenePack:
    """The scene's ScenePack, its first four fields as ``pack_scene_auto``
    makes them. Above DENSE_CUTOFF triangles with ``cam_vec``, the
    Morton-order tables come from LEAF_PACKS (built once per geometry) and
    each call packs the materials and the background, orders the
    super-groups from the camera and gathers the tables in that order: bit
    for bit the tables of ``leaf_tables(*order_leaves_near_to_far(...))``,
    since a super-group is a block of Morton-consecutive leaves of every
    table. Without ``cam_vec`` the leaf pack is the Morton pack of
    ``pack_scene_leaves`` and its tables are built here."""
    if scene.num_tris <= DENSE_CUTOFF:
        return ScenePack(*pack_scene(scene), None, None, None)
    if cam_vec is None:
        return scene_pack(*pack_scene_leaves(scene, leaf_size))
    pack = LEAF_PACKS.get(scene, leaf_size)
    order = _super_group_order(pack.cent, cam_vec[0:3].to(pack.cent.device))
    sweep = LeafTables(*(_take_blocks(x, order) for x in pack.morton))
    tab = torch.cat([pack.cie, scene.background_spd.to(torch.float32)[None]])
    return ScenePack(sweep.tri, pack_materials(scene.materials), tab, sweep.leaf, sweep, pack.key_box)


def n_uniforms(bounces: int) -> int:
    """Uniform draws per sample: jitter(2) + hero(1) + 3 per bounce +
    defocus disk(2, at the tail)."""
    return 5 + 3 * bounces


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """uint32 lowbias32 hash of int64 values in [0, 2^32). The products may
    wrap the int64 range; the low 32 bits, all that is kept, are exact."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def pixel_keys(seed: int, px: torch.Tensor, py: torch.Tensor, image_width: int) -> torch.Tensor:
    """Per-ray stream keys: hash32(seed ^ hash32(py * image_width + px))."""
    pixel = (py.to(torch.int64) * image_width + px.to(torch.int64)) & _M32
    return _hash32((seed & _M32) ^ _hash32(pixel))


def hash_uniforms(keys: torch.Tensor, sample, n_draws: int, first: int = 0) -> torch.Tensor:
    """Draws [n_draws, N] in [0, 1) with 24 bits, draws first.. of sample s
    (an int, or an int64 [N] tensor of each ray's sample): draw j of sample
    s is hash32(hash32(key + s * 0x85EBCA6B) + j * 0x9E3779B9) >> 8."""
    k = _hash32((keys + ((sample * 0x85EBCA6B) & _M32)) & _M32)
    j = torch.arange(first, first + n_draws, dtype=torch.int64, device=keys.device)[:, None]
    h = _hash32((k[None, :] + ((j * 0x9E3779B9) & _M32)) & _M32)
    return (h >> 8).to(torch.float32) * (1.0 / 16777216.0)


def lut(row: torch.Tensor, cell: torch.Tensor, frac: torch.Tensor) -> torch.Tensor:
    """Lerp of a 95-sample curve at cells/fractions (spectrum.cu:11-22)."""
    return fma(1.0 - frac, row[cell], frac * row[cell + 1])


def comb_cell(hero: torch.Tensor, w: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Wavelength w of the hero comb (spectrum.cu:31-48, with the wrap) and
    its table cell (int64) and fraction; csrc/spectrum.cuh::comb_cell."""
    lw = hero + w * (_SPAN / float(W))
    lw = torch.where(lw > LAMBDA_MAX, lw - _SPAN, lw)
    xg = (lw - LAMBDA_MIN) * _CELL_SCALE
    cw = xg.to(torch.int32).clamp(0, N_CIE_SAMPLES - 2).long()
    return lw, cw, xg - cw.to(torch.float32)


def _check(cam_vec, pack, px, py, spp, bounces, rand, steps, visits=None, warp_steps=None, group_visits=None,
           super_visits=None):
    """Checks the rays, the draws and the outputs of a render of the
    ScenePack ``pack`` (whose own shapes ``scene_pack`` checked)."""
    n = px.shape[0]
    dev = px.device
    if cam_vec.shape != (20,) or py.shape != (n,) or px.ndim != 1:
        raise ValueError(f"bad shapes cam_vec {tuple(cam_vec.shape)}, px {tuple(px.shape)}, py {tuple(py.shape)}")
    if pack.leaf is None and any(x is not None for x in (visits, group_visits, super_visits)):
        raise ValueError("visits, group_visits and super_visits count boxes of the leaf sweep: they need a leaf pack")
    if pack.leaf is not None and warp_steps is not None:
        raise ValueError("warp_steps counts the dense sweep's warps: it needs no leaf pack")
    if spp < 1 or bounces < 1:
        raise ValueError(f"spp {spp} and bounces {bounces} must be >= 1")
    if rand is not None and rand.shape != (spp, n_uniforms(bounces), n):
        raise ValueError(f"rand must be [{spp}, {n_uniforms(bounces)}, {n}], got {tuple(rand.shape)}")
    for name, x, size in (("steps", steps, n), ("visits", visits, n), ("group_visits", group_visits, n),
                          ("super_visits", super_visits, n), ("warp_steps", warp_steps, -(-n // WARP))):
        if x is not None and (x.shape != (size,) or x.dtype != torch.int32 or not x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int32 [{size}] tensor")
    for name, x in (("cam_vec", cam_vec), ("tri_pack", pack.tri), ("mat_pack", pack.mat), ("tables", pack.tab),
                    ("py", py), ("rand", rand), ("steps", steps), ("visits", visits), ("group_visits", group_visits),
                    ("super_visits", super_visits), ("warp_steps", warp_steps)):
        if x is not None and x.device != dev:
            raise ValueError(f"{name} is on {x.device}, px on {dev}")
    if warp_steps is not None and dev.type != "cuda":
        raise ValueError("warp_steps counts the CUDA kernel's warp sweeps: it needs CUDA tensors")


def camera_rays(cam_vec, px, py, u0, u1, u_r, u_th):
    """Camera ray (get_ray, rendering.cu:66-87) with the thin-lens disk, for
    pixels (px, py) and draws u0, u1 (jitter), u_r, u_th (disk): the tuple
    (ox, oy, oz, dx, dy, dz) of [N] tensors; path.cuh::camera_ray."""
    (cx, cy, cz, p0x, p0y, p0z, dux, duy, duz, dvx, dvy, dvz,
     ddux, dduy, dduz, ddvx, ddvy, ddvz, has_defocus, _) = cam_vec.tolist()
    fx = px + (u0 - 0.5)
    fy = py + (u1 - 0.5)
    dr = torch.sqrt(u_r) * has_defocus
    dth = _TWO_PI * u_th
    du = dr * cos(dth)
    dv = dr * sin(dth)
    ox = fma(dv, ddvx, fma(du, ddux, cx))
    oy = fma(dv, ddvy, fma(du, dduy, cy))
    oz = fma(dv, ddvz, fma(du, dduz, cz))
    dx = fma(fy, dvx, fma(fx, dux, p0x)) - ox
    dy = fma(fy, dvy, fma(fx, duy, p0y)) - oy
    dz = fma(fy, dvz, fma(fx, duz, p0z)) - oz
    return ox, oy, oz, dx, dy, dz


def hero_wavelength(u: torch.Tensor) -> torch.Tensor:
    """The hero wavelength of draw u (spectrum.cu:31-48), fused as the
    megakernel's XLA form contracts it."""
    return fma(_SPAN, u, LAMBDA_MIN)


def hero_curves(hero: torch.Tensor, tables: torch.Tensor):
    """Lists over the W wavelengths of the hero comb: (lam, cell, frac,
    d65w, bgw), the D65 and background weights lerped from ``tables``."""
    lam, cell, frac, d65w, bgw = [], [], [], [], []
    for w in range(W):
        lw, cw, fw = comb_cell(hero, w)
        lam.append(lw)
        cell.append(cw)
        frac.append(fw)
        d65w.append(lut(tables[3], cw, fw))
        bgw.append(lut(tables[4], cw, fw))
    return lam, cell, frac, d65w, bgw


def _sweep(ray, alive, tri_pack, leaves, counts):
    """(t, hit, front, row) of the nearest hit: the dense sweep, or the leaf
    sweep for the live rays (the others miss), counting its boxes entered
    into ``counts`` (visits, group_visits, super_visits; each may be
    None)."""
    o = torch.stack(ray[0:3], 1)
    d = torch.stack(ray[3:6], 1)
    if leaves is None:
        t, idx, hit, front = nearest_hit(o, d, tri_pack)
        return t, hit, front, idx.long()
    visits, group_visits, super_visits = counts
    t, _, hit, front, row = nearest_hit_leaves(
        o, d, tri_pack, leaves.leaf, alive > 0.0, visits, (leaves.groups, leaves.supers), group_visits, super_visits,
    )
    return t, hit, front, row


def trace_bounce(ray, power, alive, n_valid, curves, u_a, u_b, u_c, tri_pack, mat_pack,
                 leaves=None, counts=(None, None, None)):
    """One bounce of [N] paths (_scatter_shade after the sweep;
    path.cuh::shade): nearest hit, material fetch, spectral weight, scatter
    and termination. ``ray`` is (ox, oy, oz, dx, dy, dz), ``power`` a list of
    W tensors, ``alive`` 1/0 floats, ``curves`` what ``hero_curves`` gave;
    ``leaves``: the LeafTables of the leaf sweep, None for the dense one;
    ``counts``: int32 [N] counters of its leaves, groups and super-groups
    entered, or None. A dead path stays frozen. Returns (ray, power,
    alive, n_valid, matres): matres mat + 1 for a hit, -1 for a background
    miss, 0 for a dead path."""
    f32 = torch.float32
    ox, oy, oz, dx, dy, dz = ray
    lam, _, _, d65w, bgw = curves
    one = torch.ones_like(ox)
    zero = torch.zeros_like(ox)
    t, best_hit_b, front, row = _sweep(ray, alive, tri_pack, leaves, counts)
    best_hit = best_hit_b.to(f32)
    hit = best_hit * alive
    miss = (1.0 - best_hit) * alive
    t_safe = torch.where(best_hit_b, t, zero)
    hx = fma(t_safe, dx, ox)
    hy = fma(t_safe, dy, oy)
    hz = fma(t_safe, dz, oz)
    # normal flipped toward the ray; material 0, zero normal on a miss
    tp = tri_pack[row]
    nb = [torch.where(best_hit_b, torch.where(front, tp[:, k], -tp[:, k]), zero) for k in range(3)]
    nbx, nby, nbz = nb
    mat_i = torch.where(best_hit_b, tp[:, 16].to(torch.int32), torch.zeros_like(row, dtype=torch.int32))
    none = torch.zeros_like(mat_i)
    matres = torch.where(hit > 0.0, mat_i + 1, torch.where(miss > 0.0, none - 1, none))
    mr = mat_pack[mat_i.long()]
    c0, c1, c2 = mr[:, 0], mr[:, 1], mr[:, 2]
    is_lamb, is_metal, is_diel, is_emis = mr[:, 3], mr[:, 4], mr[:, 5], mr[:, 6]
    fuzz, power_sq = mr[:, 7], mr[:, 8]
    b0, b1, b2 = mr[:, 9], mr[:, 10], mr[:, 11]
    sc0, sc1, sc2 = mr[:, 12], mr[:, 13], mr[:, 14]

    # spectral weight per wavelength (material.cuh:71-84)
    new_power = []
    for w in range(W):
        x = fma(fma(c0, lam[w], c1), lam[w], c2)
        sig = 0.5 * x / torch.sqrt(fma(x, x, 1.0)) + 0.5
        spd = is_diel + is_emis * power_sq * sig * d65w[w] + (is_lamb + is_metal) * sig
        weight = hit * spd + miss * bgw[w] + (1.0 - alive)
        new_power.append(power[w] * weight)

    # scatter directions
    ilen = one / torch.sqrt(dot3(dx, dy, dz, dx, dy, dz))
    ux, uy, uz = dx * ilen, dy * ilen, dz * ilen
    sz = 2.0 * u_a - 1.0
    sphi = _TWO_PI * u_b
    sr = torch.sqrt(torch.clamp_min(fma(-sz, sz, 1.0), 0.0))
    sx = sr * cos(sphi)
    sy = sr * sin(sphi)

    # lambertian (material.cu:8-19); degenerate -> normal
    lx, ly, lz = nbx + sx, nby + sy, nbz + sz
    degen = (lx.abs() < 1e-8) & (ly.abs() < 1e-8) & (lz.abs() < 1e-8)
    lx = torch.where(degen, nbx, lx)
    ly = torch.where(degen, nby, ly)
    lz = torch.where(degen, nbz, lz)

    # metallic (material.cu:22-37)
    dn = dot3(ux, uy, uz, nbx, nby, nbz)
    rx = fma(-(2.0 * dn), nbx, ux)
    ry = fma(-(2.0 * dn), nby, uy)
    rz = fma(-(2.0 * dn), nbz, uz)
    mx = fma(fuzz, sx, rx)
    my = fma(fuzz, sy, ry)
    mz = fma(fuzz, sz, rz)
    metal_ok = dot3(mx, my, mz, nbx, nby, nbz) > 0.0

    # dielectric (material.cu:73-80, 102-136): Sellmeier n(hero)
    hl = lam[0] * 1e-3
    hero_um2 = hl * hl
    n2 = (
        1.0
        + b0 * hero_um2 / (hero_um2 - sc0)
        + b1 * hero_um2 / (hero_um2 - sc1)
        + b2 * hero_um2 / (hero_um2 - sc2)
    )
    ir = torch.sqrt(torch.clamp_min(n2, 1e-6))
    ratio = torch.where(front, one / ir, ir)
    cos_t = torch.clamp_max(-dn, 1.0)
    sin_t = torch.sqrt(torch.clamp_min(fma(-cos_t, cos_t, 1.0), 0.0))
    q = (1.0 - ratio) / (1.0 + ratio)
    r0 = q * q
    om = 1.0 - cos_t
    om2 = om * om
    schlick = fma(1.0 - r0, om * (om2 * om2), r0)
    must_reflect = (ratio * sin_t > 1.0) | (schlick > u_c)
    # refract (vec3.cuh:198-205)
    qx = ratio * fma(cos_t, nbx, ux)
    qy = ratio * fma(cos_t, nby, uy)
    qz = ratio * fma(cos_t, nbz, uz)
    par = torch.sqrt(torch.clamp_min(1.0 - dot3(qx, qy, qz, qx, qy, qz), 0.0))
    gx = torch.where(must_reflect, rx, fma(-par, nbx, qx))
    gy = torch.where(must_reflect, ry, fma(-par, nby, qy))
    gz = torch.where(must_reflect, rz, fma(-par, nbz, qz))
    refracted = is_diel * torch.where(must_reflect, zero, one)

    ndx = is_lamb * lx + is_metal * mx + is_diel * gx
    ndy = is_lamb * ly + is_metal * my + is_diel * gy
    ndz = is_lamb * lz + is_metal * mz + is_diel * gz
    eps_sign = 1.0 - 2.0 * refracted

    # wavelength bookkeeping + termination
    hit_b = hit > 0.0
    n_valid = torch.where(hit_b & (refracted > 0.0), one, n_valid)
    n_valid = torch.where(hit_b & (is_metal > 0.0) & ~metal_ok, zero, n_valid)
    terminated = torch.maximum(miss, hit * torch.maximum(is_emis, is_metal * (1.0 - metal_ok.to(f32))))
    frozen = alive == 0.0
    scat = (alive > 0.0) & (terminated == 0.0)
    ray = (
        torch.where(frozen, ox, fma(eps_sign * EPSILON, nbx, hx)),
        torch.where(frozen, oy, fma(eps_sign * EPSILON, nby, hy)),
        torch.where(frozen, oz, fma(eps_sign * EPSILON, nbz, hz)),
        torch.where(scat, ndx, dx),
        torch.where(scat, ndy, dy),
        torch.where(scat, ndz, dz),
    )
    power = [torch.where(frozen, power[w], new_power[w]) for w in range(W)]
    return ray, power, alive * (1.0 - terminated), n_valid, matres


def path_xyz(power, n_valid, cell, frac, tables):
    """XYZ (sx, sy, sz) of finished paths (dev_spectrum_to_XYZ,
    color.cu:88-104), with the bounce-limit rule already applied to
    ``n_valid``; path.cuh::path_xyz."""
    zero = torch.zeros_like(n_valid)
    delta = torch.full_like(n_valid, _DELTA)
    sx_, sy_, sz_ = zero, zero, zero
    for w in range(W):
        contrib = power[w] * torch.where(float(w) < n_valid, delta, zero)
        sx_ = fma(contrib, lut(tables[0], cell[w], frac[w]), sx_)
        sy_ = fma(contrib, lut(tables[1], cell[w], frac[w]), sy_)
        sz_ = fma(contrib, lut(tables[2], cell[w], frac[w]), sz_)
    return sx_, sy_, sz_


def render_rays_reference(
    cam_vec, seed, pack, px, py, spp, bounces, image_width, rand=None, steps=None, residuals=False, visits=None,
    group_visits=None, super_visits=None,
):
    """The plain PyTorch version of the megakernel on the ScenePack
    ``pack``: XYZ [N, 3] summed over spp; with ``residuals``, the tuple
    (xyz, hero, n_valid, power, matres). ``steps`` (int32 [N]), when given,
    receives each ray's count of live ray-steps (bounces traced while its
    path was alive); with a leaf pack (the leaf sweep), ``visits``,
    ``group_visits`` and ``super_visits`` (int32 [N]) receive the leaves,
    groups and super-groups each pixel's rays entered."""
    n = px.shape[0]
    dev = px.device
    f32 = torch.float32
    zero = torch.zeros(n, dtype=f32, device=dev)
    tri_pack, mat_pack, tables = pack.tri, pack.mat, pack.tab
    px = px.to(f32)
    py = py.to(f32)
    n_draws = n_uniforms(bounces)
    keys = None if rand is not None else pixel_keys(seed, px, py, image_width)
    accx, accy, accz = zero, zero, zero
    live = torch.zeros(n, dtype=torch.int32, device=dev)
    leaves = pack.sweep
    counts = (visits, group_visits, super_visits)
    for x in counts:
        if x is not None:
            x.zero_()
    if residuals:
        res_hero = torch.empty((spp, n), dtype=f32, device=dev)
        res_nvalid = torch.empty((spp, n), dtype=f32, device=dev)
        res_power = torch.empty((spp, W, n), dtype=f32, device=dev)
        res_mat = torch.empty((spp, bounces, n), dtype=torch.int32, device=dev)

    for s in range(spp):
        u = rand[s] if rand is not None else hash_uniforms(keys, s, n_draws)
        ray = camera_rays(cam_vec, px, py, u[0], u[1], u[3 + 3 * bounces], u[4 + 3 * bounces])
        hero = hero_wavelength(u[2])
        if residuals:
            res_hero[s] = hero
        curves = hero_curves(hero, tables)
        power = [torch.ones(n, dtype=f32, device=dev)] * W
        alive = torch.ones(n, dtype=f32, device=dev)
        n_valid = torch.full((n,), float(W), dtype=f32, device=dev)
        for b in range(bounces):
            live += (alive > 0.0).to(torch.int32)
            ray, power, alive, n_valid, matres = trace_bounce(
                ray, power, alive, n_valid, curves, u[3 + 3 * b], u[4 + 3 * b], u[5 + 3 * b],
                tri_pack, mat_pack, leaves, counts,
            )
            if residuals:
                res_mat[s, b] = matres

        # bounce-limit exhaustion contributes nothing (rendering.cu:38-39)
        n_valid = torch.where(alive > 0.0, zero, n_valid)
        if residuals:
            res_nvalid[s] = n_valid
            res_power[s] = torch.stack(power)
        sx_, sy_, sz_ = path_xyz(power, n_valid, curves[1], curves[2], tables)
        accx, accy, accz = accx + sx_, accy + sy_, accz + sz_

    if steps is not None:
        steps.copy_(live)
    xyz = torch.stack([accx, accy, accz], dim=1)
    if residuals:
        return xyz, res_hero, res_nvalid, res_power, res_mat
    return xyz


def render_rays(
    cam_vec, seed, pack, px, py, spp, bounces, image_width, rand=None, steps=None, visits=None, warp_steps=None,
    group_visits=None, super_visits=None,
) -> torch.Tensor:
    """Accumulated XYZ [N, 3] for the rays of pixels (px, py) [N] f32 in the
    ScenePack ``pack``.

    ``seed``: the chunk seed of the hash draws (ignored with ``rand``);
    ``image_width``: the frame width, for the global pixel index of the
    hash; ``rand``: injected planes [spp, n_uniforms(bounces), N] f32;
    ``steps``: optional int32 [N] output of live ray-steps per ray;
    ``visits``, ``group_visits``, ``super_visits``: optional int32 [N]
    outputs of the leaves, groups and super-groups entered (leaf pack);
    ``warp_steps``: optional int32 [ceil(N / 32)] output of each warp's
    sweeps (dense pack on CUDA tensors only; 0 for a warp that did not
    run). CUDA tensors launch the kernel (the leaf form with a leaf pack),
    CPU tensors run the plain version."""
    counts = (visits, group_visits, super_visits)
    _check(cam_vec, pack, px, py, spp, bounces, rand, steps, visits, warp_steps, group_visits, super_visits)
    if px.device.type == "cpu":
        return render_rays_reference(
            cam_vec, seed, pack, px, py, spp, bounces, image_width, rand, steps, visits=visits,
            group_visits=group_visits, super_visits=super_visits,
        )
    xyz = torch.empty((px.shape[0], 3), dtype=torch.float32, device=px.device)
    _launch(
        build.RENDER if pack.leaf is None else build.RENDER_LEAVES, cam_vec, seed, pack, px, py, spp, bounces,
        image_width, rand, xyz, steps, counts, warp_steps,
    )
    return xyz


def _launch(kernel, cam_vec, seed, pack, px, py, spp, bounces, image_width, rand, xyz, steps, counts, warp_steps,
            residuals=()):
    """Launch the megakernel (dense or leaf form, forward or residual) on
    CUDA tensors, writing xyz, steps, the leaf form's counts (visits,
    group_visits, super_visits) and the dense form's warp_steps (or None)
    and the residual buffers; the leaf form reads the pack's LeafTables."""
    if px.device.type != "cuda":
        raise ValueError(f"unsupported device {px.device}")
    f32 = torch.float32
    cam_vec, px, py = (x.to(f32).contiguous() for x in (cam_vec, px, py))
    if rand is not None:
        rand = rand.to(f32).contiguous()
    counters = (_ptr(steps),)
    if pack.leaf is None:
        scene = (pack.tri.data_ptr(), pack.tri.shape[0])
        if warp_steps is not None:
            warp_steps.zero_()
        counters += (_ptr(warp_steps),)
        if kernel is build.RENDER:
            # the persistent grid's pixel counter
            next_pixel = torch.zeros(1, dtype=torch.int32, device=px.device)
            counters += (next_pixel.data_ptr(),)
    else:
        scene = leaf_launch_args(pack.sweep)
        counters += tuple(_ptr(x) for x in counts)
    kernel.launch(
        px.device,
        cam_vec.data_ptr(), seed & _M32, *scene,
        pack.mat.data_ptr(), pack.mat.shape[0],
        pack.tab.data_ptr(), px.data_ptr(), py.data_ptr(), px.shape[0], image_width,
        spp, bounces,
        _ptr(rand),
        xyz.data_ptr(), *counters,
        *(r.data_ptr() for r in residuals),
    )


def _ptr(x):
    return None if x is None else x.data_ptr()


def residual_buffers(spp: int, bounces: int, n: int, device, out=None):
    """(hero [spp, N], n_valid [spp, N], power [spp, W, N], matres int32
    [spp, bounces, N]) on ``device``: ``out`` once checked, else new."""
    shapes = ((spp, n), (spp, n), (spp, W, n), (spp, bounces, n))
    dtypes = (torch.float32, torch.float32, torch.float32, torch.int32)
    if out is None:
        return tuple(torch.empty(sh, dtype=dt, device=device) for sh, dt in zip(shapes, dtypes))
    if any(
        o.shape != sh or o.dtype != dt or o.device != device or not o.is_contiguous()
        for o, sh, dt in zip(out, shapes, dtypes)
    ):
        raise ValueError(f"out must be contiguous tensors of shapes {shapes} and types {dtypes} on {device}")
    return tuple(out)


def render_rays_residuals(
    cam_vec, seed, pack, px, py, spp, bounces, image_width, rand=None, steps=None, out=None, visits=None,
    warp_steps=None, group_visits=None, super_visits=None,
):
    """``render_rays`` that also records the path residuals: returns
    (xyz [N, 3], hero [spp, N], n_valid [spp, N], power [spp, W, N],
    matres int32 [spp, bounces, N]). The xyz equals ``render_rays``'s on
    the same draws. ``out``: preallocated (hero, n_valid, power, matres) to
    write into; every element is written. CUDA tensors launch the kernel's
    residual form (its own launch count), CPU tensors run the plain
    version."""
    counts = (visits, group_visits, super_visits)
    _check(cam_vec, pack, px, py, spp, bounces, rand, steps, visits, warp_steps, group_visits, super_visits)
    n = px.shape[0]
    dev = px.device
    out = residual_buffers(spp, bounces, n, dev, out)
    if px.device.type == "cpu":
        xyz, *res = render_rays_reference(
            cam_vec, seed, pack, px, py, spp, bounces, image_width, rand, steps, residuals=True, visits=visits,
            group_visits=group_visits, super_visits=super_visits,
        )
        for o, r in zip(out, res):
            o.copy_(r)
        return (xyz, *out)
    xyz = torch.empty((n, 3), dtype=torch.float32, device=dev)
    _launch(
        build.RENDER_RESIDUALS if pack.leaf is None else build.RENDER_LEAVES_RESIDUALS,
        cam_vec, seed, pack, px, py, spp, bounces, image_width, rand, xyz, steps, counts, warp_steps, out,
    )
    return (xyz, *out)


SCHEDULERS = ("sorted", "mega")


def render_pack(cam_vec, seed, pack, px, py, spp, bounces, image_width, rand=None, residuals=False,
                sched: str = "sorted"):
    """XYZ [N, 3] of the rays of pixels (px, py) [N] f32 in the ScenePack
    ``pack``, through the kernel for it: the dense megakernel for a dense
    pack; for a leaf pack of more than one leaf the sorted per-bounce
    scheduler (``sched="sorted"``, the default) or the leaf megakernel
    (``sched="mega"``; the JAX package's BVH_SCHED), which also takes a
    pack of one leaf. With ``residuals``, (xyz, hero, n_valid, power,
    matres) as ``render_rays_residuals`` returns them."""
    if sched not in SCHEDULERS:
        raise ValueError(f"sched must be one of {SCHEDULERS}, got {sched!r}")
    if pack.leaf is not None and pack.leaf.shape[0] > 1 and sched == "sorted":
        from .wavefront_kernel import render_rays_wavefront

        return render_rays_wavefront(cam_vec, seed, pack, px, py, spp, bounces, image_width, rand,
                                     save_residuals=residuals)
    render = render_rays_residuals if residuals else render_rays
    return render(cam_vec, seed, pack, px, py, spp, bounces, image_width, rand)


def render_chunk(
    scene, cam, seed: int, x0: int, y0: int, width: int, height: int,
    spp: int, bounces: int, rand: torch.Tensor | None = None, sched: str = "sorted",
) -> torch.Tensor:
    """Accumulated-XYZ chunk [height, width, 3] on the scene's device
    (counterpart of render_chunk_pallas): the scene's pack from the camera
    (``pack_scene_frame``: a large scene's leaf pack and its tables built
    once per geometry, its leaves near-to-far from the camera) through the
    kernel ``render_pack`` picks for it and ``sched``. Pixels are
    row-major; ``rand`` [spp, n_uniforms(bounces), height * width] injects
    the draws in that order, else they are hashed from ``seed``."""
    dev = scene.normal.device
    cam_vec = camera_vector(cam).to(dev)
    with span("render.pack"):
        pack = pack_scene_frame(scene, cam_vec)
    px, py = (c.to(torch.float32) for c in chunk_pixels(x0, y0, width, height, dev))
    with span("render.launch"):
        xyz = render_pack(cam_vec, seed, pack, px, py, spp, bounces, cam.image_width, rand, sched=sched)
    return xyz.reshape(height, width, 3)
