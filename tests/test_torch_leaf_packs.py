"""The large scenes' leaf packs, built once per geometry
(ops/cuda/render_kernel.py::pack_scene_frame, LEAF_PACKS), on the CPU; no
JAX call and no kernel.

- from every camera the pack, its leaf tables and the sort keys' box equal
  the per-frame build, ``scene_pack`` of ``order_leaves_near_to_far``'s
  output, tensor for tensor, on fields whose last super-group is ragged, at
  leaf sizes 8 and 16; without a camera the pack carries the tables and
  box of ``pack_scene_leaves``'s Morton pack;
- an in-place edit of any tensor the pack reads (a ``_version`` bump), a
  new tensor in its place or another leaf size makes a new build;
- new materials or a new sky (``dataclasses.replace``) keep the geometry's
  entry and change the material rows and the curve tables;
- geometry that requires grad is never served under grad mode;
- dropping the geometry drops its entry; inference tensors are packed
  without one;
- the counts in ``trace.summary()`` and the run log: a build, then a reuse
  a frame or training step; none for a dense scene;
- renders served from an entry are bit-equal to cold ones (sorted and mega
  schedulers), and the served pack and the hand-built one render the same
  through ``render_rays_wavefront``;
- ``render_pack`` takes each kind of pack (dense, leaf megakernel, sorted
  scheduler) to its entry point, forward and residual.
"""

from __future__ import annotations

import dataclasses
import gc
import types

import pytest
import torch

from spectral_tpu_torch import main as port_main
from spectral_tpu_torch.config import RenderParams
from spectral_tpu_torch.models.camera import camera_vector, chunk_pixels, make_camera
from spectral_tpu_torch.models.scenes import CORNELL, build_scene, build_tri_field, scene_camera
from spectral_tpu_torch.ops.cuda.render_kernel import (
    GEOMETRY,
    LEAF_PACKS,
    _key_box,
    leaf_tables,
    order_leaves_near_to_far,
    pack_materials,
    pack_scene_auto,
    pack_scene_frame,
    pack_scene_leaves,
    render_chunk,
    render_pack,
    render_rays_residuals,
    scene_pack,
)
from spectral_tpu_torch.ops.cuda.wavefront_kernel import render_rays_wavefront
from spectral_tpu_torch.parallel import train_step_fused, trainable_params
from spectral_tpu_torch.runtime.render_manager import RenderManager
from spectral_tpu_torch.utils import trace

# one torch thread a process: the CPU test run's workers share the cores
torch.set_num_threads(1)

# fields whose last super-group of 64 leaves is ragged at leaf sizes 8 and 16
FIELDS = [(520, 3), (2000, 1)]
EYES = [(278.0, 278.0, -800.0), (-300.0, 500.0, 200.0), (278.0, 100.0, 900.0)]


def _cam_vec(eye, w=8, h=4):
    cam = make_camera(w, h, vfov=40.0, lookfrom=eye, lookat=(278.0, 278.0, 0.0), vup=(0.0, 1.0, 0.0),
                      device="cpu")
    return cam, camera_vector(cam)


def _per_frame(scene, cam_vec, leaf_size):
    """The pack as each frame built it before the cache, by hand."""
    tri, mat, tab, leaf = pack_scene_leaves(scene, leaf_size)
    tri, leaf = order_leaves_near_to_far(tri, leaf, cam_vec[0:3])
    return scene_pack(tri, mat, tab, leaf)


def _assert_packs_equal(got, want):
    for a, b in zip((got.tri, got.mat, got.tab, got.leaf, *got.sweep, *got.key_box),
                    (want.tri, want.mat, want.tab, want.leaf, *want.sweep, *want.key_box)):
        assert a.dtype == b.dtype and a.is_contiguous() and torch.equal(a, b)


def _counts():
    return LEAF_PACKS.builds, LEAF_PACKS.reuses


@pytest.mark.parametrize("leaf_size", (8, 16))
@pytest.mark.parametrize("field", FIELDS)
def test_served_pack_equals_per_frame_build(field, leaf_size):
    scene = build_tri_field(*field, device="cpu")
    b0, r0 = _counts()
    for k, eye in enumerate(EYES):
        _, cv = _cam_vec(eye)
        got = pack_scene_frame(scene, cv, leaf_size)
        want = _per_frame(scene, cv, leaf_size)
        assert pack_scene_leaves(scene, leaf_size)[3].shape[0] % 64  # the last super-group is ragged
        _assert_packs_equal(got, want)
        assert all(torch.equal(a, b) for a, b in zip(pack_scene_auto(scene, cv, leaf_size), want[:4]))
        assert _counts() == (b0 + 1, r0 + 2 * k + 1)


def test_pack_without_a_camera_is_the_morton_pack():
    scene = build_tri_field(520, 3, device="cpu")
    b0, r0 = _counts()
    for a, b in zip(pack_scene_auto(scene), pack_scene_leaves(scene)):
        assert torch.equal(a, b)
    got = pack_scene_frame(scene)
    tri, _, _, leaf = pack_scene_leaves(scene)
    assert all(torch.equal(a, b) for a, b in zip(got.sweep, leaf_tables(tri, leaf)))
    assert all(torch.equal(a, b) for a, b in zip(got.key_box, _key_box(leaf)))
    assert _counts() == (b0, r0)


@pytest.mark.parametrize("name", GEOMETRY)
def test_in_place_edit_rebuilds(name):
    scene = build_tri_field(520, 3, device="cpu")
    _, cv = _cam_vec(EYES[0])
    pack_scene_frame(scene, cv)
    b0, r0 = _counts()
    x = getattr(scene, name)
    with torch.no_grad():
        x.view(-1)[5] += 1  # moves a triangle's row, or its box
    got = pack_scene_frame(scene, cv)
    assert _counts() == (b0 + 1, r0)
    _assert_packs_equal(got, _per_frame(scene, cv, 16))
    pack_scene_frame(scene, cv)
    assert _counts() == (b0 + 1, r0 + 1)


def test_new_tensor_or_leaf_size_rebuilds():
    scene = build_tri_field(520, 3, device="cpu")
    _, cv = _cam_vec(EYES[1])
    pack_scene_frame(scene, cv)
    b0, r0 = _counts()
    pack_scene_frame(dataclasses.replace(scene, d=scene.d.clone()), cv)
    pack_scene_frame(scene, cv, 8)
    assert _counts() == (b0 + 2, r0)


def test_new_materials_keep_the_geometry():
    scene = build_tri_field(520, 3, device="cpu")
    _, cv = _cam_vec(EYES[0])
    first = pack_scene_frame(scene, cv)
    b0, r0 = _counts()
    mats = dataclasses.replace(scene.materials, coeffs=scene.materials.coeffs + 0.5,
                               emission_power=scene.materials.emission_power * 2.0)
    sky = torch.linspace(0.0, 1.0, scene.background_spd.shape[0])
    other = dataclasses.replace(scene, materials=mats, background_spd=sky)
    got = pack_scene_frame(other, cv)
    assert _counts() == (b0, r0 + 1)
    assert torch.equal(got.mat, pack_materials(mats)) and not torch.equal(got.mat, first.mat)
    assert torch.equal(got.tab, pack_scene_leaves(other)[2]) and torch.equal(got.tab[4], sky)
    assert torch.equal(got.tab[:4], first.tab[:4]) and torch.equal(got.sweep.rows, first.sweep.rows)


def test_geometry_that_requires_grad_is_not_served_under_grad():
    base = build_tri_field(520, 3, device="cpu")
    scene = dataclasses.replace(base, normal=base.normal.clone().requires_grad_(True))
    _, cv = _cam_vec(EYES[2])
    b0, r0 = _counts()
    pack_scene_frame(scene, cv)
    pack_scene_frame(scene, cv)
    assert _counts() == (b0 + 2, r0)
    with torch.no_grad():
        pack_scene_frame(scene, cv)
        pack_scene_frame(scene, cv)
    assert _counts() == (b0 + 3, r0 + 1)
    pack_scene_frame(scene, cv)  # grad mode again: the entry kept under no_grad does not serve
    assert _counts() == (b0 + 4, r0 + 1)


def test_dropping_the_geometry_drops_its_entry_and_inference_tensors_keep_none():
    _, cv = _cam_vec(EYES[0])
    scene = build_tri_field(520, 3, device="cpu")
    pack_scene_frame(scene, cv)
    ref = torch.utils.weak.WeakIdRef(scene.normal)
    assert LEAF_PACKS.entries.get(scene.normal) is not None
    n = len(LEAF_PACKS.entries)
    del scene
    gc.collect()
    assert ref() is None and len(LEAF_PACKS.entries) == n - 1
    with torch.inference_mode():
        scene = build_tri_field(520, 3, device="cpu")
        b0, r0 = _counts()
        got = pack_scene_frame(scene, cv)
        pack_scene_frame(scene, cv)
    assert _counts() == (b0 + 2, r0) and LEAF_PACKS.entries.get(scene.normal) is None
    want = _per_frame(scene, cv, 16)
    assert torch.equal(got.tri, want.tri) and torch.equal(got.leaf, want.leaf)


def test_counts_in_the_summary_and_the_run_log():
    """A field's frames through RenderManager: one build, then a reuse a
    frame; a fused training step on the field reuses it too; a Cornell
    frame (dense) counts nothing."""
    scene = build_tri_field(520, 3, device="cpu")
    params = RenderParams(xres=8, aspect_ratio=2.0, nsamples=1, bounce_limit=2, device="cpu", show=False)
    s0 = trace.summary()["leaf_packs"]
    for eye in EYES:
        RenderManager(scene, _cam_vec(eye)[0], params).render()
    cam = _cam_vec(EYES[0], 4, 4)[0]
    train = {k: v for k, v in trainable_params(scene).items() if k in ("coeffs", "emission_power")}
    train_step_fused(train, scene, cam, torch.zeros((4, 4, 3)), 7, 1, 2, lr=1e-13)
    cornell = build_scene(CORNELL, "cpu")
    RenderManager(cornell, scene_camera(CORNELL, 8, 4, "cpu"), params).render()
    s1 = trace.summary()["leaf_packs"]
    assert (s1["builds"] - s0["builds"], s1["reuses"] - s0["reuses"]) == (1, 3)
    log = {}
    port_main.log_tallies(types.SimpleNamespace(add_entry=lambda k, v: log.__setitem__(k, v)))
    assert log["leaf packs (builds, reuses)"] == f"{s1['builds']}, {s1['reuses']}"


@pytest.mark.parametrize("sched", ("sorted", "mega"))
def test_served_render_equals_cold_render(sched):
    scene = build_tri_field(2000, 1, device="cpu")
    scene = dataclasses.replace(scene, background_spd=torch.ones_like(scene.background_spd))  # a lit sky
    for eye in EYES[:2]:
        cam, _ = _cam_vec(eye, 16, 8)
        warm = render_chunk(scene, cam, 11, 0, 0, 16, 8, 4, 4, sched=sched)
        LEAF_PACKS.entries.clear()
        cold = render_chunk(scene, cam, 11, 0, 0, 16, 8, 4, 4, sched=sched)
        assert torch.equal(warm, cold) and warm.abs().sum() > 0


def test_wavefront_with_and_without_sweep():
    """The pack LEAF_PACKS serves (its sweep from the entry) and the one
    ``scene_pack`` builds by hand from ``order_leaves_near_to_far``'s output
    are equal, tensor for tensor, and render bit-equal xyz, residuals and
    counts of boxes entered through the sorted scheduler."""
    scene = build_tri_field(520, 3, device="cpu")
    _, cv = _cam_vec(EYES[1])
    served, built = pack_scene_frame(scene, cv), _per_frame(scene, cv, 16)
    _assert_packs_equal(served, built)
    px, py = (c.float() for c in chunk_pixels(0, 0, 8, 4, "cpu"))
    counts = [[torch.zeros((2, 32), dtype=torch.int32) for _ in range(3)] for _ in range(2)]
    outs = [render_rays_wavefront(cv, 5, pack, px, py, 2, 3, 8, save_residuals=True, visits=c[0], group_visits=c[1],
                                  super_visits=c[2]) for pack, c in zip((served, built), counts)]
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert all(torch.equal(a, b) for a, b in zip(*counts)) and counts[0][0].sum() > 0


@pytest.mark.parametrize("kind", ("dense", "mega", "sorted"))
def test_render_pack_routes_each_pack(kind):
    """``render_pack`` takes a dense pack to the dense megakernel, a leaf
    pack under ``sched="mega"`` to the leaf megakernel and under "sorted" to
    the sorted scheduler (the only route with ``sched.*`` spans), forward
    and residual, each bit-equal to its entry point's output."""
    scene = build_scene(CORNELL, "cpu") if kind == "dense" else build_tri_field(520, 3, device="cpu")
    _, cv = _cam_vec(EYES[0])
    pack = pack_scene_frame(scene, cv)
    px, py = (c.float() for c in chunk_pixels(0, 0, 8, 4, "cpu"))
    args = (cv, 5, pack, px, py, 2, 3, 8)
    want = render_rays_wavefront(*args, save_residuals=True) if kind == "sorted" else render_rays_residuals(*args)
    sched = "mega" if kind == "mega" else "sorted"
    trace.reset()
    with trace.recording():
        got = render_pack(*args, residuals=True, sched=sched)
    assert ("sched.camera" in trace.summary()["spans"]) == (kind == "sorted")
    assert len(got) == 5 and all(torch.equal(a, b) for a, b in zip(got, want)) and want[0].abs().sum() > 0
    assert torch.equal(render_pack(*args, sched=sched), want[0])
    with pytest.raises(ValueError, match="sched must be one of"):
        render_pack(*args, sched="wavefront")
    if kind == "dense":
        with pytest.raises(ValueError, match="leaf pack"):
            render_rays_wavefront(*args)
