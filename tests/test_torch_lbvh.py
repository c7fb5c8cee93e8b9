"""The port's Karras LBVH (ops/bvh.py) against the JAX package's, on the CPU.

The build's tables (node boxes, children, leaf starts, Morton order) must
equal build_lbvh's at leaf sizes 4 and 8 on build_tri_field(520, 3), and
the lock-step walk's hits nearest_hit_bvh's: t at rtol 3e-4, triangle and
hit flag equal (tests/test_pallas.py:42-45). The JAX outputs are stored in
tests/torch_jax_refs.npz (case ``lbvh``). The XLA-style renderer through
the LBVH is held to its dense nearest hit on the same draws, as the JAX
package's tests/test_bvh.py:151-169 holds its own pair.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from spectral_tpu_torch.models.scenes import (
    CORNELL,
    build_scene,
    build_tri_field,
    scene_camera,
    scene_from_numpy,
    with_bvh,
)
from spectral_tpu_torch.ops.bvh import _clz32, build_lbvh, nearest_hit_bvh
from spectral_tpu_torch.ops.intersect import nearest_hit_scene
from spectral_tpu_torch.render import wavefront

import torch_jax_refs as refs

# one torch thread a process: the CPU test run's workers share the cores
torch.set_num_threads(1)

HIT_RTOL = 3e-4
TABLES = ("node_min", "node_max", "left", "right", "leaf_start", "order")


def _case():
    x = refs.lbvh_inputs()
    return x, refs.outputs("lbvh", x)


@pytest.mark.parametrize("leaf_size", refs.LBVH_LEAF_SIZES)
def test_build_lbvh_tables_equal_jax(leaf_size):
    x, ref = _case()
    scene = scene_from_numpy(x["scene"], "cpu")
    bvh = build_lbvh(scene.bbox_min, scene.bbox_max, leaf_size)
    assert bvh.n_tris == scene.num_tris and bvh.leaf_size == leaf_size
    for k in TABLES:
        np.testing.assert_array_equal(getattr(bvh, k).numpy(), ref[f"leaf{leaf_size}.{k}"], err_msg=k)


@pytest.mark.parametrize("leaf_size", refs.LBVH_LEAF_SIZES)
def test_nearest_hit_bvh_equals_jax(leaf_size):
    """The walk over the port's own tree, and over the JAX tables carried
    into the port by scene_from_numpy: the same hits as JAX's walk."""
    x, ref = _case()
    r = {k[len(f"leaf{leaf_size}."):]: v for k, v in ref.items() if k.startswith(f"leaf{leaf_size}.")}
    tables = {k: r[k] for k in TABLES}
    carried = scene_from_numpy(dict(x["scene"], bvh=dict(tables, leaf_size=leaf_size, n_tris=520)), "cpu")
    scene = with_bvh(scene_from_numpy(x["scene"], "cpu"), leaf_size)
    o, d = torch.from_numpy(x["o"]), torch.from_numpy(x["d"])
    assert 0.3 < r["hit"].mean() < 1.0
    for s in (scene, carried):
        rec = nearest_hit_bvh(o, d, s, s.bvh)
        np.testing.assert_array_equal(rec.hit.numpy(), r["hit"])
        np.testing.assert_array_equal(rec.tri_index.numpy(), r["tri_index"])
        np.testing.assert_array_equal(rec.front_face.numpy(), r["front_face"])
        np.testing.assert_allclose(rec.t.numpy(), r["t"], rtol=HIT_RTOL)
        np.testing.assert_allclose(rec.p.numpy(), r["p"], rtol=HIT_RTOL, atol=1e-3)
    for k in TABLES:
        assert torch.equal(getattr(carried.bvh, k).to(getattr(scene.bvh, k).dtype), getattr(scene.bvh, k))


def test_single_leaf_tree_is_the_dense_hit():
    """A tree of one leaf (bvh.py:256-265) tests every triangle densely, in
    Morton order: the dense nearest hit's distances and hit flags, and its
    triangles except on exact t-ties (two faces meeting at an edge), which
    go to the lower index in either order."""
    scene = build_scene(CORNELL, "cpu")
    bvh = build_lbvh(scene.bbox_min, scene.bbox_max, 64)
    assert bvh.leaf_start.shape[0] == 1 and bvh.left.shape[0] == 1
    rng = np.random.default_rng(3)
    o = torch.from_numpy(rng.uniform([20, 20, -400], [535, 535, 535], (512, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(512, 3)).astype(np.float32))
    got = nearest_hit_bvh(o, d, scene, bvh)
    want = nearest_hit_scene(o, d, scene)
    assert torch.equal(got.t, want.t) and torch.equal(got.hit, want.hit)
    assert (got.tri_index != want.tri_index).float().mean() < 0.02


def test_clz32():
    xs = np.array([0, 1, 2, 3, 255, 256, 1 << 20, (1 << 30) - 1, 1 << 30, (1 << 31) - 1, 1 << 31], np.int64)
    want = np.array([32 - int(v).bit_length() for v in xs])
    np.testing.assert_array_equal(_clz32(torch.from_numpy(xs)).numpy(), want)


def test_render_through_the_lbvh_matches_the_dense_render():
    """The XLA-style render of the sky-lit 520-triangle field walked
    through its LBVH against the same render by the dense nearest hit, on
    the same draws: more than 99% of the values within rtol 2e-4 / atol
    1e-5 (exact t-ties on coplanar faces may break otherwise,
    tests/test_bvh.py:151-169)."""
    from spectral_tpu_torch.ops.rgb2spec import srgb_to_illuminance_spectrum

    field = build_tri_field(520, 3, device="cpu")
    field = dataclasses.replace(field, background_spd=srgb_to_illuminance_spectrum(torch.tensor([0.8, 0.8, 0.8])))
    cam = scene_camera(CORNELL, 32, 16, "cpu")
    with torch.no_grad():
        dense = wavefront.render_chunk(field, cam, 5, 0, 0, 32, 16, 2, 3)
        walked = wavefront.render_chunk(with_bvh(field, 8), cam, 5, 0, 0, 32, 16, 2, 3)
    close = np.isclose(walked.numpy(), dense.numpy(), rtol=2e-4, atol=1e-5)
    assert dense.abs().max() > 0.1 and close.mean() > 0.99
