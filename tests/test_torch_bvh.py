"""The port's large-scene building blocks against the JAX package, on the CPU.

- ``morton_codes`` equals spectral_tpu/ops/bvh.py's, as int32;
- ``build_tri_field`` equals the JAX field's arrays at test_torch_scene.py's
  tolerance (rtol 1e-6; in fact bit for bit);
- ``pack_scene_leaves`` orders triangles as the JAX leaf pack does (its
  stable argsort of the same Morton codes) and its leaf AABBs are JAX's
  widened by LEAF_MARGIN of the largest coordinate; every leaf encloses its
  triangles, and a padded leaf is flagged: its inverted AABB passes the
  slab test, so the flag is what keeps it out;
- the plain leaf sweep ``nearest_hit_leaves`` returns exactly what the
  plain dense ``nearest_hit`` returns (t, idx, hit, front), for camera
  rays, random rays and rays aimed at triangle vertices (ties between
  triangles that share the vertex, and hits on leaf AABB faces), at three
  leaf sizes, with and without the near-to-far leaf order. On the exact
  JAX boxes the vertex rays find both traps (ROADMAP C2): a leaf culled by
  an ulp at its face, and a tie lost to ``enter < best_t``;
- the leaf sweep's cull hierarchy (``leaf_groups``): every group and
  super-group box contains its valid members' boxes, a group with no valid
  leaf is flagged invalid, and the hierarchy is conservative: a ray whose
  slab test passes a leaf passes its group and super-group, entering them
  no later, on random rays and on rays that graze leaf boxes;
- the near-to-far order moves whole super-groups: each keeps its leaves
  contiguous and in Morton order, and the super-groups lie near to far;
- the hierarchical plain sweep returns exactly what a flat sequential walk
  over every leaf returns (t, index, row, front, leaves entered), and its
  counts of groups and super-groups entered equal a sequential walk of the
  hierarchy's, at leaf sizes 8 and 16, in Morton and near-to-far order, for
  camera, random and vertex rays; on one case the JAX package's exact dense
  sweep (spectral_tpu/ops/intersect.py::nearest_hit) finds the same hits;
- ``_sort_keys`` equals the JAX scheduler's on crafted states with NaN,
  infinite and far-out origins.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectral_tpu.models import scenes as jscenes
from spectral_tpu.ops.bvh import morton_codes as jax_morton_codes
from spectral_tpu.ops.intersect import nearest_hit as jax_nearest_hit
from spectral_tpu.ops.pallas import wavefront_kernel as jwk
from spectral_tpu.ops.pallas.render_kernel import pack_scene_bvh_mxu
from spectral_tpu_torch.models import scenes as tscenes
from spectral_tpu_torch.models.camera import camera_vector
from spectral_tpu_torch.ops.bvh import morton_codes
from spectral_tpu_torch.ops.cuda.render_kernel import (
    LEAF_MARGIN,
    LEAF_PACK_WIDTH,
    LEAF_TRI_WIDTH,
    order_leaves_near_to_far,
    pack_scene,
    pack_scene_leaves,
)
from spectral_tpu_torch.ops.cuda.wavefront_kernel import STATE_ROWS, _sort_keys
from spectral_tpu_torch.ops.intersect import (
    BIG,
    GROUP_SIZE,
    SUPER_SIZE,
    _tri_test,
    leaf_groups,
    leaf_slabs,
    nearest_hit,
    nearest_hit_leaves,
    safe_inv,
)

FIELDS = [(520, 3, False), (520, 3, True), (10008, 0, False)]


def _jax_arrays(s) -> dict:
    d = {f.name: np.asarray(getattr(s, f.name)) for f in dataclasses.fields(s) if f.name not in ("materials", "bvh")}
    d["materials"] = {f.name: np.asarray(getattr(s.materials, f.name)) for f in dataclasses.fields(s.materials)}
    return d


@pytest.fixture(scope="module")
def field520():
    return tscenes.build_tri_field(520, 3, glass=True, device="cpu")


def test_morton_codes_equal_jax():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-50.0, 600.0, (4096, 3)).astype(np.float32)
    pts[:8] = [[-50, -50, -50], [600, 600, 600], [0, 0, 0], [555, 555, 555], [1e-7, 0, 0], [0, 0, 0], [7, 8, 9], [600, 0, -50]]
    lo = np.array([0.0, 0.0, 0.0], np.float32)
    hi = np.array([555.0, 555.0, 555.0], np.float32)
    ours = morton_codes(torch.from_numpy(pts), torch.from_numpy(lo), torch.from_numpy(hi))
    theirs = np.asarray(jax_morton_codes(jnp.asarray(pts), jnp.asarray(lo), jnp.asarray(hi)))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), theirs.astype(np.int32))
    assert len(np.unique(theirs)) > 3000  # not a degenerate comparison


@pytest.mark.parametrize("n_tris,seed,glass", FIELDS)
def test_tri_field_equals_jax(n_tris, seed, glass):
    ref = _jax_arrays(jscenes.build_tri_field(n_tris, seed, glass))
    port = tscenes.build_tri_field(n_tris, seed, glass, device="cpu")
    assert port.num_tris >= n_tris
    for k, v in ref.items():
        if k == "materials":
            continue
        got = getattr(port, k).numpy()
        assert got.shape == v.shape, k
        if np.issubdtype(v.dtype, np.integer):
            np.testing.assert_array_equal(got, v, err_msg=k)
        else:
            np.testing.assert_allclose(got, v, rtol=1e-6, atol=1e-6, err_msg=k)
    for k, v in ref["materials"].items():
        got = getattr(port.materials, k).numpy()
        np.testing.assert_allclose(got, v, rtol=1e-6, atol=1e-7, err_msg=k)
    if glass:
        assert port.materials.mat_type[tscenes.FIELD_GLASS_MAT] == ref["materials"]["mat_type"][jscenes.FIELD_GLASS_MAT]
        assert (port.mat_index == tscenes.FIELD_GLASS_MAT).any()


def test_leaf_pack_order_and_aabbs_equal_jax():
    jscene = jscenes.build_tri_field(520, 3, glass=True)
    scene = tscenes.scene_from_numpy(_jax_arrays(jscene), "cpu")
    tri, _, _, leaf = pack_scene_leaves(scene, leaf_size=128)
    *_, jleaf = pack_scene_bvh_mxu(jscene, leaf_size=128)
    cent = 0.5 * (jscene.bbox_min + jscene.bbox_max)
    jorder = np.asarray(jnp.argsort(jax_morton_codes(cent, jscene.bbox_min.min(0), jscene.bbox_max.max(0))))
    t = scene.num_tris
    np.testing.assert_array_equal(tri[:t, 17].numpy().astype(np.int64), jorder)
    margin = np.float32(LEAF_MARGIN) * max(np.abs(np.asarray(jscene.bbox_min)).max(), np.abs(np.asarray(jscene.bbox_max)).max())
    np.testing.assert_array_equal(leaf[:, 0:3].numpy(), np.asarray(jleaf)[:, 0:3] - margin)
    np.testing.assert_array_equal(leaf[:, 3:6].numpy(), np.asarray(jleaf)[:, 3:6] + margin)
    np.testing.assert_array_equal(tri[:t, :17].numpy(), pack_scene(scene)[0].numpy()[jorder])


@pytest.mark.parametrize("leaf_size", [8, 32, 128])
def test_leaves_enclose_their_triangles(field520, leaf_size):
    tri, _, _, leaf = pack_scene_leaves(field520, leaf_size)
    t = field520.num_tris
    n_leaves = -(-t // leaf_size)
    assert tri.shape == (n_leaves * leaf_size, LEAF_TRI_WIDTH) and leaf.shape == (n_leaves, LEAF_PACK_WIDTH)
    order = tri[:t, 17].long()
    assert torch.equal(order.sort().values, torch.arange(t))
    owner = torch.arange(t) // leaf_size
    for v in (field520.v0, field520.v1, field520.v2):
        p = v[order]
        assert (p >= leaf[owner, 0:3]).all() and (p <= leaf[owner, 3:6]).all()
    assert (tri[t:] == 0).all()  # zero padding rows never hit
    assert (leaf[:, 6] == 1.0).all() and (leaf[:, 7] == 0.0).all()


def test_padded_leaf_is_flagged_and_skipped(field520):
    """An inverted padding AABB (min +BIG, max -BIG) passes the min/max
    slab test; the valid flag keeps the sweep out of it."""
    tri, _, _, leaf = pack_scene_leaves(field520, 32)
    o = torch.tensor([[278.0, 278.0, -800.0], [10.0, 5.0, 3.0]])
    d = torch.tensor([[0.01, 0.02, 1.0], [-1.0, 0.0, 0.0]])
    inverted = torch.tensor([[BIG, BIG, BIG, -BIG, -BIG, -BIG]])
    passes, enter = leaf_slabs(inverted, o, [safe_inv(d[:, k]) for k in range(3)])
    assert (passes & (enter < BIG)).any()
    # a padded leaf whose rows would be hit by every ray: flag 0 keeps it out
    decoy = tri[:32].clone()
    decoy[:, 16] = 0.0
    padded_tri = torch.cat([decoy, tri])
    padded_leaf = torch.cat([torch.tensor([[BIG, BIG, BIG, -BIG, -BIG, -BIG, 0.0, 0.0]]), leaf])
    ref = nearest_hit_leaves(o, d, tri, leaf)
    got = nearest_hit_leaves(o, d, padded_tri, padded_leaf)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])


def _rays(scene, kind: str, n: int = 2048, seed: int = 0):
    rng = np.random.default_rng(seed)
    if kind == "camera":
        cam = camera_vector(tscenes.scene_camera(tscenes.CORNELL, 64, 32, "cpu"))
        px = rng.uniform(0, 64, n).astype(np.float32)
        py = rng.uniform(0, 32, n).astype(np.float32)
        c = cam.numpy()
        o = np.tile(c[0:3], (n, 1))
        d = c[3:6] + px[:, None] * c[6:9] + py[:, None] * c[9:12] - o
    elif kind == "random":
        o = rng.uniform([5.0, 1.0, 5.0], [550.0, 300.0, 550.0], (n, 3))
        d = rng.normal(size=(n, 3))
    else:  # aimed at triangle vertices: ties and leaf-face hits
        verts = torch.cat([scene.v0, scene.v1, scene.v2]).numpy()
        target = verts[rng.integers(0, len(verts), n)]
        o = rng.uniform([5.0, 150.0, 5.0], [550.0, 500.0, 550.0], (n, 3))
        d = target - o
    return torch.from_numpy(o.astype(np.float32)), torch.from_numpy(d.astype(np.float32))


@pytest.mark.parametrize("near_to_far", [False, True], ids=["morton", "near_to_far"])
@pytest.mark.parametrize("leaf_size", [8, 32, 128])
@pytest.mark.parametrize("kind", ["camera", "random", "vertex"])
def test_leaf_sweep_equals_dense(field520, kind, leaf_size, near_to_far):
    o, d = _rays(field520, kind, seed=leaf_size)
    dense = nearest_hit(o, d, pack_scene(field520)[0])
    tri, _, _, leaf = pack_scene_leaves(field520, leaf_size)
    if near_to_far:
        tri, leaf = order_leaves_near_to_far(tri, leaf, torch.tensor([278.0, 278.0, -800.0]))
    visits = torch.zeros(o.shape[0], dtype=torch.int32)
    got = nearest_hit_leaves(o, d, tri, leaf, visits=visits)
    for a, b, what in zip(got[:4], dense, ("t", "idx", "hit", "front")):
        bad = (a != b).nonzero()[:, 0]
        assert bad.numel() == 0, f"{what} differs on rays {bad[:8].tolist()}"
    assert torch.equal(tri[got[4], 17].long()[got[2]], got[1].long()[got[2]])  # the row holds the winner
    assert dense[2].float().mean() > 0.3  # a real comparison
    assert visits.float().mean() < leaf.shape[0]  # the cull does skip leaves


def test_leaf_sweep_equals_dense_on_10k_field():
    scene = tscenes.build_tri_field(10008, 0, device="cpu")
    o, d = _rays(scene, "camera", n=512, seed=1)
    dense = nearest_hit(o, d, pack_scene(scene)[0])
    tri, _, _, leaf = pack_scene_leaves(scene)
    got = nearest_hit_leaves(o, d, tri, leaf)
    for a, b in zip(got[:4], dense):
        assert torch.equal(a, b)


def test_sort_keys_equal_jax():
    rng = np.random.default_rng(4)
    n = 256
    st = np.zeros((STATE_ROWS, n), np.float32)
    st[0:3] = rng.uniform(-100.0, 700.0, (3, n))
    st[3:6] = rng.normal(size=(3, n))
    st[7] = rng.integers(0, 2, n)
    st[0, :8] = [np.nan, np.inf, -np.inf, 3e38, -3e38, 1e30, -0.0, 555.0]
    st[1, 8:12] = [np.nan, np.inf, 1e20, -1e20]
    st[2, 12:16] = [np.nan, -np.inf, 3.4e38, 0.0]
    st[3:6, 16:20] = 0.0  # no octant bit
    st[3:6, 20:24] = -0.0
    lo = np.array([0.0, 0.0, 0.0], np.float32)
    inv = (1.0 / np.array([555.0, 555.0, 555.0], np.float32)).astype(np.float32)
    ours = _sort_keys(torch.from_numpy(st), torch.from_numpy(lo), torch.from_numpy(inv))
    theirs = np.asarray(jwk._sort_keys(jnp.asarray(st), jnp.asarray(lo), jnp.asarray(inv)))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), theirs)
    assert len(np.unique(theirs)) > 100


CAMERA_POS = torch.tensor([278.0, 278.0, -800.0])


def _pack(scene, leaf_size, near_to_far):
    tri, _, _, leaf = pack_scene_leaves(scene, leaf_size)
    if near_to_far:
        tri, leaf = order_leaves_near_to_far(tri, leaf, CAMERA_POS)
    return tri, leaf


@pytest.mark.parametrize("near_to_far", [False, True], ids=["morton", "near_to_far"])
@pytest.mark.parametrize("leaf_size", [8, 16])
def test_group_tables_hold_their_valid_leaves(field520, leaf_size, near_to_far):
    _, leaf = _pack(field520, leaf_size, near_to_far)
    groups, supers = leaf_groups(leaf)
    assert groups.shape == (-(-leaf.shape[0] // GROUP_SIZE), 8)
    assert supers.shape == (-(-groups.shape[0] // SUPER_SIZE), 8)
    for parent, child, fan in ((groups, leaf, GROUP_SIZE), (supers, groups, SUPER_SIZE)):
        owner = torch.arange(child.shape[0]) // fan
        valid = child[:, 6] != 0
        assert (child[valid, 0:3] >= parent[owner[valid], 0:3]).all()
        assert (child[valid, 3:6] <= parent[owner[valid], 3:6]).all()
        any_valid = torch.zeros(parent.shape[0], dtype=torch.bool).index_put_((owner,), valid, accumulate=True)
        assert torch.equal(parent[:, 6], any_valid.float())
        # a box with no valid member is inverted and flagged, as a padded leaf
        empty = ~any_valid
        assert (parent[empty, 0:3] == BIG).all() and (parent[empty, 3:6] == -BIG).all()
        assert (parent[:, 7] == 0).all()
    if near_to_far:
        assert leaf.shape[0] % (GROUP_SIZE * SUPER_SIZE) == 0
        assert (groups[:, 6] == 0).any()  # the padding fills whole groups


def _grazing_rays(leaf, n, seed):
    """Rays from random origins aimed at leaf box corners and edge points:
    their slab intervals touch the boxes' faces."""
    rng = np.random.default_rng(seed)
    boxes = leaf[leaf[:, 6] != 0].numpy()
    pick = boxes[rng.integers(0, len(boxes), n)]
    corner = rng.integers(0, 2, (n, 3)).astype(bool)
    target = np.where(corner, pick[:, 3:6], pick[:, 0:3])
    edge = rng.integers(0, 3, n)
    frac = rng.uniform(size=n)
    target[np.arange(n), edge] = pick[np.arange(n), edge] + frac * (pick[np.arange(n), edge + 3] - pick[np.arange(n), edge])
    o = rng.uniform([-100.0, -100.0, -900.0], [650.0, 650.0, 650.0], (n, 3))
    return torch.from_numpy(o.astype(np.float32)), torch.from_numpy((target - o).astype(np.float32))


@pytest.mark.parametrize("kind", ["random", "grazing"])
def test_group_cull_is_conservative(field520, kind):
    tri, leaf = _pack(field520, 8, near_to_far=True)
    o, d = _rays(field520, "random", seed=3) if kind == "random" else _grazing_rays(leaf, 2048, 5)
    groups, supers = leaf_groups(leaf)
    inv = [safe_inv(d[:, k]) for k in range(3)]
    pl, el = leaf_slabs(leaf, o, inv)
    pg, eg = leaf_slabs(groups, o, inv)
    ps, es = leaf_slabs(supers, o, inv)
    pl &= leaf[None, :, 6] != 0
    g_of = torch.arange(leaf.shape[0]) // GROUP_SIZE
    s_of = torch.arange(groups.shape[0]) // SUPER_SIZE
    assert pl.any(dim=1).float().mean() > 0.3  # a real comparison
    assert (pg[:, g_of] | ~pl).all() and (eg[:, g_of] <= el)[pl].all()
    pg &= groups[None, :, 6] != 0
    assert (ps[:, s_of] | ~pg).all() and (es[:, s_of] <= eg)[pg].all()


def test_near_to_far_moves_whole_super_groups(field520):
    tri, _, _, leaf = pack_scene_leaves(field520, 8)
    otri, oleaf = order_leaves_near_to_far(tri, leaf, CAMERA_POS)
    unit = GROUP_SIZE * SUPER_SIZE
    n = leaf.shape[0]
    pad = -n % unit
    assert oleaf.shape[0] == n + pad and otri.shape[0] == (n + pad) * 8
    padded = torch.cat([leaf, torch.tensor([[BIG] * 3 + [-BIG] * 3 + [0.0, 0.0]]).expand(pad, -1)])
    padded_tri = torch.cat([tri, torch.zeros(pad * 8, tri.shape[1])])
    seen, dist = [], []
    for b in range(oleaf.shape[0] // unit):
        block = oleaf[b * unit:(b + 1) * unit]
        src = [u for u in range(padded.shape[0] // unit) if torch.equal(block, padded[u * unit:(u + 1) * unit])]
        assert len(src) == 1  # a run of Morton-consecutive leaves, in Morton order
        u = src[0]
        assert torch.equal(otri[b * unit * 8:(b + 1) * unit * 8], padded_tri[u * unit * 8:(u + 1) * unit * 8])
        seen.append(u)
        valid = block[block[:, 6] != 0]
        cent = 0.5 * (valid[:, 0:3].min(0).values + valid[:, 3:6].max(0).values)
        dist.append(float(((cent - CAMERA_POS) ** 2).sum()))
    assert sorted(seen) == list(range(len(seen))) and dist == sorted(dist)


def _walk(o, d, tri, leaf, hierarchy):
    """The sequential sweep, written out: leaves in storage order, each
    valid leaf's slab test against the best hit so far, the rows of each
    leaf entered one by one (the triangle test of ``nearest_hit``, the
    lexicographic (t, original index) minimum);
    with ``hierarchy``, a super-group's or a group's test at its first leaf
    gates its leaves. Returns ((t, idx, hit, front, row), leaves, groups,
    super-groups entered)."""
    n, k_size = o.shape[0], tri.shape[0] // leaf.shape[0]
    groups, supers = leaf_groups(leaf)
    inv = [safe_inv(d[:, k]) for k in range(3)]
    no_idx = torch.iinfo(torch.int32).max
    best_t = torch.full((n,), BIG)
    best_idx = torch.full((n,), no_idx, dtype=torch.int32)
    best_row = torch.zeros(n, dtype=torch.int64)
    front = torch.zeros(n, dtype=torch.bool)
    counts = [torch.zeros(n, dtype=torch.int32) for _ in range(3)]
    open_s = open_g = torch.ones(n, dtype=torch.bool)

    def enters(box):
        passes, enter = leaf_slabs(box[None], o, inv)
        return (box[6] != 0) & passes[:, 0] & (enter[:, 0] < best_t)

    for lf in range(leaf.shape[0]):
        if hierarchy and lf % (GROUP_SIZE * SUPER_SIZE) == 0:
            open_s = enters(supers[lf // (GROUP_SIZE * SUPER_SIZE)])
            counts[2] += open_s.to(torch.int32)
        if hierarchy and lf % GROUP_SIZE == 0:
            open_g = open_s & enters(groups[lf // GROUP_SIZE])
            counts[1] += open_g.to(torch.int32)
        want = open_g & enters(leaf[lf])
        counts[0] += want.to(torch.int32)
        r0 = lf * k_size
        tt, valid, nd = _tri_test(o, d, tri[r0:r0 + k_size])
        for k in range(k_size):
            t, idx = tt[:, k], tri[r0 + k, 17].to(torch.int32)
            take = want & valid[:, k] & ((t < best_t) | ((t == best_t) & (idx < best_idx)))
            best_t = torch.where(take, t, best_t)
            best_idx = torch.where(take, idx, best_idx)
            best_row = torch.where(take, r0 + k, best_row)
            front = torch.where(take, nd[:, k] < 0.0, front)
    hit = best_idx != no_idx
    return (best_t, torch.where(hit, best_idx, 0), hit, front, best_row), *counts


@pytest.mark.parametrize("near_to_far", [False, True], ids=["morton", "near_to_far"])
@pytest.mark.parametrize("leaf_size", [8, 16])
@pytest.mark.parametrize("kind", ["camera", "random", "vertex"])
def test_group_sweep_equals_flat_walk(field520, kind, leaf_size, near_to_far):
    o, d = _rays(field520, kind, n=768, seed=leaf_size + 1)
    tri, leaf = _pack(field520, leaf_size, near_to_far)
    flat, flat_leaves, _, _ = _walk(o, d, tri, leaf, hierarchy=False)
    walked, *walked_counts = _walk(o, d, tri, leaf, hierarchy=True)
    counts = [torch.zeros(o.shape[0], dtype=torch.int32) for _ in range(3)]
    got = nearest_hit_leaves(o, d, tri, leaf, visits=counts[0], group_visits=counts[1], super_visits=counts[2])
    for a, b, c, what in zip((*got[:4], got[4]), flat, walked, ("t", "idx", "hit", "front", "row")):
        assert torch.equal(a, b), f"{what} differs from the flat walk"
        assert torch.equal(c, b), f"the walked hierarchy's {what} differs from the flat walk"
    assert torch.equal(counts[0], flat_leaves) and torch.equal(walked_counts[0], flat_leaves)
    for k, what in ((1, "groups"), (2, "super-groups")):
        assert torch.equal(counts[k], walked_counts[k]), what
    assert flat[2].float().mean() > 0.3
    # the groups' tests skip leaf tests
    assert GROUP_SIZE * counts[1].float().mean() < (leaf[:, 6] != 0).sum()
    if (kind, leaf_size, near_to_far) == ("random", 16, True):
        jscene = jscenes.build_tri_field(520, 3, glass=True)
        rec = jax_nearest_hit(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jscene)
        hit = np.asarray(rec.hit)
        np.testing.assert_array_equal(got[2].numpy(), hit)
        np.testing.assert_array_equal(got[1].numpy()[hit], np.asarray(rec.tri_index)[hit])
        np.testing.assert_array_equal(got[3].numpy()[hit], np.asarray(rec.front_face)[hit])
        np.testing.assert_allclose(got[0].numpy()[hit], np.asarray(rec.t)[hit], rtol=1e-5)
