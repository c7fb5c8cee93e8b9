"""The port's dense nearest hit against the JAX package's, on the CPU.

``spectral_tpu_torch.ops.cuda.intersect_kernel.intersect`` runs its plain
version for CPU tensors; it is held against the Pallas intersect kernel in
interpret mode (its outputs stored in tests/torch_jax_refs.npz) and
against the XLA ``nearest_hit``, on numpy rays from a
seed. Hit flags, triangle ids and faces must be equal. t must agree within
rtol 1e-6 with the Pallas kernel, whose arithmetic the port mirrors
(ops/fp32.py). The XLA version computes t through matrix products, in
another order: there t = (d - n.o) / n.d may also differ by the float32
rounding of the cancelling difference d - n.o, a few ulps of |d| + |n||o|
amplified by 1 / |n.d|. The kernel itself is checked against the plain
version on the card in tests/test_torch_cuda.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectral_tpu.models.scenes import build_scene as jax_build_scene
from spectral_tpu.ops.intersect import nearest_hit as jax_nearest_hit
from spectral_tpu.ops.pallas.intersect_kernel import pack_tris as jax_pack_tris
from spectral_tpu_torch.models.scenes import CORNELL, PRISM, TRIS, build_scene
from spectral_tpu_torch.ops.cuda.intersect_kernel import intersect, pack_tris
from spectral_tpu_torch.ops.intersect import BIG, nearest_hit

import torch_jax_refs as refs

# one torch thread a process: the CPU test run's workers share the cores
torch.set_num_threads(1)

N_RAYS = 512


def _rays(seed: int, n: int = N_RAYS):
    """Origins inside and in front of the box, random directions."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([20.0, 20.0, -400.0], [535.0, 535.0, 535.0], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d


def test_pack_tris_equals_jax():
    ours = pack_tris(build_scene(CORNELL, "cpu")).numpy()
    theirs = np.asarray(jax_pack_tris(jax_build_scene(CORNELL)))
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=1e-6)


def test_intersect_equals_pallas_interpret():
    """intersect_pallas in interpret mode, its outputs stored in
    tests/torch_jax_refs.npz (case intersect_cornell) for these inputs."""
    o, d = _rays(0)
    tri = pack_tris(build_scene(CORNELL, "cpu"))
    ref = refs.outputs("intersect_cornell", dict(o=o, d=d, tri=tri.numpy()))
    t, idx, hit, front = intersect(torch.from_numpy(o), torch.from_numpy(d), tri)
    jt, jidx, jhit, jfront = (ref[k] for k in ("t", "idx", "hit", "front"))
    assert 0.5 < hit.numpy().mean() < 1.0  # both hits and misses
    np.testing.assert_array_equal(hit.numpy(), jhit)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(front.numpy(), jfront)
    np.testing.assert_allclose(t.numpy(), jt, rtol=1e-6)
    assert t.dtype == torch.float32 and idx.dtype == torch.int32
    assert hit.dtype == torch.bool and front.dtype == torch.bool


@pytest.mark.parametrize("scene_id", (CORNELL, PRISM, TRIS))
@pytest.mark.parametrize("seed", (1, 2))
def test_nearest_hit_equals_xla(scene_id, seed):
    o, d = _rays(seed)
    t, idx, hit, front = nearest_hit(
        torch.from_numpy(o), torch.from_numpy(d), pack_tris(build_scene(scene_id, "cpu"))
    )
    rec = jax_nearest_hit(jnp.asarray(o), jnp.asarray(d), jax_build_scene(scene_id))
    jhit = np.asarray(rec.hit)
    np.testing.assert_array_equal(hit.numpy(), jhit)
    h = jhit
    np.testing.assert_array_equal(idx.numpy()[h], np.asarray(rec.tri_index)[h])
    np.testing.assert_array_equal(front.numpy()[h], np.asarray(rec.front_face)[h])
    tri = pack_tris(build_scene(scene_id, "cpu")).numpy()[idx.numpy()[h]]
    n, dd = tri[:, 0:3], tri[:, 3]
    cancel = (np.abs(dd) + np.abs(n * o[h]).sum(1)) / np.abs((n * d[h]).sum(1))
    tol = 1e-6 * np.abs(np.asarray(rec.t)[h]) + 4 * 2.0**-24 * cancel
    assert np.all(np.abs(t.numpy()[h] - np.asarray(rec.t)[h]) <= tol)
    # a miss reports the sweep's initial state
    assert np.all(t.numpy()[~h] == np.float32(BIG))
    assert np.all(idx.numpy()[~h] == 0) and not front.numpy()[~h].any()


def test_tie_goes_to_lower_index():
    """Two copies of a triangle are hit at the same t; the sequential sweep
    (and so the plain argmin) keeps the first."""
    floor = pack_tris(build_scene(CORNELL, "cpu"))[0:2]  # the floor quad
    o = torch.tensor([[100.0, 10.0, 100.0]])  # above the quad's first tri
    d = torch.tensor([[0.0, -1.0, 0.0]])
    t, idx, hit, front = nearest_hit(o, d, torch.cat([floor, floor]))
    assert hit.item() and front.item() and idx.item() == 0 and t.item() == 10.0
    _, idx, _, _ = nearest_hit(o, d, torch.cat([floor.flip(0), floor]))
    assert idx.item() == 1


def test_intersect_checks_shapes():
    tri = pack_tris(build_scene(CORNELL, "cpu"))
    o = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        intersect(o, torch.zeros(5, 3), tri)
    with pytest.raises(ValueError):
        intersect(o, torch.zeros(4, 3), tri[:, :15])

