"""The port's multi-device layer (spectral_tpu_torch/parallel/) on the CPU.

One world of four gloo processes (a 2 x 2 mesh, tests/torch_parallel_worker.py,
spawned once for the module with a file:// rendezvous and a timeout) runs
every sharded function on the plain versions; this process holds what each
rank returned:

- the XLA-style render and train step against JAX's on a 2 x 2 CPU mesh
  (stored cases par_render and par_train of tests/torch_jax_refs.npz, each
  shard on its own JAX draws): the image within XLA_IMAGE_TOL, the loss
  within 1e-5 relative and the gradients within XLA_GRAD_REL of each
  leaf's largest (tests/test_torch_xla.py's gaps; more than two ranks may
  sum the gradients in another order than JAX);
- the kernel renders (dense Cornell, the 520-triangle field through the
  sorted scheduler and through the leaf megakernel) bit-equal to what this
  process composes from the shards' one-device renders at the same shard
  seeds (a 2-rank sum is a + b in either order; the tile assembly adds
  zeros);
- the fused gradients (dense Cornell, the field): the loss within 1e-6
  relative and the gradients within REPLAY_REL of each leaf's largest of
  the true gradient composed here by autograd over the shards' fused
  renders; the replay sums in an order its launch shape sets.

Besides: factor_devices, the meshes, local_row_block's failure paths under
a patched world, the stored case that shows JAX's fused gradient is
n_sample times the true one (ROADMAP C8), and a 3-step CPU run of
examples/inverse_rendering.py. No JAX function runs here.
"""

from __future__ import annotations

import dataclasses
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_jax_refs as refs
import torch_parallel_worker as worker
from spectral_tpu_torch.diff import render_rays_diff_fused
from spectral_tpu_torch.models.scenes import CORNELL, scene_camera
from spectral_tpu_torch.ops.cuda.render_kernel import render_chunk
from spectral_tpu_torch.parallel import (
    Mesh,
    factor_devices,
    local_row_block,
    make_global_mesh,
    make_mesh,
    mesh_of_shape,
    render_image_sharded,
    render_image_sharded_pallas,
)
from spectral_tpu_torch.parallel.render import FUSED_SEED_STRIDE, RENDER_SEED_STRIDE

# one torch thread a process: the CPU test run's workers share the cores
torch.set_num_threads(1)

N_RANKS, SHAPE = 4, (2, 2)
XLA_IMAGE_TOL = 1.5e-5
XLA_GRAD_REL = 1.2e-6
REPLAY_REL = 2e-4
WORLD_TIMEOUT = 240


def _shard_draws(out: dict) -> dict:
    return {r: {k.split(".")[-1]: v for k, v in out.items() if k.startswith(f"shard{r}.draws.")}
            for r in range(N_RANKS)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Each rank's outputs (dicts of arrays), and the stored JAX cases."""
    tmp = tmp_path_factory.mktemp("world")
    cases = {}
    for name in ("par_render", "par_train"):
        x = refs.CASES[name][0]()
        cases[name] = (x, refs.outputs(name, x))
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump({k: (x, _shard_draws(out)) for k, (x, out) in cases.items()}, f)
    try:
        ranks = worker.spawn(N_RANKS, [str(tmp / "inputs.pkl"), str(tmp)], tmp, WORLD_TIMEOUT)
    except RuntimeError as e:
        pytest.fail(str(e))
    return ranks, cases


@pytest.mark.parametrize("n, want", ((8, (4, 2)), (4, (2, 2)), (7, (7, 1)), (1, (1, 1))))
def test_factor_devices(n, want):
    assert factor_devices(n) == want


def test_meshes_without_and_with_a_process_group(world):
    """With no process group: the 1 x 1 mesh, which makes no collective
    call; any other size raises. In the world: the 2 x 2 mesh, rank =
    ti * 2 + si, the host-major global mesh equal to it on one host, and
    each rank's rows."""
    assert not dist.is_initialized()
    for mesh in (make_mesh(device="cpu"), make_mesh(1, device="cpu"), make_global_mesh("cpu")):
        assert mesh.shape == {"tile": 1, "sample": 1} and not mesh.distributed
        x = torch.ones(3)
        assert mesh.sum(x) is x and mesh.collectives == 0
    with pytest.raises(ValueError):
        make_mesh(4, device="cpu")
    with pytest.raises(ValueError):
        mesh_of_shape(2, 2, "cpu")
    ranks, _ = world
    for r, out in enumerate(ranks):
        assert tuple(out["shape"]) == SHAPE and tuple(out["coords"]) == divmod(r, SHAPE[1])
        assert tuple(out["global_shape"]) == SHAPE and tuple(out["global_coords"]) == divmod(r, SHAPE[1])
        assert tuple(out["row_block"]) == (8 * (r // SHAPE[1]), 8)
        assert out["collectives"] > 0


def test_local_row_block_failure_paths(monkeypatch):
    """As tests/test_distributed.py:116: a height the tile extent does not
    divide raises; so does a mesh that does not cover the world."""
    mesh = Mesh(*SHAPE, 1, 0, "cpu")
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: N_RANKS)
    with pytest.raises(ValueError):
        local_row_block(2 * 3 + 1, mesh)
    assert local_row_block(2 * 3, mesh) == (3, 3)
    monkeypatch.setattr(dist, "get_world_size", lambda: 3)
    with pytest.raises(ValueError):
        local_row_block(2 * 3, mesh)


def test_extents_that_do_not_divide_raise():
    """16 rows over 3 tiles, or 4 samples over 3, raise before rendering."""
    from spectral_tpu_torch.models.scenes import build_scene

    scene = build_scene(CORNELL, "cpu")
    cam = scene_camera(CORNELL, 16, 16, "cpu")
    for shape in ((3, 1), (1, 3)):
        with pytest.raises(ValueError, match="must divide mesh"):
            render_image_sharded(scene, cam, 0, 4, 2, mesh=Mesh(*shape, 0, 0, "cpu"))
        with pytest.raises(ValueError, match="must divide mesh"):
            render_image_sharded_pallas(scene, cam, 0, 4, 2, mesh=Mesh(*shape, 0, 0, "cpu"))


def test_sharded_xla_render_equals_jax(world):
    """The XLA-style render on the 2 x 2 mesh against JAX's
    render_image_sharded, each shard on its JAX draws; every rank holds the
    same whole image."""
    ranks, cases = world
    ref = cases["par_render"][1]["xyz"]
    assert ref.max() > 1.0
    for out in ranks:
        np.testing.assert_array_equal(out["xla_image"], ranks[0]["xla_image"])
    assert np.abs(ranks[0]["xla_image"] - ref).max() <= XLA_IMAGE_TOL


def test_sharded_train_step_equals_jax(world):
    """The loss and gradients on the 2 x 2 mesh against JAX's train_step
    and its gradient; train_step's new parameters against JAX's."""
    ranks, cases = world
    x, ref = cases["par_train"]
    lr = float(x["lr"])
    for out in ranks:
        np.testing.assert_allclose(out["xla_loss"], ref["loss"], rtol=1e-5)
        np.testing.assert_array_equal(out["xla_step_loss"], out["xla_loss"])
        for leaf, p, new in (("coeffs", x["coeffs"], "coeffs"), ("emission_power", x["power"], "power")):
            g, want = out[f"xla_d_{leaf}"], ref[f"d_{new}"]
            scale = np.abs(want).max()
            assert scale > 0.0 and np.abs(g - want).max() <= XLA_GRAD_REL * scale, leaf
            step_tol = lr * XLA_GRAD_REL * scale + 2 * np.spacing(np.abs(p))
            assert (np.abs(out[f"xla_new_{leaf}"] - ref[new]) <= step_tol).all(), leaf


def _composed_image(scene, cam, seed, spp, bounces, sched) -> torch.Tensor:
    nt, ns = SHAPE
    rows, local_spp = cam.image_height // nt, spp // ns
    tiles = []
    for ti in range(nt):
        xyz = [render_chunk(scene, cam, seed + (ti * ns + si) * RENDER_SEED_STRIDE, 0, ti * rows, cam.image_width,
                            rows, local_spp, bounces, sched=sched) for si in range(ns)]
        tiles.append(xyz[0] + xyz[1])
    return torch.cat(tiles)


@pytest.mark.parametrize("run", worker.KERNEL_RUNS, ids=[r[0] for r in worker.KERNEL_RUNS])
def test_sharded_kernel_render_equals_composition(world, run):
    """render_image_sharded_pallas on the 2 x 2 mesh, bit-equal on every
    rank to the shards' one-device renders composed here."""
    ranks, _ = world
    name, s, (w, h), spp, bounces, seed, sched = run
    scene = worker.scenes()[s]
    want = _composed_image(scene, scene_camera(CORNELL, w, h, "cpu"), seed, spp, bounces, sched).numpy()
    assert want.max() > 0.0
    for out in ranks:
        np.testing.assert_array_equal(out[f"kernel_{name}"], want)


def _composed_fused(scene, cam, params, target, seed, spp, bounces, sched):
    """The true loss and gradient, by autograd over the shards' fused
    renders: the sample shards summed, the per-tile sums of squares summed."""
    nt, ns = SHAPE
    h, w = cam.image_height, cam.image_width
    rows, local_spp = h // nt, spp // ns
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    mats = dataclasses.replace(scene.materials, **leaves)
    total = 0.0
    for ti in range(nt):
        ys, xs = torch.meshgrid(torch.arange(ti * rows, (ti + 1) * rows), torch.arange(w), indexing="ij")
        px, py = xs.reshape(-1).float(), ys.reshape(-1).float()
        xyz = sum(render_rays_diff_fused(mats, scene, cam, px, py, seed + (ti * ns + si) * FUSED_SEED_STRIDE,
                                         local_spp, bounces, sched=sched) for si in range(ns))
        img = xyz.reshape(rows, w, 3) / spp
        total = total + torch.sum((img - target[ti * rows:(ti + 1) * rows]) ** 2)
    grads = torch.autograd.grad(total, list(leaves.values()))
    return float(total.detach()) / (h * w * 3), dict(zip(leaves, grads))


@pytest.mark.parametrize("run", worker.FUSED_RUNS, ids=[r[0] for r in worker.FUSED_RUNS])
def test_sharded_fused_gradient_is_the_true_one(world, run):
    """fused_loss_and_grads (train_step_fused's step) on the 2 x 2 mesh:
    the loss and the true gradient composed here, not n_sample times it."""
    ranks, _ = world
    name, s, (w, h), spp, bounces, seed, sched = run
    scene = worker.scenes()[s]
    params, target = worker.fused_problem(scene, (w, h))
    loss, grads = _composed_fused(scene, scene_camera(CORNELL, w, h, "cpu"), params, target, seed, spp, bounces,
                                  sched)
    for out in ranks:
        assert abs(float(out[f"fused_{name}_loss"]) - loss) <= 1e-6 * loss
        for k, want in grads.items():
            want = want.numpy()
            got = out[f"fused_{name}_d_{k}"]
            scale = np.abs(want).max()
            if k == "coeffs":
                assert scale > 0.0
            assert np.abs(got - want).max() <= REPLAY_REL * scale, k
            ratio = float(np.sum(got * want) / max(np.sum(want * want), 1e-30)) if scale > 0 else 1.0
            assert abs(ratio - 1.0) <= REPLAY_REL, (k, ratio)


def test_jax_fused_gradient_is_n_sample_times_the_true_one():
    """ROADMAP C8, on stored JAX outputs: JAX's train_step_fused on its
    2 x 2 mesh (interpret mode) descends n_sample = 2 times the gradient
    JAX composes from its own per-shard fused renders, at the same loss."""
    x = refs.par_fused_inputs()
    ref = refs.outputs("par_fused", x)
    lr = float(x["lr"])
    np.testing.assert_allclose(ref["loss"], ref["composed_loss"], rtol=1e-6)
    for p, new, composed in ((x["coeffs"], ref["coeffs"], ref["composed_d_coeffs"]),
                             (x["power"], ref["power"], ref["composed_d_power"])):
        sharded = (p.astype(np.float64) - new) / lr
        tol = 2 * np.spacing(np.maximum(np.abs(p), np.abs(new))) / lr + 1e-6 * np.abs(composed).max()
        assert (np.abs(sharded - SHAPE[1] * composed) <= tol).all()
    assert np.abs(ref["composed_d_coeffs"]).max() > 0.0


def test_one_device_calls_keep_their_results():
    """With no process group, mesh=None is the one-device path: the kernel
    render is render_chunk of the whole frame at the seed itself."""
    from spectral_tpu_torch.models.scenes import build_scene

    scene = build_scene(CORNELL, "cpu")
    cam = scene_camera(CORNELL, 8, 8, "cpu")
    got = render_image_sharded_pallas(scene, cam, 5, 2, 3)
    assert torch.equal(got, render_chunk(scene, cam, 5, 0, 0, 8, 8, 2, 3))
    assert torch.equal(got, render_image_sharded_pallas(scene, cam, 5, 2, 3, mesh=Mesh.one("cpu")))


def test_inverse_rendering_example_loss_falls():
    """examples/inverse_rendering.py for 3 steps at 8x8 on the CPU."""
    from spectral_tpu_torch.examples.inverse_rendering import main

    out = main(3, "cpu", size=8, log=lambda *_: None)
    losses = out["losses"]
    assert len(losses) == 3 and losses[0] > losses[1] > losses[2] > 0.0, losses
    assert out["spd_err"] < out["spd_err0"]
