"""The port's sorted scheduler and its fused gradients against the JAX
package's, on the CPU.

The configuration of tests/test_torch_wavefront.py (the sky-lit glass field
520/3, 64x32, 2 spp, 3 bounces, numpy planes). The JAX side ran once per
module, in interpret mode: its sorted scheduler (render_rays_wavefront,
save_residuals=True) and one replay (render_grads_pallas) of those
residuals for the frame's bottom half, which holds the boxes (the replay
takes 1024-ray tiles). Their outputs are stored in tests/torch_jax_refs.npz
(cases field_sorted and field_replay) for these inputs.

- The port's plain sorted scheduler against the JAX one, at the
  tolerances of tests/test_torch_wavefront.py, off the sample-rays where
  the JAX MXU sweep departs from its exact sweep (ROADMAP C3; that file
  holds each of them to the exact sweep).
- The port's fused gradient (the sorted residual forward through
  render_chunk_diff_fused, then the plain replay) against
  render_grads_pallas on the JAX sorted residuals, with one cotangent:
  zero outside the replayed half and on every pixel with a departed
  sample-ray. Coefficients, emission power and background knots per column
  within 2e-4 of the column's largest value (tests/test_torch_grad.py);
  the Sellmeier B/C of FIELD_GLASS_MAT at rtol 1e-3
  (tests/test_torch_diff.py), folded by each package's own
  _sellmeier_grads_from_replay.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from spectral_tpu_torch.diff import render_chunk_diff_fused
from spectral_tpu_torch.models.scenes import CORNELL, FIELD_GLASS_MAT, scene_camera
from spectral_tpu_torch.ops.cuda.wavefront_kernel import render_rays_wavefront
from test_torch_wavefront import (
    BOUNCES,
    H_PX,
    N,
    SPP,
    W_PX,
    assert_render_equal,
    departed,
    jax_field_inputs,
    port_field,
)

import torch_jax_refs as refs

# one torch thread a process: the CPU test run's workers share the cores
torch.set_num_threads(1)

# the pixels the gradient comparison replays: the frame's bottom half
REPLAYED = slice(N // 2, N)


@pytest.fixture(scope="module")
def field():
    jscene, x = jax_field_inputs()
    ref = refs.outputs("field_sorted", x)
    jax_sorted = [ref[k] for k in ("xyz", "hero", "n_valid", "power", "matres")]
    planes = x["planes"]
    scene, args = port_field(jscene, planes, x["px"], x["py"])
    port = render_rays_wavefront(*args, save_residuals=True)
    departed_rays = departed(port, jax_sorted)
    cot = np.random.default_rng(99).normal(size=(N, 3)).astype(np.float32)
    cot[departed_rays.any(axis=0)] = 0.0
    cot[: REPLAYED.start] = 0.0
    jgrads = refs.outputs("field_replay", refs.field_replay_inputs(x, cot))
    return dict(
        scene=scene, planes=planes, port=port, jax_sorted=jax_sorted, departed=departed_rays, cot=cot,
        jgrads=[jgrads[k] for k in ("d_coeffs", "d_power", "d_bg", "d_sell_b", "d_sell_c")],
    )


def test_sorted_scheduler_equals_jax(field):
    assert_render_equal(field["port"], field["jax_sorted"], field["departed"])


def test_gradients_on_sorted_residuals_equal_jax(field):
    scene = field["scene"]
    cam = scene_camera(CORNELL, W_PX, H_PX, "cpu")
    leaves = {k: getattr(scene.materials, k).clone().requires_grad_(True)
              for k in ("coeffs", "emission_power", "sellmeier_b", "sellmeier_c")}
    bg = scene.background_spd.clone().requires_grad_(True)
    scene_g = dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, **leaves), background_spd=bg)
    xyz = render_chunk_diff_fused(
        scene_g.materials, scene_g, cam, 0, 0, 0, W_PX, H_PX, SPP, BOUNCES,
        reparam_glass=FIELD_GLASS_MAT, rand=torch.from_numpy(field["planes"]),
    )
    assert torch.equal(xyz.detach().reshape(N, 3), field["port"][0])
    xyz.backward(torch.from_numpy(field["cot"]).reshape(H_PX, W_PX, 3))
    j_coeffs, j_power, j_bg, j_b, j_c = field["jgrads"]
    got = (leaves["coeffs"].grad.numpy(), leaves["emission_power"].grad.numpy()[:, None], bg.grad.numpy()[:, None])
    for a, b in zip(got, (j_coeffs, j_power[:, None], j_bg[:, None])):
        for j in range(b.shape[1]):
            err, scale = np.abs(a[:, j] - b[:, j]).max(), np.abs(b[:, j]).max()
            assert err <= 2e-4 * scale, (j, err, scale)
    assert np.abs(j_coeffs).max() > 0 and np.abs(j_power).max() > 0 and np.abs(j_bg).max() > 0
    d_b, d_c = leaves["sellmeier_b"].grad.numpy(), leaves["sellmeier_c"].grad.numpy()
    assert np.abs(d_b[FIELD_GLASS_MAT]).max() > 0
    assert not np.delete(d_b, FIELD_GLASS_MAT, 0).any() and not np.delete(d_c, FIELD_GLASS_MAT, 0).any()
    np.testing.assert_allclose(d_b[FIELD_GLASS_MAT], j_b, rtol=1e-3)
    np.testing.assert_allclose(d_c[FIELD_GLASS_MAT], j_c, rtol=1e-3)
