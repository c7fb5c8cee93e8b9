"""The port's last two examples (spectral_tpu_torch/examples/inverse_field.py,
inverse_dispersion.py) against the JAX package's, on the CPU.

Each example's first step at a small size is held against the JAX
example's, stored in tests/torch_jax_refs.npz (cases inverse_field and
inverse_dispersion; no JAX function runs here):
- inverse_field on the 520-triangle glass field at 32x16 (padded to 1024
  rays with pixel (0, 0)), 4 spp, 5 bounces, on JAX's uniform planes: the
  target, the pixel MSE and its gradient in the green row through the plain
  versions of the sorted residual forward and the replay, against JAX's
  interpret-mode kernels (images within IMAGE_ATOL, the gradient within
  REPLAY_REL of each coefficient column's largest value);
- inverse_dispersion at 32 px, 6 bounces, B0 + 0.08: an XLA-style estimate
  of the first step (the CRN residual and the reparameterized VJP, 16 spp)
  on the draws of the JAX example's keys, and the fused gradient factor
  (spp_g 4) on shared uniform planes, each within GRAD_REL of its largest
  value.
Then a 2-3 step run of each example on the CPU: inverse_field's SPD error
falls; inverse_dispersion's B0 moves by the clipped estimates' mean times
lr a step. Whether B0's error falls in 2 steps is a matter of the draws
(one estimate's signal-to-noise ratio is ~0.12, and most estimates are 0 at
a small size), so only the full run's gate on the card asserts it.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from spectral_tpu_torch.examples import inverse_dispersion, inverse_field

import torch_jax_refs as refs
from test_torch_xla import StoredDraws

# one torch thread a process: the CPU test run's workers share the cores
torch.set_num_threads(1)

IMAGE_ATOL = 2e-3  # tests/test_wavefront_sorted.py:70
REPLAY_REL = 2e-4  # the fused gradients' tolerance (tests/test_torch_grad.py)
GRAD_REL = 1e-4  # the warp files' tolerance (tests/test_torch_warp.py)


def _case(name: str):
    x = refs.CASES[name][0]()
    return x, refs.outputs(name, x)


def test_inverse_field_first_step_equals_jax():
    x, ref = _case("inverse_field")
    prob = inverse_field.Problem("cpu", refs.IF_W, refs.IF_TRIS, refs.IF_SPP, refs.IF_BOUNCES,
                                 rand=torch.from_numpy(x["planes"]))
    # the port builds the JAX example's scene and pixels
    for k in ("v0", "v1", "v2", "mat_index"):
        np.testing.assert_array_equal(getattr(prob.scene, k).numpy(), x["scene"][k])
    np.testing.assert_array_equal(prob.truth.coeffs.numpy(), x["scene"]["materials"]["coeffs"])
    np.testing.assert_array_equal(prob.px.numpy(), x["px"])
    np.testing.assert_array_equal(prob.py.numpy(), x["py"])
    assert np.abs(prob.target.numpy() - ref["target"]).max() <= IMAGE_ATOL
    # the field is lit by its small ceiling light alone: few pixels see light
    # at this size, and the green row's gradient comes from their paths
    assert (ref["target"].sum(-1) > 0).sum() >= 2

    c = prob.truth.coeffs[inverse_field.GREEN] + torch.from_numpy(x["offset"])
    loss, g = prob.loss_and_grad(c)
    np.testing.assert_allclose(float(loss), float(ref["loss"]), rtol=1e-4)
    want = ref["d_coeffs"]
    assert np.abs(want[inverse_field.GREEN]).max() > 0
    err = np.abs(g.numpy() - want[inverse_field.GREEN])
    assert (err <= REPLAY_REL * np.abs(want).max(0)).all(), (err, np.abs(want).max(0))


def _sub_draws(ref: dict, key: str) -> StoredDraws:
    pre = f"{key}."
    return StoredDraws({k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)})


def test_inverse_dispersion_xla_estimate_equals_jax():
    x, ref = _case("inverse_dispersion")
    prob = inverse_dispersion.Problem("xla", "cpu", refs.ID_SIZE, refs.ID_SPP)
    b = prob.b_true + torch.tensor([refs.ID_OFFSET, 0.0, 0.0])
    resid = prob.residual(b, 0, draws=_sub_draws(ref, "k1"))
    assert np.abs(ref["resid"]).max() > 0
    assert np.abs(resid.numpy() - ref["resid"]).max() <= IMAGE_ATOL / refs.ID_SPP
    np.testing.assert_allclose(float(torch.mean(resid**2)), float(ref["loss"]), rtol=1e-4)
    g = prob.factor(b, 0, 2.0 * resid / resid.numel(), draws=_sub_draws(ref, "k2")).numpy()
    scale = np.abs(ref["g_xla"]).max()
    assert scale > 0 and np.abs(g - ref["g_xla"]).max() <= GRAD_REL * scale, (g, ref["g_xla"])


def test_inverse_dispersion_fused_factor_equals_jax():
    x, ref = _case("inverse_dispersion")
    prob = inverse_dispersion.Problem("fused", "cpu", refs.ID_SIZE, spp_g=refs.ID_SPPG)
    np.testing.assert_array_equal(prob.px.numpy(), x["px"])
    b = prob.b_true + torch.tensor([refs.ID_OFFSET, 0.0, 0.0])
    g = prob.factor(b, 0, torch.from_numpy(x["cot"]), rand=torch.from_numpy(x["planes"])).numpy()
    scale = np.abs(ref["g_fused"]).max()
    assert scale > 0 and np.abs(g - ref["g_fused"]).max() <= GRAD_REL * scale, (g, ref["g_fused"])


def test_inverse_field_runs_on_the_cpu():
    out = inverse_field.main(3, "cpu", size=32, n_tris=520, log=lambda *a: None)
    assert out["spd_err"] < out["spd_err0"] and out["n_tris"] == 528
    assert all(np.isfinite(out["losses"]))


@pytest.mark.parametrize("impl", ("xla", "fused"))
def test_inverse_dispersion_runs_on_the_cpu(impl):
    """Two SGD steps of 4 estimates at 32 px, 4 spp (spp_g 4): B0 moves,
    by at most lr x CLIP a step, with B1 and B2 pinned; no gate (a full run
    has 260 steps)."""
    out = inverse_dispersion.main(impl, 2, "cpu", size=32, spp=4, spp_g=4, estimates=4, log=lambda *a: None)
    assert not out["gated"] and len(out["errs"]) == 2 and np.isfinite(out["errs"]).all()
    errs = [out["err0"], *out["errs"]]
    assert max(abs(a - b) for a, b in zip(errs, errs[1:])) <= inverse_dispersion.LR0 * inverse_dispersion.CLIP
    assert errs != [errs[0]] * 3 and out["b0"] != 0.0
