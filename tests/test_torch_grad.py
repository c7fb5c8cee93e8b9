"""The port's fused-backward pieces against the JAX package's, on the CPU.

(a) The replay's plain version (ops/cuda/grad_kernel.py::
    render_grads_reference) against render_grads_pallas in interpret mode
    (its outputs stored in tests/torch_jax_refs.npz, case replay_tris),
    background and Sellmeier outputs on, on synthetic residuals for TRIS
    (9 materials, so no padding of M is assumed): 1024 rays, 2 spp, 4
    bounces, material residuals in {-1, 0, 1..9}, n_valid in {0, 1, 7},
    heroes in [360, 830), a seeded cotangent. Tolerances:
    - d_coeffs per column, d_power and d_bg: |a - b| <= 2e-4 max|b| of that
      column. The same float32 terms are summed in another order; the c0
      column is ~1e5x the c2 column (it carries lambda^2), so one max over
      all columns would say nothing about c2.
    - sell_a / sell_b per (sample, ray): rtol 2e-4 and atol 1e-6 max|b|
      (sums of seven to a few dozen float32 terms whose fused multiply-adds
      fall in other places).
(b) ``reparam_hero`` (hero, weight) and ``sellmeier_index`` against the JAX
    functions on 4096 numpy heroes, for the PRISM glass (the reference's
    C := B) and the physical flint glass of the slab scene: rtol 1e-5.
(c) ``_sellmeier_grads_from_replay`` against the JAX function on the same
    numpy (hero, sell_a, sell_b): rtol 1e-4 (second-order AD through the
    Sellmeier map in float32, terms summed in another order).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectral_tpu.diff.fast import _sellmeier_grads_from_replay as jax_sell_grads
from spectral_tpu.diff.spectral_reparam import reparam_hero as jax_reparam_hero
from spectral_tpu.models.scenes import PRISM
from spectral_tpu.models.scenes import build_scene as jax_build_scene
from spectral_tpu.ops.sellmeier import sellmeier_index as jax_sellmeier_index
from spectral_tpu.utils.constants import SELLMEIER_FLINT_GLASS_B, SELLMEIER_FLINT_GLASS_C
from spectral_tpu_torch.diff.fast import _sellmeier_grads_from_replay
from spectral_tpu_torch.diff.spectral_reparam import SMAX, reparam_hero
from spectral_tpu_torch.ops.cuda.grad_kernel import lut_slope, render_grads, render_grads_reference
from spectral_tpu_torch.ops.sellmeier import sellmeier_index

import torch_jax_refs as refs

# one torch thread a process: the CPU test run's workers share the cores
torch.set_num_threads(1)

N, SPP, BOUNCES = 1024, 2, 4


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def assert_columns_close(got, ref, rel=2e-4):
    """|a - b| <= rel * max|b|, column by column."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    got, ref = got.reshape(ref.shape[0], -1), ref.reshape(ref.shape[0], -1)
    for j in range(ref.shape[1]):
        scale = np.abs(ref[:, j]).max()
        err = np.abs(got[:, j] - ref[:, j]).max()
        assert err <= rel * scale, f"column {j}: max abs {err} vs bound {rel * scale}"


@pytest.fixture(scope="module")
def synthetic():
    """The synthetic residuals, and the JAX replay of them
    (render_grads_pallas in interpret mode, stored in
    tests/torch_jax_refs.npz for these inputs)."""
    x = refs.replay_tris_inputs()
    ref = refs.outputs("replay_tris", x)
    port_in = (_t(x["mat"]), _t(x["tab"][:5, :95]), *(_t(x[k]) for k in ("g", "hero", "n_valid", "power", "matres")))
    return port_in, [ref[k] for k in ("d_coeffs", "d_power", "d_bg", "sell_a", "sell_b")]


def test_replay_equals_pallas_interpret(synthetic):
    """(a)"""
    port_in, ref = synthetic
    got = render_grads_reference(*port_in, SPP, BOUNCES, want_bg_grads=True, want_sellmeier=True)
    assert len(got) == len(ref) == 5
    d_coeffs, d_power, d_bg, sell_a, sell_b = (x.numpy() for x in got)
    assert d_coeffs.shape == (9, 3) and d_power.shape == (9,) and d_bg.shape == (95,)
    assert np.isfinite(d_coeffs).all() and np.abs(d_coeffs).sum() > 0
    assert_columns_close(d_coeffs, ref[0])
    assert_columns_close(d_power, ref[1])
    assert_columns_close(d_bg, ref[2])
    assert np.abs(d_power).max() > 0 and np.abs(d_bg).max() > 0
    for a, b in ((sell_a, ref[3]), (sell_b, ref[4])):
        assert a.shape == (SPP, N)
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-6 * np.abs(b).max())


def test_replay_options_are_slices(synthetic):
    """Leaving out the background or Sellmeier outputs changes nothing else,
    and render_grads takes the plain version for CPU tensors."""
    port_in, _ = synthetic
    full = render_grads(*port_in, SPP, BOUNCES, want_bg_grads=True, want_sellmeier=True)
    for bg, sell in ((False, False), (True, False), (False, True)):
        part = render_grads(*port_in, SPP, BOUNCES, want_bg_grads=bg, want_sellmeier=sell)
        want = list(full[:2]) + ([full[2]] if bg else []) + (list(full[3:]) if sell else [])
        assert len(part) == len(want)
        for a, b in zip(part, want):
            assert torch.equal(a, b)


def test_replay_checks_inputs(synthetic):
    port_in, _ = synthetic
    mat, tab, g, hero, n_valid, power, matres = port_in
    with pytest.raises(ValueError):
        render_grads(mat, tab, g, hero, n_valid, power, matres.float(), SPP, BOUNCES)
    with pytest.raises(ValueError):
        render_grads(mat, tab, g[:-1], hero, n_valid, power, matres, SPP, BOUNCES)
    with pytest.raises(ValueError):
        render_grads(mat, tab, g, hero, n_valid, power, matres, SPP, BOUNCES + 1)


def test_lut_slope_is_the_lerp_derivative():
    row = torch.from_numpy(np.random.default_rng(3).uniform(size=95).astype(np.float32))
    cell = torch.arange(94)
    np.testing.assert_array_equal(lut_slope(row, cell).numpy(), np.diff(row.numpy()))


def _glasses():
    b_prism = np.asarray(jax_build_scene(PRISM).materials.sellmeier_b[2])
    c_prism = np.asarray(jax_build_scene(PRISM).materials.sellmeier_c[2])
    flint = (np.asarray(SELLMEIER_FLINT_GLASS_B, np.float32), np.asarray(SELLMEIER_FLINT_GLASS_C, np.float32))
    return {"prism": (b_prism, c_prism), "flint": flint}


@pytest.mark.parametrize("glass", ("prism", "flint"))
def test_reparam_hero_equals_jax(glass):
    """(b)"""
    b, c = _glasses()[glass]
    if glass == "prism":
        np.testing.assert_array_equal(b, c)  # the reference's C := B
    hero = np.random.default_rng(11).uniform(360.0, 830.0, 4096).astype(np.float32)
    jh, jw = jax_reparam_hero(jnp.asarray(hero), jnp.asarray(b), jnp.asarray(c))
    th, tw = reparam_hero(_t(hero), _t(b), _t(c))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5)
    # displaced coefficients with the frozen target: a real shift, capped by SMAX
    b1 = (b + np.asarray([0.02, 0.0, 0.0], np.float32)).astype(np.float32)
    jh, jw = jax_reparam_hero(jnp.asarray(hero), jnp.asarray(b1), jnp.asarray(c), frozen=(jnp.asarray(b), jnp.asarray(c)))
    th, tw = reparam_hero(_t(hero), _t(b1), _t(c), frozen=(_t(b), _t(c)))
    assert np.abs(th.numpy() - hero).max() > 0.1 and np.abs(th.numpy() - hero).max() <= SMAX
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-5)
    n_ref = np.asarray(jax_sellmeier_index(jnp.asarray(b), jnp.asarray(c), jnp.asarray(hero)))
    np.testing.assert_allclose(sellmeier_index(_t(b), _t(c), _t(hero)).numpy(), n_ref, rtol=1e-5)


@pytest.mark.parametrize("glass", ("prism", "flint"))
def test_sellmeier_grads_from_replay_equals_jax(glass):
    """(c)"""
    b, c = _glasses()[glass]
    rng = np.random.default_rng(12)
    hero = rng.uniform(360.0, 830.0, (2, 2048)).astype(np.float32)
    sell_a = rng.normal(size=(2, 2048)).astype(np.float32)
    sell_b = rng.normal(size=(2, 2048)).astype(np.float32)
    jmats = dataclasses.replace(
        jax_build_scene(PRISM).materials,
        sellmeier_b=jax_build_scene(PRISM).materials.sellmeier_b.at[2].set(b),
        sellmeier_c=jax_build_scene(PRISM).materials.sellmeier_c.at[2].set(c),
    )
    ref_b, ref_c = (np.asarray(x) for x in jax_sell_grads(jmats, 2, jnp.asarray(hero), jnp.asarray(sell_a), jnp.asarray(sell_b)))

    @dataclasses.dataclass
    class Mats:
        sellmeier_b: torch.Tensor
        sellmeier_c: torch.Tensor

    tmats = Mats(_t(np.asarray(jmats.sellmeier_b)), _t(np.asarray(jmats.sellmeier_c)))
    got_b, got_c = _sellmeier_grads_from_replay(tmats, 2, _t(hero), _t(sell_a), _t(sell_b))
    assert np.abs(ref_b).max() > 0
    np.testing.assert_allclose(got_b.numpy(), ref_b, rtol=1e-4)
    np.testing.assert_allclose(got_c.numpy(), ref_c, rtol=1e-4)
