"""The port's general-colour rgb2spec (spectral_tpu_torch/ops/rgb2spec.py)
against the JAX package's, on the CPU.

The JAX outputs (lookup_sigmoid_coeffs, jax.vmap(_fit_one), and
srgb_to_spectrum and roundtrip_srgb through the table and through the LM fit)
are stored in tests/torch_jax_refs.npz, case rgb2spec: 32 colours of seed 5,
four grays and the three primaries. No JAX function runs here.

Tolerances: the table lookup within rtol 1e-5 / atol 1e-6 of JAX's
coefficients (measured: equal); the LM fit's SPDs and round-trip sRGB within
1e-4 of JAX's (measured: ~5e-5 and ~1e-5), its raw coefficients, which are
ill-conditioned, at rtol 1e-3 (grays excepted: their fit is degenerate and
fit_sigmoid_coeffs gives them the closed form); and the JAX suite's own
bounds (tests/test_spectrum_color.py:218, :248, :268): round trip of stock
colours within 2e-3, table against fit under 0.03, table round trip under
0.02.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import pytest
import torch

from spectral_tpu_torch.models.materials import MaterialBuilder
from spectral_tpu_torch.models.scenes import scene_from_soup
from spectral_tpu_torch.models.geometry import TriSoup
from spectral_tpu_torch.ops import rgb2spec

import torch_jax_refs as refs

# one torch thread a process: the CPU test run's workers share the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def case():
    x = refs.rgb2spec_inputs()
    return x, refs.outputs("rgb2spec", x)


def _gray(rgb: np.ndarray) -> np.ndarray:
    return (rgb[:, 0] == rgb[:, 1]) & (rgb[:, 1] == rgb[:, 2])


def _spd(coeffs) -> np.ndarray:
    return rgb2spec.spd_from_coeffs_reflectance(torch.as_tensor(coeffs)).numpy()


def test_table_copy_is_byte_identical():
    digests = []
    for pkg in ("spectral_tpu", "spectral_tpu_torch"):
        with open(os.path.join(ROOT, pkg, "data", "rgb2spec_table.npz"), "rb") as f:
            digests.append(hashlib.sha256(f.read()).hexdigest())
    assert digests[0] == digests[1]
    assert os.path.samefile(rgb2spec.TABLE_PATH, os.path.join(ROOT, "spectral_tpu_torch", "data", "rgb2spec_table.npz"))


def test_lookup_equals_jax(case):
    x, ref = case
    got = rgb2spec.lookup_sigmoid_coeffs(torch.from_numpy(x["rgb"])).numpy()
    np.testing.assert_allclose(got, ref["lookup"], rtol=1e-5, atol=1e-6)
    # any leading shape, and grays in closed form
    got2 = rgb2spec.lookup_sigmoid_coeffs(torch.from_numpy(x["rgb"]).reshape(3, 13, 3)).numpy()
    np.testing.assert_array_equal(got2.reshape(-1, 3), got)
    gray = _gray(x["rgb"])
    np.testing.assert_array_equal(got[gray], rgb2spec._gray_coeffs(torch.from_numpy(x["rgb"][gray, 0])).numpy())


def test_lm_fit_equals_jax(case):
    x, ref = case
    got = rgb2spec.lm_fit_coeffs(torch.from_numpy(x["rgb"])).numpy()
    assert np.isfinite(got).all()
    spd, want = _spd(got), _spd(ref["fit"])
    assert np.abs(spd - want).max() <= 1e-4
    rt = rgb2spec.roundtrip_srgb(torch.from_numpy(spd)).numpy()
    rt_want = rgb2spec.roundtrip_srgb(torch.from_numpy(want)).numpy()
    assert np.abs(rt - rt_want).max() <= 1e-4
    colour = ~_gray(x["rgb"])
    np.testing.assert_allclose(got[colour], ref["fit"][colour], rtol=1e-3)


@pytest.mark.parametrize("route", ("table", "exact"))
def test_srgb_to_spectrum_equals_jax(case, route, monkeypatch):
    """srgb_to_spectrum through the table (the default) and through the LM
    fit (RGB2SPEC_EXACT=1), and roundtrip_srgb of each, against JAX's."""
    x, ref = case
    monkeypatch.setenv("RGB2SPEC_EXACT", "1" if route == "exact" else "0")
    spd = rgb2spec.srgb_to_spectrum(torch.from_numpy(x["rgb"])).numpy()
    assert spd.shape == (x["rgb"].shape[0], 95)
    assert np.abs(spd - ref[f"spd_{route}"]).max() <= (1e-5 if route == "table" else 1e-4)
    rt = rgb2spec.roundtrip_srgb(torch.from_numpy(ref[f"spd_{route}"])).numpy()
    assert np.abs(rt - ref[f"rt_{route}"]).max() <= 1e-4


def test_fit_meets_the_jax_suites_bounds(case):
    """Round trip of the stock colours within 2e-3 (their palette fits),
    table against the LM fit under 0.03 and the table's round trip under
    0.02 on the 32 random colours."""
    stock = torch.tensor([[0.65, 0.05, 0.05], [0.12, 0.45, 0.15], [0.73, 0.73, 0.73], [0.2, 0.3, 0.6]])
    back = rgb2spec.roundtrip_srgb(rgb2spec.srgb_to_spectrum(stock))
    assert float((back - stock).abs().max()) <= 2e-3
    x, _ = case
    rgb = torch.from_numpy(x["rgb"][:32])
    spd_tab = _spd(rgb2spec.lookup_sigmoid_coeffs(rgb))
    assert np.abs(spd_tab - _spd(rgb2spec.lm_fit_coeffs(rgb))).max() < 0.03
    assert float((rgb2spec.roundtrip_srgb(torch.from_numpy(spd_tab)) - rgb).abs().max()) < 0.02


def test_fit_sigmoid_coeffs_order(monkeypatch):
    """Memo, then the palette (every colour in it), then the table, then
    with RGB2SPEC_EXACT=1 the LM fit; grays in closed form on both."""
    rgb2spec._fit_cache.clear()
    pal_rgb, pal_co = rgb2spec._palette()
    np.testing.assert_array_equal(rgb2spec.fit_sigmoid_coeffs(pal_rgb[:3]).numpy(), pal_co[:3])
    mixed = np.concatenate([pal_rgb[:1], [[0.31, 0.42, 0.17], [0.4, 0.4, 0.4]]]).astype(np.float32)
    t = torch.from_numpy(mixed)
    np.testing.assert_array_equal(rgb2spec.fit_sigmoid_coeffs(mixed).numpy(),
                                  rgb2spec.lookup_sigmoid_coeffs(t).numpy())
    monkeypatch.setenv("RGB2SPEC_EXACT", "1")
    exact = rgb2spec.fit_sigmoid_coeffs(t).numpy()
    np.testing.assert_array_equal(exact[:2], rgb2spec.lm_fit_coeffs(t).numpy()[:2])
    np.testing.assert_array_equal(exact[2], rgb2spec._gray_coeffs(t[2:, 0]).numpy()[0])
    n = len(rgb2spec._fit_cache)
    np.testing.assert_array_equal(rgb2spec.fit_sigmoid_coeffs(t).numpy(), exact)  # from the memo
    assert len(rgb2spec._fit_cache) == n == 3


def test_scenes_take_any_colour():
    """A material and a background outside the palette build, as in the
    JAX package (models/materials.py:103, scenes.py:66)."""
    mb = MaterialBuilder()
    odd = mb.lambertian((0.31, 0.42, 0.17))
    light = mb.emissive((0.9, 0.8, 0.55), 4.0)
    soup = TriSoup()
    soup.quad((-1.0, 0.0, -1.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0), odd)
    soup.quad((-0.5, 2.0, -0.5), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0), light)
    scene = scene_from_soup(soup, mb.build(), "cpu", background=(0.2, 0.35, 0.6))
    want = rgb2spec.lookup_sigmoid_coeffs(torch.tensor([[0.31, 0.42, 0.17], [0.9, 0.8, 0.55]]))
    np.testing.assert_array_equal(scene.materials.coeffs.numpy(), want.numpy())
    assert torch.isfinite(scene.background_spd).all() and float(scene.background_spd.max()) > 0
