"""The port's scene build against the JAX package's (spectral_tpu_torch vs
spectral_tpu), on the CPU.

Constants, CIE tables, palette coefficients, scene arrays, packs and the
camera vector must equal the JAX values: exactly for integers and tables
copied verbatim, within float32 rounding (rtol 1e-6) for values either
side computes in float32 in its own library. Also: the port imports no
JAX and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spectral_tpu.utils.constants as jc
import spectral_tpu_torch.utils.constants as tc
from spectral_tpu.config import parse_args as jax_parse_args
from spectral_tpu.io.image import encode_bmp_py as jax_encode_bmp
from spectral_tpu.models import scenes as jscenes
from spectral_tpu.ops import rgb2spec as jrgb2spec
from spectral_tpu.ops.color import xyz_to_srgb as jax_xyz_to_srgb
from spectral_tpu.ops.pallas.render_kernel import camera_vector as jax_camera_vector
from spectral_tpu.ops.pallas.render_kernel import pack_scene as jax_pack_scene
from spectral_tpu.ops.spectrum import spectrum_interp_shared as jax_interp
from spectral_tpu.render.wavefront import xyz_to_image as jax_xyz_to_image
from spectral_tpu_torch.config import parse_args
from spectral_tpu_torch.io.image import decode_bmp, encode_bmp
from spectral_tpu_torch.models import scenes as tscenes
from spectral_tpu_torch.models.camera import camera_from_numpy, camera_vector
from spectral_tpu_torch.ops import rgb2spec as trgb2spec
from spectral_tpu_torch.ops.color import xyz_to_srgb
from spectral_tpu_torch.ops.cuda.render_kernel import pack_scene
from spectral_tpu_torch.ops.spectrum import spectrum_interp_shared
from spectral_tpu_torch.render.wavefront import xyz_to_image

# one torch thread a process: the CPU test run's workers share the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "spectral_tpu_torch")
SCENES = (jscenes.CORNELL, jscenes.PRISM, jscenes.TRIS)
RTOL = 1e-6  # float32 rounding of values both sides compute in float32


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


TABLES = (
    "cie_x", "cie_y", "cie_z", "cie_xyz", "cie_d65", "cie_d65_normalized",
    "d65_srgb_to_xyz", "d65_xyz_to_srgb", "d50_srgb_to_xyz", "d50_xyz_to_srgb",
)
SCALARS = (
    "N_CIE_SAMPLES", "CIE_CURVE_RES", "CIE_Y_INTEGRAL", "LAMBDA_MIN",
    "LAMBDA_MAX", "N_RAY_WAVELENGTHS", "EPSILON",
)


@pytest.mark.parametrize("name", TABLES)
def test_constant_tables_equal(name):
    a, b = _np(getattr(tc, name)), _np(getattr(jc, name))
    assert a.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", SCALARS)
def test_scalar_constants_equal(name):
    assert getattr(tc, name) == getattr(jc, name)


@pytest.mark.parametrize("glass", sorted(jc.sellmeier_presets))
def test_sellmeier_presets_equal(glass):
    for a, b in zip(tc.sellmeier_presets[glass], jc.sellmeier_presets[glass]):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_constants_to_device():
    t = tc.to(tc.cie_x, "cpu")
    assert t.dtype == torch.float32 and t.shape == (95,)
    np.testing.assert_array_equal(t.numpy(), _np(jc.cie_x))


def test_palette_coeffs_equal_jax_fit():
    """Every palette row resolves to the coefficients the JAX package's
    fit_sigmoid_coeffs returns for it (its memo/palette path)."""
    rgb, _ = trgb2spec._palette()
    ours = trgb2spec.fit_sigmoid_coeffs(torch.from_numpy(rgb)).numpy()
    theirs = _np(jrgb2spec.fit_sigmoid_coeffs(jnp.asarray(rgb)))
    np.testing.assert_array_equal(ours, theirs)


def test_gray_closed_form_equals_jax():
    r = np.array([0.0, 0.05, 0.33, 0.5, 0.61, 0.999, 1.0], np.float32)
    ours = trgb2spec._gray_coeffs(torch.from_numpy(r)).numpy()
    theirs = _np(jrgb2spec._gray_coeffs(jnp.asarray(r)))
    np.testing.assert_allclose(ours, theirs, rtol=RTOL, atol=0)
    # a gray batch outside the palette takes the closed form
    grays = np.stack([r, r, r], axis=1)[[1, 2, 4]]
    np.testing.assert_allclose(
        trgb2spec.fit_sigmoid_coeffs(grays).numpy(), ours[[1, 2, 4]], rtol=RTOL
    )


def test_colour_outside_palette_raises():
    """A colour outside the palette no longer raises: it resolves, as in the
    JAX package, through the general-colour table (memo, palette, table);
    what still raises is a batch that is not of colours."""
    rgb = np.array([[0.31, 0.42, 0.17], [0.65, 0.05, 0.05]], np.float32)
    ours = trgb2spec.fit_sigmoid_coeffs(rgb).numpy()
    jrgb2spec._fit_cache.clear()
    theirs = _np(jrgb2spec.fit_sigmoid_coeffs(jnp.asarray(rgb)))
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        trgb2spec.fit_sigmoid_coeffs(np.array([0.31, 0.42], np.float32))


def test_spectrum_interp_and_sigmoid_equal_jax():
    rng = np.random.default_rng(5)
    lam = rng.uniform(340.0, 850.0, 257).astype(np.float32)
    spd = rng.uniform(0.0, 2.0, 95).astype(np.float32)
    ours = spectrum_interp_shared(torch.from_numpy(spd), torch.from_numpy(lam)).numpy()
    theirs = _np(jax_interp(jnp.asarray(spd), jnp.asarray(lam)))
    np.testing.assert_allclose(ours, theirs, rtol=RTOL, atol=1e-7)
    coeffs = rng.normal(0.0, 1e-3, (4, 3)).astype(np.float32) * [1e-1, 1e1, 1e4]
    coeffs = coeffs.astype(np.float32)
    ours = trgb2spec.eval_sigmoid_poly(torch.from_numpy(coeffs)[:, None, :], torch.from_numpy(lam)).numpy()
    theirs = _np(jrgb2spec.eval_sigmoid_poly(jnp.asarray(coeffs)[:, None, :], jnp.asarray(lam)))
    np.testing.assert_allclose(ours, theirs, rtol=RTOL, atol=1e-7)


def _jax_scene_dict(s) -> dict:
    d = {f.name: np.asarray(getattr(s, f.name)) for f in dataclasses.fields(s)
         if f.name not in ("materials", "bvh")}
    d["materials"] = {f.name: np.asarray(getattr(s.materials, f.name))
                      for f in dataclasses.fields(s.materials)}
    return d


def _assert_scene_equal(port, ref: dict):
    for k, v in ref.items():
        if k == "materials":
            continue
        got = _np(getattr(port, k))
        assert got.shape == v.shape, k
        if np.issubdtype(v.dtype, np.integer):
            np.testing.assert_array_equal(got, v, err_msg=k)
        else:
            np.testing.assert_allclose(got, v, rtol=RTOL, atol=1e-6, err_msg=k)
    for k, v in ref["materials"].items():
        got = _np(getattr(port.materials, k))
        assert got.shape == v.shape, k
        if np.issubdtype(v.dtype, np.integer):
            np.testing.assert_array_equal(got, v, err_msg=k)
        else:
            np.testing.assert_allclose(got, v, rtol=RTOL, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("scene_id", SCENES)
def test_scene_arrays_equal_jax(scene_id):
    port = tscenes.build_scene(scene_id, "cpu")
    _assert_scene_equal(port, _jax_scene_dict(jscenes.build_scene(scene_id)))
    n_tris, n_mats = tscenes.expected_sizes(scene_id)
    assert port.num_tris == n_tris
    assert port.materials.mat_type.shape[0] == n_mats
    assert port.mat_index.dtype == torch.int32
    assert port.materials.mat_type.dtype == torch.int32


@pytest.mark.parametrize("scene_id", SCENES)
def test_scene_from_numpy_carries_jax_scene(scene_id):
    ref = _jax_scene_dict(jscenes.build_scene(scene_id))
    carried = tscenes.scene_from_numpy(ref, "cpu")
    own = tscenes.build_scene(scene_id, "cpu")
    _assert_scene_equal(carried, ref)
    for f in ("normal", "d", "edge_g", "edge_c", "mat_index"):
        np.testing.assert_allclose(_np(getattr(carried, f)), _np(getattr(own, f)), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(_np(carried.materials.spd), _np(own.materials.spd), rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("scene_id", SCENES)
def test_pack_scene_equals_jax(scene_id):
    tri, mat, tab = pack_scene(tscenes.build_scene(scene_id, "cpu"))
    jtri, jmat, jtab = (np.asarray(x) for x in jax_pack_scene(jscenes.build_scene(scene_id)))
    np.testing.assert_allclose(tri.numpy(), jtri, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(mat.numpy(), jmat, rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(tab.numpy(), jtab[:5, :95], rtol=RTOL, atol=1e-7)
    np.testing.assert_array_equal(tri[:, 16].numpy(), jtri[:, 16])


@pytest.mark.parametrize("size", [(24, 24), (600, 600), (64, 48), (1920, 1080)])
def test_camera_vector_equals_jax(size):
    w, h = size
    ours = camera_vector(tscenes.scene_camera(0, w, h, "cpu")).numpy()
    jcam = jscenes.scene_camera(0, w, h)
    theirs = np.asarray(jax_camera_vector(jcam))
    assert ours.shape == (20,) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, rtol=RTOL, atol=1e-6)
    carried = camera_from_numpy(
        {f.name: np.asarray(getattr(jcam, f.name)) for f in dataclasses.fields(jcam)}, "cpu"
    )
    np.testing.assert_array_equal(camera_vector(carried).numpy(), theirs)


def test_xyz_to_image_equals_jax():
    rng = np.random.default_rng(11)
    xyz = (rng.exponential(3.0, (16, 16, 3)) * (rng.uniform(size=(16, 16, 1)) > 0.2)).astype(np.float32)
    ours = xyz_to_image(torch.from_numpy(xyz), 4).numpy()
    theirs = np.asarray(jax_xyz_to_image(jnp.asarray(xyz), 4))
    assert ours.dtype == np.uint8
    # one 8-bit step where the two libraries round pow() differently
    assert np.abs(ours.astype(int) - theirs.astype(int)).max() <= 1
    assert (ours != theirs).mean() < 0.01
    np.testing.assert_allclose(
        xyz_to_srgb(torch.from_numpy(xyz / 4)).numpy(), np.asarray(jax_xyz_to_srgb(jnp.asarray(xyz / 4))),
        rtol=1e-5, atol=1e-6,
    )


def test_bmp_bytes_equal_jax_and_decode():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (7, 5, 3), dtype=np.uint8)  # odd width: row padding
    data = encode_bmp(img)
    assert data == jax_encode_bmp(img)
    np.testing.assert_array_equal(decode_bmp(data), img)


@pytest.mark.parametrize(
    "argv",
    [
        [],
        ["-s", "1", "-xr", "64", "-ns", "4", "-bl", "3", "--save", "--no-show"],
        ["-xr", "abc", "-ar", "1.5", "-xc", "32", "--do-log", "-t", "x"],
        ["-s", "9", "-yc", "16", "-lsub", "sub", "--bogus"],
    ],
)
def test_config_matches_jax(argv):
    ours, theirs = parse_args(argv), jax_parse_args(argv)
    for f in ("title", "log_subdir", "scene", "xres", "aspect_ratio", "xcsize", "ycsize",
              "nsamples", "bounce_limit", "do_log", "show", "save", "yres",
              "chunk_width", "chunk_height"):
        assert getattr(ours, f) == getattr(theirs, f), f
    assert ours.device == "cuda"


def test_config_device_flag():
    assert parse_args(["--device", "cpu"]).device == "cpu"
    assert parse_args(["--device", "tpu"]).device == "cuda"  # malformed: default kept
    assert parse_args(["--profile", "prof"]).profile_dir == "prof"


def test_port_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; "
        "import spectral_tpu_torch.main, spectral_tpu_torch.runtime.render_manager; "
        "import spectral_tpu_torch.ops.cuda.intersect_kernel, spectral_tpu_torch.ops.cuda.grad_kernel; "
        "import spectral_tpu_torch.diff, spectral_tpu_torch.parallel; "
        "import spectral_tpu_torch.parallel.mesh, spectral_tpu_torch.parallel.distributed; "
        "import spectral_tpu_torch.parallel.render, spectral_tpu_torch.examples.inverse_rendering; "
        "import spectral_tpu_torch.examples.inverse_field, spectral_tpu_torch.examples.inverse_dispersion; "
        "assert not any(m == 'spectral_tpu' or m.startswith('spectral_tpu.') for m in sys.modules); "
        "print('ok')"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_reference_no_jax():
    bad = re.compile(r"^\s*(import\s+jax|from\s+jax)\b|\bspectral_tpu\.(?!_)|^\s*(import|from)\s+spectral_tpu\b(?!_)", re.M)
    files = [os.path.join(d, f) for d, _, fs in os.walk(PORT) for f in fs
             if f.endswith((".py", ".cu", ".cuh"))]
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(files) > 20
    for path in files:
        with open(path) as fh:
            text = fh.read()
        assert not bad.search(text), path
        assert "spectral_tpu/data" not in text, path
