"""The port's XLA-style renderer against the JAX package's, on the CPU.

render/wavefront.py and what it runs (utils/prng.py, ops/spectrum.py,
ops/color.py, models/camera.py::generate_rays, ops/intersect.py's scene
half, ops/shading.py, diff/spectral_reparam.py::reparam_wavelengths),
utils/misc.py and ops/intersect.py::ray_aabb, the
estimator built on it (diff/fast.py::render_chunk_diff) and the one-device
train_step (parallel/render.py). The JAX outputs, and the draws of the JAX
renderer's key schedule that the port is handed in their place, are stored
in tests/torch_jax_refs.npz (cases xla_*); no JAX function runs here.

Tolerances: on the same draws the port traces the same paths, so images
are held to max-abs 2e-3, the JAX package's gap between its two schedulers
(tests/test_wavefront_sorted.py:70); measured: ~1e-5 (CHANGES.md). Hits:
t at rtol 3e-4, triangle and hit flag equal (tests/test_pallas.py:42-45).
Gradients: each leaf within GRAD_REL of its largest |value| (the issue's
1e-3, tightened to what the measured gaps of ~1e-6 allow), with no NaN.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch

from spectral_tpu_torch.config import parse_args
from spectral_tpu_torch.diff import render_chunk_diff
from spectral_tpu_torch.models.camera import camera_from_numpy, generate_rays
from spectral_tpu_torch.models.materials import DIELECTRIC, EMISSIVE, METALLIC, tabulate
from spectral_tpu_torch.models.scenes import CORNELL, build_scene, scene_camera, scene_from_numpy
from spectral_tpu_torch.ops.color import srgb_to_xyz
from spectral_tpu_torch.ops.cuda import render_kernel
from spectral_tpu_torch.ops.intersect import BIG, HitRecord, nearest_hit_scene, ray_aabb
from spectral_tpu_torch.ops.shading import RayState, scatter_step
from spectral_tpu_torch.ops.spectrum import hero_wavelengths, spectrum_to_xyz
from spectral_tpu_torch.parallel import train_step
from spectral_tpu_torch.render import wavefront
from spectral_tpu_torch.utils.misc import degrees_to_radians, device_clamp, random_int, random_permutation
from spectral_tpu_torch.utils.prng import fold, generator

import torch_jax_refs as refs

# one torch thread a process: the CPU test run's workers share the cores
torch.set_num_threads(1)

IMAGE_ATOL = 2e-3
HIT_RTOL = 3e-4
GRAD_REL = 1e-5
# the material leaves render_chunk_diff differentiates
DIFF_KEYS = ("coeffs", "emission_power", "fuzz", "sellmeier_b", "sellmeier_c")


class StoredDraws:
    """The JAX key schedule's draws of a stored case (refs.xla_draws), in
    render/wavefront.py::GeneratorDraws' methods."""

    def __init__(self, out: dict):
        self.d = {k[len("draws."):]: torch.from_numpy(v) for k, v in out.items() if k.startswith("draws.")}

    def camera(self, s):
        return self.d["jitter"][s], None  # the stored scenes' cameras have no defocus

    def hero(self, s):
        return self.d["hero"][s]

    def bounce(self, s, b):
        return self.d["u1"][s, b], self.d["u2"][s, b], self.d["u_refl"][s, b]


def _case(name: str):
    x = refs.CASES[name][0]()
    return x, refs.outputs(name, x)


def _scene_cam(x: dict):
    return scene_from_numpy(x["scene"], "cpu"), camera_from_numpy(x["cam"], "cpu")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def test_generator_draws_repeat_and_differ():
    """The same counters give the same draws, other counters other ones."""
    a = wavefront.GeneratorDraws(7, 64, "cpu", defocus=True)
    b = wavefront.GeneratorDraws(7, 64, "cpu", defocus=True)
    for x, y in zip(a.camera(2), b.camera(2)):
        assert torch.equal(x, y)
    for x, y in zip(a.bounce(1, 3), b.bounce(1, 3)):
        assert torch.equal(x, y)
    assert torch.equal(a.hero(0), b.hero(0))
    assert not torch.equal(a.hero(0), a.hero(1))
    assert not torch.equal(a.bounce(0, 0)[0], a.bounce(0, 1)[0])
    assert not torch.equal(a.bounce(0, 0)[0], a.bounce(1, 0)[0])
    assert not torch.equal(a.camera(0)[0], wavefront.GeneratorDraws(8, 64, "cpu").camera(0)[0])
    u1 = a.bounce(0, 0)[0]
    assert torch.allclose(torch.linalg.vector_norm(u1, dim=-1), torch.ones(64), atol=1e-6)
    assert (torch.linalg.vector_norm(a.camera(0)[1], dim=-1) <= 1.0).all()
    keys = {fold(1984, s, b) for s in range(16) for b in range(16)}
    assert len(keys) == 256 and fold(1, 2, 3) != fold(1, 3, 2)
    g1, g2 = generator(fold(5, 1), "cpu"), generator(fold(5, 1), "cpu")
    assert torch.equal(torch.rand(8, generator=g1), torch.rand(8, generator=g2))


def test_generate_rays_with_defocus_equals_jax():
    """Thin-lens rays on the JAX jitter and disk draws: bit-equal."""
    x, ref = _case("xla_camera")
    cam = camera_from_numpy(x["cam"], "cpu")
    o, d = generate_rays(cam, _t(x["px"]), _t(x["py"]), _t(ref["jitter"]), _t(ref["disk"]))
    assert cam.defocus_angle > 0 and np.ptp(ref["o"], axis=0).max() > 0.0
    np.testing.assert_array_equal(o.numpy(), ref["o"])
    np.testing.assert_array_equal(d.numpy(), ref["d"])


def test_hero_wavelengths_spectrum_to_xyz_srgb_to_xyz_equal_jax():
    x, ref = _case("xla_spectrum")
    lam = hero_wavelengths(_t(ref["u"]))
    np.testing.assert_array_equal(lam.numpy(), ref["lam"])
    assert (lam.numpy() > 830.0).sum() == 0 and (ref["lam"][:, 1:] < ref["lam"][:, :1]).any()  # wraps
    xyz = spectrum_to_xyz(lam, _t(x["power"]), _t(x["n_valid"]))
    np.testing.assert_allclose(xyz.numpy(), ref["xyz"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(srgb_to_xyz(_t(x["srgb"])).numpy(), ref["srgb_xyz"], rtol=1e-5, atol=1e-6)
    g = generator(fold(3, 0), "cpu")
    assert hero_wavelengths(g, 16).shape == (16, 7)


@pytest.mark.parametrize("name", ("cornell", "prism"))
def test_nearest_hit_scene_equals_jax(name):
    """The dense intersect kernel's plain version selects (in the XLA
    order) and gather_record rebuilds the record, against JAX's scene-level
    nearest_hit."""
    x, ref = _case("xla_hits")
    scene = scene_from_numpy(x[name], "cpu")
    rec = nearest_hit_scene(_t(x["o"]), _t(x["d"]), scene)
    r = {k[len(name) + 1:]: v for k, v in ref.items() if k.startswith(name + ".")}
    assert 0.3 < r["hit"].mean() < 1.0
    np.testing.assert_array_equal(rec.hit.numpy(), r["hit"])
    np.testing.assert_array_equal(rec.tri_index.numpy(), r["tri_index"])
    np.testing.assert_array_equal(rec.front_face.numpy(), r["front_face"])
    np.testing.assert_array_equal(rec.mat_index.numpy()[r["hit"]], r["mat_index"][r["hit"]])
    np.testing.assert_allclose(rec.t.numpy(), r["t"], rtol=HIT_RTOL)
    np.testing.assert_allclose(rec.p.numpy(), r["p"], rtol=HIT_RTOL, atol=1e-3)
    np.testing.assert_array_equal(rec.normal.numpy(), r["normal"])


def test_ray_aabb_and_device_clamp_equal_jax():
    """The slab test (infinite inverse directions among the rays), with its
    default t range and with per-ray limits, and the clamp (infinities
    among the values): bit-equal to JAX's."""
    x, ref = _case("xla_misc")
    boxes = [_t(x[k]) for k in ("o", "inv_d", "bb_min", "bb_max")]
    assert np.isinf(x["inv_d"]).any() and 0.0 < ref["aabb"].mean() < 1.0
    assert (ref["aabb"] != ref["aabb_range"]).any()
    np.testing.assert_array_equal(ray_aabb(*boxes).numpy(), ref["aabb"])
    np.testing.assert_array_equal(ray_aabb(*boxes, float(x["t_min"]), _t(x["t_max"])).numpy(), ref["aabb_range"])
    np.testing.assert_array_equal(device_clamp(_t(x["x"]), float(x["lo"]), float(x["hi"])).numpy(), ref["clamp"])


def test_misc_random_draws():
    """random_permutation is a permutation and random_int covers its
    inclusive range, each a function of its generator's seed."""
    perm = random_permutation(generator(fold(11, 0), "cpu"), 1000)
    assert torch.equal(torch.sort(perm).values, torch.arange(1000))
    assert torch.equal(perm, random_permutation(generator(fold(11, 0), "cpu"), 1000))
    assert not torch.equal(perm, random_permutation(generator(fold(11, 1), "cpu"), 1000))
    ints = random_int(generator(fold(11, 2), "cpu"), (4, 1000), 2, 5)
    assert ints.shape == (4, 1000)
    assert set(ints.unique().tolist()) == {2, 3, 4, 5}
    assert degrees_to_radians(180.0) == np.pi


def test_scatter_step_equals_jax():
    """One bounce of a hand-made batch over every material type, with
    misses, ended rays, metal absorbs and total internal reflections."""
    x, ref = _case("xla_scatter")
    scene = scene_from_numpy(x["scene"], "cpu")
    hit = _t(x["hit"])
    rec = HitRecord(t=torch.where(hit, 1.0, BIG), hit=hit, p=_t(x["p"]), normal=_t(x["normal"]),
                    front_face=_t(x["front"]), mat_index=_t(x["mat_index"]).long(),
                    tri_index=torch.where(hit, 0, -1))
    state = RayState(_t(x["o"]), _t(x["d"]), _t(x["wavelengths"]), _t(x["power"]), _t(x["n_valid"]).long(),
                     _t(x["alive"]))
    out = scatter_step(state, rec, scene.materials, scene.background_spd, _t(ref["u1"]), _t(ref["u2"]),
                       _t(ref["u_refl"]))
    # the batch holds every case the bounce tells apart
    mt = scene.materials.mat_type[rec.mat_index].numpy()
    live_hit = x["hit"] & x["alive"]
    for m in (0, METALLIC, DIELECTRIC, EMISSIVE):
        assert (live_hit & (mt == m)).any()
    assert (~x["hit"] & x["alive"]).any() and (~x["alive"]).any()
    absorbed = live_hit & (mt == METALLIC) & (ref["n_valid"] == 0)
    assert absorbed.any()
    cos = -np.sum(x["d"] / np.linalg.norm(x["d"], axis=1, keepdims=True) * x["normal"], axis=1)
    tir = live_hit & (mt == DIELECTRIC) & ~x["front"] & (np.sqrt(np.maximum(1 - cos**2, 0)) * 1.5 > 1.0)
    assert tir.any()
    np.testing.assert_array_equal(out.alive.numpy(), ref["alive"])
    np.testing.assert_array_equal(out.n_valid.numpy(), ref["n_valid"])
    np.testing.assert_array_equal(out.o.numpy(), ref["o"])
    np.testing.assert_array_equal(out.d.numpy(), ref["d"])
    np.testing.assert_allclose(out.power.numpy(), ref["power"], rtol=1e-6, atol=1e-7)


def _render(x, ref, **leaves):
    scene, cam = _scene_cam(x)
    x0, y0, w, h = (int(v) for v in x["crop"])
    glass = int(x["glass"])
    if leaves:
        mats = dataclasses.replace(scene.materials, **{k: v for k, v in leaves.items() if k != "background_spd"})
        scene = dataclasses.replace(scene, materials=tabulate(mats),
                                    background_spd=leaves.get("background_spd", scene.background_spd))
    return wavefront.render_chunk(
        scene, cam, 0, x0, y0, w, h, int(x["spp"]), int(x["bounces"]),
        reparam_glass=glass if glass >= 0 else None, draws=StoredDraws(ref),
    )


@pytest.mark.parametrize("name", ("xla_cornell", "xla_prism"))
def test_render_chunk_equals_jax(name):
    """CORNELL 16x16 (4 spp, 4 bounces) and a 32x16 PRISM crop (8 spp, 6
    bounces, reparameterized) on the JAX draws: the same paths."""
    x, ref = _case(name)
    with torch.no_grad():
        got = _render(x, ref).numpy()
    assert ref["xyz"].max() > 1.0
    assert np.abs(got - ref["xyz"]).max() <= IMAGE_ATOL


_LEAVES = {
    "xla_cornell": ("coeffs", "emission_power", "background_spd"),
    "xla_prism": ("coeffs", "emission_power", "background_spd", "sellmeier_b", "sellmeier_c"),
}
_JAX_GRAD = {"coeffs": "d_coeffs", "emission_power": "d_power", "background_spd": "d_bg",
             "sellmeier_b": "d_sell_b", "sellmeier_c": "d_sell_c"}


@pytest.mark.parametrize("name", ("xla_cornell", "xla_prism"))
def test_render_gradients_equal_jax(name):
    """d sum(xyz * cot) / d leaf through autograd (checkpointed bounces),
    against jax.grad of the JAX render: CORNELL's coefficients, emission
    powers and background; PRISM's, and its glass's Sellmeier B/C through
    the hero reparameterization."""
    x, ref = _case(name)
    scene, _ = _scene_cam(x)
    src = {**{k: getattr(scene.materials, k) for k in DIFF_KEYS}, "background_spd": scene.background_spd}
    leaves = {k: src[k].clone().requires_grad_(True) for k in _LEAVES[name]}
    out = _render(x, ref, **leaves)
    grads = torch.autograd.grad((out * _t(x["cot"])).sum(), list(leaves.values()))
    for k, g in zip(leaves, grads):
        want = ref[_JAX_GRAD[k]]
        assert torch.isfinite(g).all(), k
        scale = np.abs(want).max()
        assert scale > 0.0, k
        assert np.abs(g.numpy() - want).max() <= GRAD_REL * scale, k


def test_train_step_equals_jax():
    """One autograd SGD step on CORNELL 16x16 against JAX's train_step on
    a 1 x 1 mesh: its loss and new parameters."""
    x, ref = _case("xla_train")
    scene, cam = _scene_cam(x)
    params = {"coeffs": _t(x["coeffs"]), "emission_power": _t(x["power"])}
    new, loss = train_step(params, scene, cam, _t(x["target"]), int(x["seed"]), int(x["spp"]), int(x["bounces"]),
                           float(x["lr"]), draws=StoredDraws(ref))
    np.testing.assert_allclose(float(loss), float(ref["loss"]), rtol=1e-5)
    step = ref["coeffs"] - x["coeffs"]
    assert np.abs(step).max() > 0.0
    assert np.abs(new["coeffs"].numpy() - ref["coeffs"]).max() <= GRAD_REL * np.abs(step).max()
    np.testing.assert_allclose(new["emission_power"].numpy(), ref["power"], rtol=1e-6)


def _cornell_materials_grad(checkpointed: bool, monkeypatch):
    if not checkpointed:
        monkeypatch.setattr(wavefront, "checkpoint", lambda fn, *a, **k: fn(*a))
    scene = build_scene(CORNELL, "cpu")
    cam = scene_camera(CORNELL, 8, 8, "cpu")
    leaves = {k: getattr(scene.materials, k).clone().requires_grad_(True) for k in ("coeffs", "emission_power")}
    mats = dataclasses.replace(scene.materials, **leaves)
    out = wavefront.render_chunk(dataclasses.replace(scene, materials=tabulate(mats)), cam, 11, 0, 0, 8, 8, 2, 4)
    return out.detach(), torch.autograd.grad(out[..., 1].sum(), list(leaves.values()))


def test_checkpointed_bounces_give_the_same_gradient(monkeypatch):
    """Each bounce recomputed in the backward (torch.utils.checkpoint, its
    draws made outside) gives the un-checkpointed gradient bit for bit."""
    out_a, grads_a = _cornell_materials_grad(True, monkeypatch)
    out_b, grads_b = _cornell_materials_grad(False, monkeypatch)
    assert torch.equal(out_a, out_b)
    for a, b in zip(grads_a, grads_b):
        assert torch.equal(a, b) and a.abs().max() > 0


def test_render_chunk_diff_backward_is_the_xla_vjp():
    """render_chunk_diff: its value is the kernel render's, its gradient
    torch.autograd.grad of the XLA-style render at the same seed (as
    tests/test_diff.py::TestFastPathGradients holds the JAX pair)."""
    scene = build_scene(CORNELL, "cpu")
    cam = scene_camera(CORNELL, 8, 8, "cpu")
    seed, spp, bounces = 21, 2, 3
    leaves = {k: getattr(scene.materials, k).clone().requires_grad_(True) for k in DIFF_KEYS}
    mats = dataclasses.replace(scene.materials, **leaves)
    out = render_chunk_diff(mats, scene, cam, seed, 0, 0, 8, 8, spp, bounces)
    with torch.no_grad():
        kernel = render_kernel.render_chunk(dataclasses.replace(scene, materials=tabulate(mats)), cam, seed, 0, 0, 8,
                                            8, spp, bounces)
    assert torch.equal(out.detach(), kernel)
    cot = torch.from_numpy(np.random.default_rng(2).normal(size=(8, 8, 3)).astype(np.float32))
    got = torch.autograd.grad((out * cot).sum(), list(leaves.values()))
    xla = wavefront.render_chunk(dataclasses.replace(scene, materials=tabulate(mats)), cam, seed, 0, 0, 8, 8, spp,
                                 bounces)
    want = torch.autograd.grad((xla * cot).sum(), list(leaves.values()), allow_unused=True, materialize_grads=True)
    for k, a, b in zip(leaves, got, want):
        assert torch.equal(a, b), k
    assert got[0].abs().max() > 0


def test_impl_flag():
    assert parse_args([]).impl == "auto"
    assert parse_args(["--impl", "xla"]).impl == "xla"
    assert parse_args(["--impl", "pallas"]).impl == "kernel"
    assert parse_args(["--impl", "kernel"]).impl == "kernel"
    assert parse_args(["--impl", "nonsense"]).impl == "auto"


def test_cli_impl_xla_on_cpu(tmp_path, monkeypatch):
    """python -m spectral_tpu_torch.main --impl xla --device cpu: a BMP
    with the ceiling light lit, through the XLA-style renderer."""
    from spectral_tpu_torch import main as cli
    from spectral_tpu_torch.io.image import decode_bmp

    monkeypatch.chdir(tmp_path)
    assert cli.main(["--impl", "xla", "--device", "cpu", "-xr", "32", "-ns", "2", "-bl", "3", "-xc", "16",
                     "--save", "--no-show", "-t", "xla"]) == 0
    (bmp,) = os.listdir("renders")
    with open(os.path.join("renders", bmp), "rb") as f:
        img = decode_bmp(f.read())
    lum = img.astype(np.float64).mean(-1)
    assert img.shape == (32, 32, 3) and lum[3:6, 13:19].max() >= 250 and lum.mean() > 1


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without a GPU")
def test_xla_path_raises_without_gpu():
    from spectral_tpu_torch import main as cli

    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--impl", "xla", "-xr", "8", "-ns", "1", "-bl", "1", "--no-show"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_scene(CORNELL, "cuda")
