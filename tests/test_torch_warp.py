"""The port's warp estimators against the JAX package's, on the CPU.

diff/geometry.py (derive_tri_arrays, scene_with_vertices), diff/vertex_warp.py
(warp_pixel_samples, warp_directions), diff/fuzz_warp.py (warp_fuzz), their
hooks in the XLA-style renderer (models/camera.py's screen warp,
ops/shading.py's lambertian and fuzz warps, render/wavefront.py's guard),
the vertex leaves and warp flags of parallel/render.py, and the two warp
examples. The JAX outputs, and the JAX key schedule's draws the port is
handed in their place, are stored in tests/torch_jax_refs.npz (cases
warp_*); no JAX function runs here.

Tolerances, each measured and stated beside its test:
- derive_tri_arrays: bit-equal to JAX's (XLA's fusions, ops/fp32.py), and
  within tests/test_diff.py:45-50's rtol 2e-5 / atol 2e-2 of the host's
  float64 finalize;
- the warp functions: the primal exact where JAX's is (V == 0, the
  screen's det == 1); the sphere warps' values, which JAX's rsqrt rounds
  otherwise (ROADMAP C; the lambertian directions differ in the last bit
  on 46% of the stored rays, by at most 1.2e-7), within VALUE_ATOL (the
  factors 10x, measured 8.9e-7); each gradient leaf within GRAD_REL of its
  largest |value| (measured: screen 1.6e-5, sphere 4.0e-5), the fuzz
  warp's within FUZZ_GRAD_REL;
- the warped renders: the sample-rays that leave JAX's paths are counted
  (LEFT: none of the 1024 of each case; the cause they would have is in
  ROADMAP C) and the image held to the JAX package's between-scheduler
  max-abs of 2e-3 (tests/test_wavefront_sorted.py:70; measured 2.3e-5);
  the gradients of sum(xyz * cot) within RENDER_GRAD_REL of their largest
  |value| (measured 2.3e-5), and the warped train step's new leaves within
  it of JAX's step (measured 1.5e-6).
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from spectral_tpu_torch.diff import derive_tri_arrays, scene_with_vertices
from spectral_tpu_torch.diff.fuzz_warp import warp_fuzz
from spectral_tpu_torch.diff.vertex_warp import edges_from_vertices, warp_directions, warp_pixel_samples
from spectral_tpu_torch.examples import inverse_fuzz, inverse_geometry
from spectral_tpu_torch.models.camera import camera_from_numpy, make_camera
from spectral_tpu_torch.models.geometry import TriSoup, finalize
from spectral_tpu_torch.models.materials import MaterialBuilder
from spectral_tpu_torch.models.scenes import CORNELL, build_scene, scene_camera, scene_from_numpy, scene_from_soup
from spectral_tpu_torch.ops.bvh import build_lbvh
from spectral_tpu_torch.parallel import apply_params, train_step, trainable_params
from spectral_tpu_torch.render import wavefront

import torch_jax_refs as refs
from test_torch_xla import StoredDraws

# one torch thread a process: the CPU test run's workers share the cores
torch.set_num_threads(1)

VALUE_ATOL = 1e-6
GRAD_REL = 1e-4
# the fuzz warp's 1/fuzz^2 velocities amplify float32 rounding: gradients
# measured within 2.8e-4 (freeze point live) and 4.0e-4 (pinned) of their
# largest |value|; pinned, the samples within 1.3e-5 and the dets within
# 4.4e-5 of their scale
FUZZ_GRAD_REL = 1e-3
FROZEN_ATOL, FROZEN_DET_REL = 2e-5, 1e-4
IMAGE_ATOL = 2e-3
RENDER_GRAD_REL = 1e-4
# sample-rays of each stored render that leave JAX's path (of 1024)
LEFT = {"warp_screen": 0, "warp_shadow": 0, "warp_fuzz": 0}
_GEOM = ("v0", "v1", "v2", "normal", "d", "edge_g", "edge_c", "bbox_min", "bbox_max")


def _case(name: str):
    x = refs.CASES[name][0]()
    return x, refs.outputs(name, x)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close_rel(got: torch.Tensor, want: np.ndarray, rel: float, what: str) -> None:
    assert torch.isfinite(got).all(), what
    scale = np.abs(want).max()
    assert scale > 0.0, what
    assert np.abs(got.detach().numpy() - want).max() <= rel * scale, what


@pytest.mark.parametrize("name", ("cornell", "prism", "tris", "moved"))
def test_derive_tri_arrays_equals_jax(name):
    """Bit-equal to JAX's jitted derive_tri_arrays, and close to the port's
    float64 host finalize, on the three scenes and on CORNELL's vertices
    moved by seeded noise."""
    x, ref = _case("warp_geometry")
    vs = [_t(x[name][k]) for k in ("v0", "v1", "v2")]
    got = derive_tri_arrays(*vs)
    for k in _GEOM:
        np.testing.assert_array_equal(got[k].numpy(), ref[f"{name}.{k}"], err_msg=k)
    soup = TriSoup()
    for tri in zip(*(x[name][k] for k in ("v0", "v1", "v2"))):
        soup.tri(*tri, 0)
    host = finalize(soup)
    for k in _GEOM:
        np.testing.assert_allclose(got[k].numpy(), host[k], rtol=2e-5, atol=2e-2, err_msg=k)


def test_vertex_leaves_in_apply_params():
    """trainable_params(include_vertices=True) holds the vertices;
    apply_params with them re-derives the arrays differentiably and keeps
    the materials' leaves and an LBVH as they are."""
    scene = build_scene(CORNELL, "cpu")
    scene = dataclasses.replace(scene, bvh=build_lbvh(scene.bbox_min, scene.bbox_max, 8))
    p = trainable_params(scene, include_vertices=True)
    assert set(p) == {"coeffs", "emission_power", "fuzz", "sellmeier_b", "sellmeier_c", "v0", "v1", "v2"}
    assert "v0" not in trainable_params(scene)
    v0 = (p["v0"] + 1.0).requires_grad_(True)
    s = apply_params(scene, dict(p, v0=v0))
    assert s.bvh is scene.bvh
    want = derive_tri_arrays(v0.detach(), p["v1"], p["v2"])
    for k in _GEOM:
        assert torch.equal(getattr(s, k).detach(), want[k]), k
    (g,) = torch.autograd.grad(s.d.sum(), v0)
    assert torch.isfinite(g).all() and g.abs().max() > 0


def _funcs():
    x, ref = _case("warp_funcs")
    verts = [_t(x[k]).requires_grad_(True) for k in ("v0", "v1", "v2")]
    return x, ref, camera_from_numpy(x["cam"], "cpu"), verts, _t(x["wts"])


def test_warp_pixel_samples_equals_jax():
    """The screen warp on 512 samples over (and past) the frame: the primal
    exact (fx' == fx, fy' == fy, det == 1, as JAX's), the vertex gradients
    of a weighted sum of the outputs within GRAD_REL."""
    x, ref, cam, verts, wts = _funcs()
    fx, fy, det = warp_pixel_samples(cam, edges_from_vertices(*verts), _t(x["fx"]), _t(x["fy"]))
    for got, name in ((fx, "fx"), (fy, "fy")):
        np.testing.assert_array_equal(ref[name], x[name])
        np.testing.assert_array_equal(got.detach().numpy(), x[name])
    assert (ref["det"] == 1.0).all() and bool((det == 1.0).all())
    grads = torch.autograd.grad((fx * wts[:, 0] + fy * wts[:, 1] + det * wts[:, 2]).sum(), verts)
    for i, g in enumerate(grads):
        _close_rel(g, ref[f"screen.d_v{i}"], GRAD_REL, f"d_v{i}")


def test_warp_directions_equals_jax():
    """The lambertian sphere warp at 512 bounce origins in the box: the
    directions and factors within VALUE_ATOL (JAX's rsqrt rounds otherwise
    in the last bit), the gradients with respect to the vertices, origins
    and normals within GRAD_REL."""
    x, ref, _, verts, wts = _funcs()
    o, n = _t(x["o"]).requires_grad_(True), _t(x["n"]).requires_grad_(True)
    wp, fac = warp_directions(o, n, _t(x["w0"]), edges_from_vertices(*verts))
    assert np.abs(wp.detach().numpy() - ref["wp"]).max() <= VALUE_ATOL
    assert np.abs(fac.detach().numpy() - ref["factor"]).max() <= 10 * VALUE_ATOL
    grads = torch.autograd.grad((wp * wts[:, :3]).sum() + (fac * wts[:, 3]).sum(), [*verts, o, n])
    for k, g in zip(("v0", "v1", "v2", "o", "n"), grads):
        _close_rel(g, ref[f"sphere.d_{k}"], GRAD_REL, k)


@pytest.mark.parametrize("tag", ("fuzz", "frozen"))
def test_warp_fuzz_equals_jax(tag):
    """The fuzz-sphere warp on 512 samples, with the freeze point at the
    live fuzz (the samples and dets within VALUE_ATOL of JAX's) and pinned
    at 0.3 (frozen_fuzz, where V != 0: within FROZEN_ATOL and
    FROZEN_DET_REL), the fuzz gradient within FUZZ_GRAD_REL."""
    x, ref, _, verts, wts = _funcs()
    fuzz = _t(x["fuzz"]).requires_grad_(True)
    edges = edges_from_vertices(*(v.detach() for v in verts))
    frozen = float(x["frozen"]) if tag == "frozen" else None
    s, det = warp_fuzz(*(_t(x[k]) for k in ("s0", "o", "r", "n")), fuzz, edges, frozen_fuzz=frozen)
    s_atol, det_atol = VALUE_ATOL, 10 * VALUE_ATOL
    if frozen is not None:
        s_atol, det_atol = FROZEN_ATOL, FROZEN_DET_REL * np.abs(ref[f"{tag}.det"]).max()
        assert np.abs(ref[f"{tag}.det"] - 1.0).max() > 0.1  # the pinned warp moves the samples
    assert np.abs(s.detach().numpy() - ref[f"{tag}.s"]).max() <= s_atol
    assert np.abs(det.detach().numpy() - ref[f"{tag}.det"]).max() <= det_atol
    (g,) = torch.autograd.grad((s * wts[:, :3]).sum() + (det * wts[:, 3]).sum(), fuzz)
    _close_rel(g, ref[f"{tag}.d_fuzz"], FUZZ_GRAD_REL, "d_fuzz")


def test_corner_origins_give_finite_gradients():
    """Bounce origins on the Cornell box's corners and seams (on three and
    on one edge at once): the degenerate edges are selected out and every
    gradient is finite (vertex_warp.py:220-226)."""
    scene = build_scene(CORNELL, "cpu")
    verts = [getattr(scene, k).clone().requires_grad_(True) for k in ("v0", "v1", "v2")]
    o = torch.tensor([[0.0, 0.0, 0.0], [555.0, 0.0, 0.0], [0.0, 555.0, 555.0], [555.0, 555.0, 555.0],
                      [277.5, 0.0, 0.0], [0.0, 0.0, 277.5]], requires_grad=True)
    n = torch.tensor([[0.0, 1.0, 0.0], [0.0, 1.0, 0.0], [0.0, -1.0, 0.0], [0.0, -1.0, 0.0], [0.0, 1.0, 0.0],
                      [1.0, 0.0, 0.0]], requires_grad=True)
    w0 = torch.nn.functional.normalize(n.detach() + torch.tensor([0.3, 0.2, -0.4]), dim=-1)
    wp, fac = warp_directions(o, n, w0, edges_from_vertices(*verts))
    grads = torch.autograd.grad(wp.sum() + fac.sum(), [*verts, o, n])
    assert torch.isfinite(wp).all() and torch.isfinite(fac).all()
    for g in grads:
        assert torch.isfinite(g).all()
    assert grads[0].abs().max() > 0


class SampleDraws(StoredDraws):
    """One sample's draws of a stored case, as a one-sample render's."""

    def __init__(self, out: dict, s: int):
        super().__init__(out)
        self.s = s

    def camera(self, s):
        return super().camera(self.s)

    def hero(self, s):
        return super().hero(self.s)

    def bounce(self, s, b):
        return super().bounce(self.s, b)


def _warp_render(name, x, ref, spp=None, draws=None, leaves=None):
    """The case's warped render_chunk on the stored draws; with ``leaves``
    (the vertices, or the materials' fuzz) as those of the scene."""
    scene, cam = scene_from_numpy(x["scene"], "cpu"), camera_from_numpy(x["cam"], "cpu")
    spp = int(x["spp"]) if spp is None else spp
    vw = fw = None
    if name == "warp_fuzz":
        if leaves is not None:
            scene = dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, fuzz=leaves[0]))
        fw = edges_from_vertices(scene.v0, scene.v1, scene.v2)
    else:
        vs = leaves if leaves is not None else [scene.v0, scene.v1, scene.v2]
        scene = scene_with_vertices(scene, *vs)
        vw = edges_from_vertices(*vs)
    return wavefront.render_chunk(scene, cam, 0, 0, 0, 16, 16, spp, int(x["bounces"]), vertex_warp=vw, fuzz_warp=fw,
                                  draws=draws or StoredDraws(ref))


@pytest.mark.parametrize("name", sorted(LEFT))
def test_warped_render_equals_jax(name):
    """The screen (2 bounces), shadow (3) and fuzz (2) scenes at 16x16, 4
    spp, on the JAX draws: the sample-rays that leave JAX's paths are
    counted (LEFT), the others equal JAX's at rounding; the image within
    IMAGE_ATOL; d sum(xyz * cot) / d(vertices, or fuzz) within
    RENDER_GRAD_REL."""
    x, ref = _case(name)
    with torch.no_grad():
        per = np.stack([_warp_render(name, x, ref, 1, SampleDraws(ref, s)).reshape(256, 3).numpy()
                        for s in range(int(x["spp"]))])
        img = _warp_render(name, x, ref).numpy()
    same = np.isclose(per, ref["xyz_s"], rtol=1e-4, atol=1e-6).all(-1)
    assert (~same).sum() == LEFT[name], np.argwhere(~same)
    assert ref["xyz"].max() > 0.1
    assert np.abs(img - ref["xyz"]).max() <= IMAGE_ATOL
    scene = scene_from_numpy(x["scene"], "cpu")
    if name == "warp_fuzz":
        leaves = [scene.materials.fuzz.clone().requires_grad_(True)]
        names = ["d_fuzz"]
    else:
        leaves = [getattr(scene, k).clone().requires_grad_(True) for k in ("v0", "v1", "v2")]
        names = ["d_v0", "d_v1", "d_v2"]
    out = _warp_render(name, x, ref, leaves=leaves)
    grads = torch.autograd.grad((out * _t(x["cot"])).sum(), leaves)
    for k, g in zip(names, grads):
        _close_rel(g, ref[k], RENDER_GRAD_REL, k)


def _step_close(got: torch.Tensor, want: np.ndarray, start: np.ndarray, what: str) -> None:
    step = np.abs(want - start).max()
    if step == 0.0:
        np.testing.assert_array_equal(got.numpy(), want, err_msg=what)
    else:
        assert np.abs(got.numpy() - want).max() <= RENDER_GRAD_REL * step, what


def test_warped_train_step_equals_jax():
    """One train_step(vertex_warp=True) on the shadow scene with every leaf
    of trainable_params(include_vertices=True), the occluder moved, against
    JAX's on a 1 x 1 mesh: the loss, and each new leaf within
    RENDER_GRAD_REL of the step JAX took (equal where it took none)."""
    x, ref = _case("warp_train")
    scene, cam = scene_from_numpy(x["scene"], "cpu"), camera_from_numpy(x["cam"], "cpu")
    params = dict(trainable_params(scene, include_vertices=True), **{k: _t(x[k]) for k in ("v0", "v1", "v2")})
    start = {k: v.numpy().copy() for k, v in params.items()}
    new, loss = train_step(params, scene, cam, _t(x["target"]), int(x["seed"]), int(x["spp"]), int(x["bounces"]),
                           float(x["lr"]), vertex_warp=True, draws=StoredDraws(ref))
    np.testing.assert_allclose(float(loss), float(ref["loss"]), rtol=1e-5)
    assert np.abs(ref["new.v0"] - x["v0"]).max() > 0.0
    for k, v in new.items():
        _step_close(v, ref[f"new.{k}"], start[k], k)


# ---- the port's own checks -------------------------------------------------


def _screen_scene():
    """tests/test_diff.py:739's screen scene, built by the port."""
    mb = MaterialBuilder()
    dark = mb.lambertian((0.1, 0.1, 0.1))
    light = mb.emissive((1.0, 1.0, 1.0), 4.0)
    soup = TriSoup()
    soup.quad((-4.0, -4.0, 3.0), (8.0, 0.0, 0.0), (0.0, 8.0, 0.0), light)
    soup.quad((-3.0, -2.0, 1.0), (3.0, 0.0, 0.0), (0.0, 4.0, 0.0), dark)
    cam = make_camera(16, 16, vfov=60.0, lookfrom=(0, 0, -2), lookat=(0, 0, 0), device="cpu")
    return scene_from_soup(soup, mb.build(), "cpu"), cam


@pytest.mark.parametrize("name", sorted(LEFT))
def test_port_builds_the_warp_scenes(name):
    """The port's TriSoup and MaterialBuilder (the examples' builds) give
    the JAX package's warp scenes array for array."""
    x = refs.CASES[name][0]()
    scene, cam = {"warp_screen": _screen_scene, "warp_shadow": lambda: inverse_geometry.build("cpu"),
                  "warp_fuzz": lambda: inverse_fuzz.build("cpu")[:2]}[name]()
    want = scene_from_numpy(x["scene"], "cpu")
    for k in (*_GEOM, "mat_index", "background_spd"):
        assert torch.equal(getattr(scene, k), getattr(want, k)), k
    for f in dataclasses.fields(want.materials):
        assert torch.equal(getattr(scene.materials, f.name), getattr(want.materials, f.name)), f.name
    wc = camera_from_numpy(x["cam"], "cpu")
    for k in ("center", "pixel00_loc", "pixel_delta_u", "pixel_delta_v"):
        assert torch.equal(getattr(cam, k), getattr(wc, k)), k


def test_primal_identities():
    """tests/test_diff.py:793-808: the warped Cornell render (16x16, 2 spp,
    3 bounces) equals the plain one within 2e-5. The fuzz scene's image
    (test_diff.py:1029-1037) with and without the warp, within the same
    2e-5 (measured 3.8e-6): the fuzz det is 1 up to float32 rounding, in
    JAX too, whose weighted loss is equal at PRNGKey(0) and differs at
    PRNGKey(1) and (2), by up to 1.9e-5 in a pixel's XYZ sum."""
    scene = build_scene(CORNELL, "cpu")
    cam = scene_camera(CORNELL, 16, 16, "cpu")
    edges = edges_from_vertices(scene.v0, scene.v1, scene.v2)
    with torch.no_grad():
        base = wavefront.render_chunk(scene, cam, 11, 0, 0, 16, 16, 2, 3)
        warped = wavefront.render_chunk(scene, cam, 11, 0, 0, 16, 16, 2, 3, vertex_warp=edges)
    assert float(base.max()) > 1.0 and float((base - warped).abs().max()) < 2e-5
    prob = inverse_fuzz.Problem("cpu")
    with torch.no_grad():
        f0 = torch.tensor(0.25)
        plain, warped = prob.render(f0, 0, False), prob.render(f0, 0, True)
    assert float(plain.max()) > 1.0 and float((plain - warped).abs().max()) < 2e-5


def _grad(y: torch.Tensor, x: torch.Tensor) -> float:
    """d y / d x, 0 where y does not depend on x (as jax.grad gives it)."""
    if not y.requires_grad:
        return 0.0
    return float(torch.autograd.grad(y, x, allow_unused=True, materialize_grads=True)[0])


def test_plain_estimator_gradients_are_zero():
    """Without the warps, the screen scene's vertex gradient and the fuzz
    scene's fuzz gradient are exactly 0 (test_diff.py:843-849, :1037)."""
    scene, cam = _screen_scene()
    th = torch.tensor(0.0, requires_grad=True)
    move = (torch.arange(scene.num_tris) >= 2).to(torch.float32)[:, None] * torch.tensor([1.0, 0.0, 0.0])
    s = scene_with_vertices(scene, scene.v0 + th * move, scene.v1 + th * move, scene.v2 + th * move)
    out = wavefront.render_chunk(s, cam, 0, 0, 0, 16, 16, 4, 2)
    assert float(out[..., 1].sum()) > 0 and _grad(out[..., 1].sum(), th) == 0.0
    prob = inverse_fuzz.Problem("cpu")
    f = torch.tensor(0.25, requires_grad=True)
    assert _grad(prob.render(f, 0, False)[:, 1].sum(), f) == 0.0


def _shadow_grad(checkpointed: bool, monkeypatch):
    if not checkpointed:
        monkeypatch.setattr(wavefront, "checkpoint", lambda fn, *a, **k: fn(*a))
    prob = inverse_geometry.Problem("cpu")
    th = torch.tensor(0.1, requires_grad=True)
    out = prob.render(th, 7, True)
    return out.detach(), torch.autograd.grad(out[:, 1].sum(), th)[0]


def test_checkpointed_warp_gives_the_same_gradient(monkeypatch):
    """The warped bounce recomputed in the backward (torch.utils.checkpoint,
    the draws and the EdgeSet its inputs) gives the un-checkpointed
    gradient: the double backward through the nested autograd passes
    composes with the recompute."""
    out_a, g_a = _shadow_grad(True, monkeypatch)
    out_b, g_b = _shadow_grad(False, monkeypatch)
    assert torch.equal(out_a, out_b)
    assert torch.equal(g_a, g_b) and float(g_a) != 0.0


def test_specular_guard():
    """The mirror scene of test_diff.py:930 (built by the JAX package, its
    sky outside the palette) warns under vertex_warp; CORNELL is silent."""
    mirror, cam, _ = refs.warp_scene_jax("mirror")
    scene = scene_from_numpy(refs.jax_arrays(mirror), "cpu")
    cam = camera_from_numpy(refs.jax_camera_arrays(cam), "cpu")
    with torch.no_grad(), pytest.warns(UserWarning, match="specular"):
        wavefront.render_chunk(scene, cam, 2, 0, 0, 16, 16, 2, 3,
                               vertex_warp=edges_from_vertices(scene.v0, scene.v1, scene.v2))
    cornell = build_scene(CORNELL, "cpu")
    with torch.no_grad(), warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        wavefront.render_chunk(cornell, scene_camera(CORNELL, 16, 16, "cpu"), 2, 0, 0, 16, 16, 2, 3,
                               vertex_warp=edges_from_vertices(cornell.v0, cornell.v1, cornell.v2))
    assert not [w for w in rec if "specular" in str(w.message)]


@pytest.mark.parametrize("example", (inverse_geometry, inverse_fuzz), ids=("geometry", "fuzz"))
def test_example_gradient_on_cpu(example):
    """One MSE gradient of each example at its shape (16x16, 8 spp) on the
    CPU: finite and nonzero."""
    start = inverse_geometry.START if example is inverse_geometry else inverse_fuzz.F_START
    loss, g = example.Problem("cpu").one_grad(start, 1, 2)
    assert np.isfinite(loss) and loss > 0.0 and np.isfinite(g) and g != 0.0


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without a GPU")
def test_examples_raise_without_gpu():
    for example in (inverse_geometry, inverse_fuzz):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            example.main(steps=1)
