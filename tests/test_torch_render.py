"""The port's slice as a whole against the JAX package, on the CPU.

(a) The plain megakernel on the uniform planes of the committed golden
    must reproduce tests/goldens/cornell_pallas_24px.npy (the JAX
    megakernel in interpret mode, 24x24, 4 spp, 3 bounces).
(b) PRISM 16x16, 8 spp, 5 bounces on numpy planes through the JAX kernel
    in interpret mode (its output stored in tests/torch_jax_refs.npz) and
    through the port: the dielectric and the hero collapse.
Tolerance for both: |a - b| <= 2e-3 + 1e-5 |b| per value and mean abs
<= 2e-5. The absolute part is the JAX package's own cross-scheduler
tolerance (tests/test_wavefront_sorted.py:70-71); the relative part covers
float32 rounding of sums that peak at ~110. Both sides take the same path
for every sample, so a larger difference is a discrete flip: a bug. (The
port mirrors where XLA's CPU backend fuses multiply-adds, ops/fp32.py,
held bit for bit by tests/test_torch_fp32.py; with every product rounded
on its own, PRISM's refracted rays flip at their entry face and (b)
fails.)
(b') One PRISM sample-ray of a 32x32, 16 spp, 6 bounce frame (stored as
    case prism_flip): its scattered direction's last bit decides whether
    it finds the light. With ops/fp32.py's sin and cos (the C library's,
    as XLA's CPU backend computes them) the port follows the JAX path;
    with torch's own CPU sin and cos (1 ulp off on ~5% of [0, 2 pi)) the
    same draws miss the light (ROADMAP C5).
(c) The CLI writes a decodable BMP whose ceiling light is bright.
(d) --device cuda without a GPU raises instead of running on the CPU.
"""

from __future__ import annotations

import ctypes
import glob
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectral_tpu.ops.pallas.render_kernel import n_uniforms as jax_n_uniforms
from spectral_tpu_torch import main as port_main
from spectral_tpu_torch.config import RenderParams
from spectral_tpu_torch.io.image import decode_bmp
from spectral_tpu_torch.models.camera import camera_vector
from spectral_tpu_torch.models.scenes import CORNELL, PRISM, TRIS, build_scene, scene_camera
from spectral_tpu_torch.ops.cuda import build
from spectral_tpu_torch.ops.cuda.render_kernel import (
    hash_uniforms,
    n_uniforms,
    pack_scene,
    pixel_keys,
    render_chunk,
    render_rays,
    render_rays_reference,
    scene_pack,
)
from spectral_tpu_torch.runtime.render_manager import RenderManager, chunk_seed

import torch_jax_refs as refs

# one torch thread a process: the CPU test run's workers share the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "cornell_pallas_24px.npy")


def assert_render_close(got: np.ndarray, ref: np.ndarray):
    err = np.abs(got - ref)
    bad = err > 2e-3 + 1e-5 * np.abs(ref)
    assert not bad.any(), (
        f"{bad.sum()} values off, max abs {err.max()} at {np.unravel_index(err.argmax(), err.shape)}"
    )
    assert err.mean() <= 2e-5, err.mean()


def test_n_uniforms_equals_jax():
    for b in (1, 3, 10):
        assert n_uniforms(b) == jax_n_uniforms(b)


def test_golden_cornell_24px():
    """(a): the golden's planes are PRNGKey(42) uniforms over the padded
    1024-ray tile, of which the 576 pixels use the first columns."""
    planes = np.asarray(
        jax.random.uniform(jax.random.PRNGKey(42), (4, n_uniforms(3), 1024), jnp.float32)
    )[:, :, :576]
    scene = build_scene(CORNELL, "cpu")
    cam = scene_camera(CORNELL, 24, 24, "cpu")
    img = render_chunk(scene, cam, 9, 0, 0, 24, 24, 4, 3, rand=torch.from_numpy(planes.copy()))
    golden = np.load(GOLDEN)
    assert img.shape == golden.shape == (24, 24, 3)
    assert (golden.sum(-1) > 0).sum() == 16  # the sparse golden: see (b)
    assert_render_close(img.numpy(), golden)


def test_prism_equals_pallas_interpret():
    """(b): the JAX render is render_rays_pallas in interpret mode, stored
    in tests/torch_jax_refs.npz (case prism_render) for these inputs."""
    x = refs.prism_render_inputs()
    ref = refs.outputs("prism_render", x)["xyz"]
    w, h, spp, bounces = (int(x[k]) for k in ("w", "h", "spp", "bounces"))
    n = w * h
    rand = x["rand"]
    got = render_chunk(
        build_scene(PRISM, "cpu"), scene_camera(PRISM, w, h, "cpu"), 0, 0, 0, w, h, spp, bounces,
        rand=torch.from_numpy(rand[:, :, :n].copy()),
    ).reshape(n, 3).numpy()
    assert (ref.sum(-1) > 0).sum() >= 20  # not a vacuous comparison
    assert_render_close(got, ref)


def test_prism_path_follows_xla_sin_and_cos(monkeypatch):
    """(b'): the path of one sample-ray hangs on the last bit of a sin or a
    cos."""
    from spectral_tpu_torch.ops.cuda import render_kernel

    x = refs.prism_flip_inputs()
    ref = refs.outputs("prism_flip", x)["xyz"]
    w, h, bounces = int(x["w"]), int(x["h"]), int(x["bounces"])
    pack = scene_pack(*pack_scene(build_scene(PRISM, "cpu")))
    args = (
        camera_vector(scene_camera(PRISM, w, h, "cpu")), 0, pack, torch.from_numpy(x["px"][:1].copy()),
        torch.from_numpy(x["py"][:1].copy()), 1, bounces, w, torch.from_numpy(x["rand"][:, :, :1].copy()),
    )
    assert ref[0, 2] > 1.0  # the JAX path reaches the light
    assert_render_close(render_rays_reference(*args).numpy(), ref)
    monkeypatch.setattr(render_kernel, "sin", torch.sin)
    monkeypatch.setattr(render_kernel, "cos", torch.cos)
    assert np.abs(render_rays_reference(*args).numpy() - ref).max() > 1.0


def _c_params(source: str, entry: str) -> list[str]:
    """The parameters of a C entry point of a csrc/ source, its macros
    expanded."""
    text = (build.CSRC / source).read_text()
    sig = re.search(rf'extern "C" int {entry}\((.*?)\)\s*{{', text, re.S).group(1)
    for name, body in re.findall(r"#define (\w+)\s+((?:.*\\\n)*.*)", text):
        sig = sig.replace(name, body.replace("\\\n", " "))
    return [p.strip() for p in sig.split(",")]


@pytest.mark.parametrize("name", sorted(build.KERNELS))
def test_entry_point_argtypes_match_the_source(name):
    """Each kernel's ctypes argument types (the stream last) are its C entry
    point's parameters: past the end of the list, ctypes passes a pointer
    as a 32-bit int."""
    k = build.KERNELS[name]
    params = _c_params(k.source.name, k.entry)
    want = [ctypes.c_void_p if "*" in p else ctypes.c_uint32 if p.startswith("uint32_t") else ctypes.c_int
            for p in params]
    assert list(k.argtypes) == want, params


def test_render_rays_checks_inputs():
    scene = build_scene(CORNELL, "cpu")
    tri, mat, tab = pack_scene(scene)
    cam = camera_vector(scene_camera(CORNELL, 4, 4, "cpu"))
    px = torch.zeros(16)
    with pytest.raises(ValueError):
        render_rays(cam, 0, scene_pack(tri, mat, tab), px, px, 2, 3, 4, rand=torch.zeros(2, 10, 16))
    with pytest.raises(ValueError, match="pack_scene_leaves"):
        scene_pack(torch.zeros(129, 17), mat, tab)


def _hash32_py(x: int) -> int:
    m = 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & m
    x ^= x >> 15
    x = (x * 0x846CA68B) & m
    return x ^ (x >> 16)


def test_hash_uniforms_match_uint32_arithmetic():
    """The int64 emulation equals plain unsigned 32-bit arithmetic (the
    CUDA source's), including wrapping products and sums."""
    px = torch.tensor([0.0, 599.0, 17.0, 1919.0])
    py = torch.tensor([0.0, 599.0, 3.0, 1079.0])
    seed, width, n_draws = chunk_seed(64, 32, 1920), 1920, n_uniforms(10)
    keys = pixel_keys(seed, px, py, width)
    for s in (0, 1, 499):
        u = hash_uniforms(keys, s, n_draws)
        assert u.shape == (n_draws, 4) and u.dtype == torch.float32
        for r in range(4):
            kp = _hash32_py(seed ^ _hash32_py(int(py[r]) * width + int(px[r])))
            ks = _hash32_py((kp + s * 0x85EBCA6B) & 0xFFFFFFFF)
            for j in range(n_draws):
                h = _hash32_py((ks + j * 0x9E3779B9) & 0xFFFFFFFF)
                assert u[j, r].item() == (h >> 8) / 16777216.0


def test_hash_uniforms_statistics():
    keys = pixel_keys(1984, torch.arange(4096.0) % 64, torch.arange(4096.0) // 64, 64)
    u = torch.stack([hash_uniforms(keys, s, 8) for s in range(4)])
    assert 0.0 <= u.min().item() and u.max().item() < 1.0
    assert abs(u.mean().item() - 0.5) < 0.005  # 131k draws: 6 sigma
    assert abs(u.var().item() - 1.0 / 12.0) < 0.002
    # neighbouring pixels, samples and draws are uncorrelated
    for a, b in ((u[0, 0, :-1], u[0, 0, 1:]), (u[0, 0], u[1, 0]), (u[0, 0], u[0, 1])):
        assert abs(torch.corrcoef(torch.stack([a, b]))[0, 1].item()) < 0.05


@pytest.mark.parametrize("scene_id", (CORNELL, PRISM, TRIS))
def test_production_render_is_deterministic_and_finite(scene_id):
    scene = build_scene(scene_id, "cpu")
    cam = scene_camera(scene_id, 16, 16, "cpu")
    a = render_chunk(scene, cam, 77, 0, 0, 16, 16, 4, 4)
    b = render_chunk(scene, cam, 77, 0, 0, 16, 16, 4, 4)
    c = render_chunk(scene, cam, 78, 0, 0, 16, 16, 4, 4)
    assert torch.isfinite(a).all() and (a >= 0).all() and a.sum() > 0
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_live_steps_count():
    scene = build_scene(CORNELL, "cpu")
    pack = scene_pack(*pack_scene(scene))
    cam = camera_vector(scene_camera(CORNELL, 8, 8, "cpu"))
    px = (torch.arange(64) % 8).float()
    py = (torch.arange(64) // 8).float()
    steps = torch.zeros(64, dtype=torch.int32)
    render_rays_reference(cam, 5, pack, px, py, 3, 4, 8, steps=steps)
    assert (steps >= 3).all() and (steps <= 12).all()  # >= 1 bounce per sample


def test_warp_steps_needs_the_dense_cuda_kernel():
    """warp_steps counts the CUDA kernel's sweeps: the plain version has no
    such output, so CPU tensors, a leaf pack or a wrong shape raise."""
    scene = build_scene(TRIS, "cpu")
    tri, mat, tab = pack_scene(scene)
    pack = scene_pack(tri, mat, tab)
    w, h = 40, 25
    cam = camera_vector(scene_camera(TRIS, w, h, "cpu"))
    px = (torch.arange(w * h) % w).float()
    py = (torch.arange(w * h) // w).float()
    warps = torch.zeros(32, dtype=torch.int32)  # ceil(1000 / 32)
    with pytest.raises(ValueError, match="CUDA"):
        render_rays(cam, 5, pack, px, py, 2, 4, w, warp_steps=warps)
    with pytest.raises(ValueError, match=r"int32 \[32\]"):
        render_rays(cam, 5, pack, px, py, 2, 4, w, warp_steps=torch.zeros(31, dtype=torch.int32))
    with pytest.raises(ValueError, match="leaf pack"):
        render_rays(cam, 5, scene_pack(torch.zeros(8, 18), mat, tab, torch.zeros(1, 8)), px, py, 2, 4, w,
                    warp_steps=warps)


def test_render_manager_chunks_and_resume(tmp_path):
    scene = build_scene(CORNELL, "cpu")
    cam = scene_camera(CORNELL, 20, 20, "cpu")
    p = RenderParams(xres=20, nsamples=2, bounce_limit=3, xcsize=8, device="cpu")
    rm = RenderManager(scene, cam, p)
    assert list(rm.chunks())[-1] == (16, 16, 4, 4)
    full = rm.render()
    assert full.shape == (20, 20, 3) and full.dtype == np.uint8
    ckpt = str(tmp_path / "ckpt.npz")
    seen = []
    resumed = RenderManager(scene, cam, p)
    resumed.render(on_chunk=lambda c, fb: seen.append((c.x0, c.y0)), checkpoint=ckpt)
    again = RenderManager(scene, cam, p).render(on_chunk=lambda c, fb: seen.append("x"), checkpoint=ckpt)
    assert len(seen) == 9 and "x" not in seen  # the second run found every chunk done
    np.testing.assert_array_equal(again, full)


@pytest.mark.parametrize("scene_id", (CORNELL, PRISM, TRIS))
def test_cli_writes_bmp(tmp_path, scene_id):
    """(c): the default CLI path on the CPU, in a scratch working directory,
    for each scene."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-m", "spectral_tpu_torch.main", "-s", str(scene_id), "-xr", "32", "-ns", "2",
         "-bl", "3", "--save", "--no-show", "--device", "cpu", "--do-log"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    bmps = glob.glob(str(tmp_path / "renders" / "*_render.bmp"))
    logs = glob.glob(str(tmp_path / "logs" / "*_render_log.txt"))
    assert len(bmps) == 1 and len(logs) == 1
    with open(logs[0]) as f:
        entries = dict(line.rstrip("\n").split(": ", 1) for line in f)
    # the run's tallies (utils/trace.py): one frame, one scene build, the host's waits
    assert entries["span render.frame (count, self seconds)"].startswith("1, ")
    assert float(entries["scene build time (seconds)"]) > 0 and float(entries["host wait (seconds)"]) >= 0
    with open(bmps[0], "rb") as f:
        img = decode_bmp(f.read())
    assert img.shape == (32, 32, 3)
    lum = img.astype(np.float64).mean(-1)
    light = lum[3:7, 12:20]  # the ceiling light, near the top centre
    assert light.max() > 200 and light.mean() > 2 * lum.mean()


def test_cli_profile_writes_trace(tmp_path, monkeypatch, capfd):
    """The profiler's trace file is written, with the program's spans. The
    profiler (Kineto) writes to the process's fd 2 itself, past sys.stderr,
    so the test captures at the fd level (capfd): under the run's sys-level
    capture those lines would reach the terminal and split pytest's
    progress lines."""
    monkeypatch.chdir(tmp_path)
    argv = ["-xr", "8", "-ns", "1", "-bl", "2", "--no-show", "--device", "cpu", "--profile", "prof", "-t", "p"]
    assert port_main.main(argv) == 0
    with open(tmp_path / "prof" / "p_trace.json") as f:
        assert '"spectral.render.frame"' in f.read()  # the program's spans on the profiler's timeline
    assert "profiler trace in" in capfd.readouterr().err


def test_cuda_device_without_gpu_raises(tmp_path, monkeypatch):
    """(d): asking for the card on a machine without one is an error, not a
    silent run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        port_main.main(["-xr", "8", "-ns", "1", "-bl", "1", "--no-show", "--save"])
    with pytest.raises(RuntimeError, match="cuda"):
        build_scene(CORNELL)
    assert not os.path.exists(tmp_path / "renders")

