"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one: a CUDA kernel has no CPU mode. The file imports no JAX, so it runs on
a GPU machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(--noconftest: tests/conftest.py clears JAX caches after each module.)
Kernel and plain version compute the same float32 operations in the same
order (ops/fp32.py), so discrete outputs must be equal and the rendered
XYZ within the render tolerance of tests/test_torch_render.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from spectral_tpu_torch.models.camera import camera_vector
from spectral_tpu_torch.models.scenes import CORNELL, PRISM, TRIS, build_scene, scene_camera
from spectral_tpu_torch.ops.cuda import build
from spectral_tpu_torch.ops.cuda.intersect_kernel import intersect, pack_tris
from spectral_tpu_torch.ops.cuda.render_kernel import (
    n_uniforms,
    pack_scene,
    render_rays,
    render_rays_reference,
)
from spectral_tpu_torch.ops.intersect import nearest_hit


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_intersect_kernel_equals_plain(cuda_device):
    rng = np.random.default_rng(7)
    n = 1 << 16
    o = rng.uniform([20.0, 20.0, -400.0], [535.0, 535.0, 535.0], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    tri = pack_tris(build_scene(CORNELL, cuda_device))
    o, d = torch.from_numpy(o).to(cuda_device), torch.from_numpy(d).to(cuda_device)
    before = build.INTERSECT.launches
    got = intersect(o, d, tri)
    torch.cuda.synchronize()
    assert build.INTERSECT.launches == before + 1
    ref = nearest_hit(o, d, tri)
    for a, b in zip(got[1:], ref[1:]):
        assert torch.equal(a, b)
    torch.testing.assert_close(got[0], ref[0], rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("scene_id", (CORNELL, PRISM, TRIS))
@pytest.mark.parametrize("injected", (True, False), ids=("planes", "hash"))
def test_render_kernel_equals_plain(cuda_device, scene_id, injected):
    w = h = 32
    spp, bounces = 4, 5
    scene = build_scene(scene_id, cuda_device)
    tri, mat, tab = pack_scene(scene)
    cam = camera_vector(scene_camera(scene_id, w, h, cuda_device))
    px = (torch.arange(w * h, device=cuda_device) % w).float()
    py = (torch.arange(w * h, device=cuda_device) // w).float()
    rand = None
    if injected:
        planes = np.random.default_rng(scene_id).uniform(size=(spp, n_uniforms(bounces), w * h))
        rand = torch.from_numpy(planes.astype(np.float32)).to(cuda_device)
    steps = torch.zeros(w * h, dtype=torch.int32, device=cuda_device)
    ref_steps = torch.zeros_like(steps)
    before = build.RENDER.launches
    got = render_rays(cam, 1984, tri, mat, tab, px, py, spp, bounces, w, rand, steps)
    torch.cuda.synchronize()
    assert build.RENDER.launches == before + 1
    ref = render_rays_reference(cam, 1984, tri, mat, tab, px, py, spp, bounces, w, rand, ref_steps)
    assert torch.equal(steps, ref_steps)
    err = (got - ref).abs()
    assert (err <= 2e-3 + 1e-5 * ref.abs()).all(), err.max().item()
    assert err.mean().item() <= 2e-5
    assert ref.sum().item() > 0
