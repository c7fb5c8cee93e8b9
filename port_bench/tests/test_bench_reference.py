"""The plain reference rebuilds the program's inputs on its own and traces
the same paths: against the program's plain CPU versions at a tiny size.
(The tests may import the program; the reference itself imports nothing of
it.)"""

from __future__ import annotations

import ast
import pathlib

import numpy as np
import pytest
import torch

from port_bench.reference import camera as rcam
from port_bench.reference import render as rr
from port_bench.reference import scene as rsc

REF_DIR = pathlib.Path(rr.__file__).parent


def test_reference_imports_nothing_of_the_program_or_the_harness():
    for path in REF_DIR.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] in {"torch", "numpy", "ctypes", "functools", "dataclasses", "math", "importlib",
                                           "__future__"}, (path.name, n)


def test_cornell_packs_match_the_programs():
    from spectral_tpu_torch import build_scene
    from spectral_tpu_torch.ops.cuda.render_kernel import pack_scene

    tri, mat, tab = pack_scene(build_scene(0, device="cpu"))
    ref = rsc.build({"kind": "cornell"})
    assert torch.equal(ref.tris, tri)
    assert torch.equal(ref.tables, tab)
    assert torch.equal(ref.mats[:, 3:], mat[:, 3:])
    # the reference fits the colours itself; the program reads stored fits
    assert torch.allclose(ref.mats[:, :3], mat[:, :3], rtol=1e-5, atol=1e-8)


def test_field_triangles_match_the_programs():
    from spectral_tpu_torch import build_tri_field
    from spectral_tpu_torch.ops.cuda.render_kernel import pack_scene

    tri, _, _ = pack_scene(build_tri_field(520, 0, device="cpu"))
    assert torch.equal(rsc.build({"kind": "tri_field", "n_tris": 520, "seed": 0}).tris, tri)


@pytest.mark.parametrize("yaw", [0.0, -7.25, 9.5])
def test_camera_matches_the_programs(yaw):
    import spectral_tpu_torch as st
    from spectral_tpu_torch.models.camera import camera_vector

    lf = rcam.orbit_lookfrom((278.0, 278.0, -800.0), (278.0, 278.0, 0.0), yaw)
    cam = st.make_camera(40, 30, vfov=40.0, lookfrom=lf, lookat=(278.0, 278.0, 0.0), vup=(0.0, 1.0, 0.0),
                         defocus_angle=0.0, focus_dist=10.0, device="cpu")
    assert torch.equal(camera_vector(cam), rcam.camera_vector(40, 30, 40.0, lf, (278.0, 278.0, 0.0)))


def _program_and_reference(ar):
    import spectral_tpu_torch as st
    from spectral_tpu_torch.models.camera import camera_vector
    from spectral_tpu_torch.ops.cuda.render_kernel import pack_scene, render_rays

    w, h, spp, b = 10, 8, 3, 5
    tri, mat, tab = pack_scene(st.build_scene(0, device="cpu"))
    cv = camera_vector(st.scene_camera(0, w, h, device="cpu"))
    n = w * h
    px, py = (torch.arange(n) % w).float(), (torch.arange(n) // w).float()
    prog = render_rays(cv, 1984, tri, mat, tab, px, py, spp, b, w)
    pix = torch.arange(n)
    xyz, _ = rr.trace(rsc.RefScene(tri, mat, tab), cv, torch.full((n * spp,), 1984), (pix % w).repeat_interleave(spp),
                      (pix // w).repeat_interleave(spp), torch.arange(spp).repeat(n), w, b, ar)
    acc = torch.zeros(n, 3)
    for s in range(spp):
        acc = acc + xyz.float().reshape(n, spp, 3)[:, s]
    return prog, acc


def test_exact_reference_traces_the_programs_paths_bit_for_bit():
    prog, ref = _program_and_reference(rr.Arith("exact"))
    assert float(prog.abs().sum()) > 0 and torch.equal(prog, ref)


def test_bf16_control_is_far_from_the_program():
    prog, ctrl = _program_and_reference(rr.Arith("bf16"))
    assert not torch.allclose(prog, ctrl, rtol=1e-2, atol=1e-3)


def test_record_recomputes_the_paths_xyz():
    ref = rsc.build({"kind": "cornell"})
    n, w = 64, 8
    pix = torch.arange(n)
    xyz, rec = rr.trace(ref, rcam.camera_vector(8, 8, 40.0, (278.0, 278.0, -800.0), (278.0, 278.0, 0.0)),
                        torch.full((n,), 5), pix % w, pix // w, torch.zeros(n, dtype=torch.int64), w, 6)
    again = rr.xyz_from_record(ref.mats, ref.tables, rec, rr.Arith("exact"))
    np.testing.assert_allclose(again.numpy(), xyz.numpy(), rtol=1e-5, atol=1e-9)
