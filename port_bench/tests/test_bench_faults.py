"""A run of each cell on the CPU, at a tiny frame and on the program's plain
versions, with the timed path sound and then broken underneath: the check
must pass the sound run and fail every fault the cell can have, and its
control (the reference in bfloat16 in the program's place)."""

from __future__ import annotations

import torch
import pytest

from port_bench.kinds import render, train

RENDER_FAULTS = ["sound", "unchanged", "half", "altered"]


def _patch_render(monkeypatch, fault):
    from spectral_tpu_torch.runtime import render_manager

    real = render_manager.render_chunk
    first = {}

    def broken(scene, cam, seed, x0, y0, w, h, spp, bounces, *a, **kw):
        if fault == "half":  # half the samples, their mean taken for all
            return 2.0 * real(scene, cam, seed, x0, y0, w, h, spp // 2, bounces, *a, **kw)
        out = real(scene, cam, seed, x0, y0, w, h, spp, bounces, *a, **kw)
        if fault == "unchanged":  # every frame returns the first one
            return first.setdefault("xyz", out)
        if fault == "altered":  # one answer changed where it is made
            out = out.clone()
            out[h // 2, w // 2] += 0.5 * out.abs().max() + 1.0
        return out

    if fault != "sound":
        monkeypatch.setattr(render_manager, "render_chunk", broken)


@pytest.mark.parametrize("fault", RENDER_FAULTS)
@pytest.mark.parametrize("workload", ["cornell-render", "field200k-render"])
def test_render_check(tiny_run, monkeypatch, workload, fault):
    _patch_render(monkeypatch, fault)
    run = tiny_run(workload, seconds=0.6)  # at least 3 frames on a loaded CPU
    render.run_cell(run)
    assert run.attempted >= 3
    assert run.correct == (fault == "sound"), run.checks


TRAIN_FAULTS = ["sound", "unchanged", "half", "frozen_in_window", "altered_in_window"]


def _patch_train(monkeypatch, fault):
    from spectral_tpu_torch import parallel

    real = parallel.train_step_fused
    calls = []

    def broken(params, scene, cam, target, seed, spp, bounces, lr, mesh=None, sched="sorted"):
        calls.append(seed)
        in_window = len(calls) > 2  # the traffic follows 2 steps in set-up
        if fault == "unchanged" or (fault == "frozen_in_window" and in_window):
            _, loss = real(params, scene, cam, target, seed, spp, bounces, lr, mesh, sched)
            return params, loss
        if fault == "altered_in_window" and in_window:  # the loss changed where it is made
            new, loss = real(params, scene, cam, target, seed, spp, bounces, lr, mesh, sched)
            return new, loss * 2.0
        if fault == "half":
            return real(params, scene, cam, target, seed, spp // 2, bounces, lr, mesh, sched)
        return real(params, scene, cam, target, seed, spp, bounces, lr, mesh, sched)

    if fault != "sound":
        monkeypatch.setattr(parallel, "train_step_fused", broken)


@pytest.mark.parametrize("fault", TRAIN_FAULTS)
def test_train_check(tiny_run, monkeypatch, fault):
    _patch_train(monkeypatch, fault)
    run = tiny_run("cornell-train")
    train.run_cell(run)
    assert run.attempted >= 1
    assert run.correct == (fault == "sound"), run.checks


def test_mesh_check_fails_without_the_exchange(tiny_run, monkeypatch):
    """The (1, 4) mesh's step (traffic ``sgd-mesh1x4``) in one process with
    no process group: the program renders rank 0's samples and sums nothing."""
    from spectral_tpu_torch.parallel.mesh import Mesh

    monkeypatch.setattr(train, "_mesh", lambda run: Mesh(1, 4, 0, 0, "cpu"))
    run = tiny_run("cornell-train", traffic="sgd-mesh1x4")
    train.run_cell(run)
    assert not run.correct, run.checks


@pytest.mark.parametrize("workload", ["cornell-render", "field200k-render"])
def test_render_control_fails(tiny_run, workload):
    run = tiny_run(workload)
    readings = render.controls(run, torch.device("cpu"))
    assert not run.correct, readings


@pytest.mark.parametrize("traffic", ["sgd", "sgd-mesh1x4"])
def test_train_control_and_faults_fail(tiny_run, traffic):
    run = tiny_run("cornell-train", traffic=traffic)
    readings = train.controls(run, torch.device("cpu"))
    lim = run.limits
    names = ("bf16", "half", "no_exchange") if traffic == "sgd-mesh1x4" else ("bf16", "half")
    assert set(readings) == set(names)
    for name in names:
        assert any(v > lim[k] for k, v in readings[name].items()), (name, readings[name])
