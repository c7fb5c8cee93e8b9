"""Shared fixtures of the harness's CPU tests: a run of a cell at a tiny
frame on the program's plain versions (``device="cpu"``), and the check for
a card, made inside a fixture."""

from __future__ import annotations

import copy
import time

import pytest
import torch

from port_bench.context import Run
from port_bench.manifest import Manifest

TINY = {
    "cornell-render": dict(width=12, height=12, spp=4, bounces=4),
    "field200k-render": dict(width=12, height=6, spp=2, bounces=3),
    "cornell-train": dict(width=24, height=12, spp=4, bounces=4),
}


@pytest.fixture
def tiny_run():
    """make(workload, seed=..., seconds=...) -> a Run of the cell at its TINY
    frame on the CPU; the field holds 520 triangles, and a render check
    reads every pixel of 3 frames."""
    torch.set_num_threads(1)
    man = Manifest()

    def make(workload: str, seed: int = 2**31 + 7, seconds: float = 0.3, traffic: str | None = None) -> Run:
        """``traffic``: another mix of the cell's loop in its place."""
        cell = man.cell(workload)
        cfg = copy.deepcopy(man.config(cell["config"]))
        traffic = man.traffic(traffic or cell["traffic"])
        frame = cfg["frames"][traffic["frame"]]
        frame.update(TINY[workload])
        if cfg["scene"]["kind"] == "tri_field":
            cfg["scene"]["n_tris"] = 520
        cfg["check"] = {"render": {"frames": 3, "pixels": frame["width"] * frame["height"]}}
        return Run(workload=workload, seed=seed, seconds=seconds, trace=False, cell=cell, config=cfg,
                   traffic=traffic, limits=man.limits(workload), t0=time.perf_counter(), device="cpu")

    return make


@pytest.fixture
def card():
    """Skips the test unless PyTorch sees a CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark's runs measure the card")
    return torch.device("cuda")
