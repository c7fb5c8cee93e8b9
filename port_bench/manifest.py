"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
each of those, each metric, each loop, each scene and each cell's
correctness limits is a file of its own under this directory:

    configs/<config>.json           the deployment: scene, frames, camera
    traffic/<traffic>.json          the mix, read by the loop its "kind" names
    kinds/<kind>.py                 the loop: run_cell(run), controls(run, dev)
    scenes/<scene kind>.py          the program's scene: build(spec, device)
    reference/scenes/<kind>.py      the reference's scene: build(spec)
    end_to_end/<metric>.py          read(run) -> float
    layer_metrics/<metric>.py       read(run) -> float | None
    limits/<workload>.json          {number: limit} of the correctness check

so that a later change adds a cell, a loop, a scene or a metric by adding
files and entries. A metric ``<quantity>.<part>`` (one quantity split by
the end-to-end metric it moves) is read by ``<quantity>.<part>.py``, or by
``<quantity>.py`` where that file is absent.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Manifest:
    """``path``: the manifest; ``bench``: the directory of the traffic,
    limits and reader files (this one)."""

    def __init__(self, path: Path | str = ROOT / "BENCHMARK.json", bench: Path | str = HERE):
        self.path = Path(path)
        self.data = _load_json(self.path)
        self.root = self.path.parent
        self.bench = Path(bench)

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in {self.path}")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return _load_json(self.root / c["file"])
        raise KeyError(f"no config {name!r} in {self.path}")

    def traffic(self, name: str) -> dict:
        return _load_json(self.bench / "traffic" / f"{name}.json")

    def limits(self, cell: str) -> dict:
        return _load_json(self.bench / "limits" / f"{cell}.json")

    @staticmethod
    def _covers(metric: dict, cell: str) -> bool:
        return "workloads" not in metric or cell in metric["workloads"]

    def end_to_end(self, cell: str) -> list[dict]:
        return [m for m in self.data["end_to_end"] if self._covers(m, cell)]

    def per_layer(self, cell: str) -> list[dict]:
        """The per-layer metrics of ``cell``: those that list it, and those
        without a list whose end-to-end metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if cell in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in e2e)]


def load(subdir: str, name: str, bench: Path | str = HERE):
    """The module ``<bench>/<subdir>/<name>.py``, loaded once a process (by
    the package name it would import under, so that the loops' relative
    imports work and a module imported the usual way is the same one)."""
    path = Path(bench) / subdir / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {subdir}/{name}.py under {bench}")
    parts = [p.replace(".", "_").replace("-", "_") for p in Path(subdir).parts]
    mod_name = ".".join(["port_bench", *parts, name.replace(".", "_").replace("-", "_")])
    mod = sys.modules.get(mod_name)
    if mod is not None and Path(getattr(mod, "__file__", "")).resolve() == path.resolve():
        return mod
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    if mod_name not in sys.modules:
        sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, bench: Path | str = HERE):
    """The ``read`` function of layer_metrics/<metric>.py, or of the
    quantity's own file layer_metrics/<quantity>.py for ``<quantity>.<part>``."""
    if not (Path(bench) / "layer_metrics" / f"{metric}.py").is_file() and "." in metric:
        metric = metric.split(".", 1)[0]
    return load("layer_metrics", metric, bench).read


def end_to_end(metric: str, bench: Path | str = HERE):
    """The ``read`` function of end_to_end/<metric>.py."""
    return load("end_to_end", metric, bench).read


def kind(name: str, bench: Path | str = HERE):
    """The loop of a traffic ``kind``: kinds/<name>.py."""
    return load("kinds", name, bench)
