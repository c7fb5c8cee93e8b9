"""BENCHMARK.json against the benchmark's contract, and the by-name
discovery of every file it names."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from port_bench.manifest import HERE, ROOT, Manifest, end_to_end, kind, load, reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = Manifest()
CELLS = [w["name"] for w in MAN.data["workloads"]]


def test_top_level_keys_and_command():
    d = MAN.data
    assert set(d) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(d["paths"]) <= 16 and all(not p.startswith("/") and ".." not in p for p in d["paths"])
    assert 1 <= len(d["command"]) <= 32
    assert isinstance(d["run_seconds"], int) and 1 <= d["run_seconds"] <= 51
    assert len(json.dumps(d)) < 64 * 1024


def test_entries_have_the_contract_keys_only():
    d = MAN.data
    one_line = lambda text: 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text  # noqa: E731
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["why"]) and one_line(c["source"]) and len(c["reduced"]) <= 16
    for w in d["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert one_line(w["why"])
    for m in d["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in d["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert one_line(m["layer"])
    for m in d["end_to_end"] + d["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in d[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in d[k]}) == len(d[k])
    assert len({m["name"] for m in d["end_to_end"] + d["per_layer"]}) == len(d["end_to_end"]) + len(d["per_layer"])


def test_at_most_a_quarter_of_cells_on_four_chips():
    four = sum(w["chips"] == 4 for w in MAN.data["workloads"])
    assert four <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files_by_name(cell):
    w = MAN.cell(cell)
    cfg = MAN.config(w["config"])
    traffic = MAN.traffic(w["traffic"])
    assert traffic["frame"] in cfg["frames"]
    loop = kind(traffic["kind"])
    assert callable(loop.run_cell) and callable(loop.controls)
    assert callable(load("scenes", cfg["scene"]["kind"]).build)
    assert (HERE / "reference" / "scenes" / f"{cfg['scene']['kind']}.py").is_file()
    assert set(MAN.limits(cell))
    reported = {m["name"] for m in MAN.end_to_end(cell)}
    assert "setup_s" in reported and len(reported) >= 2
    assert all(callable(end_to_end(name)) for name in reported)
    layers = MAN.per_layer(cell)
    assert layers
    for m in layers:
        assert m["moves"] in reported
        assert callable(reader(m["name"]))


def test_every_config_is_used_and_its_file_under_paths():
    used = {w["config"] for w in MAN.data["workloads"]}
    for c in MAN.data["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in MAN.data["paths"]))
        assert (ROOT / c["file"]).is_file()


def test_a_cell_added_as_files_is_found(tmp_path):
    """A later change adds a cell by adding files and entries: a copy of the
    manifest with one more cell finds its new traffic, limits, loop, scene,
    end-to-end metric and reader without an edit to any file that is
    there."""
    bench = tmp_path / "bench"
    shutil.copytree(HERE, bench, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (bench / "kinds" / "recover.py").write_text("def run_cell(run):\n    return 'recovered'\n")
    (bench / "scenes" / "prism.py").write_text("def build(spec, device):\n    return ('prism', spec['n'])\n")
    (bench / "end_to_end" / "time_to_recover_s.py").write_text("def read(run):\n    return 2.5\n")
    assert kind("recover", bench).run_cell(None) == "recovered"
    assert load("scenes", "prism", bench).build({"n": 3}, None) == ("prism", 3)
    assert end_to_end("time_to_recover_s", bench)(None) == 2.5
    (bench / "traffic" / "orbit-wide.json").write_text(json.dumps({"kind": "render", "frame": "render",
                                                                    "yaw_deg": 30.0, "strata": 8}))
    (bench / "limits" / "cornell-render-wide.json").write_text(json.dumps({"xyz_gap": 1e-3}))
    (bench / "layer_metrics" / "frames_s.py").write_text("def read(run):\n    return 1.0\n")
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    data["workloads"].append({"name": "cornell-render-wide", "config": "cornell", "traffic": "orbit-wide",
                              "chips": 1, "why": "wide orbit"})
    for m in data["end_to_end"]:
        if m["name"] == "render_mrays_s":
            m["workloads"].append("cornell-render-wide")
    data["per_layer"].append({"name": "frames_s", "unit": "1/s", "better": "higher", "source": "host_clock",
                              "layer": "device", "moves": "render_mrays_s"})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(data))
    for c in data["configs"]:
        (tmp_path / c["file"]).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(ROOT / c["file"], tmp_path / c["file"])
    man = Manifest(path, bench)
    assert man.traffic(man.cell("cornell-render-wide")["traffic"])["yaw_deg"] == 30.0
    assert man.limits("cornell-render-wide") == {"xyz_gap": 1e-3}
    names = [m["name"] for m in man.per_layer("cornell-render-wide")]
    assert names == ["frames_s"] and reader("frames_s", bench)(None) == 1.0
    assert "frames_s" in [m["name"] for m in man.per_layer("field200k-render")]


def test_a_split_quantity_is_read_by_its_own_file():
    """``device_idle_pct.<part>`` is read by layer_metrics/device_idle_pct.py."""
    for m in MAN.data["per_layer"]:
        if m["name"].startswith("device_idle_pct."):
            assert reader(m["name"]) is load("layer_metrics", "device_idle_pct").read
