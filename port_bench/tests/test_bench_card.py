"""A short run of a cell on the card (marked ``cuda``; skipped without one)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from port_bench.manifest import ROOT


@pytest.mark.cuda
def test_a_short_render_run_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", "cornell-render", "--seed", "3", "--seconds", "2",
         "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
    assert {"render_mrays_s", "setup_s"} <= set(res["metrics"])


def test_a_run_without_a_card_prints_no_result():
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "from port_bench.run import main\n"
            "sys.exit(main(['--workload', 'cornell-render', '--seed', '1', '--seconds', '1']))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
