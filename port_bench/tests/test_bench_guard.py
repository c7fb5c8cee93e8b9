"""The scan for JAX and the JAX package compares whole top-level names."""

from __future__ import annotations

import subprocess
import sys

import pytest

from port_bench.guard import forbidden_modules


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "jaxlib", "jaxlib.xla_client", "flax.linen", "spectral_tpu",
                                  "spectral_tpu.ops.pallas.render_kernel"])
def test_forbidden(name):
    assert forbidden_modules([name, "numpy"]) == [name]


@pytest.mark.parametrize("name", ["spectral_tpu_torch", "spectral_tpu_torch.ops.cuda.render_kernel", "jaxtyping",
                                  "flaxen", "spectral", "port_bench.run"])
def test_allowed(name):
    assert forbidden_modules([name]) == []


def test_the_harness_and_the_program_load_no_jax():
    code = (
        "import sys, port_bench.run, port_bench.calibrate, port_bench.kinds.render, port_bench.kinds.train\n"
        "from port_bench.manifest import load\n"
        "load('scenes', 'cornell'), load('scenes', 'tri_field')\n"
        "import spectral_tpu_torch, spectral_tpu_torch.parallel, spectral_tpu_torch.runtime.render_manager\n"
        "from port_bench.guard import forbidden_modules\n"
        "print(forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]"
