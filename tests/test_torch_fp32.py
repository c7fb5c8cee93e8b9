"""The port's float32 contract (spectral_tpu_torch/ops/fp32.py) against XLA.

The JAX kernels' goldens and interpret-mode renders are computed by XLA's
CPU backend, which contracts a product feeding a sum into one fused
multiply-add. The port's ``fma`` and ``dot3`` must round exactly as XLA
does there, both in a jitted function and inside a Pallas kernel in
interpret mode: a difference of one rounding flips refracted rays at their
entry face (tests/test_torch_render.py (b) fails at its plane seed when
every product is rounded on its own). Bit equality is required.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from spectral_tpu_torch.ops.fp32 import dot3, fma

# one torch thread a process: the CPU test run's workers share the cores
torch.set_num_threads(1)

N = 1 << 16
PALLAS_SHAPE = (8, 128)


def _inputs(n_args: int, n: int) -> list[np.ndarray]:
    rng = np.random.default_rng(7)
    return [rng.normal(size=n).astype(np.float32) for _ in range(n_args)]


def _xla(fn, args: list[np.ndarray], mode: str) -> np.ndarray:
    if mode == "jit":
        return np.asarray(jax.jit(fn)(*args))

    def kernel(*refs):
        refs[-1][...] = fn(*(r[...] for r in refs[:-1]))

    out = pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(PALLAS_SHAPE, jnp.float32), interpret=True,
    )(*(a.reshape(PALLAS_SHAPE) for a in args))
    return np.asarray(out).ravel()


@pytest.mark.parametrize("mode", ("jit", "pallas_interpret"))
def test_dot3_rounds_as_xla(mode):
    n = N if mode == "jit" else PALLAS_SHAPE[0] * PALLAS_SHAPE[1]
    a0, a1, a2, b0, b1, b2 = _inputs(6, n)
    ref = _xla(lambda a0, b0, a1, b1, a2, b2: a0 * b0 + a1 * b1 + a2 * b2, [a0, b0, a1, b1, a2, b2], mode)
    got = dot3(*(torch.from_numpy(x) for x in (a0, a1, a2, b0, b1, b2))).numpy()
    np.testing.assert_array_equal(got, ref)
    # the unfused sum differs, so the comparison can tell the two apart
    assert (((a0 * b0 + a1 * b1) + a2 * b2) != ref).mean() > 0.1


@pytest.mark.parametrize("mode", ("jit", "pallas_interpret"))
def test_fma_rounds_as_xla(mode):
    n = N if mode == "jit" else PALLAS_SHAPE[0] * PALLAS_SHAPE[1]
    a, b, c = _inputs(3, n)
    ref = _xla(lambda a, b, c: a * b + c, [a, b, c], mode)
    got = fma(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.float32
