"""The port's float32 contract (spectral_tpu_torch/ops/fp32.py) against XLA.

The JAX kernels' goldens and interpret-mode renders are computed by XLA's
CPU backend, which contracts a product feeding a sum into one fused
multiply-add. The port's ``fma`` and ``dot3`` must round exactly as XLA
does there, both in a jitted function and inside a Pallas kernel in
interpret mode: a difference of one rounding flips refracted rays at their
entry face (tests/test_torch_render.py (b) fails at its plane seed when
every product is rounded on its own). Bit equality is required.

The transcendentals, as the plain versions write them
(ops/cuda/render_kernel.py: ``torch.sqrt``, ``1 / torch.sqrt``, and
``fp32.sin``, ``fp32.cos``), against the JAX kernel's own forms (jnp.sqrt,
jax.lax.rsqrt, jnp.sin, jnp.cos) on the value ranges the kernels feed
them. Measured on the CPU test machine (ROADMAP C5): torch's sqrt is 1 ulp
from XLA's, which is correctly rounded, on ~0.7% of inputs; its 1/sqrt is
1-2 ulp from XLA's rsqrt on ~34%; torch's own sin and cos are 1 ulp from
XLA's, the C library's sinf and cosf, on ~5% of [0, 2 pi), and that flips
a PRISM path (tests/test_torch_render.py), so the plain versions call
``fp32.sin`` and ``fp32.cos``, equal to XLA's. The gaps are held at most at
those sizes, and sin and cos at none.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from spectral_tpu_torch.ops import fp32
from spectral_tpu_torch.ops.fp32 import dot3, fma

# one torch thread a process: the CPU test run's workers share the cores
torch.set_num_threads(1)

N = 1 << 16
PALLAS_SHAPE = (8, 128)


def _inputs(n_args: int, n: int) -> list[np.ndarray]:
    rng = np.random.default_rng(7)
    return [rng.normal(size=n).astype(np.float32) for _ in range(n_args)]


def _log_uniform(lo: float, hi: float, n: int) -> np.ndarray:
    return np.exp(np.random.default_rng(11).uniform(np.log(lo), np.log(hi), n)).astype(np.float32)


def _unit(n: int) -> np.ndarray:
    return np.random.default_rng(13).uniform(size=n).astype(np.float32)


def _angle(n: int) -> np.ndarray:
    """2 pi u in float32, as sphi and dth are formed from a draw u."""
    return np.float32(2.0 * np.pi) * _unit(n)


# name: (inputs of n, the plain versions' form, the JAX kernel's form, the
# largest gap in ulp); the inputs are the ranges of render_kernel.py:
# sqrt(u_r) and sqrt(1 - z^2) of a draw, sqrt(1 + x^2) of the SPD sigmoid,
# the Sellmeier index sqrt(n2), 1 / sqrt(|d|^2) of a direction (camera rays
# up to ~1e6), sin and cos of 2 pi u
TRANSCENDENTALS = {
    "sqrt_unit": (_unit, torch.sqrt, jnp.sqrt, 1),
    "sqrt_sigmoid": (lambda n: _log_uniform(1.0, 1e4, n), torch.sqrt, jnp.sqrt, 1),
    "sqrt_index": (lambda n: _log_uniform(1.0, 5.0, n), torch.sqrt, jnp.sqrt, 1),
    "rsqrt_direction": (lambda n: _log_uniform(1e-2, 1e6, n), lambda x: 1.0 / torch.sqrt(x), jax.lax.rsqrt, 2),
    "sin": (_angle, fp32.sin, jnp.sin, 0),
    "cos": (_angle, fp32.cos, jnp.cos, 0),
}


def _ulp_gap(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| in float32 units in the last place (same-sign values)."""
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


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


@pytest.mark.parametrize("mode", ("jit", "pallas_interpret"))
@pytest.mark.parametrize("name", sorted(TRANSCENDENTALS))
def test_transcendentals_within_their_gap_to_xla(name, mode):
    make, port, jax_form, max_ulp = TRANSCENDENTALS[name]
    n = N if mode == "jit" else PALLAS_SHAPE[0] * PALLAS_SHAPE[1]
    x = make(n)
    ref = _xla(jax_form, [x], mode)
    got = port(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    gap = _ulp_gap(got, ref)
    assert int(gap.max()) <= max_ulp, (name, mode, int(gap.max()), float(x[gap.argmax()]), float((gap > 0).mean()))


def gap_report() -> list[str]:
    """For each transcendental and mode: the share of inputs where the
    plain versions' form differs from XLA's, the largest gap in ulp and an
    input where it occurs; and the same for torch's own sin and cos."""
    cases = dict(TRANSCENDENTALS)
    cases["sin_torch"] = (_angle, torch.sin, jnp.sin, 1)
    cases["cos_torch"] = (_angle, torch.cos, jnp.cos, 1)
    lines = []
    for name, (make, port, jax_form, _) in cases.items():
        for mode in ("jit", "pallas_interpret"):
            n = N if mode == "jit" else PALLAS_SHAPE[0] * PALLAS_SHAPE[1]
            x = make(n)
            gap = _ulp_gap(port(torch.from_numpy(x)).numpy(), _xla(jax_form, [x], mode))
            lines.append(f"{name} {mode}: {int((gap > 0).sum())} of {n} differ, largest {int(gap.max())} ulp "
                         f"at x = {float(x[gap.argmax()])!r}")
    return lines


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_fp32.py: the gaps of the transcendentals
    print("\n".join(gap_report()))
