"""The float32 arithmetic contract shared by the CUDA kernels and their
plain PyTorch versions.

The JAX package's kernels are checked on the CPU in interpret mode, where
XLA's CPU backend contracts a product feeding a sum into one fused
multiply-add (LLVM's rule: in ``p + q`` the left operand is fused if it is
a product, else the right one; ``a*b + c*d + e*f`` becomes
``fma(e, f, fma(a, b, c*d))``). Some of the renderer's decisions hang on a
single rounding: the reference's self-intersection offset (EPSILON = 1e-4)
is under two float32 ulps at the prism's height, so whether a refracted
ray's new origin lies on its entry plane, and re-hits it at t = 0, depends
on whether ``n . o`` was contracted. The port therefore contracts exactly
where XLA does: the CUDA sources call ``fmaf`` at those places and are
compiled with -fmad=false so that nvcc fuses nothing else; the plain
versions call ``fma`` below.
"""

from __future__ import annotations

import torch


def _f64(x):
    return x.to(torch.float64) if isinstance(x, torch.Tensor) else float(x)


def fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, like CUDA's fmaf. The product of
    two float32 values is exact in float64, so only the sum rounds before
    the final rounding to float32 (the two roundings differ from one in
    about 2^-29 of cases). Scalars must be exact float32 values."""
    return (_f64(a) * _f64(b) + _f64(c)).to(torch.float32)


def dot3(a0, a1, a2, b0, b1, b2) -> torch.Tensor:
    """``a0*b0 + a1*b1 + a2*b2`` as XLA contracts it:
    fma(a2, b2, fma(a0, b0, a1*b1))."""
    return fma(a2, b2, fma(a0, b0, a1 * b1))
