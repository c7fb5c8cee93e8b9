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

The transcendentals differ between the three in the last bits (ROADMAP
C5, measured on the value ranges the kernels feed them): XLA's CPU sqrt is
correctly rounded as CUDA's sqrtf is, and torch's CPU sqrt is 1 ulp off on
~0.7% of inputs; XLA computes 1/sqrt as an rsqrt that is 1 ulp from the
two-rounding 1/sqrtf of the kernels on ~1/3 of inputs; XLA's CPU sin and
cos are the C library's sinf and cosf, from which torch's CPU sin and cos
differ by 1 ulp on ~5% of [0, 2 pi). Only the last flips paths (a
scattered direction's last bit decides whether a PRISM path finds the
light), so ``sin`` and ``cos`` below call the C library on the CPU.

The XLA-style renderer (render/wavefront.py) is another XLA program, of
[N, 3] vector expressions rather than the Pallas kernel's scalar ones. Its
fusions follow the same rule (read in the LLVM IR XLA's CPU backend emits:
a product with no other use feeding a sum or difference is fused, the left
operand first; ``p - q * r`` becomes fma(-q, r, p)); a 3-term reduction of
products (a sum over the last axis, or a K = 3 matmul) is ``sum3``; and
its square root is correctly rounded (``sqrt``).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np
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


@functools.lru_cache(maxsize=None)
def _libm(name: str):
    """The C library's float function ``name``, element by element over a
    numpy array."""
    fn = getattr(ctypes.CDLL(ctypes.util.find_library("m")), name)
    fn.restype = ctypes.c_float
    fn.argtypes = [ctypes.c_float]
    return np.frompyfunc(fn, 1, 1)


def _c_float(name: str, x: torch.Tensor) -> torch.Tensor:
    flat = x.detach().to(torch.float32).contiguous().view(-1).numpy()
    return torch.from_numpy(_libm(name)(flat).astype(np.float32)).view(x.shape)


def sin(x: torch.Tensor) -> torch.Tensor:
    """float32 sine: the C library's sinf on the CPU, as XLA's CPU backend
    computes it; torch's sin elsewhere (on CUDA tensors CUDA's sinf, which
    the kernels call)."""
    return _c_float("sinf", x) if x.device.type == "cpu" else torch.sin(x)


def cos(x: torch.Tensor) -> torch.Tensor:
    """float32 cosine, as ``sin``: the C library's cosf on the CPU."""
    return _c_float("cosf", x) if x.device.type == "cpu" else torch.cos(x)


def dot3_xla(a0, a1, a2, b0, b1, b2) -> torch.Tensor:
    """``a0*b0 + a1*b1 + a2*b2`` as XLA's CPU backend computes a 3-term
    reduction of products or a K = 3 matmul: fma(a2, b2, fma(a1, b1, a0*b0))
    (csrc/hit.cuh::dot3_xla)."""
    return fma(a2, b2, fma(a1, b1, a0 * b0))


def sum3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum(a * b, axis=-1)`` over a last axis of 3, ``dot3_xla`` of the
    components."""
    return dot3_xla(a[..., 0], a[..., 1], a[..., 2], b[..., 0], b[..., 1], b[..., 2])


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root, as XLA's CPU backend and
    CUDA's sqrtf compute it: through float64 on the CPU (a float64 root of
    a float32 value rounds once more without error), torch's elsewhere."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype) if x.device.type == "cpu" else torch.sqrt(x)
