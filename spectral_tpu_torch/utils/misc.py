"""Small utilities with the reference's utils/cuda_utility.* semantics.

Port of spectral_tpu/utils/misc.py:
- ``device_clamp``       <- branchless clamp (cuda_utility.cu:50-56)
- ``degrees_to_radians`` <- cuda_utility.cuh:40-43
- ``random_permutation`` <- Fisher-Yates (cuda_utility.cu:58-73)
- ``random_int``         <- cuda_random_int with the intended inclusive
  range [min, max] (the reference's ceil of a (0, 1] uniform draws from
  (min, max])

The random ones take a ``torch.Generator`` (utils/prng.py::generator) where
the JAX functions take a key.
"""

from __future__ import annotations

import math

import torch


def device_clamp(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """Branchless clamp: min(max(x, lo), hi)."""
    return torch.minimum(torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype, device=x.device)),
                         torch.as_tensor(hi, dtype=x.dtype, device=x.device))


def degrees_to_radians(deg: float) -> float:
    return deg * (math.pi / 180.0)


def random_permutation(gen: torch.Generator, n: int) -> torch.Tensor:
    """Uniform random permutation of [0, n) on the generator's device."""
    return torch.randperm(n, generator=gen, device=gen.device)


def random_int(gen: torch.Generator, shape, minval: int, maxval: int) -> torch.Tensor:
    """Uniform integers in [minval, maxval]."""
    return torch.randint(minval, maxval + 1, tuple(shape), generator=gen, device=gen.device)
