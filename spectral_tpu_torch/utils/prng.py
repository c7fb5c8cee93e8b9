"""Counter-based random draws for the XLA-style wavefront renderer.

Port of spectral_tpu/utils/prng.py. The JAX package folds (tile, sample,
bounce) counters into one root ``jax.random`` key, so every sample is a
pure function of its counters under any sharding. Here a key is a Python
int: ``fold`` mixes counters into it on the host, and ``generator`` seeds a
``torch.Generator`` with the result, so a render is a pure function of
(seed, chunk, sample, bounce) on every device, as in JAX. The two packages
draw different numbers from the same counters; tests that compare them
path for path inject the JAX package's draws instead
(render/wavefront.py::render_tile_xyz, ``draws``).

The reference's rejection loops (math/vec3.cuh:209-246) become closed-form
samplers with the same distributions: a normalized 3-D Gaussian is uniform
on the sphere, (sqrt(u) cos, sqrt(u) sin) uniform in the disk.
"""

from __future__ import annotations

import math

import torch

_MASK64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64's finalizer: a bijection of 64-bit ints."""
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _MASK64
    return x ^ (x >> 31)


def fold(seed: int, *counters: int) -> int:
    """Fold a sequence of counters (tile, sample, bounce) into a key, the
    counterpart of a chain of ``jax.random.fold_in``: a 64-bit mix of
    Python ints, on the host."""
    key = _mix64(int(seed) & _MASK64)
    for c in counters:
        key = _mix64((key + 0x9E3779B97F4A7C15 + _mix64(int(c) & _MASK64)) & _MASK64)
    return key


def generator(seed: int, device: torch.device | str) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with the key ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & _MASK64)
    return gen


def random_unit_vectors(gen: torch.Generator, shape: tuple[int, ...]) -> torch.Tensor:
    """Uniform unit vectors on the sphere, [*shape, 3] float32 on the
    generator's device (prng.py:23-26, with its 1e-12 floor on the norm)."""
    v = torch.randn((*shape, 3), generator=gen, device=gen.device, dtype=torch.float32)
    return v / torch.clamp_min(torch.linalg.vector_norm(v, dim=-1, keepdim=True), 1e-12)


def random_in_unit_disk(gen: torch.Generator, shape: tuple[int, ...]) -> torch.Tensor:
    """Uniform points in the unit disk, [*shape, 2] (prng.py:29-34)."""
    r = torch.sqrt(torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32))
    theta = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32) * (2.0 * math.pi)
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
