"""Which forbidden packages a process holds: JAX and the JAX package that the
program is a port of. Names are compared by their whole top-level part (the
part before the first dot), so ``spectral_tpu_torch`` is not
``spectral_tpu``."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "spectral_tpu")


def forbidden_modules(names=None) -> list[str]:
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
