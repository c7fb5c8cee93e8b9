"""Statistics over all the requests of a window."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of all ``values``, by linear
    interpolation between closest ranks (numpy's default)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(work: float, seconds: float) -> float:
    """Work per second over a whole window."""
    if seconds <= 0:
        raise ValueError(f"window of {seconds} s")
    return work / seconds

