"""The program's own spans (``spectral_tpu_torch/utils/trace.py``), read in
the run's process after the traced window: the program records them
exactly while a profiler records the process, which is the traced window.
"""

from __future__ import annotations


def summary(run) -> dict | None:
    """The program's spans by name ({name: {"count", "total_s", "self_s"}}),
    or None in an untraced run, when nothing was recorded, or when the
    program has no such module (a checkout from before it)."""
    if not run.trace:
        return None
    try:
        from spectral_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.summary()["spans"] or None


def self_ms_a_frame(run, names) -> float | None:
    """Milliseconds a ``render.frame`` span of the self time of the spans
    ``names``, or None when no frame or none of them was recorded."""
    spans = summary(run)
    if spans is None or "render.frame" not in spans or not any(k in spans for k in names):
        return None
    return 1e3 * sum(spans[k]["self_s"] for k in names if k in spans) / spans["render.frame"]["count"]
