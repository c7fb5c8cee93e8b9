"""Run log: ordered key/value store written per render.

Parity with the reference's ``log_context`` singleton (_log_/log_context.h:
31-113, log_context.cpp:5-123): insertion-ordered entries, typed add_entry
overloads collapse to one Python method, ``sum_value`` accumulators, and a
``logs/<subdir>/<timestamp>_<title>_log.txt`` writer. Instance-based rather
than a singleton, but ``get_log_context()``
offers the reference's global-access pattern for the CLI path.
"""

from __future__ import annotations

import os
import time
from typing import Optional


class LogContext:
    def __init__(self, title: str = "render", subdir: str = "") -> None:
        self.title = title
        self.subdir = subdir
        self._entries: dict[str, str] = {}

    def add_entry(self, key: str, value) -> None:
        """Typed overloads (log_context.cpp:72-111) collapse here; floats
        keep full repr precision like the reference's std::to_string+trim."""
        if isinstance(value, float):
            self._entries[key] = f"{value:.6f}".rstrip("0").rstrip(".")
        else:
            self._entries[key] = str(value)

    def sum_value(self, key: str, value: float) -> None:
        """Accumulate into a numeric entry (log_context.cpp:113-123)."""
        cur = float(self._entries.get(key, "0") or 0.0)
        self.add_entry(key, cur + float(value))

    def get(self, key: str) -> Optional[str]:
        return self._entries.get(key)

    def items(self):
        return self._entries.items()

    def to_file(self, log_dir: str = "logs") -> str:
        """Write ``logs/<subdir>/<timestamp>_<title>_log.txt``
        (log_context.cpp:5-25)."""
        d = os.path.join(log_dir, self.subdir) if self.subdir else log_dir
        os.makedirs(d, exist_ok=True)
        stamp = time.strftime("%Y%m%d-%H%M%S")
        path = os.path.join(d, f"{stamp}_{self.title}_log.txt")
        with open(path, "w") as f:
            for k, v in self._entries.items():
                f.write(f"{k}: {v}\n")
        return path


_global: Optional[LogContext] = None


def get_log_context() -> LogContext:
    global _global
    if _global is None:
        _global = LogContext()
    return _global


def reset_log_context(title: str = "render", subdir: str = "") -> LogContext:
    global _global
    _global = LogContext(title, subdir)
    return _global
