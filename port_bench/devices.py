"""Device calls that the harness makes on the card, and that do nothing on
the CPU (where the tests drive a run of the program's plain versions)."""

from __future__ import annotations

import torch


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak_bytes(dev: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0


def free(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()
