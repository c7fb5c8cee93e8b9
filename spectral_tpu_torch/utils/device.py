"""Device selection for the port's entry points.

Every entry point takes an explicit ``device`` and runs on ``cuda`` unless
the caller asks for the CPU. There is no fallback: asking for ``cuda`` on a
machine without a GPU raises instead of quietly running the plain PyTorch
path on the host.
"""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str = "cuda") -> torch.device:
    """``device`` as a torch.device; raises when it names an unusable device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' was asked for but PyTorch sees no CUDA device; "
                "pass device='cpu' (CLI: --device cpu) to run the plain "
                "PyTorch path on the host"
            )
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
