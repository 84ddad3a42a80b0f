"""The port's device rule.

Entry points run on the card unless the caller names the CPU. A request
for a CUDA device on a machine without one raises: nothing in the port
quietly continues on the CPU.
"""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """``"cuda"`` / ``"cuda:N"`` / ``"cpu"`` -> ``torch.device``; raises
    RuntimeError for a CUDA device when CUDA is unavailable."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}: use cuda or cpu")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the card's queue (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
