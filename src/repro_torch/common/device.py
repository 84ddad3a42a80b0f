"""The port's device rule.

Entry points run on the card unless the caller names the CPU. A request
for a CUDA device on a machine without one raises: nothing in the port
quietly continues on the CPU.
"""
from __future__ import annotations

import contextlib
import time
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


class StageTimes(dict):
    """Host wall milliseconds per named stage, each stage bracketed by a
    device sync so its work is inside it; repeated stages add up."""

    def __init__(self, device: torch.device):
        super().__init__()
        self.device = device

    @contextlib.contextmanager
    def stage(self, name: str):
        synchronize(self.device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            synchronize(self.device)
            self[name] = self.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
