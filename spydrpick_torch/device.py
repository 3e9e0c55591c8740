"""The one place the port picks its device.

``cuda:0`` when PyTorch sees a GPU, else ``cpu``.  The choice is made once
per process; every engine, weights matmul and pairs path takes this device
(or an explicit one from its caller) and nothing moves work from a present
GPU to the CPU.  On the CPU the kernel wrappers run their plain PyTorch
versions (ops/mi_kernels.py, ops/compact.py).
"""

from __future__ import annotations

import functools

import torch


@functools.cache
def default_device() -> torch.device:
    return torch.device("cuda:0" if torch.cuda.is_available() else "cpu")


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU), so that a
    host timestamp taken next covers it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
