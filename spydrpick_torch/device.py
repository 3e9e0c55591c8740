"""The one place the port picks its device.

A process of a sharded run (``torch.distributed`` initialised) drives
``cuda:(local rank % device count)``; any other process ``cuda:0`` when
PyTorch sees a GPU, else ``cpu``.  Every engine, weights matmul and pairs
path takes this device (or an explicit one from its caller) and nothing
moves work from a present GPU to the CPU.  On the CPU the kernel wrappers
run their plain PyTorch versions (ops/mi_kernels.py, ops/compact.py).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def local_rank() -> int:
    """This process's index on its host: torchrun's ``LOCAL_RANK``, else
    the global rank (processes started by hand with the multi-host flags,
    numbered host by host), else 0."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def default_device() -> torch.device:
    if not torch.cuda.is_available():
        return torch.device("cpu")
    if dist.is_available() and dist.is_initialized():
        return torch.device(f"cuda:{local_rank() % torch.cuda.device_count()}")
    return torch.device("cuda:0")


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU), so that a
    host timestamp taken next covers it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
