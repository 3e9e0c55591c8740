"""The one place the port picks its device.

The port runs on the GPU unless its caller asks for the CPU: a library
caller passes ``device="cpu"`` to the function it calls, and a CLI run or
a rank of a sharded run sets ``SPYDRPICK_TORCH_DEVICE=cpu`` in its
environment (the counterpart of the JAX package's ``JAX_PLATFORMS=cpu``).
Without either, ``default_device`` raises when PyTorch sees no GPU, so a
machine whose CUDA failed to initialise never runs a whole analysis on
the host.  A process of a sharded run (``torch.distributed`` initialised)
drives ``cuda:(local rank % device count)``, any other process
``cuda:0``.  On the CPU the kernel wrappers run their plain PyTorch
versions (ops/mi_kernels.py, ops/compact.py); on a CUDA tensor they launch
their kernels.  ``to_host`` is the way large results (the sweep's edges,
the sorted edge set) come back from a card: through pinned memory.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

DEVICE_ENV = "SPYDRPICK_TORCH_DEVICE"
# elements that ``to_host`` gathers and casts on a card per step: bounds
# its device temporaries to 2^24 elements of one part at a time
HOST_CHUNK = 1 << 24


def local_rank() -> int:
    """This process's index on its host: torchrun's ``LOCAL_RANK``, else
    the global rank (processes started by hand with the multi-host flags,
    numbered host by host), else 0."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def cpu_requested() -> bool:
    """Whether the environment asks for the CPU (``SPYDRPICK_TORCH_DEVICE``
    is ``cpu``; unset or empty, the GPU)."""
    value = os.environ.get(DEVICE_ENV, "").strip().lower()
    if value not in ("", "cpu"):
        raise ValueError(f"{DEVICE_ENV}={value!r}: expected 'cpu' or unset")
    return value == "cpu"


def gpu_count() -> int:
    """GPUs this process may drive: 0 when the CPU was asked for."""
    return 0 if cpu_requested() else torch.cuda.device_count()


def default_device() -> torch.device:
    if cpu_requested():
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible to PyTorch, and spydrpick_torch runs on the GPU "
            f"unless asked for the CPU: set {DEVICE_ENV}=cpu for a CPU run (library "
            "callers may pass device='cpu')")
    if dist.is_available() and dist.is_initialized():
        return torch.device(f"cuda:{local_rank() % torch.cuda.device_count()}")
    return torch.device("cuda:0")


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU), so that a
    host timestamp taken next covers it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def to_host(parts, order: torch.Tensor | None = None, dtypes=None) -> list[np.ndarray]:
    """Host numpy copies of the equal-length 1-D tensors ``parts``, each
    taken in ``order`` (an index tensor on their device) when given and
    cast to its entry of ``dtypes`` (None: its own dtype).  On a card each
    part is gathered and cast there, HOST_CHUNK elements at a time, and
    every chunk is copied without blocking into a pinned host tensor,
    which the returned array is a view of: the data cross once, already
    widened, with one synchronize at the end.  On the CPU: plain indexing
    and casts, always into new memory."""
    dtypes = [None] * len(parts) if dtypes is None else dtypes
    dtypes = [p.dtype if dt is None else dt for p, dt in zip(parts, dtypes)]
    if not parts or parts[0].device.type != "cuda":
        return [(p if order is None else p[order]).to(dt, copy=True).numpy()
                for p, dt in zip(parts, dtypes)]
    n = len(parts[0]) if order is None else len(order)
    outs = [torch.empty(n, dtype=dt, pin_memory=True) for dt in dtypes]
    for lo in range(0, n, HOST_CHUNK):
        hi = min(n, lo + HOST_CHUNK)
        idx = None if order is None else order[lo:hi]
        for p, out in zip(parts, outs):
            x = p[lo:hi] if idx is None else p[idx]
            out[lo:hi].copy_(x.to(out.dtype), non_blocking=True)
    synchronize(parts[0].device)
    return [out.numpy() for out in outs]
