"""Multi-process startup (counterpart of spydrpick_tpu/parallel/distributed.py).

Every process of a sharded run executes the same program on one device
of its own, or on a device it shares with other processes.  Two ways in:

  * ``torchrun --nproc-per-node N -m spydrpick_torch ... --sharded``:
    torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_ADDR``/``MASTER_PORT``) and an ``env://`` rendezvous;
  * the reference's multi-host flags, ``--coordinator-address H:P
    --num-processes N --process-id r``: a ``tcp://`` rendezvous, i.e. a
    TCP store that process 0 serves at H:P.

The backend is a transport choice and follows one rule: ``nccl`` when
every rank has a GPU of its own, ``gloo`` when ranks share a GPU (NCCL
refuses two ranks on one card) or run on the CPU (``SPYDRPICK_TORCH_DEVICE=cpu``,
``device.py``).  Under torchrun a rank
compares ``LOCAL_WORLD_SIZE`` with its host's GPU count; with the flags
every rank first writes its host name and GPU count into the store, so
all ranks decide from the same table.  The kernels run on the rank's
device either way (``device.default_device``).
"""

from __future__ import annotations

import collections
import os
import socket
from datetime import timedelta

import torch
import torch.distributed as dist

from spydrpick_torch.device import default_device, gpu_count

TIMEOUT = timedelta(minutes=10)  # rendezvous and collectives


def choose_backend(hosts: list[tuple[str, int]]) -> str:
    """The backend rule over (host name, GPU count) of every rank."""
    ranks_on = collections.Counter(host for host, _ in hosts)
    if all(n_gpus > 0 and ranks_on[host] <= n_gpus for host, n_gpus in hosts):
        return "nccl"
    return "gloo"


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> dict | None:
    """Join the run's process group: from the multi-host flags when any
    is given, else from torchrun's environment.  Returns the summary dict
    (process index and count, local and global devices, backend, device),
    or None for a single process, which runs without a group."""
    flags = (coordinator_address, num_processes, process_id)
    if any(f is not None for f in flags):
        if any(f is None for f in flags):
            raise ValueError("--coordinator-address, --num-processes and --process-id "
                             "go together")
        if not 0 <= process_id < num_processes:
            raise ValueError(f"--process-id {process_id} outside [0, {num_processes})")
        host, _, port = coordinator_address.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"--coordinator-address {coordinator_address!r} is not host:port")
        world, rank = num_processes, process_id
        if world == 1:
            return None
        store = dist.TCPStore(host, int(port), world, is_master=rank == 0, timeout=TIMEOUT)
        store.set(f"spydrpick/host/{rank}", f"{socket.gethostname()} {gpu_count()}")
        hosts = []
        for r in range(world):
            name, n_gpus = store.get(f"spydrpick/host/{r}").decode().rsplit(" ", 1)
            hosts.append((name, int(n_gpus)))
        backend = choose_backend(hosts)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                                timeout=TIMEOUT)
    elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
        world = int(os.environ["WORLD_SIZE"])
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        backend = choose_backend([("host", gpu_count())] * per_host)
        dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
    else:
        return None
    device = default_device()
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "local_devices": 1,
        "global_devices": dist.get_world_size(),
        "backend": backend,
        "device": str(device),
    }


def world_size() -> int:
    """Processes in the run: 1 without a process group."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_writer() -> bool:
    """Whether this process writes the run's files: rank 0 only, since
    every rank ends with the same results."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def shutdown() -> None:
    """Leave the process group, if any."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
