"""Version info and the run banner (counterpart of spydrpick_tpu/version.py)."""

__version__ = "0.1.0"

TITLE = "spydrpick-torch: MI-ARACNE genome-wide co-evolution analysis on PyTorch/CUDA"


def version_string() -> str:
    """Banner: package version, then the torch version, the CUDA runtime
    torch was built for, the device the run resolves to (or that no CUDA
    device is visible: the banner never raises) and, in a run of several
    processes, this process's rank, the process count and the collective
    backend (the JAX banner reports the jax/jaxlib versions and backend
    instead)."""
    import torch
    import torch.distributed as dist

    from spydrpick_torch.device import DEVICE_ENV, cpu_requested, default_device

    parts = [f"spydrpick-torch version {__version__}", f"torch {torch.__version__}",
             f"CUDA {torch.version.cuda or 'none'}"]
    if cpu_requested():
        dev = torch.device("cpu")
        parts.append(f"cpu device ({DEVICE_ENV}=cpu: plain PyTorch kernels)")
    elif torch.cuda.is_available():
        dev = default_device()
        parts.append(f"cuda device ({torch.cuda.device_count()}x "
                     f"{torch.cuda.get_device_name(dev)})")
    else:
        dev = None
        parts.append("no CUDA device")
    if dev is not None and dist.is_available() and dist.is_initialized():
        parts.append(f"rank {dist.get_rank()} of {dist.get_world_size()} on "
                     f"{dev} ({dist.get_backend()} backend)")
    return " | ".join(parts)
