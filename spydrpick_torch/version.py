"""Version info and the run banner (counterpart of spydrpick_tpu/version.py)."""

__version__ = "0.1.0"

TITLE = "spydrpick-torch: MI-ARACNE genome-wide co-evolution analysis on PyTorch/CUDA"


def version_string() -> str:
    """Banner: package version, then the torch version, the CUDA runtime
    torch was built for, the device the run resolves to and, in a run of
    several processes, this process's rank, the process count and the
    collective backend (the JAX banner reports the jax/jaxlib versions
    and backend instead)."""
    import torch
    import torch.distributed as dist

    from spydrpick_torch.device import default_device

    dev = default_device()
    parts = [f"spydrpick-torch version {__version__}", f"torch {torch.__version__}",
             f"CUDA {torch.version.cuda or 'none'}"]
    if dev.type == "cuda":
        parts.append(f"cuda device ({torch.cuda.device_count()}x "
                     f"{torch.cuda.get_device_name(dev)})")
    else:
        parts.append("cpu device (plain PyTorch kernels)")
    if dist.is_available() and dist.is_initialized():
        parts.append(f"rank {dist.get_rank()} of {dist.get_world_size()} on "
                     f"{dev} ({dist.get_backend()} backend)")
    return " | ".join(parts)
