"""peak_device_gib: torch.cuda.max_memory_allocated over the window's
scans (reset after the warm-up scan), in GiB."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
