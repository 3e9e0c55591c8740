"""``--profile-dir``: a torch.profiler trace of the sweep (counterpart of
spydrpick_tpu/utils/profiling.py, which wraps jax.profiler).

The trace records host ops and, on a GPU, the CUDA kernels; it is written
as a Chrome/Perfetto JSON file ``sweep_trace.json`` in the directory, with
the per-kernel summary table beside it as ``sweep_kernels.txt``.
"""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def profile_trace(trace_dir: str | None):
    """Profile the enclosed region when ``trace_dir`` is set."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "sweep_trace.json"))
    sort_key = "cuda_time_total" if torch.cuda.is_available() else "cpu_time_total"
    with open(os.path.join(trace_dir, "sweep_kernels.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort_key, row_limit=40))


# trace categories of work on the device (kineto's Chrome trace)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def device_intervals(events: list[dict], lo: float = float("-inf"),
                     hi: float = float("inf")) -> list[tuple[float, float, str]]:
    """(start, end, name) in microseconds of every device event of a
    Chrome trace's ``traceEvents``, clipped to [lo, hi]; events wholly
    outside are dropped."""
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        a, b = max(float(e["ts"]), lo), min(float(e["ts"]) + float(e["dur"]), hi)
        if b > a:
            out.append((a, b, e.get("name", "")))
    return out


def busy_union(intervals) -> float:
    """Length of the union of (start, end, ...) intervals: the time the
    device was busy, with overlapping work (streams, copy engines)
    counted once."""
    busy, cur_a, cur_b = 0.0, None, None
    for a, b, *_ in sorted(intervals):
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy += cur_b - cur_a
    return busy
