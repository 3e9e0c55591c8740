"""The traced window: torch.profiler over the window's scans, and what is
read from its trace.

``profile_window(fn, work_dir)`` runs ``fn`` inside a ``record_function``
span named WINDOW under torch.profiler (host ops and CUDA activity),
synchronizes the device before the span ends, writes the Chrome trace
into ``work_dir``, reads it and deletes it.  ``read_trace`` takes from the
trace's events, inside the span:

  * the device intervals: every event of the categories kernel,
    gpu_memcpy and gpu_memset, clipped to the span;
  * busy_s: the length of their union (overlapping work counts once),
    and window_s, the span's length;
  * kernel_s: each device operation's summed seconds, by name;
  * gaps: the device's idle intervals inside the span, the longest ones
    named by what the host was doing in their middle: the innermost
    stage span of ``stage_spans`` and the innermost host op of the span's
    thread.

``stage_spans()`` wraps the calls into the program's stages with
``record_function`` spans named ``stage:<name>`` while the window is
traced, and takes the wrappers off afterwards; a stage the program no
longer has is left out.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib
import json
import os
from collections import defaultdict

WINDOW = "gwes_bench:window"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation")
# (module, attribute path, stage name): the calls of run_pipeline's stages
STAGES = (
    ("spydrpick_torch.pipeline", "load_and_preprocess", "lead_in"),
    ("spydrpick_torch.pipeline", "MIEngine.__init__", "engine_build"),
    ("spydrpick_torch.pipeline", "determine_mi_threshold", "tournament"),
    ("spydrpick_torch.engine.solver", "MIEngine.sweep", "sweep"),
    ("spydrpick_torch.engine.solver", "EdgeSet.sorted_on", "sort"),
    ("spydrpick_torch.pipeline", "aracne_flags", "aracne"),
    ("spydrpick_torch.pipeline", "_write_outputs", "write"),
)
TOP = 10


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_s: dict
    gaps: list          # [(name, seconds)], longest first, at most TOP


def _wrap(fn, name: str):
    from torch.profiler import record_function

    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        with record_function(f"stage:{name}"):
            return fn(*args, **kwargs)
    return spanned


@contextlib.contextmanager
def stage_spans():
    undo = []
    try:
        for module, path, name in STAGES:
            try:
                owner = importlib.import_module(module)
                *parents, attr = path.split(".")
                for p in parents:
                    owner = getattr(owner, p)
                fn = getattr(owner, attr)
            except (ImportError, AttributeError):
                continue
            setattr(owner, attr, _wrap(fn, name))
            undo.append((owner, attr, fn))
        yield
    finally:
        for owner, attr, fn in reversed(undo):
            setattr(owner, attr, fn)


def profile_window(fn, work_dir: str):
    """(fn's result, its Trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with stage_spans(), profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            out = fn()
            torch.cuda.synchronize()
    path = os.path.join(work_dir, "window_trace.json")
    prof.export_chrome_trace(path)
    del prof
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return out, read_trace(events)


def device_intervals(events: list, lo: float, hi: float) -> list:
    """(start, end, name) in microseconds of every device event clipped
    to [lo, hi]; events wholly outside are dropped."""
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        a, b = max(float(e["ts"]), lo), min(float(e["ts"]) + float(e["dur"]), hi)
        if b > a:
            out.append((a, b, e.get("name", "")))
    return out


def merged(intervals) -> list:
    """The union of (start, end, ...) intervals as sorted disjoint spans."""
    spans = []
    for a, b, *_ in sorted(intervals):
        if spans and a <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], b)
        else:
            spans.append([a, b])
    return spans


def read_trace(events: list) -> Trace:
    region = [e for e in events if e.get("name") == WINDOW
              and e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    if len(region) != 1:
        raise RuntimeError(f"{len(region)} window spans in the trace")
    lo = float(region[0]["ts"])
    hi = lo + float(region[0]["dur"])
    iv = device_intervals(events, lo, hi)
    if not iv:
        raise RuntimeError("the trace holds no device event in the window")
    kernel_s: dict = defaultdict(float)
    for a, b, name in iv:
        kernel_s[name] += (b - a) * 1e-6
    spans = merged(iv)
    busy = sum(b - a for a, b in spans)
    edges = [lo] + [x for s in spans for x in s] + [hi]
    gaps = sorted(((edges[k + 1] - edges[k], edges[k]) for k in range(0, len(edges), 2)
                   if edges[k + 1] > edges[k]), reverse=True)[:TOP]
    tid = region[0].get("tid")
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATEGORIES
            and e.get("tid") == tid and e.get("name") != WINDOW
            and float(e["ts"]) < hi and float(e["ts"]) + float(e["dur"]) > lo]
    named = [(_host_name(host, start + length / 2), length * 1e-6) for length, start in gaps]
    return Trace(window_s=(hi - lo) * 1e-6, busy_s=busy * 1e-6, kernel_s=dict(kernel_s),
                 gaps=named)


def _host_name(host: list, t: float) -> str:
    """What the host did at time t: 'stage / op', from the innermost
    stage span and the innermost other host event covering t."""
    stage, op = None, None
    for e in host:
        a = float(e["ts"])
        if not a <= t <= a + float(e["dur"]):
            continue
        name = e.get("name", "")
        if name.startswith("stage:"):
            if stage is None or a > stage[0]:
                stage = (a, name[6:])
        elif op is None or a > op[0]:
            op = (a, name)
    parts = [x[1] for x in (stage, op) if x is not None]
    return " / ".join(parts) if parts else "host (no op traced)"
