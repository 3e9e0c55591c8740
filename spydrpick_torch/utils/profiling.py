"""The port's spans and counters, and ``--profile-dir``.

A recording (``recording(into)``; ``run_pipeline`` enters one for a
whole scan) collects into the dict ``into``:

  * ``"spans"``: ``span(name)`` times a part of the work; when it closes
    it appends {"path", "start", "end", "thread"}: its path dotted from
    the root (``"lead_in.parse.read"``: the path names its parents), its
    start and end in seconds from the recording's start
    (``time.perf_counter_ns``) and its thread ("main" for the thread that
    entered the recording, else the thread's name).  The recording itself
    closes as the span ``scan``.
  * ``"counters"``: ``count(name, n)`` adds the host integer n.
  * ``"scan"``: a process-wide sequence number, shared by every span of
    the recording.

With no recording active, ``span`` returns one shared null context after
one check and ``count`` returns at once; nothing is allocated.  While
torch.profiler records, each span also enters
``torch.profiler.record_function("spydrpick:" + path)``, so the spans lie
in the profiler's trace on the clock of the kernels and copies.  No span
or counter reads a device value or waits for the device: a span around
device work that is only enqueued times the host's call.

``profile_trace`` is ``--profile-dir``: a torch.profiler trace of the
enclosed region (the whole scan) with the recording's spans and counters
beside it.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time

import torch

PREFIX = "spydrpick:"
SCAN = "scan"  # the recording's own span, around the root spans
_NULL = contextlib.nullcontext()
_active: "_Recording | None" = None
_scans = itertools.count(1)


class _Recording:
    def __init__(self, into: dict):
        self.spans = into.setdefault("spans", [])
        self.counters = into.setdefault("counters", {})
        self.lock = threading.Lock()
        self.local = threading.local()
        self.owner = threading.get_ident()
        self.t0 = time.perf_counter_ns()

    def stack(self) -> list:
        """The calling thread's open span paths, innermost last."""
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = []
            return self.local.stack

    def path(self) -> str:
        """The calling thread's innermost open span path, "" at the root."""
        stack = self.stack()
        return stack[-1] if stack else ""

    def add(self, path: str, start_ns: int, end_ns: int) -> None:
        t = threading.current_thread()
        record = {"path": path, "start": (start_ns - self.t0) * 1e-9,
                  "end": (end_ns - self.t0) * 1e-9,
                  "thread": "main" if t.ident == self.owner else t.name}
        with self.lock:
            self.spans.append(record)


class _Span:
    __slots__ = ("rec", "path", "start", "end", "_rf")

    def __init__(self, rec: _Recording, name: str, parent: str | None):
        self.rec = rec
        if parent is None:
            parent = rec.path()
        self.path = f"{parent}.{name}" if parent else name
        self._rf = None

    def __enter__(self) -> "_Span":
        self.rec.stack().append(self.path)
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(PREFIX + self.path)
            self._rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self.rec.stack().pop()
        self.rec.add(self.path, self.start, self.end)

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9


def span(name: str, parent: str | None = None):
    """A context manager timing the enclosed work as the span ``name``,
    a child of the calling thread's innermost open span, or of the path
    ``parent`` when given (a worker thread's spans); yields the span
    (its ``path``; ``seconds`` once closed), or None with no recording."""
    rec = _active
    if rec is None:
        return _NULL
    return _Span(rec, name, parent)


def count(name: str, n: int = 1) -> None:
    """Add the host integer ``n`` to the counter ``name``."""
    rec = _active
    if rec is None:
        return
    with rec.lock:
        rec.counters[name] = rec.counters.get(name, 0) + int(n)


def current_path() -> str | None:
    """The calling thread's innermost open span path ("" at the root), or
    None with no recording: the ``parent`` of a worker's spans."""
    rec = _active
    return None if rec is None else rec.path()


@contextlib.contextmanager
def recording(into: dict | None):
    """Record the block's spans and counters into ``into`` (module
    docstring), closing as the span ``scan``; with ``into`` None, nothing.
    Recordings do not nest."""
    global _active
    if into is None:
        yield
        return
    if _active is not None:
        raise RuntimeError("a recording is already active")
    rec = _Recording(into)
    into["scan"] = next(_scans)
    _active = rec
    try:
        with (torch.profiler.record_function(PREFIX + SCAN)
              if torch.autograd._profiler_enabled() else _NULL):
            yield
    finally:
        rec.add(SCAN, rec.t0, time.perf_counter_ns())
        _active = None


def seconds(spans: list, path: str) -> float:
    """The summed seconds of the spans at ``path``."""
    return sum((s["end"] - s["start"] for s in spans if s["path"] == path), 0.0)


def summary(spans: list) -> dict:
    """{path: {"count", "seconds", "self_seconds"}}: a span's self time is
    its duration less its direct children's on its thread (which do not
    overlap one another); the root spans are the children of ``scan``."""
    def parent(path: str) -> str:
        return path.rpartition(".")[0] or (SCAN if path != SCAN else "")

    out: dict = {}
    for s in spans:
        kids = sum(c["end"] - c["start"] for c in spans
                   if c["thread"] == s["thread"] and parent(c["path"]) == s["path"]
                   and s["start"] <= c["start"] and c["end"] <= s["end"])
        p = out.setdefault(s["path"], {"count": 0, "seconds": 0.0, "self_seconds": 0.0})
        p["count"] += 1
        p["seconds"] += s["end"] - s["start"]
        p["self_seconds"] += s["end"] - s["start"] - kids
    return out


@contextlib.contextmanager
def profile_trace(trace_dir: str | None, record: dict | None = None):
    """Profile the enclosed region when ``trace_dir`` is set: host ops and,
    on a GPU, the CUDA kernels and copies, written as the Chrome/Perfetto
    trace ``scan_trace.json``, the per-op table ``scan_kernels.txt`` and,
    from ``record`` (a recording's dict, closed inside the region), the
    spans, their per-path summary and the counters as ``scan_spans.json``."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "scan_trace.json"))
    sort_key = "cuda_time_total" if torch.cuda.is_available() else "cpu_time_total"
    with open(os.path.join(trace_dir, "scan_kernels.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort_key, row_limit=40))
    if record is not None:
        spans = record.get("spans", [])
        with open(os.path.join(trace_dir, "scan_spans.json"), "w") as f:
            json.dump({"scan": record.get("scan"), "counters": record.get("counters", {}),
                       "paths": summary(spans), "spans": spans}, f, indent=1)
