"""What the per-layer readers take from the program's spans: a
scan's timings hold ``"spans"``, each {"path", "start", "end", "thread"}
in seconds (``spydrpick_torch/utils/profiling.py``)."""


def span_seconds(tm: dict, path: str) -> float | None:
    """The summed seconds of a scan's spans at ``path``; None when it has
    none."""
    got = [s["end"] - s["start"] for s in tm.get("spans", ()) if s.get("path") == path]
    return sum(got) if got else None


def mean_span(run, path: str) -> float | None:
    """The mean over the run's scans of ``span_seconds``; None when a scan
    lacks the span."""
    per_scan = [span_seconds(tm, path) for tm in run.scans]
    if not per_scan or any(t is None for t in per_scan):
        return None
    return sum(per_scan) / len(per_scan)
