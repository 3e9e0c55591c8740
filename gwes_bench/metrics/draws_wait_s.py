"""draws_wait_s: the tournament's launching thread waiting on its draws
worker per scan: the mean over the window's scans of the summed program
spans ``tournament.wait_draws`` (one per iteration).  A scan with a held
``--mi-threshold`` runs no tournament, draws nothing and waits for
nothing: it counts 0 s, known by a recording with spans but none under
``tournament.`` and no ``pairs_drawn`` counted.  None when any other scan
lacks the span (a program without spans, or a tournament that drew
without it)."""

from gwes_bench.program_spans import span_seconds


def _seconds(tm: dict) -> float | None:
    t = span_seconds(tm, "tournament.wait_draws")
    spans = tm.get("spans") or ()
    held = (spans and not tm.get("counters", {}).get("pairs_drawn")
            and not any(s.get("path", "").startswith("tournament.") for s in spans))
    return 0.0 if t is None and held else t


def read(run):
    per_scan = [_seconds(tm) for tm in run.scans]
    if not per_scan or any(t is None for t in per_scan):
        return None
    return sum(per_scan) / len(per_scan)
