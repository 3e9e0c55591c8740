"""draws_wait_s: the tournament's launching thread waiting on its draws
worker per scan: the mean over the window's scans of the summed program
spans ``tournament.wait_draws`` (one per iteration).  None when a scan
lacks the span (a program without spans, or a fixed threshold)."""

from gwes_bench.program_spans import mean_span


def read(run):
    return mean_span(run, "tournament.wait_draws")
