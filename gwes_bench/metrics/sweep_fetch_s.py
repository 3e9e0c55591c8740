"""sweep_fetch_s: the sweep's edges brought to the host per scan: the
mean over the window's scans of the program's span ``sweep.fetch``.  On
one card the copy of the store's edges and colmax to the host; in a run
of several ranks (rank 0's span) the colmax all-reduce and the all-gather
of every rank's edge store too, with the wait for the slowest rank's
rows.  None when a scan lacks the span."""

from gwes_bench.program_spans import mean_span


def read(run):
    return mean_span(run, "sweep.fetch")
