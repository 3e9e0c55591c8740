"""parse_s: the FASTA parse per scan (its read, the pinned allocation of
the codes and their decode, and the mappings list): the mean over the
window's scans of the program's span ``lead_in.parse``
(``run_pipeline(timings=)["spans"]``).  None when a scan lacks the span
(a program without spans)."""

from gwes_bench.program_spans import mean_span


def read(run):
    return mean_span(run, "lead_in.parse")
