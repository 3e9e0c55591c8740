"""weights_s: the sample weights per scan (the S x S identity products
and their host read): the mean over the window's scans of the program's
span ``lead_in.weights``.  None when a scan lacks the span."""

from gwes_bench.program_spans import mean_span


def read(run):
    return mean_span(run, "lead_in.weights")
