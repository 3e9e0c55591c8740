"""write_gb_per_s: the three writers' rate per scan: the bytes they
handed their files (the program's counters ``bytes_written.*``) over the
seconds of its span ``write``, in 10^9 bytes a second; the mean over the
window's scans.  None when a scan lacks the span or the counters."""

from gwes_bench.program_spans import span_seconds


def read(run):
    rates = []
    for tm in run.scans:
        t = span_seconds(tm, "write")
        written = [n for k, n in tm.get("counters", {}).items()
                   if k.startswith("bytes_written.")]
        if not t or not written:
            return None
        rates.append(sum(written) / t / 1e9)
    return sum(rates) / len(rates) if rates else None
