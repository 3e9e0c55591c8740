"""sweep_pairs_per_s: the column pairs L(L-1)/2 of every scan over the
scans' summed sweep_s; comparable across widths."""


def read(run):
    if not run.scans or any("sweep_s" not in tm for tm in run.scans):
        return None
    total = sum(tm["sweep_s"] for tm in run.scans)
    return run.loci * (run.loci - 1) / 2 * len(run.scans) / total if total > 0 else None
