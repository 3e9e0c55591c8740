"""k1_roofline_share: kernel K1, the sweep's MI tile (``mi_tile_single``,
csrc/xtab_mma.cu), against its roofline.

Work: one weighted 5 x 5 crosstable for each column pair i < j that the
traced card swept, 2 * 25 * S operations per pair, at the card's int8
dense peak (``gwes_bench/peaks.py``).  The bytes (the codes read once,
the edges written once) put the bound on the operations' side.  With one
rank the card sweeps every pair of the upper triangle, L(L-1)/2 a scan;
in a run of several ranks the trace is rank 0's, and the pairs are those
of the block-rows that the program dealt rank 0 (``Run.swept_rows``): the
rows i of each, with every j > i.  The count is set by S, L and those
rows alone: passes, tiles, padding and rows swept again after a store
overflow are not work.  Time: the summed device seconds of the traced
window's kernels whose names match PATTERN.  Nothing matches (K1 renamed
or fused): no reading.
"""

import re

from gwes_bench.peaks import peak

PATTERN = re.compile(r"\bmi_tile_mma_kernel\b")


def k1_ops(samples: int, loci: int) -> float:
    """Operations of one sweep's crosstables: 2 * 25 * S per pair i < j."""
    return 2.0 * 25.0 * samples * loci * (loci - 1) / 2.0


def block_row_pairs(loci: int, tile: int, rows) -> int:
    """The pairs i < j of the block-rows starting at ``rows``, each the
    rows [i0, min(i0 + tile, L))."""
    total = 0
    for i0 in rows:
        n = min(i0 + tile, loci) - i0
        total += n * (2 * loci - 2 * i0 - n - 1) // 2
    return total


def read(run):
    if run.trace is None:
        return None
    t = sum(s for name, s in run.trace.kernel_s.items() if PATTERN.search(name))
    rate = peak(run.device_name, "int8_ops_per_s")
    if t <= 0 or rate is None:
        return None
    if run.swept_rows is None:
        return 100.0 * k1_ops(run.samples, run.loci) * len(run.scans) / rate / t
    if len(run.swept_rows) != len(run.scans):
        return None
    pairs = sum(block_row_pairs(run.loci, tile, rows) for tile, rows in run.swept_rows)
    return 100.0 * 2.0 * 25.0 * run.samples * pairs / rate / t
