"""k1_roofline_share: kernel K1, the sweep's MI tile (``mi_tile_single``,
csrc/xtab_mma.cu), against its roofline.

Work: one weighted 5 x 5 crosstable for each column pair of the upper
triangle, 2 * 25 * S operations per pair, at the card's int8 dense peak
(``gwes_bench/peaks.py``).  The bytes (the codes read once, the edges
written once) put the bound on the operations' side.  The count is set by
S and L alone: passes, tiles, padding and rows swept again after a store
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


def read(run):
    if run.trace is None:
        return None
    t = sum(s for name, s in run.trace.kernel_s.items() if PATTERN.search(name))
    rate = peak(run.device_name, "int8_ops_per_s")
    if t <= 0 or rate is None:
        return None
    return 100.0 * k1_ops(run.samples, run.loci) * len(run.scans) / rate / t
