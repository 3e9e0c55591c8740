"""Position (column) filtering.

Reference semantics (apegrunt ``Alignment_filter`` consumed at
src/SpydrPick.cpp:244-245; rule documented in reference README.md:49):
keep positions with

  * *more than one* non-gap allele present,
  * second-most-frequent (non-gap) allele frequency >= ``maf_threshold``
    (default 0.01),
  * gap frequency <= ``gap_threshold`` (default 0.15).

Frequencies are unweighted (filtering runs before sample reweighting in
the reference pipeline, src/SpydrPick.cpp:244 vs :321) and are taken
relative to the total number of samples.

The rule runs in float64 on the host over the (L, 5) counts of
``Alignment.state_counts``; in a run with the codes on a card those are
the card's counts (``ops/columns.py``), fetched once, so no host pass over
the codes remains.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from spydrpick_torch.core.alignment import Alignment
from spydrpick_torch.core.alphabet import GAP_STATE

DEFAULT_MAF_THRESHOLD = 0.01
DEFAULT_GAP_THRESHOLD = 0.15


@dataclasses.dataclass(frozen=True)
class FilterParams:
    maf_threshold: float = DEFAULT_MAF_THRESHOLD
    gap_threshold: float = DEFAULT_GAP_THRESHOLD


def filter_mask(alignment: Alignment, params: FilterParams = FilterParams()) -> np.ndarray:
    """(n_loci,) bool mask of columns that pass the filter."""
    counts = alignment.state_counts.astype(np.float64)  # (L, 5)
    n = alignment.n_samples
    nongap = counts[:, :GAP_STATE]  # (L, 4)

    n_alleles = np.count_nonzero(nongap > 0, axis=1)
    # second-most-frequent non-gap allele count
    sorted_counts = np.sort(nongap, axis=1)  # ascending
    second = sorted_counts[:, -2]
    gap_freq = counts[:, GAP_STATE] / n

    return (
        (n_alleles > 1)
        & (second / n >= params.maf_threshold)
        & (gap_freq <= params.gap_threshold)
    )


def filter_list(alignment: Alignment, params: FilterParams = FilterParams()) -> np.ndarray:
    """Indices of columns passing the filter (apegrunt ``get_filter_list``)."""
    return np.flatnonzero(filter_mask(alignment, params))
