"""Genome distance functors.

Reference: apegrunt ``LinearDistance`` / ``CircularDistance`` /
``GenomeDistance<D>`` (consumed at include/mi.hpp:313-320,
include/SpydrPick.hpp:69-87, src/SpydrPick.cpp:440-447).  Circular
distance wraps at the genome size (``n_original_positions`` or
``--genome-size``): d(a,b) = min(|a-b|, G - |a-b|).

These operate on *original* genome positions; the engine composes them
with the filtered->original loci translation.
"""

from __future__ import annotations

import numpy as np


def linear_distance(a, b):
    return np.abs(np.asarray(a, dtype=np.int64) - np.asarray(b, dtype=np.int64))


def circular_distance(a, b, genome_size: int):
    d = linear_distance(a, b)
    return np.minimum(d, genome_size - d)


def genome_distance(a, b, genome_size: int, linear: bool):
    return linear_distance(a, b) if linear else circular_distance(a, b, genome_size)
