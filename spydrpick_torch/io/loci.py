"""Whitespace-delimited index / value list parsers.

Replaces apegrunt ``parse_Loci_list`` (src/SpydrPick.cpp:198,219,306)
and ``ValueVector_parser`` (src/SpydrPick.cpp:34, for --sample-weights).
"""

from __future__ import annotations

import os

import numpy as np


def parse_loci_list(path: str | os.PathLike, indexing_base: int = 0) -> np.ndarray:
    """Parse a whitespace-delimited list of position indices.

    ``indexing_base`` (``--input-indexing-base``) is subtracted so the
    result is 0-based internally.
    """
    with open(path) as f:
        vals = np.array([int(tok) for tok in f.read().split()], dtype=np.int64)
    return vals - indexing_base


def parse_value_list(path: str | os.PathLike) -> np.ndarray:
    """Parse a whitespace-delimited list of float values (sample weights)."""
    with open(path) as f:
        return np.array([float(tok) for tok in f.read().split()], dtype=np.float64)
