"""Outlier / extreme-outlier thresholds from per-position max MI (copy of
spydrpick_tpu/engine/outliers.py, which cannot be imported without jax).

  * positions that never see a pair past the LD distance keep -inf in the
    sweep; the quartiles map it back to float64 ``lowest()``, as the
    reference's empty boost max accumulator does;
  * quartile Q is ``sorted(colmax)[n // 4 * Q]`` (an indexing quartile,
    mi.hpp:267-281);
  * outlier threshold = Q3 + 1.5 IQR, extreme = Q3 + 3.0 IQR
    (SpydrPick.hpp:151-152).
"""

from __future__ import annotations

import numpy as np


def quartile(colmax: np.ndarray, q: int) -> float:
    vals = np.sort(np.where(np.isneginf(colmax),
                            np.finfo(np.float64).min, colmax))
    return float(vals[len(vals) // 4 * q])


def outlier_thresholds(colmax: np.ndarray) -> tuple[float, float]:
    q1 = quartile(colmax, 1)
    q3 = quartile(colmax, 3)
    iqr = q3 - q1
    return q3 + 1.5 * iqr, q3 + 3.0 * iqr
