"""Tournament-style MI save-threshold estimation (copy of the rules in
spydrpick_tpu/engine/threshold.py:33-135, SpydrPick.hpp:171-343).

  * target count: ``--mi-values``, else ``min(1e7, 100 * n_loci)``;
  * percentile = 1 - n_values / possible_pairs;
  * sample size: from 100k, +10k while the tail above the percentile
    holds < 100 values, cap 500k, never above possible_pairs / 10;
  * each iteration samples unique (i < j) pairs from one seeded numpy
    stream and takes the ascending order statistic at
    ``floor(percentile * pairs)``; the threshold is the lower median of
    the iterations.

The draws overlap the device work: one worker thread makes them, in
order, from the one generator, while the caller's thread launches each
chunk of the pairs drawn so far (``MIEngine.pair_quantiles``).  The
stream and its chunks are those of drawing every iteration first, so the
threshold is the same bit for bit.  Spans (``utils/profiling.py``):
draw (the worker's seconds in ``sample_pairs``, one per iteration, on
the thread "draws_0") and wait_draws (the caller's thread blocked on a
draw, one per iteration): the two say which of them sets the stage's
pace.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from spydrpick_torch.utils.profiling import count, current_path, span


def determine_threshold_pairs(threshold_pairs: int, possible_pairs: int,
                              threshold_percentile: float) -> int:
    """Auto sample size (SpydrPick.hpp:257-282)."""
    if threshold_pairs == 0:
        threshold_pairs = 100_000
        desired_tail = 100
        cap = 500_000
        while (
            threshold_pairs - threshold_percentile * threshold_pairs < desired_tail
            and threshold_pairs < cap
        ):
            threshold_pairs += 10_000
    if possible_pairs // 10 < threshold_pairs:
        threshold_pairs = possible_pairs // 10
    return threshold_pairs


def sample_pairs(rng: np.random.Generator, n_pairs: int,
                 n_loci: int) -> tuple[np.ndarray, np.ndarray]:
    """Unique uniform (i < j) pairs from a seeded generator."""
    collected = np.empty(0, dtype=np.int64)
    while len(collected) < n_pairs:
        need = n_pairs - len(collected)
        a = rng.integers(0, n_loci, size=int(need * 1.3) + 16)
        b = rng.integers(0, n_loci, size=len(a))
        ok = a != b
        a, b = a[ok], b[ok]
        keys = np.minimum(a, b) * n_loci + np.maximum(a, b)
        new = np.setdiff1d(keys, collected)
        collected = np.concatenate([collected, new])
    collected = rng.permutation(collected)[:n_pairs]
    return collected // n_loci, collected % n_loci


def determine_mi_threshold(engine, n_values: int, threshold_pairs: int = 0,
                           iterations: int = 10, seed: int = 42,
                           verbose_out=None) -> float:
    """Estimate the MI save threshold; ``engine`` is a
    spydrpick_torch.engine.solver.MIEngine.  The counter pairs_drawn counts
    the pairs drawn."""
    thresholds, _ = _tournament(engine, n_values, threshold_pairs, iterations, seed,
                                verbose_out)
    if verbose_out is not None:
        for it, t in enumerate(thresholds):
            print(f"spydrpick-torch: {it + 1:2d}/{iterations} threshold "
                  f"sample = {t:.6f}", file=verbose_out)
    thresholds = np.asarray(thresholds)
    n = len(thresholds)
    median_idx = n // 2 - (0 if n % 2 else 1)  # lower median (SpydrPick.hpp:339)
    return float(np.partition(thresholds, median_idx)[median_idx])


def _tournament(engine, n_values: int, threshold_pairs: int, iterations: int, seed: int,
                verbose_out) -> tuple[np.ndarray, int]:
    """(each iteration's threshold, pairs per iteration)."""
    n_loci = engine.L
    possible_pairs = n_loci * (n_loci - 1) // 2
    percentile = 1.0 - float(n_values) / possible_pairs
    pairs_n = determine_threshold_pairs(threshold_pairs, possible_pairs, percentile)
    if pairs_n <= 0 or percentile <= 0.0:
        raise ValueError(
            f"alignment too small for threshold estimation ({possible_pairs} possible "
            f"pairs <= {n_values} target values); set --mi-threshold explicitly "
            "(e.g. --mi-threshold 0 to keep all pairs)"
        )
    threshold_idx = min(int(percentile * pairs_n), pairs_n - 1)

    if verbose_out is not None:
        print(f" ({pairs_n} pairs * {iterations} iterations)", file=verbose_out)

    rng = np.random.default_rng(seed)
    parent = current_path()

    def draw():
        with span("draw", parent=parent):
            out = sample_pairs(rng, pairs_n, n_loci)
        count("pairs_drawn", pairs_n)
        return out

    def arrived(draws):
        for d in draws:
            with span("wait_draws"):
                got = d.result()
            yield got

    # one worker: the iterations are drawn in order, as one stream
    with ThreadPoolExecutor(max_workers=1, thread_name_prefix="draws") as pool:
        draws = [pool.submit(draw) for _ in range(iterations)]
        try:
            thresholds = engine.pair_quantiles(arrived(draws), iterations, pairs_n,
                                               threshold_idx)
        finally:
            for d in draws:
                d.cancel()
    return thresholds, pairs_n


def default_mi_values(n_loci: int, mi_values_flag: int) -> int:
    """--mi-values resolution (src/SpydrPick.cpp:338-339)."""
    if mi_values_flag != 0:
        return mi_values_flag
    return min(10_000_000, 100 * n_loci)
