"""The bench alignment of ``chip_smoke.py`` (``bench_alignment``) on the
CPU: the draws of ``bench.py``'s generator, which chip_smoke's pinned
``MAIN_OUTPUTS`` digests depend on."""

import numpy as np
import pytest

from chip_smoke import bench_alignment


def replay(S, L, unit_weights):
    """bench.py:158-191's numpy calls, literally."""
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=(S, L)).astype(np.uint8)
    codes[rng.random((S, L)) < 0.05] = 4
    weights = None if unit_weights else rng.random(S) * 0.9 + 0.1
    ii = rng.integers(0, L, 20000)
    jj = rng.integers(0, L, 20000)
    keep = ii != jj
    return codes, weights, np.minimum(ii, jj)[keep], np.maximum(ii, jj)[keep]


@pytest.mark.parametrize("unit_weights", [False, True])
def test_data_replays_bench_py(unit_weights):
    """The codes, weights and threshold pairs are bench.py's draws, with
    and without BENCH_UNIT_WEIGHTS=1 (which draws no weights, so the pairs
    come from another state of the generator); callers with a seed get
    the weighted codes and weights of ``default_rng(seed)``."""
    S, L = 300, 700
    rng = np.random.default_rng(0)
    codes, weights = bench_alignment(S, L, rng=rng, weighted=not unit_weights)
    ii, jj = rng.integers(0, L, 20000), rng.integers(0, L, 20000)
    keep = ii != jj
    got = codes, weights, np.minimum(ii, jj)[keep], np.maximum(ii, jj)[keep]
    for g, w in zip(got, replay(S, L, unit_weights)):
        assert (g is None and w is None) or np.array_equal(g, w)
    codes, w = bench_alignment(S, L, seed=0)
    weighted = replay(S, L, False)
    assert np.array_equal(codes, weighted[0]) and np.array_equal(w, weighted[1])
