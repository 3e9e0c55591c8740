"""Sample weights, MI math, threshold rules and outlier fences of the
PyTorch port against the JAX package, on the CPU."""

import os

import numpy as np
import pytest
import torch

from spydrpick_tpu.core import weights as jax_weights
from spydrpick_tpu.engine import outliers as jax_outliers
from spydrpick_tpu.engine import threshold as jax_threshold
from spydrpick_tpu.engine.solver import EngineConfig as JaxConfig
from spydrpick_tpu.engine.solver import MIEngine as JaxEngine
from spydrpick_tpu.ops.mi import mi_from_crosstabs as jax_mi_from_crosstabs
from spydrpick_tpu.pipeline import PipelineOptions as JaxOptions
from spydrpick_tpu.pipeline import load_and_preprocess as jax_load
from spydrpick_torch.core import weights
from spydrpick_torch.engine import outliers, threshold
from spydrpick_torch.engine.solver import EngineConfig, MIEngine
from spydrpick_torch.ops.mi import mi_from_crosstabs
from spydrpick_torch.pipeline import PipelineOptions, load_and_preprocess

from tests.conftest import random_alignment
from tests.golden.make_golden import GOLDEN2_ARGS

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.fixture(autouse=True, scope="module")
def cpu_device():
    """These runs ask for the CPU, as a CLI run on a machine without a GPU
    must (spydrpick_torch/device.py); module-scoped, so that the module's
    fixtures that run the CLI see it too."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPYDRPICK_TORCH_DEVICE", "cpu")
        yield


def duplicated_alignment():
    """Random alignment with near-duplicate samples, so that identity
    clusters (and non-unit weights) exist at the 0.9 threshold."""
    al = random_alignment(n_samples=40, n_loci=300, seed=21, gap_frac=0.1)
    rng = np.random.default_rng(1)
    for dst in range(20, 40):
        row = al.codes[dst - 20].copy()
        flip = rng.random(300) < 0.05
        row[flip] = rng.integers(0, 5, flip.sum())
        al.codes[dst] = row
    return al


@pytest.mark.parametrize("tile", [64, 8192])
def test_sample_match_counts_equal_jax(tile):
    al = duplicated_alignment()
    got = weights.sample_match_counts(al, tile=tile, device="cpu")
    np.testing.assert_array_equal(got, jax_weights.sample_match_counts(al, tile=tile))


@pytest.mark.parametrize("thr", [0.9, 0.5])
def test_weights_and_distance_matrix_equal_jax(thr):
    al = duplicated_alignment()
    w = weights.compute_sample_weights(al, thr, device="cpu")
    np.testing.assert_array_equal(w, jax_weights.compute_sample_weights(al, thr))
    assert (w < 1).any()
    np.testing.assert_array_equal(weights.hamming_distance_matrix(al, device="cpu"),
                                  jax_weights.hamming_distance_matrix(al))


def test_sample_pairs_and_threshold_rules_identical():
    for args in [(0, 10**6, 0.999), (0, 10**9, 0.99999), (0, 5000, 0.5), (1234, 10**6, 0.9)]:
        assert (threshold.determine_threshold_pairs(*args)
                == jax_threshold.determine_threshold_pairs(*args))
    for n_loci, n in [(50, 300), (1000, 20000)]:
        a = threshold.sample_pairs(np.random.default_rng(3), n, n_loci)
        b = jax_threshold.sample_pairs(np.random.default_rng(3), n, n_loci)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    for args in [(10, 0), (10**6, 0), (100, 77)]:
        assert threshold.default_mi_values(*args) == jax_threshold.default_mi_values(*args)


@pytest.mark.parametrize("case", ["random", "mostly_empty", "few_empty"])
def test_outlier_thresholds_identical(case):
    rng = np.random.default_rng(9)
    colmax = rng.random(101)
    if case == "mostly_empty":
        colmax[:80] = -np.inf
    elif case == "few_empty":
        colmax[:10] = -np.inf
    assert outliers.outlier_thresholds(colmax) == jax_outliers.outlier_thresholds(colmax)


def test_mi_from_crosstabs_matches_jax():
    rng = np.random.default_rng(4)
    C = (rng.random((500, 5, 5)) * 20).astype(np.float32)
    ip = rng.random((500, 5)) < 0.8
    jp = rng.random((500, 5)) < 0.8
    C[~(ip[:, :, None] & jp[:, None, :])] = 0  # counts only where both states occur
    got = mi_from_crosstabs(torch.from_numpy(C), torch.from_numpy(ip.astype(np.float32)),
                            torch.from_numpy(jp.astype(np.float32)), 0.5).numpy()
    want = np.asarray(jax_mi_from_crosstabs(C, ip.astype(np.float32),
                                            jp.astype(np.float32), 0.5))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def golden_alignments():
    """(port alignment, JAX alignment) after each package's own load,
    filter and weights, for both golden fixtures."""
    g1 = dict(alignmentfile=os.path.join(GOLDEN, "golden.fasta"))
    g2 = dict(alignmentfile=os.path.join(GOLDEN, "golden2.fasta"),
              mappings_list=os.path.join(GOLDEN, "golden2.mappings"),
              sample_weights=os.path.join(GOLDEN, "golden2.weights"),
              genome_size=int(GOLDEN2_ARGS[GOLDEN2_ARGS.index("--genome-size") + 1]))
    return [(load_and_preprocess(PipelineOptions(**g)), jax_load(JaxOptions(**g)))
            for g in (g1, g2)]


@pytest.mark.parametrize("fixture", [0, 1])
def test_tournament_threshold_equals_jax_on_golden(fixture):
    al, jal = golden_alignments()[fixture]
    np.testing.assert_array_equal(al.weights, jal.weights)
    port = MIEngine(al, EngineConfig(), device="cpu")
    ref = JaxEngine(jal, JaxConfig(use_pallas="on", wog_fetch="outliers"))
    assert port.statics.int8_mode == ref.statics.int8_mode
    kw = dict(n_values=1500, seed=7, iterations=10)
    got = threshold.determine_mi_threshold(port, **kw)
    want = jax_threshold.determine_mi_threshold(ref, **kw)
    assert round(got, 6) == round(want, 6), (got, want)
