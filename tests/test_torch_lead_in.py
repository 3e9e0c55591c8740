"""The main path's lead-in of the PyTorch port against the JAX package, on
the CPU: the per-column state counts (``ops/columns.py``), the filter over
them, the codes kept on the device through the lists and the filter
(``Alignment.device_codes``; here a CPU tensor stands for the card's
copy), the pairs' crosstables (``ops/pairs.py``) and
``load_and_preprocess`` as a whole.  The CUDA kernels themselves are held
to these plain versions in tests/test_torch_gpu.py."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spydrpick_tpu.core.alignment import Alignment as JaxAlignment
from spydrpick_tpu.core.filter import FilterParams as JaxFilterParams
from spydrpick_tpu.core.filter import filter_list as jax_filter_list
from spydrpick_tpu.engine.solver import EngineConfig as JaxConfig
from spydrpick_tpu.engine.solver import MIEngine as JaxEngine
from spydrpick_tpu.engine.solver import _pairs_xtab as jax_pairs_xtab
from spydrpick_tpu.io.fasta import read_fasta as jax_read_fasta
from spydrpick_tpu.io.fasta import write_fasta as jax_write_fasta
from spydrpick_tpu.pipeline import PipelineOptions as JaxOptions
from spydrpick_tpu.pipeline import load_and_preprocess as jax_load
from spydrpick_torch.core.alignment import Alignment
from spydrpick_torch.core.filter import FilterParams, filter_list
from spydrpick_torch.engine import threshold
from spydrpick_torch.engine.solver import EngineConfig, MIEngine, pairs_chunk
from spydrpick_torch.ops.columns import column_state_counts, column_state_counts_plain
from spydrpick_torch.ops.pairs import pairs_xtab, pairs_xtab_plain
from spydrpick_torch.pipeline import PipelineOptions, load_and_preprocess
from spydrpick_torch.utils.profiling import recording, seconds

from tests.golden.make_golden import GOLDEN2_ARGS

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
RTOL = 1e-6  # the JAX tables are f32 sums over samples; the port's are exact
F64_EPILOGUE_TOL = 2e-8  # the pairs' MI against float64: the tables' f32 rounding


@pytest.fixture(autouse=True, scope="module")
def cpu_device():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPYDRPICK_TORCH_DEVICE", "cpu")
        yield


def port_alignment(jal, on_device: bool) -> Alignment:
    """The port's Alignment of a JAX one; with ``on_device`` its codes
    also as ``device_codes`` (a CPU tensor in the card's place)."""
    return Alignment(jal.codes.copy(), list(jal.sample_names), jal.id_string,
                     jal.translation.copy(), jal.n_original_positions,
                     None if jal.weights is None else jal.weights.copy(),
                     torch.from_numpy(jal.codes.copy()) if on_device else None)


def padded_random_codes(seed=4, S=70, L=203):
    """Random codes 0..4 with whole pad columns and scattered pad cells
    (code 255, which counts nowhere), L not a multiple of 4."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 5, size=(S, L)).astype(np.uint8)
    codes[:, [0, 77, L - 1]] = 255
    codes[rng.random((S, L)) < 0.02] = 255
    return codes


def fixture_codes(name):
    if name == "random_pad":
        return padded_random_codes()
    return jax_read_fasta(os.path.join(GOLDEN, f"{name}.fasta")).codes


def filter_dropping_alignment(seed=9, S=120, L=240):
    """Codes whose filter drops columns for each of its rules:
    monomorphic, a minor allele below the MAF, too many gaps."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(S, L)).astype(np.uint8)
    codes[:, 10:30] = 2                           # one allele
    codes[:, 40:50] = 1
    codes[0, 40:50] = 3                           # minor allele 1/120 < 0.01
    codes[rng.random((S, L)) < 0.05] = 4
    codes[: S // 3, 60:75] = 4                    # a third gaps > 0.15
    return JaxAlignment(codes, [f"s{k}" for k in range(S)], "drop", np.arange(L) * 3 + 5,
                        3 * L + 10, None)


# ------------------------------------------------------------------ counts

@pytest.mark.parametrize("name", ["golden", "golden2", "random_pad"])
def test_column_counts_plain_equal_jax_state_counts(name):
    codes = fixture_codes(name)
    jal = JaxAlignment(codes, [f"s{k}" for k in range(len(codes))], name,
                       np.arange(codes.shape[1]), codes.shape[1])
    got = column_state_counts_plain(torch.from_numpy(codes))
    assert got.dtype == torch.int32 and got.shape == (codes.shape[1], 5)
    np.testing.assert_array_equal(got.numpy(), jal.state_counts)
    np.testing.assert_array_equal(column_state_counts(torch.from_numpy(codes)).numpy(),
                                  jal.state_counts)
    for on_device in (False, True):
        al = port_alignment(jal, on_device)
        np.testing.assert_array_equal(al.state_counts, jal.state_counts)
        assert al.state_counts.dtype == np.int64
        np.testing.assert_array_equal(al.state_presence, jal.state_presence)
        np.testing.assert_array_equal(al.state_presence_wo_gaps, jal.state_presence_wo_gaps)
        np.testing.assert_array_equal(al.gap_presence, jal.gap_presence)
        assert al.statistics_string() == jal.statistics_string()


# ------------------------------------------------------------------ filter

@pytest.mark.parametrize("params", [(0.01, 0.15), (0.05, 0.2), (0.0, 1.0)])
@pytest.mark.parametrize("fixture", ["golden2", "dropping"])
def test_filter_on_device_codes_matches_jax(fixture, params):
    jal = (filter_dropping_alignment() if fixture == "dropping"
           else jax_read_fasta(os.path.join(GOLDEN, "golden2.fasta")))
    want = jax_filter_list(jal, JaxFilterParams(*params))
    al = port_alignment(jal, on_device=True)
    got = filter_list(al, FilterParams(*params))
    np.testing.assert_array_equal(got, want)
    if fixture == "dropping" and params == (0.01, 0.15):
        assert 0 < len(want) < jal.n_loci - 40  # every rule dropped columns
    sub, jsub = al.subset(got), jal.subset(want)
    assert "codes" not in sub.__dict__  # the host subset waits for a reader
    np.testing.assert_array_equal(sub.device_codes.numpy(), jsub.codes)
    np.testing.assert_array_equal(sub.state_counts, jsub.state_counts)
    np.testing.assert_array_equal(sub.translation, jsub.translation)
    assert (sub.n_samples, sub.n_loci) == (jsub.n_samples, jsub.n_loci)
    np.testing.assert_array_equal(sub.codes, jsub.codes)
    assert sub.codes.flags.c_contiguous


def test_deferred_host_codes_compose():
    """Column and sample subsets of device codes, chained, make the host
    codes of the whole chain on the first read, equal to host subsets."""
    jal = filter_dropping_alignment()
    rng = np.random.default_rng(2)
    cols = np.sort(rng.choice(jal.n_loci, 150, replace=False))
    rows = rng.permutation(jal.n_samples)[:60]
    cols2 = np.array([3, 1, 140, 7])
    al = port_alignment(jal, on_device=True)
    chain = al.subset(cols).subsample(rows).subset(cols2)
    want = jal.subset(cols).subsample(rows).subset(cols2)
    assert "codes" not in chain.__dict__
    np.testing.assert_array_equal(chain.state_counts, want.state_counts)
    np.testing.assert_array_equal(chain.codes, want.codes)
    np.testing.assert_array_equal(chain.device_codes.numpy(), want.codes)
    assert chain.sample_names == want.sample_names
    mid = al.subset(cols)
    _ = mid.codes  # made now: a later subset starts from it
    np.testing.assert_array_equal(mid.subsample(rows).codes,
                                  jal.subset(cols).subsample(rows).codes)


# ------------------------------------------------------------------- pairs

def f64_oracle(ci, cj, w):
    """(P, 5, 5) float64 sums in numpy, then one rounding to f32."""
    q = ci.astype(np.int64) * 5 + cj
    out = np.zeros((ci.shape[1], 25))
    for k in range(25):
        out[:, k] = np.where(q == k, w.astype(np.float64)[:, None], 0.0).sum(0)
    return out.astype(np.float32).reshape(-1, 5, 5)


def weight_set(kind, S, rng):
    if kind == "unit":
        return np.ones(S, np.float32)
    if kind == "computed":  # 1 / cluster size
        return (1.0 / rng.integers(1, S + 1, S)).astype(np.float32)
    return (rng.random(S) * 0.9 + 0.1).astype(np.float32)  # the bench's [0.1, 1)


@pytest.fixture(scope="module")
def jax_engine():
    jal = JaxAlignment(np.ascontiguousarray(padded_random_codes(seed=11, S=150, L=300)[:, 1:]),
                       [f"s{k}" for k in range(150)], "pairs", np.arange(299), 299,
                       np.random.default_rng(3).random(150) * 0.9 + 0.1)
    jal.codes[jal.codes == 255] = 4
    return JaxEngine(jal, JaxConfig(use_pallas="on", wog_fetch="outliers"))


def test_pairs_xtab_plain_matches_jax_pairs_xtab(jax_engine):
    d, st = jax_engine.data, jax_engine.statics
    rng = np.random.default_rng(5)
    L = jax_engine.L
    ipos = rng.integers(0, L, 700)
    jpos = (ipos + rng.integers(1, L, 700)) % L
    want = np.asarray(jax_pairs_xtab(d, st, jnp.asarray(ipos), jnp.asarray(jpos)))
    codes, w = np.array(d.codes), np.array(d.weights)  # pad rows: code 255, weight 0
    ci, cj = codes[:, ipos], codes[:, jpos]
    got = pairs_xtab(torch.from_numpy(ci), torch.from_numpy(cj), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    np.testing.assert_array_equal(got, f64_oracle(ci, cj, w))


@pytest.mark.parametrize("kind", ["unit", "computed", "bench"])
def test_pairs_xtab_exact_and_free_of_order(kind):
    rng = np.random.default_rng({"unit": 1, "computed": 2, "bench": 3}[kind])
    S, P = 257, 613
    ci = rng.integers(0, 5, (S, P)).astype(np.uint8)
    cj = rng.integers(0, 5, (S, P)).astype(np.uint8)
    ci[rng.random((S, P)) < 0.03] = 255
    cj[:, 5] = 255
    w = weight_set(kind, S, rng)
    want = f64_oracle(ci, cj, w)
    t = torch.from_numpy
    got = pairs_xtab(t(ci), t(cj), t(w))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[5].any()
    perm_p, perm_s = rng.permutation(P), rng.permutation(S)
    for args in ((ci[:, perm_p], cj[:, perm_p], w, perm_p),
                 (ci[perm_s], cj[perm_s], w[perm_s], None)):
        out = pairs_xtab(t(np.ascontiguousarray(args[0])), t(np.ascontiguousarray(args[1])),
                         t(np.ascontiguousarray(args[2])))
        np.testing.assert_array_equal(out.numpy(), want if args[3] is None else want[args[3]])
    for cells in (1, 1000, 99_999):  # other blocks of samples
        np.testing.assert_array_equal(pairs_xtab_plain(t(ci), t(cj), t(w), cells).numpy(), want)
    exact = pairs_xtab_plain(t(ci), t(cj), t(w.astype(np.float64)))  # float64: unrounded
    assert exact.dtype == torch.float64
    np.testing.assert_array_equal(exact.numpy().astype(np.float32), want)
    for c0, c1 in ((0, 100), (100, 613), (37, 38)):  # other chunks of pairs
        np.testing.assert_array_equal(
            pairs_xtab(t(np.ascontiguousarray(ci[:, c0:c1])), t(np.ascontiguousarray(cj[:, c0:c1])),
                       t(w)).numpy(), want[c0:c1])


def test_pairs_xtab_outside_the_exact_range_within_one_ulp():
    rng = np.random.default_rng(8)
    S, P = 300, 200
    ci = rng.integers(0, 5, (S, P)).astype(np.uint8)
    cj = rng.integers(0, 5, (S, P)).astype(np.uint8)
    w = (2.0 ** rng.uniform(-45, 0, S)).astype(np.float32)  # spans 45 binades: inexact in f64
    t = torch.from_numpy
    want = f64_oracle(ci, cj, w)
    for cells in (1, 10**6):
        got = pairs_xtab_plain(t(ci), t(cj), t(w), cells).numpy()
        assert np.all(np.abs(got - want) <= np.spacing(np.abs(want))), cells


def test_engine_pairs_path_free_of_chunks(jax_engine):
    """The engine's tournament tables: the same bits for any chunk size;
    the tournament's draws on their worker thread and its pairs in chunks
    of ``_pairs_chunk``, in its spans and counters."""
    jal = jax_engine.alignment
    eng = MIEngine(jal, EngineConfig(tile=128), device="cpu")
    assert eng._pairs_chunk == pairs_chunk(jal.n_samples) == 65536
    assert pairs_chunk(3000) == 44672
    rng = np.random.default_rng(6)
    ipos = rng.integers(0, eng.L - 1, 900)
    jpos = ipos + 1 + rng.integers(0, eng.L - 1 - ipos)
    want = eng.pair_mi(ipos, jpos)
    for chunk in (128, 256, 896):
        eng._pairs_chunk = chunk
        np.testing.assert_array_equal(eng.pair_mi(ipos, jpos), want)
        perm = rng.permutation(len(ipos))
        np.testing.assert_array_equal(eng.pair_mi(ipos[perm], jpos[perm]), want[perm])
    rec = {}
    with recording(rec):
        thr = threshold.determine_mi_threshold(eng, 400, threshold_pairs=2000, iterations=3,
                                               seed=4)
    assert thr > 0
    assert rec["counters"] == {"pairs_drawn": 6000, "pair_chunks": -(-6000 // 896)}
    draws = [sp for sp in rec["spans"] if sp["path"] == "draw"]
    waits = [sp for sp in rec["spans"] if sp["path"] == "wait_draws"]
    assert len(draws) == len(waits) == 3
    assert {sp["thread"] for sp in draws} == {"draws_0"}
    assert {sp["thread"] for sp in waits} == {"main"}
    assert 0 < seconds(rec["spans"], "draw") <= seconds(rec["spans"], "scan")


def test_pairs_mi_is_the_float64_mi_rounded_once(jax_engine):
    """The pairs paths' MI and wo-gaps MI: ``ops/reference.py``'s float64
    MI of the float64 tables (f32-exact weights) within F64_EPILOGUE_TOL,
    the f32 rounding of each table cell (one relative 2^-24 error each);
    an f32 epilogue is 2^-22-coarse at these entropies."""
    from spydrpick_torch.ops import reference

    jal = jax_engine.alignment
    w32 = jal.weights.astype(np.float32).astype(np.float64)
    al = Alignment(jal.codes.copy(), list(jal.sample_names), "w32", jal.translation.copy(),
                   jal.n_original_positions, w32)
    eng = MIEngine(al, EngineConfig(tile=128), device="cpu")
    rng = np.random.default_rng(12)
    ipos = rng.integers(0, eng.L - 1, 300)
    jpos = ipos + 1 + rng.integers(0, eng.L - 1 - ipos)
    mi, wog = eng.pair_mi(ipos, jpos), eng.pair_wog(ipos, jpos)
    pres, gap = al.state_presence, al.gap_presence
    pres_wog = al.state_presence_wo_gaps
    for k, (a, b) in enumerate(zip(ipos, jpos)):
        C = reference.crosstab_pair(al.codes[:, a], al.codes[:, b], w32)
        want = reference.mi_single(C, pres[a], pres[b])
        with np.errstate(divide="ignore", invalid="ignore"):  # an all-gap column: NaN
            want_wog = (reference.mi_single(C, pres_wog[a], pres_wog[b]) if gap[a] or gap[b]
                        else want)
        np.testing.assert_allclose([mi[k], wog[k]], [want, want_wog], rtol=0,
                                   atol=F64_EPILOGUE_TOL, err_msg=f"{(a, b)}")


# --------------------------------------------------------- load_and_preprocess

def load_cases(tmp_path):
    """(options) for both packages: golden2 with its mappings, weights file
    and genome size; a filter that drops columns with include and sample
    lists and computed weights."""
    g2 = dict(alignmentfile=os.path.join(GOLDEN, "golden2.fasta"),
              mappings_list=os.path.join(GOLDEN, "golden2.mappings"),
              sample_weights=os.path.join(GOLDEN, "golden2.weights"),
              genome_size=int(GOLDEN2_ARGS[GOLDEN2_ARGS.index("--genome-size") + 1]))
    jal = filter_dropping_alignment()
    fasta = str(tmp_path / "drop.fasta")
    jax_write_fasta(fasta, jal)
    incl, samples = tmp_path / "incl.txt", tmp_path / "samples.txt"
    incl.write_text("\n".join(str(k) for k in range(1, jal.n_loci + 1) if k % 7))
    samples.write_text("\n".join(str(k) for k in range(1, jal.n_samples + 1) if k % 4))
    drop = dict(alignmentfile=fasta, include_list=str(incl), sample_list=str(samples),
                maf_threshold=0.02)
    return {"golden2": g2, "dropping_lists": drop}


@pytest.mark.parametrize("case", ["golden2", "dropping_lists"])
def test_load_and_preprocess_equals_jax(tmp_path, case):
    kw = load_cases(tmp_path)[case]
    rec = {}
    with recording(rec):
        got = load_and_preprocess(PipelineOptions(**kw))
    want = jax_load(JaxOptions(**kw))
    assert got.device_codes is None  # the CPU: the host codes are the only codes
    np.testing.assert_array_equal(got.codes, want.codes)
    np.testing.assert_array_equal(got.translation, want.translation)
    np.testing.assert_array_equal(got.weights, want.weights)
    np.testing.assert_array_equal(got.state_counts, want.state_counts)
    assert got.sample_names == want.sample_names
    assert got.n_original_positions == want.n_original_positions
    if case == "dropping_lists":
        assert got.n_loci < 240 * 6 // 7 and got.n_samples < 120
    paths = {sp["path"] for sp in rec["spans"]}
    assert "upload" not in paths and {"parse.read", "parse.decode"} <= paths
    assert seconds(rec["spans"], "parse.read") > 0 and seconds(rec["spans"], "parse.decode") > 0
