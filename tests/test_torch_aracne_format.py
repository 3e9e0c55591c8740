"""ARACNE's flags and the couplings rows of the PyTorch port on the CPU,
where ``aracne_flags`` and ``format_couplings_rows`` run their plain
versions (``ops/aracne.py``, ``ops/format.py``; the CUDA kernels are held
to them in tests/test_torch_gpu.py and chip_smoke phase 6c):

  * ``aracne_flags_plain`` equals the JAX package's ``run_aracne`` (its
    native owner-scan and its NumPy version) and the port's native
    ``mark_indirect``, flag for flag: exact DPI ties (min(w_ac, w_bc) ==
    w + thr) and their one-ulp neighbours, thr = 0, eps and 1e-3, a hub
    node, isolated edges, no edge and one edge;
  * the plain formatter's bytes equal Python's ``f"{x:.6f}"`` rows, the
    port's native formatter and the JAX package's ``write_couplings``, on
    the values where "%.6f" is easy to get wrong, on linear and circular
    genomes with translations as ``--mappings-list`` makes them;
  * ``run_pipeline`` on the CPU, where it runs the native host copies,
    writes the couplings file that the host writer and the plain versions
    write from its result, with the native owner-scan's flags.

    python -m pytest tests/test_torch_aracne_format.py -q
"""

import io
import types

import numpy as np
import pytest
import torch

from spydrpick_tpu.engine import aracne as jax_aracne
from spydrpick_tpu.io import writers as jax_writers
from spydrpick_torch.engine.aracne import DEFAULT_EDGE_THRESHOLD
from spydrpick_torch.io import writers
from spydrpick_torch.native import aracne_native, format_native
from spydrpick_torch.ops.aracne import aracne_flags, aracne_flags_plain
from spydrpick_torch.ops.format import (
    check_mi,
    couplings_columns,
    format_couplings_rows,
    format_couplings_rows_plain,
    mi_micro_plain,
)
from spydrpick_torch.utils.profiling import recording

EPS = DEFAULT_EDGE_THRESHOLD
THRESHOLDS = [0.0, EPS, 1e-3]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def unique_edges(i, j, mi):
    """The edges with i < j, each pair once (its first occurrence)."""
    i, j = np.asarray(i, np.int64), np.asarray(j, np.int64)
    lo, hi = np.minimum(i, j), np.maximum(i, j)
    keep = lo < hi
    lo, hi, mi = lo[keep], hi[keep], np.asarray(mi, np.float64)[keep]
    _, first = np.unique(lo * (hi.max() + 1) + hi, return_index=True)
    first = np.sort(first)
    return lo[first], hi[first], mi[first]


def tie_graph(seed, thr, n=400, E=3000, n_tri=300):
    """A random graph plus triangles (a, b, c) whose edge (a, b, w) sits on
    the DPI rule's edge: min(w_ac, w_bc) equals w + max(thr, 0) in f64
    exactly, or is one ulp below or above it; plus a hub joined to every
    node and a few isolated edges on nodes of their own."""
    rng = np.random.default_rng(seed)
    i, j = rng.integers(0, n, (2, E))
    mi = np.round(rng.random(E), 3)
    margin = thr if thr > 0 else 0.0
    tri = rng.choice(n, size=(n_tri, 3), replace=True) + n  # fresh nodes, n..2n
    w = np.round(rng.random(n_tri) * 0.5, 4)
    need = w + margin
    shift = rng.integers(-1, 2, n_tri)
    w_side = np.where(shift < 0, np.nextafter(need, 0), np.where(shift > 0,
                                                                 np.nextafter(need, 2), need))
    a, b, c = tri.T
    i = np.concatenate([i, a, a, b, np.zeros(2 * n, np.int64) + 3 * n, [4 * n, 4 * n + 2]])
    j = np.concatenate([j, b, c, c, np.arange(2 * n), [4 * n + 1, 4 * n + 3]])
    mi = np.concatenate([mi, w, w_side, w_side + rng.integers(0, 2, n_tri) * 0.25,
                         rng.random(2 * n) * 0.01, [0.7, 0.2]])
    return unique_edges(i, j, mi)


def references(i, j, mi, thr):
    """Flags of the JAX package's native and NumPy ARACNE and the port's
    native owner-scan (1 = direct)."""
    want = [jax_aracne.run_aracne(i, j, mi, thr, use_native=True),
            jax_aracne.run_aracne(i, j, mi, thr, use_native=False)]
    if len(mi):
        want.append((~aracne_native.mark_indirect(i, j, mi, thr)).astype(np.uint8))
    return want


def plain_flags(i, j, mi, thr, **kw):
    t = torch.from_numpy
    return aracne_flags_plain(t(i), t(j), t(mi), thr, **kw).numpy()


@pytest.mark.parametrize("thr", THRESHOLDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_flags_equal_references_at_dpi_ties(thr, seed):
    i, j, mi = tie_graph(seed, thr)
    got = plain_flags(i, j, mi, thr)
    for want in references(i, j, mi, thr):
        np.testing.assert_array_equal(got, want)
    assert 0 < int(got.sum()) < len(got)


@pytest.mark.parametrize("thr", THRESHOLDS)
def test_plain_flags_in_small_chunks(thr):
    """Chunks of a few candidates, each edge whole, give the same flags."""
    i, j, mi = tie_graph(5, thr, E=800, n_tri=100)
    want = plain_flags(i, j, mi, thr)
    np.testing.assert_array_equal(plain_flags(i, j, mi, thr, flat_budget=7), want)


@pytest.mark.parametrize("thr", THRESHOLDS)
def test_plain_flags_dense_quantised(thr):
    """A dense graph with weights on a coarse grid: ties everywhere."""
    rng = np.random.default_rng(7)
    i, j = np.triu_indices(60, 1)
    mi = rng.integers(1, 9, len(i)) / 8.0
    got = plain_flags(i.astype(np.int64), j.astype(np.int64), mi, thr)
    for want in references(i.astype(np.int64), j.astype(np.int64), mi, thr):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["empty", "one", "two", "isolated"])
def test_plain_flags_small_graphs(case):
    i, j, mi = {"empty": ([], [], []), "one": ([3], [9], [0.4]),
                "two": ([0, 1], [1, 2], [0.3, 0.3]),
                "isolated": ([0, 2, 4, 6], [1, 3, 5, 7], [0.1, 0.9, 0.5, 0.5])}[case]
    i, j, mi = np.array(i, np.int64), np.array(j, np.int64), np.array(mi, np.float64)
    got = plain_flags(i, j, mi, EPS)
    assert got.dtype == np.uint8 and len(got) == len(mi)
    for want in references(i, j, mi, EPS):
        np.testing.assert_array_equal(got, want)
    assert got.all()


def test_cpu_wrappers_run_plain_and_count_nothing():
    i, j, mi = tie_graph(3, EPS, E=500, n_tri=50)
    n0 = aracne_flags.launches, format_couplings_rows.launches
    got = aracne_flags(torch.from_numpy(i), torch.from_numpy(j), torch.from_numpy(mi)).numpy()
    np.testing.assert_array_equal(got, plain_flags(i, j, mi, EPS))
    z = torch.zeros(len(mi), dtype=torch.int64)
    format_couplings_rows(z, z, z, torch.from_numpy(got), torch.from_numpy(mi))
    assert (aracne_flags.launches, format_couplings_rows.launches) == n0


def test_plain_flags_refuse_repeated_pairs():
    t = lambda x, dt=torch.int64: torch.tensor(x, dtype=dt)
    with pytest.raises(ValueError, match="repeats"):
        aracne_flags_plain(t([0, 0]), t([1, 1]), t([0.2, 0.3], torch.float64))


def adversarial_mi(rng, n_random=5000):
    """The values of chip_smoke phase 6c, fewer: every odd multiple of
    2^-7 up to ln 5 (the only binary-exact ties (n + 1/2) 10^-6), one ulp
    either side of random halfway points, 5e-7 +- 1 ulp, subnormals, the
    smallest normal, values above 1 and random values up to ln 5."""
    ties = np.arange(1, 207, 2) * 2.0**-7
    half = (rng.integers(0, 1_609_438, n_random) + 0.5) / 1e6
    tiny = np.array([0.0, 5e-7, np.nextafter(5e-7, 0), np.nextafter(5e-7, 1), 5e-324,
                     np.nextafter(5e-324, 1), 2.2250738585072014e-308, 1e-310, 1e-300,
                     9.0e9, 123456.5, 0.9999995, 1.0000005, 2.5e-6])
    return np.concatenate([ties, half, np.nextafter(half, 0), np.nextafter(half, 1), tiny,
                           rng.random(n_random) * np.log(5)])


def python_rows(p1, p2, d, fl, mi) -> bytes:
    return "".join(f"{a} {b} {c} {int(f != 0)} {x:.6f}\n"
                   for a, b, c, f, x in zip(p1, p2, d, fl, mi)).encode()


def test_mi_micro_equals_python_rounding():
    mi = adversarial_mi(np.random.default_rng(1))
    q = mi_micro_plain(torch.from_numpy(mi)).numpy()
    want = np.array([int(f"{x:.6f}".replace(".", "")) for x in mi])
    np.testing.assert_array_equal(q, want)
    ties = np.arange(1, 207, 2) * 2.0**-7  # half-way: rounds to the even neighbour
    assert np.all(mi_micro_plain(torch.from_numpy(ties)).numpy() % 2 == 0)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_rows_equal_python_and_native(seed):
    rng = np.random.default_rng(seed)
    mi = adversarial_mi(rng)
    n = len(mi)
    p1 = rng.integers(-5, 10**7, n)
    p2 = rng.integers(0, 10**18, n)
    d = rng.integers(-3, 10**5, n)
    fl = rng.integers(0, 3, n).astype(np.uint8)
    t = torch.from_numpy
    got = format_couplings_rows_plain(t(p1), t(p2), t(d), t(fl), t(mi)).numpy().tobytes()
    assert got == python_rows(p1, p2, d, fl, mi)
    assert got == format_native.format_couplings(p1, p2, d, fl, mi)


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf"), -1e-3, -0.0,
                                 2.0**53 / 1e6, 1e300])
def test_plain_rows_refuse(bad):
    with pytest.raises(ValueError, match="mi holds"):
        check_mi(torch.tensor([0.5, bad], dtype=torch.float64))
    z = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="mi holds"):
        format_couplings_rows(z, z, z, z.to(torch.uint8),
                              torch.tensor([0.5, bad], dtype=torch.float64))


def mapped_alignment(rng, L):
    """Translation and genome size as ``--mappings-list`` gives them:
    sorted original positions with gaps, a genome longer than the last."""
    trans = np.sort(rng.choice(50 * L, size=L, replace=False)).astype(np.int64)
    G = int(trans[-1]) + 1 + int(rng.integers(0, 10 * L))
    return types.SimpleNamespace(translation=trans, n_original_positions=G)


def sorted_edges(rng, L, E):
    keys = rng.choice(L * L, size=3 * E, replace=False)
    i, j = keys // L, keys % L
    keep = i < j
    i, j = i[keep][:E], j[keep][:E]
    mi = np.concatenate([adversarial_mi(rng, 200), rng.random(E)])[:len(i)]
    order = np.lexsort((j, i, -mi))
    return types.SimpleNamespace(ipos=i[order], jpos=j[order], mi=mi[order])


def text_of(fn, *args):
    f = io.StringIO()
    fn(f, *args)
    return f.getvalue()


@pytest.mark.parametrize("linear", [False, True])
@pytest.mark.parametrize("base", [0, 1])
@pytest.mark.parametrize("chunk", [1 << 24, 97])
def test_write_couplings_rows_equal_jax_write_couplings(linear, base, chunk):
    """The pipeline's writer, on CPU tensors, writes the JAX package's
    couplings bytes (its native formatter and its Python fallback)."""
    rng = np.random.default_rng(11 + base)
    L, E = 700, 1500
    al = mapped_alignment(rng, L)
    e = sorted_edges(rng, L, E)
    flags = rng.integers(0, 2, len(e.mi)).astype(np.uint8)
    t = torch.from_numpy
    f = io.BytesIO()
    rec = {}
    with recording(rec):
        writers.write_couplings_rows(f, t(e.ipos), t(e.jpos), t(e.mi), t(flags), al, base,
                                     linear, chunk=chunk)
    got = f.getvalue()
    for native in (True, False):
        assert got.decode() == text_of(jax_writers.write_couplings, e, flags, al, base, linear,
                                       native)
    assert got.decode() == text_of(writers.write_couplings, e, flags, al, base, linear)
    # per chunk of rows the spans format, copy and file
    paths = [sp["path"] for sp in rec["spans"]]
    assert {p: paths.count(p) for p in set(paths)} == {
        "format": -(-len(e.mi) // chunk), "copy": -(-len(e.mi) // chunk),
        "file": -(-len(e.mi) // chunk), "scan": 1}
    # a text file takes the same bytes through its buffer
    s = io.TextIOWrapper(io.BytesIO(), encoding="ascii")
    writers.write_couplings_rows(s, t(e.ipos), t(e.jpos), t(e.mi), t(flags), al, base, linear)
    s.flush()
    assert s.buffer.getvalue() == got


def test_couplings_columns_match_host_rule():
    from spydrpick_torch.core.distance import genome_distance

    rng = np.random.default_rng(4)
    al = mapped_alignment(rng, 300)
    e = sorted_edges(rng, 300, 400)
    for linear in (False, True):
        p1, p2, d = couplings_columns(torch.from_numpy(e.ipos), torch.from_numpy(e.jpos),
                                      torch.from_numpy(al.translation), 1,
                                      al.n_original_positions, linear)
        want1 = al.translation[e.ipos] + 1
        want2 = al.translation[e.jpos] + 1
        np.testing.assert_array_equal(p1.numpy(), want1)
        np.testing.assert_array_equal(p2.numpy(), want2)
        np.testing.assert_array_equal(
            d.numpy(), genome_distance(want1, want2, al.n_original_positions, linear))


def test_run_pipeline_cpu_writes_host_writer_bytes(tmp_path, monkeypatch):
    """The slice on the CPU, where it runs the native host copies:
    run_pipeline's flags are the native owner-scan's, and its couplings
    file is the host writer's bytes for its edges and flags, also the
    plain versions' (the card's reference)."""
    from spydrpick_torch.core.alignment import Alignment
    from spydrpick_torch.io.fasta import write_fasta
    from spydrpick_torch.pipeline import PipelineOptions, run_pipeline

    monkeypatch.setenv("SPYDRPICK_TORCH_DEVICE", "cpu")
    rng = np.random.default_rng(42)
    S, L = 80, 256
    codes = np.repeat(rng.integers(0, 4, size=(1, L)), S, axis=0)
    mut = rng.random((S, L)) < 0.2
    codes[mut] = rng.integers(0, 4, size=mut.sum())
    codes[:, 200] = codes[:, 10]
    codes[rng.random((S, L)) < 0.03] = 4
    path = tmp_path / "aln.fasta"
    write_fasta(str(path), Alignment(codes.astype(np.uint8), [f"s{k}" for k in range(S)],
                                     "aln", np.arange(L), L))
    native_calls = []
    mark_indirect = aracne_native.mark_indirect

    def spy(*args):
        native_calls.append(len(args[2]))
        return mark_indirect(*args)
    monkeypatch.setattr(aracne_native, "mark_indirect", spy)
    tm = {}
    res = run_pipeline(PipelineOptions(alignmentfile=str(path), output_dir=str(tmp_path / "o"),
                                       tile=128, seed=3), timings=tm)
    e = res.edges
    assert native_calls == [e.n_edges]  # run_aracne's native path
    assert e.n_edges > 100
    want = (~aracne_native.mark_indirect(e.ipos, e.jpos, e.mi, EPS)).astype(np.uint8)
    np.testing.assert_array_equal(res.flags, want)
    with open(res.couplings_path, "rb") as f:
        got = f.read()
    assert got.decode() == text_of(writers.write_couplings, e, res.flags, res.alignment, 1,
                                   False)
    t = torch.from_numpy
    np.testing.assert_array_equal(aracne_flags_plain(t(e.ipos), t(e.jpos), t(e.mi)).numpy(),
                                  res.flags)
    plain = io.BytesIO()
    writers.write_couplings_rows(plain, t(e.ipos), t(e.jpos), t(e.mi), t(res.flags),
                                 res.alignment, 1, False)
    assert plain.getvalue() == got
    secs = {}
    for sp in tm["spans"]:
        secs[sp["path"]] = secs.get(sp["path"], 0.0) + sp["end"] - sp["start"]
    assert {"write.couplings", "write.outliers", "write.nodes"} <= set(secs)
    laps = [f"lead_in.{k}" for k in ("parse", "lists", "filter", "weights", "outputs")]
    assert set(laps) <= set(secs)
    assert sum(secs[k] for k in laps) <= tm["preprocess_s"] + 1e-3
    parts = secs["lead_in.parse.read"] + secs["lead_in.parse.decode"]  # the parser's
    assert parts <= secs["lead_in.parse"] + 1e-3
    assert "lead_in.upload" not in secs  # the CPU: the host codes are the only codes
