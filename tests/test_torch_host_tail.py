"""The main path's host tail of the PyTorch port on the CPU: the edge sort
as one torch sort (``EdgeSet.sorted_on``, ``desc_order``), the
tournament's draws overlapped with its pair chunks
(``determine_mi_threshold``, ``MIEngine._pairs``) and the sweep's fetch
(``device.to_host``, ``MIEngine._edges_to_host``).

  * the torch sort's permutation is numpy ``EdgeSet.sort_desc``'s and the
    JAX package's ``EdgeSet.sort_desc``'s: tie-heavy quantised MI, the
    2^20-column case where numpy lexsorts its tied spans, no edge, one
    edge, and a two-rank sharded sweep's gathered order;
  * the overlapped tournament draws the pairs of the sequential code,
    launches the same chunks (cut mid-iteration) and returns its threshold
    bit for bit;
  * the fetch gives the EdgeSet of the per-array copy-and-widen it
    replaced, values and dtypes, fresh and resumed from a checkpoint.
"""

import contextlib
import os
import socket
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

from spydrpick_tpu.engine.solver import EdgeSet as JaxEdgeSet
from spydrpick_torch.device import to_host
from spydrpick_torch.engine import threshold
from spydrpick_torch.engine.solver import EdgeSet, EngineConfig, MIEngine, desc_order

from tests.conftest import random_alignment

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("ipos", "jpos", "mi", "mi_wog")
TILE = 128
THR = 0.02


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: these small ops run ~10x slower when every
    test worker of a loaded host spins a thread per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def assert_sorts_agree(edges: EdgeSet) -> EdgeSet:
    """The torch sort on the CPU, numpy's sort_desc and the JAX package's
    give the same arrays in the same dtypes; returns the torch sort's."""
    got, dev = edges.sorted_on("cpu")
    for f in ("ipos", "jpos", "mi"):
        np.testing.assert_array_equal(getattr(dev, f).numpy(), getattr(got, f), err_msg=f)
    want = edges.sort_desc()
    ref = JaxEdgeSet(*(getattr(edges, f) for f in FIELDS + ("colmax",))).sort_desc()
    for f in FIELDS:
        a, b, c = getattr(got, f), getattr(want, f), getattr(ref, f)
        assert a.dtype == b.dtype == getattr(edges, f).dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
        np.testing.assert_array_equal(a, c, err_msg=f)
    assert got.colmax is edges.colmax
    return got


def unique_pairs(rng, L, E):
    keys = rng.choice(L * L, size=3 * E, replace=False)
    i, j = keys // L, keys % L
    keep = i < j
    return i[keep][:E], j[keep][:E]


def test_device_sort_tie_heavy_quantised_mi():
    rng = np.random.default_rng(12)
    i, j = unique_pairs(rng, 400, 6000)
    mi = rng.choice(np.linspace(0.01, 0.5, 37), size=len(i))  # 37 values: ties everywhere
    got = assert_sorts_agree(EdgeSet(i, j, mi, mi * rng.random(len(i)), rng.random(400)))
    assert len(np.unique(got.mi)) == 37


def test_device_sort_where_numpy_lexsorts_tied_spans():
    """L = 2^20 and more distinct values than (2^63 - 1) // L^2: numpy's
    sort_desc leaves its packed key for a lexsort of the tied spans; the
    torch sort's key is bounded by L^2 alone."""
    L, E = 1 << 20, (1 << 23) + 30_000
    rng = np.random.default_rng(5)
    k = np.arange(E - 1, dtype=np.int64)
    i = k % (L - 16)
    j = i + 1 + k // (L - 16)
    i, j = np.append(i, 0), np.append(j, L - 1)  # jpos reaches L - 1
    perm = rng.permutation(E)
    i, j = i[perm], j[perm]
    mi = rng.random(E) + 0.01
    mi[:20_000] = mi[20_000:40_000]  # tied spans
    got = assert_sorts_agree(EdgeSet(i, j, mi, mi, np.zeros(L))).mi
    n_ranks = 1 + np.count_nonzero(got[1:] != got[:-1])
    assert n_ranks > (2**63 - 1) // L**2, n_ranks  # numpy's lexsort branch


@pytest.mark.parametrize("n", [0, 1])
def test_device_sort_no_edge_and_one_edge(n):
    e = EdgeSet(np.arange(n, dtype=np.int64), np.arange(n, dtype=np.int64) + 3,
                np.full(n, 0.25), np.full(n, 0.125), np.zeros(5))
    assert assert_sorts_agree(e).n_edges == n


@pytest.mark.parametrize("bad", [np.nan, -0.0])
def test_desc_order_refuses_nan_and_negative_zero(bad):
    mi = torch.tensor([0.5, bad, 0.25], dtype=torch.float64)
    with pytest.raises(ValueError, match="NaN or -0.0"):
        desc_order(torch.tensor([0, 1, 2]), torch.tensor([3, 4, 5]), mi)


SHARDED_WORKER = textwrap.dedent('''
    import sys
    import numpy as np
    from spydrpick_torch.core.alignment import Alignment
    from spydrpick_torch.engine.solver import EngineConfig, MIEngine
    from spydrpick_torch.parallel.distributed import initialize_distributed, shutdown
    from spydrpick_torch.parallel.mesh import make_mesh, sharded_sweep

    addr, rank, inp, out = sys.argv[1:]
    initialize_distributed(addr, 2, int(rank))
    z = np.load(inp)
    S, L = z["codes"].shape
    al = Alignment(z["codes"], [f"s{i}" for i in range(S)], "t", np.arange(L), L, z["w"])
    e = sharded_sweep(MIEngine(al, EngineConfig(tile=128, wog_fetch="outliers")),
                      float(z["thr"]), make_mesh(1))
    assert "jax" not in sys.modules
    if rank == "0":
        np.savez(out, ipos=e.ipos, jpos=e.jpos, mi=e.mi, mi_wog=e.mi_wog, colmax=e.colmax)
    shutdown()
''')


def test_device_sort_of_a_sharded_sweeps_gathered_order(tmp_path):
    """Two gloo ranks of a rows mesh each sweep their balanced share of
    five block-rows; the gathered EdgeSet, rank by rank in each rank's
    sweep order, is sorted alike by the three sorts."""
    al = random_alignment(n_samples=40, n_loci=640, seed=31, gap_frac=0.1)
    inp = str(tmp_path / "in.npz")
    np.savez(inp, codes=al.codes, w=al.weights, thr=THR)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{s.getsockname()[1]}"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="2", SPYDRPICK_TORCH_DEVICE="cpu")
    out = str(tmp_path / "gathered.npz")
    procs = [subprocess.Popen([sys.executable, "-c", SHARDED_WORKER, addr, str(r), inp, out],
                              env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    z = np.load(out)
    e = EdgeSet(*(z[f] for f in FIELDS + ("colmax",)))
    key = e.ipos * 640 + e.jpos
    assert e.n_edges > 1000 and (np.diff(key) < 0).any()  # not in (i, j) order
    assert_sorts_agree(e)


# ---------------------------------------------------------------- tournament

def sequential_threshold(engine, n_values, threshold_pairs, iterations, seed):
    """The tournament as it ran before the overlap: every iteration drawn
    first, then one ``pair_quantiles`` over the concatenated stream."""
    L = engine.L
    possible = L * (L - 1) // 2
    pct = 1.0 - float(n_values) / possible
    pairs_n = threshold.determine_threshold_pairs(threshold_pairs, possible, pct)
    rng = np.random.default_rng(seed)
    draws = [threshold.sample_pairs(rng, pairs_n, L) for _ in range(iterations)]
    ii = np.concatenate([d[0] for d in draws])
    jj = np.concatenate([d[1] for d in draws])
    th = engine.pair_quantiles([(ii, jj)], iterations, pairs_n,
                               min(int(pct * pairs_n), pairs_n - 1))
    m = iterations // 2 - (0 if iterations % 2 else 1)
    return float(np.partition(th, m)[m])


@contextlib.contextmanager
def recording(engine):
    """Record the (ipos, jpos) of every chunk that ``pairs_table`` gets."""
    chunks = []
    table = engine.pairs_table

    def pairs_table(i, j):
        chunks.append((i.numpy().copy(), j.numpy().copy()))
        return table(i, j)

    engine.pairs_table = pairs_table
    try:
        yield chunks
    finally:
        del engine.pairs_table


@pytest.fixture(scope="module")
def tournament_engine():
    al = random_alignment(n_samples=48, n_loci=300, seed=17, gap_frac=0.1)
    return MIEngine(al, EngineConfig(tile=TILE), device="cpu")


@pytest.mark.parametrize("chunk", [384, 640])
@pytest.mark.parametrize("seed", [3, 11, 42])
def test_overlapped_tournament_is_the_sequential_one(tournament_engine, seed, chunk):
    eng = tournament_engine
    eng._pairs_chunk = chunk  # 1000 pairs per iteration: chunks cut iterations
    kw = dict(n_values=600, threshold_pairs=1000, iterations=5, seed=seed)
    with recording(eng) as got_chunks:
        got = threshold.determine_mi_threshold(eng, **kw)
    with recording(eng) as want_chunks:
        want = sequential_threshold(eng, **kw)
    assert got == want  # bit for bit
    assert len(got_chunks) == len(want_chunks) == -(-5000 // chunk)
    for (gi, gj), (wi, wj) in zip(got_chunks, want_chunks):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gj, wj)
    assert all(len(c[0]) == chunk for c in got_chunks[:-1])


def test_a_failed_draw_reaches_the_caller(tournament_engine, monkeypatch):
    draw = threshold.sample_pairs
    calls = []

    def failing(rng, n, L):
        calls.append(n)
        if len(calls) == 3:
            raise RuntimeError("draw 3 failed")
        return draw(rng, n, L)

    before = set(threading.enumerate())
    monkeypatch.setattr(threshold, "sample_pairs", failing)
    with pytest.raises(RuntimeError, match="draw 3 failed"):
        threshold.determine_mi_threshold(tournament_engine, 600, threshold_pairs=1000,
                                         iterations=6, seed=1)
    assert set(threading.enumerate()) <= before  # the drawing thread has ended


# --------------------------------------------------------------------- fetch

class OldFetchEngine(MIEngine):
    """The fetch as it was: the store's slots in sweep order, each array
    copied to the host on its own, then widened by numpy."""

    def _edges_to_host(self, store, lo, rows, host):
        hi = store.checked
        if hi > lo:
            got = [x.cpu().numpy() for x in store.ordered(lo, hi, rows, self.tile, self.Lp)]
            host.ipos.append(got[0].astype(np.int64))
            host.jpos.append(got[1].astype(np.int64))
            mi = got[2].astype(np.float64)
            host.mi.append(mi)
            host.mi_wog.append(mi if store.wog is None else got[3].astype(np.float64))
        return hi


class Killed(Exception):
    pass


def assert_same_edgeset(a: EdgeSet, b: EdgeSet):
    for f in FIELDS + ("colmax",):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("wog_fetch", ["outliers", "full"])
def test_fetch_gives_the_old_edgeset_fresh_and_resumed(tmp_path, wog_fetch):
    al = random_alignment(n_samples=48, n_loci=700, seed=61, gap_frac=0.15)
    cfg = EngineConfig(tile=TILE, wog_fetch=wog_fetch, store_capacity=64)
    new, old = MIEngine(al, cfg, device="cpu"), OldFetchEngine(al, cfg, device="cpu")
    assert_same_edgeset(new.sweep(THR), old.sweep(THR))

    def killed_sweep(cls, path):
        seen = []

        def progress(lo, hi, n, dt):
            seen.append(lo)
            if len(seen) == 3:
                raise Killed

        with pytest.raises(Killed):
            cls(al, cfg, device="cpu").sweep(THR, progress=progress, checkpoint_path=path,
                                             checkpoint_every=2)

    resumed = []
    for name, eng in (("new", new), ("old", old)):
        path = str(tmp_path / f"{name}.ckpt")
        killed_sweep(type(eng), path)
        resumed.append(eng.sweep(THR, checkpoint_path=path, checkpoint_every=2))
        assert not os.path.exists(path)
    assert_same_edgeset(*resumed)


def test_to_host_permutes_and_widens():
    rng = np.random.default_rng(2)
    i = torch.from_numpy(rng.integers(0, 1000, 50).astype(np.int32))
    m = torch.from_numpy(rng.random(50).astype(np.float32))
    order = torch.from_numpy(rng.permutation(50))
    gi, gm = to_host([i, m], order, [torch.int64, torch.float64])
    assert gi.dtype == np.int64 and gm.dtype == np.float64
    np.testing.assert_array_equal(gi, i.numpy()[order.numpy()])
    np.testing.assert_array_equal(gm, m.numpy()[order.numpy()].astype(np.float64))
    (same,) = to_host([m])
    assert same.dtype == np.float32 and not np.shares_memory(same, m.numpy())
    np.testing.assert_array_equal(same, m.numpy())
