"""Kernel B2 of the PyTorch port, ``row_select`` (spydrpick_torch/ops/
compact.py), and the sweep's device edge store, on the CPU:

  * ``row_select_plain`` against the reference's ``row_sweep_core``
    (spydrpick_tpu/engine/solver.py:671, Pallas kernels in interpret
    mode) on one block-row: fed the reference's own row buffers, the same
    edges, mi, wog and colmax exactly; fed the port's buffers, the same
    edge set with mi and wog within 1e-6 (the two packages' f32 logs
    differ in the last bits);
  * a store of a few dozen slots, which forces the sweep to grow it and
    sweep rows again, gives EdgeSet arrays equal element for element to
    a default-capacity sweep: lazy and exact wog, one process, gloo
    rows-sharded and sample-sharded sweeps, and a checkpoint kill and
    resume;
  * zero-edge and all-edges sweeps, the store's own bookkeeping and the
    order-free colmax of +0 and -0.
"""

import sys

import numpy as np
import pytest
import torch

from spydrpick_tpu.engine.solver import EngineConfig as JaxConfig
from spydrpick_tpu.engine.solver import MIEngine as JaxEngine
from spydrpick_tpu.engine.solver import row_buffers as jax_row_buffers
from spydrpick_tpu.engine.solver import row_sweep_core
from spydrpick_tpu.io.fasta import write_fasta
from spydrpick_torch.cli import main as torch_main
from spydrpick_torch.engine import checkpoint as ck
from spydrpick_torch.engine.solver import (EdgeSet, EngineConfig, MIEngine,
                                           device_data_from_jax)
from spydrpick_torch.ops.compact import EdgeStore, row_select, row_select_plain
from spydrpick_torch.utils.profiling import recording

from tests.conftest import random_alignment
from tests.test_torch_sharding import free_port, spawn

TILE = 128
THR = 0.02
TINY = 40  # store slots: every sweep below overflows it
FIELDS = ("ipos", "jpos", "mi", "mi_wog", "colmax")
# (wog_fetch, ld_threshold, linear_genome, genome_size or None for L)
SELECT_CASES = {
    "lazy_circular": ("outliers", 0, False, None),
    "full_circular_ld": ("full", 7, False, 360),
    "lazy_linear_ld": ("outliers", 10, True, None),
    "full_linear": ("full", 0, True, None),
}


@pytest.fixture(autouse=True, scope="module")
def cpu_device():
    """These runs ask for the CPU, as a CLI run on a machine without a GPU
    must (spydrpick_torch/device.py)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPYDRPICK_TORCH_DEVICE", "cpu")
        yield


def select_engines(case):
    wog_fetch, ld, linear, genome = SELECT_CASES[case]
    # L = 300: not a multiple of the tile (Lp = 384)
    al = random_alignment(n_samples=48, n_loci=300, seed=23, gap_frac=0.15, n_original=genome)
    ref = JaxEngine(al, JaxConfig(tile=TILE, use_pallas="on", wog_fetch=wog_fetch,
                                  ld_threshold=ld, linear_genome=linear,
                                  edge_capacity=TILE * 384))
    port = MIEngine(al, EngineConfig(tile=TILE, wog_fetch=wog_fetch, ld_threshold=ld,
                                     linear_genome=linear), device="cpu")
    return ref, port


def reference_row(ref, i0, thr):
    """row_sweep_core's edges of block-row i0, sorted by (i, j), and its
    colmax contributions merged into an (Lp,) vector."""
    st = ref.statics
    ci, cj, vals, wogs, ipos, jpos, count, lines = (
        np.asarray(x) for x in row_sweep_core(ref.data, st, i0, thr))
    n = int(lines) * st.store_lanes
    live = jpos[:n] > ipos[:n]
    edges = [x[:n][live] for x in (ipos, jpos, vals, wogs)]
    assert len(edges[0]) == int(count)
    order = np.lexsort((edges[1], edges[0]))
    colmax = cj.astype(np.float32).copy()
    colmax[i0:i0 + st.tile] = np.maximum(colmax[i0:i0 + st.tile], ci)
    return [x[order] for x in edges], colmax


def port_row(port, mi, wog, i0, thr):
    """row_select_plain on one block-row: (ipos, jpos, mi, wog) in store
    order and the colmax it leaves, starting from -inf."""
    st, d = port.statics, port.data
    store = EdgeStore(TILE * st.Lp, wog is not None, torch.device("cpu"))
    colmax = torch.full((st.Lp,), -np.inf)
    row_select_plain(mi, wog, d.gap, d.orig_pos, colmax, store, i0, st.L, thr, st.ld_threshold,
                     st.linear_genome, st.genome_size)
    n = int(store.count)
    edges = [a[:n].numpy() for a in store.arrays()]
    return edges, colmax.numpy(), n


def gap_threshold(values, q=0.93, width=2e-5):
    """A threshold near quantile q with no value within ``width`` of it,
    so that the two packages' MI cannot fall on different sides."""
    v = np.unique(values)
    k = int(q * len(v))
    while v[k + 1] - v[k] <= 2 * width:
        k += 1
    return float(np.float32((v[k] + v[k + 1]) / 2))


@pytest.mark.parametrize("case", list(SELECT_CASES))
def test_row_select_plain_matches_row_sweep_core(case):
    ref, port = select_engines(case)
    st = ref.statics
    lazy = SELECT_CASES[case][0] == "outliers"
    for i0 in (0, 128, 256):
        mi_buf, wog_buf = (None if x is None else np.array(x)[:, i0:]
                           for x in jax_row_buffers(ref.data, st, i0))
        upper = np.triu(np.ones_like(mi_buf, dtype=bool), 1)  # j > i in the diagonal tile
        upper[:, TILE:] = True
        thr = gap_threshold(mi_buf[upper & np.isfinite(mi_buf)])
        want, want_colmax = reference_row(ref, i0, thr)
        assert len(want[0]) > 50
        # the reference's own buffers: exactly its edges and colmax
        conv = device_data_from_jax(ref.data, torch.device("cpu"))
        assert torch.equal(conv.orig_pos, port.data.orig_pos) and torch.equal(conv.gap,
                                                                              port.data.gap)
        got, colmax, n = port_row(port, torch.from_numpy(mi_buf),
                                  None if lazy else torch.from_numpy(wog_buf), i0, thr)
        assert n == len(want[0])
        for a, b in zip(got, want[:3] if lazy else want):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(colmax, want_colmax)
        # the port's own buffers (raw wog from B3's plain version)
        mi, wog = port.row_buffers(i0)
        assert (wog is None) == lazy
        got, colmax, n = port_row(port, mi, wog, i0, thr)
        assert n == len(want[0])
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        for a, b in zip(got[2:], want[2:4]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        np.testing.assert_allclose(colmax, want_colmax, rtol=0, atol=1e-6)


def sweep_engine(wog_fetch, capacity=1 << 24, seed=61, n_loci=700):
    al = random_alignment(n_samples=48, n_loci=n_loci, seed=seed, gap_frac=0.15)
    return MIEngine(al, EngineConfig(tile=TILE, wog_fetch=wog_fetch, store_capacity=capacity),
                    device="cpu")


def assert_equal_edges(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


@pytest.mark.parametrize("wog_fetch", ["outliers", "full"])
def test_tiny_store_regrows_to_the_default_sweep(wog_fetch):
    """A 40-slot store overflows; the sweep grows it, sweeps the rows
    since the last check again and returns the default sweep's arrays,
    in the same order; progress still sees each row once, with its own
    edge count."""
    want = sweep_engine(wog_fetch).sweep(THR)
    seen, rec = [], {}
    eng = sweep_engine(wog_fetch, TINY)
    assert eng.new_store().capacity == TINY
    with recording(rec):
        got = eng.sweep(THR, progress=lambda lo, hi, n, dt: seen.append((lo, n)))
    assert rec["counters"]["rows_reswept"] > 0 and want.n_edges > 10 * TINY
    assert_equal_edges(got, want)
    assert [lo for lo, _ in seen] == list(range(0, 700, TILE))
    rows = np.asarray(want.ipos) // TILE * TILE
    assert [n for _, n in seen] == [int((rows == lo).sum()) for lo, _ in seen]


def test_sweep_edges_come_in_sweep_order():
    e = sweep_engine("full").sweep(THR)
    key = e.ipos * 700 + e.jpos
    assert np.all(np.diff(key) > 0)


@pytest.mark.parametrize("capacity", [1 << 24, TINY])
def test_zero_and_all_edge_sweeps(capacity):
    """Threshold +inf keeps no edge, -inf every pair in sweep order; both
    leave the colmax of a default sweep."""
    want = sweep_engine("full", n_loci=300).sweep(THR)
    none = sweep_engine("full", capacity, n_loci=300).sweep(np.inf)
    assert none.n_edges == 0
    np.testing.assert_array_equal(none.colmax, want.colmax)
    every = sweep_engine("full", capacity, n_loci=300).sweep(-np.inf)
    assert every.n_edges == 300 * 299 // 2
    i, j = np.triu_indices(300, 1)
    np.testing.assert_array_equal(every.ipos, i)
    np.testing.assert_array_equal(every.jpos, j)
    np.testing.assert_array_equal(every.colmax, want.colmax)
    kept = every.mi > THR
    np.testing.assert_array_equal(every.mi[kept], want.mi)
    np.testing.assert_array_equal(every.mi_wog[kept], want.mi_wog)


class Killed(Exception):
    pass


@pytest.mark.parametrize("wog_fetch", ["outliers", "full"])
def test_tiny_store_kill_then_resume_equals_clean_run(tmp_path, wog_fetch):
    """tests/test_torch_checkpoint.py's kill and resume, with a store that
    overflows before every check: the snapshot holds whole rows, and the
    resumed sweep equals a clean default-capacity run bit for bit."""
    clean = sweep_engine(wog_fetch).sweep(THR)
    path = str(tmp_path / "sweep.ckpt")
    seen = []

    def progress(lo, hi, n, dt):
        seen.append(lo)
        if len(seen) == 3:
            raise Killed

    with pytest.raises(Killed):
        sweep_engine(wog_fetch, TINY).sweep(THR, progress=progress, checkpoint_path=path,
                                            checkpoint_every=2)
    eng = sweep_engine(wog_fetch, TINY)
    saved = ck.load(path, ck.params_key(eng.statics, THR))
    assert saved is not None and saved.done_rows == {0, 128}
    rows = saved.ipos[0] // TILE * TILE
    for lo in (0, 128):  # whole rows
        assert (rows == lo).sum() == (clean.ipos // TILE * TILE == lo).sum()
    resumed = eng.sweep(THR, checkpoint_path=path)
    assert_equal_edges(resumed, clean)


def test_cli_tiny_store_outputs_match(tmp_path):
    al = random_alignment(n_samples=40, n_loci=500, seed=52, gap_frac=0.1)
    al.codes[:, 400] = al.codes[:, 60]  # a planted outlier coupling
    fasta = str(tmp_path / "store.fasta")
    write_fasta(fasta, al)
    args = [fasta, "--mi-threshold", "0.03", "--no-filter-alignment", "--tile", "128"]
    outs = []
    for cap in ("16777216", "8"):
        out = tmp_path / cap
        assert torch_main(args + ["--store-capacity", cap, "--output-dir", str(out)]) == 0
        outs.append({p.name: p.read_bytes() for p in sorted(out.iterdir())})
    assert len(outs[0]) == 3 and outs[0] == outs[1]


def test_store_drops_past_capacity_and_counts():
    store = EdgeStore(5, True, torch.device("cpu"))
    cols = (torch.arange(8, dtype=torch.int32), torch.arange(8, dtype=torch.int32) + 1,
            torch.rand(8), torch.rand(8))
    store.append_plain(*(c[:3] for c in cols))
    store.append_plain(*(c[3:] for c in cols))
    assert int(store.count) == 8
    for a, c in zip(store.arrays(), cols):
        assert torch.equal(a, c[:5])
    store.checked = 5
    store.grow(12)
    assert store.capacity == 12 and all(torch.equal(a[:5], c[:5])
                                        for a, c in zip(store.arrays(), cols))


def test_store_orders_by_visit_then_i_then_j():
    store = EdgeStore(16, False, torch.device("cpu"))
    ipos = torch.tensor([300, 5, 130, 300, 2, 129], dtype=torch.int32)
    jpos = torch.tensor([310, 9, 200, 301, 7, 140], dtype=torch.int32)
    store.append_plain(ipos, jpos, ipos.float())
    got = store.ordered(0, 6, [256, 0, 128], TILE, 384)
    assert got[0].tolist() == [300, 300, 2, 5, 129, 130]
    assert got[1].tolist() == [301, 310, 7, 9, 140, 200]
    assert torch.equal(got[2], got[0].float())


def test_colmax_of_signed_zeros_is_order_free():
    """+0 beats -0 in colmax whatever their order (one total order on
    floats, as the kernel's atomics use); plain torch.maximum would keep
    the first of the tie."""
    T, Lp = 4, 8
    orig = torch.arange(Lp, dtype=torch.int32)
    gap = torch.zeros(Lp, dtype=torch.bool)
    results = []
    for flip in (False, True):
        mi = torch.full((T, Lp), -1.0)
        mi[:2, 6] = 0.25  # rows 0 and 1 keep their own maxima
        mi[0, 5], mi[1, 5] = (0.0, -0.0) if flip else (-0.0, 0.0)
        colmax = torch.full((Lp,), -np.inf)
        colmax[5] = -0.0
        row_select_plain(mi, None, gap, orig, colmax, EdgeStore(64, False, torch.device("cpu")),
                         0, Lp, 0.5, 0, True, Lp)
        results.append(colmax.view(torch.int32).clone())
    assert torch.equal(results[0], results[1])
    assert results[0][5] == 0 and results[0][0] == torch.tensor(0.25).view(torch.int32)


def test_row_select_rejects_other_devices():
    m = torch.zeros((8, 128), device="meta")
    v = torch.zeros(128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        row_select(m, None, v.bool(), v.int(), v, EdgeStore(4, False, torch.device("cpu")),
                   0, 128, 0.1, 0, False, 128)


WORKER = '''
import sys
import numpy as np
from spydrpick_torch.core.alignment import Alignment
from spydrpick_torch.engine.solver import EngineConfig, MIEngine
from spydrpick_torch.parallel.distributed import initialize_distributed, shutdown
from spydrpick_torch.parallel.mesh import ShardedEngineView, make_mesh, sharded_sweep
from spydrpick_torch.utils.profiling import recording

addr, world, rank, k, inp, out = sys.argv[1:]
initialize_distributed(addr, int(world), int(rank))
mesh = make_mesh(int(k))
z = np.load(inp)
S, L = z["codes"].shape
al = Alignment(z["codes"], [f"s{i}" for i in range(S)], "t", np.arange(L), L, z["weights"])
res = {}
for wog in ("outliers", "full"):
    for cap in (1 << 24, int(z["tiny"])):
        cfg = EngineConfig(tile=128, wog_fetch=wog, store_capacity=cap)
        eng = ShardedEngineView(al, cfg, mesh) if int(k) > 1 else MIEngine(al, cfg)
        rec = {}
        with recording(rec):
            e = sharded_sweep(eng, float(z["thr"]), mesh)
        for f in ("ipos", "jpos", "mi", "mi_wog", "colmax"):
            res[f"{wog}/{cap}/{f}"] = getattr(e, f)
        res[f"{wog}/{cap}/rerun"] = np.array(rec["counters"]["rows_reswept"])
np.savez(f"{out}/rank{rank}.npz", **res)
shutdown()
'''
MESHES = {"2x1": 1, "1x2": 2}  # rows x samples -> sample shards (two ranks each)


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("store")
    al = sweep_engine("full").alignment
    np.savez(d / "case.npz", codes=al.codes, weights=al.weights, thr=np.array(THR),
             tiny=np.array(TINY))
    (d / "worker.py").write_text(WORKER)
    jobs = []
    for name, k in MESHES.items():
        (d / name).mkdir()
        port = free_port()
        for r in range(2):
            jobs.append([sys.executable, str(d / "worker.py"), f"127.0.0.1:{port}", "2", str(r),
                         str(k), str(d / "case.npz"), str(d / name)])
    spawn(jobs)
    return {name: [dict(np.load(d / name / f"rank{r}.npz")) for r in range(2)]
            for name in MESHES}


@pytest.mark.parametrize("wog_fetch", ["outliers", "full"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_tiny_store_matches_default(sharded_runs, mesh, wog_fetch):
    """Each rank's tiny store overflows; every rank returns the default
    store's arrays element for element, which after sort_desc are the
    single-device sweep's (fixed14: bit for bit)."""
    want = sweep_engine(wog_fetch).sweep(THR).sort_desc()
    for res in sharded_runs[mesh]:
        assert int(res[f"{wog_fetch}/{TINY}/rerun"]) > 0
        assert int(res[f"{wog_fetch}/{1 << 24}/rerun"]) == 0
        for f in FIELDS:
            np.testing.assert_array_equal(res[f"{wog_fetch}/{TINY}/{f}"],
                                          res[f"{wog_fetch}/{1 << 24}/{f}"], err_msg=f)
    got = sharded_runs[mesh][0]
    e = EdgeSet(*(got[f"{wog_fetch}/{TINY}/{f}"] for f in FIELDS)).sort_desc()
    assert_equal_edges(e, want)
