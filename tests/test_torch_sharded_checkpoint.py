"""``--checkpoint`` over the mesh (spydrpick_torch/parallel/mesh.py:
``sharded_sweep(checkpoint_path=...)``) in real processes joined by
torch.distributed over gloo, on the CPU; the counterparts of the JAX
package's tests/test_sharding.py:345-470 (plain, j-windowed, lazy wog).

Every rank of a library run sweeps each case three times: clean, killed
from the progress callback at the same local row on every rank (before
that row's save, so no rank is left in a collective), and resumed from
the killed run's snapshot.  The cases: lazy and exact wog, with and
without j-windows, once from an 8-slot store that overflows and re-sweeps
before every save; all of them on the 2x1 (rows x samples) mesh, two on
each of the 1x2 and 2x2 meshes (``MESH_CASES``):

  * the resumed ``EdgeSet`` after ``sort_desc`` is the clean run's, and
    the clean run is ``MIEngine.sweep``'s in one process, bit for bit
    (int8 modes);
  * the snapshot holds the first rows of the balanced order that every
    rank completed, and only their edges; the resumed run sweeps the
    rest and process 0 deletes the file;
  * a 2x1 snapshot resumes in one process and a one-process snapshot
    resumes on 2x1 (the key is the same).

The CLI under two and four ranks with ``--checkpoint``, with and
without ``--sharded``, writes files byte-identical to one process's;
rank 1 writes nothing and the file is gone afterwards.
"""

import os
import shutil
import sys
import textwrap

import numpy as np
import pytest

from spydrpick_tpu.io.fasta import write_fasta
from spydrpick_torch.cli import main as torch_main
from spydrpick_torch.engine import checkpoint as ck
from spydrpick_torch.engine.solver import EngineConfig, MIEngine
from spydrpick_torch.parallel.mesh import balanced_row_order
from spydrpick_torch.pipeline import PipelineOptions, engine_config, load_and_preprocess

from tests.conftest import random_alignment
from tests.test_torch_checkpoint import Killed, killer
from tests.test_torch_sharding import free_port, spawn

TILE = 128
THR = 0.02
L = 700
N_ROWS = -(-L // TILE)
EVERY = 2   # checkpoint_every: block-rows over the whole mesh
KILL = 3    # the progress call (this rank's rows) that kills the run
FIELDS = ("ipos", "jpos", "mi", "mi_wog", "colmax")
MESHES = {"2x1": (2, 1), "1x2": (2, 2), "2x2": (4, 2)}  # name -> (world, sample shards)
# case -> (alignment seed, unit weights, wog_fetch, row_window, store_capacity)
CASES = {
    "lazy": (71, False, "outliers", 0, 1 << 24),
    "exact": (72, True, "full", 0, 1 << 24),
    "lazy_window": (73, True, "outliers", 256, 1 << 24),
    "exact_window_store8": (74, False, "full", 256, 8),
}
# mesh -> its cases: every case on the rows mesh (which also resumes
# one-process snapshots); each sample-sharded mesh runs one lazy and one
# exact case, one of them j-windowed (their sweeps cost the most on the CPU)
MESH_CASES = {"2x1": list(CASES), "1x2": ["lazy", "exact_window_store8"],
              "2x2": ["exact", "lazy_window"]}
RUNS = [(mesh, case) for mesh, cases in MESH_CASES.items() for case in cases]


@pytest.fixture(autouse=True, scope="module")
def cpu_device():
    """These runs ask for the CPU (spydrpick_torch/device.py); module-
    scoped, so that the module's fixtures see it too."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPYDRPICK_TORCH_DEVICE", "cpu")
        yield


def case_alignment(case):
    seed, unit, *_ = CASES[case]
    al = random_alignment(n_samples=48, n_loci=L, seed=seed, gap_frac=0.15)
    al.codes[:, 650] = al.codes[:, 20]  # a planted outlier coupling
    if unit:
        al.weights = None
    return al


def case_config(case):
    _, _, wog, rw, store = CASES[case]
    return EngineConfig(tile=TILE, wog_fetch=wog, row_window=rw, store_capacity=store)


def saved_rows(rows_ranks):
    """The rows that a run killed at progress call KILL on every rank has
    saved.  Saves come after every ceil(EVERY / rows_ranks) local rows,
    none after the last round; progress runs at a check before its save,
    so the last save is the last one at a local row before row KILL - 1.
    It covers the first rounds of the balanced order."""
    rounds = -(-EVERY // rows_ranks)
    saves = [k for k in range(rounds - 1, N_ROWS // rows_ranks, rounds)
             if (k + 1) * rows_ranks < N_ROWS]
    last = max(k for k in saves if k < KILL - 1)
    order = [r * TILE for r in balanced_row_order(N_ROWS)]
    return set(order[:(last + 1) * rows_ranks])


WORKER = textwrap.dedent('''
    import os
    import shutil
    import sys
    import numpy as np
    import torch.distributed as dist
    from spydrpick_torch.core.alignment import Alignment
    from spydrpick_torch.engine import checkpoint as ck
    from spydrpick_torch.engine.solver import EngineConfig, MIEngine
    from spydrpick_torch.parallel.distributed import initialize_distributed, shutdown
    from spydrpick_torch.parallel.mesh import (ShardedEngineView, checkpoint_key, make_mesh,
                                               sharded_sweep)
    from spydrpick_torch.utils.profiling import recording

    class Killed(Exception):
        pass

    def killer(after):
        seen = []
        def progress(lo, hi, n, dt):
            seen.append(lo)
            if len(seen) == after:
                raise Killed
        return progress, seen

    addr, world, rank, k, inp, out, cases = sys.argv[1:]
    rank, k = int(rank), int(k)
    initialize_distributed(addr, int(world), rank)
    mesh = make_mesh(k)
    z = np.load(inp)
    thr, every, kill = float(z["thr"]), int(z["every"]), int(z["kill"])
    res = {}

    def engine(case):
        codes, w = z[case + "/codes"], z[case + "/weights"]
        S, L = codes.shape
        al = Alignment(codes, [f"s{i}" for i in range(S)], "t", np.arange(L), L,
                       None if np.isnan(w).any() else w)
        wog, rw, store = z[case + "/config"]
        cfg = EngineConfig(tile=int(z["tile"]), wog_fetch=str(wog), row_window=int(rw),
                           store_capacity=int(store))
        return ShardedEngineView(al, cfg, mesh) if k > 1 else MIEngine(al, cfg)

    def put(name, edges, rows=None):
        for f in ("ipos", "jpos", "mi", "mi_wog", "colmax"):
            res[f"{name}/{f}"] = getattr(edges.sort_desc(), f)
        if rows is not None:
            res[name + "/n_rows"] = np.array(rows["n_rows"])
            res[name + "/rerun_rows"] = np.array(rows["rerun_rows"])

    def recorded(*args, **kw):
        """sharded_sweep(*args, **kw), recorded: its edges and the block-rows
        this rank swept (progress sees each once) and swept again."""
        rec, seen = {}, []
        with recording(rec):
            edges = sharded_sweep(*args, progress=lambda lo, hi, n, dt: seen.append(lo), **kw)
        return edges, {"n_rows": len(seen), "rerun_rows": rec["counters"]["rows_reswept"]}

    for case in cases.split(","):
        path = os.path.join(out, case + ".ckpt")
        put(case + "/clean", *recorded(engine(case), thr, mesh))
        progress, _ = killer(kill)
        try:
            sharded_sweep(engine(case), thr, mesh, progress=progress, checkpoint_path=path,
                          checkpoint_every=every)
            raise AssertionError("the sweep was not killed")
        except Killed:
            pass
        dist.barrier()  # process 0 may still be writing its last save
        eng = engine(case)
        snap = ck.load(path, checkpoint_key(eng, thr, mesh))
        res[case + "/done_rows"] = np.array(sorted(snap.done_rows))
        res[case + "/snap_ipos"] = np.concatenate(snap.ipos) if snap.ipos else np.zeros(0)
        if rank == 0 and k == 1:
            shutil.copy(path, os.path.join(out, case + ".cross"))
        put(case + "/resumed", *recorded(eng, thr, mesh, checkpoint_path=path,
                                         checkpoint_every=every))
        dist.barrier()
        res[case + "/file_left"] = np.array(os.path.exists(path))
        one = os.path.join(os.path.dirname(inp), case + ".single.ckpt")
        if k == 1 and os.path.exists(one):  # a one-process snapshot, resumed on this mesh
            mine = os.path.join(out, case + ".from_single.ckpt")
            if rank == 0:
                shutil.copy(one, mine)
            dist.barrier()
            put(case + "/from_single", *recorded(engine(case), thr, mesh,
                                                 checkpoint_path=mine))
    assert "jax" not in sys.modules and "spydrpick_tpu" not in sys.modules
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    shutdown()
''')


@pytest.fixture(scope="module")
def single_process(tmp_path_factory):
    """Each case's one-process clean sweep, and a one-process snapshot of
    a killed sweep (saved every EVERY rows, killed at row KILL)."""
    d = tmp_path_factory.mktemp("single")
    res = {}
    for case in CASES:
        al, cfg = case_alignment(case), case_config(case)
        res[case] = MIEngine(al, cfg, device="cpu").sweep(THR).sort_desc()
        progress, _ = killer(KILL)
        with pytest.raises(Killed):
            MIEngine(al, cfg, device="cpu").sweep(THR, progress=progress,
                                                  checkpoint_path=str(d / f"{case}.single.ckpt"),
                                                  checkpoint_every=EVERY)
    return d, res


@pytest.fixture(scope="module")
def mesh_runs(single_process):
    """Every mesh's ranks, all started at once: {mesh: (out dir, [rank results])}."""
    d, _ = single_process
    arrays = {"thr": np.array(THR), "tile": np.array(TILE),
              "every": np.array(EVERY), "kill": np.array(KILL)}
    for case, (_, _, wog, rw, store) in CASES.items():
        al = case_alignment(case)
        arrays[case + "/codes"] = al.codes
        arrays[case + "/weights"] = (np.full(al.n_samples, np.nan) if al.weights is None
                                     else al.weights)
        arrays[case + "/config"] = np.array([wog, str(rw), str(store)])
    np.savez(d / "cases.npz", **arrays)
    (d / "worker.py").write_text(WORKER)
    jobs, owners = [], []
    for name, (world, k) in MESHES.items():
        out = d / name
        out.mkdir()
        port = free_port()
        for r in range(world):
            jobs.append([sys.executable, str(d / "worker.py"), f"127.0.0.1:{port}", str(world),
                         str(r), str(k), str(d / "cases.npz"), str(out),
                         ",".join(MESH_CASES[name])])
        owners.append((name, world, out))
    spawn(jobs)
    return {name: (out, [dict(np.load(out / f"rank{r}.npz")) for r in range(world)])
            for name, world, out in owners}


def assert_same_edges(got, prefix, want):
    for f in FIELDS:
        np.testing.assert_array_equal(got[f"{prefix}/{f}"], getattr(want, f),
                                      err_msg=f"{prefix}/{f}")


@pytest.mark.parametrize("mesh,case", RUNS)
def test_sharded_clean_run_equals_one_process(mesh_runs, single_process, mesh, case):
    _, ranks = mesh_runs[mesh]
    want = single_process[1][case]
    assert want.n_edges > 1000
    for res in ranks:
        assert_same_edges(res, case + "/clean", want)


@pytest.mark.parametrize("mesh,case", RUNS)
def test_sharded_resume_equals_clean_run(mesh_runs, single_process, mesh, case):
    """Every rank of the resumed run returns the clean run's EdgeSet
    (lazy wog resolved over snapshot and fresh rows alike)."""
    _, ranks = mesh_runs[mesh]
    for res in ranks:
        assert_same_edges(res, case + "/resumed", single_process[1][case])
    if CASES[case][4] == 8:  # the 8-slot store overflowed and re-swept rows
        assert all(res[case + "/resumed/rerun_rows"] > 0 for res in ranks)


@pytest.mark.parametrize("mesh,case", RUNS)
def test_snapshot_holds_the_rows_every_rank_completed(mesh_runs, mesh, case):
    """The killed run saved the first rounds of the balanced order and
    only their edges; the resumed run swept the rest, once over the
    rows axis, and process 0 deleted the file."""
    world, k = MESHES[mesh]
    out, ranks = mesh_runs[mesh]
    done = saved_rows(world // k)
    assert 0 < len(done) < N_ROWS
    for res in ranks:
        assert set(res[case + "/done_rows"].tolist()) == done
        assert set((res[case + "/snap_ipos"] // TILE * TILE).tolist()) == done
        assert not res[case + "/file_left"]
    per_row_group = [int(res[case + "/resumed/n_rows"]) for r, res in enumerate(ranks)
                     if r % k == 0]
    assert sum(per_row_group) == N_ROWS - len(done)
    assert sum(int(res[case + "/clean/n_rows"]) for r, res in enumerate(ranks)
               if r % k == 0) == N_ROWS
    assert not os.path.exists(out / f"{case}.ckpt")


@pytest.mark.parametrize("case", list(CASES))
def test_rows_mesh_snapshot_resumes_in_one_process(mesh_runs, single_process, tmp_path, case):
    out, _ = mesh_runs["2x1"]
    path = str(tmp_path / "x.ckpt")
    shutil.copy(out / f"{case}.cross", path)
    progress, seen = killer(-1)
    eng = MIEngine(case_alignment(case), case_config(case), device="cpu")
    got = eng.sweep(THR, progress=progress, checkpoint_path=path).sort_desc()
    assert len(seen) == N_ROWS - len(saved_rows(2))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(single_process[1][case], f))
    assert not os.path.exists(path)


@pytest.mark.parametrize("case", list(CASES))
def test_one_process_snapshot_resumes_on_rows_mesh(mesh_runs, single_process, case):
    _, ranks = mesh_runs["2x1"]
    done = ck.load(str(single_process[0] / f"{case}.single.ckpt"),
                   ck.params_key(MIEngine(case_alignment(case), case_config(case),
                                          device="cpu").statics, THR)).done_rows
    assert 0 < len(done) < N_ROWS
    for res in ranks:
        assert_same_edges(res, case + "/from_single", single_process[1][case])
    assert sum(int(res[case + "/from_single/n_rows"]) for res in ranks) == N_ROWS - len(done)


CLI_BASE = ["--ld-threshold", "10", "--seed", "5", "--tile", "128", "--mi-threshold", "0.05"]
# variant -> (processes, flags, resumes a one-process snapshot)
CLI_VARIANTS = {
    "2x1": (2, ["--sharded", "--checkpoint-every", "1"], False),
    "2x1_resume": (2, ["--sharded"], True),
    "1x2": (2, ["--sharded", "--sample-shards", "2", "--checkpoint-every", "1"], False),
    "2x2_resume": (4, ["--sharded", "--sample-shards", "2"], True),
    "unsharded_resume": (2, [], True),
}
PROGRESS_LINE = r"spydrpick-torch: +\d+-\d+ / \d+ \(\d+ new edges\)"


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The CLI in one process, a snapshot of a killed sweep of the engine
    that ``run_pipeline`` builds (saved every 2 rows, killed at row 3),
    and each variant's ranks, all started at once."""
    d = tmp_path_factory.mktemp("cli")
    al = random_alignment(n_samples=48, n_loci=L, seed=29, gap_frac=0.08)
    al.codes[:, 600] = al.codes[:, 60]  # a planted outlier coupling
    fasta = str(d / "ck.fasta")
    write_fasta(fasta, al)
    weights = d / "ck.weights"  # fixed14 weights: f32 sums over samples in the pairs path
    weights.write_text("\n".join(repr(float(w)) for w in al.weights) + "\n")
    base = [fasta, "--sample-weights", str(weights), *CLI_BASE]
    assert torch_main([*base, "--output-dir", str(d / "single")]) == 0
    opts = PipelineOptions(alignmentfile=fasta, ld_threshold=10, seed=5, tile=128,
                           mi_threshold=0.05, sample_weights=str(weights))
    eng = MIEngine(load_and_preprocess(opts), engine_config(opts), device="cpu")
    assert eng.statics.int8_mode == "fixed14"
    snapshot = str(d / "single.ckpt")
    progress, _ = killer(KILL)
    with pytest.raises(Killed):
        eng.sweep(0.05, progress=progress, checkpoint_path=snapshot, checkpoint_every=EVERY)
    done = ck.load(snapshot, ck.params_key(eng.statics, 0.05)).done_rows
    n_rows = -(-eng.L // TILE)  # of the filtered alignment
    jobs, spans = [], {}
    for name, (world, flags, resume) in CLI_VARIANTS.items():
        path = d / f"{name}.ckpt"
        if resume:
            shutil.copy(snapshot, path)
        port = free_port()
        spans[name] = (len(jobs), world)
        for r in range(world):
            jobs.append([sys.executable, "-m", "spydrpick_torch", *base, *flags,
                         "--checkpoint", str(path), "-v", "--coordinator-address",
                         f"127.0.0.1:{port}", "--num-processes", str(world), "--process-id",
                         str(r), "--output-dir", str(d / name / f"rank{r}")])
    logs = spawn(jobs)
    return d, done, n_rows, {name: logs[i:i + n] for name, (i, n) in spans.items()}


@pytest.mark.parametrize("variant", list(CLI_VARIANTS))
def test_cli_checkpointed_ranks_match_one_process(cli_runs, variant):
    """Rank 0 writes the one-process files byte for byte, no other rank
    writes, and the snapshot is gone; a resumed run sweeps only the rows
    the snapshot lacks (once over the ranks of a sharded run, on each
    process of an unsharded one, unless process 0 had deleted the file
    before a later process read it)."""
    import re

    d, done, n_rows, logs = cli_runs
    world, flags, resume = CLI_VARIANTS[variant]
    want = d / "single"
    names = sorted(os.listdir(want))
    assert any(n.endswith("edges") for n in names) and any(n.endswith("outliers") for n in names)
    assert sorted(os.listdir(d / variant / "rank0")) == names
    for n in names:
        assert (d / variant / "rank0" / n).read_bytes() == (want / n).read_bytes(), n
    for r in range(1, world):
        assert not (d / variant / f"rank{r}").exists()  # only rank 0 writes
    assert not (d / f"{variant}.ckpt").exists()
    swept = [len(re.findall(PROGRESS_LINE, log)) for log in logs[variant]]
    todo = n_rows - len(done) if resume else n_rows
    assert 0 < len(done) < n_rows
    if "--sharded" not in flags:
        assert swept[0] == todo and all(n in (todo, n_rows) for n in swept)
        return
    k = 2 if "--sample-shards" in flags else 1
    assert sum(swept[::k]) == todo  # the rows axis shares the rows out
    for r, log in enumerate(logs[variant]):
        assert f"rank {r} of {world} on cpu (gloo backend)" in log
        assert "checkpoint saves: " in log


def test_lazy_wog_does_not_depend_on_the_edge_order(single_process):
    """Sharded and resumed sweeps return their edges in other orders than
    one sweep; the lazy wog of the outlier candidates (f32 sums over the
    samples of each pair in a batch) must not follow that order."""
    eng = MIEngine(case_alignment("lazy"), case_config("lazy"), device="cpu")
    assert eng.statics.int8_mode == "fixed14"
    e = single_process[1]["lazy"]
    # a flat colmax puts the outlier threshold at 0.1: hundreds of candidates
    colmax = np.full(L, 0.1)
    want = eng._resolve_deferred_wog(e.mi, e.ipos, e.jpos, colmax)
    assert (want != e.mi).sum() > 200  # candidates with gaps got their own wog
    perm = np.random.default_rng(0).permutation(e.n_edges)
    got = eng._resolve_deferred_wog(e.mi[perm], e.ipos[perm], e.jpos[perm], colmax)
    np.testing.assert_array_equal(got, want[perm])
