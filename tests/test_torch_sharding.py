"""The port's sharded sweeps (spydrpick_torch/parallel) in real processes
joined by torch.distributed over gloo, on the CPU.

Each test's ranks are subprocesses started with the multi-host flags'
rendezvous (``initialize_distributed``) on a free local port; every wait
has a timeout, so a hung rank fails the test rather than the run.  The
ranks import no jax.  Mirrors tests/test_sharding.py:101-192 and 278-310
at the same sizes on 1x2, 2x1 and 2x2 (rows x samples) meshes, and
tests/test_cli_extra.py:144-173 for the CLI:

  * in the int8 modes (unit, fixed14) the gathered EdgeSet after
    ``sort_desc`` is the port's single-device sweep bit for bit, lazy and
    exact wog alike; bf16 sample shards sum f32 partial crosstables in
    another order, so there the JAX test's tolerance holds;
  * against JAX's ``sharded_sweep`` on ``make_mesh(2, n_samples=4)`` with
    ``use_pallas="on"`` the edge sets are equal apart from the flip band
    and MI agrees within the port's parity bound (XLA's f32 log is not
    torch's, so the two packages are not bit-equal even on one device);
  * a sample-sharded view's pair MI, pair wog and tournament equal the
    engine's bit for bit;
  * ``--sharded`` and ``--sharded --sample-shards 2`` under two ranks
    write couplings and outliers byte-identical to the single-process
    CLI, and only rank 0 writes.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from spydrpick_tpu.engine.solver import EngineConfig as JaxConfig
from spydrpick_tpu.engine.solver import MIEngine as JaxEngine
from spydrpick_tpu.io.fasta import write_fasta
from spydrpick_tpu.parallel.mesh import make_mesh as jax_make_mesh
from spydrpick_tpu.parallel.mesh import sharded_sweep as jax_sharded_sweep
from spydrpick_torch.cli import main as torch_main
from spydrpick_torch.engine.solver import EngineConfig, MIEngine
from spydrpick_torch.engine.threshold import determine_mi_threshold

from tests.conftest import random_alignment

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240  # seconds for every rank of one spawn
TOL = 1e-5     # the port's MI parity bound against the JAX package
FIELDS = ("ipos", "jpos", "mi", "mi_wog", "colmax")
MESHES = {"1x2": (2, 2), "2x1": (2, 1), "2x2": (4, 2)}  # name -> (world, sample shards)
# mode -> (alignment seed, mxu_int8, unit weights); tests/test_sharding.py's
MODES = {"unit": (50, "auto", True), "fixed14": (49, "auto", False), "bf16": (48, "off", False)}
WOGS = ("outliers", "full")
THR = 0.02


@pytest.fixture(autouse=True, scope="module")
def cpu_device():
    """These runs ask for the CPU, as a CLI run on a machine without a GPU
    must (spydrpick_torch/device.py); module-scoped, so that the module's
    fixtures that run the CLI see it too."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPYDRPICK_TORCH_DEVICE", "cpu")
        yield


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(jobs):
    """Run every job (a list of argv lists, one per rank) at once; fail
    the test if a rank times out or exits non-zero.  Returns the outputs."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="2", SPYDRPICK_TORCH_DEVICE="cpu")
    procs = [subprocess.Popen(argv, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              cwd=REPO) for argv in jobs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0].decode(errors="replace"))
    except subprocess.TimeoutExpired:
        pytest.fail("a rank timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for argv, p, out in zip(jobs, procs, outs):
        assert p.returncode == 0, f"{' '.join(argv[-6:])} failed:\n{out[-3000:]}"
    return outs


def mode_alignment(mode):
    seed, mxu_int8, unit = MODES[mode]
    al = random_alignment(n_samples=45, n_loci=256, seed=seed, gap_frac=0.1)
    al.codes[:, 190] = al.codes[:, 9]  # plant an outlier coupling
    if unit:
        al.weights = None
    return al, mxu_int8


WORKER = textwrap.dedent('''
    import sys
    import numpy as np
    from spydrpick_tpu.core.alignment import Alignment
    from spydrpick_torch.engine.solver import EngineConfig, MIEngine
    from spydrpick_torch.engine.threshold import determine_mi_threshold
    from spydrpick_torch.parallel.distributed import initialize_distributed, shutdown
    from spydrpick_torch.parallel.mesh import ShardedEngineView, make_mesh, sharded_sweep

    addr, world, rank, k, inp, out = sys.argv[1:]
    info = initialize_distributed(addr, int(world), int(rank))
    assert info["backend"] == "gloo" and info["device"] == "cpu", info
    mesh = make_mesh(int(k))
    cases = np.load(inp)
    res = {}
    for mode in cases["modes"]:
        codes, w = cases[mode + "/codes"], cases[mode + "/weights"]
        S, L = codes.shape
        al = Alignment(codes, [f"s{i}" for i in range(S)], "t", np.arange(L), L,
                       None if np.isnan(w).any() else w)
        for wog in ("outliers", "full"):
            cfg = EngineConfig(tile=128, mxu_int8=str(cases[mode + "/mxu"]), wog_fetch=wog)
            eng = ShardedEngineView(al, cfg, mesh) if int(k) > 1 else MIEngine(al, cfg)
            e = sharded_sweep(eng, float(cases["thr"]), mesh).sort_desc()
            for f in ("ipos", "jpos", "mi", "mi_wog", "colmax"):
                res[f"{mode}/{wog}/{f}"] = getattr(e, f)
        if int(k) > 1:
            ii, jj = cases["pairs_i"], cases["pairs_j"]
            res[mode + "/pair_mi"] = eng.pair_mi(ii, jj)
            res[mode + "/pair_wog"] = eng.pair_wog(ii, jj)
            res[mode + "/tournament"] = np.array(
                determine_mi_threshold(eng, 500, threshold_pairs=1000, iterations=3, seed=5))
    assert "jax" not in sys.modules
    np.savez(f"{out}/rank{rank}.npz", **res)
    shutdown()
''')


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    d = tmp_path_factory.mktemp("cases")
    arrays = {"modes": np.array(list(MODES)), "thr": np.array(THR)}
    rng = np.random.default_rng(0)
    ii = rng.integers(0, 256, size=500)
    arrays["pairs_i"], arrays["pairs_j"] = ii, (ii + 1 + rng.integers(0, 254, size=500)) % 256
    for mode in MODES:
        al, mxu = mode_alignment(mode)
        arrays[mode + "/codes"] = al.codes
        arrays[mode + "/weights"] = (np.full(al.n_samples, np.nan) if al.weights is None
                                     else al.weights)
        arrays[mode + "/mxu"] = np.array(mxu)
    np.savez(d / "cases.npz", **arrays)
    (d / "worker.py").write_text(WORKER)
    return d, arrays


@pytest.fixture(scope="module")
def mesh_runs(cases):
    """Every mesh's ranks, all started at once: {mesh: [rank results]}."""
    d, _ = cases
    jobs, owners = [], []
    for name, (world, k) in MESHES.items():
        out = d / name
        out.mkdir()
        port = free_port()
        for r in range(world):
            jobs.append([sys.executable, str(d / "worker.py"), f"127.0.0.1:{port}", str(world),
                         str(r), str(k), str(d / "cases.npz"), str(out)])
        owners.append((name, world, out))
    spawn(jobs)
    return {name: [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]
            for name, world, out in owners}


@pytest.fixture(scope="module")
def single_device(cases):
    """The port's single-device sweeps, engines and tournaments."""
    res = {}
    for mode in MODES:
        al, mxu = mode_alignment(mode)
        for wog in WOGS:
            eng = MIEngine(al, EngineConfig(tile=128, mxu_int8=mxu, wog_fetch=wog), device="cpu")
            e = eng.sweep(THR).sort_desc()
            res[mode, wog] = {f: getattr(e, f) for f in FIELDS}
        res[mode, "engine"] = eng
    return res


@pytest.mark.parametrize("mesh", list(MESHES))
def test_every_rank_ends_with_the_same_results(mesh_runs, mesh):
    first, *others = mesh_runs[mesh]
    for other in others:
        assert first.keys() == other.keys()
        for key in first:
            np.testing.assert_array_equal(first[key], other[key], err_msg=key)


@pytest.mark.parametrize("wog", WOGS)
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_sweep_matches_single_device(mesh_runs, single_device, mesh, mode, wog):
    got = mesh_runs[mesh][0]
    want = single_device[mode, wog]
    assert len(want["mi"]) > 1000
    if mode != "bf16" or MESHES[mesh][1] == 1:
        for f in FIELDS:  # exact int32 sums: bit for bit
            np.testing.assert_array_equal(got[f"{mode}/{wog}/{f}"], want[f], err_msg=f)
        return
    # bf16 sample shards: tests/test_sharding.py:101-120's bound
    ref = {k: i for i, k in enumerate(zip(want["ipos"].tolist(), want["jpos"].tolist()))}
    mine = {k: i for i, k in enumerate(zip(got[f"{mode}/{wog}/ipos"].tolist(),
                                           got[f"{mode}/{wog}/jpos"].tolist()))}
    for k in set(ref) ^ set(mine):
        m = want["mi"][ref[k]] if k in ref else got[f"{mode}/{wog}/mi"][mine[k]]
        assert abs(m - THR) <= TOL, k
    common = sorted(set(ref) & set(mine))
    a, b = [ref[k] for k in common], [mine[k] for k in common]
    np.testing.assert_allclose(got[f"{mode}/{wog}/mi"][b], want["mi"][a], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got[f"{mode}/{wog}/mi_wog"][b], want["mi_wog"][a], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(got[f"{mode}/{wog}/colmax"], want["colmax"], rtol=1e-4)


@pytest.mark.parametrize("mode", list(MODES))
def test_sample_sharded_sweep_matches_jax_sharded_sweep(mesh_runs, mode):
    """The port's 2x2 mesh against the JAX package's 2x4 (rows x samples)
    mesh with its Pallas kernels (interpret mode), both exact-wog."""
    al, mxu = mode_alignment(mode)
    cfg = JaxConfig(tile=128, use_pallas="on", mxu_int8=mxu, wog_fetch="full")
    ref = jax_sharded_sweep(JaxEngine(al, cfg), THR, jax_make_mesh(2, n_samples=4))
    got = mesh_runs["2x2"][0]
    ea = {(i, j): (m, w) for i, j, m, w in zip(
        *(got[f"{mode}/full/{f}"].tolist() for f in ("ipos", "jpos", "mi", "mi_wog")))}
    eb = {(i, j): (m, w) for i, j, m, w in zip(ref.ipos.tolist(), ref.jpos.tolist(),
                                               ref.mi.tolist(), ref.mi_wog.tolist())}
    for k in set(ea) ^ set(eb):
        assert abs(ea.get(k, eb.get(k))[0] - THR) <= TOL, k
    common = set(ea) & set(eb)
    assert len(common) > 1000
    for k in common:
        assert abs(ea[k][0] - eb[k][0]) <= TOL and abs(ea[k][1] - eb[k][1]) <= TOL, k
    np.testing.assert_allclose(got[f"{mode}/full/colmax"], ref.colmax, rtol=0, atol=TOL)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_view_pairs_and_tournament_equal_the_engine(cases, mesh_runs, single_device, mesh,
                                                    mode):
    """tests/test_sharding.py:278-310, held bit for bit: the view gathers
    the pairs' codes over the sample shards and reduces them as the
    engine does."""
    _, arrays = cases
    eng = single_device[mode, "engine"]
    got = mesh_runs[mesh][0]
    ii, jj = arrays["pairs_i"], arrays["pairs_j"]
    np.testing.assert_array_equal(got[mode + "/pair_mi"], eng.pair_mi(ii, jj))
    np.testing.assert_array_equal(got[mode + "/pair_wog"], eng.pair_wog(ii, jj))
    want = determine_mi_threshold(eng, 500, threshold_pairs=1000, iterations=3, seed=5)
    assert float(got[mode + "/tournament"]) == want


CLI_VARIANTS = {
    "rows": ["--sharded", "--mi-threshold", "0.05"],
    "2d": ["--sharded", "--sample-shards", "2", "--mi-threshold", "0.05"],
    "2d_tournament": ["--sharded", "--sample-shards", "2"],
}


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The CLI in one process and under two ranks for each variant."""
    d = tmp_path_factory.mktemp("cli")
    al = random_alignment(n_samples=48, n_loci=300, seed=29, gap_frac=0.08)
    fasta = str(d / "sh.fasta")
    write_fasta(fasta, al)
    base = [fasta, "--ld-threshold", "10", "--seed", "5", "--tile", "128"]
    singles = {}
    for thr in (["--mi-threshold", "0.05"], []):
        out = d / f"single{len(thr)}"
        assert torch_main(base + thr + ["--output-dir", str(out)]) == 0
        singles[bool(thr)] = out
    jobs = []
    for name, extra in CLI_VARIANTS.items():
        port = free_port()
        for r in range(2):
            jobs.append([sys.executable, "-m", "spydrpick_torch", *base, *extra, "-v",
                         "--coordinator-address", f"127.0.0.1:{port}", "--num-processes", "2",
                         "--process-id", str(r), "--output-dir", str(d / name / f"rank{r}")])
    logs = spawn(jobs)
    return d, singles, logs


@pytest.mark.parametrize("variant", list(CLI_VARIANTS))
def test_cli_sharded_matches_single_process(cli_runs, variant):
    d, singles, logs = cli_runs
    want = singles["--mi-threshold" in CLI_VARIANTS[variant]]
    i = list(CLI_VARIANTS).index(variant) * 2
    # each rank's -v log (the tournament's thresholds among its lines)
    ranks_log = "".join(f"\n--- rank {r} ---\n{logs[i + r]}" for r in range(2))
    names = sorted(os.listdir(want))
    assert any(n.endswith("edges") for n in names) and any(n.endswith("outliers") for n in names)
    assert sorted(os.listdir(d / variant / "rank0")) == names, ranks_log
    assert not (d / variant / "rank1").exists()  # only rank 0 writes
    for n in names:
        assert (d / variant / "rank0" / n).read_bytes() == (want / n).read_bytes(), n + ranks_log
    for r in range(2):
        assert f"rank {r} of 2 on cpu (gloo backend)" in logs[i + r]
        assert "mesh rows x samples = " + ("(1, 2)" if "2d" in variant else "(2, 1)") in logs[i + r]
