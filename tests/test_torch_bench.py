"""The port's benchmark (spydrpick_torch/bench.py) on the CPU, at
tests/test_bench_smoke.py's shape (S=40, L=512), held to the JAX
``bench.main()`` on the same knobs.

The port's tiles are multiples of 128 columns, so both benches run
BENCH_TILE=128 (the smoke test's 64 is below the port's minimum); the
tile changes no edge.  BENCH_MXU_INT8=off puts both sweeps in the same
int8 mode: on the CPU the JAX engine runs no Pallas and so resolves
"auto" to "off", where the port resolves it to fixed14.  The end-to-end
runs take no knob but the tile in either bench (bench.py:229-283), so
there the port runs fixed14 and the JAX package its f32 path; their
tournaments' thresholds differ by ~5e-7 here, and the counts are held to
the pairs within TOL of the thresholds."""

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import pytest

from spydrpick_torch import bench
from spydrpick_torch.core.alignment import Alignment
from spydrpick_torch.engine.solver import EngineConfig, MIEngine
from spydrpick_torch.stage_profile import bench_alignment

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, L = 40, 512
TOL = 1e-5  # the MI tolerance against the JAX package (tests/test_torch_cli.py)
KNOBS = {"BENCH_SAMPLES": str(S), "BENCH_LOCI": str(L), "BENCH_TILE": "128",
         "BENCH_ONEHOT": "codes", "BENCH_MXU_INT8": "off", "BENCH_SWEEPS": "2",
         "BENCH_SWEEPS_MAX": "2", "BENCH_E2E_RUNS": "2"}
TPU_KNOBS = {"BENCH_ROWS": "2", "BENCH_DEPTH": "1", "BENCH_PALLAS_COMPACT": "off"}


def run_port_bench(env: dict):
    """``bench.main()`` in this process on the CPU with ``env`` set and
    every other BENCH_ variable unset; (rc, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        for k in [k for k in os.environ if k.startswith("BENCH_")]:
            mp.delenv(k)
        mp.setenv("SPYDRPICK_TORCH_DEVICE", "cpu")
        for k, v in env.items():
            mp.setenv(k, v)
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = bench.main()
    return rc, out.getvalue(), err.getvalue()


def last_json(stdout: str) -> dict:
    lines = [line for line in stdout.splitlines() if line.startswith("{")]
    assert len(lines) == 1, stdout[-2000:]
    assert stdout.rstrip("\n").splitlines()[-1] == lines[0]
    return json.loads(lines[0])


@pytest.fixture(scope="module")
def port_run():
    rc, out, err = run_port_bench(KNOBS)
    assert rc == 0, out[-2000:] + err
    return last_json(out), err


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX ``bench.main()`` in a subprocess, through the stub of
    tests/test_bench_smoke.py (it pins jax to the CPU)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(KNOBS, BENCH_INNER="1", BENCH_DEPTH="2", JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    stub = tmp_path_factory.mktemp("jax_bench") / "run_bench.py"
    stub.write_text("import jax\n"
                    "jax.config.update('jax_platforms', 'cpu')\n"
                    "import bench\n"
                    "import sys\n"
                    "sys.exit(bench.main())\n")
    res = subprocess.run([sys.executable, "-u", str(stub)], env=env, capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert res.returncode in (0, None), res.stdout[-2000:] + res.stderr[-2000:]
    return last_json(res.stdout)


@pytest.fixture(scope="module")
def port_engine():
    """A port engine on the bench's data in the sweep's int8 mode, for
    counting the pairs near a threshold."""
    codes, w, _, _ = bench.bench_data(S, L, unit_weights=False)
    al = Alignment(codes, [f"s{i}" for i in range(S)], "bench", np.arange(L), L, w)
    return MIEngine(al, EngineConfig(tile=128, mxu_int8="off"), device="cpu")


def pairs_near(engine, t0: float, t1: float) -> int:
    """Pairs whose MI lies within TOL of [min(t0, t1), max(t0, t1)]."""
    lo, hi = min(t0, t1) - TOL, max(t0, t1) + TOL
    mi = engine.sweep(lo).mi
    return int(np.sum(mi <= hi))


def test_line_keys_and_types(port_run):
    """(a) bench.py's line (tests/test_bench_smoke.py:42-55) and the port's
    own keys; a CPU run names no device and no power limit."""
    res, err = port_run
    assert res["metric"] == "mi_column_pairs_per_s"
    assert isinstance(res["value"], float) and res["value"] > 0
    assert res["unit"] == "column-pairs/s/chip"
    assert res["vs_baseline"] == round(res["value"] / bench.BASELINE_CPU_PAIRS_PER_S, 3)
    cfg = res["config"]
    assert cfg["baseline_denominator"] == 9.19e6
    assert (cfg["samples"], cfg["loci"], cfg["tile"]) == (S, L, 128)
    assert cfg["backend"] == "cpu" and cfg["device"] == "cpu"
    assert cfg["power_limit"] == "not measured" and cfg["sweep_peak_gib"] == "not measured"
    assert cfg["device_count"] == 0 and isinstance(cfg["torch"], str)
    assert (cfg["int8_mode"], cfg["onehot_storage"], cfg["row_window"]) == ("off", "codes", 0)
    assert isinstance(cfg["edges"], int) and cfg["edges"] > 0
    assert isinstance(cfg["threshold"], float) and cfg["threshold"] > 0
    assert cfg["sweep_seconds"] == min(cfg["sweep_seconds_all"])
    assert len(cfg["sweep_seconds_all"]) == 2 and cfg["first_run_seconds"] > 0
    assert "min of 2 sweeps" in cfg["sweep_method"]
    assert cfg["phases"]["n_rows"] == L // 128 and cfg["phases"]["rerun_rows"] == 0
    assert "pallas_bs" not in cfg and "rows_per_dispatch" not in cfg
    e2e = cfg["end_to_end_s"]
    for k in ("preprocess_s", "threshold_s", "sweep_s", "sort_s", "aracne_s", "write_s",
              "total_s", "cold_total_s", "cold_threshold_s", "cold_sweep_s"):
        assert isinstance(e2e[k], float) and e2e[k] >= 0, k
    for k in ("compute_s", "fetch_s", "wog_s", "n_items", "rerun_rows"):
        assert k in e2e["sweep_phases"], k
    assert "native_s" in e2e["aracne_phases"]
    for k in ("parse_s", "lists_s", "filter_s", "weights_s", "outputs_s"):
        assert k in e2e["preprocess_phases"], k
    for k in ("couplings_s", "outliers_s", "nodes_s"):
        assert k in e2e["write_phases"], k
    assert isinstance(e2e["edges"], int) and e2e["edges"] > 0
    assert e2e["peak_gib_all"] == ["not measured"] * 2
    # the CPU runs the kernels' plain versions: no launch counts
    assert e2e["launches_all"] == [dict.fromkeys(bench.kernel_counters(), 0)] * 2
    assert "ignored" not in err


def test_port_bench_matches_jax_bench(port_run, jax_run, port_engine):
    """(b) The same data and threshold rule give the JAX bench's threshold,
    int8 mode and edges (apart from pairs within TOL of the threshold), in
    the sweep and end to end."""
    got, want = port_run[0]["config"], jax_run["config"]
    assert got["int8_mode"] == want["int8_mode"]
    assert abs(got["threshold"] - want["threshold"]) <= TOL
    assert abs(got["edges"] - want["edges"]) <= pairs_near(port_engine, got["threshold"],
                                                           want["threshold"])
    ge, we = got["end_to_end_s"], want["end_to_end_s"]
    assert abs(ge["mi_threshold"] - we["mi_threshold"]) <= TOL
    assert abs(ge["edges"] - we["edges"]) <= pairs_near(port_engine, ge["mi_threshold"],
                                                        we["mi_threshold"])


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
    """(c) The codes, weights and threshold pairs are bench.py's draws, with
    and without BENCH_UNIT_WEIGHTS=1 (which draws no weights, so the pairs
    come from another state of the generator); stage_profile's callers
    still get the weighted codes and weights of ``default_rng(seed)``."""
    got, want = bench.bench_data(300, 700, unit_weights), replay(300, 700, unit_weights)
    for g, w in zip(got, want):
        assert (g is None and w is None) or np.array_equal(g, w)
    codes, w = bench_alignment(300, 700, seed=0)
    weighted = replay(300, 700, False)
    assert np.array_equal(codes, weighted[0]) and np.array_equal(w, weighted[1])


def test_without_gpu_or_cpu_request_exits_1():
    """(d) No GPU and no SPYDRPICK_TORCH_DEVICE: exit 1, the variable named,
    no JSON line."""
    import torch

    if torch.cuda.is_available():
        return  # the rule is about machines without a GPU
    env = {k: v for k, v in os.environ.items() if k != "SPYDRPICK_TORCH_DEVICE"}
    res = subprocess.run([sys.executable, "-m", "spydrpick_torch.bench"], cwd=ROOT,
                         env=dict(env, BENCH_SAMPLES=str(S), BENCH_LOCI=str(L)),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 1
    assert "SPYDRPICK_TORCH_DEVICE" in res.stderr
    assert not any(line.startswith("{") for line in res.stdout.splitlines())


def test_tpu_knobs_are_named_and_change_nothing(port_run):
    """(e) BENCH_ROWS, BENCH_DEPTH and BENCH_PALLAS_COMPACT: one stderr line
    names them; the sweep's threshold and edges are the plain run's."""
    rc, out, err = run_port_bench({**KNOBS, **TPU_KNOBS, "BENCH_E2E": "0"})
    assert rc == 0, err
    assert "ignored on this engine: BENCH_ROWS, BENCH_DEPTH, BENCH_PALLAS_COMPACT" in err
    got, want = last_json(out)["config"], port_run[0]["config"]
    assert (got["threshold"], got["edges"]) == (want["threshold"], want["edges"])
    assert got["end_to_end_s"] == {}


def test_e2e_medians_over_warm_runs(port_run):
    """(f) BENCH_E2E_RUNS=2: two warm totals, and total_s is their median."""
    e2e = port_run[0]["config"]["end_to_end_s"]
    assert e2e["runs"] == 2 and len(e2e["total_s_all"]) == 2
    assert abs(e2e["total_s"] - statistics.median(e2e["total_s_all"])) <= 1e-6
    assert len(e2e["launches_all"]) == 2
