"""The PyTorch port's CLI (spydrpick_torch/cli.py) end to end on the CPU.

Both golden fixtures run through the port's CLI and through the JAX CLI
with ``--use-pallas on`` (the same int8 crosstable mode):
  * the files that depend only on host code or the exact weights matmul
    are byte-identical to tests/golden/expected*/;
  * couplings and outliers rows match the JAX run's, apart from pairs
    within 1e-5 of the save threshold; MI (and wo-gaps MI) agree within
    1e-5; ARACNE flags agree apart from edges whose DPI test is a tie
    within 1e-5 (the two packages' f32 epilogues may break an exact tie
    between two MI values differently).
Byte identity of the couplings with tests/golden/expected*/ (frozen from
the JAX f32 XLA path) is not required of this engine.
"""

import os
import re

import numpy as np
import pytest

from spydrpick_tpu.cli import main as jax_main
from spydrpick_tpu.core.alignment import Alignment
from spydrpick_tpu.io.fasta import write_fasta
from spydrpick_torch.cli import main as torch_main

from tests.golden.make_golden import GOLDEN2_ARGS

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def cpu_device():
    """These runs ask for the CPU, as a CLI run on a machine without a GPU
    must (spydrpick_torch/device.py); module-scoped, so that the module's
    fixtures that run the CLI see it too."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPYDRPICK_TORCH_DEVICE", "cpu")
        yield

FIXTURES = {
    "golden": ([os.path.join(GOLDEN, "golden.fasta"), "--seed", "7", "--ld-threshold", "10",
                "--mi-values", "1500", "--output-state-frequencies",
                "--output-sample-weights"],
               "expected", ("golden.weights", "golden.state_frequencies")),
    "golden2": ([os.path.join(GOLDEN, "golden2.fasta"), *GOLDEN2_ARGS,
                 "--mappings-list", os.path.join(GOLDEN, "golden2.mappings"),
                 "--sample-weights", os.path.join(GOLDEN, "golden2.weights")],
                "expected2", ("golden2.distance_matrix",)),
}


def read_rows(path):
    with open(path) as f:
        return {(int(r[0]), int(r[1])): r for r in (line.split() for line in f)}


def save_threshold(text):
    return float(re.search(r"MI save threshold = ([\d.]+)", text).group(1))


def dpi_near_tie(edge, rows, tol=TOL):
    """True when some common neighbour c of the edge's endpoints has
    min(w_ac, w_bc) within ``tol`` of the edge's weight."""
    a, b = edge
    w = float(rows[edge][4])
    nbr = {}
    for (i, j), r in rows.items():
        nbr.setdefault(i, {})[j] = float(r[4])
        nbr.setdefault(j, {})[i] = float(r[4])
    common = (set(nbr[a]) & set(nbr[b])) - {a, b}
    return any(abs(min(nbr[a][c], nbr[b][c]) - w) <= tol for c in common)


@pytest.mark.parametrize("fixture", list(FIXTURES))
def test_golden_fixture_matches_jax(tmp_path, capsys, fixture):
    args, expected, exact_files = FIXTURES[fixture]
    assert torch_main(args + ["-v", "--output-dir", str(tmp_path / "torch")]) == 0
    thr_t = save_threshold(capsys.readouterr().out)
    assert jax_main(args + ["-v", "--use-pallas", "on", "--jax-cache-dir", "none",
                            "--output-dir", str(tmp_path / "jax")]) == 0
    thr_j = save_threshold(capsys.readouterr().out)
    assert round(thr_t, 6) == round(thr_j, 6)
    want_files = sorted(os.listdir(os.path.join(GOLDEN, expected)))
    assert sorted(os.listdir(tmp_path / "torch")) == want_files
    for name in exact_files:
        with open(os.path.join(GOLDEN, expected, name), "rb") as f:
            want = f.read()
        assert (tmp_path / "torch" / name).read_bytes() == want, name

    couplings = next(n for n in want_files if n.endswith("edges"))
    outliers = next(n for n in want_files if n.endswith("outliers"))
    got = read_rows(tmp_path / "torch" / couplings)
    ref = read_rows(tmp_path / "jax" / couplings)
    for k in set(got) ^ set(ref):
        assert abs(float((got.get(k) or ref[k])[4]) - thr_j) <= TOL, k
    common = set(got) & set(ref)
    assert len(common) > 1000
    tie_flips = 0
    for k in common:
        g, r = got[k], ref[k]
        assert g[2] == r[2], k  # genome distance
        assert abs(float(g[4]) - float(r[4])) <= TOL, k
        if g[3] != r[3]:
            assert dpi_near_tie(k, ref), (k, g, r)
            tie_flips += 1
    assert tie_flips <= 2

    got_o = read_rows(tmp_path / "torch" / outliers)
    ref_o = read_rows(tmp_path / "jax" / outliers)
    assert set(got_o) == set(ref_o) and got_o
    for k, g in got_o.items():
        r = ref_o[k]
        assert g[2] == r[2] and g[7] == r[7], k  # distance, extreme flag
        assert g[3] == r[3] or dpi_near_tie(k, ref), k
        assert abs(float(g[4]) - float(r[4])) <= TOL and abs(float(g[5]) - float(r[5])) <= TOL
        assert abs(float(g[6]) - float(r[6])) <= 0.1 + 1e-9  # gap effect, 1 decimal


def planted_alignment(path):
    """The planted-pair drive of .claude/skills/verify/SKILL.md."""
    rng = np.random.default_rng(42)
    S, L = 120, 400
    codes = np.repeat(rng.integers(0, 4, size=(1, L)), S, axis=0)
    mut = rng.random((S, L)) < 0.15
    codes[mut] = rng.integers(0, 4, size=mut.sum())
    codes[:, 300] = codes[:, 10]
    codes[rng.random((S, L)) < 0.03] = 4
    write_fasta(path, Alignment(codes.astype(np.uint8), [f"s{i}" for i in range(S)],
                                "verif", np.arange(L), L))


def test_planted_pair_ranks_first_and_seed_reruns_identically(tmp_path):
    fasta = str(tmp_path / "verif.fasta")
    planted_alignment(fasta)
    outs = []
    for run in ("a", "b"):
        out = tmp_path / run
        assert torch_main([fasta, "--ld-threshold", "20", "--seed", "7",
                           "--output-dir", str(out)]) == 0
        (name,) = [n for n in os.listdir(out) if n.endswith("edges")]
        outs.append((out / name).read_bytes())
        first = outs[-1].split(b"\n", 1)[0].split()
        assert first[:3] == [b"11", b"301", b"110"], first
        (oname,) = [n for n in os.listdir(out) if n.endswith(".outliers")]
        orow = (out / oname).read_text().split("\n", 1)[0].split()
        assert len(orow) == 8 and orow[:2] == ["11", "301"] and orow[7] == "1"
    assert outs[0] == outs[1]


def test_ignored_tpu_flags_change_nothing(tmp_path, capsys):
    args, _, _ = FIXTURES["golden2"]
    assert torch_main(args + ["--output-dir", str(tmp_path / "plain")]) == 0
    assert torch_main(args + ["-v", "--use-pallas", "off", "--use-pallas-compact", "on",
                              "--rows-per-dispatch", "2", "--pipeline-depth", "1",
                              "--matmul-precision", "highest", "--jax-cache-dir", "none",
                              "--store-capacity", "1024", "--edge-capacity", "8",
                              "--onehot-storage", "dense", "--row-window", "1",
                              "--output-dir", str(tmp_path / "flags")]) == 0
    out = capsys.readouterr().out
    assert "ignored on this engine: --use-pallas, --use-pallas-compact" in out
    assert "--edge-capacity" in out
    names = sorted(os.listdir(tmp_path / "plain"))
    assert names == sorted(os.listdir(tmp_path / "flags"))
    for n in names:
        assert (tmp_path / "plain" / n).read_bytes() == (tmp_path / "flags" / n).read_bytes()


MULTI_HOST = ["--coordinator-address", "localhost:1234", "--num-processes", "2",
              "--process-id", "0"]


@pytest.mark.parametrize("base,flags,engine", [
    ([], ["--row-window", "4096"], "dense one-hot, full-width rows"),
    ([], ["--onehot-storage", "codes"], "codes one-hot, full-width rows"),
    (["--tile", "128"], ["--row-window", "128", "--onehot-storage", "codes"],
     "codes one-hot, j-windows of 128 columns"),
])
def test_window_and_codes_flags_write_the_plain_runs_files(tmp_path, capsys, base, flags, engine):
    """``--row-window`` and ``--onehot-storage codes`` run (they were
    refused before this engine ported them) and change no output byte."""
    args, _, _ = FIXTURES["golden2"]
    assert torch_main(args + base + ["--output-dir", str(tmp_path / "plain")]) == 0
    assert torch_main(args + base + flags + ["-v", "--output-dir", str(tmp_path / "flags")]) == 0
    captured = capsys.readouterr()
    assert engine in captured.out and "not yet ported" not in captured.err
    names = sorted(os.listdir(tmp_path / "plain"))
    assert names and names == sorted(os.listdir(tmp_path / "flags"))
    for n in names:
        assert (tmp_path / "plain" / n).read_bytes() == (tmp_path / "flags" / n).read_bytes()


@pytest.mark.parametrize("flags,message", [
    (["--sharded", "--sample-shards", "3"] + MULTI_HOST, "does not divide"),
    (["--sample-shards", "0"], "does not divide"),
    (["--coordinator-address", "localhost:1234"], "go together"),
    (["--num-processes", "2"], "go together"),
    (["--process-id", "0"], "go together"),
    (MULTI_HOST[:4] + ["--process-id", "2"], "outside"),
    (["--coordinator-address", "localhost", "--num-processes", "2", "--process-id", "0"],
     "host:port"),
])
def test_bad_sharding_flags_exit_1(tmp_path, capsys, flags, message):
    """Sharding flags that cannot start a run exit 1 before any process
    group exists."""
    args, _, _ = FIXTURES["golden2"]
    assert torch_main(args + flags + ["--output-dir", str(tmp_path)]) == 1
    assert message in capsys.readouterr().err
    assert not os.listdir(tmp_path)


def test_sharded_single_process_falls_back_to_single_device(tmp_path, capsys):
    """--sharded with one process sweeps on one device, as the reference
    does with one device visible, and writes the same files."""
    args, _, _ = FIXTURES["golden2"]
    assert torch_main(args + ["--output-dir", str(tmp_path / "plain")]) == 0
    assert torch_main(args + ["-v", "--sharded", "--sample-shards", "2",
                              "--output-dir", str(tmp_path / "sharded")]) == 0
    assert "only one device visible; using single-device sweep" in capsys.readouterr().out
    names = sorted(os.listdir(tmp_path / "plain"))
    assert names == sorted(os.listdir(tmp_path / "sharded"))
    for n in names:
        assert (tmp_path / "plain" / n).read_bytes() == (tmp_path / "sharded" / n).read_bytes()


def test_bad_tile_and_missing_file_exit_1(tmp_path, capsys):
    args, _, _ = FIXTURES["golden2"]
    assert torch_main(args + ["--tile", "100", "--output-dir", str(tmp_path)]) == 1
    assert "multiple of 128" in capsys.readouterr().err
    assert torch_main([str(tmp_path / "missing.fasta"), "--output-dir", str(tmp_path)]) == 1
    assert torch_main([]) == 1
