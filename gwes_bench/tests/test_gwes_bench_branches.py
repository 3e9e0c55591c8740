"""The reference's branches for the flags a cell may set: a held
``--mi-threshold``, ``--no-sample-reweighting`` and ``--ld-threshold``.
Tiny runs through the harness with the program's CPU path standing in: a
sound scan of each branch is correct, and the faults planted for it, and
the control, are not."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gwes_bench import run
from gwes_bench.record import Run
from gwes_bench.reference import options

SEED = 2**31 + 17
# the automatic threshold of the tiny 30k population at SEED (the reference's
# tournament reads 0.0706203), written to 4 digits as a user holds it
TINY_HELD = "0.07062"


def _run(cell, seed=SEED, seconds=0.001):
    return run.execute(cell, seed, seconds, False, torch.device("cpu"), 0.0)


def _held(tiny_cell):
    cell = tiny_cell("scan-3k-30k-held")
    cell.traffic = dict(cell.traffic, cli=["--mi-threshold", TINY_HELD])
    return cell


def _unit(tiny_cell, samples=160):
    return tiny_cell("scan-3k-92k-unit", samples=samples)


def test_the_options_hold_the_two_flags_and_refuse_a_weights_file():
    p = options.parse(["aln.fasta", "--mi-threshold", "0.25", "--no-sample-reweighting"])
    assert p["mi_threshold"] == 0.25 and p["no_sample_reweighting"] is True
    p = options.parse(["aln.fasta"])
    assert p["mi_threshold"] == -1.0 and p["no_sample_reweighting"] is False
    with pytest.raises(ValueError):
        options.parse(["aln.fasta", "--sample-weights", "w.txt"])


def test_the_held_cell_holds_a_threshold_and_the_unit_cell_unit_weights():
    from gwes_bench.cells import resolve
    from gwes_bench.generate import scan_args

    for name, key, want in (("scan-3k-30k-held", "mi_threshold", lambda v: v > 0),
                            ("scan-3k-92k-unit", "no_sample_reweighting", lambda v: v is True)):
        cell = resolve(name)
        assert want(options.parse(scan_args(cell.config, cell.traffic, "aln.fasta", 1))[key])


@pytest.mark.parametrize("branch", ["held", "unit"])
def test_a_tiny_scan_of_each_branch_is_correct(cpu_program, tiny_cell, branch):
    cell = _held(tiny_cell) if branch == "held" else _unit(tiny_cell)
    line = _run(cell, seconds=0.5)
    assert line["correct"] is True and line["attempted"] >= 1 and line["failed"] == 0
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]
    if branch == "held":
        assert line["checks"]["thr_gap"]["value"] == 0.0


@pytest.mark.parametrize("branch", ["held", "unit"])
def test_the_span_readers_read_each_branch(cpu_program, tiny_cell, tmp_path, branch):
    """Every per-layer metric of the cell that reads spans or counters reads
    a number from a scan of the branch: a held scan waits 0 s on draws it
    does not make, and its tournament takes next to nothing."""
    from gwes_bench import generate
    from gwes_bench.cells import reader
    from spydrpick_torch.pipeline import run_pipeline

    cell = _held(tiny_cell) if branch == "held" else _unit(tiny_cell)
    codes = generate.alignment(cell.config, cell.traffic, SEED)
    argv = generate.scan_args(cell.config, cell.traffic,
                              generate.write_fasta(str(tmp_path), codes), SEED)
    tm: dict = {}
    run_pipeline(run.scan_options([*argv, "--output-dir", str(tmp_path / "out")]), timings=tm)
    r = Run(samples=codes.shape[0], loci=cell.config["kept"], scans=[tm], window_s=1.0,
            setup_s=1.0, peak_bytes=0, device_name="cpu")
    names = {m["name"] for m in cell.per_layer if m["source"] != "device_trace"}
    assert "draws_wait_s" in names
    for name in names:
        assert reader(name)(r) is not None, name
    if branch == "held":
        assert reader("draws_wait_s")(r) == 0.0
        assert reader("tournament_s")(r) < 0.01
    else:
        assert reader("draws_wait_s")(r) > 0


def _cut_above(step):
    """The held scan's edges cut at a threshold ``step`` above the one it
    reports."""
    def plant(mp):
        from spydrpick_torch.engine.solver import MIEngine

        orig = MIEngine.sweep
        mp.setattr(MIEngine, "sweep", lambda self, thr, *a, **k: orig(self, thr + step, *a, **k))
    return plant


def _cluster_weights(mp):
    """The flag dropped: the scan computes cluster weights."""
    import spydrpick_torch.pipeline as pl

    orig = pl.cache_sample_weights
    mp.setattr(pl, "cache_sample_weights",
               lambda al, **k: orig(al, **dict(k, no_reweighting=False)))


FAULTS = {
    # one step: twice the misplaced limit, 1e-4 (a cut within the limit is
    # by design not seen)
    "held_edges_cut_one_step_above": ("held", _cut_above(2e-4), "misplaced"),
    "unit_scan_made_with_cluster_weights": ("unit", _cluster_weights, "mi_gap"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_of_a_branch_is_not_correct(cpu_program, tiny_cell, monkeypatch, fault):
    branch, plant, number = FAULTS[fault]
    cell = _held(tiny_cell) if branch == "held" else _unit(tiny_cell)
    plant(monkeypatch)
    line = _run(cell)
    assert line["correct"] is False
    assert line["checks"][number]["value"] > line["checks"][number]["limit"]


def _scan_faults():
    from gwes_bench.tests.test_gwes_bench_scan import FAULTS as SCAN_FAULTS

    return SCAN_FAULTS


@pytest.mark.parametrize("branch,fault", [
    (b, f) for b in ("held", "unit") for f in sorted(_scan_faults())
    if (b, f) != ("held", "the_threshold_moved")])  # a held scan runs no tournament
def test_the_default_cells_faults_in_each_branch(cpu_program, tiny_cell, monkeypatch, branch,
                                                 fault):
    """The faults planted under the default cells' timed path, in each
    branch's cell."""
    plant, number = _scan_faults()[fault]
    cell = _held(tiny_cell) if branch == "held" else _unit(tiny_cell)
    plant(monkeypatch)
    line = _run(cell)
    assert line["correct"] is False
    assert line["checks"][number]["value"] > line["checks"][number]["limit"]


@pytest.mark.parametrize("branch", ["held", "unit"])
def test_the_control_of_each_branch_is_not_correct(cpu_program, tiny_cell, branch):
    """The control in each branch: at 320 samples, so that unit weights'
    counts pass 256, where bfloat16 stops holding every whole number."""
    from gwes_bench.control import readings

    cell = (_held(tiny_cell) if branch == "held" else _unit(tiny_cell))
    cell.config = dict(cell.config, samples=320)
    r = readings(cell, 2**31 + 3, torch.device("cpu"))
    assert all(r["program"][k] <= limit for k, limit in cell.limits.items()
               if k in r["program"])
    failed = {k for k, limit in cell.limits.items() if r["control"].get(k, 0) > limit}
    assert {"mi_gap", "colmax_gap"} <= failed
    if branch == "held":
        assert r["control"]["thr_gap"] == 0.0


def test_colmax_is_judged_beyond_the_ld_threshold(cpu_program, tiny_cell, monkeypatch):
    """With --ld-threshold, the program leaves the pairs within it out of
    colmax: judged so it is correct, and a reference colmax left ungated
    reads it as not correct."""
    from gwes_bench.reference.scan import Reference

    cell = tiny_cell()
    cell.traffic = dict(cell.traffic, cli=["--ld-threshold", "300"])
    line = _run(cell)
    assert line["correct"] is True

    def ungated(self, colmax, i0, j0, mi):
        T, W = mi.shape
        colmax[i0:i0 + T] = torch.maximum(colmax[i0:i0 + T], mi.amax(dim=1))
        colmax[j0:j0 + W] = torch.maximum(colmax[j0:j0 + W], mi.amax(dim=0))
    monkeypatch.setattr(Reference, "fold_colmax", ungated)
    line = _run(cell)
    assert line["correct"] is False
    assert line["checks"]["colmax_gap"]["value"] > line["checks"]["colmax_gap"]["limit"]


def test_a_threshold_held_at_0_gives_a_finite_gap(tmp_path):
    """--mi-threshold 0 (the CLI's "no threshold"): thr_gap is the absolute
    difference, not a division by 0."""
    from gwes_bench.reference.judge import Inputs, ScanOutput, judge
    from gwes_bench.reference.scan import Reference

    codes = np.random.default_rng(5).integers(0, 4, size=(24, 12)).astype(np.uint8)
    p = options.parse(["aln.fasta", "--mi-threshold", "0", "--no-filter-alignment"])
    ref = Reference(codes, p, torch.device("cpu"))
    assert ref.save_threshold() == 0.0
    out = ScanOutput(kept=ref.kept, threshold=0.5, ipos=np.zeros(0, np.int64),
                     jpos=np.zeros(0, np.int64), mi=np.zeros(0), wog=np.zeros(0),
                     colmax=np.zeros(ref.L), flags=np.zeros(0, np.uint8), out_dir=str(tmp_path))
    nums = judge(Inputs(codes, "aln", [f"s{k}" for k in range(24)], p), [out],
                 torch.device("cpu"))[0]
    assert nums["thr_gap"] == 0.5
