"""A tiny run through the harness with the program's CPU path standing in:
a well-formed last line, the control judged not correct, and each fault
planted under the timed path seen as not correct."""

from __future__ import annotations

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from gwes_bench import run


def _run(cell, seed=2**31 + 17, seconds=0.001):
    return run.execute(cell, seed, seconds, False, torch.device("cpu"), 0.0)


def test_a_tiny_scan_prints_a_well_formed_last_line(cpu_program, tiny_cell):
    line = _run(tiny_cell(), seconds=0.5)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        run.report(line)
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(last)[-1] == "checks"
    assert last["correct"] is True and last["attempted"] >= 1 and last["failed"] == 0
    assert set(last["metrics"]) == {"scan_s", "setup_s"}  # no device memory on the CPU
    assert all(m["value"] > 0 for m in last["metrics"].values())
    assert last["device"]["count"] == 1
    for c in last["checks"].values():
        assert c["value"] <= c["limit"]


def test_the_control_is_not_correct(cpu_program, tiny_cell):
    from gwes_bench.control import readings
    from gwes_bench.reference.judge import EXACT

    cell = tiny_cell()
    r = readings(cell, 2**31 + 3, torch.device("cpu"))
    assert all(r["program"][k] <= limit for k, limit in cell.limits.items()
               if k in r["program"])
    failed = [k for k, limit in cell.limits.items() if r["control"].get(k, 0) > limit]
    assert {"thr_gap", "mi_gap", "misplaced", "colmax_gap"} <= set(failed)
    assert not set(failed) & set(EXACT)


def _half_the_rows(mp):
    from spydrpick_torch.engine.solver import MIEngine

    orig = MIEngine.sweep_rows
    mp.setattr(MIEngine, "sweep_rows", lambda self, rows, *a, **k: orig(self, rows[::2], *a, **k))


def _sweep_result(change):
    def plant(mp):
        from spydrpick_torch.engine.solver import MIEngine

        orig = MIEngine.sweep

        def sweep(self, *a, **k):
            return change(orig(self, *a, **k))
        mp.setattr(MIEngine, "sweep", sweep)
    return plant


def _one_mi(e):
    e.mi[len(e.mi) // 2] += 0.01
    return e


def _no_edges(e):
    import dataclasses

    empty = np.zeros(0, np.int64)
    return dataclasses.replace(e, ipos=empty, jpos=empty, mi=np.zeros(0), mi_wog=np.zeros(0))


def _couplings_row(mp):
    import spydrpick_torch.pipeline as pl

    orig = pl._write_outputs

    def write(opts, res, *a):
        out = orig(opts, res, *a)
        with open(res.couplings_path, "r+b") as f:
            row = f.readline()
            f.seek(len(row) - 2)
            f.write(b"9" if row[-2:-1] != b"9" else b"8")
        return out
    mp.setattr(pl, "_write_outputs", write)


def _one_flag(mp):
    import spydrpick_torch.pipeline as pl

    orig = pl.run_aracne

    def aracne(*a, **k):
        flags = orig(*a, **k)
        flags[0] ^= 1
        return flags
    mp.setattr(pl, "run_aracne", aracne)


def _threshold(mp):
    import spydrpick_torch.pipeline as pl

    orig = pl.determine_mi_threshold
    mp.setattr(pl, "determine_mi_threshold", lambda *a, **k: orig(*a, **k) * 1.01)


def _filter(mp):
    import spydrpick_torch.pipeline as pl

    orig = pl.filter_list
    mp.setattr(pl, "filter_list", lambda *a, **k: orig(*a, **k)[:-1])


FAULTS = {
    "half_the_block_rows_left_out": (_half_the_rows, "misplaced"),
    "one_edge_mi_altered": (_sweep_result(_one_mi), "mi_gap"),
    "the_sweep_returns_no_edges": (_sweep_result(_no_edges), "misplaced"),
    "one_couplings_row_altered": (_couplings_row, "couplings_diff"),
    "one_aracne_flag_altered": (_one_flag, "aracne_diff"),
    "the_threshold_moved": (_threshold, "thr_gap"),
    "one_column_filtered_out": (_filter, "filter_diff"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_under_the_timed_path_is_not_correct(cpu_program, tiny_cell, monkeypatch,
                                                     fault):
    plant, number = FAULTS[fault]
    plant(monkeypatch)
    line = _run(tiny_cell())
    assert line["correct"] is False
    assert line["checks"][number]["value"] > line["checks"][number]["limit"]
