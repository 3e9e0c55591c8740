"""On the card (``gpu`` marker; skipped without one): a short run of a
cell cut to a small size through the harness with the program's CUDA
path, and the control at that size, judged as on the CPU."""

from __future__ import annotations

import pytest

from gwes_bench import run


@pytest.mark.gpu
def test_a_small_scan_on_the_card_is_correct(cuda, tiny_cell):
    cell = tiny_cell(samples=1024, loci=6144, kept=4096)
    line = run.execute(cell, 2**31 + 21, 1.0, False, cuda, 0.0)
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert line["device"]["memory_peak_bytes"] > 0
    assert set(line["metrics"]) == {"scan_s", "peak_device_gib", "setup_s"}


@pytest.mark.gpu
def test_a_small_traced_scan_reads_every_per_layer_metric(cuda, tiny_cell):
    cell = tiny_cell(samples=1024, loci=6144, kept=4096)
    line = run.execute(cell, 2**31 + 22, 1.0, True, cuda, 0.0)
    assert line["correct"] is True
    assert set(line["metrics"]) == {m["name"] for m in cell.per_layer}
    assert 0 < line["metrics"]["k1_roofline_share"]["value"] < 100
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert line["breakdown"]["device_ops"] and line["breakdown"]["idle_gaps"]


@pytest.mark.gpu
def test_the_control_is_not_correct_on_the_card(cuda, tiny_cell):
    from gwes_bench.control import readings

    cell = tiny_cell(samples=1024, loci=6144, kept=4096)
    r = readings(cell, 2**31 + 23, cuda)
    assert all(r["program"][k] <= limit for k, limit in cell.limits.items()
               if k in r["program"])
    assert any(r["control"].get(k, 0) > limit for k, limit in cell.limits.items())
