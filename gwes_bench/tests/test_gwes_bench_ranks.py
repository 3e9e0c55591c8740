"""A cell of several ranks (``ranks.py``) on the CPU: two ``gloo`` ranks
of the program under PyTorch's launcher run a tiny sharded scan in
lockstep and print one well-formed line; a worker killed mid-window ends
the run at once, named; and ``k1_roofline_share`` counts the pairs of
rank 0's block-rows, reading as before with one rank."""

from __future__ import annotations

import json
import os
import re
import signal
import time

import pytest

from gwes_bench.cells import reader
from gwes_bench.record import Run
from gwes_bench.trace import Trace


def test_two_ranks_print_one_well_formed_last_line(ranks_run):
    p = ranks_run(chips=2)
    out, err = p.communicate(timeout=240)
    assert p.returncode == 0, err[-4000:]
    lines = out.strip().splitlines()
    assert len(lines) == 1, out
    last = json.loads(lines[-1])
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert last["correct"] is True and last["failed"] == 0, err[-4000:]
    assert last["device"]["count"] == 2
    assert "the sweep ran over 2 ranks: rank 0 swept 1 of 2 block-rows" in err
    counts = re.search(r"ranks' scans in the window: (\d+) (\d+)", err).groups()
    assert [last["attempted"]] * 2 == [int(n) for n in counts]
    assert last["checks"]["scans_differ"]["value"] == 0
    assert err.rstrip().splitlines()[-1].startswith("check scans_differ ")


def test_a_worker_killed_mid_window_ends_the_run_naming_it(ranks_run):
    p = ranks_run(chips=2, seconds=120.0)
    worker = None
    for line in p.stderr:
        found = re.search(r"rank 1 of 2: pid (\d+)", line)
        worker = int(found.group(1)) if found else worker
        if line.startswith("gwes_bench: warm-up scan"):
            break
    assert worker is not None
    time.sleep(1.0)
    os.kill(worker, signal.SIGKILL)
    t0 = time.monotonic()
    out, err = p.communicate(timeout=60)
    assert time.monotonic() - t0 < 60
    assert p.returncode != 0
    assert re.search(rf"rank\s*: 1 \(local_rank: 1\)\s*exitcode\s*: -9 \(pid: {worker}\)", err), \
        err[-4000:]
    assert out == ""


def _run(swept_rows=None, samples=3000, loci=92160, scans=3, k1_s=2.5):
    trace = Trace(window_s=20.0, busy_s=10.0, gaps=[],
                  kernel_s={"void mi_tile_mma_kernel<1>(...)": k1_s, "other": 1.0})
    return Run(samples=samples, loci=loci, scans=[{}] * scans, window_s=20.0, setup_s=1.0,
               peak_bytes=1, device_name="NVIDIA H100 80GB HBM3", trace=trace,
               swept_rows=swept_rows)


def test_k1_roofline_share_reads_as_before_with_one_rank():
    S, L, n, t = 3000, 92160, 3, 2.5
    before = 100.0 * (2.0 * 25.0 * S * L * (L - 1) / 2.0) * n / 1979e12 / t
    read = reader("k1_roofline_share")
    assert read(_run()) == before
    every_row = [(512, list(range(0, L, 512)))] * n
    assert read(_run(swept_rows=every_row)) == pytest.approx(before, rel=1e-12)


@pytest.mark.parametrize("loci", [92160, 1000])
def test_k1_pairs_of_the_ranks_deals_add_up_to_every_pair(loci):
    from gwes_bench.metrics.k1_roofline_share import block_row_pairs
    from spydrpick_torch.parallel.mesh import balanced_row_order

    tile, n = 512, 4
    order = [r * tile for r in balanced_row_order(-(-loci // tile))]
    pairs = [block_row_pairs(loci, tile, order[r::n]) for r in range(n)]
    assert sum(pairs) == loci * (loci - 1) // 2
    read = reader("k1_roofline_share")
    share = read(_run(swept_rows=[(tile, order[0::n])], loci=loci, scans=1))
    every = read(_run(loci=loci, scans=1))
    assert share == pytest.approx(every * pairs[0] / sum(pairs), rel=1e-12)
    assert read(_run(swept_rows=[], loci=loci, scans=1)) is None
