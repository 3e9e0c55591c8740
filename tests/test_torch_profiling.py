"""The port's profiling module (``spydrpick_torch/utils/profiling.py``):
the span and counter recorder, the record a CPU ``run_pipeline`` leaves
in ``timings`` and ``--profile-dir``; the bench alignment writer of
``chip_smoke.py``; and the benchmark's readers of the program's spans and
counters (``gwes_bench/metrics/``)."""

from __future__ import annotations

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import bench_alignment, write_inputs
from gwes_bench.cells import reader
from gwes_bench.record import Run
from spydrpick_torch.core.alignment import Alignment
from spydrpick_torch.engine.solver import MIEngine
from spydrpick_torch.engine.threshold import default_mi_values, determine_threshold_pairs
from spydrpick_torch.io.fasta import write_fasta
from spydrpick_torch.pipeline import STAGES, PipelineOptions, run_pipeline
from spydrpick_torch.utils import profiling
from spydrpick_torch.utils.profiling import count, recording, span, summary

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_inputs_round_trip(tmp_path):
    from spydrpick_tpu.io.fasta import read_fasta
    from spydrpick_tpu.io.loci import parse_value_list

    codes, w = bench_alignment(12, 40, seed=5)
    assert codes.max() == 4 and 0.1 <= w.min() and w.max() < 1.0
    fasta, wfile = write_inputs(str(tmp_path), "b", codes, w)
    al = read_fasta(fasta)
    np.testing.assert_array_equal(al.codes, codes)
    np.testing.assert_allclose(parse_value_list(wfile), w, rtol=0, atol=1e-9)


def by_path(rec: dict) -> dict:
    out: dict = {}
    for s in rec["spans"]:
        out.setdefault(s["path"], []).append(s)
    return out


def _refuse(*a, **kw):
    raise AssertionError("record_function entered")


# ------------------------------------------------------------------ recorder
def test_nesting_gives_dotted_paths_and_parents_cover():
    rec: dict = {}
    with recording(rec):
        with span("lead_in"):
            with span("parse"):
                with span("read"):
                    time.sleep(0.002)
                with span("decode"):
                    pass
            with span("weights"):
                pass
        with span("sweep"):
            pass
    spans = by_path(rec)
    assert set(spans) == {"lead_in", "lead_in.parse", "lead_in.parse.read",
                          "lead_in.parse.decode", "lead_in.weights", "sweep", "scan"}
    assert isinstance(rec["scan"], int) and rec["scan"] >= 1
    for path, (s,) in spans.items():
        assert s["thread"] == "main" and 0 <= s["start"] <= s["end"]
        parent = path.rpartition(".")[0] or ("scan" if path != "scan" else None)
        if parent is not None:
            (p,) = spans[parent]
            assert p["start"] <= s["start"] and s["end"] <= p["end"], path
    assert spans["lead_in.parse.read"][0]["end"] - spans["lead_in.parse.read"][0]["start"] \
        >= 0.002


def test_scan_numbers_rise_and_recordings_do_not_nest():
    a: dict = {}
    b: dict = {}
    with recording(a):
        with pytest.raises(RuntimeError):
            with recording({}):
                pass
    with recording(b):
        pass
    assert b["scan"] > a["scan"]


def test_self_time_is_duration_less_children():
    spans = [
        {"path": "a", "start": 0.0, "end": 1.0, "thread": "main"},
        {"path": "a.b", "start": 0.1, "end": 0.4, "thread": "main"},
        {"path": "a.b.c", "start": 0.2, "end": 0.3, "thread": "main"},
        {"path": "a.d", "start": 0.5, "end": 0.6, "thread": "main"},
        {"path": "a.w", "start": 0.0, "end": 0.9, "thread": "draws_0"},  # another thread
        {"path": "e", "start": 1.0, "end": 1.5, "thread": "main"},
        {"path": "scan", "start": 0.0, "end": 2.0, "thread": "main"},
    ]
    got = summary(spans)
    assert got["a"]["self_seconds"] == pytest.approx(1.0 - 0.3 - 0.1)
    assert got["a.b"]["self_seconds"] == pytest.approx(0.3 - 0.1)
    assert got["a.b.c"]["self_seconds"] == pytest.approx(0.1)
    assert got["a.w"]["self_seconds"] == pytest.approx(0.9)
    assert got["scan"]["self_seconds"] == pytest.approx(2.0 - 1.0 - 0.5)
    assert got["a"]["count"] == 1 and got["a"]["seconds"] == pytest.approx(1.0)


def test_worker_thread_spans_carry_its_name_and_the_given_parent():
    rec: dict = {}
    with recording(rec):
        with span("tournament"):
            parent = profiling.current_path()
            assert parent == "tournament"

            def work():
                with span("draw", parent=parent):
                    with span("inner"):
                        pass

            t = threading.Thread(target=work, name="draws_0")
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    spans = by_path(rec)
    (d,) = spans["tournament.draw"]
    (i,) = spans["tournament.draw.inner"]
    assert d["thread"] == i["thread"] == "draws_0"
    assert spans["tournament"][0]["thread"] == "main"


def test_counters_add_up_across_threads():
    rec: dict = {}
    n_threads, per_thread = 4 * (os.cpu_count() or 1), 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with recording(rec):
            def work():
                for _ in range(per_thread):
                    count("hits")
                    count("bytes", 3)
                    with span("w", parent=""):
                        pass

            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert rec["counters"] == {"hits": n_threads * per_thread,
                               "bytes": 3 * n_threads * per_thread}
    assert len(by_path(rec)["w"]) == n_threads * per_thread


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    first = span("a")
    with first as got:
        assert got is None
        with span("b", parent="a"):
            count("n", 5)
    assert span("c") is first  # one shared null context
    assert profiling.current_path() is None
    with recording(None):
        with span("d"):
            pass


def test_profiler_trace_holds_the_spans_nested(tmp_path):
    rec: dict = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with recording(rec):
            with span("lead_in"):
                with span("parse"):
                    torch.ones(8).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ann = {e["name"]: e for e in events
           if e.get("cat") == "user_annotation" and e.get("name", "").startswith("spydrpick:")}
    outer, inner = ann["spydrpick:lead_in"], ann["spydrpick:lead_in.parse"]
    assert "spydrpick:scan" in ann
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


# ------------------------------------------------------------ pipeline record
def small_fasta(path: str) -> str:
    rng = np.random.default_rng(42)
    S, L = 80, 256
    codes = np.repeat(rng.integers(0, 4, size=(1, L)), S, axis=0)
    mut = rng.random((S, L)) < 0.2
    codes[mut] = rng.integers(0, 4, size=mut.sum())
    codes[:, 200] = codes[:, 10]
    codes[rng.random((S, L)) < 0.03] = 4
    write_fasta(path, Alignment(codes.astype(np.uint8), [f"s{k}" for k in range(S)], "aln",
                                np.arange(L), L))
    return path


def swept_rows(mp: pytest.MonkeyPatch) -> list:
    """While ``mp`` holds, each ``MIEngine.row_edges`` call (one item of a
    block-row) appends its block-row to the list returned."""
    rows: list = []
    row_edges = MIEngine.row_edges

    def spy(self, i0, *args, **kwargs):
        rows.append(i0)
        return row_edges(self, i0, *args, **kwargs)
    mp.setattr(MIEngine, "row_edges", spy)
    return rows


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    """Two recorded CPU scans of one small alignment: [(result, timings,
    the FASTA's path, the block-row of each item swept)]."""
    tmp = tmp_path_factory.mktemp("profiling")
    fasta = small_fasta(str(tmp / "aln.fasta"))
    out = []
    for k in range(2):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("SPYDRPICK_TORCH_DEVICE", "cpu")
            opts = PipelineOptions(alignmentfile=fasta, output_dir=str(tmp / f"o{k}"),
                                   tile=128, seed=3)
            tm: dict = {}
            rows = swept_rows(mp)
            out.append((run_pipeline(opts, timings=tm), tm, fasta, rows))
    return out


def test_every_stage_span_once_and_its_key_equals_its_seconds(scans):
    for _, tm, *_ in scans:
        spans = by_path(tm)
        for key, path in STAGES:
            (s,) = spans[path]
            assert tm[key] == pytest.approx(s["end"] - s["start"], abs=1e-12), key
            assert s["thread"] == "main"
        assert len(tm["spans"]) <= 150
    assert scans[1][1]["scan"] > scans[0][1]["scan"]


# the spans a CPU scan records below its stages: path -> (count, thread)
SPAN_TREE = {
    "lead_in.parse": (1, "main"),
    "lead_in.parse.read": (1, "main"),
    "lead_in.parse.alloc": (1, "main"),
    "lead_in.parse.decode": (1, "main"),
    "lead_in.lists": (2, "main"),
    "lead_in.filter": (1, "main"),
    "lead_in.weights": (1, "main"),
    "lead_in.outputs": (2, "main"),
    "tournament.draw": (10, "draws_0"),
    "tournament.wait_draws": (10, "main"),
    "sweep.rows": (1, "main"),
    "sweep.rows.check": (1, "main"),  # 2 block-rows: one check, after the last
    "sweep.fetch": (1, "main"),
    "sweep.wog": (1, "main"),
    "sweep.wog.pairs": (1, "main"),
    "write.couplings": (1, "main"),
    "write.outliers": (1, "main"),
    "write.nodes": (1, "main"),
}


@pytest.mark.parametrize("path", sorted(SPAN_TREE))
def test_span_tree(scans, path):
    """Each span in every scan, as often as its stage opens it, on its
    thread, and inside an interval of its parent."""
    n, thread = SPAN_TREE[path]
    parent = path.rpartition(".")[0]
    for _, tm, *_ in scans:
        spans = by_path(tm)
        assert len(spans.get(path, ())) == n, path
        for s in spans[path]:
            assert s["thread"] == thread and s["start"] <= s["end"]
            assert any(p["start"] <= s["start"] and s["end"] <= p["end"]
                       for p in spans[parent]), path


def test_counters_match_the_results(scans):
    for res, tm, fasta, rows in scans:
        c = tm["counters"]
        assert c["edges_stored"] == res.edges.n_edges > 0
        L = res.alignment.n_loci
        possible = L * (L - 1) // 2
        per_iteration = determine_threshold_pairs(
            0, possible, 1.0 - default_mi_values(L, 0) / possible)
        assert c["pairs_drawn"] == 10 * per_iteration  # 10 iterations
        assert c["fasta_bytes"] == os.path.getsize(fasta)
        assert c["fasta_slow_records"] == 0  # lines of 60 codes, no interior whitespace
        assert c["columns_in"] >= c["columns_kept"] == res.alignment.n_loci
        # full-width rows: one item a block-row, each swept once
        assert sorted(rows) == list(range(0, L, 128))
        assert c["sweep_items"] == len(rows) and c["rows_reswept"] == 0
        assert c["pair_chunks"] >= 1
        out_dir = os.path.dirname(res.couplings_path)
        nodes = [f for f in os.listdir(out_dir) if f.endswith(".outlier_nodes.fasta")]
        assert c["bytes_written.couplings"] == os.path.getsize(res.couplings_path)
        assert c["bytes_written.outliers"] == os.path.getsize(res.outliers_path)
        assert c["bytes_written.nodes"] == sum(os.path.getsize(os.path.join(out_dir, f))
                                               for f in nodes)
        # the CPU launches no kernel; every wrapper's count is there, and
        # K1's on its wgmma loop
        launches = {k: v for k, v in c.items() if k.startswith("launches.")}
        assert set(launches) == {f"launches.{n}" for n in (
            "mi_tile_single", "mi_tile_single_wgmma", "mi_tile_dual", "crosstab_tile",
            "mi_epilogue", "row_select", "aracne_flags", "format_couplings_rows",
            "column_state_counts", "pairs_xtab")}
        assert not any(launches.values())


def test_store_grows_and_reswept_rows_are_counted(scans, tmp_path, monkeypatch):
    res0, _, fasta, _ = scans[0]
    monkeypatch.setenv("SPYDRPICK_TORCH_DEVICE", "cpu")
    rows = swept_rows(monkeypatch)
    tm: dict = {}
    res = run_pipeline(PipelineOptions(alignmentfile=fasta, output_dir=str(tmp_path / "o"),
                                       tile=128, seed=3, store_capacity=256), timings=tm)
    c = tm["counters"]
    assert c["store_grows"] >= 1
    # one item a row: the sweeps of a row past its first are the rows swept again
    assert c["rows_reswept"] == len(rows) - len(set(rows)) > 0
    assert c["sweep_items"] == len(rows) == len(set(rows)) + c["rows_reswept"]
    assert c["edges_stored"] == res.edges.n_edges == res0.edges.n_edges


def test_existing_keys_stay(scans):
    _, tm, *_ = scans[0]
    keys = ("preprocess_s", "engine_build_s", "threshold_s", "sweep_s", "sort_s",
            "aracne_s", "write_s", "total_s")
    assert set(tm) == {"spans", "counters", "scan"} | set(keys)
    assert keys == tuple(k for k, _ in STAGES)
    for k in keys:
        assert tm[k] > 0, k
    assert tm["total_s"] >= tm["sweep_s"]


def test_run_pipeline_without_timings_records_nothing(tmp_path, monkeypatch):
    fasta = small_fasta(str(tmp_path / "aln.fasta"))
    monkeypatch.setenv("SPYDRPICK_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(profiling, "_Recording", _refuse)
    res = run_pipeline(PipelineOptions(alignmentfile=fasta, output_dir=str(tmp_path / "o"),
                                       tile=128, seed=3))
    assert res.edges.n_edges > 0 and profiling._active is None


def test_profile_dir_traces_the_whole_scan(tmp_path, monkeypatch):
    fasta = small_fasta(str(tmp_path / "aln.fasta"))
    monkeypatch.setenv("SPYDRPICK_TORCH_DEVICE", "cpu")
    prof_dir = tmp_path / "prof"
    run_pipeline(PipelineOptions(alignmentfile=fasta, output_dir=str(tmp_path / "o"),
                                 tile=128, seed=3, profile_dir=str(prof_dir)))
    assert {"scan_trace.json", "scan_kernels.txt", "scan_spans.json"} <= set(
        os.listdir(prof_dir))
    with open(prof_dir / "scan_trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"}
    for path in ("scan", "lead_in", "lead_in.parse", "tournament", "sweep", "write"):
        assert f"spydrpick:{path}" in names, path
    with open(prof_dir / "scan_spans.json") as f:
        got = json.load(f)
    assert got["counters"]["edges_stored"] > 0 and isinstance(got["scan"], int)
    assert got["counters"]["fasta_slow_records"] == 0
    assert {s["path"] for s in got["spans"]} >= {"scan", "lead_in", "sweep.rows"}
    assert got["paths"]["scan"]["count"] == 1
    assert 0 <= got["paths"]["lead_in"]["self_seconds"] <= got["paths"]["lead_in"]["seconds"]


# ------------------------------------------------------------- metric readers
NEW_METRICS = {"parse_s": "lead_in.parse", "weights_s": "lead_in.weights",
               "draws_wait_s": "tournament.wait_draws"}


def run_of(timings: list) -> Run:
    return Run(samples=80, loci=256, scans=timings, window_s=1.0, setup_s=1.0,
               peak_bytes=0, device_name="cpu")


def test_new_metrics_in_the_benchmark():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        per_layer = {m["name"]: m for m in json.load(f)["per_layer"]}
    for name in (*NEW_METRICS, "write_gb_per_s"):
        m = per_layer[name]
        assert m["moves"] == "scan_s" and "workloads" not in m
        assert os.path.isfile(os.path.join(ROOT, "gwes_bench", "metrics", f"{name}.py"))
    assert per_layer["write_gb_per_s"]["source"] == "program_counter"


@pytest.mark.parametrize("name", sorted(NEW_METRICS))
def test_span_readers(scans, name):
    path = NEW_METRICS[name]
    tms = [tm for _, tm, *_ in scans]
    want = np.mean([sum(s["end"] - s["start"] for s in tm["spans"] if s["path"] == path)
                    for tm in tms])
    assert reader(name)(run_of(tms)) == pytest.approx(want, rel=1e-12) and want > 0
    lacking = [tms[0], {**tms[1], "spans": [s for s in tms[1]["spans"] if s["path"] != path]}]
    assert reader(name)(run_of(lacking)) is None
    assert reader(name)(run_of([{"preprocess_s": 1.0}])) is None  # a program without spans
    assert reader(name)(run_of([])) is None


def test_write_rate_reader(scans):
    tms = [tm for _, tm, *_ in scans]
    rates = []
    for res, tm, *_ in scans:
        (w,) = [s for s in tm["spans"] if s["path"] == "write"]
        on_disk = sum(os.path.getsize(os.path.join(os.path.dirname(res.couplings_path), f))
                      for f in os.listdir(os.path.dirname(res.couplings_path)))
        rates.append(on_disk / (w["end"] - w["start"]) / 1e9)
    read = reader("write_gb_per_s")
    assert read(run_of(tms)) == pytest.approx(np.mean(rates), rel=1e-9)
    no_write = {**tms[0], "spans": [s for s in tms[0]["spans"] if s["path"] != "write"]}
    assert read(run_of([no_write, tms[1]])) is None
    assert read(run_of([{**tms[0], "counters": {}}])) is None
    assert read(run_of([{"write_s": 1.0}])) is None
