"""The port's profiling module (``spydrpick_torch/utils/profiling.py``):
trace reading (device-busy union), the span and counter recorder, the
record a CPU ``run_pipeline`` leaves in ``timings`` and ``--profile-dir``;
the bench alignment writer of ``spydrpick_torch.stage_profile``; and the
benchmark's readers of the program's spans and counters
(``gwes_bench/metrics/``)."""

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

from gwes_bench.cells import reader
from gwes_bench.record import Run
from spydrpick_torch.core.alignment import Alignment
from spydrpick_torch.io.fasta import write_fasta
from spydrpick_torch.pipeline import STAGES, PipelineOptions, run_pipeline
from spydrpick_torch.stage_profile import bench_alignment, write_inputs
from spydrpick_torch.utils import profiling
from spydrpick_torch.utils.profiling import (
    busy_union,
    count,
    device_intervals,
    phases,
    recording,
    span,
    summary,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ev(cat, ts, dur, name="k"):
    return {"ph": "X", "cat": cat, "ts": ts, "dur": dur, "name": name}


@pytest.mark.parametrize("intervals, busy", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (20, 25)], 15.0),                  # disjoint
    ([(0, 10), (5, 15)], 15.0),                   # overlapping streams count once
    ([(0, 30), (5, 10), (12, 20)], 30.0),         # nested
    ([(20, 25), (0, 10), (10, 12)], 17.0),        # unsorted, touching
])
def test_busy_union(intervals, busy):
    assert busy_union(intervals) == busy


def test_device_intervals_filters_and_clips():
    events = [
        ev("kernel", 0, 10, "mi"),
        ev("gpu_memcpy", 8, 4, "copy"),
        ev("gpu_memset", 30, 5, "set"),
        ev("cpu_op", 0, 100, "aten::add"),          # host op: not device time
        ev("gpu_user_annotation", 0, 100, "region"),  # spans, not work
        ev("kernel", 50, 10, "late"),               # outside the window
        {"ph": "i", "cat": "kernel", "ts": 1, "name": "instant"},
    ]
    iv = device_intervals(events, lo=2.0, hi=33.0)
    assert iv == [(2.0, 10.0, "mi"), (8.0, 12.0, "copy"), (30.0, 33.0, "set")]
    assert busy_union(iv) == 13.0


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
    with phases(None) as mark:
        assert mark is None


def test_phases_view_alone_and_inside_a_recording():
    tm: dict = {}
    with phases(tm) as mark:
        with span("x"):
            time.sleep(0.001)
        with span("x"):
            pass
    assert mark.seconds("x") >= 0.001 and mark.seconds("y") == 0.0
    assert profiling._active is None  # the block's own recording is dropped
    assert tm == {}
    rec: dict = {}
    with recording(rec):
        with span("outer"):
            with span("x"):
                pass
            with phases({}) as inner:
                with span("x"):
                    time.sleep(0.001)
    assert inner.base == "outer"
    (late,) = [s for s in rec["spans"] if s["path"] == "outer.x"][1:]
    assert inner.seconds("x") == pytest.approx(late["end"] - late["start"])


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


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    """Two recorded CPU scans of one small alignment: [(result, timings,
    the FASTA's path)]."""
    tmp = tmp_path_factory.mktemp("profiling")
    fasta = small_fasta(str(tmp / "aln.fasta"))
    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPYDRPICK_TORCH_DEVICE", "cpu")
        for k in range(2):
            opts = PipelineOptions(alignmentfile=fasta, output_dir=str(tmp / f"o{k}"),
                                   tile=128, seed=3)
            tm: dict = {}
            out.append((run_pipeline(opts, timings=tm), tm, fasta))
    return out


def test_every_stage_span_once_and_its_key_equals_its_seconds(scans):
    for _, tm, _ in scans:
        spans = by_path(tm)
        for key, path in STAGES:
            (s,) = spans[path]
            assert tm[key] == pytest.approx(s["end"] - s["start"], abs=1e-12), key
            assert s["thread"] == "main"
        assert len(tm["spans"]) <= 150
    assert scans[1][1]["scan"] > scans[0][1]["scan"]


def test_phase_keys_are_views_of_their_spans(scans):
    for _, tm, _ in scans:
        spans = by_path(tm)

        def secs(path):
            return sum(s["end"] - s["start"] for s in spans.get(path, ()))

        pre = tm["preprocess_phases"]
        for k in ("parse", "lists", "filter", "weights", "outputs"):
            assert pre[f"{k}_s"] == pytest.approx(secs(f"lead_in.{k}"), abs=1e-12), k
        assert pre["read_s"] == pytest.approx(secs("lead_in.parse.read"), abs=1e-12)
        assert pre["decode_s"] == pytest.approx(secs("lead_in.parse.decode"), abs=1e-12)
        assert "lead_in.parse.alloc" in spans and pre["upload_s"] == 0.0  # the CPU
        th = tm["threshold_phases"]
        assert th["draws_s"] == pytest.approx(secs("tournament.draw"), abs=1e-12)
        assert len(spans["tournament.draw"]) == len(spans["tournament.wait_draws"]) == 10
        assert all(s["thread"] == "draws_0" for s in spans["tournament.draw"])
        assert th["draws_s"] <= th["total_s"] <= tm["threshold_s"]
        sw = tm["sweep_phases"]
        assert sw["compute_s"] == pytest.approx(secs("sweep.rows"), abs=1e-12)
        assert sw["fetch_s"] == pytest.approx(secs("sweep.fetch"), abs=1e-12)
        assert sw["wog_s"] == pytest.approx(secs("sweep.wog"), abs=1e-12)
        assert sw["wog_pairs_s"] == pytest.approx(secs("sweep.wog.pairs"), abs=1e-12)
        assert sw["checkpoint_s"] == 0.0 and len(spans["sweep.rows.check"]) >= 1
        wp = tm["write_phases"]
        for k in ("couplings", "outliers", "nodes"):
            assert wp[f"{k}_s"] == pytest.approx(secs(f"write.{k}"), abs=1e-12), k


def test_counters_match_the_results(scans):
    for res, tm, fasta in scans:
        c = tm["counters"]
        assert c["edges_stored"] == res.edges.n_edges > 0
        assert c["pairs_drawn"] == tm["threshold_phases"]["pairs"]
        assert c["fasta_bytes"] == os.path.getsize(fasta)
        assert c["fasta_slow_records"] == 0  # lines of 60 codes, no interior whitespace
        assert c["columns_in"] >= c["columns_kept"] == res.alignment.n_loci
        assert c["sweep_items"] == tm["sweep_phases"]["n_items"]
        assert c["rows_reswept"] == tm["sweep_phases"]["rerun_rows"]
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
    res0, _, fasta = scans[0]
    monkeypatch.setenv("SPYDRPICK_TORCH_DEVICE", "cpu")
    tm: dict = {}
    res = run_pipeline(PipelineOptions(alignmentfile=fasta, output_dir=str(tmp_path / "o"),
                                       tile=128, seed=3, store_capacity=256), timings=tm)
    c = tm["counters"]
    assert c["store_grows"] >= 1
    assert c["rows_reswept"] == tm["sweep_phases"]["rerun_rows"] > 0
    assert c["sweep_items"] == tm["sweep_phases"]["n_items"] + c["rows_reswept"]  # one item a row
    assert c["edges_stored"] == res.edges.n_edges == res0.edges.n_edges


def test_existing_keys_stay(scans):
    _, tm, _ = scans[0]
    for k in ("preprocess_s", "engine_build_s", "threshold_s", "sweep_s", "sort_s",
              "aracne_s", "write_s", "total_s"):
        assert tm[k] > 0, k
    assert set(tm["preprocess_phases"]) == {"parse_s", "read_s", "decode_s", "upload_s",
                                            "lists_s", "filter_s", "weights_s", "outputs_s"}
    assert set(tm["threshold_phases"]) == {"draws_s", "device_s", "pairs", "total_s"}
    assert {"compute_s", "checkpoint_s", "fetch_s", "wog_s", "n_rows", "n_items",
            "rerun_rows", "wog_candidates", "wog_pairs_s"} <= set(tm["sweep_phases"])
    assert "native_s" in tm["aracne_phases"]
    assert set(tm["write_phases"]) == {"couplings_s", "outliers_s", "nodes_s"}
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
    tms = [tm for _, tm, _ in scans]
    want = np.mean([sum(s["end"] - s["start"] for s in tm["spans"] if s["path"] == path)
                    for tm in tms])
    assert reader(name)(run_of(tms)) == pytest.approx(want, rel=1e-12) and want > 0
    lacking = [tms[0], {**tms[1], "spans": [s for s in tms[1]["spans"] if s["path"] != path]}]
    assert reader(name)(run_of(lacking)) is None
    assert reader(name)(run_of([{"preprocess_s": 1.0}])) is None  # a program without spans
    assert reader(name)(run_of([])) is None


def test_write_rate_reader(scans):
    tms = [tm for _, tm, _ in scans]
    rates = []
    for res, tm, _ in scans:
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
