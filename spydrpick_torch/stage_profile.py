"""Stage times and device-busy shares of the port's default run, and of
the wide-alignment sweep.

    python -m spydrpick_torch.stage_profile [--samples 3000] [--loci 30720]
        [--runs 3] [--seed 0] [--trace-dir DIR]
    python -m spydrpick_torch.stage_profile --wide [--samples 256]
        [--loci 998400] [--threshold 0.084647] [--storage codes]
        [--row-window 65536] [--runs 1] [--seed 0] [--trace-dir DIR]

Generates the bench.py "medium" alignment (uniform states, 5% gaps,
weights uniform in [0.1, 1), ``numpy.random.default_rng(seed)``), writes
it as FASTA plus a weights file into a temporary directory, and runs
``run_pipeline`` on it ``--runs`` times in one process (the automatic
threshold, ``--seed 1``), printing each run's stage seconds, its
preprocess, tournament and sweep phases and its peak device memory.  Then it runs two more sweeps of the pipeline's lazy-wog
engine and two exact-wog sweeps (``wog_fetch="full"``, the library
default: B3 instead of K1), untraced, printing each one's seconds
(``MIEngine.sweep``'s timings) and peak device memory, and traces one
more tournament, lazy sweep and exact-wog sweep with torch.profiler,
printing for each traced region:

  * wall: the region's own span in the trace (a ``record_function``
    annotation that ends after a device synchronize);
  * busy: the union of the intervals of every kernel, memcpy and memset
    in that span (``utils.profiling.busy_union``: overlapping work counts
    once), and busy / wall;
  * lead: the time from the region's start to its first device event,
    and the longest gap between device events;
  * the device time of the kernels that took the most.

``--wide``: the wide-alignment sweep instead.  The same generator at
``--samples`` x ``--loci`` (the defaults are scripts/bench_1m_width.py's
alignment, S=256 x L=998,400) goes straight into a lazy-wog
``MIEngine`` with ``--storage`` and ``--row-window`` (EngineConfig's
``onehot_storage`` and ``row_window``); it sweeps at ``--threshold``
``--runs`` times untraced, printing sweep_s, compute_s, fetch_s, wog_s,
n_items, expand_s (codes storage), rerun_rows, the edge count, column
pairs/s and peak device memory, then once traced, printing the region's
busy share and top kernels as above.

The traces are written to ``--trace-dir`` when it is given.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np


def bench_alignment(S: int, L: int, seed: int = 0, rng: np.random.Generator | None = None,
                    weighted: bool = True):
    """The bench.py generator (bench.py:158-169): uniform states, 5% gaps,
    weights uniform in [0.1, 1), or None and no draw unless ``weighted``
    (bench.py's ``BENCH_UNIT_WEIGHTS=1``).  It draws from ``rng`` when one
    is given (bench.py draws its threshold pairs from the same generator
    next), else from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed) if rng is None else rng
    codes = rng.integers(0, 4, size=(S, L)).astype(np.uint8)
    codes[rng.random((S, L)) < 0.05] = 4
    return codes, (rng.random(S) * 0.9 + 0.1 if weighted else None)


def write_inputs(td: str, name: str, codes: np.ndarray, weights: np.ndarray):
    """``name``.fasta (one record per sample, states A C G T -) and
    ``name``.weights in ``td``; returns both paths."""
    fasta = os.path.join(td, f"{name}.fasta")
    alphabet = np.frombuffer(b"ACGT-", dtype=np.uint8)
    with open(fasta, "wb") as f:
        for i, row in enumerate(codes):
            f.write(b">s%d\n" % i + alphabet[row].tobytes() + b"\n")
    wfile = os.path.join(td, f"{name}.weights")
    with open(wfile, "w") as f:
        f.write("\n".join(f"{x:.9f}" for x in weights))
    return fasta, wfile


def traced(name: str, fn, trace_dir: str | None) -> dict:
    """Run ``fn`` once under torch.profiler; the region's wall, device
    busy time, lead-in, longest idle gap and top kernels, in seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from spydrpick_torch.utils.profiling import busy_union, device_intervals

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(f"region:{name}"):
            fn()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(trace_dir or td, f"{name}_trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    region = [e for e in events if e.get("name") == f"region:{name}"
              and e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    if len(region) != 1:
        raise RuntimeError(f"{name}: {len(region)} region annotations in the trace")
    lo = float(region[0]["ts"])
    hi = lo + float(region[0]["dur"])
    iv = device_intervals(events, lo, hi)
    if not iv:
        raise RuntimeError(f"{name}: the trace holds no device event")
    iv.sort()
    gaps, reach = [], iv[0][1]
    for a, b, _ in iv[1:]:
        gaps.append(a - reach)
        reach = max(reach, b)
    per_kernel: dict[str, float] = defaultdict(float)
    for a, b, k in iv:
        per_kernel[k] += b - a
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:5]
    us = 1e-6
    return {
        "wall_s": (hi - lo) * us,
        "busy_s": busy_union(iv) * us,
        "busy_share": busy_union(iv) / (hi - lo),
        "lead_s": (iv[0][0] - lo) * us,
        "max_gap_s": max(gaps, default=0.0) * us,
        "device_events": len(iv),
        "top_kernels_s": {k: v * us for k, v in top},
    }


def timed_sweep(name: str, engine, thr: float) -> dict:
    """One untraced ``engine.sweep(thr)``: its wall seconds, its timings
    and the peak device memory while it ran, in GiB."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tm: dict = {}
    t0 = time.perf_counter()
    edges = engine.sweep(thr, timings=tm)
    return {"sweep": name, "sweep_s": time.perf_counter() - t0, "edges": edges.n_edges,
            **{k: v for k, v in tm.items() if k != "n_rows"},
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def wide(args) -> int:
    """``--wide``: the untraced and traced sweeps of the module docstring."""
    import torch

    from spydrpick_torch.core.alignment import Alignment
    from spydrpick_torch.engine.solver import EngineConfig, MIEngine

    S, L = args.samples, args.loci
    codes, w = bench_alignment(S, L, args.seed)
    al = Alignment(codes, [f"s{i}" for i in range(S)], "wide", np.arange(L), L, w)
    t0 = time.perf_counter()
    engine = MIEngine(al, EngineConfig(onehot_storage=args.storage, row_window=args.row_window,
                                       wog_fetch="outliers"))
    torch.cuda.synchronize()
    st = engine.statics
    print(json.dumps({"samples": S, "loci": L, "threshold": args.threshold,
                      "int8_mode": st.int8_mode, "onehot_codes": st.onehot_codes,
                      "row_window": st.row_window, "Lp": st.Lp,
                      "engine_build_s": time.perf_counter() - t0,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    pairs = L * (L - 1) / 2
    for _ in range(args.runs):
        r = timed_sweep("wide", engine, args.threshold)
        print(json.dumps({**r, "pairs_per_s": pairs / r["sweep_s"]}), flush=True)
    region = traced("wide_sweep", lambda: engine.sweep(args.threshold), args.trace_dir)
    print(json.dumps({"region": "wide_sweep", **region}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m spydrpick_torch.stage_profile",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--samples", type=int, default=None, help="default 3000 (--wide: 256)")
    ap.add_argument("--loci", type=int, default=None, help="default 30720 (--wide: 998400)")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0, help="data seed")
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--wide", action="store_true",
                    help="profile the wide-alignment sweep (module docstring)")
    ap.add_argument("--threshold", type=float, default=0.084647, help="--wide: MI threshold")
    ap.add_argument("--storage", choices=["auto", "dense", "codes"], default="codes",
                    help="--wide: one-hot residency")
    ap.add_argument("--row-window", type=int, default=65536, help="--wide: j-window width")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("stage_profile: no CUDA device visible to PyTorch", file=sys.stderr)
        return 2
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
    args.samples = args.samples or (256 if args.wide else 3000)
    args.loci = args.loci or (998400 if args.wide else 30720)
    if args.wide:
        return wide(args)
    from spydrpick_torch.engine.solver import MIEngine
    from spydrpick_torch.engine.threshold import default_mi_values, determine_mi_threshold
    from spydrpick_torch.pipeline import (PipelineOptions, engine_config, load_and_preprocess,
                                          run_pipeline)

    with tempfile.TemporaryDirectory() as td:
        codes, w = bench_alignment(args.samples, args.loci, args.seed)
        fasta, wfile = write_inputs(td, "bench", codes, w)
        opts = PipelineOptions(alignmentfile=fasta, sample_weights=wfile, seed=1,
                               output_dir=os.path.join(td, "out"))
        for run in range(args.runs):
            tm: dict = {}
            torch.cuda.reset_peak_memory_stats()
            res = run_pipeline(opts, timings=tm)
            flat = {k: round(v, 6) for k, v in tm.items() if isinstance(v, float)}
            print(json.dumps({"run": run, "edges": res.edges.n_edges,
                              "threshold": res.mi_threshold, **flat,
                              "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                              **{k: tm.get(k) for k in ("preprocess_phases",
                                                        "threshold_phases", "sweep_phases")}}),
                  flush=True)

        al = load_and_preprocess(opts)
        engine = MIEngine(al, engine_config(opts))
        top_pairs = default_mi_values(al.n_loci, 0)
        thr = determine_mi_threshold(engine, top_pairs, seed=1)
        for _ in range(2):
            print(json.dumps(timed_sweep("lazy", engine, thr)), flush=True)
        t0 = time.perf_counter()
        regions = {
            "tournament": traced("tournament", lambda: determine_mi_threshold(
                engine, top_pairs, seed=1), args.trace_dir),
            "sweep": traced("sweep", lambda: engine.sweep(thr), args.trace_dir),
        }
        del engine
        full = MIEngine(al, dataclasses.replace(engine_config(opts), wog_fetch="full"))
        for _ in range(2):  # the first also warms B3 up
            print(json.dumps(timed_sweep("exact_wog", full, thr)), flush=True)
        regions["sweep_full"] = traced("sweep_full", lambda: full.sweep(thr), args.trace_dir)
        for name, r in regions.items():
            print(json.dumps({"region": name, **r}), flush=True)
        print(f"# traced regions in {time.perf_counter() - t0:.2f} s; "
              f"{torch.cuda.get_device_name(0)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
