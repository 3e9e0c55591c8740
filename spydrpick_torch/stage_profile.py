"""Stage times and device-busy shares of the port's default run.

    python -m spydrpick_torch.stage_profile [--samples 3000] [--loci 30720]
        [--runs 3] [--seed 0] [--trace-dir DIR]

Generates the bench.py "medium" alignment (uniform states, 5% gaps,
weights uniform in [0.1, 1), ``numpy.random.default_rng(seed)``), writes
it as FASTA plus a weights file into a temporary directory, and runs
``run_pipeline`` on it ``--runs`` times in one process (the automatic
threshold, ``--seed 1``), printing each run's stage seconds.  Then it
runs two more sweeps of the pipeline's lazy-wog engine and two exact-wog
sweeps (``wog_fetch="full"``, the library default: B3 instead of K1),
untraced, printing each one's seconds (``MIEngine.sweep``'s timings) and
peak device memory, and traces one more tournament, lazy sweep and
exact-wog sweep with torch.profiler, printing for each traced region:

  * wall: the region's own span in the trace (a ``record_function``
    annotation that ends after a device synchronize);
  * busy: the union of the intervals of every kernel, memcpy and memset
    in that span (``utils.profiling.busy_union``: overlapping work counts
    once), and busy / wall;
  * lead: the time from the region's start to its first device event,
    and the longest gap between device events;
  * the device time of the kernels that took the most.

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


def bench_alignment(S: int, L: int, seed: int = 0):
    """The bench.py generator (bench.py:158-169): uniform states, 5% gaps,
    weights uniform in [0.1, 1)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(S, L)).astype(np.uint8)
    codes[rng.random((S, L)) < 0.05] = 4
    return codes, rng.random(S) * 0.9 + 0.1


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m spydrpick_torch.stage_profile",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--samples", type=int, default=3000)
    ap.add_argument("--loci", type=int, default=30720)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0, help="data seed")
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("stage_profile: no CUDA device visible to PyTorch", file=sys.stderr)
        return 2
    from spydrpick_torch.engine.solver import MIEngine
    from spydrpick_torch.engine.threshold import default_mi_values, determine_mi_threshold
    from spydrpick_torch.pipeline import (PipelineOptions, engine_config, load_and_preprocess,
                                          run_pipeline)

    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
    with tempfile.TemporaryDirectory() as td:
        codes, w = bench_alignment(args.samples, args.loci, args.seed)
        fasta, wfile = write_inputs(td, "bench", codes, w)
        opts = PipelineOptions(alignmentfile=fasta, sample_weights=wfile, seed=1,
                               output_dir=os.path.join(td, "out"))
        for run in range(args.runs):
            tm: dict = {}
            res = run_pipeline(opts, timings=tm)
            flat = {k: round(v, 6) for k, v in tm.items() if isinstance(v, float)}
            print(json.dumps({"run": run, "edges": res.edges.n_edges,
                              "threshold": res.mi_threshold, **flat,
                              "sweep_phases": tm.get("sweep_phases")}), flush=True)

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
