"""The main path's stage split and outputs in two checkouts of this
repository, in turns on one card.

    python -m spydrpick_torch.host_ab PARENT_DIR CHANGE_DIR [--width]

It runs PARENT_DIR, CHANGE_DIR, CHANGE_DIR, PARENT_DIR, each as ``python
-m spydrpick_torch.bench`` in a process of its own started in that
checkout, with BENCH_E2E_RUNS=5 warm end-to-end runs at the bench's
default shape (S=3000 x L=30720, weighted fixed14).  It prints one JSON line per run (the warm
end-to-end median and every total, each stage's median, the phases of the
sweep, the preprocess, ARACNE and the write, the sweep minimum, edges and
threshold), then per checkout the median of all its warm totals and, per
stage and per phase, the median of its runs' medians.  ``--width`` then
runs both checkouts' bench once each, parent first, at the width shape
(S=256 x L=998,400, codes storage, j-windows of 65,536, no end to end, two
timed sweeps) and prints the best sweep's phases (fetch_s among them) and
its peak memory.

Before the turns, each checkout's CLI runs once on the bench's alignment
(written as FASTA and a weights file, ``--seed 1``), and the files of the
two runs must be byte-identical: their names and sha256 digests are
printed.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile

STAGES = ("preprocess_s", "engine_build_s", "threshold_s", "sweep_s", "sort_s", "aracne_s",
          "write_s", "total_s")
PHASES = ("sweep_phases", "preprocess_phases", "aracne_phases", "write_phases")
WIDTH_ENV = {"BENCH_SAMPLES": "256", "BENCH_LOCI": "998400", "BENCH_ONEHOT": "codes",
             "BENCH_ROW_WINDOW": "65536", "BENCH_E2E": "0", "BENCH_SWEEPS": "2",
             "BENCH_SWEEPS_MAX": "2"}


def bench(tree: str, env: dict) -> dict:
    """The JSON line of ``python -m spydrpick_torch.bench`` run in ``tree``."""
    env = {**{k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}, **env}
    out = subprocess.run([sys.executable, "-m", "spydrpick_torch.bench"], cwd=tree, env=env,
                         capture_output=True, text=True, timeout=1500)
    last = (out.stdout.strip().splitlines() or [""])[-1]
    if out.returncode or not last.startswith("{"):
        sys.stderr.write(out.stdout[-3000:] + out.stderr[-3000:])
        raise SystemExit(f"host_ab: the bench of {tree} failed ({out.returncode})")
    return json.loads(last)


def cli_outputs(trees: dict) -> None:
    """Run each checkout's CLI on the bench alignment; its files must be
    byte-identical across the checkouts."""
    from spydrpick_torch.stage_profile import bench_alignment, write_inputs

    with tempfile.TemporaryDirectory() as td:
        codes, w = bench_alignment(3000, 30720, seed=0)
        fasta, wfile = write_inputs(td, "bench", codes, w)
        del codes
        digests = {}
        for label, tree in trees.items():
            out = os.path.join(td, label)
            res = subprocess.run([sys.executable, "-m", "spydrpick_torch", fasta,
                                  "--sample-weights", wfile, "--seed", "1", "--output-dir", out],
                                 cwd=tree, capture_output=True, text=True, timeout=600)
            if res.returncode:
                sys.stderr.write(res.stdout[-3000:] + res.stderr[-3000:])
                raise SystemExit(f"host_ab: the CLI of {tree} failed ({res.returncode})")
            digests[label] = {}
            for name in sorted(os.listdir(out)):
                with open(os.path.join(out, name), "rb") as f:
                    digests[label][name] = hashlib.sha256(f.read()).hexdigest()
        print(json.dumps({"cli_outputs": digests}), flush=True)
        first, *rest = digests.values()
        if any(d != first for d in rest):
            raise SystemExit("host_ab: the checkouts' CLI outputs differ")


def summary(line: dict) -> dict:
    cfg = line["config"]
    e2e = cfg["end_to_end_s"]
    return {"total_s_all": e2e.get("total_s_all"),
            **{k: e2e.get(k) for k in STAGES},
            **{k: e2e.get(k) or {} for k in PHASES},
            "busy_share": e2e.get("busy_share"), "peak_gib_all": e2e.get("peak_gib_all"),
            "sweep_min_s": cfg["sweep_seconds"],
            "edges": e2e.get("edges"), "mi_threshold": e2e.get("mi_threshold"),
            "device": cfg["device"], "power_limit": cfg["power_limit"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m spydrpick_torch.host_ab",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--width", action="store_true", help="also the width shape's fetch")
    args = ap.parse_args(argv)
    trees = {"parent": os.path.abspath(args.parent), "change": os.path.abspath(args.change)}
    cli_outputs(trees)
    order = list(trees.items())
    runs: dict = {"parent": [], "change": []}
    for label, tree in order + order[::-1]:
        s = summary(bench(tree, {"BENCH_E2E_RUNS": "5"}))
        runs[label].append(s)
        print(json.dumps({"tree": label, **s}), flush=True)
    for label, got in runs.items():
        print(json.dumps({
            "tree": label, "warm_runs": sum(len(s["total_s_all"]) for s in got),
            "median_total_s": statistics.median(t for s in got for t in s["total_s_all"]),
            **{f"median_{k}": statistics.median(s[k] for s in got) for k in STAGES},
            **{f"median_{p}": {k: statistics.median(s[p][k] for s in got)
                               for k in got[0][p] if all(k in s[p] for s in got)}
               for p in PHASES},
            "edges": sorted({s["edges"] for s in got}),
            "mi_threshold": sorted({s["mi_threshold"] for s in got})}), flush=True)
    if args.width:
        for label, tree in trees.items():
            cfg = bench(tree, WIDTH_ENV)["config"]
            print(json.dumps({"tree": label, "width": True, "sweep_s": cfg["sweep_seconds"],
                              "sweep_seconds_all": cfg["sweep_seconds_all"],
                              "phases": cfg["phases"], "sweep_peak_gib": cfg["sweep_peak_gib"],
                              "edges": cfg["edges"], "threshold": cfg["threshold"],
                              "device": cfg["device"], "power_limit": cfg["power_limit"]}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
