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
(written as FASTA and a weights file, ``--seed 1``): the names and sha256
digests of both runs' files are printed, and where they differ, the rows
that only one tree wrote (``diff_rows``).  Then each checkout's
tournament threshold at full precision is printed beside the float64
tournament of ``ops/reference.py``'s MI on the same pairs and the
tournaments of three f32 versions of the pairs path
(``tournament_variants``).  Needs a CUDA device.
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
PHASES = ("sweep_phases", "preprocess_phases", "threshold_phases", "aracne_phases",
          "write_phases")
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


# one tree's tournament threshold at full precision (an API older trees share)
THRESHOLD_SNIPPET = """
import sys
from spydrpick_torch.engine.solver import MIEngine
from spydrpick_torch.engine.threshold import default_mi_values, determine_mi_threshold
from spydrpick_torch.pipeline import PipelineOptions, engine_config, load_and_preprocess
opts = PipelineOptions(alignmentfile=sys.argv[1], sample_weights=sys.argv[2], seed=1)
al = load_and_preprocess(opts)
engine = MIEngine(al, engine_config(opts))
print(repr(determine_mi_threshold(engine, default_mi_values(al.n_loci, 0), seed=1)))
"""
DIFF_ROWS = 20  # rows printed per file and side


def diff_rows(a_dir: str, b_dir: str) -> dict:
    """Per output kind (couplings, outliers, outlier-node FASTA), the rows
    that only the first or only the second run wrote: their counts, the
    first DIFF_ROWS of each, and, over all of them, for rows of one pair
    (the first two fields) in both runs the columns that differ and each
    one's largest |difference|, for the rest the range of their MI (the
    fifth field)."""
    def kind(name):
        return ("couplings" if "edges" in name else "outliers" if name.endswith("outliers")
                else "nodes")

    rows = {}
    for d in (a_dir, b_dir):
        for name in os.listdir(d):
            with open(os.path.join(d, name)) as f:
                rows.setdefault(kind(name), []).append(f.read().splitlines())
    out = {}
    for k, (a, b) in rows.items():
        sa, sb = set(a), set(b)
        only_a, only_b = [r for r in a if r not in sb], [r for r in b if r not in sa]
        if not (only_a or only_b):
            continue
        ka = {tuple(r.split()[:2]): r.split() for r in only_a}
        kb = {tuple(r.split()[:2]): r.split() for r in only_b}
        both = sorted(set(ka) & set(kb))
        cols: dict = {}
        for key in both:
            for c, (x, y) in enumerate(zip(ka[key], kb[key])):
                if x != y:
                    d = abs(float(x) - float(y))
                    cols[c] = max(cols.get(c, 0.0), d)
        lone = [ka[key] for key in set(ka) - set(kb)] + [kb[key] for key in set(kb) - set(ka)]
        mi = [float(r[4]) for r in lone if len(r) > 4]
        out[k] = {"n_only_first": len(only_a), "n_only_second": len(only_b),
                  "n_paired": len(both), "paired_columns_max_abs_diff": cols,
                  "n_unpaired": len(lone), "unpaired_mi_range": [min(mi), max(mi)] if mi else None,
                  "only_first": only_a[:DIFF_ROWS], "only_second": only_b[:DIFF_ROWS]}
    return out


def mi_f64(C, ip, jp, pc: float):
    """``ops/reference.py:mi_single`` for P pairs at once, in float64:
    C (P, 5, 5) float64 counts, ip and jp (P, 5) bool presence."""
    import torch

    pm = (ip[:, :, None] & jp[:, None, :]).to(torch.float64)
    A = C + pc * pm
    P = A / (A * pm).sum((1, 2))[:, None, None]
    xlx = lambda x: torch.where(x > 0, x * torch.log(torch.where(x > 0, x, 1.0)), 0.0)
    joint = (xlx(P) * pm).sum((1, 2))
    icond = (xlx(P.sum(1)) * jp).sum(1)
    jcond = (xlx((P * jp[:, None, :]).sum(2)) * ip).sum(1)
    return joint - icond - jcond


def tournament_variants(fasta: str, wfile: str, seed: int = 1, iterations: int = 10) -> dict:
    """The tournament of ``determine_mi_threshold`` (the same draws, order
    statistic and lower median) on the card over four versions of its
    pairs' MI: "float64", ``ops/reference.py``'s MI in float64 from counts
    summed in float64 with the file's float64 weights (``mi_f64``, held
    to ``mi_single`` on the first pairs); "f32_sums", the f32 weights
    summed in f32 by torch (the plain-torch pairs path that ``pairs_xtab``
    replaced) and the f32 epilogue
    ``mi_from_crosstabs``; "exact_sums", ``pairs_xtab``'s tables (exact
    sums, one rounding) and the f32 epilogue; "exact_sums_f64_epilogue",
    ``pairs_xtab``'s tables and the epilogue in float64, rounded to f32.
    Returns each one's threshold and, for all but "float64", the mean and
    largest |MI - float64 MI| over the pairs."""
    import numpy as np
    import torch

    from spydrpick_torch.engine import threshold as th
    from spydrpick_torch.ops import reference
    from spydrpick_torch.ops.mi import mi_from_crosstabs
    from spydrpick_torch.ops.pairs import pairs_xtab
    from spydrpick_torch.pipeline import PipelineOptions, load_and_preprocess

    al = load_and_preprocess(PipelineOptions(alignmentfile=fasta, sample_weights=wfile, seed=1))
    dev = torch.device("cuda")
    codes = torch.from_numpy(np.ascontiguousarray(al.codes)).to(dev)
    w64 = torch.from_numpy(np.asarray(al.weights, dtype=np.float64)).to(dev)
    w32 = w64.to(torch.float32)
    pres = torch.from_numpy(al.state_presence).to(dev)
    L = al.n_loci
    possible = L * (L - 1) // 2
    pct = 1.0 - float(th.default_mi_values(L, 0)) / possible
    pairs_n = th.determine_threshold_pairs(0, possible, pct)
    k = min(int(pct * pairs_n), pairs_n - 1)
    bins = torch.arange(25, dtype=torch.int64, device=dev)
    rng = np.random.default_rng(seed)
    names = ("float64", "f32_sums", "exact_sums", "exact_sums_f64_epilogue")
    stats = {n: [] for n in names}
    err = {n: [0.0, 0.0] for n in names[1:]}  # sum and max of |d|
    for it in range(iterations):
        ii, jj = th.sample_pairs(rng, pairs_n, L)
        mis = {n: [] for n in names}
        for c0 in range(0, pairs_n, 20000):
            i = torch.from_numpy(ii[c0:c0 + 20000]).to(dev)
            j = torch.from_numpy(jj[c0:c0 + 20000]).to(dev)
            ci, cj = codes[:, i], codes[:, j]
            q = ci.to(torch.int64) * 5 + cj
            base = torch.arange(len(i), device=dev) * 25
            hit = q < 25
            C64 = torch.bincount((base + q)[hit], weights=w64[:, None].expand_as(q)[hit],
                                 minlength=len(i) * 25).view(-1, 5, 5)
            C32 = torch.where(q[:, None, :] == bins[None, :, None], w32[:, None, None],
                              0.0).sum(dim=0).T.reshape(-1, 5, 5)
            Cx = pairs_xtab(ci.contiguous(), cj.contiguous(), w32)
            ip, jp = pres[i], pres[j]
            mis["float64"].append(mi_f64(C64, ip, jp, 0.5))
            mis["f32_sums"].append(mi_from_crosstabs(C32, ip, jp, 0.5))
            mis["exact_sums"].append(mi_from_crosstabs(Cx, ip, jp, 0.5))
            mis["exact_sums_f64_epilogue"].append(
                mi_from_crosstabs(Cx.double(), ip, jp, 0.5).float())
            if it == 0 and c0 == 0:
                want = [reference.mi_single(reference.crosstab_pair(
                    al.codes[:, a], al.codes[:, b], al.weights), al.state_presence[a],
                    al.state_presence[b]) for a, b in zip(ii[:50], jj[:50])]
                e = float(np.max(np.abs(mis["float64"][0][:50].cpu().numpy() - want)))
                if e > 1e-12:
                    raise SystemExit(f"host_ab: mi_f64 off ops/reference.py by {e}")
        ref = torch.cat(mis["float64"])
        for n in names:
            m = torch.cat(mis[n])
            stats[n].append(float(torch.sort(m).values[k]))
            if n != "float64":
                d = (m.double() - ref).abs()
                err[n][0] += float(d.sum())
                err[n][1] = max(err[n][1], float(d.max()))
    med = iterations // 2 - (0 if iterations % 2 else 1)
    out = {n: {"threshold": float(np.partition(np.array(v), med)[med])}
           for n, v in stats.items()}
    for n, (tot, big) in err.items():
        out[n].update(mean_abs_err=tot / (pairs_n * iterations), max_abs_err=big)
    return out


def cli_outputs(trees: dict) -> None:
    """Run each checkout's CLI on the bench alignment; print its files'
    digests, the rows that differ between the checkouts, and each
    checkout's tournament threshold beside the float64 tournament's."""
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
        labels = list(trees)
        if digests[labels[0]] != digests[labels[1]]:
            print(json.dumps({"cli_outputs_differ": labels, "diff_rows": diff_rows(
                *(os.path.join(td, label) for label in labels))}), flush=True)
        thr = {}
        for label, tree in trees.items():
            res = subprocess.run([sys.executable, "-c", THRESHOLD_SNIPPET, fasta, wfile],
                                 cwd=tree, capture_output=True, text=True, timeout=600)
            if res.returncode:
                sys.stderr.write(res.stdout[-3000:] + res.stderr[-3000:])
                raise SystemExit(f"host_ab: the tournament of {tree} failed")
            thr[label] = float(res.stdout.strip().splitlines()[-1])
        var = tournament_variants(fasta, wfile)
        thr["float64"] = var["float64"]["threshold"]
        print(json.dumps({"thresholds": thr, "distance_to_float64": {
            k: abs(v - thr["float64"]) for k, v in thr.items() if k != "float64"},
            "tournament_variants": var}), flush=True)


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
