"""Readings for the limits of ``correct``: the program's sound runs and the
control, at a cell's own size, on several seeds, in one process.

    python3 gwes_bench/control.py --workload <name> --seeds 11 12 13 ...

For each seed: the cell's alignment and files from the seed, one scan of
the program on them (``run_pipeline`` as in a run's window; the first
also builds the kernels), then the control's own output: the reference itself put in the
program's place, with its crosstables in bfloat16 (operands and
products) and its MI in float32, one step below each precision that the
configuration states, and otherwise the reference's rules: the held
threshold or its own tournament, unit or cluster weights, as the
command line says; then one float64 reference pass that judges both
outputs alike.
Prints one JSON line per seed, ``{"seed", "program": numbers, "control":
numbers}``; the benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
if __package__ in (None, ""):
    sys.path.insert(0, str(ROOT))


def control_output(control, inputs, device, work_dir: str):
    """The control's scan output: the reference in its lower precision
    put in the program's place, from one pass of its own: its threshold,
    its edges (every pair above it), colmax, gaps-excluded MI and ARACNE
    flags, and its files rendered into a directory under ``work_dir``."""
    import numpy as np
    import torch

    from gwes_bench.reference import render
    from gwes_bench.reference.judge import ScanOutput
    from gwes_bench.reference.scan import aracne_direct, desc_order, outlier_thresholds

    p = inputs.params
    thr = control.save_threshold()
    L = control.L
    colmax = torch.full((L,), -np.inf, dtype=torch.float64, device=device)
    parts = []
    for i0, j0, mi in control.blocks():
        control.fold_colmax(colmax, i0, j0, mi)
        ri, rj = (mi > thr).nonzero(as_tuple=True)
        parts.append(((ri + i0).cpu().numpy(), (rj + j0).cpu().numpy(), mi[ri, rj].cpu().numpy()))
    i, j, mi = (np.concatenate(x) for x in zip(*parts))
    colmax = colmax.cpu().numpy()
    order = desc_order(i, j, mi, device)
    i, j, mi = i[order], j[order], mi[order]
    thr_out, thr_ext = outlier_thresholds(colmax)
    wog = mi.copy()
    cand = mi >= thr_out
    if cand.any():
        wog[cand] = control.pair_mi(i[cand], j[cand], wog=True)
    flags = (np.zeros(len(mi), np.uint8) if p["no_aracne"] else
             aracne_direct(i, j, mi, p["aracne_edge_threshold"], L, device))
    out_dir = tempfile.mkdtemp(prefix="control.", dir=work_dir)
    base = p["output_indexing_base"]
    p1, p2, d = render.positions(i, j, control.kept, base, control.n_original,
                                 p["linear_genome"])
    nodes = np.unique(np.concatenate([i[cand], j[cand]]))
    names = render.file_names(inputs.id_string, control.S, L, len(mi), base,
                              0 < len(nodes) < L)
    files = {"couplings": lambda: render.couplings_bytes(p1, p2, d, flags, mi, device),
             "outliers": lambda: render.outliers_bytes(p1, p2, d, flags, mi, wog, thr_out,
                                                       thr_ext, p["ld_threshold"]),
             "nodes": lambda: render.fasta_bytes(inputs.names,
                                                 inputs.codes[:, control.kept[nodes]])}
    for kind, name in names.items():
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(files[kind]())
    return ScanOutput(control.kept, thr, i, j, mi, wog, colmax, flags, out_dir)


def readings(cell, seed: int, device) -> dict:
    """The numbers of the program's scan and of the control on one seed,
    both judged by one pass of the reference."""
    import torch

    from gwes_bench import generate
    from gwes_bench.reference import options
    from gwes_bench.reference.judge import Inputs, judge
    from gwes_bench.reference.scan import Reference
    from gwes_bench.run import scan_options, scan_output
    from spydrpick_torch.pipeline import run_pipeline

    work = tempfile.mkdtemp(prefix="gwes_control.")
    try:
        codes = generate.alignment(cell.config, cell.traffic, seed, device)
        fasta = generate.write_fasta(work, codes)
        argv = generate.scan_args(cell.config, cell.traffic, fasta, seed)
        out = tempfile.mkdtemp(prefix="scan.", dir=work)
        res = run_pipeline(scan_options([*argv, "--output-dir", out]))
        program = scan_output(res, out)
        del res
        if device.type == "cuda":
            torch.cuda.empty_cache()
        params = options.parse(argv)
        inputs = Inputs(codes=codes, id_string=generate.FASTA_NAME.split(".")[0],
                        names=generate.sample_names(codes.shape[0]), params=params)
        control = Reference(codes, params, device, table_dtype=torch.bfloat16,
                            mi_dtype=torch.float32)
        ctl = control_output(control, inputs, device, work)
        del control
        nums = judge(inputs, [program, ctl], device)
        return {"seed": seed, "program": nums[0], "control": nums[1]}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gwes_bench/control.py", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from gwes_bench.run import CACHE_DIRS

    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / rel)
    import torch

    from gwes_bench.cells import resolve

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = resolve(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = readings(cell, seed, torch.device("cuda:0"))
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
