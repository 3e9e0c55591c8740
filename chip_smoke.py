"""On-card smoke test of the PyTorch/CUDA port (spydrpick_torch).

Run from the repository root on a machine with an NVIDIA GPU:

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):
  1. environment and build: versions, the card's name and power limit,
     and the nvcc build of spydrpick_torch/csrc;
  2. kernel K1 (MI tile) against its plain PyTorch version, max |dmi| <=
     1e-5, with both times:
     a. on contiguous random slab operands at S=3072, TI=512 and TJ in
        {512, 30720}, in the fixed14, unit-int8 and bf16 modes;
     b. at the main path's shapes: the engine's own K1 arguments
        (``MIEngine.row_args``) for the S=3000 x L=30720 bench alignment,
        at the first block-row and one in the middle (a strided column
        view of the one-hot, TJ = Lp - i0, a sample tail of 3000 % 64),
        in the fixed14, unit-int8 and bf16 modes;
  3. kernel K2 (row compaction) against its plain version at (512, 30720)
     and mask densities 0, 1%, 30%, 100%, with and without wog: counts and
     compacted prefixes exactly equal, with both times;
  4. slice parity: the engine's sweep of a weighted S=256 x L=2048
     alignment on the card against the same engine on the CPU;
  5. the main path at the size users run it: ``spydrpick_torch.cli.main``
     on the weighted S=3000 x L=30720 alignment (the bench.py "medium"
     generator) with the automatic threshold; both kernels must have been
     launched by it.
The line before the last is a JSON object with each kernel's route,
source, launches in phase 5, max error over phases 2-3 and times at the
main path's shape; the last line is ``{"ok": true, "device": {...}}``.
Without a GPU it exits with an error before printing any result.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

K1_TOL = 1e-5  # same integer crosstables; only f32 log/sum order may differ
S_BENCH, L_BENCH = 3000, 30720


def cuda_time_ms(fn, n: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``n`` calls after one
    warm-up call, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def phase_env():
    from spydrpick_torch.ops import cuda_build

    print(f"# phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    nvcc = subprocess.run([cuda_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"# nvcc: {nvcc}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    _, report = cuda_build.build()
    cuda_build.load()
    print(f"# kernels built in {time.perf_counter() - t0:.2f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            print(f"#   ptxas: {line.strip()}")
    return smi


def k1_operands(S, TI, TJ, mode, rng, dev):
    """Random slab one-hot operands of each mode, as the engine builds them."""
    from spydrpick_torch.ops.mi_kernels import BW, split_bf16, to_slab

    codes = rng.integers(0, 5, size=(S, TJ))
    oh = np.zeros((S, TJ, 5), np.int8)
    np.put_along_axis(oh, codes[:, :, None], 1, axis=2)
    xj = to_slab(torch.from_numpy(oh.reshape(S, TJ * 5)), BW).to(dev)
    pf = to_slab(torch.from_numpy((oh.sum(0) > 0).astype(np.float32).reshape(-1)), BW).to(dev)
    xi = xj[:, :TI * 5]
    w = torch.from_numpy((rng.random(S) * 0.9 + 0.1).astype(np.float32)).to(dev)
    if mode == "unit":
        return (xi.contiguous(), None, xj, pf[:TI * 5], pf, (1,), 1.0)
    if mode == "fixed14":
        q = 16383.0 / float(w.max())
        w_q = torch.clamp(torch.round(w * torch.tensor(q, dtype=torch.float32, device=dev)),
                          0, 16383).to(torch.int32)
        x32 = xi.to(torch.int32)
        hi = (x32 * (w_q // 128)[:, None]).to(torch.int8)
        lo = (x32 * (w_q % 128)[:, None]).to(torch.int8)
        return (hi, lo, xj, pf[:TI * 5], pf, (128, 1), 1.0 / q)
    hi, lo = split_bf16(xi.to(torch.float32) * w[:, None])
    return (hi, lo, xj.to(torch.bfloat16), pf[:TI * 5], pf, (1, 1), 1.0)


def k1_compare(label, args, n, n_plain):
    """K1 against its plain version on the same arguments: max |dmi| (raises
    past K1_TOL) and both mean times."""
    from spydrpick_torch.ops.mi_kernels import mi_tile_single, mi_tile_single_plain

    got = mi_tile_single(*args)
    want = mi_tile_single_plain(*args)
    torch.cuda.synchronize()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"K1 {label}: shape {tuple(got.shape)} or non-finite output")
    err = float((got - want).abs().max())
    if err > K1_TOL:
        raise AssertionError(f"K1 {label}: max|dmi| {err} > {K1_TOL}")
    del got, want
    ms = cuda_time_ms(lambda: mi_tile_single(*args), n)
    plain_ms = cuda_time_ms(lambda: mi_tile_single_plain(*args), n_plain)
    return err, ms, plain_ms


def phase_k1(dev, S=3072, TI=512, widths=(512, 30720)):
    from spydrpick_torch.ops.mi_kernels import BW

    rng = np.random.default_rng(1)
    worst = 0.0
    for TJ in widths:
        for mode in ("fixed14", "unit", "bf16"):
            xi_hi, xi_lo, xj, ipf, jpf, mults, scale = k1_operands(S, TI, TJ, mode, rng, dev)
            args = (xi_hi, xi_lo, xj, ipf, jpf, 0.5, BW, mults, scale)
            n = 20 if TJ == widths[0] else 5
            err, ms, plain_ms = k1_compare(f"{mode} S={S} TJ={TJ}", args, n,
                                           2 if n == 5 else n)
            worst = max(worst, err)
            passes = len(mults)
            tops = 2.0 * S * (TI * 5) * (TJ * 5) * passes / (ms * 1e-3) / 1e12
            unit = "int8 TOP/s" if xi_hi.dtype == torch.int8 else "bf16 TFLOP/s"
            print(f"# K1 {mode:8s} S={S} TI={TI} TJ={TJ:5d}: max|dmi|={err:.3e} "
                  f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, {tops:.2f} {unit} "
                  f"({passes} pass{'es' if passes > 1 else ''})", flush=True)
            del args, xi_hi, xi_lo, xj
            torch.cuda.empty_cache()
    return worst


def phase_k1_main(dev, fasta, wfile):
    """K1 on the engine's own block-row arguments for the bench alignment:
    the main path's shapes, strides and sample tail, in its three modes."""
    from spydrpick_torch.engine.solver import EngineConfig, MIEngine
    from spydrpick_torch.pipeline import PipelineOptions, load_and_preprocess

    al = load_and_preprocess(PipelineOptions(alignmentfile=fasta, sample_weights=wfile))
    weights = al.weights
    worst, main_ms, main_plain_ms = 0.0, None, None
    for mode, mxu_int8, unit in (("fixed14", "auto", False), ("unit", "auto", True),
                                 ("off", "off", False)):
        al.weights = np.ones_like(weights) if unit else weights
        eng = MIEngine(al, EngineConfig(mxu_int8=mxu_int8), device=dev)
        if eng.statics.int8_mode != mode:
            raise AssertionError(f"engine picked {eng.statics.int8_mode}, not {mode}")
        for i0 in (0, (eng.Lp // 2) // eng.tile * eng.tile):
            args = eng.row_args(i0)
            xi, xj = args[0], args[2]
            err, ms, plain_ms = k1_compare(f"main-path {mode} i0={i0}", args, 5, 2)
            worst = max(worst, err)
            print(f"# K1 main path {mode:7s} S={eng.S} i0={i0:5d} TJ={xj.shape[1] // 5:5d} "
                  f"(xi {xi.dtype} row stride {xi.stride(0)}, xj row stride {xj.stride(0)}): "
                  f"max|dmi|={err:.3e} kernel {ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
            if mode == "fixed14" and i0 == 0:
                main_ms, main_plain_ms = ms, plain_ms
            del args, xi, xj
        del eng
        torch.cuda.empty_cache()
    al.weights = weights
    return worst, main_ms, main_plain_ms


def phase_k2(dev, R=512, W=30720):
    from spydrpick_torch.ops.compact import route_rows, route_rows_plain

    rng = np.random.default_rng(2)
    main_ms = main_plain_ms = None
    worst = 0.0
    for density in (0.0, 0.01, 0.3, 1.0):
        for with_wog in (False, True):
            mask = torch.from_numpy(rng.random((R, W)) < density).to(dev)
            mi = torch.from_numpy(rng.random((R, W)).astype(np.float32)).to(dev)
            wog = torch.from_numpy(rng.random((R, W)).astype(np.float32)).to(dev) if with_wog else None
            got = route_rows(mask, mi, wog)
            want = route_rows_plain(mask, mi, wog)
            torch.cuda.synchronize()
            if not torch.equal(got[3], want[3]):
                raise AssertionError(f"K2 density={density}: counts differ")
            lane = torch.arange(W, device=dev)[None, :] < want[3][:, None]
            for name, a, b in zip(("mi", "j", "wog"), got[:3], want[:3]):
                if b is None:
                    continue
                if not torch.equal(a[lane], b[lane]):
                    raise AssertionError(f"K2 density={density} wog={with_wog}: {name} differs")
                if lane.any():
                    d = (a[lane].to(torch.float64) - b[lane].to(torch.float64)).abs().max()
                    worst = max(worst, float(d))
            ms = cuda_time_ms(lambda: route_rows(mask, mi, wog), 10)
            plain_ms = cuda_time_ms(lambda: route_rows_plain(mask, mi, wog), 3)
            print(f"# K2 density={density:<4} wog={with_wog!s:5}: exact; kernel {ms:.3f} ms, "
                  f"plain {plain_ms:.3f} ms", flush=True)
            if density == 0.01 and not with_wog:
                main_ms, main_plain_ms = ms, plain_ms
    return worst, main_ms, main_plain_ms


def phase_parity(dev, td, S=256, L=2048):
    from spydrpick_torch.engine.solver import EngineConfig, MIEngine
    from spydrpick_torch.pipeline import PipelineOptions, load_and_preprocess
    from spydrpick_torch.stage_profile import bench_alignment, write_inputs

    codes, w = bench_alignment(S, L, seed=3)
    fasta, wfile = write_inputs(td, "parity", codes, w)
    al = load_and_preprocess(PipelineOptions(alignmentfile=fasta, sample_weights=wfile,
                                             no_filter_alignment=True))
    cpu = MIEngine(al, EngineConfig(), device="cpu")
    gpu = MIEngine(al, EngineConfig(), device=dev)
    if gpu.statics.int8_mode != "fixed14":
        raise AssertionError(f"parity alignment runs {gpu.statics.int8_mode}, not fixed14")
    rng = np.random.default_rng(4)
    ii, jj = rng.integers(0, al.n_loci, (2, 20000))
    keep = ii != jj
    sample = cpu.pair_mi(np.minimum(ii, jj)[keep], np.maximum(ii, jj)[keep])
    thr = float(np.quantile(sample, 1 - 100 * al.n_loci / (al.n_loci * (al.n_loci - 1) / 2)))
    t0 = time.perf_counter()
    a = cpu.sweep(thr)
    t1 = time.perf_counter()
    b = gpu.sweep(thr)
    t2 = time.perf_counter()
    ea = {(i, j): m for i, j, m in zip(a.ipos.tolist(), a.jpos.tolist(), a.mi.tolist())}
    eb = {(i, j): m for i, j, m in zip(b.ipos.tolist(), b.jpos.tolist(), b.mi.tolist())}
    flips = [k for k in set(ea) ^ set(eb) if abs(ea.get(k, eb.get(k)) - thr) > 1e-5]
    if flips:
        raise AssertionError(f"parity: {len(flips)} edges differ beyond the 1e-5 band")
    common = set(ea) & set(eb)
    dmi = max(abs(ea[k] - eb[k]) for k in common)
    dcol = float(np.max(np.abs(a.colmax - b.colmax)))
    if dmi > 1e-5 or dcol > 1e-5:
        raise AssertionError(f"parity: max|dmi| {dmi}, max|dcolmax| {dcol} > 1e-5")
    print(f"# parity S={S} L={L} fixed14 thr={thr:.6f}: {len(ea)} cpu / {len(eb)} gpu "
          f"edges, {len(set(ea) ^ set(eb))} near-threshold flips, max|dmi|={dmi:.3e}, "
          f"max|dcolmax|={dcol:.3e}; sweep cpu {t1 - t0:.2f} s, gpu {t2 - t1:.2f} s",
          flush=True)


def phase_main(dev, td, fasta, wfile, S=S_BENCH, L=L_BENCH):
    from spydrpick_torch import cli
    from spydrpick_torch.ops.compact import route_rows
    from spydrpick_torch.ops.mi_kernels import mi_tile_single

    out_dir = os.path.join(td, "out")
    torch.cuda.reset_peak_memory_stats(dev)
    mi_tile_single.launches = 0
    route_rows.launches = 0
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = cli.main([fasta, "--sample-weights", wfile, "--seed", "1", "-v",
                       "--output-dir", out_dir])
    wall = time.perf_counter() - t0
    launches = {"mi_tile_single": mi_tile_single.launches, "route_rows": route_rows.launches}
    text = log.getvalue()
    if rc != 0:
        raise AssertionError(f"cli.main returned {rc}:\n{text[-4000:]}")
    mode = re.search(r"int8 mode (\w+)", text).group(1)
    if mode != "fixed14":
        raise AssertionError(f"main path ran int8 mode {mode}, not fixed14")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"main path never launched kernel {name}")
    files = sorted(os.listdir(out_dir))
    couplings = [f for f in files if re.search(r"spydrpick_couplings\.1-based\.\d+edges$", f)]
    outliers = [f for f in files if f.endswith(".outliers")]
    if len(couplings) != 1 or len(outliers) != 1:
        raise AssertionError(f"unexpected outputs {files}")
    for f in couplings + outliers:
        if os.path.getsize(os.path.join(out_dir, f)) == 0:
            raise AssertionError(f"empty output {f}")
    with open(os.path.join(out_dir, couplings[0])) as f:
        first = f.readline().split()
    if len(first) != 5 or not np.isfinite(float(first[4])):
        raise AssertionError(f"malformed couplings row {first}")
    stages = dict(re.findall(r"stage time: (\w+) ([\d.]+)s", text))
    thr = float(re.search(r"MI save threshold = ([\d.]+)", text).group(1))
    n_edges = int(re.search(r"(\d+) edges stored", text).group(1))
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"# main path S={S} L={L} weighted fixed14: rc 0 in {wall:.2f} s; "
          f"threshold {thr:.6f}, {n_edges} edges, top couplings row {' '.join(first)}")
    print("# stage seconds: " + ", ".join(f"{k} {v}" for k, v in stages.items()))
    print(f"# peak device memory {peak / 2**30:.2f} GiB; launches {launches}", flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to PyTorch", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    from spydrpick_torch.stage_profile import bench_alignment, write_inputs

    phase_env()
    k1_err = phase_k1(dev)
    with tempfile.TemporaryDirectory() as td:
        codes, w = bench_alignment(S_BENCH, L_BENCH, seed=0)
        fasta, wfile = write_inputs(td, "bench", codes, w)
        del codes
        k1_main_err, k1_ms, k1_plain_ms = phase_k1_main(dev, fasta, wfile)
        k2_err, k2_ms, k2_plain_ms = phase_k2(dev)
        phase_parity(dev, td)
        launches = phase_main(dev, td, fasta, wfile)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    kernels = [
        {"name": "mi_tile_single", "route": "cuda", "source": "spydrpick_torch/csrc/mi_tile.cu",
         "replaces": "spydrpick_tpu/ops/mi_pallas.py:279",
         "launches": launches["mi_tile_single"], "max_abs_err": max(k1_err, k1_main_err),
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "route_rows", "route": "cuda", "source": "spydrpick_torch/csrc/route_rows.cu",
         "replaces": "spydrpick_tpu/ops/compact_route.py:111",
         "launches": launches["route_rows"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
