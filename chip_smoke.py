"""On-card smoke test of the PyTorch/CUDA port (spydrpick_torch).

Run from the repository root on a machine with an NVIDIA GPU:

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):
  1. environment and build: versions, the card's name and power limit,
     the nvcc build of spydrpick_torch/csrc (ptxas registers and spills),
     the g++ build of the native host libraries (spydrpick_torch/native),
     and a SASS check (cuobjdump) that K1's, B3's and B4's kernels run on
     the tensor cores: IMMA (int8) or HMMA (bf16) on the mma.sync loop,
     IGMMA (the int8 warpgroup MMA) on K1's wgmma loop, and no IDP.4A;
  2. kernel K1 (MI tile) against its plain PyTorch version, max |dmi| <=
     1e-5 (0 in the int8 modes), with both times and K1's bound and
     roofline share; in the int8 modes on both of its main loops (the
     wgmma loop, the default, and the mma.sync loop), each timed, equal bit
     for bit:
     a. on random slab operands at S=3072, TI=512 and TJ in {512, 30720},
        in the fixed14, unit-int8 and bf16 modes, copied K-major as K1
        reads them;
     b. at the main path's shapes: the engine's own K1 arguments
        (``MIEngine.row_args``: K-major views) for the S=3000 x L=30720
        bench alignment, at the first block-row and one in the middle
        (TJ = Lp - i0, a sample tail), in the fixed14, unit-int8 and bf16
        modes;
     c. kernel B3 (dual MI tile, K1's tensor-core loop with a second
        epilogue) against its plain version on operands made as in 2a and
        on the engine's own dual block-row arguments
        (``MIEngine.row_dual_args``, K-major views) as in 2b: max |dmi| and
        max |dwog| <= 1e-5 (0 in the int8 modes), its mi equal to K1's on
        the same operands bit for bit in every mode, and in the int8 modes
        its (mi, wog) equal to B4 -> ``xtab_to_f32`` -> B5's; B3, plain and
        K1 times, B3's bound and roofline share;
     d. kernels B4 (crosstable tile) and B5 (entropy epilogue) on the same
        operands as 2a and 2b: B4's int32 crosstable equal to its plain
        version (bf16: within 1e-5 of the largest cell), B5's mi and wog
        within 1e-5 of its plain version on B4's crosstable, and B4 ->
        ``xtab_to_f32`` -> B5 equal to K1's mi and B3's (mi, wog) bit for
        bit in the int8 modes; B4, B5 and plain times beside K1's, their
        bounds and roofline shares, and B4's yardstick (``b4_library``:
        one PyTorch product per pass, which the port never calls);
  3. kernel B2 (row_select: threshold, colmax and append to the device
     edge store in one pass) against its plain version: on random
     (512, 30720) block-rows at densities 0, 1%, 30% and 100%, lazy and
     with wog, an LD gate and a circular genome, and on the engine's own
     block-rows at i0 = 0 and 15360 of the bench alignment (lazy: K1's
     buffer; wog: B3's) at the tournament's threshold; the count, the
     edges sorted by (i, j) and colmax's bits exactly equal, with both
     times, B2's bound and share; a 1000-slot store (the count still
     counts every edge, the slots written are plain's edges), a lazy
     sweep from a 2^18-slot store that must grow (arrays equal to the
     default store's sweep, rows swept again), and j-window buffers
     (``WINDOW_CASES``: a window right of the diagonal, one straddling it
     with wog, one at a non-zero j0 with an LD gate), each held to the
     plain version as above;
  4. slice parity: the engine's sweep of a weighted S=256 x L=2048
     alignment on the card against the same engine on the CPU;
  5. the main path at the size users run it: ``spydrpick_torch.cli.main``
     on the weighted S=3000 x L=30720 alignment (the bench.py "medium"
     generator) with the automatic threshold; K1 and B2 must each have
     been launched once per block-row (60), the ARACNE kernel once, the
     couplings formatter, the column counts and the pairs' crosstables at
     least once (its -v log's preprocess and tournament phases printed),
     and its files must be
     byte-identical to the ones pinned in ``MAIN_OUTPUTS`` (sha256);
  6. the library's exact-wog sweep at that size:
     ``MIEngine(al, EngineConfig(wog_fetch="full")).sweep(thr)`` at phase
     5's threshold launches B3 and B2 once per block-row (60) and K1
     never; its edges, mi and colmax equal the lazy sweep's bit for bit,
     the lazy sweep's outlier candidates (wog from the pairs path) agree
     within 1e-5, and edges whose columns have no gaps carry wog == mi;
     both sweeps' times and peak device memory;
     b. the pipeline's edge sort on the card (``EdgeSet.sorted_on``)
        against numpy's ``EdgeSet.sort_desc``: the same permutation on the
        lazy sweep's edges (phase 5's), on them shuffled with MI quantised
        to steps of 0.005, and on 2^23 + 30,000 edges over 2^20 columns
        where numpy lexsorts its tied spans; both times each;
     c. the kernels for host stages on phase 5's sorted edges, kept on
        the card (``EdgeSet.sorted_on``): the ARACNE DPI scan
        (``aracne_flags``) equal to its plain version and the native
        owner-scan flag for flag; the couplings formatter
        (``format_couplings_rows``) equal to the native formatter (sha256)
        and its plain version, and on adversarial MI values (the
        binary-exact ties, halfway points and their one-ulp neighbours,
        5e-7 +- 1 ulp, subnormals) equal to Python's f"{x:.6f}"; the
        times of each kernel, its plain version and its native copy, with
        bounds and shares; the plain versions on the host's CPU, equal to
        the native copies, timed beside them (the CPU pipeline runs the
        native copies);
     d. the lead-in's kernels: ``column_state_counts`` on phase 5's codes
        as the pipeline keeps them on the card, equal to its plain version
        and to the host numpy counts it replaced (timed beside it), and
        ``pairs_xtab`` on the tournament's 1,000,000 pairs, in one launch
        and in the pipeline's chunks, bit-equal to its plain version; each
        kernel's time, bound and share, and its launches in phase 5;
  7. checkpoint and resume at that size: a checkpointed sweep of the
     engine ``run_pipeline`` builds is killed from its progress callback
     after block-row 24; ``cli.main`` with phase 5's flags plus
     ``--checkpoint`` resumes it, launching K1 and B2 once per row not in
     the snapshot, deletes the file and writes outputs byte-identical to
     phase 5's; an uninterrupted ``--checkpoint`` run shows the cost of
     the saves: its sweep_s and checkpoint_s beside phase 5's sweep_s;
  8. the row-sharded CLI: two processes on the one card, joined by the
     multi-host flags (gloo, since they share it), run phase 5's flags
     with ``--sharded``; rank 0's outputs are byte-identical to phase 5's
     and the ranks' K1 and B2 launches each sum to one per block-row
     (60), with no B4 or B5;
  9. the sample-sharded CLI: ``--sharded --sample-shards 2``, two ranks of
     1500 samples each, on the weighted S=3000 x L=16384 bench alignment
     (a cut: every block-row's crosstable crosses the host through gloo),
     once with ``--mi-threshold`` set to the single-process tournament's
     threshold and once with the sharded tournament; both byte-identical
     to the single-process run, and each rank launches B4 and B5 once per
     8192-column chunk of each block-row (48 for 32 block-rows), B2 once
     per block-row, and K1 and B3 never;
 10. the wide path at a cut: S=256 x L=262,144 of the same generator
     (past the 2^17 columns where the reference turns j-windows on),
     weighted fixed14, lazy wog, swept by the library at 0.084647 in three
     ways, in turns (dense full width, dense j-windows of 65536, codes
     storage in j-windows of 65536, then backwards): identical EdgeSets,
     K1 and B2 once per item, B3 never, each sweep's seconds, items,
     expansion seconds and peak memory; then ``cli.main`` with
     ``--mi-values 1000000`` as it is ("auto", which must resolve to dense
     full-width rows) and with ``--onehot-storage codes --row-window
     65536``: byte-identical files;
 11. the full width shape: scripts/bench_1m_width.py's S=256 x L=998,400
     alignment in codes storage with ``row_window=65536`` (62,464 after
     the reference's rounding), swept at 0.084647 - 4e-5 twice: from the
     default store, which grows and re-sweeps rows, and from a 2^27-slot
     store that never grows, with identical EdgeSets; 32 whole block-rows
     (0, 512, every row swept again, 6 drawn from a seeded generator)
     recounted in float64 from the one-hot's products (``check_recount``):
     every pair above 0.084627 stored, within 1e-5; the count above
     0.084647 beside the float64 count of the edges near it; the
     reference's (the TPU run's) 34 printed group counts
     (scripts/results_r5/bench_1m_width_final.json) each inside the
     +-1e-5 band of this sweep's count at the MI where this sweep reaches
     the reference's whole count 87,227,673, that MI's distance below
     0.084647 printed; the sweep's seconds, column pairs/s, expansion
     seconds, items, rows swept again and peak memory (fetch_s among its
     phases); then the pipeline's device sort of its edges, its time and
     peak memory with the engine held; the ARACNE kernel and the
     couplings writer on the sorted ~87M edges (times, peak memory, the
     longest row), both held to the native copies on the first 2^24
     sorted edges (the flags of that prefix run as a graph of its own,
     the bytes' sha256 of the file's first chunk); the sort checked on the card
     (``check_desc_order``: the sweep's edges, mi and wog once each, in
     descending mi with ties by (ipos, jpos));
 12. the checkpointed row-sharded CLI (run after phase 9, since it needs
     phase 5's files): phase 5's flags with ``--sharded --checkpoint F
     --checkpoint-every 8`` as two ranks, process 0 ended right after its
     second save (16 block-rows in F); a two-rank resume launches K1 and
     B2 once per row not in F, summed over the ranks, writes phase 5's
     bytes and removes F; a copy of F resumed by one process does the
     same; the kill point, rows and edges saved, each resumed run's
     sweep_s and checkpoint_s, the launches and the wall times;
 13. the bench (run after phase 11): ``python -m spydrpick_torch.bench`` in
     a process of its own at its default shape (phase 5's alignment and
     engine) with BENCH_E2E_RUNS=5 warm end-to-end runs; its JSON line must
     name the card and power limit of phase 1 and the cuda backend, its
     end-to-end edges and threshold must be phase 5's, every warm run must
     launch K1 and B2 once per block-row (60), the ARACNE and formatter
     kernels once each, and B3, B4 and B5 never, and
     its sweep minimum must lie within 2x of phase 5's sweep_s; its
     headline figures, its stage medians and the device's busy share of
     its traced warm run (in (0, 1]) are printed.
Ranks of phases 8, 9 and 12 are this script run as ``chip_smoke.py --rank
ARGS``: ``cli.main(ARGS)``, then the launch counts as a JSON line; each
has a time limit, and a rank that fails fails the phase.  Phase 12's
killed run starts them as ``chip_smoke.py --rank-killed K ARGS``.
The line before the last is a JSON object with each kernel's route,
source, launches in its main-path phase (5 for K1, B2, the ARACNE and
formatter kernels and the lead-in's two, 6 for B3, 9 for B4 and B5,
summed over the ranks), max error over phases 2-3, 6, 2d, 6c and 6d (0
for the exact comparisons), times at the main path's shape (the fixed14
block-row at i0=0; for B2 the lazy block-row at i0=0 and the tournament's
threshold; for the ARACNE and formatter kernels phase 5's ~3.1M sorted
edges; for the column counts phase 5's codes, for the pairs' crosstables
the tournament's 1,000,000 pairs in one launch), the bound
computed from those inputs and what sets it, and the
library call's time where one PyTorch call computes the same function
(B4), else null; the last line is ``{"ok": true, "device": {...}}``.
Without a GPU it exits with an error before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
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
# the card's published dense peaks (NVIDIA H100 SXM data sheet, 700 W) for
# the roofline bounds: tensor-core int8 and bf16, f32 and f64 outside the
# tensor cores, HBM3 bytes
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12, "f64": 34e12}
HBM_BYTES_S = 3.35e12
EPILOGUE_OPS = 320  # f32 operations of one pair's mi_epilogue (csrc/mi_epilogue.cuh), ~
S_BENCH, L_BENCH = 3000, 30720
L_SAMPLE_SHARDED = 16384  # phase 9: the crosstables cross the host through gloo
RANK_TIMEOUT = 600  # seconds for the ranks of one sharded CLI run
KILLED_RC = 17  # the exit code of a rank ended on purpose after a checkpoint save
TILE = 512  # the engine's default block-row width
# phase 3's j-window block-rows: (label, i0, j0, W, with wog, LD threshold)
WINDOW_CASES = (("right of the diagonal", 0, 8192, 8192, False, 0),
                ("straddling the diagonal", 6144, 4096, 8192, True, 0),
                ("at a non-zero j0, LD-gated", 15872, 16384, 4096, False, 500))
# phases 10 and 11: scripts/bench_1m_width.py's alignment (the bench.py
# generator at S=256), its threshold as its JSON gives it (6 decimals) and
# its edge count there (scripts/results_r5/bench_1m_width_final.json)
S_WIDE, L_CUT, L_WIDE = 256, 262144, 998400
WIDE_THRESHOLD, WIDE_EDGES, WIDE_BAND = 0.084647, 87_227_673, 1e-5
WIDE_MARGIN = 4e-5  # phase 11 sweeps this far below WIDE_THRESHOLD
WIDE_WINDOW = 65536  # resolves to 62464 at L_WIDE, as in the reference
WIDE_MI_VALUES = 1_000_000  # phase 10's CLI runs: the tournament's target edge count
WIDE_STORE = 1 << 27  # phase 11's second sweep: a store that never grows at L_WIDE
RECOUNT_ROWS = 6  # phase 11: block-rows recounted in float64 besides the first two and reruns
REFERENCE_LOG = "scripts/results_r5/bench_1m_width_final.json"  # the reference's 1M run
# phase 5's files (sha256), as the CLI wrote them on an H100 once the
# pairs paths summed their crosstables exactly (pairs_xtab) and took their
# MI in float64: the tournament's threshold moved from 0.0066821575 to
# 0.0066821375, 2e-10 from the float64 tournament's, which kept 405 more
# edges at MI 0.006682, and 50 outliers rows' wog moved by 1e-6 (python -m
# spydrpick_torch.host_ab lists them; PERF.md); the moves of the
# sort, the fetch, ARACNE and the writer onto the card changed no byte
MAIN_OUTPUTS = {
    "bench.3000x30720.spydrpick_couplings.1-based.3101324edges":
        "481c49439a33bd34423ac602acf8824519a155a5315971a9059716acc7816a58",
    "bench.3000x30720.spydrpick_couplings.1-based.outliers":
        "5fca76a6bccaba990a61feb3ec13e4669f12aeaa9bb49b194aa303571da6a5a1",
    "bench.outlier_nodes.fasta":
        "e560354968724f0cabe8466a3e84f7e67725b663f184e34499fd9e9921043a5e",
}
BENCH_E2E_RUNS = 5  # phase 13: warm end-to-end runs of the bench (PERF.md's median rule)
BENCH_TIMEOUT = 300  # seconds for phase 13's bench process
BENCH_STAGES = ("preprocess_s", "engine_build_s", "threshold_s", "sweep_s", "sort_s", "aracne_s",
                "write_s")


def main_flags(fasta, wfile):
    """Phase 5's ``cli.main`` flags (phases 6 and 7 rebuild its engine)."""
    return [fasta, "--sample-weights", wfile, "--seed", "1", "-v"]


LEAD_CYCLES = 40_000_000  # a spin of ~20 ms on the card ahead of a timed window


def cuda_time_ms(fn, n: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``n`` calls after one
    warm-up call, by CUDA events.  A spin kernel ahead of the window lets
    the host queue the calls before the card reaches them, so a kernel
    shorter than its host-side launch is timed on the card, not the host."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(LEAD_CYCLES)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def bound(ops, kind, nbytes):
    """(ms, "operations" or "bytes"): the least time the card could take
    for ``ops`` operations at the ``kind`` peak that move ``nbytes``."""
    t_ops, t_bytes = ops / PEAK_OPS[kind], nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def xtab_bound(xi_hi, xi_lo, xj, out_bytes, presence_vectors=0):
    """The bound of K1, B3 and B4 on these operands: 2 * S * (TI*5) *
    (TJ*5) multiply-adds per pass on the tensor cores; each operand read
    once, the presence vectors (f32 slab vectors of both sides) and the
    output written once."""
    S, TI5 = xi_hi.shape
    TJ5 = xj.shape[1]
    passes = 1 if xi_lo is None else 2
    esz = xj.element_size()
    nbytes = S * (TI5 * passes + TJ5) * esz + presence_vectors * (TI5 + TJ5) * 4 + out_bytes
    return bound(2.0 * S * TI5 * TJ5 * passes, "int8" if xj.dtype == torch.int8 else "bf16",
                 nbytes)


def epilogue_bound(TI, TJ, dual):
    """B5's bound: its f32 crosstable read and its mi (and wog) written
    once, EPILOGUE_OPS f32 operations per pair and epilogue."""
    n = 2 if dual else 1
    return bound(EPILOGUE_OPS * TI * TJ * n, "f32",
                 TI * TJ * 25 * 4 + n * (2 * (TI + TJ) * 5 * 4 + TI * TJ * 4))


def share(ms, bound_ms):
    return f"bound {bound_ms:.3f} ms, roofline share {100 * bound_ms / ms:.1f}%"


def build_native():
    """The native host libraries (FASTA parser, ARACNE owner-scan,
    couplings formatter), built from spydrpick_torch/native into build/."""
    from spydrpick_torch import native

    t0 = time.perf_counter()
    libs = [native.build_library(name) for name in ("fasta", "aracne", "format")]
    print(f"# native host libraries built in {time.perf_counter() - t0:.2f} s: "
          + ", ".join(str(p.relative_to(native.BUILD_DIR.parents[1])) for p in libs))


TC_KERNELS = ("mi_tile_mma_kernel", "mi_tile_dual_mma_kernel", "crosstab_mma_kernel")  # K1 B3 B4


def check_sass(lib):
    """K1's, B3's and B4's kernels must run on the tensor cores: their SASS
    (cuobjdump) holds IMMA (int8 instance) or HMMA (bf16) on the mma.sync
    loop, IGMMA on K1's wgmma loop (the instance named with ``Wgmma``), and
    no IDP.4A."""
    from spydrpick_torch.ops import cuda_build

    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    found = {}
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        name = block.split(None, 1)[0]
        kernel = next((k for k in TC_KERNELS if k in name), None)
        if kernel is None:
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", block)
        mma = sorted({o.split(".")[0] for o in ops
                      if o.startswith(("IMMA", "HMMA", "HGMMA", "IGMMA"))})
        dp4a = sum(o.startswith("IDP") for o in ops)
        bf16, wgmma = "bfloat16" in name, "Wgmma" in name
        label = "bf16" if bf16 else "int8, wgmma" if wgmma else "int8"
        print(f"#   SASS {kernel}<{label}>: {len(ops)} instructions, "
              f"tensor-core {mma} x{sum(o.startswith(tuple(mma)) for o in ops) if mma else 0}, "
              f"IDP.4A x{dp4a}")
        want = "HMMA" if bf16 else "IGMMA" if wgmma else "IMMA"
        if want not in mma or dp4a:
            raise AssertionError(f"{kernel} ({label}): SASS has tensor-core ops {mma} and "
                                 f"{dp4a} IDP.4A, not {want}")
        found[(kernel, bf16, wgmma)] = True
    if len(found) != 2 * len(TC_KERNELS) + 1 or ("mi_tile_mma_kernel", False, True) not in found:
        raise AssertionError(f"SASS check found {sorted(found)}, expected both instances of "
                             f"{TC_KERNELS} and K1's wgmma instance")


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
    lib, report = cuda_build.build()
    cuda_build.load()
    print(f"# kernels built in {time.perf_counter() - t0:.2f} s")
    build_native()
    kernel = "?"
    for line in report.splitlines():
        # a mangled template instance: ...mi_epilogue_kernelILb1EE... is
        # <1>, ...mi_tile_mma_kernelIaE... <int8>, ...I13__nv_bfloat16E... <bf16>
        m = re.search(r"entry function '\w*?((?:mi_tile|mi_tile_dual|crosstab)_mma_kernel"
                      r"|row_select_kernel|mi_epilogue_kernel|aracne_scan_kernel"
                      r"|format_lengths_kernel|format_rows_kernel)(?:I(\w+?)E+v|E)", line)
        if m:
            targs = m.group(2) or ""
            args = re.findall(r"L[ib](\d+)E", targs + "E") or (
                ["bf16" if "bfloat16" in targs else "int8, wgmma" if "Wgmma" in targs
                 else "int8"] if targs else [])
            kernel = m.group(1) + (f"<{', '.join(args)}>" if args else "")
        elif "registers" in line or "spill" in line:
            print(f"#   ptxas {kernel}: {line.split('info    :')[-1].strip()}")
    check_sass(lib)
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


def kmajor_args(args):
    """``args`` with its three operands as the K-major views K1 and B4 read
    (``ops/mi_kernels.py:k_major``, as the engine's ``row_args`` gives
    them), copied here, outside any timed window."""
    from spydrpick_torch.ops.mi_kernels import k_major

    view = lambda x: None if x is None else k_major(x)[:, :x.shape[0]].T
    return tuple(map(view, args[:3])) + tuple(args[3:])


def k1_compare(label, args, n, n_plain):
    """K1 against its plain version on the same arguments, on each main loop
    that takes them (int8: the wgmma loop, the default, then the mma.sync
    loop, whose MI must equal the default's bit for bit): max |dmi| (raises
    past K1_TOL), {loop: mean ms} with the default loop first, the plain
    version's mean ms and K1's bound (ms, what sets it)."""
    from spydrpick_torch.ops.mi_kernels import k1_loop, mi_tile_single, mi_tile_single_plain

    loops = [k1_loop(args[0].dtype, args[0].shape[0])]
    if loops[0] == "wgmma":
        loops.append("mma_sync")
    want = mi_tile_single_plain(*args)
    first, err = None, 0.0
    for loop in loops:
        got = mi_tile_single(*args, loop=loop)
        torch.cuda.synchronize()
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"K1 {label} ({loop}): shape {tuple(got.shape)} or "
                                 "non-finite output")
        err = max(err, float((got - want).abs().max()))
        if err > K1_TOL:
            raise AssertionError(f"K1 {label} ({loop}): max|dmi| {err} > {K1_TOL}")
        if first is None:
            first = got
        elif not torch.equal(got, first):
            raise AssertionError(f"K1 {label}: the {loop} loop's MI differs from the "
                                 f"{loops[0]} loop's")
    del first, got, want
    ms = {loop: cuda_time_ms(lambda: mi_tile_single(*args, loop=loop), n) for loop in loops}
    plain_ms = cuda_time_ms(lambda: mi_tile_single_plain(*args), n_plain)
    TI, TJ = args[0].shape[1] // 5, args[2].shape[1] // 5
    return err, ms, plain_ms, xtab_bound(args[0], args[1], args[2], TI * TJ * 4, 1)


def k1_times(ms, bound_ms):
    """Each loop's time beside K1's bound and roofline share."""
    return "; ".join(f"{loop} {t:.3f} ms, {share(t, bound_ms)}" for loop, t in ms.items())


def phase_k1(dev, S=3072, TI=512, widths=(512, 30720)):
    from spydrpick_torch.ops.mi_kernels import BW

    rng = np.random.default_rng(1)
    worst = 0.0
    for TJ in widths:
        for mode in ("fixed14", "unit", "bf16"):
            xi_hi, xi_lo, xj, ipf, jpf, mults, scale = k1_operands(S, TI, TJ, mode, rng, dev)
            args = kmajor_args((xi_hi, xi_lo, xj, ipf, jpf, 0.5, BW, mults, scale))
            n = 20 if TJ == widths[0] else 5
            err, ms, plain_ms, (bound_ms, _) = k1_compare(f"{mode} S={S} TJ={TJ}", args, n,
                                                          2 if n == 5 else n)
            worst = max(worst, err)
            passes = len(mults)
            best = min(ms.values())
            tops = 2.0 * S * (TI * 5) * (TJ * 5) * passes / (best * 1e-3) / 1e12
            unit = "int8 TOP/s" if xi_hi.dtype == torch.int8 else "bf16 TFLOP/s"
            print(f"# K1 {mode:8s} S={S} TI={TI} TJ={TJ:5d}: max|dmi|={err:.3e} "
                  f"plain {plain_ms:.3f} ms, {tops:.2f} {unit} "
                  f"({passes} pass{'es' if passes > 1 else ''}); {k1_times(ms, bound_ms)}",
                  flush=True)
            del args, xi_hi, xi_lo, xj
            torch.cuda.empty_cache()
    return worst


def wog_presence(pf):
    """Slab presence with the gap state (4) cleared."""
    from spydrpick_torch.ops.mi_kernels import BW

    pw = pf.reshape(-1, 5, BW).clone()
    pw[:, 4] = 0
    return pw.reshape(-1)


def b3_compare(label, args, n, n_plain):
    """B3 against its plain version on ``args`` (max |dmi| and max |dwog|
    must be <= K1_TOL, and 0 in the int8 modes), its mi against K1's on the
    same operands (bit for bit in every mode: one main loop, conversion and
    epilogue) and, in the int8 modes, its (mi, wog) against B4 ->
    ``xtab_to_f32`` -> B5's (bit for bit); returns both errors, B3's,
    plain's and K1's mean times and B3's bound (ms, what sets it)."""
    from spydrpick_torch.ops.mi_kernels import (crosstab_tile, mi_epilogue, mi_tile_dual,
                                                mi_tile_dual_plain, mi_tile_single, xtab_to_f32)

    xi_hi, xi_lo, xj, ipf, jpf, ipwf, jpwf, pc, bw, mults, scale = args
    int8 = xi_hi.dtype == torch.int8
    k1_args = args[:5] + args[7:]
    mi, wog = mi_tile_dual(*args)
    want_mi, want_wog = mi_tile_dual_plain(*args)
    k1 = mi_tile_single(*k1_args)
    torch.cuda.synchronize()
    if mi.shape != want_mi.shape or not bool(torch.isfinite(mi).all() & torch.isfinite(wog).all()):
        raise AssertionError(f"B3 {label}: shape {tuple(mi.shape)} or non-finite output")
    err_mi = float((mi - want_mi).abs().max())
    err_wog = float((wog - want_wog).abs().max())
    if max(err_mi, err_wog) > (0.0 if int8 else K1_TOL):
        raise AssertionError(f"B3 {label}: max|dmi| {err_mi}, max|dwog| {err_wog} > "
                             f"{0.0 if int8 else K1_TOL}")
    if not torch.equal(mi, k1):
        raise AssertionError(f"B3 {label}: mi differs from K1's by {float((mi - k1).abs().max())}")
    del want_mi, want_wog, k1
    if int8:
        split = mi_epilogue(xtab_to_f32(crosstab_tile(xi_hi, xi_lo, xj, bw, mults), scale),
                            ipf, jpf, ipwf, jpwf, pc, bw)
        if not (torch.equal(mi, split[0]) and torch.equal(wog, split[1])):
            raise AssertionError(f"B3 {label}: (mi, wog) differs from B4 -> B5's")
        del split
    del mi, wog
    torch.cuda.empty_cache()
    ms = cuda_time_ms(lambda: mi_tile_dual(*args), n)
    plain_ms = cuda_time_ms(lambda: mi_tile_dual_plain(*args), n_plain)
    k1_ms = cuda_time_ms(lambda: mi_tile_single(*k1_args), n)
    TI, TJ = xi_hi.shape[1] // 5, xj.shape[1] // 5
    return err_mi, err_wog, ms, plain_ms, k1_ms, xtab_bound(xi_hi, xi_lo, xj, 2 * TI * TJ * 4, 2)


def print_b3(label, int8, err_mi, err_wog, ms, plain_ms, k1_ms, b3_bound):
    print(f"# B3 {label}: max|dmi|={err_mi:.3e} max|dwog|={err_wog:.3e}, mi == K1's"
          f"{', (mi, wog) == B4->B5' if int8 else ''}; kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, K1 {k1_ms:.3f} ms; {share(ms, b3_bound[0])}", flush=True)


def phase_b3(dev, S=3072, TI=512, widths=(512, 30720)):
    from spydrpick_torch.ops.mi_kernels import BW

    rng = np.random.default_rng(6)
    worst = 0.0
    for TJ in widths:
        for mode in ("fixed14", "unit", "bf16"):
            xi_hi, xi_lo, xj, ipf, jpf, mults, scale = k1_operands(S, TI, TJ, mode, rng, dev)
            args = kmajor_args((xi_hi, xi_lo, xj, ipf, jpf, wog_presence(ipf),
                                wog_presence(jpf), 0.5, BW, mults, scale))
            n = 20 if TJ == widths[0] else 5
            res = b3_compare(f"{mode} S={S} TJ={TJ}", args, n, 2 if n == 5 else n)
            worst = max(worst, res[0], res[1])
            print_b3(f"{mode:8s} S={S} TI={TI} TJ={TJ:5d}", mode != "bf16", *res)
            del args, xi_hi, xi_lo, xj
            torch.cuda.empty_cache()
    return worst


def b4_library(xi_hi, xi_lo, xj, mults):
    """B4's yardstick, which the port never calls: one PyTorch call per
    pass that computes the same crosstable.  int8 operands:
    ``torch._int_mm`` (cuBLASLt's int8 product, Xi^T row-major against Xj
    column-major), the int32 passes combined as B4 does; bf16: ``torch.mm``
    of the exact f32 upcasts with TF32 off.  The layout copies and upcasts
    are made here, outside the timed function it returns."""
    xs = [x for x in (xi_hi, xi_lo) if x is not None]
    m = [int(v) for v in mults[:len(xs)]] if xi_hi.dtype == torch.int8 else list(mults)
    if xi_hi.dtype == torch.int8:
        A = [x.T.contiguous() for x in xs]
        B = xj.T.contiguous().T

        def fn():
            C = torch._int_mm(A[0], B)
            if m[0] != 1:
                C.mul_(m[0])
            if len(A) == 2:
                C.add_(torch._int_mm(A[1], B), alpha=m[1])
            return C
        return fn
    A = [x.T.float().contiguous() for x in xs]
    B = xj.float().contiguous()

    def fn():
        C = torch.mm(A[0], B)
        if m[0] != 1:
            C.mul_(m[0])
        if len(A) == 2:
            C.add_(torch.mm(A[1], B), alpha=m[1])
        return C
    return fn


def split_compare(label, args, n, n_plain):
    """B4 and B5 against their plain versions on ``args`` (B3's arguments,
    operands K-major as K1, B3 and B4 read them), and B4 -> xtab_to_f32 ->
    B5 against K1 and B3 (bit for bit in the int8 modes); B4's yardstick
    (``b4_library``) must give its table too.  Returns (B4 error, B5
    error, times in ms: B4, plain B4, B5, plain B5, dual B5, K1, library
    or None, bounds: B4's and B5's (ms, what sets it))."""
    from spydrpick_torch.ops.mi_kernels import (crosstab_tile, crosstab_tile_plain,
                                                mi_epilogue, mi_epilogue_plain, mi_tile_dual,
                                                mi_tile_single, xtab_to_f32)

    xi_hi, xi_lo, xj, ipf, jpf, ipwf, jpwf, pc, bw, mults, scale = args
    int8 = xi_hi.dtype == torch.int8
    TI, TJ = xi_hi.shape[1] // 5, xj.shape[1] // 5
    C = crosstab_tile(xi_hi, xi_lo, xj, bw, mults)
    want = crosstab_tile_plain(xi_hi, xi_lo, xj, mults)
    torch.cuda.synchronize()
    if C.dtype != want.dtype or C.shape != want.shape:
        raise AssertionError(f"B4 {label}: {C.dtype} {tuple(C.shape)} vs plain {want.dtype}")
    err_b4 = float((C.to(torch.float64) - want.to(torch.float64)).abs().max())
    if int8 and not torch.equal(C, want):
        raise AssertionError(f"B4 {label}: int32 crosstable differs by {err_b4}")
    if not int8 and err_b4 > 1e-5 * float(want.abs().max()):
        raise AssertionError(f"B4 {label}: max|dC| {err_b4} > 1e-5 of the largest cell")
    del want
    Cf = xtab_to_f32(C, scale)
    mi1 = mi_epilogue(Cf, ipf, jpf, pseudocount=pc, bw=bw)
    mi, wog = mi_epilogue(Cf, ipf, jpf, ipwf, jpwf, pc, bw)
    pmi, pwog = mi_epilogue_plain(Cf, ipf, jpf, ipwf, jpwf, pc, bw)
    torch.cuda.synchronize()
    if not (bool(torch.isfinite(mi).all()) and bool(torch.isfinite(wog).all())):
        raise AssertionError(f"B5 {label}: non-finite output")
    err_b5 = max(float((mi - pmi).abs().max()), float((wog - pwog).abs().max()))
    if err_b5 > K1_TOL or not torch.equal(mi1, mi):
        raise AssertionError(f"B5 {label}: max|d| {err_b5} > {K1_TOL}, or single != dual mi")
    del pmi, pwog
    k1_args = args[:5] + args[7:]
    if int8:
        k1 = mi_tile_single(*k1_args)
        b3 = mi_tile_dual(*args)
        if not (torch.equal(mi, k1) and torch.equal(mi, b3[0]) and torch.equal(wog, b3[1])):
            raise AssertionError(f"B4 -> B5 {label}: differs from K1/B3")
        del k1, b3
    del mi1, mi, wog
    lib_ms = None
    try:
        library = b4_library(xi_hi, xi_lo, xj, mults)
        lib_C = library()
        torch.cuda.synchronize()
    except RuntimeError as e:  # a yardstick only: B4 is held to its plain version above
        print(f"# 2d {label}: B4's library call refused these operands: {e}", flush=True)
    else:
        d = float((lib_C.to(torch.float64) - C.to(torch.float64)).abs().max())
        if (not torch.equal(lib_C, C)) if int8 else d > 1e-5 * float(C.abs().max()):
            raise AssertionError(f"B4 {label}: its library call's table differs by {d}")
        del lib_C
        lib_ms = cuda_time_ms(library, n)
        del library
    del C
    torch.cuda.empty_cache()
    times = (cuda_time_ms(lambda: crosstab_tile(xi_hi, xi_lo, xj, bw, mults), n),
             cuda_time_ms(lambda: crosstab_tile_plain(xi_hi, xi_lo, xj, mults), n_plain),
             cuda_time_ms(lambda: mi_epilogue(Cf, ipf, jpf, pseudocount=pc, bw=bw), n),
             cuda_time_ms(lambda: mi_epilogue_plain(Cf, ipf, jpf, pseudocount=pc, bw=bw),
                          n_plain),
             cuda_time_ms(lambda: mi_epilogue(Cf, ipf, jpf, ipwf, jpwf, pc, bw), n),
             cuda_time_ms(lambda: mi_tile_single(*k1_args), n), lib_ms,
             (xtab_bound(xi_hi, xi_lo, xj, TI * TJ * 25 * 4), epilogue_bound(TI, TJ, False)))
    del Cf
    torch.cuda.empty_cache()
    return err_b4, err_b5, times


def print_split(label, int8, err_b4, err_b5, times):
    b4, b4p, b5, b5p, b5d, k1, lib, ((b4_bound, _), (b5_bound, _)) = times
    lib_text = "refused" if lib is None else f"{lib:.3f}"
    print(f"# 2d {label}: B4 {'int32 equal' if int8 else f'max|dC|={err_b4:.3e}'}, "
          f"B5 max|d|={err_b5:.3e}{', B4->B5 == K1/B3' if int8 else ''}; B4 {b4:.3f} ms "
          f"(plain {b4p:.3f}, library {lib_text}; {share(b4, b4_bound)}), B5 {b5:.3f} ms "
          f"(plain {b5p:.3f}, dual {b5d:.3f}; {share(b5, b5_bound)}), "
          f"B4+B5 {b4 + b5:.3f} vs K1 {k1:.3f} ms", flush=True)


def phase_split(dev, S=3072, TI=512, widths=(512, 30720)):
    from spydrpick_torch.ops.mi_kernels import BW

    rng = np.random.default_rng(7)
    err_b4 = err_b5 = 0.0
    for TJ in widths:
        for mode in ("fixed14", "unit", "bf16"):
            xi_hi, xi_lo, xj, ipf, jpf, mults, scale = k1_operands(S, TI, TJ, mode, rng, dev)
            args = (xi_hi, xi_lo, xj, ipf, jpf, wog_presence(ipf), wog_presence(jpf), 0.5, BW,
                    mults, scale)
            n = 20 if TJ == widths[0] else 5
            e4, e5, times = split_compare(f"{mode} S={S} TJ={TJ}", kmajor_args(args), n,
                                          2 if n == 5 else n)
            if xi_hi.dtype != torch.int8:
                e4 = 0.0  # bf16 B4 sums in another order: held to its own bound above
            err_b4, err_b5 = max(err_b4, e4), max(err_b5, e5)
            print_split(f"{mode:8s} S={S} TI={TI} TJ={TJ:5d}", xi_hi.dtype == torch.int8, e4, e5,
                        times)
            del args, xi_hi, xi_lo, xj
            torch.cuda.empty_cache()
    return err_b4, err_b5


def phase_k1_main(dev, fasta, wfile):
    """K1 and B3 on the engine's own block-row arguments for the bench
    alignment: the main path's shapes, strides and sample tail, in its
    three modes."""
    from spydrpick_torch.engine.solver import EngineConfig, MIEngine
    from spydrpick_torch.pipeline import PipelineOptions, load_and_preprocess

    al = load_and_preprocess(PipelineOptions(alignmentfile=fasta, sample_weights=wfile))
    weights = al.weights
    worst, main = 0.0, {}
    b3_worst, b3 = 0.0, {}
    split_err, split_ms = [0.0, 0.0], {}
    for mode, mxu_int8, unit in (("fixed14", "auto", False), ("unit", "auto", True),
                                 ("off", "off", False)):
        al.weights = np.ones_like(weights) if unit else weights
        eng = MIEngine(al, EngineConfig(mxu_int8=mxu_int8), device=dev)
        if eng.statics.int8_mode != mode:
            raise AssertionError(f"engine picked {eng.statics.int8_mode}, not {mode}")
        for i0 in (0, (eng.Lp // 2) // eng.tile * eng.tile):
            args = eng.row_args(i0)
            xi, xj = args[0], args[2]
            err, ms, plain_ms, (bound_ms, bound_by) = k1_compare(
                f"main-path {mode} i0={i0}", args, 5, 2)
            worst = max(worst, err)
            print(f"# K1 main path {mode:7s} S={eng.S} i0={i0:5d} TJ={xj.shape[1] // 5:5d} "
                  f"(xi {xi.dtype} K-major, row stride {xi.stride(1)}, xj row stride "
                  f"{xj.stride(1)}): max|dmi|={err:.3e} plain {plain_ms:.3f} ms; "
                  f"{k1_times(ms, bound_ms)}", flush=True)
            if mode == "fixed14" and i0 == 0:
                main = {"ms": next(iter(ms.values())), "mma_sync_ms": ms["mma_sync"],
                        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": None}
            del xi, xj
            dual = eng.row_dual_args(i0)
            res = b3_compare(f"main-path {mode} i0={i0}", dual, 5, 2)
            b3_worst = max(b3_worst, res[0], res[1])
            print_b3(f"main path {mode:7s} S={eng.S} i0={i0:5d}", mode != "off", *res)
            if mode == "fixed14" and i0 == 0:
                b3 = {"ms": res[2], "plain_ms": res[3], "bound_ms": res[5][0],
                      "bound_by": res[5][1], "library_ms": None}
            e4, e5, times = split_compare(f"main-path {mode} i0={i0}", dual, 5, 2)
            del args, dual
            int8 = mode != "off"
            split_err[0] = max(split_err[0], e4 if int8 else 0.0)
            split_err[1] = max(split_err[1], e5)
            print_split(f"main path {mode:7s} S={eng.S} i0={i0:5d}", int8, e4, e5, times)
            if mode == "fixed14" and i0 == 0:
                (b4_bound, b4_by), (b5_bound, b5_by) = times[7]
                split_ms.update(b4={"ms": times[0], "plain_ms": times[1], "bound_ms": b4_bound,
                                    "bound_by": b4_by, "library_ms": times[6]},
                                b5={"ms": times[2], "plain_ms": times[3], "bound_ms": b5_bound,
                                    "bound_by": b5_by, "library_ms": None})
        del eng
        torch.cuda.empty_cache()
    al.weights = weights
    return worst, main, b3_worst, b3, split_err, split_ms


def select_bound(T, W, n_edges, with_wog):
    """B2's bound: the (T, W) row buffer (and wog) read once, orig_pos (and
    gap) of its rows and columns read once, colmax over its columns read
    and written once, each survivor written once as (i, j, mi[, wog]);
    one compare per element at the f32 peak."""
    nbytes = (T * W * 4 * (2 if with_wog else 1) + (T + W) * (5 if with_wog else 4)
              + 2 * W * 4 + n_edges * (16 if with_wog else 12))
    return bound(T * W, "f32", nbytes)


def select_run(fn, mi, wog, args, colmax, kw, capacity):
    """``fn`` (row_select or its plain version) into a fresh store: its
    count, its edges sorted by (i, j) and the colmax it leaves."""
    from spydrpick_torch.ops.compact import EdgeStore

    store = EdgeStore(capacity, wog is not None, mi.device)
    colmax = colmax.clone()
    fn(mi, wog, *args, colmax, store, **kw)
    n = min(int(store.count), capacity)
    got = [a[:n] for a in store.arrays()]
    order = torch.argsort(got[0].to(torch.int64) * colmax.shape[0] + got[1])
    return int(store.count), [a[order] for a in got], colmax


def select_compare(label, mi, wog, args, colmax, kw, n_time, n_plain):
    """B2 against its plain version on one block-row: the count, the edges
    sorted by (i, j) (ipos, jpos, mi and wog exactly) and colmax's bits
    must be equal.  Returns (max |d|, count, ms, plain ms, bound)."""
    from spydrpick_torch.ops.compact import EdgeStore, row_select, row_select_plain

    n, got, cm = select_run(row_select, mi, wog, args, colmax, kw, 1 << 24)
    want_n, want, want_cm = select_run(row_select_plain, mi, wog, args, colmax, kw, 1 << 24)
    torch.cuda.synchronize()
    if n != want_n or not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"B2 {label}: {n} edges vs plain {want_n}, or they differ")
    if not torch.equal(cm.view(torch.int32), want_cm.view(torch.int32)):
        raise AssertionError(f"B2 {label}: colmax bits differ from the plain version's")
    err = max([float((a.double() - b.double()).abs().max()) for a, b in zip(got, want) if n]
              + [0.0])
    del got, want
    # every timed call appends to one store that holds them all; colmax
    # holds the row's maxima after the first call, so later calls make no
    # colmax atomics (stage_profile times the sweep's own launches)
    times = []
    for fn, reps in ((row_select, n_time), (row_select_plain, n_plain)):
        store = EdgeStore(max(1, (reps + 2) * n), wog is not None, mi.device)
        run_cm = colmax.clone()
        times.append(cuda_time_ms(lambda: fn(mi, wog, *args, run_cm, store, **kw), reps))
        del store
    T, W = mi.shape
    return err, n, times[0], times[1], select_bound(T, W, n, wog is not None)


def print_select(label, n, ms, plain_ms, b2_bound):
    print(f"# B2 {label}: {n} edges, sorted edges and colmax bits equal to plain; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.3f} ms; {share(ms, b2_bound[0])}", flush=True)


def random_select_case(dev, rng, density, with_wog, T=TILE, Lp=L_BENCH, L=L_BENCH - 20, W=None):
    """Block-row i0 = 0 of random MI in [-0.25, 1) at a threshold that keeps
    ``density`` of it, gaps, a circular genome with an LD gate and a
    colmax that already holds values (some -inf).  ``W``: a buffer of W
    columns (a j-window; the caller sets i0 and j0), else the full row."""
    t = lambda x: torch.from_numpy(x).to(dev)
    W = Lp if W is None else W
    mi = t((rng.random((T, W)) * 1.25 - 0.25).astype(np.float32))
    wog = t(rng.random((T, W)).astype(np.float32)) if with_wog else None
    colmax = rng.random(Lp).astype(np.float32) * 0.9
    colmax[rng.random(Lp) < 0.3] = -np.inf
    genome = 2 * Lp
    thr = -np.inf if density == 1.0 else 1.0 - 1.25 * density
    args = (t(rng.random(Lp) < 0.3), t(np.sort(rng.choice(genome, Lp, replace=False))
                                         .astype(np.int32)))
    return mi, wog, args, t(colmax), dict(i0=0, n_loci=L, threshold=thr, ld_threshold=500,
                                          linear_genome=False, genome_size=genome)


def phase_b2(dev, fasta, wfile):
    """B2 (row_select) against its plain version on random block-rows and
    on the engine's own, a store that overflows, and a sweep whose store
    must grow."""
    import dataclasses

    from spydrpick_torch.engine.solver import EngineConfig, MIEngine
    from spydrpick_torch.ops.compact import row_select, row_select_plain

    rng = np.random.default_rng(2)
    worst = 0.0
    for density in (0.0, 0.01, 0.3, 1.0):
        for with_wog in (False, True):
            mi, wog, args, colmax, kw = random_select_case(dev, rng, density, with_wog)
            err, n, ms, plain_ms, b2_bound = select_compare(
                f"random density {density}", mi, wog, args, colmax, kw, 10, 3)
            worst = max(worst, err)
            print_select(f"random {tuple(mi.shape)} density={density:<4} wog={with_wog!s:5} "
                         "LD 500 circular", n, ms, plain_ms, b2_bound)
            del mi, wog, args, colmax
            torch.cuda.empty_cache()
    mi, wog, args, colmax, kw = random_select_case(dev, rng, 0.01, True)
    n, got, _ = select_run(row_select, mi, wog, args, colmax, kw, 1000)
    want_n, want, _ = select_run(row_select_plain, mi, wog, args, colmax, kw, 1 << 24)
    keys = lambda e: set(zip(*(x.tolist() for x in e)))
    if n != want_n or len(got[0]) != 1000 or not keys(got) <= keys(want):
        raise AssertionError(f"B2 overflow: count {n} vs plain {want_n}, or the 1000 slots "
                             "written are not plain's edges")
    print(f"# B2 store of 1000 slots: count {n} = plain's, 1000 slots written, each one of "
          "plain's edges", flush=True)
    del mi, wog, args, colmax, got, want
    for label, i0, j0, W, with_wog, ld in WINDOW_CASES:
        mi, wog, args, colmax, kw = random_select_case(dev, rng, 0.01, with_wog, W=W)
        kw.update(i0=i0, j0=j0, ld_threshold=ld)
        err, n, ms, plain_ms, b2_bound = select_compare(
            f"window {label}", mi, wog, args, colmax, kw, 10, 3)
        worst = max(worst, err)
        print_select(f"window {label}: rows [{i0}, {i0 + TILE}) x columns [{j0}, {j0 + W}) "
                     f"wog={with_wog!s:5} LD {ld}", n, ms, plain_ms, b2_bound)
        del mi, wog, args, colmax
    al, lazy, thr = pipeline_engine(dev, fasta, wfile)
    full = MIEngine(al, EngineConfig(wog_fetch="full"), device=dev)
    main = {}
    for eng, name in ((lazy, "lazy"), (full, "wog")):
        d, st = eng.data, eng.statics
        for i0 in (0, (eng.Lp // 2) // eng.tile * eng.tile):
            mi, wog = eng.row_buffers(i0)
            colmax = torch.full((eng.Lp,), -np.inf, dtype=torch.float32, device=dev)
            kw = dict(i0=i0, n_loci=st.L, threshold=thr, ld_threshold=st.ld_threshold,
                      linear_genome=st.linear_genome, genome_size=st.genome_size)
            err, n, ms, plain_ms, b2_bound = select_compare(
                f"main path {name} i0={i0}", mi, wog, (d.gap, d.orig_pos), colmax, kw, 10, 3)
            worst = max(worst, err)
            print_select(f"main path {name} S={eng.S} i0={i0:5d} ({mi.shape[0]}, {mi.shape[1]})",
                         n, ms, plain_ms, b2_bound)
            if name == "lazy" and i0 == 0:
                main = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b2_bound[0],
                        "bound_by": b2_bound[1], "library_ms": None}
            del mi, wog
    del full
    torch.cuda.empty_cache()
    want = lazy.sweep(thr)
    small = MIEngine(al, dataclasses.replace(lazy.config, store_capacity=1 << 18), device=dev)
    del lazy
    launches = row_select.launches
    tm = {}
    got = small.sweep(thr, timings=tm)
    for f in ("ipos", "jpos", "mi", "mi_wog", "colmax"):
        if not np.array_equal(getattr(got, f), getattr(want, f)):
            raise AssertionError(f"B2 sweep with a 2^18-slot store: {f} differs")
    if not tm["rerun_rows"]:
        raise AssertionError("B2 sweep with a 2^18-slot store swept no row again")
    print(f"# B2 lazy sweep from a 2^18-slot store: {got.n_edges} edges, arrays equal to the "
          f"default store's; {tm['rerun_rows']} block-rows swept again, "
          f"{row_select.launches - launches} row_select launches", flush=True)
    return worst, main


def phase_parity(dev, td, S=256, L=2048):
    from spydrpick_torch.engine.solver import EngineConfig, MIEngine
    from spydrpick_torch.pipeline import PipelineOptions, load_and_preprocess
    from spydrpick_torch.stage_profile import bench_alignment, write_inputs

    codes, w = bench_alignment(S, L, seed=3)
    fasta, wfile = write_inputs(td, "parity", codes, w)
    al = load_and_preprocess(PipelineOptions(alignmentfile=fasta, sample_weights=wfile,
                                             no_filter_alignment=True))
    cpu = MIEngine(al, EngineConfig(wog_fetch="outliers"), device="cpu")
    gpu = MIEngine(al, EngineConfig(wog_fetch="outliers"), device=dev)
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
    from spydrpick_torch.ops.aracne import aracne_flags
    from spydrpick_torch.ops.columns import column_state_counts
    from spydrpick_torch.ops.compact import row_select
    from spydrpick_torch.ops.format import format_couplings_rows
    from spydrpick_torch.ops.mi_kernels import mi_tile_single
    from spydrpick_torch.ops.pairs import pairs_xtab

    out_dir = os.path.join(td, "out")
    torch.cuda.reset_peak_memory_stats(dev)
    fns = (mi_tile_single, row_select, aracne_flags, format_couplings_rows,
           column_state_counts, pairs_xtab)
    for fn in fns:
        fn.launches = 0
    mi_tile_single.launches_wgmma = 0
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = cli.main(main_flags(fasta, wfile) + ["--output-dir", out_dir])
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in fns}
    text = log.getvalue()
    if rc != 0:
        raise AssertionError(f"cli.main returned {rc}:\n{text[-4000:]}")
    mode = re.search(r"int8 mode (\w+)", text).group(1)
    if mode != "fixed14":
        raise AssertionError(f"main path ran int8 mode {mode}, not fixed14")
    n_rows = -(-L // TILE)
    launches["mi_tile_single_wgmma"] = mi_tile_single.launches_wgmma
    for name in ("mi_tile_single", "mi_tile_single_wgmma", "row_select"):
        if launches[name] != n_rows:
            raise AssertionError(f"main path launched kernel {name} {launches[name]} times, "
                                 f"not once per block-row ({n_rows})")
    if launches["aracne_flags"] != 1 or launches["format_couplings_rows"] < 1:
        raise AssertionError(f"main path launches {launches}: ARACNE's kernel must run once "
                             "and the couplings formatter at least once")
    if launches["column_state_counts"] < 1 or launches["pairs_xtab"] < 1:
        raise AssertionError(f"main path launches {launches}: the lead-in's counts and the "
                             "tournament's crosstables must run on their kernels")
    files = sorted(os.listdir(out_dir))
    couplings = [f for f in files if re.search(r"spydrpick_couplings\.1-based\.\d+edges$", f)]
    outliers = [f for f in files if f.endswith(".outliers")]
    if len(couplings) != 1 or len(outliers) != 1:
        raise AssertionError(f"unexpected outputs {files}")
    for f in couplings + outliers:
        if os.path.getsize(os.path.join(out_dir, f)) == 0:
            raise AssertionError(f"empty output {f}")
    digests = {}
    for f in files:
        with open(os.path.join(out_dir, f), "rb") as fh:
            digests[f] = hashlib.sha256(fh.read()).hexdigest()
    if digests != MAIN_OUTPUTS:
        raise AssertionError(f"main path outputs {digests}, expected {MAIN_OUTPUTS}")
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
    print("# " + re.search(r"ARACNE: .*", text).group(0))
    print("# " + re.search(r"preprocess phases: .*", text).group(0))
    print("# " + re.search(r"tournament phases: .*", text).group(0))
    print(f"# peak device memory {peak / 2**30:.2f} GiB; launches {launches}", flush=True)
    print(f"# main path files byte-identical to the ones pinned (sha256): {digests}", flush=True)
    return launches, out_dir, float(stages["sweep"]), thr, n_edges


def pipeline_engine(dev, fasta, wfile):
    """The alignment, engine and save threshold that ``run_pipeline``
    builds from phase 5's flags (the same key for a checkpoint)."""
    from spydrpick_torch.engine.solver import MIEngine
    from spydrpick_torch.engine.threshold import default_mi_values, determine_mi_threshold
    from spydrpick_torch.pipeline import PipelineOptions, engine_config, load_and_preprocess

    opts = PipelineOptions(alignmentfile=fasta, sample_weights=wfile, seed=1)
    al = load_and_preprocess(opts)
    engine = MIEngine(al, engine_config(opts), device=dev)
    thr = determine_mi_threshold(engine, default_mi_values(al.n_loci, opts.mi_values),
                                 threshold_pairs=opts.mi_threshold_pairs,
                                 iterations=opts.mi_threshold_iterations, seed=opts.seed)
    return al, engine, thr


def timed_sweep(engine, thr):
    """(edges, seconds, peak device memory in GiB) of ``engine.sweep(thr)``;
    the peak counts what is allocated when the sweep starts (the engine's
    tensors) and what the sweep adds."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    edges = engine.sweep(thr)
    torch.cuda.synchronize()
    return edges, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30


def phase_dual_sweep(dev, fasta, wfile, L=L_BENCH):
    """The library's exact-wog sweep (B3) against the pipeline's lazy one."""
    from spydrpick_torch.engine.outliers import outlier_thresholds
    from spydrpick_torch.engine.solver import EngineConfig, MIEngine
    from spydrpick_torch.ops.compact import row_select
    from spydrpick_torch.ops.mi_kernels import mi_tile_dual, mi_tile_single

    al, lazy_engine, thr = pipeline_engine(dev, fasta, wfile)
    lazy, lazy_s, lazy_gib = timed_sweep(lazy_engine, thr)
    del lazy_engine
    torch.cuda.empty_cache()
    engine = MIEngine(al, EngineConfig(wog_fetch="full"), device=dev)
    if engine.statics.int8_mode != "fixed14" or engine.statics.wog_lazy:
        raise AssertionError(f"dual sweep engine runs {engine.statics}")
    mi_tile_single.launches = mi_tile_dual.launches = row_select.launches = 0
    full, full_s, full_gib = timed_sweep(engine, thr)
    launches = {"mi_tile_single": mi_tile_single.launches, "mi_tile_dual": mi_tile_dual.launches,
                "row_select": row_select.launches}
    n_rows = -(-L // TILE)
    if (launches["mi_tile_dual"] != n_rows or launches["row_select"] != n_rows
            or launches["mi_tile_single"] != 0):
        raise AssertionError(f"dual sweep launches {launches}, expected {n_rows} B3 and B2 "
                             "and no K1")
    for f in ("ipos", "jpos", "mi", "colmax"):
        if not np.array_equal(getattr(lazy, f), getattr(full, f)):
            raise AssertionError(f"dual sweep: {f} differs from the lazy sweep's")
    cand = full.mi >= outlier_thresholds(full.colmax)[0]
    if not cand.any():
        raise AssertionError("dual sweep: no outlier candidate to compare")
    err = float(np.max(np.abs(lazy.mi_wog[cand] - full.mi_wog[cand])))
    if err > K1_TOL:
        raise AssertionError(f"dual sweep: candidates' max|dwog| {err} > {K1_TOL}")
    gap = al.gap_presence
    no_gap = ~(gap[full.ipos] | gap[full.jpos])
    if not np.array_equal(full.mi_wog[no_gap], full.mi[no_gap]):
        raise AssertionError("dual sweep: an edge without gaps has wog != mi")
    print(f"# dual sweep S={al.n_samples} L={al.n_loci} fixed14 thr={thr:.6f}: {full.n_edges} "
          f"edges, edges/mi/colmax equal to the lazy sweep's; {int(cand.sum())} outlier "
          f"candidates, max|dwog| vs pairs path {err:.3e}; {int(no_gap.sum())} edges without "
          f"gaps (wog == mi); max|wog - mi| {float(np.max(np.abs(full.mi_wog - full.mi))):.4f}; "
          f"sweep lazy {lazy_s:.3f} s, dual {full_s:.3f} s; peak device memory lazy "
          f"{lazy_gib:.3f} GiB, dual {full_gib:.3f} GiB; launches {launches}", flush=True)
    return launches, err, lazy, al


SORT_FIELDS = ("ipos", "jpos", "mi", "mi_wog")


def sorts_agree(label, edges, dev):
    """(numpy seconds, device seconds, tied neighbours): numpy's
    ``EdgeSet.sort_desc`` and the pipeline's device sort
    (``EdgeSet.sorted_on``, timed after one warm-up call) must give the
    same arrays in the same dtypes, on the host and in the columns it keeps
    on the card, i.e. the same permutation (the pairs are unique)."""
    t0 = time.perf_counter()
    want = edges.sort_desc()
    np_s = time.perf_counter() - t0
    edges.sorted_on(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, kept = edges.sorted_on(dev)
    dev_s = time.perf_counter() - t0
    for f in SORT_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"device sort of {label}: {f} differs from numpy sort_desc's")
    for f in SORT_FIELDS[:3]:
        if not np.array_equal(getattr(kept, f).cpu().numpy(), getattr(want, f)):
            raise AssertionError(f"device sort of {label}: the kept {f} column differs")
    del kept
    return np_s, dev_s, int(np.count_nonzero(want.mi[1:] == want.mi[:-1]))


def lexsort_branch_edges(rng):
    """Edges over L = 2^20 columns with more distinct MI values than
    (2^63 - 1) // L^2, and tied spans: numpy's sort_desc lexsorts there."""
    from spydrpick_torch.engine.solver import EdgeSet

    L, E = 1 << 20, (1 << 23) + 30_000
    k = np.arange(E - 1, dtype=np.int64)
    i = np.append(k % (L - 16), 0)
    j = np.append(k % (L - 16) + 1 + k // (L - 16), L - 1)
    perm = rng.permutation(E)
    mi = rng.random(E) + 0.01
    mi[:20_000] = mi[20_000:40_000]
    return EdgeSet(i[perm], j[perm], mi, mi, np.zeros(L))


def phase_sort(dev, edges):
    """Phase 6b: the pipeline's device sort against numpy ``sort_desc``
    on phase 5's edges (phase 6's lazy sweep at phase 5's threshold), on
    them shuffled with MI quantised to steps of 0.005 (ties everywhere)
    and on the 2^20-column set where numpy takes its lexsort branch: the
    same permutation each time, with both times."""
    from spydrpick_torch.engine.solver import EdgeSet

    rng = np.random.default_rng(12)
    perm = rng.permutation(edges.n_edges)
    quant = EdgeSet(edges.ipos[perm], edges.jpos[perm], np.round(edges.mi[perm] * 200) / 200,
                    edges.mi_wog[perm], edges.colmax)
    cases = (("phase 5's edges", edges), ("those shuffled, MI in steps of 0.005", quant),
             ("2^20 columns, numpy's lexsort branch", lexsort_branch_edges(rng)))
    for label, e in cases:
        np_s, dev_s, tied = sorts_agree(label, e, dev)
        print(f"# device sort, {label}: {e.n_edges} edges, {tied} tied neighbours; permutation "
              f"identical to numpy sort_desc's; numpy {np_s:.3f} s, device {dev_s:.3f} s",
              flush=True)


ADVERSARIAL_HALFWAY = 100_000  # phase 6c: random halfway points (n + 1/2) 10^-6 up to ln 5


def adversarial_mi(rng):
    """Phase 6c's MI values for the formatter: every odd multiple of 2^-7
    up to ln 5 (the only binary-exact ties (n + 1/2) 10^-6), one ulp
    either side of ADVERSARIAL_HALFWAY random halfway points and the
    points themselves, 5e-7 +- 1 ulp, subnormals, the smallest normal, and
    random values up to ln 5."""
    ties = np.arange(1, 207, 2) * 2.0**-7
    half = (rng.integers(0, 1_609_438, ADVERSARIAL_HALFWAY) + 0.5) / 1e6
    tiny = np.array([0.0, 5e-7, np.nextafter(5e-7, 0), np.nextafter(5e-7, 1), 5e-324,
                     np.nextafter(5e-324, 1), 1e-310, 2.2250738585072014e-308, 1e-300])
    return np.concatenate([ties, half, np.nextafter(half, 0), np.nextafter(half, 1), tiny,
                           rng.random(ADVERSARIAL_HALFWAY) * np.log(5)])


def aracne_bounds(E, n_nodes):
    """(function bound, scan bound), each (ms, "bytes"): aracne_flags reads
    the edge columns (ipos, jpos int64, mi f64) once and writes one flag
    byte per edge; its scan kernel reads the CSR (offsets, int32
    neighbours, f64 weights of 2E half-edges) besides."""
    cols = E * (8 + 8 + 8) + E
    csr = (n_nodes + 1) * 8 + 2 * E * (4 + 8)
    return bound(0, "f32", cols), bound(0, "f32", cols + csr)


def format_bound(n, n_bytes):
    """format_couplings_rows reads p1, p2, dist, mi (8 bytes each) and the
    flag of each row once and writes the text once; its integer digit
    arithmetic is not counted (the table has no integer-ALU peak)."""
    return bound(0, "f32", n * 33 + n_bytes)


def max_abs_diff(a, b) -> float:
    """max |a - b| over two integer arrays (flags or bytes), widened to
    int64; inf when their lengths differ, 0.0 when both are empty."""
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    if a.shape != b.shape:
        return float("inf")
    if a.size == 0:
        return 0.0
    return float(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


def phase_host_kernels(dev, al, edges):
    """Phase 6c: kernels A (ARACNE's DPI scan) and B (the couplings
    formatter) on phase 5's sorted edges, kept on the card as the
    pipeline keeps them (``EdgeSet.sorted_on``): A's flags equal to its
    plain version's and to the native owner-scan's; B's bytes equal to
    the native formatter's (sha256) and to its plain version's; B on the
    adversarial MI values equal to Python's f"{x:.6f}" rows; times of the
    kernels, the plain versions and the native copies, with bounds."""
    from spydrpick_torch.engine.aracne import DEFAULT_EDGE_THRESHOLD as EPS
    from spydrpick_torch.native import aracne_native, format_native
    from spydrpick_torch.ops.aracne import aracne_flags, aracne_flags_plain
    from spydrpick_torch.ops.format import (couplings_columns, format_couplings_rows,
                                            format_couplings_rows_plain)

    host, d = edges.sorted_on(dev)
    E = host.n_edges
    tm = {}
    flags = aracne_flags(d.ipos, d.jpos, d.mi, EPS, timings=tm)
    plain = aracne_flags_plain(d.ipos, d.jpos, d.mi, EPS)
    t0 = time.perf_counter()
    native = ~aracne_native.mark_indirect(host.ipos, host.jpos, host.mi, EPS)
    native_a_ms = (time.perf_counter() - t0) * 1e3
    got = flags.cpu().numpy()
    a_err = max(max_abs_diff(got, plain.cpu().numpy()), max_abs_diff(got, native))
    if a_err != 0:
        raise AssertionError(f"ARACNE kernel: flags differ from the plain version's or the "
                             f"native owner-scan's (max |d| {a_err})")
    a_ms = cuda_time_ms(lambda: aracne_flags(d.ipos, d.jpos, d.mi, EPS), 5)
    split = [{} for _ in range(3)]
    for t in split:
        aracne_flags(d.ipos, d.jpos, d.mi, EPS, timings=t)
    csr_ms = 1e3 * float(np.median([t["csr_s"] for t in split]))
    scan_ms = 1e3 * float(np.median([t["scan_s"] for t in split]))
    a_plain_ms = cuda_time_ms(lambda: aracne_flags_plain(d.ipos, d.jpos, d.mi, EPS), 1)
    (a_bound, a_by), (scan_bound, _) = aracne_bounds(E, int(host.jpos.max()) + 1)
    print(f"# 6c ARACNE kernel on phase 5's {E} sorted edges ({tm['nodes']} nodes, longest row "
          f"{tm['max_degree']}): {int(got.sum())} direct, flags equal to the plain version's "
          f"and the native owner-scan's; aracne_flags {a_ms:.3f} ms (CSR {csr_ms:.3f}, scan "
          f"{scan_ms:.3f}), {share(a_ms, a_bound)}; scan {share(scan_ms, scan_bound)}; plain "
          f"{a_plain_ms:.3f} ms; native owner-scan {native_a_ms:.3f} ms", flush=True)

    trans = torch.from_numpy(np.ascontiguousarray(al.translation, dtype=np.int64)).to(dev)
    cols = couplings_columns(d.ipos, d.jpos, trans, 1, al.n_original_positions, False)
    rows = format_couplings_rows(*cols, flags, d.mi)
    data = rows.cpu().numpy().tobytes()
    hcols = [c.cpu().numpy() for c in cols]
    t0 = time.perf_counter()
    want = format_native.format_couplings(*hcols, got, host.mi)
    native_b_ms = (time.perf_counter() - t0) * 1e3
    digest = hashlib.sha256(data).hexdigest()
    plain_rows = format_couplings_rows_plain(*cols, flags, d.mi)
    b_err = max(max_abs_diff(rows.cpu().numpy(), np.frombuffer(want, np.uint8)),
                max_abs_diff(rows.cpu().numpy(), plain_rows.cpu().numpy()))
    if b_err != 0 or digest != hashlib.sha256(want).hexdigest():
        raise AssertionError(f"formatter kernel: bytes differ from the native formatter's or "
                             f"the plain version's (max |d| {b_err})")
    b_ms = cuda_time_ms(lambda: format_couplings_rows(*cols, flags, d.mi), 10)
    b_plain_ms = cuda_time_ms(lambda: format_couplings_rows_plain(*cols, flags, d.mi), 1)
    b_bound, b_by = format_bound(E, len(data))
    print(f"# 6c formatter kernel on the same rows: {len(data)} bytes, sha256 {digest} equal "
          f"to the native formatter's and the plain version's; {b_ms:.3f} ms, "
          f"{share(b_ms, b_bound)}; plain {b_plain_ms:.3f} ms; native formatter "
          f"{native_b_ms:.3f} ms", flush=True)
    # the plain versions on the host's CPU, against the native copies: the
    # pipeline runs the faster of the two there
    cpu = [torch.from_numpy(x) for x in (host.ipos, host.jpos, host.mi)]
    t0 = time.perf_counter()
    cpu_flags = aracne_flags_plain(*cpu, EPS).numpy()
    a_cpu_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    cpu_rows = format_couplings_rows_plain(*(torch.from_numpy(c) for c in hcols),
                                           torch.from_numpy(cpu_flags), cpu[2]).numpy()
    b_cpu_ms = (time.perf_counter() - t0) * 1e3
    cpu_a_err = max_abs_diff(cpu_flags, native)
    cpu_b_err = max_abs_diff(cpu_rows, np.frombuffer(want, np.uint8))
    a_err, b_err = max(a_err, cpu_a_err), max(b_err, cpu_b_err)
    if cpu_a_err != 0 or cpu_b_err != 0:
        raise AssertionError(f"plain versions on the CPU differ from the native copies (flags "
                             f"max |d| {cpu_a_err}, bytes max |d| {cpu_b_err})")
    print(f"# 6c plain versions on the host's CPU ({torch.get_num_threads()} torch threads), "
          f"equal to the native copies: ARACNE {a_cpu_ms:.3f} ms against the native "
          f"owner-scan's {native_a_ms:.3f} ms ({a_cpu_ms / native_a_ms:.1f}x), formatter "
          f"{b_cpu_ms:.3f} ms against the native formatter's {native_b_ms:.3f} ms "
          f"({b_cpu_ms / native_b_ms:.1f}x); the pipeline on the CPU runs the native copies",
          flush=True)
    del cpu, cpu_flags, cpu_rows
    mi = adversarial_mi(np.random.default_rng(6))
    z = torch.zeros(len(mi), dtype=torch.int64, device=dev)
    adv = format_couplings_rows(z, z, z, z.to(torch.uint8), torch.from_numpy(mi).to(dev))
    py = "".join(f"0 0 0 0 {x:.6f}\n" for x in mi).encode()
    adv_err = max_abs_diff(adv.cpu().numpy(), np.frombuffer(py, np.uint8))
    b_err = max(b_err, adv_err)
    if adv_err != 0:
        raise AssertionError(f"formatter kernel: an adversarial MI differs from Python's "
                             f"(max |d| {adv_err})")
    print(f"# 6c formatter kernel on {len(mi)} adversarial MI values (103 binary-exact ties, "
          f"{ADVERSARIAL_HALFWAY} halfway points and their one-ulp neighbours, 5e-7 +- 1 ulp, "
          "subnormals, random up to ln 5): rows equal to Python's f\"{x:.6f}\"", flush=True)
    del plain, plain_rows, rows, d
    return ({"aracne": a_err, "format": b_err},
            {"aracne": {"ms": a_ms, "plain_ms": a_plain_ms, "bound_ms": a_bound, "bound_by": a_by,
                        "library_ms": None},
             "format": {"ms": b_ms, "plain_ms": b_plain_ms, "bound_ms": b_bound, "bound_by": b_by,
                        "library_ms": None}})


TOURNAMENT_SEED = 1  # phase 5's --seed: the tournament's pair stream


def tournament_pairs(L, seed=TOURNAMENT_SEED, iterations=10):
    """The (ipos, jpos) of every iteration of the automatic threshold's
    tournament at L columns, drawn as ``determine_mi_threshold`` draws them."""
    from spydrpick_torch.engine import threshold as th

    possible = L * (L - 1) // 2
    pct = 1.0 - float(th.default_mi_values(L, 0)) / possible
    n = th.determine_threshold_pairs(0, possible, pct)
    rng = np.random.default_rng(seed)
    draws = [th.sample_pairs(rng, n, L) for _ in range(iterations)]
    return np.concatenate([d[0] for d in draws]), np.concatenate([d[1] for d in draws])


def phase_lead_in(dev, al, main_launches):
    """Phase 6d: the lead-in's kernels at the main path's data, each
    bit-equal to its plain version: ``column_state_counts`` on phase 5's
    codes as the pipeline keeps them on the card (``al.device_codes``),
    with the host numpy passes it replaces timed beside it; ``pairs_xtab``
    on the tournament's 1,000,000 pairs (one launch; and in the
    pipeline's chunks); times, bounds and shares."""
    from spydrpick_torch.engine.solver import pairs_chunk
    from spydrpick_torch.ops.columns import column_state_counts, column_state_counts_plain
    from spydrpick_torch.ops.pairs import pairs_xtab, pairs_xtab_plain

    codes = al.device_codes
    if codes is None or not codes.is_cuda:
        raise AssertionError("phase 6d: the pipeline's alignment holds no codes on the card")
    S, L = codes.shape
    n0 = column_state_counts.launches
    got = column_state_counts(codes)
    plain = column_state_counts_plain(codes)
    c_err = max_abs_diff(got.cpu().numpy(), plain.cpu().numpy())
    host = al.codes
    t0 = time.perf_counter()
    host_counts = np.stack([np.count_nonzero(host == k, axis=0) for k in range(5)], 1)
    host_ms = (time.perf_counter() - t0) * 1e3
    c_err = max(c_err, max_abs_diff(got.cpu().numpy(), host_counts))
    if c_err != 0 or column_state_counts.launches != n0 + 1:
        raise AssertionError(f"column counts kernel: differs from the plain version or the "
                             f"host's (max |d| {c_err})")
    c_ms = cuda_time_ms(lambda: column_state_counts(codes), 20)
    c_plain_ms = cuda_time_ms(lambda: column_state_counts_plain(codes), 3)
    c_bound, c_by = bound(0, "f32", S * L + 20 * L)
    print(f"# 6d column counts kernel on phase 5's {S} x {L} codes on the card: counts equal "
          f"to the plain version's and the host numpy's; {c_ms:.4f} ms, {share(c_ms, c_bound)}"
          f" ({c_by}); plain {c_plain_ms:.3f} ms; host numpy (the five passes it replaces) "
          f"{host_ms:.1f} ms; launches in phase 5's run "
          f"{main_launches['column_state_counts']}", flush=True)

    ipos, jpos = tournament_pairs(L)
    P = len(ipos)
    i_d, j_d = torch.from_numpy(ipos).to(dev), torch.from_numpy(jpos).to(dev)
    ci, cj = codes.index_select(1, i_d), codes.index_select(1, j_d)
    w = torch.from_numpy(np.asarray(al.weights, dtype=np.float32)).to(dev)
    tab = pairs_xtab(ci, cj, w)
    want = pairs_xtab_plain(ci, cj, w)
    c = pairs_chunk(S)
    chunked = torch.cat([pairs_xtab(ci[:, k:k + c].contiguous(), cj[:, k:k + c].contiguous(), w)
                         for k in range(0, P, c)])
    p_err = max(float((tab - want).abs().max()), float((chunked - tab).abs().max()))
    if not (torch.equal(tab, want) and torch.equal(chunked, tab)):
        raise AssertionError(f"pairs crosstable kernel: tables differ from the plain version's "
                             f"or across chunks (max |d| {p_err})")
    p_ms = cuda_time_ms(lambda: pairs_xtab(ci, cj, w), 5)
    parts = [(ci[:, k:k + c].contiguous(), cj[:, k:k + c].contiguous()) for k in range(0, P, c)]
    chunks_ms = cuda_time_ms(lambda: [pairs_xtab(a, b, w) for a, b in parts], 3)
    p_plain_ms = cuda_time_ms(lambda: pairs_xtab_plain(ci, cj, w), 1)
    p_bound, p_by = bound(S * P, "f64", 2 * S * P + 100 * P)
    print(f"# 6d pairs crosstable kernel on the tournament's {P} pairs (S={S}): tables equal to "
          f"the plain version's bit for bit, and in the pipeline's {len(parts)} chunks of {c} "
          f"pairs; one launch {p_ms:.3f} ms, {share(p_ms, p_bound)} ({p_by}); in chunks "
          f"{chunks_ms:.3f} ms; plain {p_plain_ms:.3f} ms; launches in phase 5's run "
          f"{main_launches['pairs_xtab']}", flush=True)
    del ci, cj, parts, tab, want, chunked
    torch.cuda.empty_cache()
    return ({"column_state_counts": c_err, "pairs_xtab": p_err},
            {"column_state_counts": {"ms": c_ms, "plain_ms": c_plain_ms, "bound_ms": c_bound,
                                     "bound_by": c_by, "library_ms": None},
             "pairs_xtab": {"ms": p_ms, "plain_ms": p_plain_ms, "bound_ms": p_bound,
                            "bound_by": p_by, "library_ms": None}})


def cli_run(args, label):
    """``cli.main(args)`` with its stdout captured; returns the log and
    the K1/B3/B2 launches it made."""
    from spydrpick_torch import cli
    from spydrpick_torch.ops.compact import row_select
    from spydrpick_torch.ops.mi_kernels import mi_tile_dual, mi_tile_single

    mi_tile_single.launches = mi_tile_dual.launches = row_select.launches = 0
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = cli.main(args)
    launches = {"mi_tile_single": mi_tile_single.launches, "mi_tile_dual": mi_tile_dual.launches,
                "row_select": row_select.launches}
    text = log.getvalue()
    if rc != 0:
        raise AssertionError(f"{label}: cli.main returned {rc}:\n{text[-4000:]}")
    return text, launches


def assert_same_outputs(want_dir, got_dir, label):
    names = sorted(os.listdir(want_dir))
    if sorted(os.listdir(got_dir)) != names:
        raise AssertionError(f"{label}: files {sorted(os.listdir(got_dir))} != {names}")
    for name in names:
        with open(os.path.join(want_dir, name), "rb") as a, open(os.path.join(got_dir, name),
                                                                 "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"{label}: {name} differs from phase 5's")
    return names


def phase_checkpoint(dev, td, fasta, wfile, main_out, main_sweep_s, L=L_BENCH,
                     kill_after=24, every=8):
    """Kill a checkpointed sweep (saved every ``every`` rows) after block-row
    ``kill_after``, resume it through the CLI, and time an uninterrupted
    checkpointed CLI run."""
    from spydrpick_torch.engine import checkpoint as ckpt_mod

    class Killed(Exception):
        pass

    al, engine, thr = pipeline_engine(dev, fasta, wfile)
    path = os.path.join(td, "sweep.ckpt")
    seen = []

    def progress(lo, hi, n, dt):
        seen.append(lo)
        if len(seen) == kill_after:
            raise Killed

    try:
        engine.sweep(thr, progress=progress, checkpoint_path=path, checkpoint_every=every)
        raise AssertionError("checkpointed sweep was not killed")
    except Killed:
        pass
    saved = ckpt_mod.load(path, ckpt_mod.params_key(engine.statics, thr))
    if saved is None:
        raise AssertionError("no checkpoint with the pipeline's key after the kill")
    n_done = len(saved.done_rows)
    n_saved = sum(len(x) for x in saved.mi)
    del engine, saved
    torch.cuda.empty_cache()
    n_rows = -(-L // TILE)
    out = os.path.join(td, "resumed")
    text, launches = cli_run(main_flags(fasta, wfile) + ["--checkpoint", path,
                                                         "--output-dir", out], "resume")
    if (launches["mi_tile_single"] != n_rows - n_done or launches["mi_tile_dual"] != 0
            or launches["row_select"] != n_rows - n_done):
        raise AssertionError(f"resumed run launches {launches}, expected {n_rows - n_done} K1 "
                             "and B2")
    if os.path.exists(path):
        raise AssertionError("the checkpoint file outlived the completed run")
    names = assert_same_outputs(main_out, out, "resumed run")
    resumed_sweep_s, resumed_ck_s = sweep_seconds(text)
    print(f"# checkpoint: killed after block-row {kill_after} with {n_done} rows / {n_saved} edges "
          f"saved; resumed cli.main launched K1 {launches['mi_tile_single']} times, "
          f"sweep_s {resumed_sweep_s:.2f} (checkpoint_s {resumed_ck_s:.2f}), removed the file, "
          f"{len(names)} outputs byte-identical to phase 5's", flush=True)
    out = os.path.join(td, "checkpointed")
    text, launches = cli_run(main_flags(fasta, wfile) + ["--checkpoint", path,
                                                         "--output-dir", out], "checkpointed")
    assert_same_outputs(main_out, out, "checkpointed run")
    ck_sweep_s, ck_s = sweep_seconds(text)
    print(f"# checkpoint: uninterrupted --checkpoint run sweep_s {ck_sweep_s:.2f} s, "
          f"checkpoint_s {ck_s:.2f} s (uncompressed saves every 16 rows) vs phase 5 sweep_s "
          f"{main_sweep_s:.2f} s, outputs byte-identical; launches {launches}", flush=True)
    return launches


def sweep_seconds(log):
    """(sweep_s, checkpoint_s) of a checkpointed CLI run's ``-v`` log."""
    return (float(re.search(r"stage time: sweep ([\d.]+)s", log).group(1)),
            float(re.search(r"checkpoint saves: ([\d.]+)s", log).group(1)))


def rank_main(argv, kill_after_saves: int | None = None) -> int:
    """One rank of a sharded CLI run: ``cli.main(argv)``, then its launch
    counts as the last line.  With ``kill_after_saves`` k the process
    ends at once, with KILLED_RC, right after its k-th checkpoint save
    returns (only process 0 saves)."""
    from spydrpick_torch.bench import kernel_counters

    fns = kernel_counters()
    for fn in fns.values():
        fn.launches = 0
    from spydrpick_torch import cli

    if kill_after_saves is not None:
        from spydrpick_torch.engine import checkpoint as ckpt_mod

        save, n_saves = ckpt_mod.save, []

        def save_then_die(path, ckpt):
            save(path, ckpt)
            n_saves.append(path)
            if len(n_saves) == kill_after_saves:
                sys.stdout.flush()
                os._exit(KILLED_RC)

        ckpt_mod.save = save_then_die
    rc = cli.main(argv)
    print(json.dumps({"rc": rc, "launches": {k: fn.launches for k, fn in fns.items()}}))
    return rc


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(args, out_dir, n=2, rank_args=("--rank",)):
    """``n`` processes of ``chip_smoke.py RANK_ARGS ARGS``, joined by the
    multi-host flags, all on this card."""
    port = free_port()
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), *rank_args, *args, "--output-dir", out_dir,
         "--coordinator-address", f"127.0.0.1:{port}", "--num-processes", str(n),
         "--process-id", str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]


def run_ranks(args, out_dir, label, n=2):
    """``cli.main(args)`` in ``n`` processes joined by the multi-host flags,
    all on this card; returns each rank's log and launch counts.  Raises
    if a rank fails or outlives RANK_TIMEOUT (then every rank is killed)."""
    procs = start_ranks(args, out_dir, n)
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    launches = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"{label}: rank {r} exited {p.returncode}:\n{log[-4000:]}")
        launches.append(json.loads(log.strip().splitlines()[-1])["launches"])
    return logs, launches


def rank_summary(log):
    stages = dict(re.findall(r"stage time: (\w+) ([\d.]+)s", log))
    banner = re.search(r"rank \d+ of \d+ on \S+ \(\w+ backend\)", log).group(0)
    return banner, stages


def phase_rows_sharded(td, fasta, wfile, main_out, L=L_BENCH):
    """Phase 8: phase 5's CLI run with --sharded over two ranks."""
    out = os.path.join(td, "rows_sharded")
    t0 = time.perf_counter()
    logs, launches = run_ranks(main_flags(fasta, wfile) + ["--sharded"], out, "rows-sharded")
    wall = time.perf_counter() - t0
    names = assert_same_outputs(main_out, out, "rows-sharded run")
    n_rows = -(-L // TILE)
    k1 = sum(x["mi_tile_single"] for x in launches)
    b2 = sum(x["row_select"] for x in launches)
    if (k1 != n_rows or b2 != n_rows or any(x["crosstab_tile"] or x["mi_epilogue"]
                                            or x["mi_tile_dual"] for x in launches)):
        raise AssertionError(f"rows-sharded launches {launches}: expected {n_rows} K1 and B2 "
                             "in all")
    for r, log in enumerate(logs):
        banner, stages = rank_summary(log)
        if "mesh rows x samples = (2, 1)" not in log:
            raise AssertionError(f"rows-sharded rank {r} did not run a (2, 1) mesh")
        print(f"# rows-sharded rank {r}: {banner}; launches {launches[r]}; stage seconds "
              + ", ".join(f"{k} {v}" for k, v in stages.items()), flush=True)
    print(f"# rows-sharded S={S_BENCH} L={L}: 2 ranks in {wall:.2f} s, K1 {k1} and B2 {b2} "
          f"launches in all, {len(names)} outputs byte-identical to phase 5's", flush=True)
    return launches


def kill_ranks(args, out_dir, label, saves, n=2):
    """``cli.main(args)`` (a ``--checkpoint`` run) in ``n`` processes,
    process 0 ending hard right after its ``saves``-th save; then every
    rank left is killed (it waits in a collective for process 0).
    Returns process 0's log."""
    procs = start_ranks(args, out_dir, n, ("--rank-killed", str(saves)))
    log = ""
    try:
        log = procs[0].communicate(timeout=RANK_TIMEOUT)[0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs[1:]:
            p.communicate()
        procs[0].wait()
    if procs[0].returncode != KILLED_RC:
        raise AssertionError(f"{label}: process 0 exited {procs[0].returncode}, not after its "
                             f"save {saves}:\n{log[-4000:]}")
    return log


def phase_rows_sharded_checkpoint(td, fasta, wfile, main_out, L=L_BENCH, every=8, saves=2):
    """Phase 12: phase 5's CLI run with --sharded --checkpoint over two
    ranks, killed after process 0's ``saves``-th save, resumed by two
    ranks and, from a copy of the same snapshot, by one process."""
    path = os.path.join(td, "sharded.ckpt")
    flags = main_flags(fasta, wfile) + ["--sharded", "--checkpoint", path,
                                        "--checkpoint-every", str(every)]
    t0 = time.perf_counter()
    kill_ranks(flags, os.path.join(td, "killed"), "killed sharded run", saves)
    t_kill = time.perf_counter() - t0
    if os.listdir(os.path.join(td, "killed")):
        raise AssertionError("the killed sharded run wrote outputs")
    with np.load(path) as z:
        n_done, n_saved = len(z["done_rows"]), len(z["mi"])
    n_rows = -(-L // TILE)
    if n_done != saves * every:
        raise AssertionError(f"the killed run saved {n_done} block-rows, not {saves * every}")
    copy = os.path.join(td, "sharded_copy.ckpt")
    with open(path, "rb") as a, open(copy, "wb") as b:
        b.write(a.read())
    out = os.path.join(td, "sharded_resumed")
    t1 = time.perf_counter()
    logs, launches = run_ranks(flags, out, "sharded resume")
    t_resume = time.perf_counter() - t1
    names = assert_same_outputs(main_out, out, "sharded resumed run")
    k1 = sum(x["mi_tile_single"] for x in launches)
    b2 = sum(x["row_select"] for x in launches)
    if (k1 != n_rows - n_done or b2 != n_rows - n_done
            or any(x["crosstab_tile"] or x["mi_epilogue"] or x["mi_tile_dual"]
                   for x in launches)):
        raise AssertionError(f"sharded resume launches {launches}: expected "
                             f"{n_rows - n_done} K1 and B2 in all")
    if os.path.exists(path):
        raise AssertionError("the snapshot outlived the completed sharded run")
    ranks = []
    for r, log in enumerate(logs):
        sweep_s, ck_s = sweep_seconds(log)
        ranks.append(f"rank {r} sweep_s {sweep_s:.2f} checkpoint_s {ck_s:.2f} "
                     f"K1 {launches[r]['mi_tile_single']} B2 {launches[r]['row_select']}")
    t2 = time.perf_counter()
    out = os.path.join(td, "sharded_resumed_single")
    text, single = cli_run(main_flags(fasta, wfile) + ["--checkpoint", copy, "--output-dir", out],
                           "one-process resume of the sharded snapshot")
    t_single = time.perf_counter() - t2
    assert_same_outputs(main_out, out, "one-process resume of the sharded snapshot")
    if single["mi_tile_single"] != n_rows - n_done or single["row_select"] != n_rows - n_done:
        raise AssertionError(f"one-process resume launches {single}: expected "
                             f"{n_rows - n_done} K1 and B2")
    if os.path.exists(copy):
        raise AssertionError("the snapshot outlived the completed one-process run")
    sweep_s, ck_s = sweep_seconds(text)
    print(f"# sharded checkpoint: 2 ranks saving every {every} block-rows over the mesh, "
          f"process 0 killed after save {saves} ({t_kill:.2f} s): {n_done} rows / {n_saved} "
          f"edges saved; 2-rank resume in {t_resume:.2f} s: " + "; ".join(ranks)
          + f"; {len(names)} outputs byte-identical to phase 5's, file removed; one-process "
          f"resume of the same snapshot in {t_single:.2f} s: sweep_s {sweep_s:.2f} checkpoint_s "
          f"{ck_s:.2f}, K1 {single['mi_tile_single']} B2 {single['row_select']}, "
          f"byte-identical, file removed; phase 12 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return launches


def phase_samples_sharded(dev, td, S=S_BENCH, L=L_SAMPLE_SHARDED):
    """Phase 9: --sharded --sample-shards 2 over two ranks against one
    process, on a cut of the bench alignment."""
    from spydrpick_torch.stage_profile import bench_alignment, write_inputs

    codes, w = bench_alignment(S, L, seed=0)
    fasta, wfile = write_inputs(td, "samples", codes, w)
    del codes
    _, engine, thr = pipeline_engine(dev, fasta, wfile)
    del engine
    torch.cuda.empty_cache()
    flags = main_flags(fasta, wfile)
    single = os.path.join(td, "samples_single")
    text, _ = cli_run(flags + ["--output-dir", single], "single-process")
    thr_single = float(re.search(r"MI save threshold = ([\d.]+)", text).group(1))
    print(f"# samples-sharded S={S} L={L} single-process run: stage seconds "
          + ", ".join(f"{k} {v}" for k, v in re.findall(r"stage time: (\w+) ([\d.]+)s", text)),
          flush=True)
    from spydrpick_torch.parallel.mesh import XTAB_COLS

    n_rows = -(-L // TILE)
    # one B4 and one B5 per XTAB_COLS-wide j-chunk of each block-row
    n_chunks = sum(-(-(n_rows * TILE - i0) // XTAB_COLS) for i0 in range(0, L, TILE))
    result = None
    for label, extra in (("given threshold", ["--mi-threshold", repr(thr)]),
                         ("sharded tournament", [])):
        out = os.path.join(td, "samples_sharded_" + str(len(extra)))
        t0 = time.perf_counter()
        logs, launches = run_ranks(flags + extra + ["--sharded", "--sample-shards", "2"], out,
                                   f"samples-sharded ({label})")
        wall = time.perf_counter() - t0
        names = assert_same_outputs(single, out, f"samples-sharded run ({label})")
        for r, (log, n) in enumerate(zip(logs, launches)):
            if (n["crosstab_tile"] != n_chunks or n["mi_epilogue"] != n_chunks
                    or n["row_select"] != n_rows or n["mi_tile_single"] or n["mi_tile_dual"]):
                raise AssertionError(f"samples-sharded rank {r} launches {n}: expected "
                                     f"{n_chunks} B4 and B5, {n_rows} B2, no K1/B3")
            if f"{S // 2} sample rows" not in log or "mesh rows x samples = (1, 2)" not in log:
                raise AssertionError(f"samples-sharded rank {r} did not hold {S // 2} samples "
                                     "on a (1, 2) mesh")
            banner, stages = rank_summary(log)
            print(f"# samples-sharded ({label}) rank {r}: {banner}; launches {n}; stage "
                  "seconds " + ", ".join(f"{k} {v}" for k, v in stages.items()), flush=True)
        line = f"# samples-sharded S={S} L={L} ({label}): 2 ranks in {wall:.2f} s, " \
               f"{len(names)} outputs byte-identical to the single-process run's"
        if not extra:
            thr_sh = float(re.search(r"MI save threshold = ([\d.]+)", logs[0]).group(1))
            line += f"; threshold sharded {thr_sh:.6f} vs single-process {thr_single:.6f}"
        print(line + f" (exact single-process threshold {thr!r})", flush=True)
        if result is None:
            result = launches
    return result


def wide_sweep(engine, thr):
    """``engine.sweep(thr)`` with K1, B3 and B2 counted from 0: the edges
    and (seconds, timings, peak device memory in GiB, launches)."""
    from spydrpick_torch.bench import kernel_counters

    fns = kernel_counters()
    for fn in fns.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tm = {}
    t0 = time.perf_counter()
    edges = engine.sweep(thr, timings=tm)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return edges, (dt, tm, torch.cuda.max_memory_allocated() / 2**30,
                   {k: fn.launches for k, fn in fns.items()})


def check_item_launches(label, tm, launches):
    """A lazy sweep launches K1 and B2 once per item, B3 never (no row
    swept again: the default store holds these sweeps' edges)."""
    n = tm["n_items"]
    if (tm["rerun_rows"] or launches["mi_tile_single"] != n or launches["row_select"] != n
            or launches["mi_tile_dual"]):
        raise AssertionError(f"{label}: launches {launches}, {tm['rerun_rows']} rows swept "
                             f"again; expected {n} K1 and B2 (one per item), no B3")


WIDE_CONFIGS = {  # phase 10's three library sweeps
    "dense full width": dict(onehot_storage="dense", row_window=1),
    "dense windowed": dict(onehot_storage="dense", row_window=WIDE_WINDOW),
    "codes windowed": dict(onehot_storage="codes", row_window=WIDE_WINDOW),
}


def phase_wide_cut(dev, td, S=S_WIDE, L=L_CUT):
    """Phase 10: the wide path at a cut, S=256 x L=262,144 (past the 2^17
    columns where "auto" turns j-windows on): three library sweeps in turns
    (dense full width, dense windowed, codes windowed, then backwards)
    with identical EdgeSets, then the CLI with and without ``--onehot-
    storage codes --row-window 65536``, byte-identical."""
    from spydrpick_torch.engine.solver import EngineConfig, MIEngine
    from spydrpick_torch.pipeline import PipelineOptions, load_and_preprocess
    from spydrpick_torch.stage_profile import bench_alignment, write_inputs

    codes, w = bench_alignment(S, L, seed=0)
    fasta, wfile = write_inputs(td, "wide", codes, w)
    del codes
    al = load_and_preprocess(PipelineOptions(alignmentfile=fasta, sample_weights=wfile))
    want, runs = None, {}
    for name in list(WIDE_CONFIGS) + list(WIDE_CONFIGS)[::-1]:
        engine = MIEngine(al, EngineConfig(wog_fetch="outliers", **WIDE_CONFIGS[name]),
                          device=dev)
        st = engine.statics
        if (st.int8_mode != "fixed14" or st.onehot_codes != name.startswith("codes")
                or bool(st.row_window) != name.endswith("windowed")):
            raise AssertionError(f"{name}: engine resolved {st}")
        edges, (dt, tm, gib, launches) = wide_sweep(engine, WIDE_THRESHOLD)
        del engine
        torch.cuda.empty_cache()
        check_item_launches(name, tm, launches)
        if want is None:
            want = edges
        for f in ("ipos", "jpos", "mi", "mi_wog", "colmax"):
            if not np.array_equal(getattr(edges, f), getattr(want, f)):
                raise AssertionError(f"wide cut, {name}: {f} differs from the dense full-width "
                                     "sweep's")
        runs.setdefault(name, []).append((dt, tm, gib))
        print(f"# wide cut S={S} L={L} {name} (row_window {st.row_window}, Lp {st.Lp}): "
              f"{edges.n_edges} edges equal to the dense full-width sweep's; sweep {dt:.3f} s, "
              f"compute_s {tm['compute_s']:.3f}, fetch_s {tm['fetch_s']:.3f}, n_items "
              f"{tm['n_items']}, expand_s {tm.get('expand_s', 0.0):.3f}, peak device memory "
              f"{gib:.3f} GiB; launches {launches}", flush=True)
    base = min(r[0] for r in runs["dense full width"])
    for name, rs in runs.items():
        best = min(r[0] for r in rs)
        print(f"# wide cut {name}: best sweep {best:.3f} s, {100 * (best / base - 1):+.1f}% "
              "against dense full width", flush=True)
    del want
    outs = {}
    for label, extra in (("auto", []), ("codes windowed", ["--onehot-storage", "codes",
                                                          "--row-window", str(WIDE_WINDOW)])):
        out = os.path.join(td, "wide_" + label.replace(" ", "_"))
        text, launches = cli_run(main_flags(fasta, wfile) + extra + [
            "--mi-values", str(WIDE_MI_VALUES), "--output-dir", out], f"wide CLI ({label})")
        engine_line = re.search(r"engine on .*", text).group(0)
        if label == "auto" and "dense one-hot, full-width rows" not in engine_line:
            raise AssertionError(f"wide CLI: auto resolved to {engine_line}, not dense "
                                 "full-width rows (they fit in half of the card)")
        stages = ", ".join(f"{k} {v}" for k, v in re.findall(r"stage time: (\w+) ([\d.]+)s",
                                                             text))
        n_edges = int(re.search(r"(\d+) edges stored", text).group(1))
        print(f"# wide CLI ({label}) S={S} L={L}: {engine_line}; {n_edges} edges; stage "
              f"seconds {stages}; launches {launches}", flush=True)
        outs[label] = out
    names = assert_same_outputs(outs["auto"], outs["codes windowed"], "wide CLI with codes "
                                "storage and windows")
    print(f"# wide CLI: {len(names)} outputs byte-identical with and without --onehot-storage "
          f"codes --row-window {WIDE_WINDOW}", flush=True)
    return runs


def mi_f64(engine, weights, ipos, jpos, chunk=32768):
    """float64 MI of explicit pairs of ``engine``'s alignment: the joint
    counts of their codes weighted by ``weights`` in float64 and the
    epilogue of ops/mi.py in float64 (an evaluation independent of K1)."""
    from spydrpick_torch.engine.solver import codes_xtab
    from spydrpick_torch.ops.mi import mi_from_crosstabs

    d, st = engine.data, engine.statics
    out = []
    for p in range(0, len(ipos), chunk):
        i = torch.as_tensor(ipos[p:p + chunk], device=d.codes.device)
        j = torch.as_tensor(jpos[p:p + chunk], device=d.codes.device)
        C = codes_xtab(d.codes[:, i], d.codes[:, j], weights)
        out.append(mi_from_crosstabs(C, d.presence[i], d.presence[j], st.pseudocount))
    return torch.cat(out).cpu().numpy()


def f64_count(engine, weights, edges, thr, margin):
    """The count above ``thr`` with float64 MI (``mi_f64``) from a sweep
    that kept every edge above thr - margin: the edges above thr + margin
    plus those of the band [thr - margin, thr + margin] whose float64 MI
    lies above thr.  Exact when every pair's float64 MI lies within
    margin of the sweep's, as the band's largest difference, which is
    returned, must show.  Returns (count, max |mi_f64 - mi| over the band,
    band size)."""
    band = np.abs(edges.mi - thr) <= margin
    m64 = mi_f64(engine, weights, edges.ipos[band], edges.jpos[band])
    dmax = float(np.max(np.abs(m64 - edges.mi[band])))
    n = int(np.count_nonzero(edges.mi > thr + margin)) + int(np.count_nonzero(m64 > thr))
    return n, dmax, int(band.sum())


def reference_groups(L, T, rw, Lp, G=8):
    """The reference run's progress lines (``REFERENCE_LOG``) with the
    items each one counts.  scripts/bench_1m_width.py's sweep dispatches
    its (block-row, window) items G at a time, each block-row's windows
    from the one that holds its diagonal (spydrpick_tpu/engine/solver.py:
    1541-1548), and prints a group's edges above the threshold when its
    first block-row starts within 1024 columns past a multiple of 65536
    (:1590-1591).  Returns [(lo, hi, edges, [(i0, w0), ...])], in order."""
    items = [(r, w0) for r in range(0, L, T) for w0 in range(r // rw * rw, Lp, rw)]
    groups = [items[k:k + G] for k in range(0, len(items), G)]
    shown = [g for g in groups if g[0][0] % 65536 < 1024]
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), REFERENCE_LOG)) as f:
        lines = re.findall(r"# rows (\d+)-(\d+) \((\d+) edges", f.read())
    if [(g[0][0], min(g[-1][0] + T, L)) for g in shown] != [(int(a), int(b)) for a, b, _ in lines]:
        raise AssertionError(f"{REFERENCE_LOG}: its progress lines are not the groups of "
                             f"{len(items)} items by {G}")
    return [(int(a), int(b), int(n), g) for (a, b, n), g in zip(lines, shown)]


def group_counts(edges, groups, T, rw, Lp, thresholds):
    """(len(thresholds), len(groups)): this sweep's edges above each
    threshold in the items of each reference group."""
    nw = Lp // rw
    gid = np.full((Lp // T) * nw, -1, dtype=np.int64)
    for g, (_, _, _, items) in enumerate(groups):
        for i0, w0 in items:
            gid[i0 // T * nw + w0 // rw] = g
    g = gid[edges.ipos // T * nw + edges.jpos // rw]
    return np.stack([np.bincount(g[(g >= 0) & (edges.mi > t)], minlength=len(groups))
                     for t in thresholds])


def recount_block_row(engine, w64, i0, thr_lo, cw=4096):
    """Every pair (i, j) of block-row i0 (i0 <= i < i0 + tile, i < j < L)
    whose float64 MI exceeds ``thr_lo``, as (i * L + j keys, MI): the
    one-hot's weighted products in float64 (``torch.matmul``) and the
    epilogue of ops/mi.py in float64, independent of K1, B2, the store and
    the windows."""
    from spydrpick_torch.ops.mi import mi_from_crosstabs

    d, st = engine.data, engine.statics
    T, L, S = st.tile, st.L, st.S
    states = torch.arange(5, dtype=torch.uint8, device=d.codes.device)
    onehot = lambda c0, c1: (d.codes[:, c0:c1, None] == states).double()  # (S, n, 5)
    pres = d.presence.double()
    xi = (onehot(i0, i0 + T) * w64[:, None, None]).reshape(S, T * 5)
    ii = torch.arange(i0, i0 + T, device=xi.device)
    keys, mis = [], []
    for c0 in range(i0, L, cw):
        c1 = min(c0 + cw, L)
        C = (xi.T @ onehot(c0, c1).reshape(S, -1)).view(T, 5, c1 - c0, 5).permute(0, 2, 1, 3)
        mi = mi_from_crosstabs(C, pres[i0:i0 + T, None], pres[None, c0:c1], st.pseudocount)
        jj = torch.arange(c0, c1, device=xi.device)
        r, c = ((mi > thr_lo) & (jj[None, :] > ii[:, None])).nonzero(as_tuple=True)
        keys.append(ii[r] * L + jj[c])
        mis.append(mi[r, c])
    return torch.cat(keys).cpu().numpy(), torch.cat(mis).cpu().numpy()


def check_recount(edges, engine, w64, rows, thr):
    """Hold the sweep's edges of block-rows ``rows`` to ``recount_block_row``:
    every pair whose float64 MI exceeds thr - WIDE_MARGIN / 2 is stored,
    within K1_TOL of it, and every stored edge above thr - WIDE_MARGIN / 2 +
    K1_TOL is such a pair.  Returns (pairs checked, max |d|, edges above thr
    in the sweep and in float64)."""
    st = engine.statics
    T, L = st.tile, st.L
    thr_lo = thr - WIDE_MARGIN / 2
    brow = edges.ipos // T * T
    n_pairs, dmax, n32, n64 = 0, 0.0, 0, 0
    for i0 in rows:
        sel = brow == i0
        k32, m32 = edges.ipos[sel] * L + edges.jpos[sel], edges.mi[sel]
        order = np.argsort(k32)
        k32, m32 = k32[order], m32[order]
        k64, m64 = recount_block_row(engine, w64, i0, thr_lo)
        at = np.minimum(np.searchsorted(k32, k64), len(k32) - 1)
        lost = k32[at] != k64 if len(k32) else np.ones(len(k64), bool)
        extra = np.setdiff1d(k32[m32 > thr_lo + K1_TOL], k64)
        if lost.any() or len(extra):
            raise AssertionError(
                f"1M sweep, block-row {i0}: {int(lost.sum())} pairs above {thr_lo} in float64 "
                f"not stored (first {k64[lost][:3] // L}, {k64[lost][:3] % L}), {len(extra)} "
                f"stored edges above {thr_lo + K1_TOL} not above {thr_lo} in float64")
        d = float(np.max(np.abs(m32[at] - m64))) if len(k64) else 0.0
        if d > K1_TOL:
            raise AssertionError(f"1M sweep, block-row {i0}: max |mi - float64| {d} > {K1_TOL}")
        n_pairs += len(k64)
        dmax = max(dmax, d)
        n32 += int(np.count_nonzero(m32 > thr))
        n64 += int(np.count_nonzero(m64 > thr))
    return n_pairs, dmax, n32, n64


def check_desc_order(edges, got, dev):
    """On the card: ``got`` holds the edges of ``edges``, each with its
    mi and wog, once each (its keys ipos * 2^32 + jpos found among the
    sweep's, which are unique, and the sources a permutation), in
    descending mi with ties by (ipos, jpos) ascending."""
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    key = lambda e: (t(e.ipos) << 32) | t(e.jpos)
    ko, oi = torch.sort(key(edges))
    ks = key(got)
    n = len(ko)
    if len(ks) != n or not bool((ko[1:] > ko[:-1]).all()):
        raise AssertionError("1M sort: edge counts differ, or the sweep repeats a pair")
    pos = torch.searchsorted(ko, ks).clamp_(max=max(n - 1, 0))
    if not torch.equal(ko[pos], ks):
        raise AssertionError("1M sort: an edge of the sorted set is not the sweep's")
    src = oi[pos]
    del ko, oi, pos
    if not torch.equal(torch.sort(src).values, torch.arange(n, device=dev)):
        raise AssertionError("1M sort: the sorted set is not a permutation of the sweep's")
    for f in ("mi", "mi_wog"):
        if not torch.equal(t(getattr(got, f)), t(getattr(edges, f))[src]):
            raise AssertionError(f"1M sort: an edge's {f} moved apart from its pair")
    m = t(got.mi)
    ok = (m[1:] < m[:-1]) | ((m[1:] == m[:-1]) & (ks[1:] > ks[:-1]))
    if not bool(ok.all()):
        raise AssertionError("1M sort: not in descending mi with ties by (ipos, jpos)")


class HashSink:
    """A binary file that keeps only the sha256 and the count of the
    bytes written to it, and those of its first write."""

    def __init__(self):
        self.sha, self.n, self.first = hashlib.sha256(), 0, None

    def write(self, data) -> None:
        self.sha.update(data)
        self.n += memoryview(data).nbytes
        if self.first is None:
            self.first = (memoryview(data).nbytes, hashlib.sha256(data).hexdigest())


def wide_host_kernels(dev, al, ordered, d):
    """Phase 11's ARACNE kernel and couplings writer on the ~87M sorted
    edges ``d`` (on the card, the engine held, as in a pipeline run): each
    one's time and peak device memory, the writer's bytes crossing through
    pinned memory into a sink that hashes them.  Then both are held to
    the native copies on the first ROW_CHUNK (2^24) sorted edges, each
    native pass timed: the kernel's flags of that prefix, run as a graph
    of its own, against the owner-scan's, and the writer's first chunk of
    rows (sha256) against the native formatter's.  On every edge the
    native passes take 40–82 s of host time (PR 12's runs), which would
    push chip_smoke well past its budget."""
    from spydrpick_torch.core.distance import genome_distance
    from spydrpick_torch.engine.aracne import DEFAULT_EDGE_THRESHOLD as EPS
    from spydrpick_torch.io.writers import ROW_CHUNK, write_couplings_rows
    from spydrpick_torch.native import aracne_native, format_native
    from spydrpick_torch.ops.aracne import aracne_flags

    E = len(d.mi)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tm = {}
    flags = aracne_flags(d.ipos, d.jpos, d.mi, EPS, timings=tm)
    torch.cuda.synchronize()
    a_s, a_gib = time.perf_counter() - t0, torch.cuda.max_memory_allocated(dev) / 2**30
    torch.cuda.reset_peak_memory_stats(dev)
    sink, wt = HashSink(), {}
    t0 = time.perf_counter()
    write_couplings_rows(sink, d.ipos, d.jpos, d.mi, flags, al, 1, False, timings=wt)
    w_s, w_gib = time.perf_counter() - t0, torch.cuda.max_memory_allocated(dev) / 2**30
    got = flags.cpu().numpy()
    del flags
    print(f"# 1M width: ARACNE kernel on the {E} sorted edges ({tm['nodes']} nodes, longest "
          f"row {tm['max_degree']}) in {a_s:.3f} s (CSR {tm['csr_s']:.3f}, scan "
          f"{tm['scan_s']:.3f}), {int(got.sum())} direct, peak device memory {a_gib:.3f} GiB "
          f"(engine held); couplings rows {sink.n} bytes in {w_s:.3f} s (format "
          f"{wt['format_s']:.3f}, copy {wt['copy_s']:.3f}, sink with sha256 "
          f"{wt['file_s']:.3f}), peak {w_gib:.3f} GiB", flush=True)
    n = min(E, ROW_CHUNK)
    sub = aracne_flags(d.ipos[:n], d.jpos[:n], d.mi[:n], EPS).cpu().numpy()
    ipos, jpos, mi = ordered.ipos[:n], ordered.jpos[:n], ordered.mi[:n]
    t0 = time.perf_counter()
    want = ~aracne_native.mark_indirect(ipos, jpos, mi, EPS)
    native_a_s = time.perf_counter() - t0
    if not np.array_equal(sub, want.astype(np.uint8)):
        raise AssertionError("1M width: ARACNE kernel flags differ from the native owner-scan's")
    del want, sub
    p1 = al.translation[ipos] + 1
    p2 = al.translation[jpos] + 1
    dist = genome_distance(p1, p2, al.n_original_positions, False)
    t0 = time.perf_counter()
    data = format_native.format_couplings(p1, p2, dist, got[:n], mi)
    native_b_s = time.perf_counter() - t0
    if (len(data), hashlib.sha256(data).hexdigest()) != sink.first:
        raise AssertionError("1M width: the couplings writer's first chunk differs from the "
                             "native formatter's")
    print(f"# 1M width: on the first {n} sorted edges, run as a graph of their own, the ARACNE "
          f"kernel's flags equal the native owner-scan's ({native_a_s:.2f} s), and the "
          f"writer's first chunk of rows ({len(data)} bytes) the native formatter's "
          f"({native_b_s:.2f} s; sha256 {sink.first[1]})", flush=True)


def phase_full_width(dev, S=S_WIDE, L=L_WIDE):
    """Phase 11: the 1M-column width shape, codes storage and j-windows,
    swept at WIDE_THRESHOLD - WIDE_MARGIN from the default store (which
    grows, and rows are swept again) and from a WIDE_STORE-slot store that
    never grows: identical EdgeSets.  Whole block-rows (the first two,
    every row swept again and RECOUNT_ROWS more) are held to a float64
    recount of all their pairs (``check_recount``).  The count above
    WIDE_THRESHOLD is printed beside the float64 count of the edges near
    it and the reference's count with its +-WIDE_BAND band.  The reference
    run's MI sits above this sweep's by one offset (PERF.md), so its
    printed groups are held to this sweep's counts at the MI where this
    sweep reaches the reference's whole count: each inside the +-WIDE_BAND
    band there."""
    from spydrpick_torch.core.alignment import Alignment
    from spydrpick_torch.engine.solver import EngineConfig, MIEngine
    from spydrpick_torch.stage_profile import bench_alignment

    codes, w = bench_alignment(S, L, seed=0)
    al = Alignment(codes, [f"s{i}" for i in range(S)], "width1m", np.arange(L), L, w)
    t0 = time.perf_counter()
    engine = MIEngine(al, EngineConfig(onehot_storage="codes", row_window=WIDE_WINDOW,
                                       wog_fetch="outliers"), device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    st = engine.statics
    T, rw, Lp = st.tile, st.row_window, st.Lp
    if st.int8_mode != "fixed14" or not st.onehot_codes or rw != 62464:
        raise AssertionError(f"1M engine resolved {st}")
    calls = {}  # block-row -> items swept
    row_edges = engine.row_edges

    def counted(i0, *args):
        calls[i0] = calls.get(i0, 0) + 1
        return row_edges(i0, *args)

    engine.row_edges = counted
    thr = WIDE_THRESHOLD
    edges, (dt, tm, gib, launches) = wide_sweep(engine, thr - WIDE_MARGIN)
    again = sorted(i0 for i0, n in calls.items() if n > len(engine.row_windows(i0)))
    if not np.all(np.isfinite(edges.mi)) or not np.all(edges.ipos < edges.jpos):
        raise AssertionError("1M sweep: non-finite MI or an edge with ipos >= jpos")
    if (len(again) != tm["rerun_rows"] or launches["mi_tile_single"] != sum(calls.values())
            or launches["row_select"] != sum(calls.values()) or launches["mi_tile_dual"]):
        raise AssertionError(f"1M sweep: launches {launches} for {sum(calls.values())} items "
                             f"swept, {len(again)} rows swept again of {tm['rerun_rows']}")
    engine.row_edges = row_edges
    engine.config = dataclasses.replace(engine.config, store_capacity=WIDE_STORE)
    big, (dt_big, tm_big, gib_big, launches_big) = wide_sweep(engine, thr - WIDE_MARGIN)
    check_item_launches(f"1M sweep from a {WIDE_STORE}-slot store", tm_big, launches_big)
    for f in ("ipos", "jpos", "mi", "colmax"):
        if not np.array_equal(getattr(big, f), getattr(edges, f)):
            raise AssertionError(f"1M sweep: {f} from the grown store differs from the "
                                 f"{WIDE_STORE}-slot store's")
    del big
    # the pipeline's sort of these edges, its engine still held as in a
    # pipeline run: its time and peak device memory
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t_s = time.perf_counter()
    ordered, dcols = edges.sorted_on(dev)
    sort_s = time.perf_counter() - t_s
    sort_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    wide_host_kernels(dev, al, ordered, dcols)
    del dcols
    torch.cuda.empty_cache()
    t_rc = time.perf_counter()
    rows = sorted({0, T} | set(again) | set(
        (np.random.default_rng(0).choice(L // T, RECOUNT_ROWS, replace=False) * T).tolist()))
    w64 = torch.from_numpy(w).to(dev)
    n_pairs, dmax, rc32, rc64 = check_recount(edges, engine, w64, rows, thr)
    rc_s = time.perf_counter() - t_rc
    count = lambda t: int(np.count_nonzero(edges.mi > t))
    n_above = count(thr)
    n64, d64, n_band64 = f64_count(engine, w64, edges, thr, WIDE_MARGIN / 2)
    if d64 >= WIDE_MARGIN / 2:
        raise AssertionError(f"1M sweep: max |mi - float64| {d64} over the band")
    del engine
    torch.cuda.empty_cache()
    t_ck = time.perf_counter()
    check_desc_order(edges, ordered, dev)
    del ordered
    torch.cuda.empty_cache()
    print(f"# 1M width: the pipeline's device sort of the {edges.n_edges} edges in {sort_s:.2f} s "
          f"(engine held), peak device memory {sort_gib:.3f} GiB; checked on the card in "
          f"{time.perf_counter() - t_ck:.2f} s: the sweep's edges, mi and wog once each, in "
          "descending mi with ties by (ipos, jpos)", flush=True)
    # the reference's count: the MI this sweep's WIDE_EDGES largest exceed,
    # and each printed group's count there against the reference's
    k = edges.n_edges - WIDE_EDGES - 1
    if k < 0:
        raise AssertionError(f"1M sweep: {edges.n_edges} edges above {thr} - {WIDE_MARGIN}, "
                             f"fewer than the reference's {WIDE_EDGES} above {thr}")
    t_ref = float(np.partition(edges.mi, k)[k])
    groups = reference_groups(L, T, rw, Lp)
    ref = np.array([g[2] for g in groups])
    per = group_counts(edges, groups, T, rw, Lp, (thr, thr - WIDE_BAND, thr + WIDE_BAND, t_ref,
                                                  t_ref - WIDE_BAND, t_ref + WIDE_BAND))
    n_lo, n_hi = count(thr - WIDE_BAND), count(thr + WIDE_BAND)
    pairs = L * (L - 1) / 2
    print(f"# 1M width S={S} L={L} codes, row_window {rw}, Lp {Lp}: engine built in "
          f"{build_s:.2f} s; sweep at {thr} - {WIDE_MARGIN}: {edges.n_edges} edges in {dt:.2f} s "
          f"= {pairs / dt:.4g} column pairs/s, compute_s {tm['compute_s']:.2f}, fetch_s "
          f"{tm['fetch_s']:.2f}, wog_s {tm['wog_s']:.2f} (pairs path {tm['wog_pairs_s']:.4f} for "
          f"{tm['wog_candidates']} candidates), expand_s {tm['expand_s']:.2f}, n_items "
          f"{tm['n_items']}, rows swept again {again}; peak device memory {gib:.3f} GiB; "
          f"launches {launches}", flush=True)
    print(f"# 1M width from a {WIDE_STORE}-slot store: the same EdgeSet in {dt_big:.2f} s, "
          f"compute_s {tm_big['compute_s']:.2f}, no row swept again, peak device memory "
          f"{gib_big:.3f} GiB", flush=True)
    print(f"# 1M width float64 recount of {len(rows)} whole block-rows {rows}: {n_pairs} pairs "
          f"above {thr - WIDE_MARGIN / 2}, every one stored, max |mi - float64| {dmax:.3e}; "
          f"above {thr}: sweep {rc32}, float64 {rc64} ({rc_s:.1f} s)", flush=True)
    print(f"# 1M width: {n_above} edges above {thr}; float64 count {n64} (the stored edges "
          f"within {WIDE_MARGIN / 2} of it recounted: {n_band64}, max |d| {d64:.3e})", flush=True)
    print(f"# 1M width against the reference's {len(groups)} printed groups "
          f"({sum(len(g[3]) for g in groups)} items): reference {int(ref.sum())}, this sweep "
          f"{int(per[0].sum())} ({100 * (per[0].sum() / ref.sum() - 1):+.3f}%), band +-{WIDE_BAND} "
          f"[{int(per[2].sum())}, {int(per[1].sum())}]; per group (reference, sweep): "
          + " ".join(f"{a}/{b}" for a, b in zip(ref.tolist(), per[0].tolist())), flush=True)
    print(f"# 1M width at {t_ref:.8f}, where this sweep has the reference's count: each "
          f"printed group's reference count inside its band +-{WIDE_BAND}; (reference - sweep) "
          "per group: " + " ".join(str(x) for x in (ref - per[3]).tolist()), flush=True)
    print(f"# 1M width: reference {WIDE_EDGES}, difference {n_above - WIDE_EDGES:+d} "
          f"({100 * (n_above / WIDE_EDGES - 1):+.3f}%); band +-{WIDE_BAND}: [{n_hi}, {n_lo}], "
          f"{n_lo - n_hi} edges, reference {'inside' if n_hi <= WIDE_EDGES <= n_lo else 'outside'}"
          f"; this sweep reaches the reference's count at MI {t_ref:.8f}, {thr - t_ref:.3e} "
          "below the threshold", flush=True)
    off = np.nonzero((ref < per[5]) | (ref > per[4]))[0]
    if len(off) or t_ref - WIDE_BAND <= thr - WIDE_MARGIN:
        raise AssertionError(f"1M sweep: at {t_ref}, where this sweep has the reference's "
                             f"count, reference groups {off.tolist()} lie outside the "
                             f"+-{WIDE_BAND} band of its count (or that band reaches below "
                             f"the sweep's {thr - WIDE_MARGIN})")
    return dt, tm, gib


def phase_bench(smi, main_thr, main_edges, main_sweep_s, main_launches, L=L_BENCH):
    """Phase 13: ``python -m spydrpick_torch.bench`` at its default shape
    with BENCH_E2E_RUNS warm runs, held to phases 1 and 5."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env["BENCH_E2E_RUNS"] = str(BENCH_E2E_RUNS)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "spydrpick_torch.bench"], env=env,
                         cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                         text=True, timeout=BENCH_TIMEOUT)
    wall = time.perf_counter() - t0
    last = (res.stdout.strip().splitlines() or [""])[-1]
    if res.returncode != 0 or not last.startswith("{"):
        raise AssertionError(f"bench: rc {res.returncode}\n{res.stdout[-3000:]}\n"
                             f"{res.stderr[-3000:]}")
    line = json.loads(last)
    cfg, e2e = line["config"], line["config"]["end_to_end_s"]
    name, limit = (x.strip() for x in smi.rsplit(",", 1))
    want = {"backend": "cuda", "device": name, "power_limit": limit}
    got = {k: cfg[k] for k in want}
    if got != want:
        raise AssertionError(f"bench ran on {got}, phase 1 saw {want}")
    if (e2e["edges"], f"{e2e['mi_threshold']:.6f}") != (main_edges, f"{main_thr:.6f}"):
        raise AssertionError(f"bench end to end: {e2e['edges']} edges at "
                             f"{e2e['mi_threshold']}, phase 5: {main_edges} at {main_thr}")
    n_rows = -(-L // TILE)
    per_row = {"mi_tile_single": n_rows, "row_select": n_rows, "mi_tile_dual": 0,
               "crosstab_tile": 0, "mi_epilogue": 0, "aracne_flags": 1,
               "format_couplings_rows": 1, "column_state_counts": main_launches[
                   "column_state_counts"], "pairs_xtab": main_launches["pairs_xtab"]}
    if len(e2e["launches_all"]) != BENCH_E2E_RUNS or any(
            run != per_row for run in e2e["launches_all"]):
        raise AssertionError(f"bench warm runs launched {e2e['launches_all']}, expected "
                             f"{per_row} each (the lead-in's as in phase 5)")
    busy, tr = e2e["busy_share"], e2e["traced_run"]
    if not isinstance(busy, float) or not 0 < busy <= 1:
        raise AssertionError(f"bench: the traced warm run's busy share is {busy}")
    if not main_sweep_s / 2 <= cfg["sweep_seconds"] <= 2 * main_sweep_s:
        raise AssertionError(f"bench sweep {cfg['sweep_seconds']} s against phase 5's "
                             f"sweep_s {main_sweep_s} s")
    print(f"# bench S={cfg['samples']} L={cfg['loci']} {cfg['int8_mode']} on {cfg['device']}, "
          f"{cfg['power_limit']}: {line['value']:.1f} column pairs/s (sweep "
          f"{cfg['sweep_seconds']} s, {cfg['sweep_method']}; {cfg['edges']} edges at "
          f"{cfg['threshold']}; sweep peak {cfg['sweep_peak_gib']} GiB); end to end median "
          f"{e2e['total_s']} s of {e2e['total_s_all']} (cold {e2e['cold_total_s']} s), "
          f"{e2e['edges']} edges at {e2e['mi_threshold']} as phase 5, peak GiB "
          f"{e2e['peak_gib_all']}; K1 and B2 {n_rows} per warm run, the ARACNE and formatter "
          f"kernels once, the counts {per_row['column_state_counts']} and the pairs' "
          f"crosstables {per_row['pairs_xtab']} times as in phase 5; {wall:.1f} s", flush=True)
    print("# bench stage medians (s): " + ", ".join(f"{k} {e2e[k]}" for k in BENCH_STAGES)
          + f"; preprocess phases {e2e['preprocess_phases']}; threshold phases "
          f"{e2e['threshold_phases']}; sweep phases "
          f"{e2e['sweep_phases']}; aracne phases {e2e['aracne_phases']}; write phases "
          f"{e2e['write_phases']}", flush=True)
    print(f"# bench traced warm run: device busy share {busy} (wall {tr['wall_s']} s, busy "
          f"{tr['busy_s']} s, lead-in {tr['lead_s']} s, longest gap {tr['max_gap_s']} s)",
          flush=True)


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--rank":
        return rank_main(sys.argv[2:])
    if len(sys.argv) > 2 and sys.argv[1] == "--rank-killed":
        return rank_main(sys.argv[3:], kill_after_saves=int(sys.argv[2]))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to PyTorch", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 yardsticks and plain versions
    from spydrpick_torch.stage_profile import bench_alignment, write_inputs

    smi = phase_env()
    k1_err = phase_k1(dev)
    b3_err = phase_b3(dev)
    b4_err, b5_err = phase_split(dev)
    with tempfile.TemporaryDirectory() as td:
        codes, w = bench_alignment(S_BENCH, L_BENCH, seed=0)
        fasta, wfile = write_inputs(td, "bench", codes, w)
        del codes
        k1_main_err, k1, b3_main_err, b3, split_err, split_ms = phase_k1_main(dev, fasta, wfile)
        b2_err, b2 = phase_b2(dev, fasta, wfile)
        phase_parity(dev, td)
        launches, main_out, main_sweep_s, main_thr, main_edges = phase_main(dev, td, fasta,
                                                                             wfile)
        dual_launches, dual_err, lazy, al = phase_dual_sweep(dev, fasta, wfile)
        phase_sort(dev, lazy)
        host_err, host_ms = phase_host_kernels(dev, al, lazy)
        lead_err, lead_ms = phase_lead_in(dev, al, launches)
        del lazy, al
        phase_checkpoint(dev, td, fasta, wfile, main_out, main_sweep_s)
        phase_rows_sharded(td, fasta, wfile, main_out)
        split_launches = phase_samples_sharded(dev, td)
        phase_rows_sharded_checkpoint(td, fasta, wfile, main_out)  # phase 12: phase 5's files
        t_wide = time.perf_counter()
        phase_wide_cut(dev, td)
        print(f"# phase 10 in {time.perf_counter() - t_wide:.1f} s", flush=True)
    t_wide = time.perf_counter()
    phase_full_width(dev)
    print(f"# phase 11 in {time.perf_counter() - t_wide:.1f} s; chip_smoke so far "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    t_bench = time.perf_counter()
    phase_bench(smi, main_thr, main_edges, main_sweep_s, launches)
    print(f"# phase 13 in {time.perf_counter() - t_bench:.1f} s; chip_smoke in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    kernels = [
        {"name": "mi_tile_single", "route": "cuda", "source": "spydrpick_torch/csrc/xtab_mma.cu",
         "replaces": "spydrpick_tpu/ops/mi_pallas.py:279",
         "launches": launches["mi_tile_single"], "max_abs_err": max(k1_err, k1_main_err), **k1},
        {"name": "row_select", "route": "cuda", "source": "spydrpick_torch/csrc/row_select.cu",
         "replaces": "spydrpick_tpu/ops/compact_route.py:111",
         "launches": launches["row_select"], "max_abs_err": b2_err, **b2},
        {"name": "mi_tile_dual", "route": "cuda", "source": "spydrpick_torch/csrc/xtab_mma.cu",
         "replaces": "spydrpick_tpu/ops/mi_pallas.py:523",
         "launches": dual_launches["mi_tile_dual"],
         "max_abs_err": max(b3_err, b3_main_err, dual_err), **b3},
        {"name": "crosstab_tile", "route": "cuda", "source": "spydrpick_torch/csrc/xtab_mma.cu",
         "replaces": "spydrpick_tpu/ops/mi_pallas.py:404",
         "launches": sum(x["crosstab_tile"] for x in split_launches),
         "max_abs_err": max(b4_err, split_err[0]), **split_ms["b4"]},
        {"name": "mi_epilogue", "route": "cuda", "source": "spydrpick_torch/csrc/xtab.cu",
         "replaces": "spydrpick_tpu/ops/mi_pallas.py:468",
         "launches": sum(x["mi_epilogue"] for x in split_launches),
         "max_abs_err": max(b5_err, split_err[1]), **split_ms["b5"]},
        {"name": "aracne_flags", "route": "cuda", "source": "spydrpick_torch/csrc/aracne.cu",
         "replaces": "spydrpick_tpu/native/aracne.cpp:33",
         "launches": launches["aracne_flags"], "max_abs_err": host_err["aracne"],
         **host_ms["aracne"]},
        {"name": "format_couplings_rows", "route": "cuda",
         "source": "spydrpick_torch/csrc/format_rows.cu",
         "replaces": "spydrpick_tpu/native/format.cpp:42",
         "launches": launches["format_couplings_rows"], "max_abs_err": host_err["format"],
         **host_ms["format"]},
        {"name": "column_state_counts", "route": "cuda",
         "source": "spydrpick_torch/csrc/column_counts.cu",
         "replaces": "spydrpick_torch/core/alignment.py:70",
         "launches": launches["column_state_counts"],
         "max_abs_err": lead_err["column_state_counts"], **lead_ms["column_state_counts"]},
        {"name": "pairs_xtab", "route": "cuda", "source": "spydrpick_torch/csrc/pairs_xtab.cu",
         "replaces": "spydrpick_tpu/engine/solver.py:862",
         "launches": launches["pairs_xtab"], "max_abs_err": lead_err["pairs_xtab"],
         **lead_ms["pairs_xtab"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
