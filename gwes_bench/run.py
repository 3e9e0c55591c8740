"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 gwes_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m gwes_bench.run ...``), from the root of a checkout, on
a machine with as many CUDA cards as the cell asks for.

Set-up: the CUDA context; the cell's alignment generated from ``--seed``
on the card (``generate.py``) and written as a FASTA into a directory of
its own under the temporary directory (``TMPDIR``); one whole scan as
the warm-up, which in a checkout's first run also builds the program's
libraries into ``build/`` of the checkout (``setup_s`` then holds the
build, as it does for a user's first call; standard error says whether
the run built them).  Window:
whole scans back to back, one at a time, until ``--seconds`` have
passed, each ``spydrpick_torch.pipeline.run_pipeline`` with the
``PipelineOptions`` that ``python -m spydrpick_torch`` builds from the
cell's command line, writing into a fresh output directory that is
deleted after the scan, except the one scan kept for the check: a scan
drawn uniformly from the window's scans by the seed (reservoir
sampling).  ``--trace 1`` runs the window under torch.profiler
(``trace.py``).

After the window: the scans' results are freed, the kept scan is judged
against the plain reference on the card (``reference/judge.py``), and
the last line of standard output is one JSON object: ``correct``,
``attempted`` (the window's scans), ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics, each
read by ``metrics/<name>.py``), ``device``, with ``--trace 1`` the
``breakdown``, and last ``checks``: each number compared, with its
limit.  The same numbers end standard error.

A cell whose ``chips`` is N > 1 runs as N ranks of the program on this
host, a card each, as ``torchrun --nproc-per-node N -m spydrpick_torch``
runs them: this process re-executes itself under PyTorch's launcher
(``ranks.py``), and each rank runs ``run.py`` again.  Rank 0, on
``cuda:0``, makes the alignment and writes the FASTA that every rank
reads, says before each scan whether the window goes on, so that every
rank runs the same scans, and prints the result.  What such a run
reports:

  * ``scan_s`` and ``setup_s``: rank 0's host clock; ``setup_s`` runs
    from this process's start (passed to the ranks in
    ``GWES_BENCH_STARTED_AT``; ``time.perf_counter`` is the host's
    monotonic clock, one for all its processes), so it holds the launcher, every rank's
    start and the rendezvous;
  * ``peak_device_gib`` and ``device.memory_peak_bytes``: the largest
    ``max_memory_allocated`` of any rank over the window (every rank
    resets its peak after the warm-up): the fullest card;
  * the per-layer metrics: rank 0's spans; ``--trace 1`` traces rank 0
    alone, so ``device_idle_share``, ``busy_s``, ``window_s`` and the
    ``breakdown`` are rank 0's card's, and ``k1_roofline_share`` counts
    the pairs of the block-rows that rank 0 swept;
  * ``device.count``: the number of ranks;
  * ``scans_differ``: also each scan of another rank whose (edges,
    threshold, kept columns) differ from rank 0's scan of the same index.

A scan that raises on one rank, or a rank that dies, ends such a run:
the launcher stops every rank and exits with code 1, naming the rank
(``ranks.py``); with one rank a scan that raises counts in ``failed``.

Exit codes: 0 with a result; 2 without CUDA or with fewer cards than the
cell asks for; 3 when a rank holds JAX or the JAX package after the
window; 4 when the program cannot be imported; with several ranks, 1
from the launcher in place of any rank's code but 0.  None of these print
a result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
if __package__ in (None, ""):
    sys.path.insert(0, str(ROOT))

# every build and kernel cache at a fixed path inside the checkout
CACHE_DIRS = {"TRITON_CACHE_DIR": "build/triton", "TORCH_EXTENSIONS_DIR": "build/torch_extensions",
              "CUDA_CACHE_PATH": "build/cuda_cache"}
FORBIDDEN = ("jax", "jaxlib", "flax", "spydrpick_tpu")


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules that the benchmark may not load."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def log(*msg) -> None:
    print("gwes_bench:", *msg, file=sys.stderr, flush=True)


def scan_options(argv: list[str]):
    """``PipelineOptions`` as ``python -m spydrpick_torch`` builds them from
    ``argv``: its parser's values under the options' names."""
    from spydrpick_torch.cli import build_parser
    from spydrpick_torch.pipeline import PipelineOptions

    args = build_parser().parse_args(argv)
    return PipelineOptions(**{f.name: getattr(args, f.name)
                              for f in dataclasses.fields(PipelineOptions)})


def scan_output(res, out_dir: str):
    from gwes_bench.reference.judge import ScanOutput

    e = res.edges
    return ScanOutput(kept=res.alignment.translation, threshold=res.mi_threshold,
                      ipos=e.ipos, jpos=e.jpos, mi=e.mi, wog=e.mi_wog, colmax=e.colmax,
                      flags=res.flags, out_dir=out_dir)


def card_power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip().splitlines()
        return out[0].rsplit(",", 1)[1].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not measured"


def execute(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run of ``cell`` on ``device``, as rank 0 of ``cell.chips`` ranks
    (module docstring); returns the result's line as a dict, ``checks``
    last."""
    import numpy as np
    import torch

    from gwes_bench import generate, ranks
    from gwes_bench.cells import reader
    from gwes_bench.record import Run
    from gwes_bench.reference import options as ref_options
    from gwes_bench.reference.judge import Inputs, judge
    from spydrpick_torch.pipeline import run_pipeline

    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    work = tempfile.mkdtemp(prefix="gwes_bench.")
    multi = cell.chips > 1
    ctrl = None  # the control group of a run of several ranks
    dealt: list = []  # rank 0's block-rows, each scan's (tile, rows), with ranks
    patches = contextlib.ExitStack()
    try:
        built = _libraries()
        if multi:
            patches.enter_context(ranks.dealt_rows(dealt))
        codes = generate.alignment(cell.config, cell.traffic, seed, device)
        fasta = generate.write_fasta(work, codes)
        argv = generate.scan_args(cell.config, cell.traffic, fasta, seed)
        log(f"{cell.name}: {codes.shape[0]} x {codes.shape[1]} alignment written in "
            f"{time.perf_counter() - t_start:.3f} s; warm-up scan")
        if multi:
            _, _, info, ctrl = ranks.join(argv, work)
            log(f"{info['process_count']} ranks joined in "
                f"{time.perf_counter() - t_start:.3f} s: backend {info['backend']}, "
                f"rank 0 on {info['device']}")

        def scan():
            out = tempfile.mkdtemp(prefix="scan.", dir=work)
            tm: dict = {}
            res = run_pipeline(scan_options([*argv, "--output-dir", out]), timings=tm)
            return res, tm, out

        t0 = time.perf_counter()
        res, _, out = scan()
        kept_columns = len(res.alignment.translation)
        del res
        shutil.rmtree(out)
        sync()
        log(f"warm-up scan {time.perf_counter() - t0:.3f} s, "
            + ("the program's libraries built in it (a checkout's first run)"
               if _libraries() != built else "no library built"))
        if multi:
            tile, rows = dealt[-1]
            dealt.clear()
            log(f"the sweep ran over {cell.chips} ranks: rank 0 swept {len(rows)} of "
                f"{-(-kept_columns // tile)} block-rows")
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        pick = np.random.default_rng([seed, 1])
        state = {"scans": [], "kept": None, "summary": [], "failed": 0}

        go = (lambda more: more) if ctrl is None else (lambda more: ranks.go(ctrl, more))

        def window():
            t0 = time.perf_counter()
            while go(time.perf_counter() - t0 < seconds):
                try:
                    res, tm, out = scan()
                except Exception as exc:  # the scan failed: counted, the window ends
                    log(f"scan {len(state['scans']) + 1} failed: {exc!r}")
                    if multi:  # the other ranks may wait inside it: the launcher ends them
                        raise
                    state["failed"] += 1
                    break
                state["scans"].append(tm)
                state["summary"].append(ranks.summary(res))
                if pick.random() * len(state["scans"]) < 1.0:
                    if state["kept"] is not None:
                        shutil.rmtree(state["kept"].out_dir)
                    state["kept"] = scan_output(res, out)
                    state["kept_index"] = len(state["scans"]) - 1
                else:
                    shutil.rmtree(out)
                del res
            return time.perf_counter() - t0

        t_window = time.perf_counter()
        setup_s = t_window - t_start
        tr = None
        if trace:
            from gwes_bench.trace import profile_window

            window_s, tr = profile_window(window, work)
        else:
            window_s = window()
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        reports = ranks.reports(ctrl) if multi else []
        if multi:  # the other ranks have ended: the check may use every core
            torch.set_num_threads(len(os.sched_getaffinity(0)))
        held = {0: forbidden_modules(), **{w["rank"]: w["forbidden"] for w in reports}}
        held = {r: m for r, m in held.items() if m}
        if held:
            raise ForbiddenModules(held)
        scans, kept = state["scans"], state["kept"]
        if reports:
            log("ranks' scans in the window: " + " ".join(
                str(n) for n in [len(scans)] + [len(w["scans"]) for w in reports])
                + "; ranks' peaks (GiB): " + " ".join(
                f"{p / 2**30:.4f}" for p in [peak] + [w["peak"] for w in reports]))
            peak = max([peak] + [w["peak"] for w in reports])
        log(f"window: {len(scans)} scans in {window_s:.3f} s; peak {peak / 2**30:.4f} GiB; "
            f"setup {setup_s:.3f} s")
        log("bytes written since the start (/proc/self/io write_bytes, of them deleted "
            "before the disk saw them: cancelled_write_bytes): " + _io_written())
        for k in ("total_s", "preprocess_s", "threshold_s", "sweep_s", "write_s"):
            log(f"scans' {k}: " + " ".join(f"{tm.get(k, float('nan')):.3f}" for tm in scans))
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        checks = {}
        if kept is not None:
            t0 = time.perf_counter()
            inputs = Inputs(codes=codes, id_string=generate.FASTA_NAME.split(".")[0],
                            names=generate.sample_names(codes.shape[0]),
                            params=ref_options.parse(argv))
            parts: dict = {}
            nums = judge(inputs, [kept], device, timings=parts)[0]
            nums["scans_differ"] = float(
                sum(s != state["summary"][state["kept_index"]] for s in state["summary"])
                + sum(_differing(state["summary"], w["scans"]) for w in reports))
            checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in nums.items()
                      if k in cell.limits}
            log(f"checked scan {state['kept_index'] + 1} of {len(scans)} against the "
                f"reference in {time.perf_counter() - t0:.3f} s ("
                + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()) + ")")
        correct = (bool(scans) and not state["failed"] and bool(checks)
                   and all(c["value"] <= c["limit"] for c in checks.values()))

        loci = state["summary"][0][2] if scans else 0
        run = Run(samples=codes.shape[0], loci=loci, scans=scans, window_s=window_s,
                  setup_s=setup_s, peak_bytes=peak,
                  device_name=torch.cuda.get_device_name(device) if cuda else "cpu",
                  trace=tr, swept_rows=dealt[:len(scans)] if multi else None)
        metrics = {}
        for m in (cell.per_layer if trace else cell.end_to_end):
            value = reader(m["name"])(run) if scans else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = {"platform": "gpu" if cuda else "cpu", "kind": run.device_name,
               "count": cell.chips, "memory_peak_bytes": int(peak)}
        if cuda:
            dev["power_limit"] = card_power_limit()
        line = {"correct": correct, "attempted": len(scans) + state["failed"],
                "failed": state["failed"] + (0 if correct or not scans else 1),
                "metrics": metrics, "device": dev}
        if tr is not None:
            dev["busy_s"] = tr.busy_s
            dev["window_s"] = tr.window_s
            ops = sorted(tr.kernel_s.items(), key=lambda kv: -kv[1])[:10]
            line["breakdown"] = {"device_ops": [[k, v] for k, v in ops],
                                 "idle_gaps": [[k, v] for k, v in tr.gaps]}
        line["checks"] = checks
        return line
    finally:
        patches.close()
        shutil.rmtree(work, ignore_errors=True)


def _differing(mine: list, theirs: list) -> int:
    """Another rank's scans whose summary differs from rank 0's scan of the
    same index, a scan that one of the two lacks counted as differing."""
    return sum(a != b for a, b in zip(mine, theirs)) + abs(len(mine) - len(theirs))


def _io_written() -> str:
    try:
        with open("/proc/self/io") as f:
            io = dict(line.split(": ") for line in f.read().splitlines())
        return f"{int(io['write_bytes'])} {int(io['cancelled_write_bytes'])}"
    except (OSError, KeyError, ValueError):
        return "not measured"


def _libraries() -> dict:
    """The program's built libraries under ``build/`` of the checkout,
    each with its modification time: a first run's set-up builds them."""
    return {str(f): f.stat().st_mtime_ns for f in (ROOT / "build").rglob("*.so")}


class ForbiddenModules(RuntimeError):
    pass


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="gwes_bench/run.py", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def report(line: dict) -> None:
    """The checks as the last lines of standard error, then the line as
    the last line of standard output.  A number that is not finite (an
    invalid edge reads inf) is printed as the largest double, so that the
    line stays strict JSON."""
    for c in line["checks"].values():
        if not math.isfinite(c["value"]):
            c["value"] = sys.float_info.max
    for name, c in line["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {ok}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line, allow_nan=False), flush=True)


STARTED_AT = "GWES_BENCH_STARTED_AT"  # the run's start, for the ranks of several


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse_args(argv)
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / rel)
    os.environ.pop("SPYDRPICK_TORCH_DEVICE", None)  # the program runs on the card
    from gwes_bench.cells import resolve

    cell = resolve(args.workload)
    if cell.chips > 1 and STARTED_AT not in os.environ:
        # the ranks check the cards below, so that torch is imported once a process
        from gwes_bench.ranks import launcher

        os.environ[STARTED_AT] = repr(T_START)
        sys.stderr.flush()
        os.execv(sys.executable, launcher(cell.chips, str(pathlib.Path(__file__).resolve()),
                                          argv))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
        return 2
    return run_rank(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda:0"),
                    float(os.environ.get(STARTED_AT, T_START)))


def run_rank(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> int:
    """This process's part of a run: the whole run with one rank; rank 0
    (which reports, on ``device``) or a worker (``ranks.worker``, on the
    card of its ``LOCAL_RANK``) with several."""
    try:
        import spydrpick_torch.pipeline  # noqa: F401
    except ImportError as exc:
        log(f"cannot import the program: {exc!r}")
        return 4
    if cell.chips > 1 and int(os.environ["RANK"]) > 0:
        from gwes_bench.ranks import worker

        return worker()
    try:
        line = execute(cell, seed, seconds, trace, device, t_start)
    except ForbiddenModules as exc:
        log("after the window " + "; ".join(f"rank {r} holds {m}"
                                            for r, m in exc.args[0].items()))
        return 3
    if forbidden_modules():
        log(f"the process holds {forbidden_modules()} after the window")
        return 3
    report(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
