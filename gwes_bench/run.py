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

Exit codes: 0 with a result; 2 without CUDA or with fewer cards than the
cell asks for; 3 when the process holds JAX or the JAX package after the
window; 4 when the program cannot be imported.  None of these print a
result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
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
    """One run of ``cell`` on ``device`` (module docstring); returns the
    result's line as a dict, ``checks`` last."""
    import numpy as np
    import torch

    from gwes_bench import generate
    from gwes_bench.cells import reader
    from gwes_bench.record import Run
    from gwes_bench.reference import options as ref_options
    from gwes_bench.reference.judge import Inputs, judge
    from spydrpick_torch.pipeline import run_pipeline

    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    work = tempfile.mkdtemp(prefix="gwes_bench.")
    try:
        built = _libraries()
        codes = generate.alignment(cell.config, cell.traffic, seed, device)
        fasta = generate.write_fasta(work, codes)
        argv = generate.scan_args(cell.config, cell.traffic, fasta, seed)
        log(f"{cell.name}: {codes.shape[0]} x {codes.shape[1]} alignment written in "
            f"{time.perf_counter() - t_start:.3f} s; warm-up scan")

        def scan():
            out = tempfile.mkdtemp(prefix="scan.", dir=work)
            tm: dict = {}
            res = run_pipeline(scan_options([*argv, "--output-dir", out]), timings=tm)
            return res, tm, out

        t0 = time.perf_counter()
        res, _, out = scan()
        del res
        shutil.rmtree(out)
        sync()
        log(f"warm-up scan {time.perf_counter() - t0:.3f} s, "
            + ("the program's libraries built in it (a checkout's first run)"
               if _libraries() != built else "no library built"))
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        pick = np.random.default_rng([seed, 1])
        state = {"scans": [], "kept": None, "summary": [], "failed": 0}

        def window():
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                try:
                    res, tm, out = scan()
                except Exception as exc:  # the scan failed: counted, the window ends
                    log(f"scan {len(state['scans']) + 1} failed: {exc!r}")
                    state["failed"] += 1
                    break
                state["scans"].append(tm)
                state["summary"].append((res.edges.n_edges, res.mi_threshold,
                                         len(res.alignment.translation)))
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
        if forbidden_modules():
            raise ForbiddenModules(forbidden_modules())
        scans, kept = state["scans"], state["kept"]
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
            nums["scans_differ"] = float(sum(s != state["summary"][state["kept_index"]]
                                             for s in state["summary"]))
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
                  trace=tr)
        metrics = {}
        for m in (cell.per_layer if trace else cell.end_to_end):
            value = reader(m["name"])(run) if scans else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = {"platform": "gpu" if cuda else "cpu", "kind": run.device_name,
               "count": 1, "memory_peak_bytes": int(peak)}
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
        shutil.rmtree(work, ignore_errors=True)


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


def main(argv=None) -> int:
    args = parse_args(argv)
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / rel)
    os.environ.pop("SPYDRPICK_TORCH_DEVICE", None)  # the program runs on the card
    from gwes_bench.cells import resolve

    cell = resolve(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
        return 2
    try:
        import spydrpick_torch.pipeline  # noqa: F401
    except ImportError as exc:
        log(f"cannot import the program: {exc!r}")
        return 4
    try:
        line = execute(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda:0"),
                       T_START)
    except ForbiddenModules as exc:
        log(f"the process holds {exc.args[0]} after the window")
        return 3
    if forbidden_modules():
        log(f"the process holds {forbidden_modules()} after the window")
        return 3
    report(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
