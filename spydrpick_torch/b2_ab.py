"""Kernel B2's main-path time in two checkouts of this repository, in
turns on one card.

    python -m spydrpick_torch.b2_ab PARENT_DIR CHANGE_DIR [--turns 2]

Each turn runs PARENT_DIR, CHANGE_DIR, CHANGE_DIR, PARENT_DIR (``--turns
1``: parent, then change), each in a process of its own started in that
checkout: it builds the checkout's kernels (``spydrpick_torch.ops.
cuda_build``), writes the S=3000 x L=30720 bench alignment and runs that
checkout's chip_smoke.py phase 3 (``phase_b2``): B2 held to its plain
version, and timed by chip_smoke's ``cuda_time_ms`` on the engine's lazy
block-row at i0 = 0 and the tournament's threshold (the figure of the
``kernels`` line).  Prints each run's phase 3 lines, then one JSON line
per run with that time, and the change's best time against the parent's.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = """
import json, sys, tempfile, torch
sys.path.insert(0, ".")
import chip_smoke
from spydrpick_torch.ops import cuda_build
from spydrpick_torch.stage_profile import bench_alignment, write_inputs
torch.backends.cuda.matmul.allow_tf32 = False
cuda_build.build()
cuda_build.load()
with tempfile.TemporaryDirectory() as td:
    codes, w = bench_alignment(chip_smoke.S_BENCH, chip_smoke.L_BENCH, seed=0)
    fasta, wfile = write_inputs(td, "bench", codes, w)
    _, main = chip_smoke.phase_b2(torch.device("cuda:0"), fasta, wfile)
print("B2_AB " + json.dumps(main))
"""


def run(tree: str) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=tree, capture_output=True,
                         text=True, timeout=1200)
    sys.stdout.write("".join(l + "\n" for l in out.stdout.splitlines() if "B2" in l))
    if out.returncode:
        sys.stderr.write(out.stderr[-4000:])
        raise SystemExit(f"b2_ab: phase 3 of {tree} failed ({out.returncode})")
    return json.loads(out.stdout.rsplit("B2_AB ", 1)[1].splitlines()[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m spydrpick_torch.b2_ab",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--turns", type=int, default=2, choices=(1, 2))
    args = ap.parse_args(argv)
    order = [("parent", args.parent), ("change", args.change)]
    if args.turns == 2:
        order += order[::-1]
    best = {}
    for label, tree in order:
        r = run(os.path.abspath(tree))
        best[label] = min(best.get(label, r["ms"]), r["ms"])
        print(json.dumps({"tree": label, "dir": tree, "b2_main_path_ms": r["ms"],
                          "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"]}), flush=True)
    print(json.dumps({"b2_change_over_parent": best["change"] / best["parent"], **best}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
