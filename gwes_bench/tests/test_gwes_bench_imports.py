"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program.  Top-level module names are
compared whole: the program's name begins with the JAX package's."""

from __future__ import annotations

import subprocess
import sys

from gwes_bench.cells import ROOT

JAX_NAMES = ("jax", "jaxlib", "flax", "spydrpick_tpu")

RUN = """
import os, sys, torch
os.environ["SPYDRPICK_TORCH_DEVICE"] = "cpu"
from gwes_bench import run
from gwes_bench.cells import resolve
cell = resolve("scan-3k-30k")
cell.config = dict(cell.config, samples=120, loci=720, kept=512)
line = run.execute(cell, 5, 0.001, False, torch.device("cpu"), 0.0)
assert line["correct"], line
import gwes_bench.control, gwes_bench.trace
print(sorted({m.split(".")[0] for m in sys.modules}))
"""

REFERENCE = """
import sys
import gwes_bench.reference.judge, gwes_bench.reference.scan
import gwes_bench.reference.render, gwes_bench.reference.options
print(sorted({m.split(".")[0] for m in sys.modules}))
"""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_module():
    names = _top_level(RUN)
    assert "spydrpick_torch" in names
    assert not names & set(JAX_NAMES)


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level(REFERENCE)
    assert not names & {"spydrpick_torch", *JAX_NAMES}


def test_the_forbidden_module_check_compares_whole_names():
    from gwes_bench.run import forbidden_modules

    before = set(sys.modules)
    sys.modules["spydrpick_torch_like"] = sys
    try:
        assert "spydrpick_torch_like" not in forbidden_modules()
        sys.modules["jax.numpy"] = sys
        assert "jax" in forbidden_modules()
    finally:
        for m in ("spydrpick_torch_like", "jax.numpy"):
            if m not in before:
                sys.modules.pop(m, None)
