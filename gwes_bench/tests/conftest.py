"""Fixtures of the benchmark's tests.  Tests that need the card carry the
``gpu`` marker and ask for the ``cuda`` fixture, which skips them when no
CUDA card is visible; the check runs inside the fixture, so every worker
collects the same tests.  The CPU tests run the program's CPU path
(``SPYDRPICK_TORCH_DEVICE=cpu``) at a tiny size; a run of several ranks
(``ranks_run``) runs as ``gloo`` ranks on the CPU under PyTorch's
launcher."""

from __future__ import annotations

import os
import subprocess

import pytest

from gwes_bench.cells import ROOT

RANKS = """
import sys, time
sys.path.insert(0, {root!r})
import torch
from gwes_bench import run
from gwes_bench.cells import resolve
cell = resolve("scan-3k-92k-4gpu")
cell.config = dict(cell.config, samples=160, loci=900, kept=640)
cell.chips = {chips}
sys.exit(run.run_rank(cell, {seed}, {seconds}, False, torch.device("cpu"), time.perf_counter()))
"""


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.fixture
def cpu_program(monkeypatch):
    monkeypatch.setenv("SPYDRPICK_TORCH_DEVICE", "cpu")


@pytest.fixture
def tiny_cell():
    """Makes the cell ``name`` with its alignment cut to ``samples`` x
    ``loci``, ``kept`` of the columns kept by the filter."""
    from gwes_bench.cells import resolve

    def make(name: str = "scan-3k-30k", samples: int = 160, loci: int = 900,
             kept: int = 640):
        cell = resolve(name)
        cell.config = dict(cell.config, samples=samples, loci=loci, kept=kept)
        return cell
    return make


@pytest.fixture
def ranks_run(tmp_path):
    """Starts the sharded cell cut to a tiny size as ``chips`` ranks (the
    cell asks for 4) on the CPU, under the launcher that ``run.py`` uses
    (``ranks.launcher``); returns its ``Popen`` (text pipes), stopped at
    the test's end."""
    from gwes_bench.ranks import launcher

    procs = []

    def start(chips: int = 2, seconds: float = 2.0, seed: int = 2**31 + 41):
        script = tmp_path / "ranks.py"
        script.write_text(RANKS.format(root=str(ROOT), chips=chips, seconds=seconds, seed=seed))
        env = dict(os.environ, SPYDRPICK_TORCH_DEVICE="cpu")
        procs.append(subprocess.Popen(launcher(chips, str(script), []), cwd=ROOT, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
        return procs[-1]
    yield start
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()
