"""Fixtures of the benchmark's tests.  Tests that need the card carry the
``gpu`` marker and ask for the ``cuda`` fixture, which skips them when no
CUDA card is visible; the check runs inside the fixture, so every worker
collects the same tests.  The CPU tests run the program's CPU path
(``SPYDRPICK_TORCH_DEVICE=cpu``) at a tiny size."""

from __future__ import annotations

import pytest


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
