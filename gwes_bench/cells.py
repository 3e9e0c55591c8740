"""Cells of ``BENCHMARK.json`` resolved to their files, by name.

A cell (an entry of ``workloads``) names a configuration, whose entry in
``configs`` gives its file, and a traffic mix, whose file is
``gwes_bench/traffic/<traffic>.json``.  Its metrics are the end-to-end
and per-layer metrics of ``BENCHMARK.json`` that report in it (those
without a ``workloads`` list report in every cell), each read by
``gwes_bench/metrics/<metric>.py``.  Its limits, the bound of each number
that ``correct`` compares, are in ``gwes_bench/limits/<config>.json``;
a number of ``reference/judge.py`` without a limit there is not compared
in the cell.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

PACKAGE = pathlib.Path(__file__).resolve().parent
ROOT = PACKAGE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list     # metric entries of BENCHMARK.json
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, root: pathlib.Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((PACKAGE / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((PACKAGE / "limits" / f"{w['config']}.json").read_text())
    return Cell(name=name, chips=w["chips"], config=config, traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = PACKAGE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "gwes_bench.metrics." + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
