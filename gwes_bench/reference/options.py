"""The scan options the reference reads from a command line of
``python -m spydrpick_torch``: the flags that change what a scan
computes, with the SpydrPick reference's defaults (README "Usage").
``--mi-threshold`` holds the threshold (-1, the default, leaves it to
the tournament; 0 is the CLI's "no threshold") and
``--no-sample-reweighting`` gives every sample the weight 1.  Flags that
tune only how the engine computes are accepted and ignored; any other
flag is refused, so that a traffic mix whose meaning the reference does
not know fails loudly: ``--sample-weights`` among them.
"""

from __future__ import annotations

import argparse

import numpy as np

# flags that change no output: (name, takes a value)
ENGINE_FLAGS = (("--tile", True), ("--mxu-int8", True), ("--store-capacity", True),
                ("--onehot-storage", True), ("--row-window", True), ("--threads", True),
                ("-t", True), ("--checkpoint", True), ("--checkpoint-every", True),
                ("--profile-dir", True), ("--output-dir", True), ("--sharded", False),
                ("--sample-shards", True), ("--edge-capacity", True),
                ("--rows-per-dispatch", True), ("--pipeline-depth", True),
                ("--use-pallas", True), ("--use-pallas-compact", True),
                ("--matmul-precision", True), ("--jax-cache-dir", True),
                ("--aracne-block-size", True), ("--aracne-node-grouping-size", True),
                ("--aracne-outputfile", True), ("-v", False), ("--verbose", False))


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    p.add_argument("alignmentfile")
    p.add_argument("--mi-threshold", type=float, default=-1.0)
    p.add_argument("--mi-values", type=int, default=0)
    p.add_argument("--mi-pseudocount", type=float, default=0.5)
    p.add_argument("--mi-threshold-iterations", type=int, default=10)
    p.add_argument("--mi-threshold-pairs", type=int, default=0)
    p.add_argument("--ld-threshold", type=int, default=0)
    p.add_argument("--no-aracne", action="store_true")
    p.add_argument("--maf-threshold", type=float, default=0.01)
    p.add_argument("--gap-threshold", type=float, default=0.15)
    p.add_argument("--no-filter-alignment", action="store_true")
    p.add_argument("--genome-size", type=int, default=None)
    p.add_argument("--output-indexing-base", type=int, default=1)
    p.add_argument("--linear-genome", action="store_true")
    p.add_argument("--no-sample-reweighting", action="store_true")
    p.add_argument("--sample-reweighting-threshold", type=float, default=0.9)
    p.add_argument("--aracne-edge-threshold", type=float,
                   default=float(np.finfo(np.float64).eps))
    p.add_argument("--seed", type=int, default=42)
    for name, value in ENGINE_FLAGS:
        if value:
            p.add_argument(name, dest="_" + name.strip("-").replace("-", "_"))
        else:
            p.add_argument(name, dest="_" + name.strip("-").replace("-", "_"),
                           action="store_true")
    return p


def parse(argv: list[str]) -> dict:
    """The options of ``argv`` (the arguments after the program's name)
    as a dict of the reference's names."""
    args, rest = parser().parse_known_args(argv)
    if rest:
        raise ValueError(f"the reference does not know the flags {rest}")
    return {k: v for k, v in vars(args).items() if not k.startswith("_")}

