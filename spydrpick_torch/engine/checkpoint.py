"""Tile-range checkpointing for the all-pairs MI sweep (copy of
spydrpick_tpu/engine/checkpoint.py, which cannot be imported without jax).

The sweep is a host loop over independent block-rows, so the checkpoint
is {completed rows, edges so far, colmax so far}, saved atomically every
N rows and validated against the run's parameters on resume.  The key
and the ``.npz`` fields and dtypes are the reference's; a snapshot of the
JAX engine still does not resume here, because that engine pads S to its
Pallas block, and a mismatched key means a fresh run.  Snapshots are
written uncompressed (``np.savez``): each save rewrites every edge so
far, and the reference's ``np.savez_compressed`` put all of them through
zlib each time.  ``np.load`` reads either kind, so each package loads
the other's files.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np


@dataclasses.dataclass
class SweepCheckpoint:
    params_key: str           # hash of (threshold, L, S, tile, flags)
    done_rows: set[int]       # completed block-row starts
    colmax: np.ndarray
    ipos: list[np.ndarray]
    jpos: list[np.ndarray]
    mi: list[np.ndarray]
    mi_wog: list[np.ndarray]


def params_key(statics, threshold: float) -> str:
    # wog_lazy is part of the key: lazy snapshots persist mi
    # PLACEHOLDERS for wog (resolved post-hoc), full snapshots exact
    # values — resuming one mode's snapshot in the other would leave
    # outlier rows with unresolved placeholders.  int8_mode/scale are
    # keyed too: fixed14 MI carries 2^-14 quantisation jitter, so
    # resuming a bf16 snapshot under --mxu-int8 auto (or vice versa)
    # would silently mix two numeric schemes in one edge list
    return (
        f"L={statics.L},S={statics.S},tile={statics.tile},"
        f"thr={threshold!r},pc={statics.pseudocount!r},"
        f"ld={statics.ld_threshold},lin={statics.linear_genome},"
        f"G={statics.genome_size},lazy={statics.wog_lazy},"
        f"i8={statics.int8_mode}:{statics.int8_scale!r}"
    )


def concat(parts: list[np.ndarray], dtype) -> np.ndarray:
    """The parts end to end: the one part itself, uncopied, or an empty
    array of ``dtype`` when there is none."""
    if len(parts) == 1:
        return parts[0]
    return np.concatenate(parts) if parts else np.empty(0, dtype)


def save(path: str, ckpt: SweepCheckpoint) -> None:
    """Atomic save (tmp + rename)."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)) or ".",
                               suffix=".ckpt.tmp")
    os.close(fd)
    np.savez(
        tmp,
        params_key=np.array(ckpt.params_key),
        done_rows=np.array(sorted(ckpt.done_rows), dtype=np.int64),
        colmax=ckpt.colmax,
        ipos=concat(ckpt.ipos, np.int64),
        jpos=concat(ckpt.jpos, np.int64),
        mi=concat(ckpt.mi, np.float64),
        mi_wog=concat(ckpt.mi_wog, np.float64),
    )
    # np.savez appends .npz to the filename
    os.replace(tmp + ".npz", path)
    os.unlink(tmp) if os.path.exists(tmp) else None


def load(path: str, expect_key: str) -> SweepCheckpoint | None:
    """Load and validate; None if missing or parameter mismatch."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        if str(z["params_key"]) != expect_key:
            return None
        return SweepCheckpoint(
            params_key=expect_key,
            done_rows=set(int(r) for r in z["done_rows"]),
            colmax=z["colmax"].copy(),
            ipos=[z["ipos"].copy()] if len(z["ipos"]) else [],
            jpos=[z["jpos"].copy()] if len(z["jpos"]) else [],
            mi=[z["mi"].copy()] if len(z["mi"]) else [],
            mi_wog=[z["mi_wog"].copy()] if len(z["mi_wog"]) else [],
        )
