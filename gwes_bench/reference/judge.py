"""The comparison that decides ``correct``: what a scan produced against
the plain reference (``scan.py``, float64).

A scan's output (``ScanOutput``) is judged by these numbers, each held to
a limit of its cell's limits file (``gwes_bench/limits/<config>.json``):

  filter_diff   columns kept by one side only (exact: 0);
  thr_gap       |threshold - reference threshold| / reference threshold
                (a held threshold: the one on the command line, so 0 for a
                sound scan; held at 0, the absolute difference);
  mi_gap        the largest |MI - reference MI| over the scan's edges;
  misplaced     the farthest a pair lies from the reference threshold on
                the wrong side: an edge of the scan whose reference MI is
                at most the reference threshold, or a pair above it that
                the scan lacks; inf for an edge repeated, or with j <= i;
  colmax_gap    the largest |colmax - reference colmax| over the columns
                (colmax over the pairs beyond the LD threshold);
  wog_gap       the largest |gaps-excluded MI - reference| over the edges
                at or above the outlier threshold (the outliers file's);
  aracne_diff   edges whose flag differs from the reference's DPI rule
                over the scan's own edges (exact: 0);
  couplings_diff, outliers_diff, nodes_diff: lines of each file that
                differ from the reference's rendering of the scan's edges,
                in the reference's order, with the reference's flags and
                outlier thresholds and the scan's MI and gaps-excluded MI,
                plus one for a file named or present otherwise (exact: 0).

The last four follow the scan step by step from its own edges: the
stages they skip (the edges, their MI, colmax and the gaps-excluded MI)
are held to the reference by the numbers above them.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from gwes_bench.reference import render
from gwes_bench.reference.scan import Reference, aracne_direct, desc_order, outlier_thresholds

EXACT = ("filter_diff", "aracne_diff", "couplings_diff", "outliers_diff", "nodes_diff")


@dataclasses.dataclass
class ScanOutput:
    """What one scan produced: its kept columns (original positions), its
    threshold, its edges (filtered column indices, any order), colmax,
    the ARACNE flags (1 = direct) beside the edges, and the directory its
    files are in."""

    kept: np.ndarray
    threshold: float
    ipos: np.ndarray
    jpos: np.ndarray
    mi: np.ndarray
    wog: np.ndarray
    colmax: np.ndarray
    flags: np.ndarray
    out_dir: str


@dataclasses.dataclass
class Inputs:
    """What both sides are handed: the codes the FASTA holds, the
    alignment's id and sample names, and the scan's command line
    (``options.parse``: its seed and its options)."""

    codes: np.ndarray
    id_string: str
    names: list
    params: dict


def _edges_on(out: ScanOutput, L: int, device):
    """The scan's edges on ``device`` in (i, j) order, their keys, and
    whether any is invalid (repeated, j <= i, or out of range)."""
    i = torch.from_numpy(np.asarray(out.ipos, np.int64)).to(device)
    j = torch.from_numpy(np.asarray(out.jpos, np.int64)).to(device)
    m = torch.from_numpy(np.asarray(out.mi, np.float64)).to(device)
    bad = bool(((j <= i) | (i < 0) | (j >= L)).any()) if len(i) else False
    key = i * L + j
    key, order = torch.sort(key)
    if len(key) > 1 and bool((key[1:] == key[:-1]).any()):
        bad = True
    return key, i[order], j[order], m[order], bad


def judge(inputs: Inputs, outputs: list[ScanOutput], device: torch.device,
          timings: dict | None = None) -> list[dict]:
    """Each output's numbers (module docstring), in order, from one pass
    of the reference.  ``timings`` receives the seconds of the
    reference's threshold, its sweep and the files' part."""
    p = inputs.params
    tm = timings if timings is not None else {}
    t0 = time.perf_counter()
    ref = Reference(inputs.codes, p, device)
    thr = ref.save_threshold()
    t1 = time.perf_counter()
    tm["threshold_s"] = t1 - t0
    L = ref.L
    nums = [dict.fromkeys(("filter_diff", "thr_gap", "mi_gap", "misplaced", "colmax_gap",
                           "wog_gap", "aracne_diff", "couplings_diff", "outliers_diff",
                           "nodes_diff"), 0.0) for _ in outputs]
    judged = []
    for n, out in zip(nums, outputs):
        n["filter_diff"] = float(len(np.setxor1d(out.kept, ref.kept)))
        n["thr_gap"] = abs(out.threshold - thr) / (thr if thr > 0 else 1.0)
        ok = n["filter_diff"] == 0 and len(out.colmax) == L
        judged.append(_edges_on(out, L, device) if ok else None)
        if not ok:
            for k in ("mi_gap", "misplaced", "colmax_gap", "wog_gap"):
                n[k] = float("inf")

    colmax = torch.full((L,), -np.inf, dtype=torch.float64, device=device)
    for i0, j0, mi in ref.blocks():
        T, W = mi.shape
        ref.fold_colmax(colmax, i0, j0, mi)
        for n, e in zip(nums, judged):
            if e is None:
                continue
            key, ei, ej, em, _ = e
            lo, hi = torch.searchsorted(key, torch.tensor([i0 * L, (i0 + T) * L],
                                                          device=device)).tolist()
            sel = (ej[lo:hi] >= j0) & (ej[lo:hi] < j0 + W)
            ri, rj, rm = ei[lo:hi][sel] - i0, ej[lo:hi][sel] - j0, em[lo:hi][sel]
            mask = torch.zeros((T, W), dtype=torch.bool, device=device)
            mask[ri, rj] = True
            _update(n, mi, mask, ri, rj, rm, thr)
    colmax_h = colmax.cpu().numpy()
    t2 = time.perf_counter()
    tm["sweep_s"] = t2 - t1

    for n, out, e in zip(nums, outputs, judged):
        if e is None:
            continue
        if e[4]:
            n["misplaced"] = float("inf")
        n["colmax_gap"] = float(np.max(np.abs(out.colmax - colmax_h)))
        _files(n, out, ref, inputs, device)
    tm["files_s"] = time.perf_counter() - t2
    return nums


def _update(n: dict, mi: torch.Tensor, mask: torch.Tensor, ri, rj, rm, thr: float) -> None:
    """Fold one block into mi_gap and misplaced: the reference MI ``mi``,
    the scan's edges in it (``mask``; local rows, columns and MI)."""
    if len(ri):
        r = mi[ri, rj]
        n["mi_gap"] = max(n["mi_gap"], float((rm - r).abs().max()))
        wrong = r <= thr
        if bool(wrong.any()):
            n["misplaced"] = max(n["misplaced"], float((thr - r[wrong]).max()))
    missing = (mi > thr) & ~mask
    if bool(missing.any()):
        n["misplaced"] = max(n["misplaced"], float((mi[missing] - thr).max()))


def _files(n: dict, out: ScanOutput, ref: Reference, inputs: Inputs, device) -> None:
    """wog_gap, aracne_diff and the three files' numbers of one output."""
    p = inputs.params
    base, ld = p["output_indexing_base"], p["ld_threshold"]
    direct = (np.zeros(len(out.mi), np.uint8) if p["no_aracne"] else
              aracne_direct(out.ipos, out.jpos, out.mi, p["aracne_edge_threshold"], ref.L,
                            device))
    n["aracne_diff"] = float(np.count_nonzero(direct != (np.asarray(out.flags) != 0)))
    order = desc_order(out.ipos, out.jpos, out.mi, device)
    ii, jj, mi, wog = out.ipos[order], out.jpos[order], out.mi[order], out.wog[order]
    fl = direct[order]
    thr_out, thr_ext = outlier_thresholds(out.colmax)
    cand = mi >= thr_out
    n["wog_gap"] = 0.0
    if cand.any():
        want = ref.pair_mi(ii[cand], jj[cand], wog=True)
        n["wog_gap"] = float(np.max(np.abs(wog[cand] - want)))
    p1, p2, d = render.positions(ii, jj, ref.kept, base, ref.n_original,
                                 p["linear_genome"])
    nodes = np.unique(np.concatenate([ii[cand], jj[cand]]))
    with_nodes = 0 < len(nodes) < ref.L
    names = render.file_names(inputs.id_string, ref.S, ref.L, len(mi), base, with_nodes)
    want = {"couplings": lambda: render.couplings_bytes(p1, p2, d, fl, mi, device),
            "outliers": lambda: render.outliers_bytes(p1, p2, d, fl, mi, wog, thr_out,
                                                      thr_ext, ld),
            "nodes": lambda: render.fasta_bytes(
                inputs.names, inputs.codes[:, ref.kept[nodes]])}
    present = set(os.listdir(out.out_dir))
    for kind in ("couplings", "outliers", "nodes"):
        key = f"{kind}_diff"
        name = names.get(kind)
        if name is None:
            n[key] = 0.0
            continue
        path = os.path.join(out.out_dir, name)
        if not os.path.isfile(path):
            n[key] = 1.0 + float(len(want[kind]().split(b"\n")))
            continue
        with open(path, "rb") as f:
            n[key] = float(render.lines_differ(f.read(), want[kind]()))
    n["couplings_diff"] += float(len(present - set(names.values())))

