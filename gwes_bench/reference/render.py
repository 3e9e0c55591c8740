"""The output files of a scan as the reference writes them.

  couplings rows: ``pos1 pos2 distance aracne_flag mi`` with mi as "%.6f"
    of its exact binary value, MI descending;
  outliers rows: ``pos1 pos2 distance flag mi mi_wo_gaps gap_effect
    extreme`` for the edges with mi >= the outlier threshold and distance
    > the LD threshold, gap_effect = (1 - mi_wo_gaps / mi) * 100 at one
    decimal, extreme = mi > the extreme threshold;
  outlier-node FASTA: the columns that an outlier edge touches, every
    sample, 60 symbols a line;
  file names: ``<id>.<S>x<L>.spydrpick_couplings.<base>-based.<E>edges``,
    ``...<base>-based.outliers`` and ``<id>.outlier_nodes.fasta``.

Positions are original genome positions plus the output base; distances
are circular over the genome size unless the genome is linear.  The
couplings rows are assembled with torch ops on the given device, digits
from integer divisions; "%.6f" rounds half to even on the exact value,
so a value that lies within 1e-6 of a half micro-unit is formatted by
Python's exact rule instead.
"""

from __future__ import annotations

import numpy as np
import torch

ALPHABET = np.frombuffer(b"ACGT-", dtype=np.uint8)


def micro_units(mi: np.ndarray) -> np.ndarray:
    """round-half-even(mi * 10^6) of the exact values, int64; mi >= 0."""
    if (mi < 0).any() or not np.isfinite(mi).all():
        raise ValueError("render: mi holds a negative or non-finite value")
    y = mi * 1e6
    q = np.floor(y)
    fr = y - q
    q = q.astype(np.int64) + (fr > 0.5)
    near = np.flatnonzero(np.abs(fr - 0.5) < 1e-6)
    for k in near:
        q[k] = int(("%.6f" % mi[k]).replace(".", ""))
    return q


def _digits(v: torch.Tensor):
    """(chars, valid): v's decimal digits right-aligned in the widest
    value's width, and which of those columns each row prints."""
    width = max(1, len(str(int(v.max())))) if len(v) else 1
    pw = torch.tensor([10 ** k for k in range(width - 1, -1, -1)], dtype=torch.int64,
                      device=v.device)
    chars = ((v[:, None] // pw) % 10 + 48).to(torch.uint8)
    nd = (v[:, None] >= pw).sum(dim=1).clamp_(min=1)
    valid = torch.arange(width, device=v.device)[None, :] >= (width - nd)[:, None]
    return chars, valid


def _const(n: int, text: bytes, device):
    c = torch.tensor(list(text), dtype=torch.uint8, device=device).expand(n, len(text))
    return c, torch.ones_like(c, dtype=torch.bool)


def couplings_bytes(p1: np.ndarray, p2: np.ndarray, dist: np.ndarray, flags: np.ndarray,
                    mi: np.ndarray, device: torch.device, chunk: int = 1 << 22) -> bytes:
    """The couplings file's rows, in the given order."""
    q = micro_units(mi)
    parts = []
    for lo in range(0, len(mi), chunk):
        sl = slice(lo, lo + chunk)
        t = lambda x: torch.from_numpy(np.ascontiguousarray(x[sl], np.int64)).to(device)
        n = len(mi[sl])
        qq = t(q)
        fields = [_digits(t(p1)), _const(n, b" ", device), _digits(t(p2)),
                  _const(n, b" ", device), _digits(t(dist)), _const(n, b" ", device),
                  _digits((t(flags) != 0).to(torch.int64)), _const(n, b" ", device),
                  _digits(qq // 1_000_000), _const(n, b".", device)]
        frac = qq % 1_000_000
        pw = torch.tensor([10 ** k for k in range(5, -1, -1)], dtype=torch.int64, device=device)
        fc = ((frac[:, None] // pw) % 10 + 48).to(torch.uint8)
        fields += [(fc, torch.ones_like(fc, dtype=torch.bool)), _const(n, b"\n", device)]
        chars = torch.cat([f[0] for f in fields], dim=1)
        valid = torch.cat([f[1] for f in fields], dim=1)
        parts.append(chars[valid].cpu().numpy().tobytes())
    return b"".join(parts)


def positions(ipos, jpos, translation, base, genome_size, linear):
    p1 = translation[ipos] + base
    p2 = translation[jpos] + base
    d = np.abs(p1 - p2)
    if not linear:
        d = np.minimum(d, genome_size - d)
    return p1, p2, d


def outliers_bytes(p1, p2, dist, flags, mi, wog, thr_out, thr_ext, ld_threshold) -> bytes:
    """The outliers file's rows from edges in MI-descending order."""
    rows = []
    for a, b, d, fl, w, wg in zip(p1.tolist(), p2.tolist(), dist.tolist(), flags.tolist(),
                                  mi.tolist(), wog.tolist()):
        if w < thr_out:
            break
        if d <= ld_threshold:
            continue
        effect = (1.0 - wg / w) * 100.0 if w != 0 else 0.0
        rows.append(f"{a} {b} {d} {int(fl)} {w:.6f} {wg:.6f} {effect:.1f} {int(w > thr_ext)}\n")
    return "".join(rows).encode()


def fasta_bytes(names: list[str], codes: np.ndarray, width: int = 60) -> bytes:
    """FASTA of (S, n) codes, one record per sample."""
    out = []
    for name, row in zip(names, codes):
        seq = ALPHABET[row].tobytes()
        out.append(b">" + name.encode() + b"\n")
        out.extend(seq[k:k + width] + b"\n" for k in range(0, len(seq), width))
    return b"".join(out)


def file_names(id_string: str, n_samples: int, n_loci: int, n_edges: int, base: int,
               with_nodes: bool) -> dict:
    stem = f"{id_string}.{n_samples}x{n_loci}.spydrpick_couplings.{base}-based"
    names = {"couplings": f"{stem}.{n_edges}edges", "outliers": f"{stem}.outliers"}
    if with_nodes:
        names["nodes"] = f"{id_string}.outlier_nodes.fasta"
    return names


def lines_differ(got: bytes, want: bytes) -> int:
    """Lines that differ between two texts, counted by position; 0 when
    the bytes are equal."""
    if got == want:
        return 0
    a, b = got.split(b"\n"), want.split(b"\n")
    n = min(len(a), len(b))
    return sum(x != y for x, y in zip(a[:n], b[:n])) + abs(len(a) - len(b)) or 1
