"""Output-file writers: couplings, outliers, state frequencies, weights.

Formats per reference README "Deciphering SpydrPick output" and the
formatters at apegrunt ``Graph_output_formatter`` (src/SpydrPick.cpp:
442-446) / ``Outlier_Graph_formatter`` (include/SpydrPick.hpp:89-129):

  couplings rows: ``pos1 pos2 genome_distance aracne_flag mi``
    (descending MI; positions are original-genome indices + output base;
    MI fixed 6 decimals per SpydrPick.hpp:119-121)
  outliers rows:  ``pos1 pos2 distance flag mi mi_wo_gaps gap_effect
    extreme_flag`` where gap_effect = (1 - mi_wo_gaps/mi)*100 at one
    decimal, rows restricted to weight >= outlier_threshold and
    distance > ld_threshold (SpydrPick.hpp:100-124).

``write_couplings_rows`` is the pipeline's couplings writer: it formats
the sorted edges where they lie (``ops/format.py``: a CUDA kernel on a
card, its plain version on the CPU), ROW_CHUNK rows at a time, and
writes each chunk's bytes; ``write_couplings`` is the host writer of the
reference (native formatter, Python fallback), kept with its signature.
"""

from __future__ import annotations

import numpy as np
import torch

from spydrpick_torch.core.alignment import Alignment
from spydrpick_torch.core.distance import genome_distance
from spydrpick_torch.device import synchronize
from spydrpick_torch.ops.format import couplings_columns, format_couplings_rows
from spydrpick_torch.utils.profiling import count, span

ROW_CHUNK = 1 << 24  # rows formatted at a time: bounds the device scratch


def _translated(edges_pos: np.ndarray, translation: np.ndarray, base: int) -> np.ndarray:
    return translation[edges_pos] + base


def write_couplings(
    f,
    edges,                      # sorted-desc EdgeSet
    flags: np.ndarray,          # (E,) uint8 aracne flags (0 when --no-aracne)
    alignment: Alignment,
    output_base: int = 1,
    linear_genome: bool = False,
    use_native: bool = True,
) -> None:
    """The couplings file's rows on the host; the counter
    bytes_written.couplings counts the bytes written."""
    p1 = _translated(edges.ipos, alignment.translation, output_base)
    p2 = _translated(edges.jpos, alignment.translation, output_base)
    dist = genome_distance(p1, p2, alignment.n_original_positions, linear_genome)
    fl = flags.astype(np.uint8)
    # native OpenMP formatter (the apegrunt Graph_output_formatter role):
    # the earlier np.char pipeline ran ~25 us/row — 250 s at the 1e7-edge
    # default output.  Python fallback below is a chunked f-string loop
    # (~1.5 us/row); both produce byte-identical rows (locked by tests).
    if use_native:
        # Only the native build/format step may fall back to Python: the
        # actual file writes stay OUTSIDE the try so a partial write
        # (e.g. ENOSPC) surfaces as an error instead of being silently
        # re-emitted by the fallback after half the native rows landed.
        data = None
        try:
            from spydrpick_torch.native import format_native

            data = format_native.format_couplings(p1, p2, dist, fl, edges.mi)
        except Exception:
            pass  # fall back to Python formatting
        if data is not None:
            if hasattr(f, "buffer"):  # text file: skip the str round-trip
                f.flush()
                f.buffer.write(data)
            else:
                f.write(data.decode("ascii"))
            count("bytes_written.couplings", len(data))
            return
    mi = edges.mi
    out = []
    for c0 in range(0, len(mi), 1 << 18):
        hi = min(len(mi), c0 + (1 << 18))
        out.append("\n".join(
            f"{p1[k]} {p2[k]} {dist[k]} {fl[k]} {mi[k]:.6f}"
            for k in range(c0, hi)
        ))
        out.append("\n")
    text = "".join(out)
    f.write(text)
    count("bytes_written.couplings", len(text))  # ASCII: one byte a character


def write_couplings_rows(f, ipos: torch.Tensor, jpos: torch.Tensor, mi: torch.Tensor,
                         flags: torch.Tensor, alignment: Alignment, output_base: int = 1,
                         linear_genome: bool = False, chunk: int = ROW_CHUNK) -> None:
    """The couplings file's rows (``write_couplings``'s bytes) from the
    sorted edges as tensors on one device: ipos, jpos int64, mi f64, flags
    uint8.  Per chunk of rows, p1, p2 and dist are computed and the rows
    formatted on that device (``format_couplings_rows``); on a card the
    bytes cross once into a pinned host buffer, and the file's binary
    buffer writes them with no further copy.  Per chunk the spans format,
    copy and file.  The counter bytes_written.couplings counts the bytes
    handed to the file."""
    dev = mi.device
    out = f
    if hasattr(f, "buffer"):  # a text file: write its bytes underneath
        f.flush()
        out = f.buffer
    trans = torch.from_numpy(np.ascontiguousarray(alignment.translation, dtype=np.int64)).to(dev)
    host = None
    for lo in range(0, len(mi), chunk):
        hi = min(len(mi), lo + chunk)
        with span("format"):
            p1, p2, dist = couplings_columns(ipos[lo:hi], jpos[lo:hi], trans, output_base,
                                             alignment.n_original_positions, linear_genome)
            data = format_couplings_rows(p1, p2, dist, flags[lo:hi], mi[lo:hi])
            del p1, p2, dist
            synchronize(dev)
        with span("copy"):
            if dev.type == "cuda":
                if host is None or len(host) < len(data):
                    host = torch.empty(len(data), dtype=torch.uint8, pin_memory=True)
                host[:len(data)].copy_(data, non_blocking=True)
                synchronize(dev)
                buf = host[:len(data)].numpy()
            else:
                buf = data.numpy()
            del data
        with span("file"):
            out.write(memoryview(buf))
        count("bytes_written.couplings", len(buf))


def write_outliers(
    f,
    edges,                      # sorted-desc EdgeSet
    flags: np.ndarray,
    alignment: Alignment,
    outlier_threshold: float,
    extreme_outlier_threshold: float,
    ld_threshold: int = 0,
    output_base: int = 1,
    linear_genome: bool = False,
) -> int:
    """Returns the number of rows written; the counter
    bytes_written.outliers counts the bytes written."""
    p1 = _translated(edges.ipos, alignment.translation, output_base)
    p2 = _translated(edges.jpos, alignment.translation, output_base)
    dist = genome_distance(p1, p2, alignment.n_original_positions, linear_genome)
    n = n_bytes = 0
    for a, b, d, fl, w, wog in zip(p1, p2, dist, flags, edges.mi, edges.mi_wog):
        if w < outlier_threshold:
            break  # list is descending; reference breaks here (SpydrPick.hpp:100-103)
        if d <= ld_threshold:
            continue
        gap_effect = (1.0 - wog / w) * 100.0 if w != 0 else 0.0
        extreme = int(w > extreme_outlier_threshold)
        row = f"{a} {b} {d} {int(fl)} {w:.6f} {wog:.6f} {gap_effect:.1f} {extreme}\n"
        f.write(row)
        n += 1
        n_bytes += len(row)  # ASCII: one byte a character
    count("bytes_written.outliers", n_bytes)
    return n


def write_state_frequencies(f, alignment: Alignment, output_base: int = 1) -> None:
    """Per-column state frequency profile (apegrunt
    ``output_state_frequencies``, src/SpydrPick.cpp:333).  Columns:
    position A C G T gap frequencies (of n_samples).  Chunked join —
    the naive per-row loop cost ~1 min at the 1M-column class."""
    counts = alignment.state_counts
    freqs = counts / alignment.n_samples
    pos = alignment.translation + output_base
    L = alignment.n_loci
    for c0 in range(0, L, 1 << 16):
        hi = min(L, c0 + (1 << 16))
        f.write("\n".join(
            f"{pos[k]} " + " ".join(f"{x:.6f}" for x in freqs[k])
            for k in range(c0, hi)
        ))
        f.write("\n")


def write_sample_weights(f, alignment: Alignment) -> None:
    """One weight per line (apegrunt ``output_sample_weights``,
    src/SpydrPick.cpp:324)."""
    for w in alignment.weights:
        f.write(f"{w:.8f}\n")


def write_distance_matrix(f, dist: np.ndarray) -> None:
    """Sample-sample Hamming distance matrix
    (``output_sample_distance_matrix``, src/SpydrPick.cpp:367)."""
    for row in dist:
        f.write(" ".join(str(int(x)) for x in row) + "\n")
