"""FASTA alignment reader/writer.

Replaces the role of apegrunt's FASTA parser (consumed via
``apegrunt::get_alignments`` at src/SpydrPick.cpp:163).  Semantics
(reference README.md:42): case-insensitive; A/C/G/T are four
categories, every other symbol maps to the gap category.

Two parser backends, same semantics:
  * native: mmap + OpenMP C++ (spydrpick_torch/native/fasta.cpp),
    used when the toolchain is available — GB-scale inputs;
  * NumPy: vectorised over the raw bytes (record split + 256-entry
    LUT decode, no per-character Python loop) as a fallback.
"""

from __future__ import annotations

import os
import pathlib

import numpy as np

from spydrpick_torch.core.alignment import Alignment
from spydrpick_torch.core.alphabet import decode_codes, encode_bytes


def _pinned(shape) -> np.ndarray:
    """An uninitialised uint8 array in page-locked host memory, from which
    a copy to a card needs no staging."""
    import torch

    return torch.empty(shape, dtype=torch.uint8, pin_memory=True).numpy()


def _native_parser():
    """The native parse function, or None if the toolchain is missing."""
    try:
        from spydrpick_torch.native import fasta_native

        fasta_native._load()
        return fasta_native.parse
    except Exception:
        return None


def _numpy_parse(path: pathlib.Path) -> tuple[np.ndarray, list[str]]:
    raw = path.read_bytes()
    if not raw.strip():
        raise ValueError(f"{path}: empty FASTA file")
    names: list[str] = []
    seqs: list[np.ndarray] = []
    # Split on '>' at RECORD STARTS only (line starts) — a literal '>'
    # inside a header line must not split the record.  The native parser
    # (fasta.cpp) differs: it starts a record at the first '>' of any
    # line, so a '>' in the middle of a sequence line splits there, where
    # this fallback decodes it as a gap
    body_all = raw.lstrip()
    if not body_all.startswith(b">"):
        raise ValueError(f"{path}: file does not start with a FASTA header ('>')")
    body_all = body_all[1:]
    for chunk in body_all.replace(b"\r\n", b"\n").split(b"\n>"):
        if not chunk.strip():
            continue
        nl = chunk.find(b"\n")
        if nl < 0:
            raise ValueError(f"{path}: malformed FASTA record (no sequence)")
        header = chunk[:nl].strip().decode("utf-8", errors="replace")
        body = chunk[nl + 1 :]
        arr = np.frombuffer(body, dtype=np.uint8)
        # drop whitespace bytes (\n \r \t space)
        keep = (arr != 0x0A) & (arr != 0x0D) & (arr != 0x09) & (arr != 0x20)
        names.append(header.split()[0] if header else f"seq{len(names)}")
        seqs.append(encode_bytes(arr[keep]))
    if not seqs:
        raise ValueError(f"{path}: no sequences found")
    widths = {len(s) for s in seqs}
    if len(widths) != 1:
        raise ValueError(f"{path}: unaligned sequences (widths {sorted(widths)})")
    return np.vstack(seqs), names


def read_fasta(
    path: str | os.PathLike,
    mappings: np.ndarray | None = None,
    genome_size: int | None = None,
    pinned: bool = False,
) -> Alignment:
    """Parse a FASTA file into an :class:`Alignment`.

    ``mappings``: optional per-column original-position indices
    (``--mappings-list``, reference README "Advanced usage").
    ``genome_size``: optional explicit genome size (``--genome-size``).
    ``pinned``: the native parser decodes into page-locked memory, so that
    the codes go to a card without a staging copy.  The native parser
    records its passes as spans (``fasta_native.parse``).
    """
    path = pathlib.Path(path)
    native = _native_parser()
    if native is not None:
        codes, names = native(path, _pinned if pinned else None)
        names = [n if n else f"seq{k}" for k, n in enumerate(names)]
    else:
        codes, names = _numpy_parse(path)
    n_loci = codes.shape[1]

    if mappings is not None:
        mappings = np.asarray(mappings, dtype=np.int64)
        if len(mappings) != n_loci:
            raise ValueError(
                f"mappings list has {len(mappings)} entries but alignment has {n_loci} columns"
            )
        translation = mappings
        n_original = int(mappings.max()) + 1
    else:
        translation = np.arange(n_loci, dtype=np.int64)
        n_original = n_loci
    if genome_size is not None:
        n_original = int(genome_size)

    return Alignment(
        codes=codes,
        sample_names=names,
        id_string=path.name.split(".")[0],
        translation=translation,
        n_original_positions=n_original,
    )


def write_fasta(path: str | os.PathLike, alignment: Alignment, width: int = 60) -> int:
    """Write an alignment back to FASTA (apegrunt ``output_alignment``,
    used for --output-alignment / outlier-node dumps, SpydrPick.cpp:173,501);
    returns the bytes written."""
    with open(path, "wb") as f:
        for name, row in zip(alignment.sample_names, alignment.codes):
            f.write(b">" + name.encode() + b"\n")
            seq = decode_codes(row)
            for off in range(0, len(seq), width):
                f.write(seq[off : off + width] + b"\n")
        return f.tell()
