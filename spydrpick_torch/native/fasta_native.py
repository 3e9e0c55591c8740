"""ctypes loader for the native FASTA parser (fasta.cpp); a copy of
spydrpick_tpu/native/fasta_native.py that builds its library into
build/native/ (``spydrpick_torch.native.build_library``)."""

from __future__ import annotations

import ctypes
import os

import numpy as np

from spydrpick_torch.native import build_library
from spydrpick_torch.utils.profiling import count, span

_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_library("fasta")))
    lib.spydrpick_fasta_index.restype = ctypes.c_int
    lib.spydrpick_fasta_index.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.spydrpick_fasta_parse.restype = ctypes.c_int
    lib.spydrpick_fasta_parse.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_char_p,
        ctypes.c_int64,
    ]
    _lib = lib
    return lib


def parse(path: str, alloc=None) -> tuple[np.ndarray, list[str]]:
    """(codes (S, L) uint8, sample names). Raises on malformed input.
    ``alloc(shape)`` gives the C-contiguous uint8 array the codes are
    decoded into (a pinned buffer, say; by default ``np.empty``).  Spans
    (``utils/profiling.py``): read (the first pass: the file mapped, its
    bytes read and its records indexed), alloc (the codes' array) and
    decode (the second pass: the codes decoded and the names copied); the
    counter fasta_bytes counts the file's bytes."""
    lib = _load()
    with span("read"):
        n = ctypes.c_int64()
        w = ctypes.c_int64()
        rc = lib.spydrpick_fasta_index(str(path).encode(), ctypes.byref(n), ctypes.byref(w))
    if rc == -1:
        # the native open_map rejects missing AND zero-length files with
        # the same code; report the empty case like the numpy parser does
        if os.path.exists(path) and os.path.getsize(path) == 0:
            raise ValueError(f"{path}: empty FASTA file")
        raise FileNotFoundError(path)
    if rc == -2:
        raise ValueError(f"{path}: malformed FASTA")
    if rc == -3:
        raise ValueError(f"{path}: unaligned sequences (differing widths)")
    count("fasta_bytes", os.path.getsize(path))
    S, L = n.value, w.value
    with span("alloc"):
        codes = np.empty((S, L), dtype=np.uint8) if alloc is None else alloc((S, L))
    if codes.dtype != np.uint8 or codes.shape != (S, L) or not codes.flags.c_contiguous:
        raise ValueError(f"alloc gave a {codes.dtype} array of shape {codes.shape}")
    with span("decode"):
        namebuf_cap = 1 << 22
        namebuf = ctypes.create_string_buffer(namebuf_cap)
        rc = lib.spydrpick_fasta_parse(
            str(path).encode(),
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int64(S), ctypes.c_int64(L), namebuf, ctypes.c_int64(namebuf_cap),
        )
        if rc != 0:
            raise ValueError(f"{path}: FASTA parse failed (code {rc})")
        names = namebuf.raw.split(b"\0")[:S]
    return codes, [x.decode("utf-8", errors="replace") for x in names]
