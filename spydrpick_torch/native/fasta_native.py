"""ctypes loader for the native FASTA parser (fasta.cpp), built into
build/native/ (``spydrpick_torch.native.build_library``).  Its codes,
names and errors are those of spydrpick_tpu/native/fasta_native.py; the
file is mapped once and walked in parallel (fasta.cpp's header)."""

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
    lib.spydrpick_fasta_max_threads.restype = ctypes.c_int
    lib.spydrpick_fasta_max_threads.argtypes = []
    lib.spydrpick_fasta_index.restype = ctypes.c_int
    lib.spydrpick_fasta_index.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.spydrpick_fasta_decode.restype = ctypes.c_int
    lib.spydrpick_fasta_decode.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.spydrpick_fasta_free.restype = None
    lib.spydrpick_fasta_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def parse(path: str, alloc=None, ranges: int | None = None) -> tuple[np.ndarray, list[str]]:
    """(codes (S, L) uint8, sample names). Raises on malformed input.
    ``alloc(shape)`` gives the C-contiguous uint8 array the codes are
    decoded into (a pinned buffer, say; by default ``np.empty``).
    ``ranges``: the byte ranges the index cuts the file into, by default
    OpenMP's thread count (tests set it to put range ends on record and
    line boundaries).  Spans (``utils/profiling.py``): read (the file
    mapped, its records indexed and their widths counted), alloc (the
    codes' array) and decode (the codes decoded, the names copied and the
    mapping released); the counters fasta_bytes count the file's bytes and
    fasta_slow_records the records with a line that held interior
    whitespace (decoded byte by byte)."""
    lib = _load()
    handle = ctypes.c_void_p()
    n = ctypes.c_int64()
    w = ctypes.c_int64()
    with span("read"):
        rc = lib.spydrpick_fasta_index(
            str(path).encode(), ranges or lib.spydrpick_fasta_max_threads(),
            ctypes.byref(handle), ctypes.byref(n), ctypes.byref(w))
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
    try:
        count("fasta_bytes", os.path.getsize(path))
        S, L = n.value, w.value
        with span("alloc"):
            codes = np.empty((S, L), dtype=np.uint8) if alloc is None else alloc((S, L))
        if codes.dtype != np.uint8 or codes.shape != (S, L) or not codes.flags.c_contiguous:
            raise ValueError(f"alloc gave a {codes.dtype} array of shape {codes.shape}")
        with span("decode"):
            namebuf = np.empty(1 << 22, dtype=np.uint8)  # only the names' pages are touched
            used = ctypes.c_int64()
            slow = ctypes.c_int64()
            rc = lib.spydrpick_fasta_decode(
                handle, codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.c_int64(S), ctypes.c_int64(L), namebuf.ctypes.data,
                ctypes.c_int64(namebuf.size), ctypes.byref(used), ctypes.byref(slow),
            )
            lib.spydrpick_fasta_free(handle)
            handle = None
            if rc != 0:
                raise ValueError(f"{path}: FASTA parse failed (code {rc})")
            count("fasta_slow_records", slow.value)
            names = namebuf[:used.value].tobytes().split(b"\0")[:S]
    finally:
        if handle is not None:
            lib.spydrpick_fasta_free(handle)
    return codes, [x.decode("utf-8", errors="replace") for x in names]
