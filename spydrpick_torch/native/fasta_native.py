"""ctypes loader for the native FASTA parser (fasta.cpp); a copy of
spydrpick_tpu/native/fasta_native.py that builds its library into
build/native/ (``spydrpick_torch.native.build_library``)."""

from __future__ import annotations

import ctypes

import numpy as np

from spydrpick_torch.native import build_library

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


def parse(path: str) -> tuple[np.ndarray, list[str]]:
    """(codes (S, L) uint8, sample names). Raises on malformed input."""
    lib = _load()
    n = ctypes.c_int64()
    w = ctypes.c_int64()
    rc = lib.spydrpick_fasta_index(str(path).encode(), ctypes.byref(n), ctypes.byref(w))
    if rc == -1:
        # the native open_map rejects missing AND zero-length files with
        # the same code; report the empty case like the numpy parser does
        import os

        if os.path.exists(path) and os.path.getsize(path) == 0:
            raise ValueError(f"{path}: empty FASTA file")
        raise FileNotFoundError(path)
    if rc == -2:
        raise ValueError(f"{path}: malformed FASTA")
    if rc == -3:
        raise ValueError(f"{path}: unaligned sequences (differing widths)")
    S, L = n.value, w.value
    codes = np.empty((S, L), dtype=np.uint8)
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
