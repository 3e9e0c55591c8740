"""ctypes loader of the native couplings-row formatter.

Compiles format.cpp with g++ on first use (cached in build/native/;
rebuilt when the source is newer).  Callers catch exceptions and fall
back to the Python formatter.
"""

from __future__ import annotations

import ctypes

import numpy as np

from spydrpick_torch.native import build_library

_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_library("format")))
    lib.spydrpick_format_couplings.restype = ctypes.c_int64
    lib.spydrpick_format_couplings.argtypes = [
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.c_char_p,
        ctypes.c_int64,
    ]
    _lib = lib
    return lib


def format_couplings(p1, p2, dist, flags, mi, chunk: int = 1 << 20) -> bytes:
    """Formatted couplings rows as bytes (chunked: bounded scratch)."""
    lib = _load()
    n = len(mi)
    if n == 0:
        return b""
    p1 = np.ascontiguousarray(p1, dtype=np.int64)
    p2 = np.ascontiguousarray(p2, dtype=np.int64)
    dist = np.ascontiguousarray(dist, dtype=np.int64)
    flags = np.ascontiguousarray(flags, dtype=np.uint8)
    mi = np.ascontiguousarray(mi, dtype=np.float64)
    pieces = []
    ptr = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
    for c0 in range(0, n, chunk):
        m = min(chunk, n - c0)
        cap = 96 * m
        buf = ctypes.create_string_buffer(cap)
        rc = lib.spydrpick_format_couplings(
            ptr(p1[c0:], ctypes.c_int64), ptr(p2[c0:], ctypes.c_int64),
            ptr(dist[c0:], ctypes.c_int64), ptr(flags[c0:], ctypes.c_uint8),
            ptr(mi[c0:], ctypes.c_double), ctypes.c_int64(m),
            buf, ctypes.c_int64(cap),
        )
        if rc < 0:
            raise RuntimeError("format buffer overflow")
        pieces.append(buf.raw[:rc])
    return b"".join(pieces)
