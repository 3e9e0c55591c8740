"""The 5-state nucleic-acid alphabet.

Reference semantics (reference README.md:42): nucleotide symbols
A, C, G, T map to four distinct categories; *all other symbols*
(including N, -, ., lower-case variants of other letters, ...) map to a
single gap category. Parsing is case-insensitive.

State codes: A=0, C=1, G=2, T=3, GAP=4 (``number_of_states == 5``,
reference include/mi.hpp:70).
"""

from __future__ import annotations

import numpy as np

N_STATES = 5
GAP_STATE = 4

_SYMBOLS = b"ACGT"


def code_lookup_table() -> np.ndarray:
    """256-entry byte -> state-code lookup table (case-insensitive)."""
    lut = np.full(256, GAP_STATE, dtype=np.uint8)
    for code, sym in enumerate(_SYMBOLS):
        lut[sym] = code          # upper case
        lut[sym + 32] = code     # lower case
    return lut


_LUT = code_lookup_table()


def encode_bytes(seq: bytes | np.ndarray) -> np.ndarray:
    """Encode a byte sequence into uint8 state codes."""
    arr = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, (bytes, bytearray)) else seq
    return _LUT[arr]


def decode_codes(codes: np.ndarray) -> bytes:
    """Decode state codes back to symbols; gap renders as '-'."""
    table = np.frombuffer(b"ACGT-", dtype=np.uint8)
    return table[codes].tobytes()
