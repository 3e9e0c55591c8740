"""Kernel B, ``format_couplings_rows``: the couplings file's rows as bytes
on their device (``csrc/format_rows.cu``, design notes there).

Row k is ``f"{p1[k]} {p2[k]} {dist[k]} {flag[k]} {mi[k]:.6f}\\n"``, the
bytes of the host formatter ``native/format.cpp`` (snprintf's "%.6f") and
of Python's format: the MI field is the exact binary value correctly
rounded to six decimals, ties to even, computed in integers (x = m *
2^-k, q = round(m * 10^6 / 2^k)).  The flag prints as 1 when nonzero.

On CUDA tensors it launches the two passes (row lengths, then the rows at
the offsets of their cumsum); on CPU tensors it runs
``format_couplings_rows_plain``, the same integer rule on int64 tensors
(m * 10^6 in two limbs, since it reaches 2^73) assembled by scatters into
a uint8 tensor.  Both refuse MI values whose "%.6f" the rule would not
give: NaN, +-inf, negatives, -0.0 and values >= 2^53 / 10^6 (the
pipeline's mi are > threshold >= 0).

``couplings_columns`` gives p1, p2 and dist from the sorted edges'
columns with torch ops (``translation[pos] + base``; ``core/distance.py``'s
linear or circular rule), on their device.
"""

from __future__ import annotations

import torch

from spydrpick_torch.ops import cuda_build

MI_LIMIT = 2.0**53 / 1e6  # mi at or above this are refused
PLAIN_CHUNK = 1 << 20     # rows the plain version assembles at a time
_INT_WIDTH = 20           # characters of an int64 field, sign included
_POW10 = [10**i for i in range(19)]


def couplings_columns(ipos: torch.Tensor, jpos: torch.Tensor, translation: torch.Tensor,
                      base: int, genome_size: int, linear_genome: bool):
    """(p1, p2, dist) int64 on the positions' device: original genome
    positions plus ``base`` and their genome distance (``core/distance.py``)."""
    p1 = translation[ipos] + base
    p2 = translation[jpos] + base
    dist = torch.abs(p1 - p2)
    if not linear_genome:
        dist = torch.minimum(dist, genome_size - dist)
    return p1, p2, dist


def check_mi(mi: torch.Tensor) -> None:
    """Raise unless every value is finite, >= +0.0 and < MI_LIMIT."""
    bad = ~torch.isfinite(mi) | (mi < 0) | (mi >= MI_LIMIT) | ((mi == 0) & torch.signbit(mi))
    if bool(bad.any()):
        raise ValueError("format_couplings_rows: mi holds NaN, inf, a negative value, -0.0 "
                         f"or a value >= {MI_LIMIT}")


def mi_micro_plain(mi: torch.Tensor) -> torch.Tensor:
    """round-half-even(mi * 10^6) of the exact binary values, int64 (the
    kernel's ``mi_micro``): x = m * 2^-k, N = m * 10^6 = A * 2^26 + B
    with B < 2^26, q = N >> k rounded on the remainder against 2^(k-1)."""
    bits = mi.to(torch.float64).contiguous().view(torch.int64)
    eb = (bits >> 52) & 0x7FF
    m = bits & ((1 << 52) - 1)
    normal = eb != 0
    m = torch.where(normal, m | (1 << 52), m)
    k = torch.where(normal, 1075 - eb, torch.full_like(eb, 1074)).clamp(max=74)
    B = (m & ((1 << 26) - 1)) * 1_000_000
    A = (m >> 26) * 1_000_000 + (B >> 26)
    B = B & ((1 << 26) - 1)
    small = k <= 26
    # k <= 26: q = A << (26 - k) | B >> k, remainder B mod 2^k against 2^(k-1)
    ks = k.clamp(min=1, max=26)
    q_s = (A << (26 - ks)) + (B >> ks)
    r_s = B & ((1 << ks) - 1)
    h_s = 1 << (ks - 1)
    # k > 26: q = A >> (k - 26), remainder (A mod 2^(k-26)) * 2^26 + B against 2^(k-27) * 2^26
    kb = (k - 26).clamp(min=1)
    q_b = A >> kb
    r_b = A & ((1 << kb) - 1)
    h_b = 1 << (kb - 1)
    gt = torch.where(small, r_s > h_s, (r_b > h_b) | ((r_b == h_b) & (B > 0)))
    eq = torch.where(small, r_s == h_s, (r_b == h_b) & (B == 0))
    q = torch.where(small, q_s, q_b)
    q = q + (gt | (eq & ((q & 1) == 1))).to(torch.int64)
    return torch.where(k >= 74, torch.zeros_like(q), q)


def _digits(u: torch.Tensor, width: int):
    """(chars, n): the decimal digits of u >= 0 right-aligned in ``width``
    uint8 columns, and their count."""
    p = torch.tensor(_POW10[:width], dtype=torch.int64, device=u.device)
    chars = ((u[:, None] // p.flip(0)) % 10 + ord("0")).to(torch.uint8)
    n = 1 + (u[:, None] >= p[1:]).sum(dim=1)
    return chars, n


def _int_field(v: torch.Tensor):
    """An int64 field: its digits with a '-' before them when negative."""
    neg = v < 0
    chars, n = _digits(torch.abs(v), _INT_WIDTH - 1)
    chars = torch.cat([torch.zeros_like(chars[:, :1]), chars], dim=1)
    col = torch.arange(_INT_WIDTH, device=v.device)
    chars = torch.where((col == (_INT_WIDTH - 1 - n)[:, None]) & neg[:, None],
                        torch.tensor(ord("-"), dtype=torch.uint8, device=v.device), chars)
    return chars, n + neg.to(torch.int64)


def _const_field(n: int, text: bytes, dev):
    chars = torch.tensor(list(text), dtype=torch.uint8, device=dev).expand(n, len(text))
    return chars, torch.full((n,), len(text), dtype=torch.int64, device=dev)


def _rows_plain(p1, p2, dist, flags, mi) -> torch.Tensor:
    n, dev = len(mi), mi.device
    q = mi_micro_plain(mi)
    space = _const_field(n, b" ", dev)
    flag = (torch.where(flags != 0, ord("1"), ord("0")).to(torch.uint8)[:, None],
            torch.ones(n, dtype=torch.int64, device=dev))
    fields = [_int_field(p1.to(torch.int64)), space, _int_field(p2.to(torch.int64)), space,
              _int_field(dist.to(torch.int64)), space, flag, space,
              _digits(q // 1_000_000, 10), _const_field(n, b".", dev),
              (_digits(q % 1_000_000, 6)[0], torch.full((n,), 6, device=dev)),
              _const_field(n, b"\n", dev)]
    lengths = torch.stack([f[1] for f in fields], dim=1)
    field_start = torch.cumsum(lengths, dim=1) - lengths
    row_len = lengths.sum(dim=1)
    row_start = torch.cumsum(row_len, 0) - row_len
    out = torch.empty(int(row_len.sum()), dtype=torch.uint8, device=dev)
    for f, (chars, ln) in enumerate(fields):
        W = chars.shape[1]
        col = torch.arange(W, device=dev)[None, :]
        lead = (W - ln)[:, None]
        keep = col >= lead
        dest = (row_start + field_start[:, f])[:, None] + col - lead
        out[dest[keep]] = chars[keep]
    return out


def format_couplings_rows_plain(p1, p2, dist, flags, mi) -> torch.Tensor:
    """The rows as a uint8 tensor on mi's device, PLAIN_CHUNK rows at a
    time (module docstring)."""
    check_mi(mi)
    parts = [_rows_plain(p1[lo:lo + PLAIN_CHUNK], p2[lo:lo + PLAIN_CHUNK],
                         dist[lo:lo + PLAIN_CHUNK], flags[lo:lo + PLAIN_CHUNK],
                         mi[lo:lo + PLAIN_CHUNK]) for lo in range(0, len(mi), PLAIN_CHUNK)]
    return torch.cat(parts) if parts else torch.zeros(0, dtype=torch.uint8, device=mi.device)


def _check(p1, p2, dist, flags, mi) -> None:
    dev, n = mi.device, len(mi)
    for name, x, dtype in (("p1", p1, torch.int64), ("p2", p2, torch.int64),
                           ("dist", dist, torch.int64), ("flags", flags, torch.uint8),
                           ("mi", mi, torch.float64)):
        if x.dtype != dtype or x.dim() != 1 or len(x) != n or not x.is_contiguous() \
                or x.device != dev:
            raise ValueError(f"format_couplings_rows: {name} must be a contiguous 1-D {dtype} "
                             f"tensor of mi's length on {dev}")
    check_mi(mi)


def format_couplings_rows(p1: torch.Tensor, p2: torch.Tensor, dist: torch.Tensor,
                          flags: torch.Tensor, mi: torch.Tensor) -> torch.Tensor:
    """The couplings rows of the n edges as one uint8 tensor on their
    device: p1, p2, dist int64, flags uint8, mi f64 (module docstring).
    On a card the byte count is read back once to size the output."""
    if mi.device.type == "cpu":
        return format_couplings_rows_plain(p1, p2, dist, flags, mi)
    if not mi.is_cuda:
        raise ValueError(f"format_couplings_rows: unsupported device {mi.device}")
    _check(p1, p2, dist, flags, mi)
    n, dev = len(mi), mi.device
    if n == 0:
        return torch.zeros(0, dtype=torch.uint8, device=dev)
    lib = cuda_build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    lens = torch.empty(n, dtype=torch.int32, device=dev)
    cuda_build.check(lib.spk_format_lengths(p1.data_ptr(), p2.data_ptr(), dist.data_ptr(),
                                            mi.data_ptr(), n, lens.data_ptr(), stream),
                     "format_couplings_rows (lengths)")
    starts = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(lens, 0, out=starts[1:])
    out = torch.empty(int(starts[n]), dtype=torch.uint8, device=dev)
    cuda_build.check(lib.spk_format_rows(p1.data_ptr(), p2.data_ptr(), dist.data_ptr(),
                                         flags.data_ptr(), mi.data_ptr(), n, starts.data_ptr(),
                                         out.data_ptr(), stream),
                     "format_couplings_rows (rows)")
    format_couplings_rows.launches += 1
    return out


format_couplings_rows.launches = 0  # calls that launched the kernels (CPU calls do not count)
