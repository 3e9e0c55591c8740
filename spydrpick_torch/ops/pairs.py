"""``pairs_xtab``: the weighted 5x5 joint-count tables of explicit column
pairs, for the threshold tournament, the lazy wo-gaps resolve and the
sample-sharded view (``csrc/pairs_xtab.cu``, design notes there).

``pairs_xtab(ci, cj, weights)`` takes the (S, P) uint8 codes of the
pairs' i and j columns and the (S,) f32 sample weights, and returns the
(P, 5, 5) f32 tables: cell (a, b) of pair p sums the weights of the
samples whose codes are a in column i and b in column j (the reference's
``_pairs_xtab``, spydrpick_tpu/engine/solver.py:862).  A code above 4 on
either side (255: padding) adds to no cell.

The sums are exact and free of order: each cell is summed in float64 and
rounded to f32 once.  An f32 weight is a multiple of 2^(e - 23) for its
exponent e, so while log2 S + e_max - e_min + 24 <= 53 every partial sum
is exact in float64, in any order.  For weights <= 1 that holds when
every nonzero weight is at least 2^(ceil(log2 S) - 29) (2^-17 at S=3000):
computed weights (>= 1/S), unit weights and the bench's [0.1, 1) qualify.
Inside that range the kernel, ``pairs_xtab_plain`` and any order of the
pairs or the samples, or any chunking of the pairs, give the same bits;
outside it they agree within one f32 ulp.

On CUDA tensors the wrapper launches the kernel; on CPU tensors it runs
``pairs_xtab_plain``, which runs on any device and is the kernel's
reference on the card: one weighted ``bincount`` of the cells' bins per
block of samples, in float64, added block by block, then one rounding.
"""

from __future__ import annotations

import torch

from spydrpick_torch.core.alphabet import N_STATES
from spydrpick_torch.ops import cuda_build

N_BINS = N_STATES * N_STATES
# (sample, pair) cells per bincount of the plain version: bounds its
# temporaries (an int64 bin and an f64 weight per cell) to 256 MiB
PLAIN_CELLS = 1 << 24


def pairs_xtab_plain(ci: torch.Tensor, cj: torch.Tensor, weights: torch.Tensor,
                     cells: int = PLAIN_CELLS) -> torch.Tensor:
    """(P, 5, 5) tables of the pairs whose (S, P) codes are ``ci`` and
    ``cj``, weighted by the (S,) ``weights`` (module docstring), on their
    device: the samples in blocks of at most ``cells`` (sample, pair)
    cells, each block one float64 ``bincount``.  f32 for f32 weights (the
    kernel's contract); float64 weights give the float64 sums themselves,
    unrounded (the float64 recounts of chip_smoke.py read them)."""
    S, P = ci.shape
    dev = ci.device
    acc = torch.zeros(P * N_BINS, dtype=torch.float64, device=dev)
    base = torch.arange(P, dtype=torch.int64, device=dev) * N_BINS
    w64 = weights.to(torch.float64)
    step = max(1, cells // max(P, 1))
    for s0 in range(0, S, step):
        q = ci[s0:s0 + step].to(torch.int64) * N_STATES + cj[s0:s0 + step].to(torch.int64)
        hit = q < N_BINS
        acc += torch.bincount((base + q)[hit], weights=w64[s0:s0 + step, None].expand_as(q)[hit],
                              minlength=P * N_BINS)
    return acc.to(torch.promote_types(weights.dtype, torch.float32)).view(P, N_STATES, N_STATES)


def pairs_xtab(ci: torch.Tensor, cj: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(P, 5, 5) f32 weighted joint-count tables of P column pairs from
    their (S, P) uint8 codes ``ci``, ``cj`` and the (S,) f32 ``weights``,
    on their device (module docstring)."""
    if ci.device.type == "cpu":
        return pairs_xtab_plain(ci, cj, weights)
    if not ci.is_cuda:
        raise ValueError(f"pairs_xtab: unsupported device {ci.device}")
    for name, x in (("ci", ci), ("cj", cj)):
        if (x.dtype != torch.uint8 or x.dim() != 2 or not x.is_contiguous()
                or x.device != ci.device or x.shape != ci.shape):
            raise ValueError(f"pairs_xtab: {name} must be a contiguous (S, P) uint8 tensor on "
                             f"{ci.device} of ci's shape {tuple(ci.shape)}")
    S, P = ci.shape
    if (weights.dtype != torch.float32 or weights.dim() != 1 or len(weights) != S
            or not weights.is_contiguous() or weights.device != ci.device):
        raise ValueError(f"pairs_xtab: weights must be a contiguous ({S},) float32 tensor on "
                         f"{ci.device}")
    if S >= 2**31:
        raise ValueError(f"pairs_xtab: {S} samples exceed int32")
    out = torch.empty((P, N_STATES, N_STATES), dtype=torch.float32, device=ci.device)
    if P == 0:
        return out
    if S == 0:
        return out.zero_()
    rc = cuda_build.load().spk_pairs_xtab(
        ci.data_ptr(), cj.data_ptr(), weights.data_ptr(), S, P, out.data_ptr(),
        torch.cuda.current_stream(ci.device).cuda_stream)
    cuda_build.check(rc, "pairs_xtab")
    pairs_xtab.launches += 1
    return out


pairs_xtab.launches = 0  # kernel launches (CPU calls do not count)
