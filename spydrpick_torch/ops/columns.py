"""``column_state_counts``: the per-column state counts of an alignment's
codes on their device (``csrc/column_counts.cu``, design notes there).

``column_state_counts(codes)`` takes (S, L) uint8 codes and returns the
(L, 5) int32 counts of states 0..4 in each column; any other code (255,
the engine's padding) counts nowhere.  They are the counts of the host's
``Alignment.state_counts`` (core/alignment.py, a copy of the reference's),
from which the filter rules, the presence masks and the gap mask follow.
On CUDA tensors the wrapper launches the kernel; on CPU tensors it runs
``column_state_counts_plain``, five ``(codes == s).sum(0)``, which runs on
any device and is the kernel's reference on the card.  Integer counts:
the two agree exactly.
"""

from __future__ import annotations

import torch

from spydrpick_torch.core.alphabet import N_STATES
from spydrpick_torch.ops import cuda_build


def column_state_counts_plain(codes: torch.Tensor) -> torch.Tensor:
    """(L, 5) int32 counts of states 0..4 per column of (S, L) codes."""
    return torch.stack([(codes == s).sum(0, dtype=torch.int32) for s in range(N_STATES)], 1)


def column_state_counts(codes: torch.Tensor) -> torch.Tensor:
    """(L, 5) int32 unweighted counts of states 0..4 per column of the
    (S, L) uint8 codes, on their device (module docstring)."""
    if codes.device.type == "cpu":
        return column_state_counts_plain(codes)
    if not codes.is_cuda:
        raise ValueError(f"column_state_counts: unsupported device {codes.device}")
    if codes.dtype != torch.uint8 or codes.dim() != 2 or not codes.is_contiguous():
        raise ValueError("column_state_counts: codes must be a contiguous 2-D uint8 tensor, "
                         f"got {codes.dtype} of shape {tuple(codes.shape)}")
    S, L = codes.shape
    if S >= 2**31 or L >= 2**31:
        raise ValueError(f"column_state_counts: shape {(S, L)} exceeds int32 sizes")
    out = torch.zeros((L, N_STATES), dtype=torch.int32, device=codes.device)
    if S == 0 or L == 0:
        return out
    rc = cuda_build.load().spk_column_counts(
        codes.data_ptr(), S, L, out.data_ptr(),
        torch.cuda.current_stream(codes.device).cuda_stream)
    cuda_build.check(rc, "column_state_counts")
    column_state_counts.launches += 1
    return out


column_state_counts.launches = 0  # kernel launches (CPU calls do not count)
