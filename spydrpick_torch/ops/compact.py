"""Kernel K2: per-row edge compaction (port of
spydrpick_tpu/ops/compact_route.py:route_rows_pallas).

``route_rows(mask, mi, wog=None)`` returns (routed_mi, routed_j int32,
routed_wog or None, counts int32): lanes [0, counts[r]) of row r hold
the masked values of that row verbatim and their row-local column
indices, in ascending column order; the lanes past counts[r] are zero.
Any (R, W) shape is accepted.  On CUDA tensors it launches the scan
kernel in ``csrc/route_rows.cu``; on CPU tensors it runs
``route_rows_plain``.  The TPU kernel's roll-routing rounds, 128-lane
line packing and VMEM caps have no counterpart here: they existed
because the TPU scatters element by element.
"""

from __future__ import annotations

import torch

from spydrpick_torch.ops import cuda_build


def route_rows_plain(mask: torch.Tensor, mi: torch.Tensor,
                     wog: torch.Tensor | None = None):
    """Plain-PyTorch twin of the kernel: each survivor's lane is its rank
    among the row's survivors (a cumulative sum), written by a scatter
    whose indices are unique, so the result is deterministic."""
    R, W = mask.shape
    counts = mask.sum(dim=1, dtype=torch.int32)
    rows, cols = mask.nonzero(as_tuple=True)
    lane = torch.cumsum(mask, dim=1)[rows, cols] - 1
    omi = torch.zeros_like(mi)
    omi[rows, lane] = mi[rows, cols]
    oj = torch.zeros((R, W), dtype=torch.int32, device=mask.device)
    oj[rows, lane] = cols.to(torch.int32)
    owog = None
    if wog is not None:
        owog = torch.zeros_like(wog)
        owog[rows, lane] = wog[rows, cols]
    return omi, oj, owog, counts


def route_rows(mask: torch.Tensor, mi: torch.Tensor,
               wog: torch.Tensor | None = None):
    """Compact every row of ``mask`` (R, W) bool; mi/wog are (R, W) f32
    payloads carried verbatim (see module docstring)."""
    if mask.device.type == "cpu":
        return route_rows_plain(mask, mi, wog)
    if not mask.is_cuda:
        raise ValueError(f"route_rows: unsupported device {mask.device}")
    payloads = (mi,) if wog is None else (mi, wog)
    if mask.dtype != torch.bool or mask.dim() != 2 or not mask.is_contiguous():
        raise ValueError("route_rows: mask must be a contiguous 2-D bool tensor")
    for x in payloads:
        if (x.dtype != torch.float32 or x.shape != mask.shape
                or x.device != mask.device or not x.is_contiguous()):
            raise ValueError("route_rows: payloads must be contiguous f32 of the mask's shape")
    R, W = mask.shape
    if R >= 2**31 or W >= 2**31:
        raise ValueError(f"route_rows: shape {tuple(mask.shape)} exceeds int32 indexing")
    omi = torch.empty_like(mi)
    oj = torch.empty((R, W), dtype=torch.int32, device=mask.device)
    owog = None if wog is None else torch.empty_like(wog)
    counts = torch.zeros(R, dtype=torch.int32, device=mask.device)
    if R == 0 or W == 0:
        return omi, oj, owog, counts
    lib = cuda_build.load()
    rc = lib.spk_route_rows(
        mask.data_ptr(), mi.data_ptr(), None if wog is None else wog.data_ptr(),
        omi.data_ptr(), oj.data_ptr(), None if owog is None else owog.data_ptr(),
        counts.data_ptr(), R, W, torch.cuda.current_stream(mask.device).cuda_stream)
    cuda_build.check(rc, "route_rows")
    route_rows.launches += 1
    return omi, oj, owog, counts


route_rows.launches = 0  # kernel launches (CPU calls do not count)
