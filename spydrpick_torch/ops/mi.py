"""Batched MI of weighted 5x5 crosstables (port of
spydrpick_tpu/ops/mi.py:mi_from_crosstabs).

Used by the pairs paths (threshold tournament, lazy wo-gaps resolve);
the all-pairs sweep goes through kernel K1 (ops/mi_kernels.py) instead.
Semantics follow include/mi.hpp:146-181, including the full-row-sum
quirk of mi.hpp:173 (see ops/reference.py, the float64 oracle).
"""

from __future__ import annotations

import torch

from spydrpick_torch.ops.mi_kernels import cpu_log_ready


def _xlogx(x: torch.Tensor) -> torch.Tensor:
    """x * ln(x), defined as 0 at x <= 0 (apegrunt ``xlogx``)."""
    if x.device.type == "cpu":
        cpu_log_ready()
    pos = x > 0
    return torch.where(pos, x * torch.log(torch.where(pos, x, 1.0)), 0.0)


def mi_from_crosstabs(C: torch.Tensor, ip: torch.Tensor, jp: torch.Tensor,
                      pseudocount: float) -> torch.Tensor:
    """MI for a batch of crosstables.

    C: (..., 5, 5) raw weighted joint counts (i-state, j-state); ip/jp:
    (..., 5) 0/1 state presence of the i/j column.  Returns (...,) MI in
    nats, in C's dtype."""
    dtype = C.dtype
    ip = ip.to(dtype)
    jp = jp.to(dtype)
    pm = ip[..., :, None] * jp[..., None, :]
    A = C + pseudocount * pm
    Z = torch.sum(A * pm, dim=(-2, -1), keepdim=True)
    P = A / torch.clamp(Z, min=torch.finfo(dtype).tiny)
    jointH = torch.sum(_xlogx(P) * pm, dim=(-2, -1))
    # j-marginal: full sum over ALL i-states (mi.hpp:173)
    amarg = torch.sum(P, dim=-2)
    icondH = torch.sum(_xlogx(amarg) * jp, dim=-1)
    # i-marginal: masked sum over present j-states (mi.hpp:174,178)
    bmarg = torch.sum(P * jp[..., None, :], dim=-1)
    jcondH = torch.sum(_xlogx(bmarg) * ip, dim=-1)
    return jointH - icondH - jcondH
