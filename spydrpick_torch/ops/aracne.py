"""Kernel A, ``aracne_flags``: ARACNE's DPI flags of the sorted edges on
their device (``csrc/aracne.cu``, design notes there).

Edge (a, b, w) is indirect iff some common neighbour c has ``min(w_ac,
w_bc) >= w + max(threshold, 0)``, all in float64: the rule of the host
owner-scan ``native/aracne.cpp`` and of ``engine/aracne.py``
(``run_aracne``, ``aracne_mark_indirect``), which stay as the host
functions they are.  The flag is 1 for a direct (kept) edge, 0 for an
indirect one, as uint8 on the edges' device.

Both versions first build a CSR with torch ops (``device_csr``): one sort
of the 2E half-edge keys ``node * 2^32 + neighbour``, the weights taken
in that order, and the row offsets from ``bincount`` + ``cumsum``, so each
node's neighbours lie ascending.  On CUDA tensors ``aracne_flags``
launches the scan kernel (one warp per edge, binary searches into the
longer endpoint's row); on CPU tensors it runs ``aracne_flags_plain``, the
port of ``aracne_mark_indirect``'s chunked ``searchsorted`` over the CSR
keys to torch ops, which runs on any device and is the card-side
reference.  Both refuse an edge set that repeats a pair.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spydrpick_torch.engine.aracne import DEFAULT_EDGE_THRESHOLD
from spydrpick_torch.ops import cuda_build

FLAT_BUDGET = 1 << 21  # the plain version's candidates per chunk (aracne_mark_indirect's)


@dataclasses.dataclass
class DeviceCSR:
    """Sorted-neighbour adjacency of an edge set, on its device."""

    keys: torch.Tensor   # (2E,) int64 node * 2^32 + neighbour, ascending
    offs: torch.Tensor   # (n_nodes + 1,) int64 row offsets
    nbr: torch.Tensor    # (2E,) int32 neighbours, ascending within a row
    wadj: torch.Tensor   # (2E,) f64 the half-edge's weight

    @property
    def degrees(self) -> torch.Tensor:
        return self.offs[1:] - self.offs[:-1]


def device_csr(ipos: torch.Tensor, jpos: torch.Tensor, mi: torch.Tensor,
               n_nodes: int) -> DeviceCSR:
    """The CSR of the edges (ipos[k], jpos[k], mi[k]) over nodes [0,
    n_nodes), on their device (module docstring)."""
    E = len(mi)
    keys, perm = torch.sort(torch.cat([(ipos << 32) | jpos, (jpos << 32) | ipos]))
    if E > 1 and bool((keys[1:] == keys[:-1]).any()):
        raise ValueError("aracne: the edge set repeats a pair")
    perm = torch.where(perm >= E, perm - E, perm)
    wadj = mi[perm]
    del perm
    offs = torch.zeros(n_nodes + 1, dtype=torch.int64, device=mi.device)
    torch.cumsum(torch.bincount(keys >> 32, minlength=n_nodes), 0, out=offs[1:])
    return DeviceCSR(keys, offs, (keys & 0xFFFFFFFF).to(torch.int32), wadj)


def _margin(threshold: float) -> float:
    """max(threshold, 0) as aracne.cpp's ``margin_add`` computes it."""
    return float(threshold) if threshold > 0 else 0.0


def aracne_flags_plain(ipos: torch.Tensor, jpos: torch.Tensor, mi: torch.Tensor,
                       threshold: float = DEFAULT_EDGE_THRESHOLD,
                       flat_budget: int = FLAT_BUDGET) -> torch.Tensor:
    """(E,) uint8 flags, 1 = direct, on the edges' device: for each edge
    (u, v), u the endpoint of smaller degree, every neighbour c of u is
    looked up in v's row by one ``searchsorted`` over the CSR keys, in
    chunks of at most ``flat_budget`` candidates (each edge whole); the
    best min(w_uc, w_vc) is compared with w + max(threshold, 0)."""
    dev = mi.device
    E = len(mi)
    if E == 0:
        return torch.zeros(0, dtype=torch.uint8, device=dev)
    a, b = ipos.to(torch.int64), jpos.to(torch.int64)
    w = mi.to(torch.float64)
    csr = device_csr(a, b, w, int(torch.maximum(a.max(), b.max())) + 1)
    deg = csr.degrees
    swap = deg[a] > deg[b]
    u, v = torch.where(swap, b, a), torch.where(swap, a, b)
    cnt = deg[u]
    cum = np.concatenate([[0], np.cumsum(cnt.cpu().numpy())])
    need = w + _margin(threshold)
    indirect = torch.zeros(E, dtype=torch.bool, device=dev)
    last = len(csr.keys) - 1
    start = 0
    while start < E:
        end = int(np.searchsorted(cum, cum[start] + flat_budget, side="right")) - 1
        end = min(max(end, start + 1), E)
        c_cnt = cnt[start:end]
        seg0 = torch.from_numpy(cum[start:end] - cum[start]).to(dev)
        rep = torch.repeat_interleave(torch.arange(end - start, device=dev), c_cnt)
        flat = (csr.offs[u[start:end]][rep]
                + torch.arange(int(cum[end] - cum[start]), device=dev) - seg0[rep])
        cand = csr.nbr[flat].to(torch.int64)
        vr = v[start:end][rep]
        query = (vr << 32) | cand
        pos = torch.searchsorted(csr.keys, query).clamp_(max=last)
        hit = (csr.keys[pos] == query) & (cand != vr)
        m = torch.where(hit, torch.minimum(csr.wadj[flat], csr.wadj[pos]),
                        torch.tensor(-np.inf, dtype=torch.float64, device=dev))
        best = torch.full((end - start,), -np.inf, dtype=torch.float64, device=dev)
        best.scatter_reduce_(0, rep, m, "amax")
        indirect[start:end] = best >= need[start:end]
        start = end
    return (~indirect).to(torch.uint8)


def _check(ipos: torch.Tensor, jpos: torch.Tensor, mi: torch.Tensor) -> int:
    """Raise on what the kernel does not take; returns the node count."""
    dev = mi.device
    E = mi.shape[0] if mi.dim() == 1 else -1
    for name, x, dtype in (("ipos", ipos, torch.int64), ("jpos", jpos, torch.int64),
                           ("mi", mi, torch.float64)):
        if x.dtype != dtype or x.dim() != 1 or len(x) != E or not x.is_contiguous() \
                or x.device != dev:
            raise ValueError(f"aracne_flags: {name} must be a contiguous 1-D {dtype} tensor "
                             f"of the edges' length on {dev}")
    if E == 0:
        return 0
    bad, top = torch.stack([((ipos >= jpos) | (ipos < 0)).any().to(torch.int64),
                            jpos.max()]).tolist()
    if bad:
        raise ValueError("aracne_flags: every edge needs 0 <= ipos < jpos")
    if top >= 2**31:
        raise ValueError(f"aracne_flags: node id {top} does not fit int32")
    return top + 1


def aracne_flags(ipos: torch.Tensor, jpos: torch.Tensor, mi: torch.Tensor,
                 threshold: float = DEFAULT_EDGE_THRESHOLD) -> torch.Tensor:
    """(E,) uint8 ARACNE flags (1 = direct) of the edges ipos < jpos
    (int64) with weights mi (f64), on their device (module docstring)."""
    if mi.device.type == "cpu":
        return aracne_flags_plain(ipos, jpos, mi, threshold)
    if not mi.is_cuda:
        raise ValueError(f"aracne_flags: unsupported device {mi.device}")
    n_nodes = _check(ipos, jpos, mi)
    E = len(mi)
    out = torch.empty(E, dtype=torch.uint8, device=mi.device)
    if E == 0:
        return out
    csr = device_csr(ipos, jpos, mi, n_nodes)
    rc = cuda_build.load().spk_aracne_scan(
        ipos.data_ptr(), jpos.data_ptr(), mi.data_ptr(), E, csr.offs.data_ptr(),
        csr.nbr.data_ptr(), csr.wadj.data_ptr(), _margin(threshold), out.data_ptr(),
        torch.cuda.current_stream(mi.device).cuda_stream)
    cuda_build.check(rc, "aracne_flags")
    aracne_flags.launches += 1
    return out


aracne_flags.launches = 0  # kernel launches (CPU calls do not count)
