"""Kernel B2, ``row_select``: one pass per sweep item that thresholds
the row's MI, updates colmax and appends the edges to a device edge store
(port of spydrpick_tpu/ops/compact_route.py:route_rows_pallas together
with the mask and colmax part of spydrpick_tpu/engine/solver.py:
row_sweep_core).

``EdgeStore`` is the sweep's device edge store: ``capacity`` slots of
(ipos int32, jpos int32, mi f32, wog f32; no wog in lazy sweeps) and a
one-element int64 ``count`` of the edges appended.  Appends past the
capacity are dropped but still counted, so the host, which reads the
count only now and then, sees the overflow, grows the store and sweeps
the rows again (engine/solver.py:MIEngine.sweep_rows).  ``ordered``
gives a slice of the store in sweep order.

``row_select(mi, wog, gap, orig_pos, colmax, store, i0, ..., j0=...)`` takes
an item's (T, W) f32 MI buffer (K1's, or B3's mi and raw wog): block-row i0
against the columns [j0, j0 + W), the full-width row (j0 = i0, W = Lp - i0)
or one of its j-windows, and:
  * updates ``colmax`` in place with the row and column maxima of the
    buffer over the colmax mask (valid, upper triangle, genome distance
    > ld_threshold; ``select_masks``);
  * appends every pair of the store mask (valid, upper triangle,
    mi > threshold in f32) as (i, j, mi[, wog]), wog being the raw wog
    where column i or j has gaps and mi elsewhere (``_wog_effective`` of
    the engine, for survivors only).
On CUDA tensors it launches ``csrc/row_select.cu`` (design notes there),
whose atomics leave the appended edges in no fixed order; on CPU tensors
it runs ``row_select_plain``, which appends them row-major.  Maxima take
one total order on floats, -0 below +0 (``_ordered``), so colmax is the
same bits whatever the order of the work; plain torch.maximum keeps
either zero of a +-0 tie by position.

``route_rows`` / ``route_rows_plain`` are the per-row compaction the
sweep ran before (lanes [0, counts[r]) of row r hold the masked values
and their row-local column indices in ascending column order; lanes past
counts[r] are zero), kept as a plain PyTorch function of CPU tensors; no
kernel serves it on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from spydrpick_torch.ops import cuda_build
from spydrpick_torch.utils.profiling import count

_KEY_BITS = 0x7FFFFFFF


def _ordered(x: torch.Tensor) -> torch.Tensor:
    """The int32 image of f32 ``x`` that orders as the floats do, with -0
    below +0; applied to an int32 image, the same map gives the floats'
    bits back."""
    b = x.view(torch.int32) if x.dtype == torch.float32 else x
    return b ^ ((b >> 31) & _KEY_BITS)


class EdgeStore:
    """A sweep's device edge store (module docstring).  ``checked`` is
    the count at the sweep's last read of it, on the host."""

    def __init__(self, capacity: int, with_wog: bool, device: torch.device):
        if capacity < 1:
            raise ValueError(f"edge store capacity {capacity} must be positive")
        self.capacity = capacity
        self.ipos = torch.empty(capacity, dtype=torch.int32, device=device)
        self.jpos = torch.empty(capacity, dtype=torch.int32, device=device)
        self.mi = torch.empty(capacity, dtype=torch.float32, device=device)
        self.wog = torch.empty(capacity, dtype=torch.float32, device=device) if with_wog else None
        self.count = torch.zeros(1, dtype=torch.int64, device=device)
        self.checked = 0

    def arrays(self) -> tuple[torch.Tensor, ...]:
        return (self.ipos, self.jpos, self.mi) + (() if self.wog is None else (self.wog,))

    def grow(self, capacity: int) -> None:
        """Reallocate to ``capacity`` slots, keeping slots [0, checked);
        counted by the counter store_grows."""
        count("store_grows")
        n = self.checked
        for name in ("ipos", "jpos", "mi", "wog"):
            old = getattr(self, name)
            if old is not None:
                new = torch.empty(capacity, dtype=old.dtype, device=old.device)
                new[:n] = old[:n]
                setattr(self, name, new)
        self.capacity = capacity

    def append_plain(self, *cols: torch.Tensor) -> None:
        """Append edges in the given order, as the kernel does: slots past
        the capacity are dropped, the count counts them."""
        n0, n = int(self.count), len(cols[0])
        take = max(0, min(n, self.capacity - n0))
        for dst, src in zip(self.arrays(), cols):
            dst[n0:n0 + take] = src[:take]
        self.count += n

    def sweep_order(self, lo: int, hi: int, rows: list[int], tile: int,
                    width: int) -> torch.Tensor:
        """The permutation that puts slots [lo, hi) in sweep order: by the
        visit index of the block-row in ``rows`` (block-row starts in the
        order swept), then i, then j (< ``width``); one sort of a unique
        int64 key on the device."""
        if hi <= lo:
            return torch.zeros(0, dtype=torch.int64, device=self.ipos.device)
        rank = torch.zeros(max(rows) // tile + 1, dtype=torch.int64)
        rank[[r // tile for r in rows]] = torch.arange(len(rows))
        rank = rank.to(self.ipos.device)
        ip = self.ipos[lo:hi].to(torch.int64)
        blk = ip // tile
        key = (rank[blk] * tile + ip - blk * tile) * width + self.jpos[lo:hi]
        return torch.argsort(key)

    def ordered(self, lo: int, hi: int, rows: list[int], tile: int,
                width: int) -> tuple[torch.Tensor, ...]:
        """Slots [lo, hi) in sweep order (``sweep_order``)."""
        order = self.sweep_order(lo, hi, rows, tile, width)
        return tuple(a[lo:hi][order] for a in self.arrays())


def select_masks(orig_pos: torch.Tensor, i0: int, T: int, j0: int, W: int, n_loci: int,
                 ld_threshold: int, linear_genome: bool, genome_size: int):
    """(store_base, colmax_mask), each (T, W) bool, for block-row i0 over
    columns [j0, j0 + W) (solver.py:643-668 of the reference).
    store_base: valid upper-triangle pairs (storage is not LD-gated,
    mi.hpp:430-434); colmax_mask also needs genome distance >
    ld_threshold (mi.hpp:423-427)."""
    dev = orig_pos.device
    i_global = i0 + torch.arange(T, dtype=torch.int32, device=dev)
    j_global = j0 + torch.arange(W, dtype=torch.int32, device=dev)
    valid = (i_global[:, None] < n_loci) & (j_global[None, :] < n_loci)
    upper = j_global[None, :] > i_global[:, None]
    d = torch.abs(orig_pos[i0:i0 + T, None] - orig_pos[None, j0:j0 + W])
    if not linear_genome:
        d = torch.minimum(d, genome_size - d)
    store_base = valid & upper
    return store_base, store_base & (d > ld_threshold)


def row_select_plain(mi, wog, gap, orig_pos, colmax, store: EdgeStore, i0: int, n_loci: int,
                     threshold: float, ld_threshold: int, linear_genome: bool,
                     genome_size: int, j0: int | None = None) -> None:
    """Plain-PyTorch twin of the kernel (the CPU path, and the card-side
    reference): the masks of ``select_masks``, colmax over int32
    ``_ordered`` images, the survivors in row-major order."""
    T, W = mi.shape
    j0 = i0 if j0 is None else j0
    store_base, colmax_mask = select_masks(orig_pos, i0, T, j0, W, n_loci, ld_threshold,
                                           linear_genome, genome_size)
    keys = _ordered(torch.where(colmax_mask, mi, torch.tensor(-np.inf, device=mi.device)))
    cm = _ordered(colmax)
    cm[j0:j0 + W] = torch.maximum(cm[j0:j0 + W], keys.amax(dim=0))
    cm[i0:i0 + T] = torch.maximum(cm[i0:i0 + T], keys.amax(dim=1))
    colmax.view(torch.int32).copy_(_ordered(cm))
    thr = torch.tensor(threshold, dtype=torch.float32, device=mi.device)
    rows, cols = (store_base & (mi > thr)).nonzero(as_tuple=True)
    ipos, jpos = (rows + i0).to(torch.int32), (cols + j0).to(torch.int32)
    vals = mi[rows, cols]
    if wog is None:
        store.append_plain(ipos, jpos, vals)
    else:
        store.append_plain(ipos, jpos, vals,
                           torch.where(gap[ipos] | gap[jpos], wog[rows, cols], vals))


def _check_select(mi, wog, gap, orig_pos, colmax, store: EdgeStore, i0: int, j0: int) -> None:
    """Raise on what the kernel does not take."""
    T, W = mi.shape if mi.dim() == 2 else (0, -1)
    Lp = orig_pos.shape[0]
    dev = mi.device
    if (mi.dtype != torch.float32 or not mi.is_contiguous() or mi.data_ptr() % 16
            or W % 4 or j0 % 4 or not 0 <= j0 <= j0 + W <= Lp or not 0 <= i0 <= i0 + T <= Lp):
        raise ValueError("row_select: mi must be a contiguous 16-byte aligned (T, W) f32 "
                         "tensor of rows [i0, i0 + T) and columns [j0, j0 + W) within Lp, "
                         "j0 and W multiples of 4")
    if (wog is None) != (store.wog is None):
        raise ValueError("row_select: give wog exactly when the store keeps it")
    if wog is not None and (wog.dtype != torch.float32 or wog.shape != mi.shape
                            or not wog.is_contiguous() or wog.data_ptr() % 16
                            or wog.device != dev):
        raise ValueError("row_select: wog must be contiguous 16-byte aligned f32 of mi's shape")
    for name, x, dtype, align in (("gap", gap, torch.bool, 4),
                                  ("orig_pos", orig_pos, torch.int32, 16),
                                  ("colmax", colmax, torch.float32, 4)):
        if (x.dtype != dtype or x.shape != (Lp,) or not x.is_contiguous()
                or x.data_ptr() % align or x.device != dev):
            raise ValueError(f"row_select: {name} must be a contiguous {align}-byte aligned "
                             f"(Lp,) {dtype} tensor on {dev}")
    if any(a.device != dev for a in store.arrays() + (store.count,)):
        raise ValueError("row_select: the store lies on another device")
    if Lp >= 2**31:
        raise ValueError(f"row_select: {Lp} columns exceed int32 indexing")


def row_select(mi, wog, gap, orig_pos, colmax, store: EdgeStore, i0: int, n_loci: int,
               threshold: float, ld_threshold: int, linear_genome: bool,
               genome_size: int, j0: int | None = None) -> None:
    """Select the rows [i0, i0 + T) x columns [j0, j0 + W) of a sweep
    into ``store`` and ``colmax`` (module docstring).  ``mi`` (and
    ``wog``, raw, or None in a lazy sweep): the (T, W) f32 row buffer,
    its first column the global column ``j0`` (a j-window; by default i0:
    the full-width block-row, W = Lp - i0); ``gap`` (Lp,) bool,
    ``orig_pos`` (Lp,) int32 and ``colmax`` (Lp,) f32 span every
    column."""
    j0 = i0 if j0 is None else j0
    args = (mi, wog, gap, orig_pos, colmax, store, i0, n_loci, threshold, ld_threshold,
            linear_genome, genome_size, j0)
    if mi.device.type == "cpu":
        return row_select_plain(*args)
    if not mi.is_cuda:
        raise ValueError(f"row_select: unsupported device {mi.device}")
    _check_select(mi, wog, gap, orig_pos, colmax, store, i0, j0)
    T, W = mi.shape
    if T == 0 or W == 0:
        return
    ptr = lambda x: None if x is None else x.data_ptr()
    lib = cuda_build.load()
    rc = lib.spk_row_select(
        mi.data_ptr(), ptr(wog), gap.data_ptr(), orig_pos.data_ptr(), colmax.data_ptr(),
        store.ipos.data_ptr(), store.jpos.data_ptr(), store.mi.data_ptr(), ptr(store.wog),
        store.count.data_ptr(), store.capacity, T, W, i0, j0, n_loci,
        float(np.float32(threshold)), ld_threshold, 0 if linear_genome else 1, genome_size,
        torch.cuda.current_stream(mi.device).cuda_stream)
    cuda_build.check(rc, "row_select")
    row_select.launches += 1


row_select.launches = 0  # kernel launches (CPU calls do not count)


def route_rows_plain(mask: torch.Tensor, mi: torch.Tensor,
                     wog: torch.Tensor | None = None):
    """Each survivor's lane is its rank among the row's survivors (a
    cumulative sum), written by a scatter whose indices are unique, so the
    result is deterministic."""
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
    payloads carried verbatim (module docstring).  CPU tensors only."""
    if mask.device.type != "cpu":
        raise ValueError(f"route_rows: unsupported device {mask.device} (a plain CPU "
                         "function; the sweep's kernel is row_select)")
    return route_rows_plain(mask, mi, wog)
