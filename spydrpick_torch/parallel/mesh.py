"""Sharded all-pairs sweep over the processes of a run (port of
spydrpick_tpu/parallel/mesh.py).

The processes form a 2-D ``DeviceMesh`` named ("rows", "samples"), rank
r at (r // k, r % k) for k sample shards, the layout of the reference's
``np.array(devices).reshape(-1, k)``:

  * "rows": each group of the rows axis sweeps its share of the
    block-rows (the balanced interleaving ``balanced_row_order``, rank r
    of the axis taking ``order[r::n_rows]``), with the engine's own
    per-item steps (each row's j-windows, ``MIEngine.row_windows``: MI,
    then ``row_select`` into the rank's edge store);
  * "samples" (k > 1): each rank holds only its contiguous slice of the
    samples (``ShardedEngineView``; in codes storage a rank expands its
    operands from its own codes); an item's crosstable is made by
    kernel B4 on the rank's samples, summed over the axis (int32 for the
    int8 modes: exact), converted as K1 converts, and kernel B5 runs the
    entropy epilogue on it, so the MI equals the single-device kernels'
    bit for bit in the int8 modes (solver.py:540-583 of the reference).

Each rank sweeps its rows into a device edge store of its own, as the
single-device sweep does (``MIEngine.sweep_rows``: the count read only at
checks, overflow re-run); the ranks of a samples group re-run together,
since their rows' crosstables are collectives.  At the end colmax is
all-reduced with MAX over "rows" and each rank's store, in its sweep
order, is all-gathered over "rows" (counts first, then payloads padded
to the largest count, since gloo's all_gather takes equal sizes): every
rank ends with the same ``EdgeSet``.  The reference's store epochs,
drains and dispatch groups are not ported.

``sharded_sweep(checkpoint_path=...)`` checkpoints as the reference
does (spydrpick_tpu/parallel/mesh.py:533-547, 740-770, 854-858): every
rank loads the snapshot, and its rows leave the balanced order before
the rows are dealt out; a save, collective and at the same local row
on every rank, gathers the rows that every rank has completed, and
process 0 alone writes the file and deletes it when the sweep completes.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from spydrpick_torch.core.alignment import Alignment
from spydrpick_torch.core.alphabet import N_STATES
from spydrpick_torch.device import default_device, synchronize, to_host
from spydrpick_torch.engine import checkpoint as ckpt_mod
from spydrpick_torch.engine.solver import (
    DeviceData,
    EdgeSet,
    EngineConfig,
    MIEngine,
    SweepStatics,
    _wog_effective,
    build_device_data,
    pairs_chunk,
)
from spydrpick_torch.ops.mi_kernels import crosstab_tile, mi_epilogue, xtab_to_f32
from spydrpick_torch.ops.pairs import pairs_xtab
from spydrpick_torch.utils.profiling import count, span

# j-columns per B4 launch (a multiple of BW): bounds a block-row's
# crosstable, its f32 copy and each all-reduce to 2560 x 40960 cells at
# the default tile (420 MB of int32)
XTAB_COLS = 8192


def make_mesh(n_samples: int = 1) -> DeviceMesh:
    """The (world // n_samples, n_samples) mesh of every process of the
    run, named ("rows", "samples"), on the ranks' device type."""
    world = dist.get_world_size()
    if n_samples < 1 or world % n_samples:
        raise ValueError(f"--sample-shards {n_samples} does not divide the world size {world}")
    return init_device_mesh(default_device().type, (world // n_samples, n_samples),
                            mesh_dim_names=("rows", "samples"))


def sample_range(n_samples_total: int, n_shards: int, shard: int) -> tuple[int, int]:
    """Sample rows [lo, hi) of one shard: contiguous, sizes differing by
    at most one, so S need not divide by the shard count."""
    return (shard * n_samples_total // n_shards, (shard + 1) * n_samples_total // n_shards)


def balanced_row_order(n_rows: int) -> list[int]:
    """Interleave cheap and expensive rows: [0, R-1, 1, R-2, ...]
    (a copy of the reference's)."""
    order = []
    lo, hi = 0, n_rows - 1
    while lo <= hi:
        order.append(lo)
        if hi != lo:
            order.append(hi)
        lo += 1
        hi -= 1
    return order


def axis_size(mesh: DeviceMesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))


def shard_sample_data(alignment: Alignment, config: EngineConfig, device: torch.device,
                      n_shards: int, shard: int) -> tuple[DeviceData, SweepStatics]:
    """Device data and statics of sample shard ``shard`` of ``n_shards``
    (``sample_range``): the weights and codes of its sample rows only
    (so the engine's K-major operands and fixed14
    weight digits too), S = its row count; presence, wo-gaps presence,
    gaps, the int8 mode and its scale from the whole alignment (data built
    from a sample-sliced alignment would get those wrong, and with them
    the MI)."""
    lo, hi = sample_range(alignment.n_samples, n_shards, shard)
    return build_device_data(alignment, config, device, samples=(lo, hi))


class ShardedEngineView(MIEngine):
    """This rank's sample shard of the engine (``shard_sample_data``),
    whose block-rows and pairs are summed over the "samples" axis of the
    mesh, so it answers as the single-device engine does:

      * ``row_mi`` / ``row_mi_dual``: B4 on the rank's samples, in
        ``XTAB_COLS``-wide j-chunks of the item (i0, j0, W), each
        all-reduced over "samples", converted (``xtab_to_f32``) and
        finished by B5;
      * ``pair_mi``, ``pair_wog``, ``pair_quantiles`` (tournament, lazy
        wog): the pairs' codes of every shard are all-gathered in shard
        order and reduced over all samples with all the weights by
        ``pairs_xtab``, the single-device op on the same tensors, so the
        values are the single-device ones bit for bit.  (Summing per-shard
        f32 crosstables, the reference's psum, reassociated f32 sums and
        moved ~10% of the printed 6-decimal wo-gaps values at S=3000.)

    Every rank of a samples group must call these together."""

    def __init__(self, alignment: Alignment, config: EngineConfig, mesh: DeviceMesh,
                 device: torch.device | None = None):
        device = default_device() if device is None else torch.device(device)
        S, n_samp = alignment.n_samples, axis_size(mesh, "samples")
        super().__init__(alignment, config, device, _prebuilt=shard_sample_data(
            alignment, config, device, n_samp, mesh.get_local_rank("samples")))
        self.mesh = mesh
        self.group = mesh.get_group("samples")
        self._shard_rows = [sample_range(S, n_samp, r) for r in range(n_samp)]
        w = (np.ones(S) if alignment.weights is None
             else np.asarray(alignment.weights, dtype=np.float64))
        self._weights_all = torch.from_numpy(w).to(device=self.device, dtype=torch.float32)
        # the gathered (S, P) codes span every sample
        self._pairs_chunk = pairs_chunk(S)

    def pairs_table(self, ipos: torch.Tensor, jpos: torch.Tensor) -> torch.Tensor:
        d = self.data
        mine = torch.stack((d.codes.index_select(1, ipos), d.codes.index_select(1, jpos)))
        rows = max(hi - lo for lo, hi in self._shard_rows)
        pad = torch.full((2, rows, mine.shape[2]), 255, dtype=torch.uint8, device=self.device)
        pad[:, :mine.shape[1]] = mine
        parts = [torch.empty_like(pad) for _ in self._shard_rows]
        dist.all_gather(parts, pad, group=self.group)
        codes = torch.cat([p[:, :hi - lo] for p, (lo, hi) in zip(parts, self._shard_rows)],
                          dim=1)
        return pairs_xtab(codes[0], codes[1], self._weights_all)

    def _split_row(self, i0: int, j0: int | None, W: int | None, dual: bool):
        """mi (and raw wog when ``dual``) of the item (i0, j0, W) through
        B4 -> all-reduce over "samples" -> f32 -> B5, chunk by chunk."""
        j0, W = self._item(i0, j0, W)
        xi_hi, xi_lo, xj, ipf, jpf, pc, bw, mults, scale = self.row_args(i0, j0, W)
        ipwf = self._pwslab[i0 * N_STATES:(i0 + self.tile) * N_STATES]
        jpwf = self._pwslab[j0 * N_STATES:(j0 + W) * N_STATES]
        mis, wogs = [], []
        for k0 in range(0, W, XTAB_COLS):
            cols = slice(k0 * N_STATES, min(k0 + XTAB_COLS, W) * N_STATES)
            C = crosstab_tile(xi_hi, xi_lo, xj[:, cols], bw, mults)            # B4
            dist.all_reduce(C, group=self.group)
            C = xtab_to_f32(C, scale)
            jp = jpf[cols]
            if dual:
                mi, wog = mi_epilogue(C, ipf, jp, ipwf, jpwf[cols], pc, bw)       # B5
                wogs.append(wog)
            else:
                mi = mi_epilogue(C, ipf, jp, pseudocount=pc, bw=bw)                # B5
            mis.append(mi)
            del C
        cat = lambda xs: xs[0] if len(xs) == 1 else torch.cat(xs, dim=1)
        return cat(mis), (cat(wogs) if dual else None)

    def row_mi(self, i0: int, j0: int | None = None, W: int | None = None) -> torch.Tensor:
        return self._split_row(i0, j0, W, dual=False)[0]

    def row_mi_dual(self, i0: int, j0: int | None = None, W: int | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        mi, wog = self._split_row(i0, j0, W, dual=True)
        return mi, _wog_effective(self.data, self.statics, mi, wog, i0, self._item(i0, j0, W)[0])

    def row_buffers(self, i0: int, j0: int | None = None, W: int | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor | None]:
        return self._split_row(i0, j0, W, dual=not self.statics.wog_lazy)


def _gather_rows(x: torch.Tensor, counts: list[int], group) -> torch.Tensor:
    """All-gather 1-D tensors of the given per-rank lengths over ``group``,
    padded to the largest, and concatenate them in rank order."""
    n = max(max(counts), 1)  # gloo takes no empty tensors
    pad = torch.zeros(n, dtype=x.dtype, device=x.device)
    pad[:len(x)] = x
    parts = [torch.empty_like(pad) for _ in counts]
    dist.all_gather(parts, pad, group=group)
    return torch.cat([p[:c] for p, c in zip(parts, counts)])


def _gather_store(store, lo: int, rows: list[int], tile: int, width: int, group,
                  n_ranks: int) -> list[np.ndarray]:
    """Store slots [lo, store.checked) of every rank of ``group``, each
    rank's in its sweep order (``EdgeStore.ordered`` over its ``rows``),
    concatenated in rank order on the host (``to_host``) and widened:
    (ipos, jpos as int64, mi[, wog] as float64)."""
    local = store.ordered(lo, store.checked, rows, tile, width)
    n = torch.tensor([store.checked - lo], dtype=torch.int64, device=store.count.device)
    ns = [torch.empty_like(n) for _ in range(n_ranks)]
    dist.all_gather(ns, n, group=group)
    counts = [int(x) for x in ns]
    return to_host([_gather_rows(x, counts, group) for x in local],
                   dtypes=[torch.int64, torch.int64, torch.float64, torch.float64][:len(local)])


def checkpoint_key(engine: MIEngine, threshold: float, mesh: DeviceMesh) -> str:
    """The key of a sweep snapshot over ``mesh``, as the reference keys
    it (``ckpt_mod.params_key``).  On a rows-only mesh every rank's
    engine is the whole-alignment ``MIEngine``, so the key is the
    one-process key and a snapshot resumes in one process and the other
    way round.  A ``ShardedEngineView`` is keyed as the reference keys
    its view: S is the alignment's sample count rounded up to a multiple
    of the shard count (spydrpick_tpu/parallel/mesh.py:shard_sample_data
    without Pallas).  Such a snapshot crosses over to one process only
    where the shard count divides S; its MI is the one-process MI bit
    for bit in the int8 modes, while bf16 shards sum in another f32
    order."""
    st = engine.statics
    if isinstance(engine, ShardedEngineView):
        k = axis_size(mesh, "samples")
        st = dataclasses.replace(st, S=-(-engine.alignment.n_samples // k) * k)
    return ckpt_mod.params_key(st, threshold)


def load_snapshot(path: str | None, key: str, L: int,
                  device: torch.device) -> ckpt_mod.SweepCheckpoint:
    """The snapshot at ``path`` with this run's ``key``, or an empty one;
    called by every rank together when there is a path.  Every rank must
    deal out the same rows: the all-reduce that checks that they loaded
    the same rows also holds process 0 back from its first save (which
    replaces the file) until every rank has loaded it."""
    snap = ckpt_mod.load(path, key) if path else None
    if snap is None:
        snap = ckpt_mod.SweepCheckpoint(key, set(), np.full(L, -np.inf), [], [], [], [])
    if path:
        n, s = len(snap.done_rows), sum(snap.done_rows)
        t = torch.tensor([n, s, -n, -s], dtype=torch.int64, device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        if t[0] != -t[2] or t[1] != -t[3]:
            raise RuntimeError(f"the ranks loaded different snapshots of {path}")
    return snap


def sharded_sweep(engine: MIEngine, threshold: float, mesh: DeviceMesh, progress=None,
                  checkpoint_path: str | None = None, checkpoint_every: int = 16) -> EdgeSet:
    """All-pairs sweep over the mesh; every rank returns the same
    ``EdgeSet``, equal to ``MIEngine.sweep``'s on one device (bit for bit
    in the int8 modes; bf16 crosstables of sample shards sum in another
    f32 order).  ``engine``: a whole-alignment ``MIEngine`` on a mesh with
    one sample shard, a ``ShardedEngineView`` of this rank's shard
    otherwise.  ``progress`` as for ``MIEngine.sweep`` (over this rank's
    rows).

    ``checkpoint_path``: a snapshot with this run's key
    (``checkpoint_key``) resumes it on every rank (``load_snapshot``):
    its rows leave the balanced order before the rows are dealt out, its
    colmax is every rank's start, and its edges join the gathered ones
    once at the end.  Saves come after every ``checkpoint_every``
    block-rows swept over the mesh (the reference's count), except after
    the last: after the same local row on every rank, which each rank of
    the rows axis reaches, a collective save all-reduces colmax and
    gathers each rank's store slots since its last save (its checks have
    re-swept any overflow by then, so no saved row is truncated), and
    process 0 writes the rows that every rank has completed.  Process 0
    deletes the file when the sweep completes.  Spans rows (with
    rows.save), fetch and wog, as for ``MIEngine.sweep``; the counter
    edges_stored counts the edges returned."""
    if axis_size(mesh, "samples") > 1 and not isinstance(engine, ShardedEngineView):
        raise ValueError("a mesh with sample shards sweeps a ShardedEngineView")
    rows_group = mesh.get_group("rows")
    n_rows_sh = axis_size(mesh, "rows")
    st, dev = engine.statics, engine.device
    T, L, Lp = st.tile, st.L, st.Lp
    synchronize(dev)
    with span("rows"):
        snap = load_snapshot(checkpoint_path, checkpoint_key(engine, threshold, mesh), L, dev)
        colmax = torch.full((Lp,), -np.inf, dtype=torch.float32, device=dev)
        colmax[:L] = torch.from_numpy(snap.colmax).to(device=dev, dtype=torch.float32)
        order = [r * T for r in balanced_row_order(-(-L // T)) if r * T not in snap.done_rows]
        mine = order[mesh.get_local_rank("rows")::n_rows_sh]
        agree = None
        if axis_size(mesh, "samples") > 1:
            samples_group = mesh.get_group("samples")

            def agree(n: int) -> int:
                t = torch.tensor([n], dtype=torch.int64, device=dev)
                dist.all_reduce(t, op=dist.ReduceOp.MAX, group=samples_group)
                return int(t)

        store = engine.new_store()
        # round k sweeps the k-th row of every rank of the rows axis; saves
        # fall in rounds that every rank sweeps, the last round excepted
        rounds = max(1, -(-checkpoint_every // n_rows_sh))
        saves = (frozenset(k for k in range(rounds - 1, len(order) // n_rows_sh, rounds)
                           if (k + 1) * n_rows_sh < len(order))
                 if checkpoint_path else frozenset())
        writer = dist.get_rank() == 0
        written = dataclasses.replace(snap, done_rows=set(snap.done_rows),
                                      ipos=list(snap.ipos), jpos=list(snap.jpos),
                                      mi=list(snap.mi), mi_wog=list(snap.mi_wog))
        saved = 0

        def save(k):
            nonlocal saved
            with span("save"):
                cm = colmax.clone()
                dist.all_reduce(cm, op=dist.ReduceOp.MAX, group=rows_group)
                new = _gather_store(store, saved, mine, T, Lp, rows_group, n_rows_sh)
                saved = store.checked
                if writer:
                    written.ipos.append(new[0])
                    written.jpos.append(new[1])
                    written.mi.append(new[2])
                    written.mi_wog.append(new[2] if store.wog is None else new[3])
                    written.done_rows.update(order[:(k + 1) * n_rows_sh])
                    written.colmax = cm[:L].cpu().numpy().astype(np.float64)
                    ckpt_mod.save(checkpoint_path, written)

        engine.sweep_rows(mine, threshold, colmax, store, progress, saves, save, agree=agree)
        synchronize(dev)
    with span("fetch"):
        dist.all_reduce(colmax, op=dist.ReduceOp.MAX, group=rows_group)
        got = _gather_store(store, 0, mine, T, Lp, rows_group, n_rows_sh)
        cat = ckpt_mod.concat
        s_i = cat(snap.ipos + [got[0]], np.int64)
        s_j = cat(snap.jpos + [got[1]], np.int64)
        s_m = cat(snap.mi + [got[2]], np.float64)
        colmax_h = colmax[:L].cpu().numpy().astype(np.float64)
    with span("wog"):
        if st.wog_lazy:
            # snapshot and fresh rows alike hold mi placeholders
            s_w = engine._resolve_deferred_wog(s_m, s_i, s_j, colmax_h)
        else:
            s_w = cat(snap.mi_wog + [got[3]], np.float64)
        if checkpoint_path and writer and os.path.exists(checkpoint_path):
            os.unlink(checkpoint_path)  # run completed; stale resume data
    count("edges_stored", len(s_i))
    return EdgeSet(ipos=s_i, jpos=s_j, mi=s_m, mi_wog=s_w, colmax=colmax_h)
