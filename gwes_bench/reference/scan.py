"""Plain reference of one GWES scan, in PyTorch and NumPy.

It works out from the alignment's codes everything a scan of
``python -m spydrpick_torch aln.fasta`` derives, by the rules of the
SpydrPick reference (README; mi.hpp, SpydrPick.hpp, ARACNE.hpp) as the
port documents them:

  * the column filter: keep a column with more than one non-gap state,
    a second most frequent non-gap state at a frequency >= maf, and a gap
    frequency <= gap, all over the unweighted sample count;
  * the sample weights: 1 / the number of samples whose share of
    identical kept columns (the gap state included) is at least the
    reweighting threshold; all 1.0 with ``--no-sample-reweighting``;
  * the weighted 5 x 5 crosstable of a column pair,
    ``C[a, b] = sum_s w_s [x_si == a][x_sj == b]``, and its MI with a
    pseudocount on the present cells (``mi_from_tables``);
  * the tournament: ``iterations`` samples of unique (i < j) pairs, drawn
    from ``numpy.random.default_rng(seed)`` in the stream of
    ``draw_pairs``; each sample's ascending order statistic at
    ``floor(percentile * pairs)``; the lower median of the samples;
  * the save threshold: ``--mi-threshold`` where it is held (>= 0), else
    the tournament's;
  * the sweep: every pair i < j with MI > threshold is an edge; colmax is
    each column's largest MI over its pairs at a genome distance (the
    couplings file's, ``render.positions``) above the LD threshold;
  * the outlier thresholds: Q3 + 1.5 IQR and Q3 + 3 IQR of colmax, with
    indexing quartiles ``sorted(colmax)[n // 4 * q]``;
  * the gaps-excluded MI of an edge: the same table with the gap state
    cleared from both presence masks, where either column has gaps; the
    MI elsewhere;
  * ARACNE (``aracne_direct``): an edge (a, b, w) is indirect when a common
    neighbour c has ``min(w_ac, w_bc) >= w + max(threshold, 0)``;
  * the sort: MI descending, ties by (i, j) ascending.

Nothing here imports the program (``spydrpick_torch``) or the JAX
package.  The crosstables run in ``table_dtype`` and the MI in
``mi_dtype``: float64 both for the reference, lower precisions for the
control (``control.py``).
"""

from __future__ import annotations

import numpy as np
import torch

N_STATES = 5
GAP = 4
TILE = 512            # block-row height of the sweep
J_CHUNK = 16384       # columns of one crosstable product
PAIRS_CHUNK = 16384   # pairs of one pairs-table step
ARACNE_BUDGET = 1 << 25  # candidate lookups per ARACNE step


# --------------------------------------------------------------------------- #
# column statistics and the filter

def state_counts(codes: torch.Tensor) -> torch.Tensor:
    """(L, 5) int64 unweighted state counts of (S, L) uint8 codes."""
    return torch.stack([(codes == s).sum(0) for s in range(N_STATES)], dim=1)


def filter_kept(counts: np.ndarray, n_samples: int, maf: float, gap: float) -> np.ndarray:
    """Indices of the columns that pass the filter (module docstring)."""
    c = counts.astype(np.float64)
    nongap = c[:, :GAP]
    second = np.sort(nongap, axis=1)[:, -2]
    keep = ((nongap > 0).sum(axis=1) > 1) & (second / n_samples >= maf) \
        & (c[:, GAP] / n_samples <= gap)
    return np.flatnonzero(keep)


# --------------------------------------------------------------------------- #
# MI of crosstables

def mi_from_tables(C: torch.Tensor, ip: torch.Tensor, jp: torch.Tensor,
                   pc: float) -> torch.Tensor:
    """MI in nats of (..., 5, 5) tables with (..., 5) 0/1 presence masks of
    the i and the j column (broadcast against the tables' leading axes),
    in C's dtype:

      A = C + pc * outer(ip, jp);  Z = sum of A over the present cells;
      P = A / Z;  MI = sum_present xlogx(P) - sum_{b in jp} xlogx(sum_a P[a, b])
                       - sum_{a in ip} xlogx(sum_{b in jp} P[a, b]),

    the j-side marginal summing the table's whole column over every
    i-state (mi.hpp:173)."""
    ip = ip.to(C.dtype)
    jp = jp.to(C.dtype)
    ipb, jpb = ip[..., :, None], jp[..., None, :]
    A = torch.addcmul(C, ipb, jpb, value=pc)
    rows = (A * jpb).sum(dim=-1)                  # sum over the present j-states
    Z = (rows * ip).sum(dim=-1)
    P = A / Z[..., None, None]
    del A
    joint = ((torch.special.xlogy(P, P) * jpb).sum(dim=-1) * ip).sum(dim=-1)
    col = P.sum(dim=-2)
    del P
    row = rows / Z[..., None]
    hj = (torch.special.xlogy(col, col) * jp).sum(dim=-1)
    hi = (torch.special.xlogy(row, row) * ip).sum(dim=-1)
    return joint - hj - hi


# --------------------------------------------------------------------------- #
# the tournament's draws (the program's seeded stream, frozen here)

def threshold_pairs(possible: int, percentile: float) -> int:
    """Pairs per tournament sample: from 100,000, +10,000 while the tail
    above the percentile holds < 100 values, at most 500,000, and never
    above possible / 10 (SpydrPick.hpp:257-282)."""
    n = 100_000
    while n - percentile * n < 100 and n < 500_000:
        n += 10_000
    return min(n, possible // 10)


def draw_pairs(rng: np.random.Generator, n_pairs: int, n_loci: int):
    """One sample of unique (i < j) pairs: draws of (a, b) with a != b in
    rounds of 1.3x what is missing, new keys appended in ascending key
    order, then a permutation, the first ``n_pairs`` kept."""
    got = np.empty(0, dtype=np.int64)
    while len(got) < n_pairs:
        need = n_pairs - len(got)
        a = rng.integers(0, n_loci, size=int(need * 1.3) + 16)
        b = rng.integers(0, n_loci, size=len(a))
        ok = a != b
        a, b = a[ok], b[ok]
        keys = np.minimum(a, b) * n_loci + np.maximum(a, b)
        got = np.concatenate([got, np.setdiff1d(keys, got)])
    got = rng.permutation(got)[:n_pairs]
    return got // n_loci, got % n_loci


# --------------------------------------------------------------------------- #

class Reference:
    """The alignment's kept columns on ``device`` and the reference's
    computations over them (module docstring)."""

    def __init__(self, codes: np.ndarray, params: dict, device: torch.device,
                 table_dtype: torch.dtype = torch.float64,
                 mi_dtype: torch.dtype = torch.float64):
        self.device = device
        self.table_dtype = table_dtype
        self.mi_dtype = mi_dtype
        self.params = params
        codes_all = torch.from_numpy(np.ascontiguousarray(codes)).to(device)
        self.S, L0 = codes.shape
        self.n_original = params["genome_size"] or L0
        counts = state_counts(codes_all).cpu().numpy()
        self.kept = (np.arange(L0) if params["no_filter_alignment"] else
                     filter_kept(counts, self.S, params["maf_threshold"],
                                 params["gap_threshold"]))
        self.codes = codes_all[:, torch.from_numpy(self.kept).to(device)].contiguous()
        del codes_all
        self.L = len(self.kept)
        kc = torch.from_numpy(counts[self.kept]).to(device)
        self.presence = kc > 0
        self.presence_wog = self.presence.clone()
        self.presence_wog[:, GAP] = False
        self.gap = self.presence[:, GAP]
        self.states = torch.arange(N_STATES, dtype=torch.uint8, device=device)
        self.pos = torch.from_numpy(self.kept).to(device)
        if params["no_sample_reweighting"]:
            self.w64 = torch.ones(self.S, dtype=torch.float64, device=device)
        else:
            w = self.cluster_weights(params["sample_reweighting_threshold"])
            self.w64 = torch.from_numpy(w).to(device)

    def cluster_weights(self, threshold: float) -> np.ndarray:
        """1 / the number of samples whose share of identical kept
        columns (the gap state included) is >= ``threshold``."""
        match = torch.zeros((self.S, self.S), dtype=torch.float64, device=self.device)
        for s in range(N_STATES):
            x = (self.codes == s).to(torch.float64)
            match += x @ x.T
        similar = (match >= threshold * self.L).sum(dim=1)
        return (1.0 / similar.to(torch.float64)).cpu().numpy()

    # ---------------------------------------------------------------- tables
    def _weights(self, dtype: torch.dtype) -> torch.Tensor:
        return self.w64.to(dtype)

    def pair_tables(self, ii: torch.Tensor, jj: torch.Tensor) -> torch.Tensor:
        """(P, 5, 5) crosstables of the pairs (ii, jj): one product per
        pair of the weighted i one-hot and the j one-hot over the
        samples, in the table dtype."""
        dt = self.table_dtype
        oi = (self.codes[:, ii, None] == self.states).to(dt)   # (S, P, 5)
        oj = (self.codes[:, jj, None] == self.states).to(dt)
        oi = oi * self._weights(dt)[:, None, None]
        return torch.bmm(oi.permute(1, 2, 0), oj.permute(1, 0, 2))

    def pair_mi(self, ii: np.ndarray, jj: np.ndarray, wog: bool = False) -> np.ndarray:
        """float64 MI of explicit pairs (with ``wog``: the effective
        gaps-excluded MI), in steps of PAIRS_CHUNK pairs."""
        out = []
        for lo in range(0, len(ii), PAIRS_CHUNK):
            i = torch.from_numpy(np.asarray(ii[lo:lo + PAIRS_CHUNK], np.int64)).to(self.device)
            j = torch.from_numpy(np.asarray(jj[lo:lo + PAIRS_CHUNK], np.int64)).to(self.device)
            C = self.pair_tables(i, j).to(self.mi_dtype)
            pc = self.params["mi_pseudocount"]
            mi = mi_from_tables(C, self.presence[i], self.presence[j], pc)
            if wog:
                mw = mi_from_tables(C, self.presence_wog[i], self.presence_wog[j], pc)
                mi = torch.where(self.gap[i] | self.gap[j], mw, mi)
            out.append(mi.double().cpu().numpy())
        return np.concatenate(out) if out else np.zeros(0)

    # ------------------------------------------------------------ threshold
    def save_threshold(self) -> float:
        """The held ``--mi-threshold`` where it is >= 0; else the
        tournament's on the scan's seed."""
        held = self.params["mi_threshold"]
        return float(held) if held >= 0 else self.tournament(self.params["seed"])

    def tournament(self, seed: int) -> float:
        """The automatic MI save threshold (module docstring)."""
        L = self.L
        possible = L * (L - 1) // 2
        n_values = self.params["mi_values"] or min(10_000_000, 100 * L)
        percentile = 1.0 - n_values / possible
        n_pairs = (threshold_pairs(possible, percentile) if not self.params["mi_threshold_pairs"]
                   else min(self.params["mi_threshold_pairs"], possible // 10))
        if n_pairs <= 0 or percentile <= 0.0:
            raise ValueError("alignment too small for the tournament")
        k = min(int(percentile * n_pairs), n_pairs - 1)
        rng = np.random.default_rng(seed)
        stats = []
        for _ in range(self.params["mi_threshold_iterations"]):
            ii, jj = draw_pairs(rng, n_pairs, L)
            stats.append(np.sort(self.pair_mi(ii, jj))[k])
        stats = np.sort(np.asarray(stats))
        n = len(stats)
        return float(stats[n // 2 - (0 if n % 2 else 1)])

    # ----------------------------------------------------------------- sweep
    def blocks(self):
        """The sweep's MI in blocks: yields (i0, j0, mi) with mi the
        (T, W) float64 MI of rows [i0, i0 + T) against columns [j0, j0 + W),
        j0 >= i0; pairs with j <= i are -inf."""
        L, dt = self.L, self.table_dtype
        pc = self.params["mi_pseudocount"]
        w = self._weights(dt)
        for i0 in range(0, L, TILE):
            T = min(TILE, L - i0)
            xi = (self.codes[:, i0:i0 + T, None] == self.states).to(dt) * w[:, None, None]
            xi = xi.reshape(self.S, T * N_STATES)
            for j0 in range(i0, L, J_CHUNK):
                W = min(J_CHUNK, L - j0)
                xj = (self.codes[:, j0:j0 + W, None] == self.states).to(dt)
                C = (xi.T @ xj.reshape(self.S, W * N_STATES)).view(T, N_STATES, W, N_STATES)
                del xj
                C = C.permute(0, 2, 1, 3).to(self.mi_dtype)
                mi = mi_from_tables(C, self.presence[i0:i0 + T, None, :],
                                    self.presence[None, j0:j0 + W, :], pc).double()
                del C
                ig = torch.arange(i0, i0 + T, device=self.device)
                jg = torch.arange(j0, j0 + W, device=self.device)
                mi.masked_fill_(jg[None, :] <= ig[:, None], -np.inf)
                yield i0, j0, mi

    def fold_colmax(self, colmax: torch.Tensor, i0: int, j0: int, mi: torch.Tensor) -> None:
        """Fold a block of ``blocks`` into ``colmax`` (float64, (L,)): each
        row's and column's largest MI over the block's pairs whose genome
        distance exceeds the LD threshold."""
        T, W = mi.shape
        d = (self.pos[i0:i0 + T, None] - self.pos[None, j0:j0 + W]).abs()
        if not self.params["linear_genome"]:
            d = torch.minimum(d, self.n_original - d)
        far = mi.masked_fill(d <= self.params["ld_threshold"], -np.inf)
        colmax[i0:i0 + T] = torch.maximum(colmax[i0:i0 + T], far.amax(dim=1))
        colmax[j0:j0 + W] = torch.maximum(colmax[j0:j0 + W], far.amax(dim=0))


# --------------------------------------------------------------------------- #
# outliers, ARACNE, the order of the edges

def quartile(colmax: np.ndarray, q: int) -> float:
    vals = np.sort(np.where(np.isneginf(colmax), np.finfo(np.float64).min, colmax))
    return float(vals[len(vals) // 4 * q])


def outlier_thresholds(colmax: np.ndarray) -> tuple[float, float]:
    q1, q3 = quartile(colmax, 1), quartile(colmax, 3)
    return q3 + 1.5 * (q3 - q1), q3 + 3.0 * (q3 - q1)


def desc_order(ipos: np.ndarray, jpos: np.ndarray, mi: np.ndarray,
               device: torch.device | None = None) -> np.ndarray:
    """MI descending, ties by (i, j) ascending: a stable sort by the key
    (i, j), then a stable descending sort by MI, on ``device``."""
    dev = torch.device("cpu") if device is None else device
    i, j, m = (torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (ipos, jpos, mi))
    key = i.to(torch.int64) * (int(j.max()) + 1 if len(j) else 1) + j
    order = torch.argsort(key, stable=True)
    order = order[torch.argsort(m[order], descending=True, stable=True)]
    return order.cpu().numpy()


def aracne_direct(ipos: np.ndarray, jpos: np.ndarray, mi: np.ndarray, threshold: float,
                  n_nodes: int, device: torch.device) -> np.ndarray:
    """(E,) uint8: 1 where the edge is direct, 0 where some common
    neighbour c has min(w_ac, w_bc) >= w + max(threshold, 0), in float64.
    For each edge the neighbours of its endpoint of smaller degree are
    looked up among the other endpoint's by a binary search over the
    sorted half-edge keys, ARACNE_BUDGET lookups a step."""
    E = len(mi)
    if E == 0:
        return np.zeros(0, np.uint8)
    a = torch.from_numpy(np.asarray(ipos, np.int64)).to(device)
    b = torch.from_numpy(np.asarray(jpos, np.int64)).to(device)
    w = torch.from_numpy(np.asarray(mi, np.float64)).to(device)
    src, dst = torch.cat([a, b]), torch.cat([b, a])
    keys, order = torch.sort(src * n_nodes + dst)
    nbr = dst[order]
    wadj = torch.cat([w, w])[order]
    del src, dst, order
    deg = torch.bincount(torch.cat([a, b]), minlength=n_nodes)
    offs = torch.zeros(n_nodes + 1, dtype=torch.int64, device=device)
    offs[1:] = torch.cumsum(deg, 0)
    swap = deg[a] > deg[b]
    u, v = torch.where(swap, b, a), torch.where(swap, a, b)
    cnt = deg[u]
    cum = torch.zeros(E + 1, dtype=torch.int64, device=device)
    cum[1:] = torch.cumsum(cnt, 0)
    margin = w + max(threshold, 0.0)
    direct = torch.ones(E, dtype=torch.uint8, device=device)
    cum_h = cum.cpu().numpy()
    e0 = 0
    while e0 < E:
        e1 = int(np.searchsorted(cum_h, cum_h[e0] + ARACNE_BUDGET, side="right")) - 1
        e1 = min(max(e1, e0 + 1), E)
        edge = torch.repeat_interleave(torch.arange(e0, e1, device=device), cnt[e0:e1])
        if len(edge):
            k = torch.arange(len(edge), device=device) - (cum[edge] - cum[e0])
            flat = offs[u[edge]] + k
            c = nbr[flat]
            q = v[edge] * n_nodes + c
            pos = torch.searchsorted(keys, q).clamp_(max=len(keys) - 1)
            hit = keys[pos] == q
            m = torch.where(hit, torch.minimum(wadj[flat], wadj[pos]),
                            torch.tensor(-np.inf, dtype=torch.float64, device=device))
            best = torch.full((e1 - e0,), -np.inf, dtype=torch.float64, device=device)
            best.scatter_reduce_(0, edge - e0, m, reduce="amax")
            direct[e0:e1] = (best < margin[e0:e1]).to(torch.uint8)
        e0 = e1
    return direct.cpu().numpy()
