"""ARACNE indirect-edge pruning: the ``run_aracne`` entry point and its
NumPy fallback, copied from spydrpick_tpu/engine/aracne.py (which cannot
be imported without jax).  The fast path is the native owner-scan kernel,
the port's copy ``spydrpick_torch.native.aracne_native``.

Closed form of the DPI rule (ARACNE.hpp:311-313): edge (a, b, w) is
indirect iff ``max_c min(w_ac, w_bc) >= w + max(threshold, 0)`` over the
common neighbours c.  The public flag is 1 for direct (kept) edges.
"""

from __future__ import annotations

import os

import numpy as np

DEFAULT_EDGE_THRESHOLD = float(np.finfo(np.float64).eps)


def _csr_adjacency(ipos, jpos, n_nodes):
    """Sorted-neighbour CSR over undirected edges; returns
    (indptr, neighbors, edge_ids) with neighbours ascending per node."""
    deg = np.bincount(ipos, minlength=n_nodes) + np.bincount(jpos, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    E = len(ipos)
    src = np.concatenate([ipos, jpos])
    dst = np.concatenate([jpos, ipos])
    eid = np.concatenate([np.arange(E), np.arange(E)])
    order = np.lexsort((dst, src))
    return indptr, dst[order], eid[order]


def aracne_mark_indirect(ipos: np.ndarray, jpos: np.ndarray, mi: np.ndarray,
                         threshold: float = DEFAULT_EDGE_THRESHOLD) -> np.ndarray:
    """(E,) bool: True where the edge is INDIRECT (NumPy implementation)."""
    E = len(mi)
    if E == 0:
        return np.zeros(0, dtype=bool)
    nodes, inv = np.unique(np.concatenate([ipos, jpos]), return_inverse=True)
    a = inv[:E]
    b = inv[E:]
    n_nodes = len(nodes)
    indptr, nbr, eid = _csr_adjacency(a, b, n_nodes)
    w = np.asarray(mi, dtype=np.float64)
    margin = w + max(threshold, 0.0)

    # for each edge (u, v): scan the smaller endpoint's neighbours and look
    # each candidate c up in ne(v) through one global searchsorted over the
    # (src, dst)-sorted CSR keys
    deg = indptr[1:] - indptr[:-1]
    swap = deg[a] > deg[b]
    u = np.where(swap, b, a)
    v = np.where(swap, a, b)
    keys = np.repeat(np.arange(n_nodes, dtype=np.int64), deg) * n_nodes + nbr
    cnt = deg[u]
    cum = np.concatenate([[0], np.cumsum(cnt)])

    indirect = np.zeros(E, dtype=bool)

    def _chunk(start: int, end: int) -> None:
        c_cnt = cnt[start:end]
        seg0 = (cum[start:end] - cum[start]).astype(np.int64)
        M = int(cum[end] - cum[start])
        rep = np.repeat(np.arange(start, end, dtype=np.int64), c_cnt)
        offs = np.arange(M, dtype=np.int64) - np.repeat(seg0, c_cnt)
        flat = indptr[u[rep]] + offs
        cand = nbr[flat]
        e1 = eid[flat]
        query = v[rep] * n_nodes + cand
        pos = np.clip(np.searchsorted(keys, query), 0, len(keys) - 1)
        hit = keys[pos] == query
        e2 = eid[pos]
        valid = hit & (e1 != rep) & (e2 != rep)
        m = np.where(valid, np.minimum(w[e1], w[e2]), -np.inf)
        best = np.maximum.reduceat(m, seg0)
        indirect[start:end] = best >= margin[start:end]

    flat_budget = 1 << 21
    bounds = [0]
    while bounds[-1] < E:
        nxt = int(np.searchsorted(cum, cum[bounds[-1]] + flat_budget, side="right")) - 1
        bounds.append(min(max(nxt, bounds[-1] + 1), E))
    spans = list(zip(bounds[:-1], bounds[1:]))
    if len(spans) == 1:
        _chunk(*spans[0])
    else:
        from concurrent.futures import ThreadPoolExecutor

        workers = min(len(spans), os.cpu_count() or 1)
        with ThreadPoolExecutor(workers) as ex:
            list(ex.map(lambda s: _chunk(*s), spans))
    return indirect


def run_aracne(ipos: np.ndarray, jpos: np.ndarray, mi: np.ndarray,
               threshold: float = DEFAULT_EDGE_THRESHOLD,
               use_native: bool = True) -> np.ndarray:
    """(E,) uint8 ARACNE flags: 1 = direct survivor, 0 = indirect."""
    if use_native:
        try:
            from spydrpick_torch.native import aracne_native

            return (~aracne_native.mark_indirect(ipos, jpos, mi, threshold)).astype(np.uint8)
        except Exception:
            pass  # no C++ compiler or build failure: NumPy below
    return (~aracne_mark_indirect(ipos, jpos, mi, threshold)).astype(np.uint8)
