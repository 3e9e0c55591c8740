"""The benchmark's one generator of alignments and of the scan's command
line, driven by a configuration's file and a traffic mix's file.

An alignment is a clonal bacterial population's SNP columns: the
standard neutral model of a sample's genealogy (Kingman's coalescent)
with infinite-sites mutations, so that the columns' derived-allele
counts follow the neutral spectrum (a count of k in proportion to 1/k:
most columns rare, many below the filter's MAF) and columns whose
mutations lie on one branch, or on nested branches, are linked.

Configuration (``configs/<name>.json``) keys read here:

  samples, loci      the alignment's S x L;
  kept               how many of the L columns pass the scan's filter
                     (the rest do not), the same on every seed;
  population         the model's parameters:
    genealogy_seed   the seed of the one genealogy of the S samples, so
                     that every seed scans the same population;
    homoplasy        the share of columns with a second mutation, on a
                     branch drawn independently, whose leaves take a third
                     state (recurrent mutation or recombination: these
                     columns break the tree's perfect linkage);
    gap_rate         the chance that a cell is a gap (missing data);
    gappy_columns    the share of columns in gappy regions, whose gap
                     chance is drawn uniform in [0, gappy_max) instead;
  cli                the scan's arguments after the FASTA.

Traffic (``traffic/<name>.json``) keys read here:

  loop, clients      "closed" and 1: one scan at a time, back to back;
  cli                arguments added after the configuration's.

The genealogy comes from ``numpy.random.default_rng(genealogy_seed)``;
everything else from a ``torch.Generator`` on the card seeded with
``--seed``, in a fixed order (each chunk's branches, states and gaps,
the columns' places, the samples' order), so one seed gives the same
FASTA on one kind of device, and every seed the same S x L, the same
kept columns and the same population.  The FASTA has one record per
sample, ``>s<k>``, on one line.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gwes_bench.reference import options
from gwes_bench.reference.scan import filter_kept

ALPHABET = np.frombuffer(b"ACGT-", dtype=np.uint8)
GAP = 4
FASTA_NAME = "aln.fasta"


def genealogy(n: int, rng: np.random.Generator):
    """Kingman's coalescent of ``n`` samples: (branch, lo, hi, order).
    Nodes 0..n-1 are the samples, n..2n-2 the merges (the last the root);
    ``branch[v]`` is the length of the branch above node v (0 for the
    root); the samples under v are ``order[lo[v]:hi[v]]``."""
    m = 2 * n - 1
    height = np.zeros(m)
    parent = np.full(m, -1, dtype=np.int64)
    children = np.zeros((m, 2), dtype=np.int64)
    live = list(range(n))
    t = 0.0
    waits = rng.exponential(size=n - 1)
    for step, v in enumerate(range(n, m)):
        k = len(live)
        t += waits[step] / (k * (k - 1) / 2)
        a, b = rng.choice(k, size=2, replace=False)
        children[v] = live[a], live[b]
        parent[[live[a], live[b]]] = v
        height[v] = t
        for idx in sorted((a, b), reverse=True):
            live[idx] = live[-1]
            live.pop()
        live.append(v)
    branch = np.where(parent >= 0, height[np.maximum(parent, 0)] - height, 0.0)
    # the samples in depth-first order and each node's range in it: a
    # merge is numbered after its children, so sizes are summed upwards
    # and ranges handed downwards
    size = np.ones(m, dtype=np.int64)
    for v in range(n, m):
        size[v] = size[children[v, 0]] + size[children[v, 1]]
    lo = np.zeros(m, dtype=np.int64)
    for v in range(m - 1, n - 1, -1):
        c0, c1 = children[v]
        lo[c0] = lo[v]
        lo[c1] = lo[v] + size[c0]
    order = np.empty(n, dtype=np.int64)
    order[lo[:n]] = np.arange(n)
    return branch, lo, lo + size, order


def _columns(n: int, tree, pop: dict, gen: torch.Generator) -> torch.Tensor:
    """(n, S) uint8 codes of ``n`` new columns, one column a row, samples
    in the genealogy's depth-first order (the model of the module
    docstring), on the generator's device."""
    p, lo, hi = tree
    dev = p.device
    S = int(hi[-1])
    first = torch.multinomial(p, n, replacement=True, generator=gen)
    second = torch.multinomial(p, n, replacement=True, generator=gen)
    recur = torch.rand(n, generator=gen, device=dev) < pop["homoplasy"]
    states = torch.argsort(torch.rand((n, 4), generator=gen, device=dev), dim=1)[:, :3]
    cols = torch.arange(n, device=dev)

    def under(branch, on):
        # 1 for the samples under the branch: +1 at lo, -1 at hi, summed
        d = torch.zeros((n, S + 1), dtype=torch.int8, device=dev)
        d[cols, lo[branch]] = on
        d[cols, hi[branch]] = -on
        return torch.cumsum(d, dim=1, dtype=torch.int8)[:, :S].bool()

    level = under(first, torch.ones_like(first, dtype=torch.int8)).to(torch.int64)
    level.masked_fill_(under(second, recur.to(torch.int8)), 2)
    codes = torch.gather(states, 1, level).to(torch.uint8)
    del level
    rate = torch.full((n,), pop["gap_rate"], device=dev)
    gappy = torch.rand(n, generator=gen, device=dev) < pop["gappy_columns"]
    rate = torch.where(gappy, torch.rand(n, generator=gen, device=dev) * pop["gappy_max"], rate)
    codes[torch.rand((n, S), generator=gen, device=dev) < rate[:, None]] = GAP
    return codes


def alignment(config: dict, traffic: dict, seed: int,
              device: torch.device = torch.device("cpu")) -> np.ndarray:
    """(S, L) uint8 codes in 0..4 (4 = gap), made on ``device``: ``kept``
    columns that pass the scan's filter and L - kept that do not, in an
    order drawn from the seed, and the samples in an order of their own
    (module docstring).  Columns are drawn in chunks, and each chunk's
    columns are taken in turn for the part they belong to until both are
    full, so every seed sweeps the same number of columns.  One seed
    gives the same codes on one kind of device."""
    S, L, keep = config["samples"], config["loci"], config["kept"]
    if not 0 < keep <= L:
        raise ValueError(f"{keep} kept columns of {L}")
    pop = config["population"]
    p = options.parse(scan_args(config, traffic, FASTA_NAME, seed))
    branch, lo, hi, _ = genealogy(S, np.random.default_rng(pop["genealogy_seed"]))
    tree = (torch.from_numpy(branch / branch.sum()).to(device),
            torch.from_numpy(lo).to(device), torch.from_numpy(hi).to(device))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    slots = torch.randperm(L, generator=gen, device=device)
    want = {True: slots[:keep], False: slots[keep:]}
    got = {True: 0, False: 0}
    codes = torch.empty((L, S), dtype=torch.uint8, device=device)
    chunk = min(L, 1 << 14)
    for _ in range(64 * (L // chunk + 1)):
        if got[True] == keep and got[False] == L - keep:
            break
        part = _columns(chunk, tree, pop, gen)
        counts = torch.stack([(part == s).sum(1) for s in range(5)], dim=1).cpu().numpy()
        passes = np.zeros(chunk, dtype=bool)
        passes[filter_kept(counts, S, p["maf_threshold"], p["gap_threshold"])] = True
        for kind in (True, False):
            cols = np.flatnonzero(passes == kind)[:len(want[kind]) - got[kind]]
            dest = want[kind][got[kind]:got[kind] + len(cols)]
            codes[dest] = part[torch.from_numpy(cols).to(device)]
            got[kind] += len(cols)
    if got[True] != keep or got[False] != L - keep:
        raise ValueError(f"the model gives too few columns of one kind: {got}")
    rows = torch.randperm(S, generator=gen, device=device)
    return codes.t()[rows].contiguous().cpu().numpy()


def write_fasta(directory: str, codes: np.ndarray) -> str:
    """The FASTA of ``codes`` in ``directory``; returns its path."""
    fasta = os.path.join(directory, FASTA_NAME)
    lines = np.empty((codes.shape[0], codes.shape[1] + 1), dtype=np.uint8)
    lines[:, :-1] = ALPHABET[codes]
    lines[:, -1] = ord("\n")
    with open(fasta, "wb") as f:
        for k, row in enumerate(lines):
            f.write(b">s%d\n" % k)
            f.write(row.tobytes())
    return fasta


def sample_names(n: int) -> list[str]:
    return [f"s{k}" for k in range(n)]


def scan_args(config: dict, traffic: dict, fasta: str, seed: int) -> list:
    """The scan's command line after the program's name, without
    ``--output-dir``."""
    if traffic.get("loop") != "closed" or traffic.get("clients") != 1:
        raise ValueError("only a closed loop of one client is generated")
    return [fasta, *config.get("cli", []), *traffic.get("cli", []), "--seed", str(seed)]
