"""GWES Manhattan plot — Python counterpart of the reference's
standalone R script (gwes_plot.r): MI vs genome distance; indirect
edges small/grey, direct edges blue; optional LD-threshold and
outlier-threshold rules; auto-uniquified output filename
(gwes_plot.r:65-97).

Usage:
    python -m spydrpick_torch.plot <couplings_file> [--outliers FILE]
        [--ld-dist N] [--outlier-threshold X] [--out plot.png]

Reads the space-delimited couplings file; columns (README.md:60):
pos1 pos2 distance aracne_flag mi  (field indices 3/4/5 in the R
script's 1-based terms, gwes_plot.r:65-67,79).

A copy of spydrpick_tpu/plot.py, which the port may not import; it
uses the port's ``unique_path``.  matplotlib is imported on use only.
"""

from __future__ import annotations

import argparse

import numpy as np

from spydrpick_torch.utils.uniquefile import unique_path


def load_couplings(path: str):
    data = np.loadtxt(path, usecols=(2, 3, 4), ndmin=2)
    return data[:, 0], data[:, 1].astype(int), data[:, 2]  # dist, flag, mi


def gwes_plot(
    couplings_path: str,
    out_path: str | None = None,
    ld_dist: float | None = None,
    outlier_threshold: float | None = None,
    extreme_outlier_threshold: float | None = None,
    max_points: int = 2_000_000,
):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    dist, flag, mi = load_couplings(couplings_path)
    if len(mi) > max_points:  # subsample low-MI mass, keep all direct edges
        rng = np.random.default_rng(0)
        keep = np.zeros(len(mi), dtype=bool)
        keep[flag == 1] = True
        n_direct = int(keep.sum())
        if n_direct >= max_points:
            # direct edges alone exceed the budget: subsample THEM
            direct = np.flatnonzero(keep)
            keep[:] = False
            keep[rng.choice(direct, max_points, replace=False)] = True
        else:
            rest = np.flatnonzero(~keep)
            keep[rng.choice(rest, max_points - n_direct,
                            replace=False)] = True
        dist, flag, mi = dist[keep], flag[keep], mi[keep]

    fig, ax = plt.subplots(figsize=(12, 6))
    indirect = flag == 0
    # indirect: grey + small; direct: blue (gwes_plot.r:79-82)
    ax.scatter(dist[indirect], mi[indirect], s=2, c="#b0b0b0", linewidths=0,
               label="indirect", rasterized=True)
    ax.scatter(dist[~indirect], mi[~indirect], s=6, c="#1f4e9c", linewidths=0,
               label="direct", rasterized=True)
    if ld_dist is not None:
        ax.axvline(ld_dist, color="black", ls="--", lw=1, label="ld distance")
    if outlier_threshold is not None:
        ax.axhline(outlier_threshold, color="#c44", ls="--", lw=1, label="outlier")
    if extreme_outlier_threshold is not None:
        ax.axhline(extreme_outlier_threshold, color="#811", ls=":", lw=1,
                   label="extreme outlier")
    ax.set_xlabel("genome distance (bp)")
    ax.set_ylabel("mutual information")
    ax.set_title("GWES Manhattan plot")
    ax.legend(loc="upper right", frameon=False)
    out = unique_path(out_path or couplings_path + ".gwes_plot.png")
    fig.savefig(out, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return str(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("couplings")
    p.add_argument("--out")
    p.add_argument("--ld-dist", type=float)
    p.add_argument("--outlier-threshold", type=float)
    p.add_argument("--extreme-outlier-threshold", type=float)
    args = p.parse_args(argv)
    out = gwes_plot(
        args.couplings, args.out, args.ld_dist,
        args.outlier_threshold, args.extreme_outlier_threshold,
    )
    print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
