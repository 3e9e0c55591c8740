"""The generator repeats by seed; the K1 work function on a worked shape;
the reference's renderer and MI on hand-checked cases."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gwes_bench import generate
from gwes_bench.cells import reader, resolve
from gwes_bench.record import Run
from gwes_bench.reference import options, render
from gwes_bench.reference.scan import filter_kept, mi_from_tables, state_counts


def _small(seed, samples=60, loci=400, kept=240):
    cell = resolve("scan-3k-30k")
    cfg = dict(cell.config, samples=samples, loci=loci, kept=kept)
    return generate.alignment(cfg, cell.traffic, seed), cell.traffic


def test_the_generator_repeats_by_seed():
    (c1, _), (c2, _) = _small(2**31 + 5), _small(2**31 + 5)
    assert np.array_equal(c1, c2)
    c3, _ = _small(2**31 + 6)
    assert not np.array_equal(c1, c3)


@pytest.mark.parametrize("seed", [3, 2**31 + 7])
def test_every_seed_keeps_the_configured_columns(seed):
    codes, traffic = _small(seed)
    assert codes.shape == (60, 400) and codes.dtype == np.uint8 and codes.max() <= 4
    p = options.parse(generate.scan_args(resolve("scan-3k-30k").config, traffic, "a", 1))
    counts = state_counts(torch.from_numpy(codes)).numpy()
    assert len(filter_kept(counts, 60, p["maf_threshold"], p["gap_threshold"])) == 240


def test_the_columns_are_linked_along_one_genealogy():
    # columns of one branch carry the same split of the samples: with
    # 2 * 60 - 2 branches and 400 columns many splits repeat, as they do
    # in a clonal population, and never in independent columns
    codes, _ = _small(11)
    splits = {tuple(col == col[0]) for col in codes.T if (col != 4).all()}
    assert len(splits) < 0.75 * sum((col != 4).all() for col in codes.T)
    branch, lo, hi, order = generate.genealogy(60, np.random.default_rng(1))
    assert sorted(order) == list(range(60)) and (hi - lo)[-1] == 60
    assert branch[-1] == 0 and (branch[:-1] > 0).all()


def test_the_fasta_holds_the_codes(tmp_path):
    codes, traffic = _small(4)
    fasta = generate.write_fasta(str(tmp_path), codes)
    lines = open(fasta, "rb").read().split(b"\n")
    assert lines[0] == b">s0" and lines[2] == b">s1"
    assert lines[1] == generate.ALPHABET[codes[0]].tobytes()
    args = generate.scan_args(resolve("scan-3k-30k").config, traffic, fasta, 9)
    assert args == [fasta, "--seed", "9"]


def test_k1_work_on_a_worked_shape():
    # S = 3000, L = 30720: 30720 * 30719 / 2 = 471,843,840 pairs, each
    # 2 * 25 * 3000 = 150,000 operations: 7.077657600e13 per sweep
    k1 = reader("k1_roofline_share")
    ops = k1.__globals__["k1_ops"](3000, 30720)
    assert ops == 7.0776576e13
    trace = type("T", (), {"kernel_s": {"void mi_tile_mma_kernel<signed char>(...)": 0.2,
                                        "void mi_tile_dual_mma_kernel<signed char>(...)": 9.0}})
    run = Run(samples=3000, loci=30720, scans=[{}, {}], window_s=1.0, setup_s=1.0,
              peak_bytes=1, device_name="NVIDIA H100 80GB HBM3", trace=trace)
    # two sweeps' operations at 1979 TOP/s take 71.527 ms of the 200 ms
    assert k1(run) == pytest.approx(100 * 2 * 7.0776576e13 / 1979e12 / 0.2)
    assert reader("k1_roofline_share")(
        Run(3000, 30720, [{}], 1.0, 1.0, 1, "cpu", None)) is None


def test_per_layer_spans_read_means():
    scans = [{"preprocess_s": 0.2, "engine_build_s": 0.1, "threshold_s": 0.3, "sweep_s": 0.5,
              "sort_s": 0.01, "aracne_s": 0.02, "write_s": 0.07}] * 2
    run = Run(samples=10, loci=101, scans=scans, window_s=2.4, setup_s=3.0, peak_bytes=2**30,
              device_name="x")
    assert reader("lead_in_s")(run) == pytest.approx(0.3)
    assert reader("tail_s")(run) == pytest.approx(0.1)
    assert reader("sweep_pairs_per_s")(run) == pytest.approx(5050 / 0.5)
    assert reader("scan_s")(run) == pytest.approx(1.2)
    assert reader("peak_device_gib")(run) == 1.0
    assert reader("device_idle_share")(run) is None


def test_couplings_rows_match_python_formatting():
    rng = np.random.default_rng(0)
    mi = rng.random(2000).astype(np.float32).astype(np.float64) * 0.02
    mi[:3] = [0.0078125, 0.0234375, 1.5]   # exact half micro-units, and > 1
    p1, p2 = rng.integers(1, 10**6, 2000), rng.integers(1, 10**6, 2000)
    d, fl = np.abs(p1 - p2), rng.integers(0, 2, 2000)
    want = "".join(f"{a} {b} {c} {f} {m:.6f}\n" for a, b, c, f, m in zip(p1, p2, d, fl, mi))
    got = render.couplings_bytes(p1, p2, d, fl, mi, torch.device("cpu"), chunk=700)
    assert got == want.encode()


def test_mi_of_independent_and_copied_columns():
    n = torch.tensor([[10.0, 0, 0, 0, 0], [0, 10, 0, 0, 0], [0, 0, 10, 0, 0],
                      [0, 0, 0, 10, 0], [0, 0, 0, 0, 0]], dtype=torch.float64)
    present = torch.tensor([1, 1, 1, 1, 0])
    copied = float(mi_from_tables(n, present, present, 0.0))
    assert copied == pytest.approx(np.log(4))
    flat = torch.full((5, 5), 2.0, dtype=torch.float64)
    allp = torch.ones(5)
    assert float(mi_from_tables(flat, allp, allp, 0.5)) == pytest.approx(0.0, abs=1e-15)
