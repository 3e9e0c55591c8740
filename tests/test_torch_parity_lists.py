"""The port's CLI against the JAX CLI (``--use-pallas on``, the same int8
mode) on the list flags together, and on three analytic corners of the
filter and the outliers writer, on the CPU.

The fixture is ``golden2.fasta`` with ``--mappings-list``,
``--include-list``, ``--exclude-list``, ``--sample-list``,
``--genome-size`` and ``--sample-weights`` at once; the list files are
drawn from a seeded generator into the test's directory.  Side files
must be byte-identical; couplings and outliers rows must hold the same
edges (with the automatic threshold, apart from pairs within TOL of it:
the tournament's own pair, ROADMAP's watch list), printed MI within one
unit of its 6th decimal and ARACNE flags equal apart from DPI ties."""

import os
import re

import numpy as np
import pytest

from spydrpick_tpu.cli import main as jax_main
from spydrpick_tpu.core.alignment import Alignment as JaxAlignment
from spydrpick_tpu.core.filter import FilterParams as JaxFilterParams
from spydrpick_tpu.core.filter import filter_mask as jax_filter_mask
from spydrpick_tpu.engine.solver import EdgeSet as JaxEdgeSet
from spydrpick_tpu.io.writers import write_outliers as jax_write_outliers
from spydrpick_torch.cli import main as torch_main
from spydrpick_torch.core.alignment import Alignment
from spydrpick_torch.core.filter import FilterParams, filter_mask
from spydrpick_torch.engine.solver import EdgeSet
from spydrpick_torch.io.writers import write_outliers
from spydrpick_torch.pipeline import PipelineOptions, run_pipeline

from tests.test_torch_cli import dpi_near_tie, read_rows, save_threshold

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
TOL = 1e-5
SIDE_FILES = (".distance_matrix", ".state_frequencies", ".weights", ".input.fasta",
              ".filtered.fasta", ".outlier_nodes.fasta")


@pytest.fixture(autouse=True, scope="module")
def cpu_device():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPYDRPICK_TORCH_DEVICE", "cpu")
        yield


def list_file(path, values, fmt="{}"):
    path.write_text(" ".join(fmt.format(v) for v in values) + "\n")
    return str(path)


PLANTED = [30, 120]  # golden2's planted coupling (make_golden.py: column 120 copies 30)


def list_flags(tmp_path, seed=2024):
    """golden2's list flags, drawn from ``default_rng(seed)``: 160 mapped
    positions of a 600-position genome, 130 of them included (the planted
    pair's among them, so that the outliers file has rows), 12 others of
    those and 5 unmapped ones excluded, 42 of the 50 samples and their
    weights (1-based, as the CLI reads them)."""
    rng = np.random.default_rng(seed)
    genome = np.arange(1, 601)
    mapped = np.sort(rng.choice(genome, 160, replace=False))
    others = np.delete(mapped, PLANTED)
    included = np.sort(np.concatenate([mapped[PLANTED], rng.choice(others, 128, replace=False)]))
    excluded = np.concatenate([rng.choice(np.setdiff1d(included, mapped[PLANTED]), 12,
                                          replace=False),
                               rng.choice(np.setdiff1d(genome, mapped), 5, replace=False)])
    samples = np.sort(rng.choice(np.arange(1, 51), 42, replace=False))
    weights = rng.random(42) * 0.9 + 0.1
    return ["--genome-size", "600",
            "--mappings-list", list_file(tmp_path / "golden2.mappings", mapped),
            "--include-list", list_file(tmp_path / "include", included),
            "--exclude-list", list_file(tmp_path / "exclude", excluded),
            "--sample-list", list_file(tmp_path / "samples", samples),
            "--sample-weights", list_file(tmp_path / "weights", weights, "{:.6f}")]


def run_both(args, tmp_path, capsys):
    """Both CLIs on ``args``; (port dir, JAX dir, port threshold, JAX
    threshold)."""
    assert torch_main(args + ["-v", "--output-dir", str(tmp_path / "torch")]) == 0
    thr_t = save_threshold(capsys.readouterr().out)
    assert jax_main(args + ["-v", "--use-pallas", "on", "--jax-cache-dir", "none",
                            "--output-dir", str(tmp_path / "jax")]) == 0
    thr_j = save_threshold(capsys.readouterr().out)
    return tmp_path / "torch", tmp_path / "jax", thr_t, thr_j


def micro(x: str) -> int:
    return round(float(x) * 1e6)


def assert_same_outputs(got_dir, want_dir, thr, band):
    """Side files byte-identical; couplings and outliers rows as the module
    docstring says (``band``: edges within TOL of ``thr`` may differ)."""
    names = sorted(os.listdir(got_dir))
    assert names == sorted(os.listdir(want_dir))
    for n in names:
        if n.endswith(SIDE_FILES):
            assert (got_dir / n).read_bytes() == (want_dir / n).read_bytes(), n
    (couplings,) = [n for n in names if re.search(r"\.\d+edges$", n)]
    (outliers,) = [n for n in names if n.endswith(".outliers")]
    got, ref = read_rows(got_dir / couplings), read_rows(want_dir / couplings)
    flipped = set(got) ^ set(ref)
    assert not flipped or band, sorted(flipped)[:5]
    for k in flipped:
        assert abs(float((got.get(k) or ref[k])[4]) - thr) <= TOL, k
    for k in set(got) & set(ref):
        g, r = got[k], ref[k]
        assert g[2] == r[2] and abs(micro(g[4]) - micro(r[4])) <= 1, (g, r)
        assert g[3] == r[3] or dpi_near_tie(k, ref), (g, r)
    got_o, ref_o = read_rows(got_dir / outliers), read_rows(want_dir / outliers)
    assert set(got_o) == set(ref_o) and got_o
    for k, g in got_o.items():
        r = ref_o[k]
        assert g[2] == r[2] and g[7] == r[7], (g, r)
        assert g[3] == r[3] or dpi_near_tie(k, ref), (g, r)
        assert abs(micro(g[4]) - micro(r[4])) <= 1 and abs(micro(g[5]) - micro(r[5])) <= 1
        assert abs(float(g[6]) - float(r[6])) <= 0.1 + 1e-9  # gap effect, 1 decimal
    return got, got_o


@pytest.mark.parametrize("threshold", ["pinned", "tournament"])
def test_list_flags_match_jax(tmp_path, capsys, threshold):
    """All list flags together, with every side file written, and
    ``--mi-values`` below the filtered pair count; the threshold pinned
    (edge sets equal) or the tournament's."""
    args = [os.path.join(GOLDEN, "golden2.fasta"), "--seed", "11", "--ld-threshold", "15",
            *list_flags(tmp_path), "--mi-values", "2000", "--output-sample-distance-matrix",
            "--output-state-frequencies", "--output-sample-weights", "--output-alignment",
            "--output-filtered-alignment"]
    if threshold == "pinned":
        args += ["--mi-threshold", "0.08"]
    got_dir, want_dir, thr_t, thr_j = run_both(args, tmp_path, capsys)
    assert round(thr_t, 6) == round(thr_j, 6)
    couplings, _ = assert_same_outputs(got_dir, want_dir, thr_j, threshold == "tournament")
    # the lists took effect: 42 samples, 130 - 12 included columns before the filter
    assert any(n.startswith("golden2.42x") for n in os.listdir(got_dir))
    assert len(couplings) > 1000
    weights = [float(x) for x in (got_dir / "golden2.weights").read_text().split()]
    assert len(weights) == 42


def corner_alignment(S=50):
    """Columns: 30 copies of one column (equal colmax, so the outlier fence
    Q3 + 1.5 IQR equals their MI exactly), 6 random ones, and four filter
    corners at --maf-threshold 0.1 and --gap-threshold 0.2: a minor allele
    count of exactly 0.1 S (kept, the rule is >=) and one below, a gap
    count of exactly 0.2 S (kept, <=) and one above."""
    rng = np.random.default_rng(7)
    base = rng.integers(0, 4, S)
    base[rng.random(S) < 0.1] = 4
    cols = [base] * 30 + [rng.integers(0, 4, S) for _ in range(6)]
    maf_tie, maf_low = np.zeros(S, int), np.zeros(S, int)
    maf_tie[:S // 10] = 1
    maf_low[:S // 10 - 1] = 1
    gap_tie, gap_high = rng.integers(0, 4, S), rng.integers(0, 4, S)
    gap_tie[:S // 5] = 4
    gap_high[:S // 5 + 1] = 4
    return np.stack(cols + [maf_tie, maf_low, gap_tie, gap_high], axis=1).astype(np.uint8)


CORNER_FLAGS = ["--maf-threshold", "0.1", "--gap-threshold", "0.2", "--no-sample-reweighting",
                "--mi-threshold", "0.001", "--output-filtered-alignment"]


def test_filter_ties_and_outlier_fence_match_jax(tmp_path, capsys):
    """The filter keeps a column whose minor allele or gap frequency equals
    its threshold exactly, as the JAX filter does; an edge whose MI equals
    the outlier threshold exactly is printed (SpydrPick.hpp:99-103 breaks
    only on <): all 435 copy pairs, by both CLIs."""
    codes = corner_alignment()
    S, L = codes.shape
    fasta = tmp_path / "corner.fasta"
    fasta.write_bytes(b"".join(b">s%d\n" % i + np.frombuffer(b"ACGT-", np.uint8)[row].tobytes()
                               + b"\n" for i, row in enumerate(codes)))
    names, trans = [f"s{i}" for i in range(S)], np.arange(L)
    keep = filter_mask(Alignment(codes, names, "c", trans, L), FilterParams(0.1, 0.2))
    want = jax_filter_mask(JaxAlignment(codes, names, "c", trans, L), JaxFilterParams(0.1, 0.2))
    assert np.array_equal(keep, want)
    assert keep[:36].all() and keep[[36, 38]].all() and not keep[[37, 39]].any()

    res = run_pipeline(PipelineOptions(alignmentfile=str(fasta), maf_threshold=0.1,
                                       gap_threshold=0.2, no_sample_reweighting=True,
                                       mi_threshold=0.001), write_outputs=False)
    at_fence = res.edges.mi == res.outlier_threshold
    assert at_fence.sum() == 30 * 29 // 2 and res.edges.mi.max() == res.outlier_threshold

    got_dir, want_dir, thr_t, thr_j = run_both([str(fasta), *CORNER_FLAGS], tmp_path, capsys)
    _, outliers = assert_same_outputs(got_dir, want_dir, thr_j, band=False)
    assert len(outliers) == 30 * 29 // 2
    assert {(i + 1, j + 1) for i in range(30) for j in range(i + 1, 30)} == set(outliers)
    assert len(next(iter(outliers.values()))) == 8


@pytest.mark.parametrize("outlier_threshold", [0.0, 0.3])
def test_outliers_writer_zero_weight_guard_and_fence(outlier_threshold):
    """The writers on hand-made edges: a row whose MI equals the outlier
    threshold is printed and the list stops at the first MI below it; an
    edge of MI 0 gets gap effect 0.0 (the ``w != 0`` guard,
    io/writers.py:97) instead of a division by zero.  Both packages
    write the same bytes."""
    import io

    mi = np.array([0.5, 0.3, 0.3, 0.0, 0.0, -1e-9])
    wog = np.array([0.4, 0.3, 0.1, 0.0, 0.2, 0.0])
    ipos, jpos = np.array([0, 1, 2, 3, 4, 5]), np.array([6, 7, 8, 9, 10, 11])
    flags = np.array([1, 0, 1, 0, 1, 0], dtype=np.uint8)
    colmax = np.zeros(12)
    L, names = 12, ["a", "b"]
    codes = np.zeros((2, L), np.uint8)
    out = []
    for edge_set, alignment, write in (
            (EdgeSet, Alignment(codes, names, "w", np.arange(L), 100), write_outliers),
            (JaxEdgeSet, JaxAlignment(codes, names, "w", np.arange(L), 100), jax_write_outliers)):
        f = io.StringIO()
        n = write(f, edge_set(ipos=ipos, jpos=jpos, mi=mi, mi_wog=wog, colmax=colmax), flags,
                  alignment, outlier_threshold, 0.4)
        out.append((n, f.getvalue()))
    assert out[0] == out[1]
    rows = [r.split() for r in out[0][1].splitlines()]
    if outlier_threshold == 0.3:
        assert [r[4] for r in rows] == ["0.500000", "0.300000", "0.300000"]
    else:
        assert len(rows) == 5  # the MI of -1e-9 stops the list
        assert rows[3][4:7] == ["0.000000", "0.000000", "0.0"]
        assert rows[4][4:7] == ["0.000000", "0.200000", "0.0"]
    assert rows[0][7] == "1" and all(r[7] == "0" for r in rows[1:])
