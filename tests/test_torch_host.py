"""The port's copies of the JAX package's host modules (spydrpick_torch/core,
io, utils, native, plot and ops/reference) against their originals, on
both golden fixtures and a seeded random alignment: FASTA parse (native and
NumPy paths), the filter's keep lists, the writers' bytes (native and
Python couplings formatter), the native ARACNE flags, the Manhattan plot
and the float64 MI oracle.  The port's functions also take an Alignment
built by the JAX package's reader."""

import io
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from spydrpick_tpu.core import alphabet as jax_alphabet
from spydrpick_tpu.core import distance as jax_distance
from spydrpick_tpu.core import filter as jax_filter
from spydrpick_tpu.engine.aracne import aracne_mark_indirect
from spydrpick_tpu.io import fasta as jax_fasta
from spydrpick_tpu.io import loci as jax_loci
from spydrpick_tpu.io import writers as jax_writers
from spydrpick_tpu.native import aracne_native as jax_aracne_native
from spydrpick_tpu.native import fasta_native as jax_fasta_native
from spydrpick_tpu.ops import reference as jax_reference
from spydrpick_tpu import plot as jax_plot
from spydrpick_torch import plot
from spydrpick_torch.core import alphabet, distance
from spydrpick_torch.core import filter as port_filter
from spydrpick_torch.io import fasta, loci, writers
from spydrpick_torch.native import BUILD_DIR, aracne_native, fasta_native
from spydrpick_torch.ops import reference
from spydrpick_torch.ops.mi import mi_from_crosstabs
from spydrpick_torch.pipeline import PipelineOptions, run_pipeline
from spydrpick_torch.utils.stopwatch import time_string
from spydrpick_torch.utils.uniquefile import unique_path

from tests.conftest import random_alignment

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
CASES = ("golden", "golden2", "random")


@pytest.fixture(scope="module")
def fasta_files(tmp_path_factory):
    """case -> (FASTA path, mappings path or None)."""
    tmp = tmp_path_factory.mktemp("host")
    al = random_alignment(n_samples=37, n_loci=211, seed=13, gap_frac=0.2)
    path = str(tmp / "random.fasta")
    jax_fasta.write_fasta(path, al)
    return {"golden": (os.path.join(GOLDEN, "golden.fasta"), None),
            "golden2": (os.path.join(GOLDEN, "golden2.fasta"),
                        os.path.join(GOLDEN, "golden2.mappings")),
            "random": (path, None)}


def read_both(fasta_files, case):
    path, mappings = fasta_files[case]
    m = None if mappings is None else loci.parse_loci_list(mappings, 1)
    return fasta.read_fasta(path, mappings=m), jax_fasta.read_fasta(path, mappings=m)


def assert_same_alignment(a, b):
    np.testing.assert_array_equal(a.codes, b.codes)
    assert a.sample_names == b.sample_names and a.id_string == b.id_string
    np.testing.assert_array_equal(a.translation, b.translation)
    assert a.n_original_positions == b.n_original_positions


@pytest.mark.parametrize("case", CASES)
def test_fasta_parse_native_and_numpy_equal_the_original(fasta_files, case):
    path, mappings = fasta_files[case]
    port, ref = read_both(fasta_files, case)
    assert_same_alignment(port, ref)
    codes, names = fasta_native.parse(path)
    ref_codes, ref_names = jax_fasta_native.parse(path)
    np.testing.assert_array_equal(codes, ref_codes)
    assert names == ref_names
    codes, names = fasta._numpy_parse(pathlib.Path(path))
    np.testing.assert_array_equal(codes, ref.codes)
    assert names == ref.sample_names
    if mappings is not None:
        np.testing.assert_array_equal(loci.parse_loci_list(mappings, 1),
                                      jax_loci.parse_loci_list(mappings, 1))


def test_native_libraries_build_under_build_dir(fasta_files):
    fasta_native.parse(fasta_files["random"][0])
    assert (BUILD_DIR / "libfasta.so").exists()
    assert "spydrpick_tpu" not in str(BUILD_DIR)
    assert BUILD_DIR.parts[-2:] == ("build", "native")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("params", [(0.01, 0.15), (0.1, 0.05)])
def test_filter_lists_equal_the_original(fasta_files, case, params):
    port, ref = read_both(fasta_files, case)
    got = port_filter.filter_list(port, port_filter.FilterParams(*params))
    np.testing.assert_array_equal(got, jax_filter.filter_list(ref, jax_filter.FilterParams(*params)))
    # the port's filter takes the JAX package's Alignment as it is
    np.testing.assert_array_equal(port_filter.filter_list(ref, port_filter.FilterParams(*params)),
                                  got)


def edge_set(al, seed):
    """A descending random edge set over the alignment's columns, with
    ties, and its ARACNE-like flags."""
    rng = np.random.default_rng(seed)
    L = al.n_loci
    i, j = rng.integers(0, L, (2, 600))
    keep = i != j
    i, j = np.minimum(i, j)[keep], np.maximum(i, j)[keep]
    _, first = np.unique(i * L + j, return_index=True)
    i, j = i[first], j[first]
    mi = np.round(rng.random(len(i)) * 0.5, 4)  # ties after rounding
    order = np.argsort(-mi, kind="stable")
    mi_wog = mi * (1 - 0.3 * rng.random(len(i)))
    mi_wog[::7] = mi[::7]
    return (types.SimpleNamespace(ipos=i[order], jpos=j[order], mi=mi[order],
                                  mi_wog=mi_wog[order]),
            (rng.random(len(i)) < 0.6).astype(np.uint8))


def write_text(fn, *args, **kw):
    f = io.StringIO()
    out = fn(f, *args, **kw)
    return f.getvalue(), out


@pytest.mark.parametrize("case", CASES)
def test_writers_bytes_equal_the_original(fasta_files, case, tmp_path):
    port, ref = read_both(fasta_files, case)
    ref.weights = port.weights = np.random.default_rng(3).random(ref.n_samples) + 0.1
    edges, flags = edge_set(ref, seed=len(case))
    for native in (True, False):
        for linear in (False, True):
            got = write_text(writers.write_couplings, edges, flags, port, 1, linear, native)
            want = write_text(jax_writers.write_couplings, edges, flags, ref, 1, linear, native)
            assert got == want
            # an Alignment of the JAX package serves the port's writer
            assert write_text(writers.write_couplings, edges, flags, ref, 1, linear,
                              native) == want
    thr = float(np.quantile(edges.mi, 0.8))
    for ld in (0, 5):
        args = (edges, flags, port, thr, float(np.quantile(edges.mi, 0.95)), ld, 0, False)
        got = write_text(writers.write_outliers, *args)
        want = write_text(jax_writers.write_outliers, *args[:2], ref, *args[3:])
        assert got == want and got[1] > 0
    assert (write_text(writers.write_state_frequencies, port, 1)
            == write_text(jax_writers.write_state_frequencies, ref, 1))
    assert (write_text(writers.write_sample_weights, port)
            == write_text(jax_writers.write_sample_weights, ref))
    dist = np.random.default_rng(4).integers(0, 90, (6, 6))
    assert (write_text(writers.write_distance_matrix, dist)
            == write_text(jax_writers.write_distance_matrix, dist))
    fasta.write_fasta(tmp_path / "port.fasta", port)
    jax_fasta.write_fasta(tmp_path / "ref.fasta", ref)
    assert (tmp_path / "port.fasta").read_bytes() == (tmp_path / "ref.fasta").read_bytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_aracne_flags_equal_the_original(seed):
    rng = np.random.default_rng(seed)
    n = 60
    i, j = rng.integers(0, n, (2, 900))
    keep = i < j
    i, j = i[keep], j[keep]
    _, first = np.unique(i * n + j, return_index=True)
    i, j = i[first], j[first]
    mi = np.round(rng.random(len(i)), 2)  # exact ties exercise the DPI's >=
    got = aracne_native.mark_indirect(i, j, mi, 1e-12)
    np.testing.assert_array_equal(got, jax_aracne_native.mark_indirect(i, j, mi, 1e-12))
    np.testing.assert_array_equal(got, aracne_mark_indirect(i, j, mi, 1e-12))
    assert got.any() and not got.all()


def test_alphabet_distance_and_helpers_equal_the_original(tmp_path):
    raw = np.frombuffer(b"ACGTacgtNn-.*RYKM", dtype=np.uint8)
    np.testing.assert_array_equal(alphabet.encode_bytes(raw), jax_alphabet.encode_bytes(raw))
    codes = np.arange(5, dtype=np.uint8)
    assert alphabet.decode_codes(codes) == jax_alphabet.decode_codes(codes)
    a, b = np.arange(0, 100, 7), np.arange(99, -1, -7)
    for linear in (False, True):
        np.testing.assert_array_equal(distance.genome_distance(a, b, 120, linear),
                                      jax_distance.genome_distance(a, b, 120, linear))
    w = tmp_path / "w.txt"
    w.write_text("0.5 1\n2.25\n")
    np.testing.assert_array_equal(loci.parse_value_list(w), jax_loci.parse_value_list(w))
    assert [time_string(x) for x in (2e-5, 0.2, 3.0, 75.0)] == ["20us", "200.0ms", "3.00s",
                                                               "1m15.0s"]
    (tmp_path / "out").write_text("")
    assert unique_path(tmp_path / "out").name == "out.1"


@pytest.fixture(scope="module")
def port_couplings(tmp_path_factory):
    """A CLI-sized run of the port's pipeline on the CPU (every pair kept,
    as tests/test_cli_extra.py:69-82 does): its couplings file and
    outlier threshold."""
    tmp = tmp_path_factory.mktemp("plot")
    al = random_alignment(n_samples=40, n_loci=30, seed=82)
    path = tmp / "a.fasta"
    jax_fasta.write_fasta(path, al)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPYDRPICK_TORCH_DEVICE", "cpu")
        res = run_pipeline(PipelineOptions(
            alignmentfile=str(path), mi_threshold=0.0, no_filter_alignment=True,
            no_sample_reweighting=True, output_dir=str(tmp)))
    return res.couplings_path, res.outlier_threshold


def test_plot_tool_plots_the_port_cli_output(port_couplings, tmp_path):
    couplings, thr = port_couplings
    args = [couplings, "--out", str(tmp_path / "plot.png"), "--ld-dist", "5",
            "--outlier-threshold", str(thr)]
    assert plot.main(args) == 0
    assert (tmp_path / "plot.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    # the entry point runs as a module; by default the PNG goes beside the input
    env = dict(os.environ, PYTHONPATH=str(pathlib.Path(__file__).parents[1]))
    res = subprocess.run([sys.executable, "-m", "spydrpick_torch.plot", couplings], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == couplings + ".gwes_plot.png"
    assert os.path.getsize(couplings + ".gwes_plot.png") > 0


def test_plot_equals_the_original(port_couplings, tmp_path):
    """The same columns read and the same PNG bytes drawn, with and without
    the threshold rules."""
    couplings, thr = port_couplings
    for got, want in zip(plot.load_couplings(couplings), jax_plot.load_couplings(couplings)):
        np.testing.assert_array_equal(got, want)
    for rules in ({}, {"ld_dist": 5.0, "outlier_threshold": thr,
                       "extreme_outlier_threshold": thr * 1.2}):
        a = plot.gwes_plot(couplings, str(tmp_path / "port.png"), **rules)
        b = jax_plot.gwes_plot(couplings, str(tmp_path / "ref.png"), **rules)
        assert pathlib.Path(a).read_bytes() == pathlib.Path(b).read_bytes()
        os.unlink(a), os.unlink(b)


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_oracle_equals_the_original(seed):
    """``mi_matrix``, ``mi_single`` (with and without the wo-gaps
    presence, where mi.hpp:173's full-row sum shows), ``crosstab_pair`` and
    ``xlogx`` of the copy are the original's bit for bit; the port's
    batched f64 MI agrees with the oracle."""
    al = random_alignment(n_samples=30, n_loci=12, seed=seed, gap_frac=0.2)
    args = (al.codes, al.weights, al.state_presence)
    np.testing.assert_array_equal(reference.mi_matrix(*args, 0.5),
                                  jax_reference.mi_matrix(*args, 0.5))
    rng = np.random.default_rng(seed)
    x = rng.random(50) - 0.1
    np.testing.assert_array_equal(reference.xlogx(x), jax_reference.xlogx(x))
    for i, j in rng.integers(0, al.n_loci, (6, 2)):
        C = reference.crosstab_pair(al.codes[:, i], al.codes[:, j], al.weights)
        np.testing.assert_array_equal(
            C, jax_reference.crosstab_pair(al.codes[:, i], al.codes[:, j], al.weights))
        for pres in (al.state_presence, al.state_presence_wo_gaps):
            got = reference.mi_single(C, pres[i], pres[j], 0.5)
            assert got == jax_reference.mi_single(C, pres[i], pres[j], 0.5)
            batched = mi_from_crosstabs(torch.from_numpy(C), torch.from_numpy(pres[i]),
                                        torch.from_numpy(pres[j]), 0.5)
            assert abs(float(batched) - got) <= 1e-12
