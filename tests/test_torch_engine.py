"""The PyTorch port's engine (spydrpick_torch/engine/solver.py) against the
JAX engine with its Pallas kernels in interpret mode, on the CPU: device
data, the all-pairs sweep with the lazy wo-gaps resolve, pair MI, the
edge sort and the ARACNE copy."""

import dataclasses

import numpy as np
import pytest
import torch

from spydrpick_tpu.engine.aracne import aracne_mark_indirect as jax_aracne_mark_indirect
from spydrpick_tpu.engine.outliers import outlier_thresholds
from spydrpick_tpu.engine.solver import EdgeSet as JaxEdgeSet
from spydrpick_tpu.engine.solver import EngineConfig as JaxConfig
from spydrpick_tpu.engine.solver import MIEngine as JaxEngine
from spydrpick_torch.engine.aracne import run_aracne
from spydrpick_torch.engine.solver import (
    DeviceData,
    EdgeSet,
    EngineConfig,
    MIEngine,
    build_device_data,
    device_data_from_jax,
)
from spydrpick_torch.ops.mi_kernels import split_bf16

from tests.conftest import random_alignment

# same integer crosstables in both packages; f32 log and sum order differ
TOL = 1e-5

MODES = {
    # mode -> (weights, mxu_int8, extra engine options)
    "unit": ("ones", "auto", {}),
    "fixed14": ("random", "auto", {}),
    "fixed14_ld_linear": ("random", "auto", {"ld_threshold": 10, "linear_genome": True}),
    "bf16": ("random", "off", {}),
    "bf16_wide_spread": ("spread", "auto", {}),
}


def alignment_for(mode, n_loci=300, seed=5):
    weights, mxu_int8, extra = MODES[mode]
    al = random_alignment(n_samples=48, n_loci=n_loci, seed=seed, gap_frac=0.15)
    if weights == "ones":
        al.weights = None
    elif weights == "spread":
        al.weights[0] = al.weights.max() / 64.0  # spread > 32: bf16 hi/lo under auto
    return al, mxu_int8, extra


def engines(mode, **kw):
    al, mxu_int8, extra = alignment_for(mode, **kw)
    port = MIEngine(al, EngineConfig(tile=128, mxu_int8=mxu_int8, wog_fetch="outliers", **extra),
                    device="cpu")
    ref = JaxEngine(al, JaxConfig(tile=128, use_pallas="on", wog_fetch="outliers",
                                  mxu_int8=mxu_int8, **extra))
    return al, port, ref


def save_threshold(port):
    """A threshold keeping about the top 5% of pairs."""
    rng = np.random.default_rng(0)
    ii, jj = rng.integers(0, port.L, (2, 4000))
    keep = ii < jj
    return float(np.quantile(port.pair_mi(ii[keep], jj[keep]), 0.95))


def assert_sweeps_agree(a, b, thr):
    """Edge sets equal apart from flips within TOL of the threshold; common
    MI, colmax and the wog of outlier candidates within TOL."""
    ea = {(i, j): (m, w) for i, j, m, w in zip(a.ipos.tolist(), a.jpos.tolist(),
                                              a.mi.tolist(), a.mi_wog.tolist())}
    eb = {(i, j): (m, w) for i, j, m, w in zip(b.ipos.tolist(), b.jpos.tolist(),
                                              b.mi.tolist(), b.mi_wog.tolist())}
    for k in set(ea) ^ set(eb):
        m = ea.get(k, eb.get(k))[0]
        assert abs(m - thr) <= TOL, (k, m, thr)
    common = set(ea) & set(eb)
    assert len(common) > 100
    np.testing.assert_allclose(a.colmax, b.colmax, rtol=0, atol=TOL)
    cand_thr, _ = outlier_thresholds(b.colmax)
    n_cand = 0
    for k in common:
        assert abs(ea[k][0] - eb[k][0]) <= TOL, k
        if eb[k][0] >= cand_thr + TOL:
            n_cand += 1
            assert abs(ea[k][1] - eb[k][1]) <= TOL, k
    return n_cand


@pytest.mark.parametrize("mode", list(MODES))
def test_device_data_matches_jax(mode):
    """The port's device data, its sample-major one-hot kept
    (``keep_onehot``: the engine itself builds none), equals the JAX
    engine's."""
    al, port, ref = engines(mode)
    assert port.statics.int8_mode == ref.statics.int8_mode
    assert port.statics.int8_scale == ref.statics.int8_scale
    assert port.statics.Lp == ref.statics.Lp
    assert port.data.onehot is None
    kept, _ = build_device_data(al, port.config, torch.device("cpu"), keep_onehot=True)
    conv = device_data_from_jax(ref.data, torch.device("cpu"))
    n = al.n_samples
    for name in DeviceData._fields:
        mine, theirs = getattr(kept, name), getattr(conv, name)
        assert mine.dtype == theirs.dtype, name
        if name in ("onehot", "weights", "codes"):  # the JAX engine pads samples
            assert torch.equal(mine[:n], theirs[:n]), name
            assert mine.shape[0] == n
            assert bool((theirs[n:] == (255 if name == "codes" else 0)).all()), name
        else:
            assert torch.equal(mine, theirs), name


@pytest.mark.parametrize("mode", list(MODES))
def test_sweep_matches_jax(mode):
    al, port, ref = engines(mode)
    thr = save_threshold(port)
    a = port.sweep(thr).sort_desc()
    b = ref.sweep(thr).sort_desc()
    assert a.n_edges > 0
    assert np.all(a.ipos < a.jpos)
    assert assert_sweeps_agree(a, b, thr) > 0
    np.testing.assert_allclose(port.pair_mi(a.ipos[:300], a.jpos[:300]), a.mi[:300],
                               rtol=0, atol=TOL)


def test_sweep_on_jax_device_data():
    """The JAX engine's device data, carried into the port, sweeps to the
    same edges as the port's own (its extra zero-weight sample rows are
    exact no-ops)."""
    al, port, ref = engines("fixed14")
    statics = dataclasses.replace(port.statics, S=int(ref.data.onehot.shape[0]))
    carried = MIEngine(al, port.config, device="cpu",
                       _prebuilt=(device_data_from_jax(ref.data, torch.device("cpu")), statics))
    thr = save_threshold(port)
    a = port.sweep(thr)
    b = carried.sweep(thr)
    for x, y in zip((a.ipos, a.jpos, a.mi, a.mi_wog, a.colmax),
                    (b.ipos, b.jpos, b.mi, b.mi_wog, b.colmax)):
        np.testing.assert_array_equal(x, y)


def test_sweep_multiple_row_tiles_and_tile_invariance():
    al, mxu, _ = alignment_for("fixed14", n_loci=500, seed=8)
    a = MIEngine(al, EngineConfig(tile=128, wog_fetch="outliers"), device="cpu")
    b = MIEngine(al, EngineConfig(tile=256, wog_fetch="outliers"), device="cpu")
    thr = save_threshold(a)
    ea, eb = a.sweep(thr).sort_desc(), b.sweep(thr).sort_desc()
    np.testing.assert_array_equal(ea.ipos, eb.ipos)
    np.testing.assert_array_equal(ea.jpos, eb.jpos)
    np.testing.assert_allclose(ea.mi, eb.mi, rtol=0, atol=1e-6)


def test_tile_must_be_slab_aligned():
    al, _, _ = alignment_for("fixed14")
    with pytest.raises(ValueError, match="multiple of 128"):
        build_device_data(al, EngineConfig(tile=96), torch.device("cpu"))


def test_sort_desc_tie_heavy_equals_reference():
    rng = np.random.default_rng(12)
    L, E = 400, 6000
    keys = rng.choice(L * L, size=3 * E, replace=False)
    i, j = keys // L, keys % L
    keep = i < j
    i, j = i[keep][:E], j[keep][:E]
    mi = rng.choice(np.linspace(0.01, 0.5, 37), size=len(i))  # many ties
    wog = mi * rng.random(len(i))
    colmax = rng.random(L)
    a = EdgeSet(i, j, mi, wog, colmax).sort_desc()
    b = JaxEdgeSet(i, j, mi, wog, colmax).sort_desc()
    for f in ("ipos", "jpos", "mi", "mi_wog"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_aracne_copy_equals_reference():
    rng = np.random.default_rng(2)
    L, E = 120, 2500
    keys = rng.choice(L * L, size=4 * E, replace=False)
    i, j = keys // L, keys % L
    keep = i < j
    i, j = i[keep][:E], j[keep][:E]
    mi = np.round(rng.random(len(i)), 3)  # rounded: exact DPI ties occur
    want = (~jax_aracne_mark_indirect(i, j, mi)).astype(np.uint8)
    np.testing.assert_array_equal(run_aracne(i, j, mi, use_native=False), want)
    np.testing.assert_array_equal(run_aracne(i, j, mi), want)


@pytest.mark.parametrize("mxu_int8,unit", [("auto", True), ("auto", False), ("off", False)])
def test_engine_k_major_operands_equal_the_sample_major_ones(mxu_int8, unit):
    """The engine's K-major copy is the transpose of its slab one-hot with
    zero pad rows, and a block-row's K1 and B3 operands (``row_args``,
    ``row_dual_args``: views of K-major tensors) hold the values of the
    sample-major operands built from the one-hot."""
    al = random_alignment(n_samples=45, n_loci=300, seed=8, gap_frac=0.1)
    if unit:
        al.weights = None
    cfg = EngineConfig(tile=128, mxu_int8=mxu_int8)
    eng = MIEngine(al, cfg, device="cpu",
                   _prebuilt=build_device_data(al, cfg, torch.device("cpu"), keep_onehot=True))
    st, oh, ohk, w = eng.statics, eng.data.onehot, eng._onehot_k, eng.data.weights
    assert torch.equal(ohk[:, :45], oh.T) and not ohk[:, 45:].any()
    assert ohk.shape[1] % (16 // oh.element_size()) == 0
    for i0 in (0, 128):
        xi = oh[:, i0 * 5:(i0 + 128) * 5]
        if st.int8_mode == "unit":
            want = (xi, None)
        elif st.int8_mode == "fixed14":
            w_q = torch.clamp(torch.round(w * torch.tensor(st.int8_scale, dtype=torch.float32)),
                              0, 16383).to(torch.int32)
            want = tuple((xi.to(torch.int32) * d[:, None]).to(torch.int8)
                         for d in (w_q // 128, w_q % 128))
        else:
            want = split_bf16(xi.to(torch.float32) * w[:, None])
        k = eng.row_args(i0)
        s = eng.row_dual_args(i0)
        for a, b, c in zip(k[:3], s[:3], want + (oh[:, i0 * 5:],)):
            assert (a is None) == (b is None) == (c is None)
            if a is not None:
                assert a.stride(0) == 1 and b.stride(0) == 1
                assert torch.equal(a, c) and torch.equal(b, c)
        assert all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
                   for x, y in zip(k[3:], s[3:5] + s[7:]))
