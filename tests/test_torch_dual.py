"""Kernel B3 of the PyTorch port (``mi_tile_dual``, spydrpick_torch/ops/
mi_kernels.py) and the engine's exact-wog sweep against the JAX package,
on the CPU: the plain version against the Pallas kernel ``mi_tile_pallas``
in interpret mode and the float64 oracle, and ``wog_fetch="full"`` sweeps
against the JAX engine's.  The CUDA kernel itself is compared with the
plain version on the card (tests/test_torch_gpu.py and chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spydrpick_tpu.engine.outliers import outlier_thresholds
from spydrpick_tpu.engine.solver import EngineConfig as JaxConfig
from spydrpick_tpu.engine.solver import MIEngine as JaxEngine
from spydrpick_tpu.ops import mi_pallas
from spydrpick_tpu.ops.reference import crosstab_pair, mi_single
from spydrpick_torch.engine.solver import EngineConfig, MIEngine
from spydrpick_torch.ops import mi_kernels
from spydrpick_torch.ops.mi_kernels import (
    BW,
    mi_tile_dual,
    mi_tile_dual_plain,
    mi_tile_single,
    mi_tile_single_plain,
)

from tests.conftest import random_alignment
from tests.test_torch_engine import MODES, alignment_for, save_threshold
from tests.test_torch_mi_kernels import operands, to_torch

# same integer (or bf16-exact) crosstables in both packages; only the f32
# log implementation and the order of f32 sums differ
TOL = 1e-5
# tests/test_mi_pallas.py:56 bound against the float64 oracle
ORACLE_TOL = 3e-4


def dual_operands(mode, S, TI, TJ, seed):
    """``operands`` of tests/test_torch_mi_kernels.py plus the slab
    presence with the gap bit cleared, in B3's argument order."""
    al, (hi, lo, xj, ipf, jpf, mults, scale) = operands(mode, S, TI, TJ, seed)
    pw = np.asarray(mi_pallas.to_slab(
        al.state_presence_wo_gaps.astype(np.float32).reshape(-1), BW))
    return al, (hi, lo, xj, ipf, jpf, pw[:TI * 5], pw, mults, scale)


def run_port(ops):
    hi, lo, xj, ipf, jpf, ipwf, jpwf, mults, scale = ops
    mi, wog = mi_tile_dual(to_torch(hi), None if lo is None else to_torch(lo), to_torch(xj),
                           to_torch(ipf), to_torch(jpf), to_torch(ipwf), to_torch(jpwf),
                           0.5, BW, mults, scale)
    return mi.numpy(), wog.numpy()


def run_jax(ops, bs):
    hi, lo, xj, ipf, jpf, ipwf, jpwf, mults, scale = ops
    mi, wog = mi_pallas.mi_tile_pallas(
        jnp.asarray(hi), jnp.asarray(hi if lo is None else lo), jnp.asarray(xj),
        jnp.asarray(ipf), jnp.asarray(jpf), jnp.asarray(ipwf), jnp.asarray(jpwf),
        pseudocount=0.5, interpret=True, bs=bs, bi=BW, bj=BW, pass_mults=mults,
        acc_scale=scale)
    return np.asarray(mi), np.asarray(wog)


@pytest.mark.parametrize("mode", ["unit", "fixed14", "bf16"])
@pytest.mark.parametrize("S,TI,TJ,bs", [
    (64, 128, 128, 64),   # one (bi, bj, S) block
    (64, 256, 384, 32),   # 2 x 3 column blocks, 2 sample blocks
])
def test_plain_b3_matches_pallas(mode, S, TI, TJ, bs):
    _, ops = dual_operands(mode, S, TI, TJ, seed=TI + TJ)
    launches = mi_tile_dual.launches
    mi, wog = run_port(ops)
    want_mi, want_wog = run_jax(ops, bs)
    assert mi_tile_dual.launches == launches  # CPU tensors never launch the kernel
    assert mi.shape == wog.shape == want_mi.shape == (TI, TJ)
    assert np.isfinite(mi).all() and np.isfinite(wog).all()
    np.testing.assert_allclose(mi, want_mi, rtol=0, atol=TOL)
    np.testing.assert_allclose(wog, want_wog, rtol=0, atol=TOL)
    assert np.abs(mi - wog).max() > 1e-3  # the columns have gaps


@pytest.mark.parametrize("mode", ["unit", "fixed14", "bf16"])
def test_plain_b3_matches_oracle(mode):
    al, ops = dual_operands(mode, 96, 128, 256, seed=17)
    mi, wog = run_port(ops)
    rng = np.random.default_rng(1)
    for _ in range(60):
        i, j = int(rng.integers(0, 128)), int(rng.integers(0, 256))
        if i == j:
            continue
        C = crosstab_pair(al.codes[:, i], al.codes[:, j], al.weights)
        want = mi_single(C, al.state_presence[i], al.state_presence[j], 0.5)
        want_wog = mi_single(C, al.state_presence_wo_gaps[i], al.state_presence_wo_gaps[j], 0.5)
        assert abs(mi[i, j] - want) < ORACLE_TOL, (i, j, mi[i, j], want)
        assert abs(wog[i, j] - want_wog) < ORACLE_TOL, (i, j, wog[i, j], want_wog)


@pytest.mark.parametrize("mode", ["unit", "fixed14", "bf16"])
def test_plain_b3_mi_equals_k1(mode):
    """B3's mi is K1's bit for bit: the same crosstable, the same epilogue."""
    _, (hi, lo, xj, ipf, jpf, ipwf, jpwf, mults, scale) = dual_operands(mode, 80, 256, 384, 9)
    args = [None if x is None else to_torch(x) for x in (hi, lo, xj, ipf, jpf, ipwf, jpwf)]
    mi, _ = mi_tile_dual_plain(*args, 0.5, BW, mults, scale)
    k1 = mi_tile_single_plain(*args[:5], 0.5, BW, mults, scale)
    assert torch.equal(mi, k1)


def test_b3_rejects_other_devices():
    """Off the CPU the wrapper launches the kernel or raises: a tensor on
    another device never falls back to the plain version."""
    x = torch.zeros((64, BW * 5), dtype=torch.int8, device="meta")
    p = torch.zeros(BW * 5, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mi_tile_dual(x, None, x, p, p, p, p, 0.5, BW, (1,), 1.0)


def edge_map(e):
    return {(i, j): (m, w) for i, j, m, w in zip(e.ipos.tolist(), e.jpos.tolist(),
                                                  e.mi.tolist(), e.mi_wog.tolist())}


def assert_full_sweeps_agree(port, ref):
    """The port's and the JAX engine's wog_fetch="full" sweeps: edge sets
    equal apart from flips within TOL of the threshold, every common
    edge's mi and wog within TOL, and wog != mi on most edges."""
    assert not port.statics.wog_lazy and not ref.statics.wog_lazy
    thr = save_threshold(port)
    ea, eb = edge_map(port.sweep(thr)), edge_map(ref.sweep(thr))
    for k in set(ea) ^ set(eb):
        assert abs(ea.get(k, eb.get(k))[0] - thr) <= TOL, k
    common = set(ea) & set(eb)
    assert len(common) > 100
    for k in common:
        assert abs(ea[k][0] - eb[k][0]) <= TOL, k
        assert abs(ea[k][1] - eb[k][1]) <= TOL, k
    assert sum(abs(m - w) > 1e-3 for m, w in ea.values()) > len(ea) // 2


@pytest.mark.parametrize("mode", list(MODES))
def test_full_wog_sweep_matches_jax(mode):
    """wog_fetch="full": every edge's mi and wog within TOL of the JAX
    engine's dual Pallas path."""
    al, mxu_int8, extra = alignment_for(mode)
    port = MIEngine(al, EngineConfig(tile=128, mxu_int8=mxu_int8, wog_fetch="full", **extra),
                    device="cpu")
    ref = JaxEngine(al, JaxConfig(tile=128, use_pallas="on", wog_fetch="full",
                                  mxu_int8=mxu_int8, **extra))
    assert_full_sweeps_agree(port, ref)


def test_default_config_wog_matches_jax_default():
    """Both packages' library defaults give the exact wog of every edge
    (ROADMAP §C: the port's default used to be the lazy mode, off by up to
    0.132 on 44,810 of these 44,824 edges)."""
    al = random_alignment(n_samples=48, n_loci=300, seed=5, gap_frac=0.15)
    a = MIEngine(al, EngineConfig(tile=128), device="cpu").sweep(0.02)
    b = JaxEngine(al, JaxConfig(tile=128)).sweep(0.02)
    ea, eb = edge_map(a), edge_map(b)
    common = set(ea) & set(eb)
    assert len(common) > 40000
    assert max(abs(ea[k][1] - eb[k][1]) for k in common) <= TOL
    assert max(abs(ea[k][0] - eb[k][0]) for k in common) <= TOL


def alignment_with_gap_free_columns(mode):
    """alignment_for(mode) with the gaps of every third column replaced by
    state 0, so that some edges join two columns without gaps."""
    al, mxu_int8, extra = alignment_for(mode)
    cols = al.codes[:, ::3]  # a view
    cols[cols == 4] = 0
    return al, mxu_int8, extra


@pytest.mark.parametrize("mode", ["unit", "fixed14", "bf16"])
def test_full_sweep_equals_lazy_sweep(mode):
    """The dual sweep's edges, mi and colmax equal the lazy sweep's bit for
    bit; the lazy sweep's outlier candidates (wog from the pairs path)
    agree within TOL; edges between columns without gaps carry wog == mi."""
    al, mxu_int8, extra = alignment_with_gap_free_columns(mode)
    cfg = dict(tile=128, mxu_int8=mxu_int8, **extra)
    lazy_eng = MIEngine(al, EngineConfig(wog_fetch="outliers", **cfg), device="cpu")
    thr = save_threshold(lazy_eng)
    lazy = lazy_eng.sweep(thr)
    full = MIEngine(al, EngineConfig(wog_fetch="full", **cfg), device="cpu").sweep(thr)
    for f in ("ipos", "jpos", "mi", "colmax"):
        np.testing.assert_array_equal(getattr(lazy, f), getattr(full, f))
    cand = full.mi >= outlier_thresholds(full.colmax)[0]
    assert cand.any()
    np.testing.assert_allclose(lazy.mi_wog[cand], full.mi_wog[cand], rtol=0, atol=TOL)
    gap = al.gap_presence
    no_gap = ~(gap[full.ipos] | gap[full.jpos])
    assert no_gap.sum() > 10
    np.testing.assert_array_equal(full.mi_wog[no_gap], full.mi[no_gap])
    assert np.abs(full.mi_wog - full.mi)[~no_gap].max() > 1e-3


def test_row_mi_dual_is_row_mi_plus_effective_wog():
    al, mxu_int8, _ = alignment_with_gap_free_columns("fixed14")
    eng = MIEngine(al, EngineConfig(tile=128, mxu_int8=mxu_int8), device="cpu")
    for i0 in (0, 128):
        mi, wog = eng.row_mi_dual(i0)
        assert torch.equal(mi, eng.row_mi(i0))
        gap = eng.data.gap
        no_gap = ~(gap[i0:i0 + 128, None] | gap[None, i0:])
        assert torch.equal(wog[no_gap], mi[no_gap])
        raw = mi_tile_dual(*eng.row_dual_args(i0))[1]
        assert torch.equal(wog[~no_gap], raw[~no_gap])


KERNEL_MODES = {"fixed14": ("auto", False), "unit": ("auto", True), "bf16": ("off", False)}


def engine_for(mode, S, n_loci=300, seed=11, **cfg):
    """A CPU engine on a random alignment of S samples whose operands run
    in the given mode."""
    mxu_int8, unit = KERNEL_MODES[mode]
    al = random_alignment(n_samples=S, n_loci=n_loci, seed=seed, gap_frac=0.15)
    if unit:
        al.weights = None
    eng = MIEngine(al, EngineConfig(tile=128, mxu_int8=mxu_int8, **cfg), device="cpu")
    assert eng.statics.int8_mode == ("off" if mode == "bf16" else mode)
    return eng


def storage(x):
    return x.untyped_storage().data_ptr()


@pytest.mark.parametrize("S", [45, 64])
@pytest.mark.parametrize("mode", list(KERNEL_MODES))
def test_row_dual_args_are_k_major_views(mode, S):
    """B3's block-row arguments are ``row_args``' K-major views: the j side
    (and the unit-weight i side) a view of the engine's K-major one-hot,
    the presence slices of its slab vectors, and every operand one that
    the wrapper hands to the kernel as it is, so neither copies."""
    eng = engine_for(mode, S)
    for i0 in (0, 128):
        xi_hi, xi_lo, xj, ipf, jpf, ipwf, jpwf, *_ = eng.row_dual_args(i0)
        assert xj.shape == (S, (eng.Lp - i0) * 5)
        assert storage(xj) == storage(eng._onehot_k)
        assert (xi_lo is None) == (mode == "unit")
        if mode == "unit":
            assert storage(xi_hi) == storage(eng._onehot_k)
        xs = (xi_hi,) if xi_lo is None else (xi_hi, xi_lo)
        assert all(x.stride(0) == 1 for x in xs + (xj,))
        got = mi_kernels._kernel_operands(xs, xj)
        assert [x.data_ptr() for x in got] == [x.data_ptr() for x in (xs[0], xs[-1], xj)]
        for p, slab in ((ipf, eng._pslab), (jpf, eng._pslab), (ipwf, eng._pwslab),
                        (jpwf, eng._pwslab)):
            assert storage(p) == storage(slab)


@pytest.mark.parametrize("S", [45, 64])
@pytest.mark.parametrize("mode", list(KERNEL_MODES))
def test_b3_engine_mi_equals_k1(mode, S):
    """B3's mi from the engine's dual arguments is K1's on ``row_args``
    bit for bit."""
    eng = engine_for(mode, S)
    for i0 in (0, 128):
        mi, wog = mi_tile_dual(*eng.row_dual_args(i0))
        assert torch.equal(mi, mi_tile_single(*eng.row_args(i0)))
        assert not torch.equal(mi, wog)


@pytest.mark.parametrize("mode", list(KERNEL_MODES))
def test_full_wog_sweep_matches_jax_with_a_sample_tail(mode):
    """The exact-wog sweep through B3's K-major arguments at a second
    shape, 45 samples (no multiple of the 16-byte row pad) by 400 columns
    (four block-rows of 128), against the JAX engine's wog_fetch="full"
    sweep."""
    port = engine_for(mode, 45, n_loci=400, seed=13, wog_fetch="full")
    ref = JaxEngine(port.alignment, JaxConfig(tile=128, use_pallas="on", wog_fetch="full",
                                              mxu_int8=KERNEL_MODES[mode][0]))
    assert ref.statics.int8_mode == port.statics.int8_mode
    assert_full_sweeps_agree(port, ref)


def test_wog_fetch_is_validated():
    al, _, _ = alignment_for("unit")
    with pytest.raises(ValueError, match="wog_fetch"):
        MIEngine(al, EngineConfig(tile=128, wog_fetch="lazy"), device="cpu")
    assert MIEngine(al, EngineConfig(tile=128), device="cpu").statics.wog_lazy is False
