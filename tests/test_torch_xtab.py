"""Kernels B4 (``crosstab_tile``) and B5 (``mi_epilogue``) of the PyTorch
port and the sample-shard helpers of spydrpick_torch/parallel/mesh.py,
against the JAX package on the CPU: the plain versions against the Pallas
kernels ``crosstab_tile_pallas`` and ``mi_epilogue_pallas`` in interpret
mode, and B4 -> sum over sample shards -> convert -> B5 against K1's and
B3's plain versions.  The CUDA kernels themselves are compared with the
plain versions on the card (tests/test_torch_gpu.py and chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spydrpick_tpu.ops import mi_pallas
from spydrpick_tpu.parallel.mesh import balanced_row_order as jax_balanced_row_order
from spydrpick_torch.engine.solver import EngineConfig, MIEngine, build_device_data
from spydrpick_torch.ops.mi_kernels import (
    BW,
    crosstab_tile,
    crosstab_tile_plain,
    mi_epilogue,
    mi_epilogue_plain,
    mi_tile_dual_plain,
    mi_tile_single_plain,
    xtab_to_f32,
)
from spydrpick_torch.parallel.mesh import balanced_row_order, sample_range, shard_sample_data

from tests.conftest import random_alignment
from tests.test_torch_dual import dual_operands
from tests.test_torch_engine import alignment_for
from tests.test_torch_mi_kernels import to_torch

# bf16 crosstables: f32 sums of exact bf16 products in another order than
# the Pallas dot's, relative to the largest cell
XTAB_BF16_RTOL = 1e-6
# the f32 epilogue on the same crosstable: XLA's log against torch's (up to
# 1.006e-6 measured on these operands; the port's MI parity bound is 1e-5)
EPILOGUE_TOL = 2e-6
MODES = ["unit", "fixed14", "bf16"]


def port_args(ops):
    return [None if x is None else to_torch(x) for x in ops[:7]] + list(ops[7:])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("S,TI,TJ,bs", [
    (64, 128, 128, 64),   # one (bi, bj, S) block
    (64, 256, 384, 32),   # 2 x 3 column blocks, 2 sample blocks
])
def test_plain_b4_matches_pallas(mode, S, TI, TJ, bs):
    _, (hi, lo, xj, *_, mults, scale) = dual_operands(mode, S, TI, TJ, seed=TI + TJ)
    launches = crosstab_tile.launches
    got = crosstab_tile(to_torch(hi), None if lo is None else to_torch(lo), to_torch(xj), BW,
                        mults).numpy()
    want = np.asarray(mi_pallas.crosstab_tile_pallas(
        jnp.asarray(hi), None if lo is None else jnp.asarray(lo), jnp.asarray(xj), bs=bs,
        bi=BW, bj=BW, interpret=True, pass_mults=mults))
    assert crosstab_tile.launches == launches  # CPU tensors never launch the kernel
    assert got.shape == want.shape == (TI * 5, TJ * 5)
    if mode == "bf16":
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=XTAB_BF16_RTOL * np.abs(want).max())
    else:
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        assert got.max() > (16383 * 10 if mode == "fixed14" else 10)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dual", [False, True])
def test_plain_b5_matches_pallas(mode, dual):
    _, (hi, lo, xj, ipf, jpf, ipwf, jpwf, mults, scale) = dual_operands(mode, 64, 256, 384, 11)
    C = np.asarray(mi_pallas.crosstab_tile_pallas(
        jnp.asarray(hi), None if lo is None else jnp.asarray(lo), jnp.asarray(xj), bs=64,
        bi=BW, bj=BW, interpret=True, pass_mults=mults))
    C = (C.astype(np.float32) * np.float32(scale)).astype(np.float32)
    pres = (ipf, jpf, ipwf, jpwf) if dual else (ipf, jpf)
    want = mi_pallas.mi_epilogue_pallas(jnp.asarray(C), *map(jnp.asarray, pres),
                                        pseudocount=0.5, interpret=True, bi=BW, bj=BW)
    launches = mi_epilogue.launches
    got = mi_epilogue(to_torch(C), *map(to_torch, pres), pseudocount=0.5, bw=BW)
    assert mi_epilogue.launches == launches
    for g, w in zip(got if dual else (got,), want if dual else (want,)):
        assert g.shape == (256, 384) and bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=EPILOGUE_TOL)
    if dual:
        assert float((got[0] - got[1]).abs().max()) > 1e-3  # the columns have gaps


@pytest.mark.parametrize("mode", ["unit", "fixed14"])
@pytest.mark.parametrize("n_shards", [1, 2, 3])
def test_b4_shard_sum_b5_equals_k1_and_b3(mode, n_shards):
    """The split path of a sample-sharded sweep: B4 on each shard's
    samples, the int32 tables summed, converted after the sum, B5 — K1's
    mi and B3's (mi, wog) bit for bit, for any shard count (S = 80 does
    not divide by 3)."""
    _, ops = dual_operands(mode, 80, 256, 384, 9)
    hi, lo, xj, ipf, jpf, ipwf, jpwf, mults, scale = port_args(ops)
    C = 0
    for r in range(n_shards):
        a, b = sample_range(80, n_shards, r)
        C = C + crosstab_tile_plain(hi[a:b], None if lo is None else lo[a:b], xj[a:b], mults)
    assert C.dtype == torch.int32
    C = xtab_to_f32(C, scale)
    k1 = mi_tile_single_plain(hi, lo, xj, ipf, jpf, 0.5, BW, mults, scale)
    b3 = mi_tile_dual_plain(hi, lo, xj, ipf, jpf, ipwf, jpwf, 0.5, BW, mults, scale)
    assert torch.equal(mi_epilogue_plain(C, ipf, jpf, pseudocount=0.5, bw=BW), k1)
    mi, wog = mi_epilogue_plain(C, ipf, jpf, ipwf, jpwf, 0.5, BW)
    assert torch.equal(mi, b3[0]) and torch.equal(wog, b3[1])


def test_b4_b5_reject_other_devices():
    """Off the CPU the wrappers launch the kernel or raise: a tensor on
    another device never falls back to the plain version."""
    x = torch.zeros((64, BW * 5), dtype=torch.int8, device="meta")
    p = torch.zeros(BW * 5, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        crosstab_tile(x, None, x, BW, (1,))
    with pytest.raises(ValueError, match="unsupported device"):
        mi_epilogue(torch.zeros((BW * 5, BW * 5), device="meta"), p, p)


@pytest.mark.parametrize("n", [0, 1, 2, 5, 16, 17, 60])
def test_balanced_row_order_equals_reference(n):
    assert balanced_row_order(n) == jax_balanced_row_order(n)
    assert sorted(balanced_row_order(n)) == list(range(n))


@pytest.mark.parametrize("mode", ["unit", "fixed14", "bf16"])
def test_shard_sample_data_keeps_whole_alignment_statics(mode):
    """A shard holds only its sample rows of the one-hot, weights, codes
    and fixed14 digits; presence, wo-gaps presence, gaps, the int8 mode
    and its scale are the whole alignment's."""
    al, mxu_int8, extra = alignment_for(mode, n_loci=200)
    al.codes[:20, 7] = 4  # column 7's gaps all lie in the first shard's samples
    cfg = EngineConfig(tile=128, mxu_int8=mxu_int8, **extra)
    cpu = torch.device("cpu")
    full = MIEngine(al, cfg, device="cpu", _prebuilt=build_device_data(al, cfg, cpu,
                                                                       keep_onehot=True))
    S = al.n_samples
    for shard in range(3):
        lo, hi = sample_range(S, 3, shard)
        data, st = shard_sample_data(al, cfg, torch.device("cpu"), 3, shard)
        assert st.S == hi - lo
        assert st.int8_mode == full.statics.int8_mode
        assert st.int8_scale == full.statics.int8_scale
        assert st.unit_weights == full.statics.unit_weights
        for f in ("presence", "presence_wog", "gap", "orig_pos"):
            assert torch.equal(getattr(data, f), getattr(full.data, f)), f
        for f in ("weights", "codes"):
            assert torch.equal(getattr(data, f), getattr(full.data, f)[lo:hi]), f
        assert data.onehot is None
        kept, _ = build_device_data(al, cfg, cpu, samples=(lo, hi), keep_onehot=True)
        assert torch.equal(kept.onehot, full.data.onehot[lo:hi])
        local = MIEngine(al, cfg, device="cpu", _prebuilt=(data, st))
        for a, b in zip(local.row_operands(128), full.row_operands(128)):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b[lo:hi])
            else:
                assert a == b
    assert bool(full.data.gap[7])
    # the trap: an alignment cut to a later shard's samples loses column 7's gaps
    lo, hi = sample_range(S, 3, 2)
    sliced = al.subsample(np.arange(lo, hi))
    assert not sliced.gap_presence[7]


def test_sample_range_covers_every_sample():
    for S, k in ((45, 4), (3000, 2), (7, 7), (10, 3)):
        rng = [sample_range(S, k, r) for r in range(k)]
        assert rng[0][0] == 0 and rng[-1][1] == S
        assert all(a[1] == b[0] for a, b in zip(rng, rng[1:]))
        assert max(b - a for a, b in rng) - min(b - a for a, b in rng) <= 1


def test_random_alignment_fixture_unchanged():
    """The sizes the sharding tests mirror (tests/test_sharding.py) still
    build the int8 modes they are meant to."""
    al = random_alignment(n_samples=45, n_loci=256, seed=49, gap_frac=0.1)
    assert MIEngine(al, EngineConfig(tile=128), device="cpu").statics.int8_mode == "fixed14"
    al.weights = None
    assert MIEngine(al, EngineConfig(tile=128), device="cpu").statics.int8_mode == "unit"
