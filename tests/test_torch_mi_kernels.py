"""Kernel K1 of the PyTorch port (spydrpick_torch/ops/mi_kernels.py) against
the JAX package's Pallas kernel ``mi_tile_pallas_single`` (interpret mode,
as tests/test_mi_pallas.py runs it) and the float64 oracle.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel itself is compared with that plain version on the card
(tests/test_torch_gpu.py and chip_smoke.py)."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from spydrpick_tpu.core.alphabet import N_STATES
from spydrpick_tpu.ops import mi_pallas
from spydrpick_tpu.ops.reference import crosstab_pair, mi_single
from spydrpick_torch import sass_compare
from spydrpick_torch.ops import mi_kernels
from spydrpick_torch.ops.mi_kernels import BW, mi_tile_single

from tests.conftest import random_alignment

# Both packages build the same integer (or bf16-exact) crosstables; only
# the f32 log implementation and the order of f32 sums differ.
PARITY_TOL = 1e-5
# tests/test_mi_pallas.py:56 bound against the float64 oracle
ORACLE_TOL = 3e-4


def to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def operands(mode: str, S: int, TI: int, TJ: int, seed: int):
    """Slab operands of one tile (i-columns [0, TI), j-columns [0, TJ)) of
    a random alignment, as numpy arrays, in the given operand mode."""
    al = random_alignment(n_samples=S, n_loci=TJ, seed=seed, gap_frac=0.2)
    if mode == "unit":
        al.weights = np.ones(S)
    oh = np.zeros((S, TJ, N_STATES), np.int8)
    np.put_along_axis(oh, al.codes[:, :, None].astype(np.int64), 1, axis=2)
    xj = np.asarray(mi_pallas.to_slab(oh.reshape(S, TJ * N_STATES), BW))
    pf = np.asarray(mi_pallas.to_slab(
        al.state_presence.astype(np.float32).reshape(-1), BW))
    xi = xj[:, :TI * N_STATES]
    w = al.weights
    if mode == "unit":
        return al, (np.ascontiguousarray(xi), None, xj, pf[:TI * N_STATES], pf, (1,), 1.0)
    if mode == "fixed14":
        q = 16383.0 / float(w.max())
        w_q = np.clip(np.round(w.astype(np.float32) * np.float32(q)), 0, 16383).astype(np.int32)
        hi = (xi.astype(np.int32) * (w_q // 128)[:, None]).astype(np.int8)
        lo = (xi.astype(np.int32) * (w_q % 128)[:, None]).astype(np.int8)
        return al, (hi, lo, xj, pf[:TI * N_STATES], pf, (128, 1), 1.0 / q)
    xi_w = xi.astype(np.float32) * w.astype(np.float32)[:, None]
    hi, lo = (np.asarray(x) for x in mi_pallas.split_bf16(jnp.asarray(xi_w)))
    return al, (hi, lo, xj.astype(ml_dtypes.bfloat16), pf[:TI * N_STATES], pf, (1, 1), 1.0)


def run_jax(ops, bs):
    hi, lo, xj, ipf, jpf, mults, scale = ops
    return np.asarray(mi_pallas.mi_tile_pallas_single(
        jnp.asarray(hi), jnp.asarray(hi if lo is None else lo), jnp.asarray(xj),
        jnp.asarray(ipf), jnp.asarray(jpf), pseudocount=0.5, interpret=True, bs=bs,
        bi=BW, bj=BW, n_passes=len(mults), pass_mults=mults, acc_scale=scale))


def run_port(ops):
    hi, lo, xj, ipf, jpf, mults, scale = ops
    return mi_tile_single(to_torch(hi), None if lo is None else to_torch(lo), to_torch(xj),
                          to_torch(ipf), to_torch(jpf), 0.5, BW, mults, scale).numpy()


@pytest.mark.parametrize("mode", ["unit", "fixed14", "bf16"])
@pytest.mark.parametrize("S,TI,TJ,bs", [
    (64, 128, 128, 64),   # one (bi, bj, S) block
    (64, 256, 384, 32),   # 2 x 3 column blocks, 2 sample blocks
])
def test_plain_k1_matches_pallas(mode, S, TI, TJ, bs):
    al, ops = operands(mode, S, TI, TJ, seed=TI + TJ)
    launches = mi_tile_single.launches
    got = run_port(ops)
    want = run_jax(ops, bs)
    assert mi_tile_single.launches == launches  # CPU tensors never launch the kernel
    assert got.shape == want.shape == (TI, TJ)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=PARITY_TOL)


@pytest.mark.parametrize("mode", ["unit", "fixed14", "bf16"])
def test_plain_k1_matches_oracle(mode):
    al, ops = operands(mode, 96, 128, 256, seed=17)
    got = run_port(ops)
    rng = np.random.default_rng(0)
    for _ in range(60):
        i, j = int(rng.integers(0, 128)), int(rng.integers(0, 256))
        if i == j:
            continue
        C = crosstab_pair(al.codes[:, i], al.codes[:, j], al.weights)
        want = mi_single(C, al.state_presence[i], al.state_presence[j], 0.5)
        assert abs(got[i, j] - want) < ORACLE_TOL, (i, j, got[i, j], want)


def test_to_slab_and_split_bf16_equal_jax():
    rng = np.random.default_rng(5)
    x = rng.random((7, 3 * BW * N_STATES)).astype(np.float32)
    np.testing.assert_array_equal(mi_kernels.to_slab(torch.from_numpy(x), BW).numpy(),
                                  np.asarray(mi_pallas.to_slab(jnp.asarray(x), BW)))
    hi, lo = mi_kernels.split_bf16(torch.from_numpy(x))
    jhi, jlo = mi_pallas.split_bf16(jnp.asarray(x))
    assert torch.equal(hi, to_torch(np.asarray(jhi)))
    assert torch.equal(lo, to_torch(np.asarray(jlo)))


def test_k1_rejects_other_devices():
    """Off the CPU the wrapper launches the kernel or raises: a tensor on
    another device never falls back to the plain version."""
    x = torch.zeros((64, BW * N_STATES), dtype=torch.int8, device="meta")
    p = torch.zeros(BW * N_STATES, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mi_tile_single(x, None, x, p, p, 0.5, BW, (1,), 1.0)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 45, 64])
def test_k_major_is_the_transpose_with_zero_pad_rows(dtype, S):
    """K1 and B4 read K-major operands: k_major(x) holds x transposed, its
    rows padded with zeros to a multiple of 16 bytes, and its [:, :S].T view
    is x again with unit row stride."""
    x = torch.from_numpy(np.random.default_rng(S).integers(-3, 4, (S, 2 * BW))).to(dtype)
    xt = mi_kernels.k_major(x)
    step = 16 // x.element_size()
    assert xt.shape == (2 * BW, -(-S // step) * step) and xt.is_contiguous()
    assert torch.equal(xt[:, :S], x.T) and not xt[:, S:].any()
    view = xt[:, :S].T
    assert view.stride(0) == 1 and torch.equal(view, x)
    assert mi_kernels._kernel_operand(view).data_ptr() == view.data_ptr()  # no copy
    again = mi_kernels._kernel_operand(x)  # a sample-major operand is copied
    assert again.stride(0) == 1 and torch.equal(again, x)


@pytest.mark.parametrize("mode", ["unit", "fixed14", "bf16"])
def test_plain_versions_take_k_major_operands(mode):
    """The engine hands K1 and B4 K-major views; their plain versions give
    the sample-major operands' values bit for bit."""
    _, ops = operands(mode, 45, 128, 256, seed=3)
    hi, lo, xj, ipf, jpf, mults, scale = ops
    hi, xj, ipf, jpf = to_torch(hi), to_torch(xj), to_torch(ipf), to_torch(jpf)
    lo = None if lo is None else to_torch(lo)
    kview = lambda x: None if x is None else mi_kernels.k_major(x)[:, :x.shape[0]].T
    args = (0.5, BW, mults, scale)
    assert torch.equal(mi_tile_single(kview(hi), kview(lo), kview(xj), ipf, jpf, *args),
                       mi_tile_single(hi, lo, xj, ipf, jpf, *args))
    assert torch.equal(mi_kernels.crosstab_tile(kview(hi), kview(lo), kview(xj), BW, mults),
                       mi_kernels.crosstab_tile(hi, lo, xj, BW, mults))


@pytest.mark.parametrize("S", [45, 64])
@pytest.mark.parametrize("mode", ["fixed14", "unit", "bf16"])
def test_b3_takes_either_layout(mode, S):
    """B3 (``mi_tile_dual``) gives the same (mi, wog) bit for bit for K-major
    views, as the engine hands them over, and for sample-major operands."""
    al, (hi, lo, xj, ipf, jpf, mults, scale) = operands(mode, S, 128, 256, seed=S)
    pw = to_torch(mi_pallas.to_slab(al.state_presence_wo_gaps.astype(np.float32).reshape(-1), BW))
    hi, xj, ipf, jpf = to_torch(hi), to_torch(xj), to_torch(ipf), to_torch(jpf)
    lo = None if lo is None else to_torch(lo)
    kview = lambda x: None if x is None else mi_kernels.k_major(x)[:, :x.shape[0]].T
    rest = (ipf, jpf, pw[:128 * N_STATES], pw, 0.5, BW, mults, scale)
    mi, wog = mi_kernels.mi_tile_dual(kview(hi), kview(lo), kview(xj), *rest)
    want_mi, want_wog = mi_kernels.mi_tile_dual(hi, lo, xj, *rest)
    assert torch.equal(mi, want_mi) and torch.equal(wog, want_wog)
    assert not torch.equal(mi, wog)  # the columns have gaps


@pytest.mark.parametrize("case", ["bw", "m1", "meta"])
def test_b3_refuses_what_the_tensor_core_loop_cannot_run(case):
    """B3 takes K1's operand rules: 32-column tiles and, for two int8
    passes, m1 dividing m0; a tensor on another device than the CPU or a
    GPU raises rather than falling back to the plain version."""
    dev = "meta" if case == "meta" else "cpu"
    x = torch.zeros((64, 2 * BW * N_STATES), dtype=torch.int8, device=dev)
    p = torch.zeros(2 * BW * N_STATES, device=dev)
    if case == "meta":
        with pytest.raises(ValueError, match="unsupported device"):
            mi_kernels.mi_tile_dual(x, x, x, p, p, p, p, 0.5, BW, (128, 1), 1.0)
        return
    check = lambda lo, bw, mults: mi_kernels._check_operands(
        "mi_tile_dual", x, lo, x, ((p, p), (p, p)), bw, mults)
    bad = (None, 16, (1,)) if case == "bw" else (x, 32, (128, 3))
    check(bad[0], 32, (128, 1) if bad[0] is not None else (1,))  # the rules met: accepted
    with pytest.raises(ValueError, match="bw % 32" if case == "bw" else "m1 dividing m0"):
        check(*bad)


def test_sass_listing_pairs_kernels_across_builds():
    """``sass_compare`` reads cuobjdump's listing into kernels named
    without the anonymous namespace's name (a hash of the build and one of
    the source, which an edit elsewhere in the file changes), so the kernels
    of two builds of one file pair up, and their instruction lines (with
    their encodings) tell whether the code changed."""
    def listing(file_hash, source_hash, op):
        return ("\n\tcode for sm_90a\n\t\tFunction : _ZN44_GLOBAL__N__" + file_hash
                + "_11_xtab_mma_cu_" + source_hash + "18mi_tile_mma_kernelIaEEvPKT_\n"
                '\t.headerflags\t@"EF_CUDA_SM90"\n'
                "        /*0000*/    LDC R1, c[0x0][0x28] ;    /* 0x00000a00ff017b82 */\n"
                "                                              /* 0x000e700000000800 */\n"
                f"        /*0010*/    {op} ;    /* 0x0000000000137919 */\n")

    a = sass_compare.sass_functions(listing("afdd503b", "8ac9ee78", "S2R R19, SR_TID.X"))
    b = sass_compare.sass_functions(listing("31c813b1", "5c6a2dfe", "S2R R19, SR_TID.X"))
    c = sass_compare.sass_functions(listing("31c813b1", "5c6a2dfe", "S2R R13, SR_TID.X"))
    name = "_ZN_GLOBAL__N_18mi_tile_mma_kernelIaEEvPKT_"
    assert list(a) == list(b) == list(c) == [name]
    assert len(a[name]) == 2 and a == b and a != c


@pytest.mark.parametrize("dtype,S,loop", [
    (torch.int8, 3000, "wgmma"),     # fixed14 and unit, the main path
    (torch.int8, 1, "wgmma"),        # fewer samples than one staged chunk
    (torch.int8, 0, "mma_sync"),     # no sample: no TMA map to build
    (torch.bfloat16, 3000, "mma_sync"),  # the "off" mode keeps the mma.sync loop
    (torch.bfloat16, 0, "mma_sync"),
])
def test_k1_loop_route(dtype, S, loop):
    """K1's main loop on the card (``k1_loop``, the rule of
    ``csrc/xtab_mma.cu:k1_loop``): int8 operands with samples take the
    wgmma loop whatever the tile the wrapper accepts; bf16 keeps mma.sync.
    CPU calls run the plain version and count no launch on either loop."""
    assert mi_kernels.k1_loop(dtype, S) == loop
    assert mi_kernels.K1_LOOPS == ("mma_sync", "wgmma")
    x = torch.zeros((max(S, 1), BW * N_STATES), dtype=dtype)
    p = torch.ones(BW * N_STATES)
    counts = mi_tile_single.launches, mi_tile_single.launches_wgmma
    mi_tile_single(x, None, x, p, p, 0.5, BW, (1,), 1.0, loop=loop)
    assert (mi_tile_single.launches, mi_tile_single.launches_wgmma) == counts


def test_k1_b4_refuse_what_the_tensor_core_loop_cannot_run():
    """Off the CPU, K1, B3 and B4 take either layout, but need 32-column
    tiles and, for two int8 passes, m1 dividing m0 (acc = (m0 / m1) * P0 +
    P1); an operand with neither a unit row nor a unit column stride is
    refused."""
    x = torch.zeros((64, 2 * 32 * N_STATES), dtype=torch.int8)
    check = lambda lo, bw, mults: mi_kernels._check_operands("k1", x, lo, x, (), bw, mults)
    check(x, 32, (128, 1))
    check(None, 64, (1,))
    with pytest.raises(ValueError, match="m1 dividing m0"):
        check(x, 32, (128, 3))
    with pytest.raises(ValueError, match="bw % 32"):
        check(None, 16, (1,))
    xt = mi_kernels.k_major(x)[:, :64].T
    mi_kernels._check_operands("k1", xt, None, xt, (), 32, (1,))
    strided = torch.zeros((64, 4 * 32 * N_STATES), dtype=torch.int8)[:, ::2]
    with pytest.raises(ValueError, match="unit column stride or unit row stride"):
        mi_kernels._check_operands("k1", strided, None, xt, (), 32, (1,))
