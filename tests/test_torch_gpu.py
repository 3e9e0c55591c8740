"""The port's CUDA kernels and engine on the card, against their plain
PyTorch versions and the CPU engine.  Every test here needs an NVIDIA GPU
and skips without one.  This file imports no jax, so that it runs where
only PyTorch is installed:

    python -m pytest tests/test_torch_gpu.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from spydrpick_torch.core.alignment import Alignment
from spydrpick_torch.core.weights import sample_match_counts
from spydrpick_torch.engine.solver import EngineConfig, MIEngine
from spydrpick_torch.ops.compact import EdgeStore, row_select, row_select_plain
from spydrpick_torch.ops.mi_kernels import (
    BW,
    crosstab_tile,
    crosstab_tile_plain,
    k1_loop,
    k_major,
    mi_epilogue,
    mi_epilogue_plain,
    mi_tile_dual,
    mi_tile_dual_plain,
    mi_tile_single,
    mi_tile_single_plain,
    split_bf16,
    to_slab,
    xtab_to_f32,
)

# the kernel and its plain version build the same integer (or bf16-exact)
# crosstables; only f32 log and sum order may differ
TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def k1_operands(mode, S, TI, TJ, dev, seed=3):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 5, size=(S, TJ))
    oh = np.zeros((S, TJ, 5), np.int8)
    np.put_along_axis(oh, codes[:, :, None], 1, axis=2)
    xj = to_slab(torch.from_numpy(oh.reshape(S, TJ * 5)), BW).to(dev)
    pf = to_slab(torch.from_numpy((oh.sum(0) > 0).astype(np.float32).reshape(-1)), BW).to(dev)
    xi = xj[:, :TI * 5]
    w = torch.from_numpy((rng.random(S) * 0.9 + 0.1).astype(np.float32)).to(dev)
    if mode == "unit":
        return xi, None, xj, pf[:TI * 5], pf, (1,), 1.0
    if mode == "fixed14":
        q = 16383.0 / float(w.max())
        w_q = torch.clamp(torch.round(w * torch.tensor(q, device=dev)), 0, 16383).to(torch.int32)
        x32 = xi.to(torch.int32)
        return ((x32 * (w_q // 128)[:, None]).to(torch.int8),
                (x32 * (w_q % 128)[:, None]).to(torch.int8), xj, pf[:TI * 5], pf,
                (128, 1), 1.0 / q)
    hi, lo = split_bf16(xi.to(torch.float32) * w[:, None])
    return hi, lo, xj.to(torch.bfloat16), pf[:TI * 5], pf, (1, 1), 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["unit", "fixed14", "bf16"])
def test_cuda_k1_matches_plain(cuda_device, mode):
    hi, lo, xj, ipf, jpf, mults, scale = k1_operands(mode, 200, 256, 640, cuda_device)
    launches = mi_tile_single.launches
    got = mi_tile_single(hi, lo, xj, ipf, jpf, 0.5, BW, mults, scale)
    want = mi_tile_single_plain(hi, lo, xj, ipf, jpf, 0.5, BW, mults, scale)
    torch.cuda.synchronize()
    assert mi_tile_single.launches == launches + 1
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= TOL


def k1_window_operands(mode, S, bw, i0, TI, j0, TJ, dev, seed=11):
    """K1's arguments for the (i0, TI) x (j0, TJ) tile of random one-hots in
    slab blocks of bw, each operand a K-major view as the engine keeps it."""
    rng = np.random.default_rng(seed)
    n = max(i0 + TI, j0 + TJ)
    codes = rng.integers(0, 5, size=(S, n))
    oh = np.zeros((S, n, 5), np.int8)
    np.put_along_axis(oh, codes[:, :, None], 1, axis=2)
    x = to_slab(torch.from_numpy(oh.reshape(S, n * 5)), bw).to(dev)
    pf = to_slab(torch.from_numpy((oh.sum(0) > 0).astype(np.float32).reshape(-1)), bw).to(dev)
    cols = lambda t, c0, m: k_major(t[:, c0 * 5:(c0 + m) * 5])[:, :S].T
    if mode == "unit":
        hi, lo, mults, scale = cols(x, i0, TI), None, (1,), 1.0
    else:
        w = rng.random(S) * 0.9 + 0.1
        w_q = torch.from_numpy(np.round(w * 16383.0 / w.max()).astype(np.int32)).to(dev)
        x32 = x.to(torch.int32)
        hi = cols((x32 * (w_q // 128)[:, None]).to(torch.int8), i0, TI)
        lo = cols((x32 * (w_q % 128)[:, None]).to(torch.int8), i0, TI)
        mults, scale = (128, 1), float(w.max()) / 16383.0
    return (hi, lo, cols(x, j0, TJ), pf[i0 * 5:(i0 + TI) * 5], pf[j0 * 5:(j0 + TJ) * 5], 0.5,
            bw, mults, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["unit", "fixed14"])
@pytest.mark.parametrize("bw,S,i0,TI,j0,TJ", [
    (128, 3000, 0, 512, 0, 1024),    # the main path's block-row, cut in width
    (128, 257, 128, 512, 384, 640),  # a ragged last 128-byte chunk; i0 != 0, j0 != i0
    (128, 64, 0, 128, 0, 256),       # fewer sample bytes than one stage
    (32, 3000, 32, 32, 96, 256),     # half an i tile
    (32, 257, 0, 96, 64, 320),       # a ragged i tile (64 + 32 columns)
])
def test_cuda_k1_wgmma_matches_plain_and_mma_sync(cuda_device, mode, bw, S, i0, TI, j0, TJ):
    """K1 in the int8 modes takes the wgmma loop by default and gives its
    plain version's and the mma.sync loop's MI bit for bit; the launch
    counts say which loop ran."""
    args = k1_window_operands(mode, S, bw, i0, TI, j0, TJ, cuda_device)
    assert k1_loop(torch.int8, S) == "wgmma"
    launches, wgmma = mi_tile_single.launches, mi_tile_single.launches_wgmma
    got = mi_tile_single(*args)
    old = mi_tile_single(*args, loop="mma_sync")
    want = mi_tile_single_plain(*args)
    torch.cuda.synchronize()
    assert mi_tile_single.launches == launches + 2
    assert mi_tile_single.launches_wgmma == wgmma + 1
    assert got.shape == (TI, TJ) and bool(torch.isfinite(got).all())
    assert torch.equal(got, want)
    assert torch.equal(got, old)


@pytest.mark.gpu
def test_cuda_k1_loop_refusals(cuda_device):
    """bf16 operands have no wgmma loop, and a loop outside ``K1_LOOPS`` is
    refused: nothing launches."""
    hi, lo, xj, ipf, jpf, mults, scale = k1_operands("bf16", 64, 128, 128, cuda_device)
    launches = mi_tile_single.launches
    for loop in ("wgmma", "mma.sync"):
        with pytest.raises(ValueError, match="loop"):
            mi_tile_single(hi, lo, xj, ipf, jpf, 0.5, BW, mults, scale, loop=loop)
    assert mi_tile_single.launches == launches


def select_case(dev, density, with_wog, T=64, i0=128, Lp=3200, L=3100, seed=5):
    """One block-row for row_select: mi uniform in [-0.25, 1) (negative
    values too), a threshold that keeps ``density`` of it, gaps, a
    circular genome of 3000 positions with an LD gate of 40, and a colmax
    that already holds values (some -inf)."""
    rng = np.random.default_rng(seed)
    t = lambda x: torch.from_numpy(x).to(dev)
    mi = t((rng.random((T, Lp - i0)) * 1.25 - 0.25).astype(np.float32))
    wog = t(rng.random((T, Lp - i0)).astype(np.float32)) if with_wog else None
    colmax = rng.random(Lp).astype(np.float32) * 0.9
    colmax[rng.random(Lp) < 0.3] = -np.inf
    thr = -np.inf if density == 1.0 else 1.0 - 1.25 * density
    args = (t(rng.random(Lp) < 0.3), t(rng.permutation(Lp).astype(np.int32) % 3000))
    return mi, wog, args, t(colmax), thr, dict(i0=i0, n_loci=L, threshold=thr, ld_threshold=40,
                                                  linear_genome=False, genome_size=3000)


def run_select(fn, mi, wog, args, colmax, kw, capacity):
    """fn's store (count, and its edges sorted by (i, j)) and colmax."""
    store = EdgeStore(capacity, wog is not None, mi.device)
    colmax = colmax.clone()
    fn(mi, wog, *args, colmax, store, **kw)
    n = min(int(store.count), capacity)
    got = [a[:n] for a in store.arrays()]
    order = torch.argsort(got[0].long() * 4096 + got[1])
    return int(store.count), [a[order] for a in got], colmax


@pytest.mark.gpu
@pytest.mark.parametrize("with_wog", [False, True])
@pytest.mark.parametrize("density", [0.0, 0.01, 0.3, 1.0])
def test_cuda_row_select_matches_plain(cuda_device, density, with_wog):
    mi, wog, args, colmax, thr, kw = select_case(cuda_device, density, with_wog)
    launches = row_select.launches
    n, got, cm = run_select(row_select, mi, wog, args, colmax, kw, 1 << 18)
    want_n, want, want_cm = run_select(row_select_plain, mi, wog, args, colmax, kw, 1 << 18)
    torch.cuda.synchronize()
    assert row_select.launches == launches + 1
    assert n == want_n and (n > 0) == (density > 0)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(cm.view(torch.int32), want_cm.view(torch.int32))


@pytest.mark.gpu
def test_cuda_row_select_counts_past_capacity(cuda_device):
    """A store of 100 slots: the count is the plain version's, 100 slots
    are written, each an edge of the plain version's."""
    mi, wog, args, colmax, thr, kw = select_case(cuda_device, 0.01, True)
    n, got, _ = run_select(row_select, mi, wog, args, colmax, kw, 100)
    want_n, want, _ = run_select(row_select_plain, mi, wog, args, colmax, kw, 1 << 18)
    assert n == want_n > 100 and len(got[0]) == 100
    keys = lambda e: set(zip(*(x.tolist() for x in e)))
    assert keys(got) <= keys(want)


@pytest.mark.gpu
@pytest.mark.parametrize("i0,j0,W,with_wog", [(0, 1024, 1024, False), (512, 256, 1024, True),
                                              (1024, 1536, 1536, False)])
def test_cuda_row_select_window_matches_plain(cuda_device, i0, j0, W, with_wog):
    """B2 on a j-window (columns [j0, j0 + W)): right of the diagonal,
    straddling it, and LD-gated just right of it: count, sorted edges and
    colmax bits equal the plain version's."""
    mi, wog, args, colmax, thr, kw = select_case(cuda_device, 0.01, with_wog)
    mi = mi[:, :W].contiguous()
    wog = None if wog is None else wog[:, :W].contiguous()
    kw.update(i0=i0, j0=j0)
    n, got, cm = run_select(row_select, mi, wog, args, colmax, kw, 1 << 18)
    want_n, want, want_cm = run_select(row_select_plain, mi, wog, args, colmax, kw, 1 << 18)
    assert n == want_n > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(cm.view(torch.int32), want_cm.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("wog_fetch", ["outliers", "full"])
def test_cuda_windowed_codes_sweep_equals_full_width(cuda_device, wog_fetch):
    """j-windows and codes storage on the card: K1 (or B3) and B2 once per
    item, and the full-width dense sweep's arrays element for element."""
    al = alignment(96, 1400)
    full = MIEngine(al, EngineConfig(tile=256, wog_fetch=wog_fetch, row_window=1),
                    device=cuda_device).sweep(0.05)
    eng = MIEngine(al, EngineConfig(tile=256, wog_fetch=wog_fetch, row_window=512,
                                    onehot_storage="codes"), device=cuda_device)
    kernel = mi_tile_single if wog_fetch == "outliers" else mi_tile_dual
    launches = kernel.launches, row_select.launches
    tm = {}
    got = eng.sweep(0.05, timings=tm)
    assert tm["n_items"] > tm["n_rows"] and tm["expand_s"] > 0
    assert (kernel.launches - launches[0], row_select.launches - launches[1]) == (tm["n_items"],) * 2
    for f in ("ipos", "jpos", "mi", "mi_wog", "colmax"):
        np.testing.assert_array_equal(getattr(got, f), getattr(full, f), err_msg=f)


def alignment(S, L, unit=False, seed=8):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(S, L)).astype(np.uint8)
    codes[rng.random((S, L)) < 0.05] = 4
    return Alignment(codes, [f"s{i}" for i in range(S)], "gpu", np.arange(L), L,
                     None if unit else rng.random(S) * 0.9 + 0.1)


@pytest.mark.gpu
def test_cuda_sample_match_counts_exact(cuda_device):
    """f32 matmuls with TF32 off: integer counts as exact as on the CPU."""
    al = alignment(300, 5000)
    got = sample_match_counts(al, tile=2048, device=cuda_device)
    np.testing.assert_array_equal(got, sample_match_counts(al, tile=2048, device="cpu"))
    assert got.max() > 2**11  # past what TF32 holds exactly


@pytest.mark.gpu
@pytest.mark.parametrize("unit", [False, True])
def test_cuda_sweep_matches_cpu(cuda_device, unit):
    al = alignment(96, 700, unit)
    cfg = EngineConfig(tile=256, wog_fetch="outliers")
    cpu = MIEngine(al, cfg, device="cpu")
    gpu = MIEngine(al, cfg, device=cuda_device)
    assert gpu.statics.int8_mode == ("unit" if unit else "fixed14")
    thr = 0.05
    a, b = cpu.sweep(thr), gpu.sweep(thr)
    ea = dict(zip(zip(a.ipos.tolist(), a.jpos.tolist()), zip(a.mi.tolist(), a.mi_wog.tolist())))
    eb = dict(zip(zip(b.ipos.tolist(), b.jpos.tolist()), zip(b.mi.tolist(), b.mi_wog.tolist())))
    for k in set(ea) ^ set(eb):
        assert abs(ea.get(k, eb.get(k))[0] - thr) <= TOL, k
    for k in set(ea) & set(eb):
        assert abs(ea[k][0] - eb[k][0]) <= TOL and abs(ea[k][1] - eb[k][1]) <= TOL, k
    np.testing.assert_allclose(a.colmax, b.colmax, rtol=0, atol=TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("wog_fetch", ["outliers", "full"])
def test_cuda_tiny_store_sweep_equals_default(cuda_device, wog_fetch):
    """A 64-slot store overflows on the card: the sweep grows it, sweeps
    rows again (more row_select launches than block-rows) and returns the
    default sweep's arrays element for element."""
    al = alignment(96, 700)
    want = MIEngine(al, EngineConfig(tile=256, wog_fetch=wog_fetch), device=cuda_device).sweep(0.05)
    launches = row_select.launches
    got = MIEngine(al, EngineConfig(tile=256, wog_fetch=wog_fetch, store_capacity=64),
                   device=cuda_device).sweep(0.05)
    assert row_select.launches - launches > 3 and want.n_edges > 1000
    for f in ("ipos", "jpos", "mi", "mi_wog", "colmax"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["unit", "fixed14", "off"])
def test_cuda_k1_engine_row_args(cuda_device, mode):
    """K1 on the engine's own block-row arguments, as the sweep gives
    them: strided column views of the one-hot, TJ = Lp - i0 and a sample
    tail (S = 200 is no multiple of the kernel's sample chunk)."""
    al = alignment(200, 1500, unit=mode == "unit")
    cfg = EngineConfig(tile=256, mxu_int8="off" if mode == "off" else "auto")
    eng = MIEngine(al, cfg, device=cuda_device)
    assert eng.statics.int8_mode == mode
    for i0 in (0, 768):
        args = eng.row_args(i0)
        got = mi_tile_single(*args)
        want = mi_tile_single_plain(*args)
        torch.cuda.synchronize()
        assert got.shape == (256, eng.Lp - i0)
        assert float((got - want).abs().max()) <= TOL


def wog_presence(pf):
    """Slab presence with the gap state (4) cleared."""
    pw = pf.reshape(-1, 5, BW).clone()
    pw[:, 4] = 0
    return pw.reshape(-1)


def assert_b3_matches(args, single_args):
    """B3 against its plain version (mi and wog within TOL), its mi against
    K1's on the same operands bit for bit in every mode (one main loop,
    conversion and epilogue), and in the int8 modes its (mi, wog) against
    B4 -> convert -> B5 bit for bit."""
    launches = mi_tile_dual.launches
    mi, wog = mi_tile_dual(*args)
    want_mi, want_wog = mi_tile_dual_plain(*args)
    k1 = mi_tile_single(*single_args)
    torch.cuda.synchronize()
    assert mi_tile_dual.launches == launches + 1
    assert bool(torch.isfinite(mi).all()) and bool(torch.isfinite(wog).all())
    assert float((mi - want_mi).abs().max()) <= TOL
    assert float((wog - want_wog).abs().max()) <= TOL
    assert torch.equal(mi, k1)
    if args[0].dtype == torch.int8:
        xi_hi, xi_lo, xj, ipf, jpf, ipwf, jpwf, pc, bw, mults, scale = args
        C = xtab_to_f32(crosstab_tile(xi_hi, xi_lo, xj, bw, mults), scale)
        split = mi_epilogue(C, ipf, jpf, ipwf, jpwf, pc, bw)
        assert torch.equal(mi, split[0]) and torch.equal(wog, split[1])
    assert not torch.equal(mi, wog)  # the operands have gaps


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["unit", "fixed14", "bf16"])
def test_cuda_b3_matches_plain_and_k1(cuda_device, mode):
    hi, lo, xj, ipf, jpf, mults, scale = k1_operands(mode, 200, 256, 640, cuda_device)
    assert_b3_matches((hi, lo, xj, ipf, jpf, wog_presence(ipf), wog_presence(jpf), 0.5, BW,
                       mults, scale),
                      (hi, lo, xj, ipf, jpf, 0.5, BW, mults, scale))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["unit", "fixed14", "off"])
def test_cuda_b3_engine_row_args(cuda_device, mode):
    """B3 on the engine's own dual block-row arguments: K-major views of
    the engine's copy of the one-hot, TJ = Lp - i0 and a sample tail
    (S = 200)."""
    al = alignment(200, 1500, unit=mode == "unit")
    cfg = EngineConfig(tile=256, mxu_int8="off" if mode == "off" else "auto")
    eng = MIEngine(al, cfg, device=cuda_device)
    assert eng.statics.int8_mode == mode
    for i0 in (0, 768):
        args = eng.row_dual_args(i0)
        assert args[2].stride() == (1, eng._onehot_k.shape[1])
        assert args[2].shape[1] == (eng.Lp - i0) * 5
        assert_b3_matches(args, eng.row_args(i0))


@pytest.mark.gpu
@pytest.mark.parametrize("unit", [False, True])
def test_cuda_full_wog_sweep_matches_cpu(cuda_device, unit):
    """wog_fetch="full": one B3 launch per block-row and no K1 launch;
    edges, mi and exact wog as on the CPU."""
    al = alignment(96, 700, unit)
    cfg = EngineConfig(tile=256, wog_fetch="full")
    cpu = MIEngine(al, cfg, device="cpu")
    gpu = MIEngine(al, cfg, device=cuda_device)
    thr = 0.05
    k1, b3 = mi_tile_single.launches, mi_tile_dual.launches
    a, b = cpu.sweep(thr), gpu.sweep(thr)
    assert mi_tile_single.launches == k1 and mi_tile_dual.launches == b3 + 3
    ea = dict(zip(zip(a.ipos.tolist(), a.jpos.tolist()), zip(a.mi.tolist(), a.mi_wog.tolist())))
    eb = dict(zip(zip(b.ipos.tolist(), b.jpos.tolist()), zip(b.mi.tolist(), b.mi_wog.tolist())))
    for k in set(ea) ^ set(eb):
        assert abs(ea.get(k, eb.get(k))[0] - thr) <= TOL, k
    assert len(set(ea) & set(eb)) > 1000
    for k in set(ea) & set(eb):
        assert abs(ea[k][0] - eb[k][0]) <= TOL and abs(ea[k][1] - eb[k][1]) <= TOL, k
    np.testing.assert_allclose(a.colmax, b.colmax, rtol=0, atol=TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["unit", "fixed14", "bf16"])
def test_cuda_b4_b5_match_plain_and_k1_b3(cuda_device, mode):
    """B4 against its plain version (int32 equal; bf16 within 1e-5 of the
    largest cell), B5 against its plain version on the same crosstable,
    and B4 -> convert -> B5 against K1's mi and B3's (mi, wog): bit for
    bit in the int8 modes."""
    hi, lo, xj, ipf, jpf, mults, scale = k1_operands(mode, 200, 256, 640, cuda_device)
    ipwf, jpwf = wog_presence(ipf), wog_presence(jpf)
    launches = crosstab_tile.launches, mi_epilogue.launches
    C = crosstab_tile(hi, lo, xj, BW, mults)
    want = crosstab_tile_plain(hi, lo, xj, mults)
    torch.cuda.synchronize()
    assert C.dtype == want.dtype and C.shape == (256 * 5, 640 * 5)
    if mode == "bf16":
        assert float((C - want).abs().max()) <= 1e-5 * float(want.abs().max())
    else:
        assert torch.equal(C, want)
    Cf = xtab_to_f32(C, scale)
    mi = mi_epilogue(Cf, ipf, jpf, pseudocount=0.5, bw=BW)
    mi2, wog = mi_epilogue(Cf, ipf, jpf, ipwf, jpwf, 0.5, BW)
    pmi, pwog = mi_epilogue_plain(Cf, ipf, jpf, ipwf, jpwf, 0.5, BW)
    torch.cuda.synchronize()
    assert (crosstab_tile.launches, mi_epilogue.launches) == (launches[0] + 1, launches[1] + 2)
    assert bool(torch.isfinite(mi).all()) and bool(torch.isfinite(wog).all())
    assert float((mi - pmi).abs().max()) <= TOL and float((wog - pwog).abs().max()) <= TOL
    assert torch.equal(mi, mi2)
    if mode != "bf16":
        assert torch.equal(mi, mi_tile_single(hi, lo, xj, ipf, jpf, 0.5, BW, mults, scale))
        b3 = mi_tile_dual(hi, lo, xj, ipf, jpf, ipwf, jpwf, 0.5, BW, mults, scale)
        assert torch.equal(mi, b3[0]) and torch.equal(wog, b3[1])


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["unit", "fixed14"])
def test_cuda_split_path_on_engine_row_args(cuda_device, mode):
    """The sample-sharded split path on the engine's own block-row
    arguments (strided views, TJ = Lp - i0, S = 200 cut 101 + 99): B4 per
    shard, int32 sum, convert, B5 — K1's mi bit for bit."""
    al = alignment(200, 1500, unit=mode == "unit")
    eng = MIEngine(al, EngineConfig(tile=256), device=cuda_device)
    assert eng.statics.int8_mode == mode
    for i0 in (0, 768):
        hi, lo, xj, ipf, jpf, pc, bw, mults, scale = eng.row_args(i0)
        C = sum(crosstab_tile(hi[a:b], None if lo is None else lo[a:b], xj[a:b], bw, mults)
                for a, b in ((0, 101), (101, 200)))
        mi = mi_epilogue(xtab_to_f32(C, scale), ipf, jpf, pseudocount=pc, bw=bw)
        assert torch.equal(mi, eng.row_mi(i0))


@pytest.mark.gpu
def test_cuda_to_host_in_chunks(cuda_device, monkeypatch):
    """``to_host`` on a card: gathered, widened and copied through pinned
    memory in HOST_CHUNK steps (here 1000 elements) equals the CPU's."""
    from spydrpick_torch import device as device_mod

    monkeypatch.setattr(device_mod, "HOST_CHUNK", 1000)
    rng = np.random.default_rng(4)
    i = torch.from_numpy(rng.integers(0, 10**6, 4321).astype(np.int32))
    m = torch.from_numpy(rng.random(4321).astype(np.float32))
    order = torch.from_numpy(rng.permutation(4321))
    dtypes = [torch.int64, torch.float64]
    want = device_mod.to_host([i, m], order, dtypes)
    got = device_mod.to_host([i.to(cuda_device), m.to(cuda_device)], order.to(cuda_device),
                             dtypes)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_cuda_sort_desc_on_ties(cuda_device):
    """The device sort keeps (ipos, jpos) order inside runs of equal mi on
    CUDA as numpy's sort_desc does (stable descending sort)."""
    from spydrpick_torch.engine.solver import EdgeSet

    rng = np.random.default_rng(12)
    L, E = 3000, 200_000
    keys = rng.choice(L * L, size=3 * E, replace=False)
    i, j = keys // L, keys % L
    keep = i < j
    i, j = i[keep][:E], j[keep][:E]
    mi = rng.choice(np.linspace(0.01, 0.5, 37), size=len(i))
    e = EdgeSet(i, j, mi, mi * rng.random(len(i)), rng.random(L))
    (got, dev), want = e.sorted_on(cuda_device), e.sort_desc()
    for f in ("ipos", "jpos", "mi", "mi_wog"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for f in ("ipos", "jpos", "mi"):
        np.testing.assert_array_equal(getattr(dev, f).cpu().numpy(), getattr(want, f))


def random_graph(rng, L, E, decimals=None):
    """E distinct edges i < j over L nodes, weights in [0, 1) (rounded to
    ``decimals`` for DPI ties), as int64 / f64 numpy arrays."""
    keys = rng.choice(L * L, size=3 * E, replace=False)
    i, j = keys // L, keys % L
    keep = i < j
    i, j = i[keep][:E], j[keep][:E]
    mi = rng.random(len(i))
    return i, j, mi if decimals is None else np.round(mi, decimals)


@pytest.mark.gpu
@pytest.mark.parametrize("thr", [0.0, float(np.finfo(np.float64).eps), 1e-3])
@pytest.mark.parametrize("decimals", [None, 2])
def test_cuda_aracne_flags_match_plain_and_native(cuda_device, thr, decimals):
    """Kernel A's flags equal its plain version's and the native
    owner-scan's bit for bit (hub node and ties included)."""
    from spydrpick_torch.native import aracne_native
    from spydrpick_torch.ops.aracne import aracne_flags, aracne_flags_plain

    rng = np.random.default_rng(21)
    i, j, mi = random_graph(rng, 900, 40_000, decimals)
    hub = np.arange(1, 900)
    i, j = np.concatenate([i, np.zeros(899, np.int64)]), np.concatenate([j, hub])
    keys, first = np.unique(i * 900 + j, return_index=True)
    i, j = i[first], j[first]
    mi = np.concatenate([mi, rng.random(899)])[first]
    t = lambda x: torch.from_numpy(x).to(cuda_device)
    n0 = aracne_flags.launches
    got = aracne_flags(t(i), t(j), t(mi), thr)
    assert aracne_flags.launches == n0 + 1 and got.dtype == torch.uint8 and got.is_cuda
    plain = aracne_flags_plain(t(i), t(j), t(mi), thr)
    native = (~aracne_native.mark_indirect(i, j, mi, thr)).astype(np.uint8)
    np.testing.assert_array_equal(got.cpu().numpy(), plain.cpu().numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), native)
    assert 0 < int(got.sum()) < len(mi)


@pytest.mark.gpu
def test_cuda_aracne_flags_refusals(cuda_device):
    from spydrpick_torch.ops.aracne import aracne_flags

    t = lambda x, dt=torch.int64: torch.tensor(x, dtype=dt, device=cuda_device)
    w = t([0.5, 0.4], torch.float64)
    with pytest.raises(ValueError, match="ipos < jpos"):
        aracne_flags(t([0, 3]), t([1, 2]), w)
    with pytest.raises(ValueError, match="int64"):
        aracne_flags(t([0, 1], torch.int32), t([1, 2]), w)
    with pytest.raises(ValueError, match="float64"):
        aracne_flags(t([0, 1]), t([1, 2]), w.float())
    with pytest.raises(ValueError, match="contiguous"):
        aracne_flags(t([0, 9, 1, 9]).view(2, 2)[:, 0], t([1, 2]), w)
    with pytest.raises(ValueError, match="int32"):
        aracne_flags(t([0, 1]), t([1, 2**31]), w)
    with pytest.raises(ValueError, match="repeats"):
        aracne_flags(t([0, 0]), t([1, 1]), w)
    assert aracne_flags(t([]), t([]), t([], torch.float64)).shape == (0,)


def adversarial_mi(rng, n_random=20_000):
    """Values whose "%.6f" is easy to get wrong: the binary-exact ties
    (odd multiples of 2^-7 up to ln 5), one ulp either side of halfway
    points, 5e-7 +- 1 ulp, subnormals, and random values up to ln 5."""
    ties = np.arange(1, 207, 2) * 2.0**-7
    half = (rng.integers(0, 1_609_438, n_random) + 0.5) / 1e6
    tiny = np.array([0.0, 5e-7, np.nextafter(5e-7, 0), np.nextafter(5e-7, 1), 5e-324,
                     2.2250738585072014e-308, 1e-310, 1e-300, 9.0e9, 123456.5])
    return np.concatenate([ties, half, np.nextafter(half, 0), np.nextafter(half, 1), tiny,
                           rng.random(n_random) * np.log(5)])


@pytest.mark.gpu
def test_cuda_format_rows_match_plain_python_and_native(cuda_device):
    """Kernel B's bytes equal its plain version's, Python's f-string's
    and the native formatter's."""
    from spydrpick_torch.native import format_native
    from spydrpick_torch.ops.format import format_couplings_rows, format_couplings_rows_plain

    rng = np.random.default_rng(22)
    mi = adversarial_mi(rng)
    n = len(mi)
    p1 = rng.integers(-5, 10**7, n)
    p2 = rng.integers(0, 10**18, n)
    d = rng.integers(-3, 10**5, n)
    fl = rng.integers(0, 3, n).astype(np.uint8)
    t = lambda x: torch.from_numpy(x).to(cuda_device)
    n0 = format_couplings_rows.launches
    got = format_couplings_rows(t(p1), t(p2), t(d), t(fl), t(mi))
    assert format_couplings_rows.launches == n0 + 1 and got.is_cuda
    got = got.cpu().numpy().tobytes()
    want = "".join(f"{a} {b} {c} {int(f != 0)} {x:.6f}\n"
                   for a, b, c, f, x in zip(p1, p2, d, fl, mi)).encode()
    assert got == want
    assert got == format_native.format_couplings(p1, p2, d, fl, mi)
    plain = format_couplings_rows_plain(t(p1), t(p2), t(d), t(fl), t(mi))
    assert plain.cpu().numpy().tobytes() == want


@pytest.mark.gpu
@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -1e-3, -0.0, 2.0**53 / 1e6])
def test_cuda_format_rows_refusals(cuda_device, bad):
    from spydrpick_torch.ops.format import format_couplings_rows

    z = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    f = torch.zeros(2, dtype=torch.uint8, device=cuda_device)
    mi = torch.tensor([0.5, bad], dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="mi holds"):
        format_couplings_rows(z, z, z, f, mi)
    with pytest.raises(ValueError, match="int64"):
        format_couplings_rows(z.int(), z, z, f, mi.abs())


# ---------------------------------------------------------------- lead-in

def lead_in_codes(rng, S, L):
    """Codes 0..4 with pad cells (255) and a whole pad column."""
    codes = rng.integers(0, 5, size=(S, L)).astype(np.uint8)
    codes[rng.random((S, L)) < 0.03] = 255
    codes[:, L // 2] = 255
    return codes


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 1), (1, 7), (3, 4), (257, 1021), (600, 4096),
                                   (3000, 30720)])
def test_cuda_column_counts_match_plain(cuda_device, shape):
    from spydrpick_torch.ops.columns import column_state_counts, column_state_counts_plain

    codes = torch.from_numpy(lead_in_codes(np.random.default_rng(sum(shape)), *shape))
    want = column_state_counts_plain(codes)
    n0 = column_state_counts.launches
    got = column_state_counts(codes.to(cuda_device))
    torch.cuda.synchronize()
    assert column_state_counts.launches == n0 + 1
    assert got.dtype == torch.int32 and got.is_cuda
    assert torch.equal(got.cpu(), want)
    assert torch.equal(column_state_counts_plain(codes.to(cuda_device)).cpu(), want)


@pytest.mark.gpu
def test_cuda_column_counts_unaligned_rows_and_refusals(cuda_device):
    """Rows that do not start at a multiple of 4 bytes (L % 4 == 0 but an
    odd data pointer) take the byte path and count the same; what the
    kernel does not take is refused."""
    from spydrpick_torch.ops.columns import column_state_counts, column_state_counts_plain

    rng = np.random.default_rng(7)
    S, L = 130, 512
    buf = torch.from_numpy(lead_in_codes(rng, 1, S * L + 1).ravel()).to(cuda_device)
    codes = buf[1:].view(S, L)
    assert codes.data_ptr() % 4 == 1 and codes.is_contiguous()
    assert torch.equal(column_state_counts(codes), column_state_counts_plain(codes))
    ok = codes.contiguous()
    for bad in (ok.to(torch.int32), ok[:, ::2], ok.reshape(-1)):
        with pytest.raises(ValueError, match="column_state_counts"):
            column_state_counts(bad)


def lead_in_weights(kind, S, rng):
    if kind == "unit":
        return np.ones(S, np.float32)
    if kind == "computed":
        return (1.0 / rng.integers(1, S + 1, S)).astype(np.float32)
    if kind == "bench":
        return (rng.random(S) * 0.9 + 0.1).astype(np.float32)
    return (2.0 ** rng.uniform(-45, 0, S)).astype(np.float32)  # outside the exact range


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 1), (1, 33), (5, 1), (257, 613), (3000, 4097)])
@pytest.mark.parametrize("kind", ["unit", "computed", "bench", "wide"])
def test_cuda_pairs_xtab_match_plain(cuda_device, shape, kind):
    """Bit-equal to the plain version for weights in the exact range (and
    under a permutation of the pairs), within one f32 ulp outside it."""
    from spydrpick_torch.ops.pairs import pairs_xtab, pairs_xtab_plain

    S, P = shape
    rng = np.random.default_rng(S + P)
    ci = torch.from_numpy(lead_in_codes(rng, S, P)).to(cuda_device)
    cj = torch.from_numpy(rng.integers(0, 5, size=(S, P)).astype(np.uint8)).to(cuda_device)
    w = torch.from_numpy(lead_in_weights(kind, S, rng)).to(cuda_device)
    n0 = pairs_xtab.launches
    got = pairs_xtab(ci, cj, w)
    torch.cuda.synchronize()
    assert pairs_xtab.launches == n0 + 1 and got.shape == (P, 5, 5)
    want = pairs_xtab_plain(ci.cpu(), cj.cpu(), w.cpu())
    if kind == "wide":
        ulp = torch.from_numpy(np.spacing(np.abs(want.numpy())))
        assert bool(((got.cpu() - want).abs() <= ulp).all())
        return
    assert torch.equal(got.cpu(), want)
    assert torch.equal(pairs_xtab_plain(ci, cj, w).cpu(), want)
    perm = torch.from_numpy(rng.permutation(P)).to(cuda_device)
    got_p = pairs_xtab(ci[:, perm].contiguous(), cj[:, perm].contiguous(), w)
    assert torch.equal(got_p, got[perm])


@pytest.mark.gpu
def test_cuda_pairs_xtab_refusals(cuda_device):
    from spydrpick_torch.ops.pairs import pairs_xtab

    ci = torch.zeros((8, 40), dtype=torch.uint8, device=cuda_device)
    w = torch.ones(8, dtype=torch.float32, device=cuda_device)
    for bad in ((ci, ci[:, :20], w), (ci, ci.int(), w), (ci[:, ::2], ci[:, ::2], w),
                (ci, ci, w.double()), (ci, ci, w[:7]), (ci, ci, w.cpu())):
        with pytest.raises(ValueError, match="pairs_xtab"):
            pairs_xtab(*bad)


@pytest.mark.gpu
def test_cuda_lead_in_runs_the_kernels(cuda_device, tmp_path, monkeypatch):
    """On a card ``load_and_preprocess`` keeps the codes there, counts and
    filters them with the kernel (no host pass), and the engine's
    tournament tables come from ``pairs_xtab``: the same alignment, device
    data and threshold as on the CPU, bit for bit."""
    from spydrpick_torch.engine import threshold
    from spydrpick_torch.io.fasta import write_fasta
    from spydrpick_torch.ops.columns import column_state_counts
    from spydrpick_torch.ops.pairs import pairs_xtab
    from spydrpick_torch.pipeline import PipelineOptions, load_and_preprocess

    rng = np.random.default_rng(3)
    S, L = 200, 700
    codes = rng.integers(0, 4, size=(S, L)).astype(np.uint8)
    codes[:, 100:140] = 1                         # dropped by the filter
    codes[rng.random((S, L)) < 0.04] = 4
    path = str(tmp_path / "lead.fasta")
    write_fasta(path, Alignment(codes, [f"s{k}" for k in range(S)], "lead", np.arange(L), L))
    opts = PipelineOptions(alignmentfile=path, tile=128)
    n_counts, n_pairs = column_state_counts.launches, pairs_xtab.launches
    tm = {}
    al = load_and_preprocess(opts, tm)
    assert al.device_codes is not None and al.device_codes.is_cuda
    assert column_state_counts.launches > n_counts and tm["upload_s"] > 0
    assert "codes" not in al.__dict__  # the filter's subset: no host copy yet
    monkeypatch.setenv("SPYDRPICK_TORCH_DEVICE", "cpu")
    al_cpu = load_and_preprocess(opts)
    monkeypatch.delenv("SPYDRPICK_TORCH_DEVICE")
    np.testing.assert_array_equal(al.device_codes.cpu().numpy(), al_cpu.codes)
    np.testing.assert_array_equal(al.codes, al_cpu.codes)
    np.testing.assert_array_equal(al.weights, al_cpu.weights)
    np.testing.assert_array_equal(al.state_counts, al_cpu.state_counts)
    eng = MIEngine(al, EngineConfig(tile=128), device=cuda_device)
    ref = MIEngine(al_cpu, EngineConfig(tile=128), device="cpu")
    for f in ("presence", "presence_wog", "gap", "orig_pos", "codes", "weights"):
        assert torch.equal(getattr(eng.data, f).cpu(), getattr(ref.data, f)), f
    i = torch.from_numpy(rng.integers(0, eng.L - 1, 5000))
    j = i + 1 + torch.from_numpy(rng.integers(0, 10**6, 5000)) % (eng.L - 1 - i)
    assert torch.equal(eng.pairs_table(i.to(cuda_device), j.to(cuda_device)).cpu(),
                       ref.pairs_table(i, j))
    kw = dict(n_values=2000, threshold_pairs=5000, iterations=3, seed=9)
    tm = {}
    got = threshold.determine_mi_threshold(eng, timings=tm, **kw)
    assert pairs_xtab.launches > n_pairs and tm["device_s"] > 0
    assert abs(got - threshold.determine_mi_threshold(ref, **kw)) <= TOL
