"""Kernels K1 and B3, the all-pairs MI tile (ports of
spydrpick_tpu/ops/mi_pallas.py:mi_tile_pallas_single and its dual,
mi_tile_pallas), and B4 and B5, the same tile split around a sum over
sample shards (ports of crosstab_tile_pallas and mi_epilogue_pallas).

``mi_tile_single`` (K1) computes the (TI, TJ) f32 with-gaps MI of every
column pair from slab-layout one-hot operands: the weighted crosstable
C = sum_passes mult * (Xi^T Xj) over samples, then f32(C) * acc_scale,
then the fused pseudocount + entropy epilogue of ``_mi_from_block``.
``mi_tile_dual`` (B3) runs the same epilogue twice on one crosstable:
with the presence vectors (mi, bit-equal to K1's) and with the wo-gaps
presence vectors (wog).  ``crosstab_tile`` (B4) returns the crosstable
itself, unscaled (int32 for int8 operands), so that sample shards can sum
it exactly; ``xtab_to_f32`` converts the sum as K1 does and
``mi_epilogue`` (B5) runs K1's epilogue on it.  On CUDA tensors each
launches its hand-written kernel (K1, B3 and B4 in ``csrc/xtab_mma.cu``:
K1's int8 modes on a TMA-fed ``wgmma`` loop, ``csrc/xtab_wgmma.cuh``, the
rest on one ``mma.sync`` loop, ``csrc/xtab_mma.cuh``; B5 in
``csrc/xtab.cu``; design notes there; ``k1_loop`` is K1's rule); on
CPU tensors it runs its ``*_plain`` twin, the same function in plain
PyTorch.  One launch may cover a whole block-row (TJ = every column from
the diagonal tile on): it is the same function on a wider tile.

Operand layout.  Every operand is an (S, T*5) tensor, either sample-major
(unit column stride, any row stride) or a K-major view,
``k_major(x)[:, :S].T`` (unit row stride: each slab column's samples
contiguous), which is what the tensor-core loop of K1, B3 and B4 reads;
the engine keeps such a copy of its one-hot, and a sample-major operand
is copied into one per call.  The plain versions give the same values
for either layout.

Operand modes (the engine's int8-mode rule picks one,
engine/solver.py:build_device_data):
  * int8, 1 pass: unit weights, exact 0/1 counts;
  * int8, 2 passes x (128, 1): fixed14 weight digits, int32 counts
    scaled by acc_scale = 1/int8_scale;
  * bf16, 1 or 2 passes (hi/lo split of f32 weights), f32 accumulation.
"""

from __future__ import annotations

import functools

import torch

from spydrpick_torch.ops import cuda_build

N_STATES = 5
BW = 128  # slab block width (mi_pallas.BI/BJ)


def to_slab(x: torch.Tensor, bw: int) -> torch.Tensor:
    """Interleaved minor axis (..., n*5) -> slab layout: within each
    bw-wide column block, state t of column c sits at t*bw + c
    (mi_pallas.py:to_slab)."""
    *lead, m = x.shape
    nb = m // (N_STATES * bw)
    if nb * N_STATES * bw != m:
        raise ValueError(f"to_slab: width {m} is not a multiple of 5*{bw}")
    return x.reshape(*lead, nb, bw, N_STATES).transpose(-1, -2).reshape(*lead, m)


def split_bf16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (hi, lo) bf16 pair with hi + lo ~ x (mi_pallas.py:split_bf16);
    eager PyTorch needs no barrier against x - f32(bf16(x)) folding."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.to(torch.float32)).to(torch.bfloat16)
    return hi, lo


def k_major(x: torch.Tensor) -> torch.Tensor:
    """The (n, Sp) K-major copy of an (S, n) operand: row k holds slab
    column k's S samples, then zeros up to Sp, S rounded up to 16 bytes, so
    every row starts 16-byte aligned.  ``k_major(x)[:, :S].T`` is the
    operand again, as a view that K1, B3 and B4 read without a copy."""
    S, n = x.shape
    step = max(1, 16 // x.element_size())
    out = torch.zeros((n, -(-S // step) * step), dtype=x.dtype, device=x.device)
    out[:, :S] = x.T
    return out


def _kernel_operand(x: torch.Tensor, ld: int | None = None) -> torch.Tensor:
    """x as K1, B3 and B4 read it: x itself when it is a K-major view whose row
    stride (``ld`` when given) is a whole number of 16-byte units from an
    aligned start, else a K-major copy."""
    row_bytes = x.stride(1) * x.element_size()
    if (x.stride(0) == 1 and row_bytes % 16 == 0 and x.data_ptr() % 16 == 0
            and (ld is None or x.stride(1) == ld)):
        return x
    if ld is None:
        return k_major(x)[:, :x.shape[0]].T
    out = torch.zeros((x.shape[1], ld), dtype=x.dtype, device=x.device)
    out[:, :x.shape[0]] = x.T
    return out[:, :x.shape[0]].T


@functools.cache
def cpu_log_ready() -> None:
    """One single-threaded ``torch.log`` on the CPU, before any parallel
    one.  On the CPU it runs MKL's vector math, which sets up its kernels
    at first use; a first call made from several OpenMP threads at once
    has returned logs with relative errors up to 1.4e-4 in ranks of a
    gloo run (one block-row's MI, or the tournament's, up to 1.5e-5 low;
    about one process in 60 with 8 threads).  A tensor too small to
    split between threads sets them up first."""
    torch.log(torch.ones(8))


def _ln_pos(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        cpu_log_ready()
    return torch.log(torch.where(x > 0, x, 1.0))


def _sum_states(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum a size-5 state axis in _sum_istates/_sum_jstates order."""
    s = lambda k: x.select(dim, k)
    return ((s(0) + s(1)) + (s(2) + s(3))) + s(4)


def mi_from_block_plain(C: torch.Tensor, ipf: torch.Tensor, jpf: torch.Tensor,
                        pc: float, bw: int) -> torch.Tensor:
    """(TI, TJ) MI from a (TI*5, TJ*5) slab crosstable, op for op with
    mi_pallas.py:_mi_from_block over every bw x bw block at once."""
    TI5, TJ5 = C.shape
    nbi, nbj = TI5 // (N_STATES * bw), TJ5 // (N_STATES * bw)
    C = C.reshape(nbi, N_STATES, bw, nbj, N_STATES, bw)
    ipc = ipf.reshape(nbi, N_STATES, bw, 1, 1, 1)
    jrow = jpf.reshape(1, 1, 1, nbj, N_STATES, bw)
    pm = ipc * jrow
    A = C + pc * pm
    lnA = _ln_pos(A)
    G1 = _sum_states(_sum_states(A * lnA * pm, 1), 3)
    B = _sum_states(A * jrow, 4)                  # (nbi, 5, bw, nbj, bw)
    R = _sum_states(A, 1)                         # (nbi, bw, nbj, 5, bw) full row sums
    lnR = _ln_pos(R)
    RJ = R * jrow.reshape(1, 1, nbj, N_STATES, bw)
    Gi = _sum_states(RJ * lnR, 3)
    Si = _sum_states(RJ, 3)
    ipb = ipc.reshape(nbi, N_STATES, bw, 1, 1)
    Z = _sum_states(B * ipb, 1)                   # (nbi, bw, nbj, bw)
    lnB = _ln_pos(B)
    Gj = _sum_states(B * lnB * ipb, 1)
    invZ = 1.0 / torch.clamp(Z, min=torch.finfo(torch.float32).tiny)
    lnZ = _ln_pos(Z)
    jointH = (G1 - lnZ * Z) * invZ
    icondH = (Gi - lnZ * Si) * invZ
    jcondH = (Gj - lnZ * Z) * invZ                # S_j == Z
    return (jointH - icondH - jcondH).reshape(nbi * bw, nbj * bw)


def _passes(xi_hi, xi_lo, pass_mults):
    xs = (xi_hi,) if xi_lo is None else (xi_hi, xi_lo)
    if len(pass_mults) < len(xs):
        raise ValueError(f"need {len(xs)} pass multipliers, got {pass_mults}")
    return xs, tuple(pass_mults[: len(xs)])


def crosstab_tile_plain(xi_hi, xi_lo, xj, pass_mults: tuple = (1, 1)) -> torch.Tensor:
    """Plain-PyTorch twin of B4: the (TI*5, TJ*5) slab crosstable of the
    kernels' operands, unscaled.  int8 operands: the exact int32 counts
    sum_p mult_p * (Xi_p^T Xj), taken in float64 (exact: counts < 2^53;
    integer matmul does not exist on CUDA).  bf16 operands: f32 products
    of the exact f32 upcasts, summed over the passes.  Operands of either
    layout are made contiguous first, so the products see one layout."""
    xs, mults = _passes(xi_hi, xi_lo, pass_mults)
    xs, xj = tuple(x.contiguous() for x in xs), xj.contiguous()
    f32 = torch.float32
    if xi_hi.dtype == torch.int8:
        xjd = xj.to(torch.float64)
        acc = None
        for m, x in zip(mults, xs):
            d = x.to(torch.float64).T @ xjd
            if m != 1:
                d = d * m
            acc = d if acc is None else acc + d
        return acc.to(torch.int32)
    xjf = xj.to(f32)
    C = None
    for m, x in zip(mults, xs):
        d = x.to(f32).T @ xjf
        if m != 1:
            d = d * torch.tensor(m, dtype=f32)
        C = d if C is None else C + d
    return C


def xtab_to_f32(C: torch.Tensor, acc_scale: float = 1.0) -> torch.Tensor:
    """A crosstable in weight units: int32 counts round to nearest f32,
    then one f32 multiply by f32(acc_scale) — the rounding of K1's
    ``__fmul_rn(__int2float_rn(c), acc_scale)``, so a sample-sharded
    sweep that sums int32 partials and converts after the sum gets K1's
    values bit for bit (solver.py:558-565)."""
    C = C.to(torch.float32)
    if acc_scale != 1.0:
        C = C * torch.tensor(acc_scale, dtype=torch.float32, device=C.device)
    return C


def crosstab_plain(xi_hi, xi_lo, xj, pass_mults: tuple = (1, 1),
                   acc_scale: float = 1.0) -> torch.Tensor:
    """(TI*5, TJ*5) f32 slab crosstable in weight units, as K1 and B3
    feed it to their epilogue."""
    return xtab_to_f32(crosstab_tile_plain(xi_hi, xi_lo, xj, pass_mults), acc_scale)


def mi_epilogue_plain(C, ipf, jpf, ipwf=None, jpwf=None, pseudocount: float = 0.5,
                      bw: int = BW):
    """Plain-PyTorch twin of B5: mi, or (mi, wog) when the wo-gaps
    presence is given, of a (TI*5, TJ*5) f32 slab crosstable."""
    f32 = torch.float32
    mi = mi_from_block_plain(C, ipf.to(f32), jpf.to(f32), pseudocount, bw)
    if ipwf is None:
        return mi
    return mi, mi_from_block_plain(C, ipwf.to(f32), jpwf.to(f32), pseudocount, bw)


def mi_tile_single_plain(xi_hi, xi_lo, xj, ipf, jpf, pseudocount: float = 0.5,
                         bw: int = BW, pass_mults: tuple = (1, 1),
                         acc_scale: float = 1.0) -> torch.Tensor:
    """Plain-PyTorch twin of K1 (the CPU path, and the card-side
    reference)."""
    C = crosstab_plain(xi_hi, xi_lo, xj, pass_mults, acc_scale)
    return mi_epilogue_plain(C, ipf, jpf, pseudocount=pseudocount, bw=bw)


def mi_tile_dual_plain(xi_hi, xi_lo, xj, ipf, jpf, ipwf, jpwf, pseudocount: float = 0.5,
                       bw: int = BW, pass_mults: tuple = (1, 1),
                       acc_scale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch twin of B3: (mi, wog) from one crosstable; mi is
    ``mi_tile_single_plain``'s value bit for bit."""
    C = crosstab_plain(xi_hi, xi_lo, xj, pass_mults, acc_scale)
    return mi_epilogue_plain(C, ipf, jpf, ipwf, jpwf, pseudocount, bw)


def _check_operands(name, xi_hi, xi_lo, xj, presence, bw, pass_mults):
    """Validate the operands of K1, B3 and B4; returns (passes, mults, S,
    TI, TJ).  ``presence``: the (i, j) presence vector pairs the kernel
    reads."""
    xs, mults = _passes(xi_hi, xi_lo, pass_mults)
    S, TI5 = xi_hi.shape
    TJ5 = xj.shape[1]
    TI, TJ = TI5 // N_STATES, TJ5 // N_STATES
    if xi_hi.dtype not in (torch.int8, torch.bfloat16):
        raise ValueError(f"{name}: operand dtype {xi_hi.dtype}")
    for x in xs + (xj,):
        if x.dtype != xi_hi.dtype or x.device != xj.device or x.dim() != 2:
            raise ValueError(f"{name}: operands differ in dtype, device or rank")
        if x.shape[0] != S or not (x.stride(1) == 1 or x.stride(0) == 1):
            raise ValueError(f"{name}: operands need S rows and unit column stride"
                             " or unit row stride")
    if xi_lo is not None and xi_lo.shape != xi_hi.shape:
        raise ValueError(f"{name}: xi_hi and xi_lo need one shape")
    if TI5 != TI * N_STATES or TJ5 != TJ * N_STATES or TI % bw or TJ % bw:
        raise ValueError(f"{name}: tile ({TI}, {TJ}) not in {bw}-column slab blocks")
    for ip, jp in presence:
        for p, n in ((ip, TI5), (jp, TJ5)):
            if (p.dtype != torch.float32 or p.device != xj.device or p.shape != (n,)
                    or not p.is_contiguous()):
                raise ValueError(f"{name}: presence must be contiguous f32 (T*5,)")
    if xi_hi.dtype == torch.int8 and any(m != int(m) for m in mults):
        raise ValueError(f"{name}: int8 passes need integer multipliers {mults}")
    if bw % 32 or (len(xs) == 2 and (
            mults[1] == 0 or (xi_hi.dtype == torch.int8 and int(mults[0]) % int(mults[1])))):
        # the tensor-core loop: 32-column tiles, acc = (m0 / m1) * P0 + P1
        raise ValueError(f"{name}: needs bw % 32 == 0 and, for two int8 passes, "
                         f"m1 dividing m0 (bw {bw}, multipliers {mults})")
    return xs, mults, S, TI, TJ


def _kernel_operands(xs, xj):
    """(xi_hi, xi_lo, xj) as K1, B3 and B4 read them (``_kernel_operand``):
    both i passes with one row stride."""
    hi = _kernel_operand(xs[0])
    lo = _kernel_operand(xs[-1], hi.stride(1))
    return hi, lo, _kernel_operand(xj)


K1_LOOPS = ("mma_sync", "wgmma")


def k1_loop(dtype: torch.dtype, S: int) -> str:
    """K1's main loop on the card for operands of ``dtype`` with S samples
    (``csrc/xtab_mma.cu:k1_loop``, the same rule): "wgmma" (TMA-fed
    warpgroup MMAs, ``csrc/xtab_wgmma.cuh``) for int8 operands with at
    least one sample, whatever the tile (every tile the wrapper takes is
    in 32-column slab runs, which the wgmma loop's boxes need), else
    "mma_sync" (bf16, and S = 0, for which no TMA map exists)."""
    return "wgmma" if dtype == torch.int8 and S > 0 else "mma_sync"


def mi_tile_single(xi_hi, xi_lo, xj, ipf, jpf, pseudocount: float = 0.5,
                   bw: int = BW, pass_mults: tuple = (1, 1),
                   acc_scale: float = 1.0, *, loop: str | None = None) -> torch.Tensor:
    """(TI, TJ) f32 MI of a tile (see module docstring).  Operands are
    (S, TI*5) / (S, TJ*5) slab one-hots with unit column stride (row
    strides may exceed the width: column slices of the alignment's
    one-hot pass without a copy); ipf/jpf are (TI*5,)/(TJ*5,) slab
    presence.  ``xi_lo=None`` selects the single-pass mode.  Operands may
    also be K-major views (module docstring); two int8 passes need m1 to
    divide m0 on the card.  ``loop`` picks the card's main loop (one of
    ``K1_LOOPS``; by default ``k1_loop``'s); both give the same bits."""
    if xj.device.type == "cpu":
        return mi_tile_single_plain(xi_hi, xi_lo, xj, ipf, jpf, pseudocount,
                                    bw, pass_mults, acc_scale)
    if not xj.is_cuda:
        raise ValueError(f"mi_tile_single: unsupported device {xj.device}")
    xs, mults, S, TI, TJ = _check_operands("mi_tile_single", xi_hi, xi_lo, xj,
                                           ((ipf, jpf),), bw, pass_mults)
    out = torch.empty((TI, TJ), dtype=torch.float32, device=xj.device)
    if out.numel() == 0:
        return out
    loop = k1_loop(xi_hi.dtype, S) if loop is None else loop
    if loop not in K1_LOOPS or (loop == "wgmma" and k1_loop(xi_hi.dtype, S) != loop):
        raise ValueError(f"mi_tile_single: loop {loop!r} for {xi_hi.dtype} operands, S={S}")
    hi, lo, xk = _kernel_operands(xs, xj)
    lib = cuda_build.load()
    stream = torch.cuda.current_stream(xj.device).cuda_stream
    rc = lib.spk_mi_tile_single_loop(
        K1_LOOPS.index(loop), 0 if xi_hi.dtype == torch.int8 else 1,
        hi.data_ptr(), lo.data_ptr(), xk.data_ptr(),
        hi.stride(1), xk.stride(1), ipf.data_ptr(), jpf.data_ptr(),
        out.data_ptr(), out.stride(0), S, TI, TJ, bw, bw, len(xs),
        float(mults[0]), float(mults[-1]), float(acc_scale), float(pseudocount),
        stream)
    cuda_build.check(rc, "mi_tile_single")
    mi_tile_single.launches += 1
    mi_tile_single.launches_wgmma += loop == "wgmma"
    return out


mi_tile_single.launches = 0  # kernel launches (CPU calls do not count)
mi_tile_single.launches_wgmma = 0  # of them, those on the wgmma loop


def mi_tile_dual(xi_hi, xi_lo, xj, ipf, jpf, ipwf, jpwf, pseudocount: float = 0.5,
                 bw: int = BW, pass_mults: tuple = (1, 1),
                 acc_scale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """(mi, wog), each (TI, TJ) f32, of a tile: ``mi_tile_single``'s
    operands (either layout) plus ipwf/jpwf, the slab presence with the gap
    bit cleared.  mi equals ``mi_tile_single``'s bit for bit (one main loop,
    conversion and epilogue on the card).  Unit weights may run one
    int8 pass (``xi_lo=None``): the reference's dual path gives them a
    bf16 hi/lo split with lo = 0, which yields the same exact counts."""
    if xj.device.type == "cpu":
        return mi_tile_dual_plain(xi_hi, xi_lo, xj, ipf, jpf, ipwf, jpwf, pseudocount,
                                  bw, pass_mults, acc_scale)
    if not xj.is_cuda:
        raise ValueError(f"mi_tile_dual: unsupported device {xj.device}")
    xs, mults, S, TI, TJ = _check_operands("mi_tile_dual", xi_hi, xi_lo, xj,
                                           ((ipf, jpf), (ipwf, jpwf)), bw, pass_mults)
    out = torch.empty((TI, TJ), dtype=torch.float32, device=xj.device)
    out_wog = torch.empty_like(out)
    if out.numel() == 0:
        return out, out_wog
    hi, lo, xk = _kernel_operands(xs, xj)
    lib = cuda_build.load()
    stream = torch.cuda.current_stream(xj.device).cuda_stream
    rc = lib.spk_mi_tile_dual(
        0 if xi_hi.dtype == torch.int8 else 1,
        hi.data_ptr(), lo.data_ptr(), xk.data_ptr(),
        hi.stride(1), xk.stride(1), ipf.data_ptr(), jpf.data_ptr(),
        ipwf.data_ptr(), jpwf.data_ptr(), out.data_ptr(), out_wog.data_ptr(),
        out.stride(0), S, TI, TJ, bw, bw, len(xs),
        float(mults[0]), float(mults[-1]), float(acc_scale), float(pseudocount),
        stream)
    cuda_build.check(rc, "mi_tile_dual")
    mi_tile_dual.launches += 1
    return out, out_wog


mi_tile_dual.launches = 0  # kernel launches (CPU calls do not count)


def crosstab_tile(xi_hi, xi_lo, xj, bw: int = BW, pass_mults: tuple = (1, 1)) -> torch.Tensor:
    """B4: the (TI*5, TJ*5) slab crosstable of K1's operands, unscaled:
    int32 counts for int8 operands (exact, so partial tables of sample
    shards sum exactly), f32 sums for bf16 operands.  Same operand rules
    as ``mi_tile_single``."""
    if xj.device.type == "cpu":
        return crosstab_tile_plain(xi_hi, xi_lo, xj, pass_mults)
    if not xj.is_cuda:
        raise ValueError(f"crosstab_tile: unsupported device {xj.device}")
    xs, mults, S, TI, TJ = _check_operands("crosstab_tile", xi_hi, xi_lo, xj, (), bw,
                                           pass_mults)
    int8 = xi_hi.dtype == torch.int8
    out = torch.empty((TI * N_STATES, TJ * N_STATES),
                      dtype=torch.int32 if int8 else torch.float32, device=xj.device)
    if out.numel() == 0:
        return out
    hi, lo, xk = _kernel_operands(xs, xj)
    lib = cuda_build.load()
    rc = lib.spk_crosstab_tile(
        0 if int8 else 1, hi.data_ptr(), lo.data_ptr(), xk.data_ptr(),
        hi.stride(1), xk.stride(1), out.data_ptr(), out.stride(0), S, TI, TJ, bw, bw,
        len(xs), float(mults[0]), float(mults[-1]),
        torch.cuda.current_stream(xj.device).cuda_stream)
    cuda_build.check(rc, "crosstab_tile")
    crosstab_tile.launches += 1
    return out


crosstab_tile.launches = 0  # kernel launches (CPU calls do not count)


def mi_epilogue(C, ipf, jpf, ipwf=None, jpwf=None, pseudocount: float = 0.5, bw: int = BW):
    """B5: mi, or (mi, wog) when the wo-gaps slab presence ipwf/jpwf is
    given, each (TI, TJ) f32, of a (TI*5, TJ*5) f32 slab crosstable in
    weight units (unit column stride).  On the same crosstable it equals
    K1's mi and B3's wog bit for bit."""
    if C.device.type == "cpu":
        return mi_epilogue_plain(C, ipf, jpf, ipwf, jpwf, pseudocount, bw)
    if not C.is_cuda:
        raise ValueError(f"mi_epilogue: unsupported device {C.device}")
    TI5, TJ5 = C.shape
    TI, TJ = TI5 // N_STATES, TJ5 // N_STATES
    if C.dtype != torch.float32 or C.dim() != 2 or C.stride(1) != 1:
        raise ValueError("mi_epilogue: C must be 2-D f32 with unit column stride")
    if TI5 != TI * N_STATES or TJ5 != TJ * N_STATES or TI % bw or TJ % bw:
        raise ValueError(f"mi_epilogue: tile ({TI}, {TJ}) not in {bw}-column slab blocks")
    dual = ipwf is not None
    for p, n in ((ipf, TI5), (jpf, TJ5)) + (((ipwf, TI5), (jpwf, TJ5)) if dual else ()):
        if (p.dtype != torch.float32 or p.device != C.device or p.shape != (n,)
                or not p.is_contiguous()):
            raise ValueError("mi_epilogue: presence must be contiguous f32 (T*5,)")
    out = torch.empty((TI, TJ), dtype=torch.float32, device=C.device)
    out_wog = torch.empty_like(out) if dual else None
    if out.numel() == 0:
        return (out, out_wog) if dual else out
    lib = cuda_build.load()
    rc = lib.spk_mi_epilogue(
        C.data_ptr(), C.stride(0), ipf.data_ptr(), jpf.data_ptr(),
        ipwf.data_ptr() if dual else None, jpwf.data_ptr() if dual else None,
        out.data_ptr(), out_wog.data_ptr() if dual else None, out.stride(0), TI, TJ, bw, bw,
        float(pseudocount), torch.cuda.current_stream(C.device).cuda_stream)
    cuda_build.check(rc, "mi_epilogue")
    mi_epilogue.launches += 1
    return (out, out_wog) if dual else out


mi_epilogue.launches = 0  # kernel launches (CPU calls do not count)
