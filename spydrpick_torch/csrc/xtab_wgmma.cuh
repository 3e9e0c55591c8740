// K1's int8 main loop on Hopper's warpgroup tensor-core path (xtab_mma.cu:
// mi_tile_mma_kernel<int8_t, Wgmma>): one thread block's tile of the slab
// crosstable C = sum_passes mult_p * (Xi_p^T Xj) over the samples, left in
// the accumulator registers of the threads that run the pairs' epilogue.
//
// Tile.  A block takes TI_W = 64 i-columns and TJ_W = 32 j-columns.  Each of
// its two consumer warpgroups takes all 64 i-columns and 16 of the
// j-columns: per 32-byte k-step five wgmma.mma_async m64n80k32 s8 x s8 ->
// s32, one per i-state t, whose A is state t of the 64 i-columns (64 slab
// rows) and whose B is the warpgroup's 80 j rows ordered state-major (5
// states x 16 columns).  In the accumulator layout of m64nN a thread holds
// rows r and r + 8 and the column pairs 2(lane%4) + {0, 1} of every
// 8-column chunk, so thread (warp w, lane l) of a warpgroup holds all 25
// cells of 8 whole pairs: i-columns 16w + l/4 + {0, 8} x j-columns
// 2(l%4) + {0, 1, 8, 9}, acc[t][(2u + jq) * 4 + 2 ri + e] for i-column ri,
// j-column 8 jq + e, states (t, u).  200 int32 accumulators a thread.
//
// Staging.  Operands are K-major (row k: one slab column's S samples,
// contiguous, row stride ld bytes, a multiple of 16), the layout int8
// wgmma requires for both operands.  A 2-D TMA tensor map per operand has
// an inner dimension of exactly S bytes and one row per slab row, so the
// copy engine zero-fills the bytes past S and the rows past the operand:
// S needs no padding and a ragged i tile (TI % 64 == 32) reads zeros.  A
// stage is 128 sample bytes of the block's 320 i rows and 160 j rows
// (60 KB), 128-byte swizzled; one producer thread fills it with 20 boxes:
// per i-state two of 32 rows (32 columns lie in one slab block when the
// slab width is a multiple of 32) and per warpgroup and j-state one of 16
// rows, each landing 1024-byte aligned so that the whole stage is one
// swizzled K-major layout for the wgmma descriptors (stride 1024 bytes per
// 8 rows; the k-step advances the start address by 32 bytes).  A ring of
// STAGES = 3 stages with full/empty mbarriers: the producer waits for a
// slot's consumers, the consumers for its bytes.
//
// Roles.  384 threads: warpgroups 0 and 1 run wgmma (setmaxnreg up to 232
// registers: 200 accumulators and the loop's own), warpgroup 2 is the
// producer (down to 40), of which one thread issues the copies.  A
// consumer commits each stage's 20 wgmmas as one group, waits until at
// most that group is in flight and frees the stage before it.  The waits
// spin on mbarrier.try_wait alone: a clock-bounded spin with a trap made
// ptxas serialise the wgmmas and spill 80 accumulators.
//
// A/B at S=3072, 512 x 30720 (H100 80GB HBM3, 700 W): the loop alone runs
// at 86% of the int8 peak in fixed14, 81% in unit; a block of one consumer
// warpgroup (64 x 16 pairs, two blocks an SM, the i rows staged twice as
// often) ran 24% slower in fixed14; the epilogue's layout is xtab_mma.cu's.
//
// Passes.  As the mma.sync loop: fixed14's two digits run the sample loop
// twice into one accumulator set, acc = q * P_hi, then + P_lo, exact since
// S * 16383 < 2^31; the producer streams the second pass's stages while
// the consumers scale.
#pragma once

#include "common.cuh"

#include <cuda.h>

namespace spk_wgmma {

constexpr int TI_W = 64;                         // i-columns per block
constexpr int TJ_W = 32;                         // j-columns per block
constexpr int JW = 16;                           // j-columns per consumer warpgroup
constexpr int N = SPK_NS * JW;                   // 80: the wgmma's n
constexpr int NACC = N / 2;                      // 40 accumulators per m64n80 a thread
constexpr int KC = 128;                          // sample bytes per stage and row
constexpr int STAGES = 3;
constexpr int I_BOX = 32;                        // rows of an i-side box
constexpr int A_BYTES = SPK_NS * TI_W * KC;      // 40960
constexpr int B_BYTES = SPK_NS * TJ_W * KC;      // 20480
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;   // 61440, a multiple of 1024
constexpr int CONSUMERS = 256;                   // two consumer warpgroups
constexpr int NT = CONSUMERS + 128;              // and a producer warpgroup
constexpr int CELLS = SPK_NS * NACC;             // 200 crosstable cells a consumer thread
constexpr int STASH_BYTES = CELLS * CONSUMERS * 4;  // 204800: every cell, as f32
// the ring, which holds the stash once the loop is done
constexpr int RING_BYTES = STAGES * STAGE_BYTES > STASH_BYTES ? STAGES * STAGE_BYTES : STASH_BYTES;
constexpr int SMEM_BYTES = RING_BYTES + 1024 + 2 * STAGES * 8;  // + alignment, mbarriers
static_assert(STAGE_BYTES % 1024 == 0 && (JW * KC) % 1024 == 0 && (I_BOX * KC) % 1024 == 0,
              "every box lands 1024-byte aligned");

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    return done != 0;
}

// Wait until the barrier's phase of this parity has completed.  (A spin
// with a clock-based trap here makes ptxas serialize the consumers' wgmmas
// and spill their accumulators.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    while (!mbar_try_wait(bar, parity)) {
    }
}

// Box (k0, row) of the 2-D map into the shared memory at dst; completion
// counts its bytes on the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int k0, int row) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
        "l"((uint64_t)map), "r"(bar), "r"(k0), "r"(row)
        : "memory");
}

// A K-major operand in 128-byte swizzled rows starting at addr: 8-row
// groups 1024 bytes apart.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
           ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N_PENDING>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N_PENDING) : "memory");
}

// Keep the compiler from moving accesses of the accumulators across the
// asynchronous wgmmas.
__device__ __forceinline__ void acc_fence(int (&d)[SPK_NS][NACC]) {
#pragma unroll
    for (int t = 0; t < SPK_NS; ++t)
#pragma unroll
        for (int e = 0; e < NACC; ++e) asm volatile("" : "+r"(d[t][e])::"memory");
}

// d += A (64 x 32 bytes at da) * B^T (80 x 32 bytes at db), s8 x s8 -> s32.
__device__ __forceinline__ void wgmma_m64n80k32(int (&d)[NACC], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
        "%35, %36, %37, %38, %39}, %40, %41, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
          "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
          "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
          "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
          "+r"(d[37]), "+r"(d[38]), "+r"(d[39])
        : "l"(da), "l"(db), "n"(1));
}

// The shared memory of a block: the 1024-aligned ring (later the stash of
// the crosstable), then the full and empty barriers of each stage.
struct Ring {
    uint32_t base, full, empty;
    __device__ __forceinline__ explicit Ring(unsigned char* smem) {
        base = ((uint32_t)__cvta_generic_to_shared(smem) + 1023) & ~1023u;
        full = base + RING_BYTES;
        empty = full + STAGES * 8;
    }
    __device__ __forceinline__ void init() const {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, CONSUMERS / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
};

// The producer thread: every stage of every pass, in order.  Box rows: the
// i-side box of state t and half h starts at slab row ri_h + t * bw_i,
// the j-side box of warpgroup w and state u at rj + 16 w + u * bw_j (the
// block's 32 j-columns lie in one slab block).
__device__ __forceinline__ void produce(const Ring& ring, const CUtensorMap* tm_hi,
                                       const CUtensorMap* tm_lo, const CUtensorMap* tm_j,
                                       int nk, int n_passes, int i0, int j0, int bw_i,
                                       int bw_j) {
    const int ri0 = (int)spk_slab_col(i0, bw_i, 0), ri1 = (int)spk_slab_col(i0 + I_BOX, bw_i, 0);
    const int rj = (int)spk_slab_col(j0, bw_j, 0);
    int it = 0;
    for (int p = 0; p < n_passes; ++p) {
        const CUtensorMap* tm_i = p == 0 ? tm_hi : tm_lo;
        for (int kt = 0; kt < nk; ++kt, ++it) {
            const int s = it % STAGES;
            if (it >= STAGES) mbar_wait(ring.empty + 8 * s, ((it / STAGES) - 1) & 1);
            const uint32_t full = ring.full + 8 * s;
            mbar_expect_tx(full, STAGE_BYTES);
            const uint32_t a = ring.base + s * STAGE_BYTES, b = a + A_BYTES;
            const int k0 = kt * KC;
#pragma unroll
            for (int t = 0; t < SPK_NS; ++t) {
                tma_load(a + (t * TI_W) * KC, tm_i, full, k0, ri0 + t * bw_i);
                tma_load(a + (t * TI_W + I_BOX) * KC, tm_i, full, k0, ri1 + t * bw_i);
                tma_load(b + (t * JW) * KC, tm_j, full, k0, rj + t * bw_j);
                tma_load(b + (N + t * JW) * KC, tm_j, full, k0, rj + JW + t * bw_j);
            }
        }
    }
}

// A consumer warpgroup (wg 0 or 1): its 64 x 80 share of the block's
// crosstable over every stage of every pass into acc.  q = m0 / m1 when
// n_passes == 2.
__device__ __forceinline__ void consume(int (&acc)[SPK_NS][NACC], const Ring& ring, int wg,
                                        int nk, int n_passes, int q) {
    const bool lead = (threadIdx.x & 31) == 0;
#pragma unroll
    for (int t = 0; t < SPK_NS; ++t)
#pragma unroll
        for (int e = 0; e < NACC; ++e) acc[t][e] = 0;
    int it = 0;
    for (int p = 0; p < n_passes; ++p) {
        for (int kt = 0; kt < nk; ++kt, ++it) {
            const int s = it % STAGES;
            mbar_wait(ring.full + 8 * s, (it / STAGES) & 1);
            // descriptors advance in 16-byte units: 2 a k-step, 512 an i-state
            const uint64_t da = smem_desc(ring.base + s * STAGE_BYTES);
            const uint64_t db = da + ((A_BYTES + wg * N * KC) >> 4);
            acc_fence(acc);
            wgmma_fence();
#pragma unroll
            for (int ks = 0; ks < KC / 32; ++ks)
#pragma unroll
                for (int t = 0; t < SPK_NS; ++t)
                    wgmma_m64n80k32(acc[t], da + ((t * TI_W * KC + ks * 32) >> 4),
                                    db + ((ks * 32) >> 4));
            wgmma_commit();
            wgmma_wait<1>();  // the stage before this one is read
            acc_fence(acc);
            if (kt > 0 && lead) mbar_arrive(ring.empty + 8 * ((it - 1) % STAGES));
        }
        wgmma_wait<0>();
        acc_fence(acc);
        if (lead) mbar_arrive(ring.empty + 8 * ((it - 1) % STAGES));
        if (p == 0 && n_passes == 2) {
#pragma unroll
            for (int t = 0; t < SPK_NS; ++t)
#pragma unroll
                for (int e = 0; e < NACC; ++e) acc[t][e] *= q;
        }
    }
}

}  // namespace spk_wgmma
