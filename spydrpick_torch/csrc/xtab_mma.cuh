// The tensor-core main loop shared by kernels K1, B3 and B4 (xtab_mma.cu): one
// thread block's tile of the slab crosstable
// C = sum_passes mult_p * (Xi_p^T Xj) over the samples, in registers.
//
// Tile.  A block takes TC = 32 i-columns and 32 j-columns, each run inside
// one slab block (slab widths bw_i, bw_j multiples of 32), so its
// crosstable tile is 5 state bands of 32 rows by 5 bands of 32 columns: a 160 x 160 product
// over the samples, every band a whole number of MMA tiles.  Row r of the
// tile is state r / 32 of column c0 + r % 32, which in the slab layout is
// row slab_row(c0, bw, r) of the K-major operand.  Eight warps split it
// 2 (rows) x 4 (columns); a warp holds 80 x 40 accumulators, 5 x 5 MMA
// tiles of 16 x 8.
//
// Operands are K-major: row k of an operand holds one slab column's
// samples, contiguous, with a row stride (ld, elements) whose bytes are a
// multiple of 16 (ops/mi_kernels.py:k_major builds them; the engine keeps
// a K-major copy of its one-hot).  Int8 mma.sync wants both operands
// K-major and ldmatrix transposes only 16-bit elements, so the layout is
// fixed once in device memory rather than byte by byte while staging.
//
// Instructions.  int8: mma.sync m16n8k32 s8 x s8 -> s32 (exact integer
// counts); bf16: mma.sync m16n8k16 bf16 x bf16 -> f32.  One k-step is 32
// bytes of samples for both, so the fragments have one layout: ldmatrix
// x4 (A, 16 rows x 32 bytes) and x4/x2 (B, 8 rows x 32 bytes per tile).
//
// Staging.  A ring of STAGES = 3 shared-memory stages, each 128 bytes of
// samples of the block's 160 i-rows and 160 j-rows, filled with 16-byte
// cp.async copies: the copy of chunk k + 2 is in flight while the warps
// run the MMAs on chunk k.  A row's tail past S is zero-filled by the copy
// itself (src-size), so nothing is read past a row's S samples and S needs
// no padding.  Thread t copies 16-byte chunk t % 8 of column t / 8's row of
// each state on both sides: the rows of one column are bw rows apart in the
// operand, so a thread keeps two row pointers and two strides, not one
// pointer per copy (that freed the registers a 128-byte stage needs: with
// a pointer per copy ptxas hit 255 registers and spilled), and a warp reads
// whole 128-byte lines.  Rows are staged 144 bytes apart, which makes every
// 8-row ldmatrix conflict-free.
//
// Passes.  Two-pass operands (fixed14 digits, bf16 hi/lo) run the whole
// sample loop once per pass against the same j rows, into one accumulator
// set: acc = q * P_hi, then + P_lo, with q = m0 / m1; the caller multiplies
// by m1.  For int8 that is m0 * P_hi + m1 * P_lo exactly (S * 16383 < 2^31
// by the int8-mode rule).  One accumulator set is 100 registers per thread
// (ptxas gives the kernels 178-192 in all, one 256-thread block per SM);
// the second pass re-reads the j rows from L2.
#pragma once

#include "common.cuh"

#include <cuda_bf16.h>

namespace spk_mma {

constexpr int TC = 32;                    // i and j columns per block
constexpr int ROWS = SPK_NS * TC;         // 160 tile rows (and columns)
constexpr int KC = 128;                   // sample bytes per stage and row
constexpr int PITCH = KC + 16;            // bytes between staged rows
constexpr int STAGES = 3;
constexpr int NT = 256;                   // threads: 8 warps
constexpr int WN = 4;                     // warps along the tile's columns
constexpr int WROWS = ROWS / (NT / 32 / WN);  // 80 rows per warp
constexpr int WCOLS = ROWS / WN;              // 40 columns per warp
constexpr int MI = WROWS / 16;            // 5 m16 tiles per warp
constexpr int NI = WCOLS / 8;             // 5 n8 tiles per warp
constexpr int STAGE_BYTES = 2 * ROWS * PITCH;
constexpr int CPITCH = ROWS + 8;          // 32-bit words between rows of the tile in smem
constexpr int TILE_BYTES = ROWS * CPITCH * 4;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES > TILE_BYTES ? STAGES * STAGE_BYTES : TILE_BYTES;
static_assert(NT == TC * (KC / 16) && MI * 16 == WROWS && NI * 8 == WCOLS, "tile shape");

template <typename T>
struct Mma;

template <>
struct Mma<int8_t> {
    using Acc = int;
    static __device__ __forceinline__ void run(int (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
            "{%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
    static __device__ __forceinline__ int scale(int x, int m) { return x * m; }
};

template <>
struct Mma<__nv_bfloat16> {
    using Acc = float;
    static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
            "{%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
    static __device__ __forceinline__ float scale(float x, float m) {
        return m == 1.f ? x : __fmul_rn(x, m);
    }
};

// Row r of the tile whose columns start at c0: state r / TC of column
// c0 + r % TC, as a slab row (= a row of the K-major operand).
__device__ __forceinline__ long long slab_row(int c0, int bw, int r) {
    return spk_slab_col(c0 + r % TC, bw, r / TC);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3, uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
                 : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1, uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r0), "=r"(r1)
                 : "r"(addr));
}

// Issue this thread's copies of sample chunk kt into the stage at dst: from
// the rows gi + t * istep (i side) and gj + t * jstep (j side), state t,
// the 16 bytes at off = kt * KC + cbyte; the bytes of a row past its S
// samples are zero-filled.
__device__ __forceinline__ void load_stage(uint32_t dst, const char* gi, const char* gj,
                                           long long istep, long long jstep, int cbyte,
                                           long long sbytes, int kt) {
    const long long off = (long long)kt * KC + cbyte;
    const long long left = sbytes - off;
    const int nb = left <= 0 ? 0 : (left >= 16 ? 16 : (int)left);
    const long long src = nb ? off : 0;
#pragma unroll
    for (int t = 0; t < SPK_NS; ++t) {
        cp_async16(dst + t * TC * PITCH, gi + t * istep + src, nb);
        cp_async16(dst + (ROWS + t * TC) * PITCH, gj + t * jstep + src, nb);
    }
}

// The block's (i0, j0) tile of the crosstable into acc (see the note at
// the top).  xi_lo is read only when n_passes == 2; q = m0 / m1 then.
// Every thread of the block must call it; it ends with the shared memory
// free for the caller's epilogue.
template <typename T>
__device__ __forceinline__ void crosstab_tile(typename Mma<T>::Acc (&acc)[MI][NI][4],
                                              const T* __restrict__ xi_hi,
                                              const T* __restrict__ xi_lo,
                                              const T* __restrict__ xj, long long ldi,
                                              long long ldj, int S, int bw_i, int bw_j,
                                              int i0, int j0,
                                              int n_passes, typename Mma<T>::Acc q,
                                              unsigned char* smem) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wr = (warp / WN) * WROWS, wc = (warp % WN) * WCOLS;
    const long long sbytes = (long long)S * (long long)sizeof(T);
    const int nk = (int)((sbytes + KC - 1) / KC);
    const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem);

#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

    // this thread's copies (load_stage): chunk ch of column rr's rows
    const int ch = tid % (KC / 16), rr = tid / (KC / 16);
    const long long esz = sizeof(T);
    const long long istep = (long long)bw_i * ldi * esz, jstep = (long long)bw_j * ldj * esz;
    const char* gj = (const char*)xj + slab_row(j0, bw_j, rr) * ldj * esz;
    const long long ioff = slab_row(i0, bw_i, rr) * ldi * esz;
    const uint32_t sdst = sbase + rr * PITCH + ch * 16;

    for (int p = 0; p < n_passes; ++p) {
        const char* gi = (const char*)(p == 0 ? xi_hi : xi_lo) + ioff;

#pragma unroll
        for (int s = 0; s < STAGES - 1; ++s) {
            if (s < nk) load_stage(sdst + s * STAGE_BYTES, gi, gj, istep, jstep, ch * 16, sbytes, s);
            cp_async_commit();
        }
        for (int kt = 0; kt < nk; ++kt) {
            cp_async_wait<STAGES - 2>();
            __syncthreads();  // chunk kt landed for every thread; slot kt-1 is free
            const int nxt = kt + STAGES - 1;
            if (nxt < nk)
                load_stage(sdst + (nxt % STAGES) * STAGE_BYTES, gi, gj, istep, jstep, ch * 16,
                           sbytes, nxt);
            cp_async_commit();
            const uint32_t sa = sbase + (kt % STAGES) * STAGE_BYTES;
            const uint32_t sb = sa + ROWS * PITCH;
#pragma unroll
            for (int ks = 0; ks < KC / 32; ++ks) {
                uint32_t b[NI][2];
                // x4: n-tiles ni and ni+1, bytes 0-15 and 16-31 of the k-step
#pragma unroll
                for (int ni = 0; ni + 1 < NI; ni += 2) {
                    const int row = wc + ni * 8 + ((lane >> 4) << 3) + (lane & 7);
                    ldmatrix_x4(b[ni][0], b[ni][1], b[ni + 1][0], b[ni + 1][1],
                                sb + row * PITCH + ks * 32 + ((lane >> 3) & 1) * 16);
                }
                if (NI & 1) {
                    const int row = wc + (NI - 1) * 8 + (lane & 7);
                    ldmatrix_x2(b[NI - 1][0], b[NI - 1][1],
                                sb + row * PITCH + ks * 32 + ((lane >> 3) & 1) * 16);
                }
#pragma unroll
                for (int mi = 0; mi < MI; ++mi) {
                    uint32_t a[4];
                    const int row = wr + mi * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
                    ldmatrix_x4(a[0], a[1], a[2], a[3],
                                sa + row * PITCH + ks * 32 + (lane >> 4) * 16);
#pragma unroll
                    for (int ni = 0; ni < NI; ++ni) Mma<T>::run(acc[mi][ni], a, b[ni]);
                }
            }
        }
        cp_async_wait<0>();
        __syncthreads();  // every warp is done with the ring
        if (p == 0 && n_passes == 2) {
#pragma unroll
            for (int mi = 0; mi < MI; ++mi)
#pragma unroll
                for (int ni = 0; ni < NI; ++ni)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[mi][ni][e] = Mma<T>::scale(acc[mi][ni][e], q);
        }
    }
}

// Write the accumulators, each through conv (a 32-bit result), into the
// (ROWS, CPITCH) word tile cs in shared memory; the caller synchronises
// before reading it.
template <typename T, typename Conv>
__device__ __forceinline__ void store_tile(const typename Mma<T>::Acc (&acc)[MI][NI][4],
                                           uint32_t* cs, Conv conv) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wr = (warp / WN) * WROWS, wc = (warp % WN) * WCOLS;
    const int g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
            uint32_t* p = cs + (wr + mi * 16 + g) * CPITCH + wc + ni * 8 + c2;
            *reinterpret_cast<uint2*>(p) = make_uint2(conv(acc[mi][ni][0]), conv(acc[mi][ni][1]));
            *reinterpret_cast<uint2*>(p + 8 * CPITCH) =
                make_uint2(conv(acc[mi][ni][2]), conv(acc[mi][ni][3]));
        }
}

}  // namespace spk_mma
