// Kernel B3: (mi, wo-gaps mi) of every column pair of a (TI, TJ) tile
// from one crosstable.
//
// B3 replaces spydrpick_tpu/ops/mi_pallas.py:mi_tile_pallas (body
// _kernel).  Operands: slab-layout one-hots (S, TI*5) and (S, TJ*5), either
// int8 (1 pass, or 2 fixed-point digit passes recombined in int32 by
// pass_mults) or bf16 (1 or 2 hi/lo passes accumulated in f32), slab
// presence vectors, and the fused entropy epilogue of _mi_from_block
// (mi_pallas.py:88-121) op for op, run twice on the same registers: with
// the presence (mi) and with the presence whose gap bit is cleared (wog).
// DUAL is true in every instance; the parameter stays so that B3's body is
// the one measured before K1 moved to the tensor cores (xtab_mma.cu).  In
// the int8 modes its mi equals K1's bit for bit (the same integer counts,
// conversion and epilogue).
//
// What bounds it on the H100: the crosstable is 25 * n_passes dot
// products over S samples per column pair — integer multiply-adds.
// This design keeps one pair's whole 5x5 (x n_passes) crosstable
// in one thread's registers and runs __dp4a (4 int8 products per
// instruction) over samples staged in shared memory, so it is bound by
// the SM's integer pipe and by shared-memory loads (15 loads per 50
// dp4a at 2 passes), not by the tensor cores.  Blocks of 16x16 pairs
// are ordered i-fastest so the j operand of a launch streams from
// device memory about once while the i operand stays in L2.  Moving it
// onto K1's tensor-core main loop is later work (ROADMAP B3).  The second
// epilogue raises the registers per thread (int8 2 passes: 107), so 2
// blocks fit on an SM.

#include "mi_epilogue.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int BLK = 16;    // i and j columns per thread block: one pair per thread
constexpr int KW_I8 = 16;  // shared words per chunk on the int8 path (4 samples each)
constexpr int KS_BF = 16;  // samples per chunk on the bf16 path

// mi of pair (i, j) from its crosstable, and for B3 also wog from the
// same crosstable with the wo-gaps presence ipwf/jpwf into out_wog, which
// shares out's row stride (mi_pallas.py:138-140).  The kernels take these
// as separate parameters: bundled into one struct parameter, they changed
// K1's generated code, which then ran 20% slower at the main path's shape
// on an H100.
template <bool DUAL>
__device__ __forceinline__ void store_pair(const float (&C)[SPK_NS][SPK_NS], int i, int j,
    const float* __restrict__ ipf, const float* __restrict__ jpf, const float* __restrict__ ipwf,
    const float* __restrict__ jpwf, float* __restrict__ out, float* __restrict__ out_wog,
    long long ldo, int bw_i, int bw_j, float pc) {
    float ip[SPK_NS], jp[SPK_NS];
    load_presence(ipf, i, bw_i, ip);
    load_presence(jpf, j, bw_j, jp);
    out[(long long)i * ldo + j] = mi_epilogue(C, ip, jp, pc);
    if constexpr (DUAL) {
        load_presence(ipwf, i, bw_i, ip);
        load_presence(jpwf, j, bw_j, jp);
        out_wog[(long long)i * ldo + j] = mi_epilogue(C, ip, jp, pc);
    }
}

template <int NP, bool DUAL>
__global__ void __launch_bounds__(BLK * BLK)
mi_tile_i8_kernel(const int8_t* __restrict__ xi_hi, const int8_t* __restrict__ xi_lo,
                  const int8_t* __restrict__ xj, long long ldi, long long ldj,
                  const float* __restrict__ ipf, const float* __restrict__ jpf,
                  const float* __restrict__ ipwf, const float* __restrict__ jpwf,
                  float* __restrict__ out, float* __restrict__ out_wog, long long ldo, int S,
                  int TI, int TJ, int bw_i, int bw_j, int nbi, int m0, int m1, float acc_scale,
                  float pc) {
    // word w of column (t, c) packs samples s0+4w .. s0+4w+3, one byte each
    __shared__ int sI[NP][SPK_NS][BLK][KW_I8 + 1];
    __shared__ int sJ[SPK_NS][BLK][KW_I8 + 1];
    const int tx = threadIdx.x, ty = threadIdx.y;  // tx -> j column, ty -> i column
    const int tid = ty * BLK + tx;
    const int i0 = (blockIdx.x % nbi) * BLK, j0 = (blockIdx.x / nbi) * BLK;

    int acc[NP][SPK_NS][SPK_NS];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int t = 0; t < SPK_NS; ++t)
#pragma unroll
            for (int u = 0; u < SPK_NS; ++u) acc[p][t][u] = 0;

    for (int s0 = 0; s0 < S; s0 += 4 * KW_I8) {
        // column index fastest across threads: neighbours read neighbouring bytes
        for (int job = tid; job < (NP + 1) * SPK_NS * BLK * KW_I8; job += BLK * BLK) {
            const int c = job % BLK;
            int r = job / BLK;
            const int t = r % SPK_NS;
            r /= SPK_NS;
            const int w = r % KW_I8;
            const int p = r / KW_I8;  // 0..NP-1: i passes, NP: the j operand
            const bool is_j = p == NP;
            const int col = (is_j ? j0 : i0) + c;
            int word = 0;
            if (col < (is_j ? TJ : TI)) {
                const int8_t* src = is_j ? xj + spk_slab_col(col, bw_j, t)
                                         : (p == 0 ? xi_hi : xi_lo) + spk_slab_col(col, bw_i, t);
                const long long ld = is_j ? ldj : ldi;
                const int s = s0 + 4 * w;
#pragma unroll
                for (int b = 0; b < 4; ++b)
                    if (s + b < S) word |= (int)(uint8_t)src[(long long)(s + b) * ld] << (8 * b);
            }
            if (is_j)
                sJ[t][c][w] = word;
            else
                sI[p][t][c][w] = word;
        }
        __syncthreads();
#pragma unroll 4
        for (int w = 0; w < KW_I8; ++w) {
            int xv[SPK_NS];
#pragma unroll
            for (int u = 0; u < SPK_NS; ++u) xv[u] = sJ[u][tx][w];
#pragma unroll
            for (int p = 0; p < NP; ++p)
#pragma unroll
                for (int t = 0; t < SPK_NS; ++t) {
                    const int a = sI[p][t][ty][w];
#pragma unroll
                    for (int u = 0; u < SPK_NS; ++u) acc[p][t][u] = __dp4a(a, xv[u], acc[p][t][u]);
                }
        }
        __syncthreads();
    }

    const int i = i0 + ty, j = j0 + tx;
    if (i >= TI || j >= TJ) return;
    float C[SPK_NS][SPK_NS];
#pragma unroll
    for (int t = 0; t < SPK_NS; ++t)
#pragma unroll
        for (int u = 0; u < SPK_NS; ++u) {
            int c = acc[0][t][u] * m0;  // exact: S * 16383 < 2^31 (int8-mode rule)
            if (NP == 2) c += acc[1][t][u] * m1;
            C[t][u] = __fmul_rn(__int2float_rn(c), acc_scale);
        }
    store_pair<DUAL>(C, i, j, ipf, jpf, ipwf, jpwf, out, out_wog, ldo, bw_i, bw_j, pc);
}

template <int NP, bool DUAL>
__global__ void __launch_bounds__(BLK * BLK)
mi_tile_bf16_kernel(const __nv_bfloat16* __restrict__ xi_hi, const __nv_bfloat16* __restrict__ xi_lo,
                    const __nv_bfloat16* __restrict__ xj, long long ldi, long long ldj,
                    const float* __restrict__ ipf, const float* __restrict__ jpf,
                    const float* __restrict__ ipwf, const float* __restrict__ jpwf,
                    float* __restrict__ out, float* __restrict__ out_wog, long long ldo, int S,
                    int TI, int TJ, int bw_i, int bw_j, int nbi, float m0, float m1,
                    float acc_scale, float pc) {
    __shared__ float sI[NP][SPK_NS][BLK][KS_BF + 1];
    __shared__ float sJ[SPK_NS][BLK][KS_BF + 1];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * BLK + tx;
    const int i0 = (blockIdx.x % nbi) * BLK, j0 = (blockIdx.x / nbi) * BLK;

    float acc[NP][SPK_NS][SPK_NS];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int t = 0; t < SPK_NS; ++t)
#pragma unroll
            for (int u = 0; u < SPK_NS; ++u) acc[p][t][u] = 0.f;

    for (int s0 = 0; s0 < S; s0 += KS_BF) {
        for (int job = tid; job < (NP + 1) * SPK_NS * BLK * KS_BF; job += BLK * BLK) {
            const int c = job % BLK;
            int r = job / BLK;
            const int t = r % SPK_NS;
            r /= SPK_NS;
            const int k = r % KS_BF;
            const int p = r / KS_BF;
            const bool is_j = p == NP;
            const int col = (is_j ? j0 : i0) + c;
            const int s = s0 + k;
            float x = 0.f;
            if (s < S && col < (is_j ? TJ : TI)) {
                const __nv_bfloat16* src = is_j ? xj + spk_slab_col(col, bw_j, t)
                                                : (p == 0 ? xi_hi : xi_lo) + spk_slab_col(col, bw_i, t);
                x = __bfloat162float(src[(long long)s * (is_j ? ldj : ldi)]);
            }
            if (is_j)
                sJ[t][c][k] = x;
            else
                sI[p][t][c][k] = x;
        }
        __syncthreads();
#pragma unroll 4
        for (int k = 0; k < KS_BF; ++k) {
            float xv[SPK_NS];
#pragma unroll
            for (int u = 0; u < SPK_NS; ++u) xv[u] = sJ[u][tx][k];
#pragma unroll
            for (int p = 0; p < NP; ++p)
#pragma unroll
                for (int t = 0; t < SPK_NS; ++t) {
                    const float a = sI[p][t][ty][k];
#pragma unroll
                    for (int u = 0; u < SPK_NS; ++u) acc[p][t][u] = fmaf(a, xv[u], acc[p][t][u]);
                }
        }
        __syncthreads();
    }

    const int i = i0 + ty, j = j0 + tx;
    if (i >= TI || j >= TJ) return;
    float C[SPK_NS][SPK_NS];
#pragma unroll
    for (int t = 0; t < SPK_NS; ++t)
#pragma unroll
        for (int u = 0; u < SPK_NS; ++u) {
            float c = m0 == 1.f ? acc[0][t][u] : __fmul_rn(acc[0][t][u], m0);
            if (NP == 2) c = __fadd_rn(c, m1 == 1.f ? acc[1][t][u] : __fmul_rn(acc[1][t][u], m1));
            C[t][u] = acc_scale == 1.f ? c : __fmul_rn(c, acc_scale);
        }
    store_pair<DUAL>(C, i, j, ipf, jpf, ipwf, jpwf, out, out_wog, ldo, bw_i, bw_j, pc);
}

template <bool DUAL>
int launch(int dtype, const void* xi_hi, const void* xi_lo, const void* xj, long long ldi,
           long long ldj, const void* ipf_, const void* jpf_, const void* ipwf_,
           const void* jpwf_, void* out_, void* out_wog_, long long ldo, int S, int TI, int TJ,
           int bw_i, int bw_j, int n_passes, double m0, double m1, float acc_scale, float pc,
           void* stream) {
    const int nbi = (TI + BLK - 1) / BLK, nbj = (TJ + BLK - 1) / BLK;
    const dim3 block(BLK, BLK);
    const dim3 grid((unsigned)((long long)nbi * nbj));
    cudaStream_t st = (cudaStream_t)stream;
    const float *ipf = (const float*)ipf_, *jpf = (const float*)jpf_;
    const float *ipwf = (const float*)ipwf_, *jpwf = (const float*)jpwf_;
    float *out = (float*)out_, *out_wog = (float*)out_wog_;
    if (dtype == 0) {
        const int8_t *a = (const int8_t*)xi_hi, *b = (const int8_t*)xi_lo, *x = (const int8_t*)xj;
        if (n_passes == 2)
            mi_tile_i8_kernel<2, DUAL><<<grid, block, 0, st>>>(
                a, b, x, ldi, ldj, ipf, jpf, ipwf, jpwf, out, out_wog, ldo, S, TI, TJ, bw_i, bw_j,
                nbi, (int)m0, (int)m1, acc_scale, pc);
        else
            mi_tile_i8_kernel<1, DUAL><<<grid, block, 0, st>>>(
                a, a, x, ldi, ldj, ipf, jpf, ipwf, jpwf, out, out_wog, ldo, S, TI, TJ, bw_i, bw_j,
                nbi, (int)m0, 0, acc_scale, pc);
    } else {
        const __nv_bfloat16 *a = (const __nv_bfloat16*)xi_hi, *b = (const __nv_bfloat16*)xi_lo,
                            *x = (const __nv_bfloat16*)xj;
        if (n_passes == 2)
            mi_tile_bf16_kernel<2, DUAL><<<grid, block, 0, st>>>(
                a, b, x, ldi, ldj, ipf, jpf, ipwf, jpwf, out, out_wog, ldo, S, TI, TJ, bw_i, bw_j,
                nbi, (float)m0, (float)m1, acc_scale, pc);
        else
            mi_tile_bf16_kernel<1, DUAL><<<grid, block, 0, st>>>(
                a, a, x, ldi, ldj, ipf, jpf, ipwf, jpwf, out, out_wog, ldo, S, TI, TJ, bw_i, bw_j,
                nbi, (float)m0, 0.f, acc_scale, pc);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// B3.  dtype: 0 = int8 operands (int32 accumulation), 1 = bf16 operands
// (f32).  Pointers are device pointers; ld* are row strides in elements
// (sample-major operands); ipwf/jpwf are the wo-gaps presence and the wog
// output shares out's row stride.  Returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int spk_mi_tile_dual(int dtype, const void* xi_hi, const void* xi_lo, const void* xj,
                                long long ldi, long long ldj, const void* ipf, const void* jpf,
                                const void* ipwf, const void* jpwf, void* out, void* out_wog,
                                long long ldo, int S, int TI, int TJ, int bw_i, int bw_j,
                                int n_passes, double m0, double m1, float acc_scale, float pc,
                                void* stream) {
    return launch<true>(dtype, xi_hi, xi_lo, xj, ldi, ldj, ipf, jpf, ipwf, jpwf, out, out_wog,
                        ldo, S, TI, TJ, bw_i, bw_j, n_passes, m0, m1, acc_scale, pc, stream);
}
