// Kernels B4 and B5: the split MI path of sample-sharded sweeps.
//
// A fused MI tile (K1, B3 in mi_tile.cu) cannot hold a collective in the
// middle of the kernel, so when each device holds only a slice of the
// samples the sweep splits it (spydrpick_tpu/engine/solver.py:540-583):
// B4 materialises the slab crosstable of the rank's samples, the caller
// sums it over the sample shards (int32 for int8 operands: exact, so the
// merged counts equal the single-device ones), converts and de-quantises
// it in f32, and B5 runs the entropy epilogue over the merged table.
//
// B4 replaces spydrpick_tpu/ops/mi_pallas.py:crosstab_tile_pallas (body
// _xtab_kernel): the same operands, passes and pass_mults digit
// recombination as K1, no acc_scale and no epilogue; int8 operands give
// the int32 counts acc[0]*m0 + acc[1]*m1, bf16 operands the f32 sums.  It
// is K1's accumulation loop (dp4a over samples staged in shared memory as
// 4-byte words, one 16x16 block of pairs per thread block, one pair's
// 5x5 x NP accumulators in one thread's registers), kept as its own
// kernel so that K1's generated code stays as it is; each thread stores
// its 25 cells at their slab positions, so neighbouring threads (j) store
// neighbouring words.  Bound, like K1, by the integer pipe and
// shared-memory loads; it also writes 100 bytes per pair.
//
// B5 replaces mi_pallas.py:mi_epilogue_pallas (body _epilogue_kernel):
// one thread per pair reads its 25 f32 cells and calls the same
// mi_epilogue (mi_epilogue.cuh) as K1 and B3, once, or twice with the
// wo-gaps presence (dual), so on the same crosstable it gives K1's and
// B3's values bit for bit.  It is memory-bound (100 bytes read per pair):
// threads are laid out 32 along j, so each of the 25 reads of a warp is
// one 128-byte line.

#include "mi_epilogue.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int BLK = 16;    // B4: i and j columns per thread block, one pair per thread
constexpr int KW_I8 = 16;  // B4: shared words per chunk on the int8 path (4 samples each)
constexpr int KS_BF = 16;  // B4: samples per chunk on the bf16 path
constexpr int EJ = 32;     // B5: j columns per thread block (one warp row)
constexpr int EI = 8;      // B5: i columns per thread block

// The minimum-blocks bound caps the registers at 64 (2 passes; ptxas then
// spills 104 bytes) and 51 (1 pass): 4 and 5 resident blocks per SM.  Left
// to itself ptxas gave the 2-pass instance 72 registers, 3 blocks per SM,
// and on an H100 it took 166 ms at S=3072, 512 x 30720 against 108 ms with
// the bound (K1: 109 ms).
template <int NP>
__global__ void __launch_bounds__(BLK * BLK, NP == 2 ? 4 : 5)
crosstab_i8_kernel(const int8_t* __restrict__ xi_hi, const int8_t* __restrict__ xi_lo,
                   const int8_t* __restrict__ xj, long long ldi, long long ldj,
                   int* __restrict__ out, long long ldc, int S, int TI, int TJ, int bw_i,
                   int bw_j, int nbi, int m0, int m1) {
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
#pragma unroll
    for (int t = 0; t < SPK_NS; ++t) {
        int* row = out + spk_slab_col(i, bw_i, t) * ldc;
#pragma unroll
        for (int u = 0; u < SPK_NS; ++u) {
            int c = acc[0][t][u] * m0;  // exact: S * 16383 < 2^31 (int8-mode rule)
            if (NP == 2) c += acc[1][t][u] * m1;
            row[spk_slab_col(j, bw_j, u)] = c;
        }
    }
}

template <int NP>
__global__ void __launch_bounds__(BLK * BLK)
crosstab_bf16_kernel(const __nv_bfloat16* __restrict__ xi_hi,
                     const __nv_bfloat16* __restrict__ xi_lo, const __nv_bfloat16* __restrict__ xj,
                     long long ldi, long long ldj, float* __restrict__ out, long long ldc, int S,
                     int TI, int TJ, int bw_i, int bw_j, int nbi, float m0, float m1) {
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
#pragma unroll
    for (int t = 0; t < SPK_NS; ++t) {
        float* row = out + spk_slab_col(i, bw_i, t) * ldc;
#pragma unroll
        for (int u = 0; u < SPK_NS; ++u) {
            float c = m0 == 1.f ? acc[0][t][u] : __fmul_rn(acc[0][t][u], m0);
            if (NP == 2) c = __fadd_rn(c, m1 == 1.f ? acc[1][t][u] : __fmul_rn(acc[1][t][u], m1));
            row[spk_slab_col(j, bw_j, u)] = c;
        }
    }
}

template <bool DUAL>
__global__ void __launch_bounds__(EJ * EI)
mi_epilogue_kernel(const float* __restrict__ C, long long ldc, const float* __restrict__ ipf,
                   const float* __restrict__ jpf, const float* __restrict__ ipwf,
                   const float* __restrict__ jpwf, float* __restrict__ out,
                   float* __restrict__ out_wog, long long ldo, int TI, int TJ, int bw_i, int bw_j,
                   float pc) {
    const int j = blockIdx.x * EJ + threadIdx.x;
    const int i = blockIdx.y * EI + threadIdx.y;
    if (i >= TI || j >= TJ) return;
    float Cp[SPK_NS][SPK_NS];
#pragma unroll
    for (int t = 0; t < SPK_NS; ++t) {
        const float* row = C + spk_slab_col(i, bw_i, t) * ldc;
#pragma unroll
        for (int u = 0; u < SPK_NS; ++u) Cp[t][u] = row[spk_slab_col(j, bw_j, u)];
    }
    float ip[SPK_NS], jp[SPK_NS];
    load_presence(ipf, i, bw_i, ip);
    load_presence(jpf, j, bw_j, jp);
    out[(long long)i * ldo + j] = mi_epilogue(Cp, ip, jp, pc);
    if constexpr (DUAL) {
        load_presence(ipwf, i, bw_i, ip);
        load_presence(jpwf, j, bw_j, jp);
        out_wog[(long long)i * ldo + j] = mi_epilogue(Cp, ip, jp, pc);
    }
}

}  // namespace

// B4.  dtype: 0 = int8 operands -> int32 out, 1 = bf16 operands -> f32 out.
// Pointers are device pointers; ld* are row strides in elements; out is
// the (TI*5, TJ*5) slab crosstable with row stride ldc.  Returns the
// launch's cudaGetLastError() (0 on success).
extern "C" int spk_crosstab_tile(int dtype, const void* xi_hi, const void* xi_lo, const void* xj,
                                 long long ldi, long long ldj, void* out, long long ldc, int S,
                                 int TI, int TJ, int bw_i, int bw_j, int n_passes, double m0,
                                 double m1, void* stream) {
    const int nbi = (TI + BLK - 1) / BLK, nbj = (TJ + BLK - 1) / BLK;
    const dim3 block(BLK, BLK);
    const dim3 grid((unsigned)((long long)nbi * nbj));
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0) {
        const int8_t *a = (const int8_t*)xi_hi, *b = (const int8_t*)xi_lo, *x = (const int8_t*)xj;
        int* o = (int*)out;
        if (n_passes == 2)
            crosstab_i8_kernel<2><<<grid, block, 0, st>>>(a, b, x, ldi, ldj, o, ldc, S, TI, TJ,
                                                          bw_i, bw_j, nbi, (int)m0, (int)m1);
        else
            crosstab_i8_kernel<1><<<grid, block, 0, st>>>(a, a, x, ldi, ldj, o, ldc, S, TI, TJ,
                                                          bw_i, bw_j, nbi, (int)m0, 0);
    } else {
        const __nv_bfloat16 *a = (const __nv_bfloat16*)xi_hi, *b = (const __nv_bfloat16*)xi_lo,
                            *x = (const __nv_bfloat16*)xj;
        float* o = (float*)out;
        if (n_passes == 2)
            crosstab_bf16_kernel<2><<<grid, block, 0, st>>>(a, b, x, ldi, ldj, o, ldc, S, TI, TJ,
                                                            bw_i, bw_j, nbi, (float)m0, (float)m1);
        else
            crosstab_bf16_kernel<1><<<grid, block, 0, st>>>(a, a, x, ldi, ldj, o, ldc, S, TI, TJ,
                                                            bw_i, bw_j, nbi, (float)m0, 0.f);
    }
    return (int)cudaGetLastError();
}

// B5.  C: the (TI*5, TJ*5) f32 slab crosstable (row stride ldc); ipf/jpf
// the slab presence; ipwf/jpwf the wo-gaps presence, or null for mi only;
// out and out_wog are (TI, TJ) with row stride ldo.
extern "C" int spk_mi_epilogue(const void* C, long long ldc, const void* ipf, const void* jpf,
                               const void* ipwf, const void* jpwf, void* out, void* out_wog,
                               long long ldo, int TI, int TJ, int bw_i, int bw_j, float pc,
                               void* stream) {
    const dim3 block(EJ, EI);
    const dim3 grid((unsigned)((TJ + EJ - 1) / EJ), (unsigned)((TI + EI - 1) / EI));
    cudaStream_t st = (cudaStream_t)stream;
    const float *c = (const float*)C, *ip = (const float*)ipf, *jp = (const float*)jpf;
    const float *ipw = (const float*)ipwf, *jpw = (const float*)jpwf;
    if (ipwf == nullptr)
        mi_epilogue_kernel<false><<<grid, block, 0, st>>>(c, ldc, ip, jp, nullptr, nullptr,
                                                          (float*)out, nullptr, ldo, TI, TJ,
                                                          bw_i, bw_j, pc);
    else
        mi_epilogue_kernel<true><<<grid, block, 0, st>>>(c, ldc, ip, jp, ipw, jpw, (float*)out,
                                                         (float*)out_wog, ldo, TI, TJ, bw_i,
                                                         bw_j, pc);
    return (int)cudaGetLastError();
}
