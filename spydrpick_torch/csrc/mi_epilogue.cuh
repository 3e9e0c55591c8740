// The entropy epilogue of one column pair, shared by the fused MI tiles
// (K1, B3 in xtab_mma.cu) and the split path's epilogue kernel (B5 in
// xtab.cu), so that every kernel computes mi from a crosstable with the
// same code and the same rounding: _mi_from_block
// (spydrpick_tpu/ops/mi_pallas.py:88-121) op for op, with
// __fmul_rn/__fadd_rn so that nvcc contracts nothing into an FMA.
#pragma once

#include "common.cuh"

#include <float.h>

namespace {

__device__ __forceinline__ float ln_pos(float x) { return logf(x > 0.f ? x : 1.f); }

// _sum_istates / _sum_jstates order: ((x0 + x1) + (x2 + x3)) + x4
__device__ __forceinline__ float sum5(const float* v) {
    return __fadd_rn(__fadd_rn(__fadd_rn(v[0], v[1]), __fadd_rn(v[2], v[3])), v[4]);
}

// _mi_from_block for one (i, j) pair; C[t][u] = count of (i-state t, j-state u).
__device__ float mi_epilogue(const float (&C)[SPK_NS][SPK_NS], const float (&ip)[SPK_NS],
                             const float (&jp)[SPK_NS], float pc) {
    float A[SPK_NS][SPK_NS], lnA[SPK_NS][SPK_NS];
#pragma unroll
    for (int t = 0; t < SPK_NS; ++t)
#pragma unroll
        for (int u = 0; u < SPK_NS; ++u) {
            const float pm = __fmul_rn(ip[t], jp[u]);
            A[t][u] = __fadd_rn(C[t][u], __fmul_rn(pc, pm));
            lnA[t][u] = ln_pos(A[t][u]);
        }
    float v[SPK_NS], w[SPK_NS];
    // G1 = sum_j(sum_i(A * lnA * pm))
#pragma unroll
    for (int u = 0; u < SPK_NS; ++u) {
#pragma unroll
        for (int t = 0; t < SPK_NS; ++t)
            v[t] = __fmul_rn(__fmul_rn(A[t][u], lnA[t][u]), __fmul_rn(ip[t], jp[u]));
        w[u] = sum5(v);
    }
    const float G1 = sum5(w);
    // B = sum_j(A * jrow): masked j-marginal per i-state
    float B[SPK_NS];
#pragma unroll
    for (int t = 0; t < SPK_NS; ++t) {
#pragma unroll
        for (int u = 0; u < SPK_NS; ++u) v[u] = __fmul_rn(A[t][u], jp[u]);
        B[t] = sum5(v);
    }
    // R = sum_i(A): the FULL row sum over all i-states (mi.hpp:173)
    float RJ[SPK_NS], RJlnR[SPK_NS];
#pragma unroll
    for (int u = 0; u < SPK_NS; ++u) {
#pragma unroll
        for (int t = 0; t < SPK_NS; ++t) v[t] = A[t][u];
        const float R = sum5(v);
        RJ[u] = __fmul_rn(R, jp[u]);
        RJlnR[u] = __fmul_rn(RJ[u], ln_pos(R));
    }
    const float Gi = sum5(RJlnR);
    const float Si = sum5(RJ);
#pragma unroll
    for (int t = 0; t < SPK_NS; ++t) {
        v[t] = __fmul_rn(B[t], ip[t]);
        w[t] = __fmul_rn(__fmul_rn(B[t], ln_pos(B[t])), ip[t]);
    }
    const float Z = sum5(v);
    const float Gj = sum5(w);
    const float invZ = __fdiv_rn(1.f, fmaxf(Z, FLT_MIN));
    const float lnZ = ln_pos(Z);
    const float jointH = __fmul_rn(__fsub_rn(G1, __fmul_rn(lnZ, Z)), invZ);
    const float icondH = __fmul_rn(__fsub_rn(Gi, __fmul_rn(lnZ, Si)), invZ);
    const float jcondH = __fmul_rn(__fsub_rn(Gj, __fmul_rn(lnZ, Z)), invZ);  // S_j == Z
    return __fsub_rn(__fsub_rn(jointH, icondH), jcondH);
}

__device__ __forceinline__ void load_presence(const float* __restrict__ pf, int c, int bw,
                                              float (&p)[SPK_NS]) {
#pragma unroll
    for (int t = 0; t < SPK_NS; ++t) p[t] = pf[spk_slab_col(c, bw, t)];
}

}  // namespace
