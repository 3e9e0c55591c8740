// Kernel B5: the entropy epilogue of the split MI path of sample-sharded
// sweeps.
//
// A fused MI tile (K1, B3) cannot hold a collective in the middle of the
// kernel, so when each device holds only a slice of the samples the sweep
// splits it (spydrpick_tpu/engine/solver.py:540-583): B4 (xtab_mma.cu)
// materialises the slab crosstable of the rank's samples, the caller sums
// it over the sample shards (int32 for int8 operands: exact, so the merged
// counts equal the single-device ones), converts and de-quantises it in
// f32, and B5 runs the entropy epilogue over the merged table.
//
// B5 replaces mi_pallas.py:mi_epilogue_pallas (body _epilogue_kernel):
// one thread per pair reads its 25 f32 cells and calls the same
// mi_epilogue (mi_epilogue.cuh) as K1 and B3, once, or twice with the
// wo-gaps presence (dual), so on the same crosstable it gives K1's and
// B3's values bit for bit.  It is memory-bound (100 bytes read per pair):
// threads are laid out 32 along j, so each of the 25 reads of a warp is
// one 128-byte line.

#include "mi_epilogue.cuh"

namespace {

constexpr int EJ = 32;     // B5: j columns per thread block (one warp row)
constexpr int EI = 8;      // B5: i columns per thread block

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
