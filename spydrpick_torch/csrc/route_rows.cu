// Kernel K2: per-row stream compaction of a thresholded MI row buffer.
//
// Replaces spydrpick_tpu/ops/compact_route.py:route_rows_pallas.  For
// each row r of an (R, W) mask it writes, in lanes [0, counts[r]), the
// masked mi (and wog) values verbatim and their row-local column index,
// in ascending column order; lanes past counts[r] are zero.  The TPU
// kernel routed elements with log2(W) rounds of lane rolls because the
// TPU scatters element by element; on the H100 a scan does it in one
// pass.
//
// What bounds it on the H100: device-memory traffic (each row's mask and
// values are read once and each output lane written once) at the sparse
// survivor densities of the sweep.  Design: one block of 256 threads per
// row walks the row in 256-lane chunks; a warp ballot + __popc gives
// each survivor its rank inside its warp, a shared-memory scan of the 8
// warp totals its rank inside the chunk, and a running base the chunk's
// offset in the row, so writes stay ordered and no atomics are needed.

#include "common.cuh"

namespace {

constexpr int RT = 256;  // threads per row block
constexpr int NW = RT / 32;

template <bool WOG>
__global__ void __launch_bounds__(RT)
route_rows_kernel(const uint8_t* __restrict__ mask, const float* __restrict__ mi,
                  const float* __restrict__ wog, float* __restrict__ omi, int* __restrict__ oj,
                  float* __restrict__ owog, int* __restrict__ counts, int W) {
    __shared__ int warp_tot[NW];
    const long long row = (long long)blockIdx.x * W;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int base = 0;
    for (int c0 = 0; c0 < W; c0 += RT) {
        const int c = c0 + threadIdx.x;
        const bool keep = c < W && mask[row + c] != 0;
        const unsigned bal = __ballot_sync(0xffffffffu, keep);
        if (lane == 0) warp_tot[warp] = __popc(bal);
        __syncthreads();
        int before = 0, total = 0;
#pragma unroll
        for (int k = 0; k < NW; ++k) {
            const int v = warp_tot[k];
            total += v;
            before += k < warp ? v : 0;
        }
        if (keep) {
            const long long pos = row + base + before + __popc(bal & ((1u << lane) - 1u));
            omi[pos] = mi[row + c];
            oj[pos] = c;
            if (WOG) owog[pos] = wog[row + c];
        }
        base += total;
        __syncthreads();  // warp_tot is rewritten by the next chunk
    }
    for (int c = base + threadIdx.x; c < W; c += RT) {
        omi[row + c] = 0.f;
        oj[row + c] = 0;
        if (WOG) owog[row + c] = 0.f;
    }
    if (threadIdx.x == 0) counts[blockIdx.x] = base;
}

}  // namespace

// All arrays are contiguous (R, W) device arrays (counts: (R,)); wog and
// owog are null when there is no wog payload.  Returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int spk_route_rows(const void* mask, const void* mi, const void* wog, void* omi,
                              void* oj, void* owog, void* counts, int R, int W, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (wog)
        route_rows_kernel<true><<<R, RT, 0, st>>>((const uint8_t*)mask, (const float*)mi,
                                                  (const float*)wog, (float*)omi, (int*)oj,
                                                  (float*)owog, (int*)counts, W);
    else
        route_rows_kernel<false><<<R, RT, 0, st>>>((const uint8_t*)mask, (const float*)mi, nullptr,
                                                   (float*)omi, (int*)oj, nullptr, (int*)counts, W);
    return (int)cudaGetLastError();
}
