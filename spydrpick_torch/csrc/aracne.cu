// Kernel A: the ARACNE DPI scan, one warp per edge over a sorted-neighbour
// CSR on the device.
//
// Replaces the host's owner-scan (spydrpick_torch/native/aracne.cpp, the
// port's copy of spydrpick_tpu/native/aracne.cpp:33, which the JAX
// package's engine/aracne.py:run_aracne calls) on the main path: no TPU
// kernel did this work.  Closed form of the DPI rule: edge (a, b, w) is
// indirect iff some common neighbour c has
//     min(w_ac, w_bc) >= w + max(thr, 0)
// all in float64, the add the same f64 add as aracne.cpp's `need`.  Every
// step is an exact comparison, so the flags do not depend on the order in
// which the warps find their hits, and equal the owner-scan's bit for bit.
//
// Input: the edge columns (int64 node ids a < b, f64 weights) and the CSR
// that ops/aracne.py builds with torch ops: offsets (n_nodes + 1, int64),
// and per half-edge the neighbour (int32, ascending within each node's
// row) and its edge's weight (f64).  Output: one uint8 per edge, 1 for a
// direct edge (kept), 0 for an indirect one.
//
// Design: warp e takes edge e.  u is the endpoint with the shorter row, v
// the other.  The lanes stride over u's row, 32 neighbours at a time; a
// lane whose c is not v binary-searches c in v's sorted row and, where it
// is found, tests min(w_uc, w_vc) against the need.  After each stride
// __any_sync tells the whole warp whether a lane hit, and the warp stops
// at the first stride that holds a hit.  Every lane runs the same number
// of strides (u's degree is the warp's), so the vote is uniform.
//
// What bounds it on the H100: memory latency, not bandwidth.  Each probe
// is a chain of dependent loads into v's row (log2 deg steps); the bytes a
// perfect kernel would move are the CSR and the edge columns read once and
// the flags written once (chip_smoke.py prints the share of that bound),
// but the probes re-read v's row once per common-neighbour candidate, from
// L2 when it hits there (the CSR is 74 MB at the 30k shape, more than the
// 50 MB L2) and from device memory otherwise.  Many warps in flight hide
// part of the latency; the probes' chains keep the scan well under its
// bound (0.9% of it at the 30k shape on an H100, PERF.md).

#include "common.cuh"

namespace {

constexpr int AR_THREADS = 256;
constexpr int AR_WARPS = AR_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// index of c in the ascending row nbr[lo, hi), or -1
__device__ __forceinline__ long long find_sorted(const int* __restrict__ nbr, long long lo,
                                                 long long end, int c) {
    long long hi = end;
    while (lo < hi) {  // first slot whose neighbour is >= c
        const long long mid = lo + ((hi - lo) >> 1);
        if (__ldg(nbr + mid) < c)
            lo = mid + 1;
        else
            hi = mid;
    }
    return (lo < end && __ldg(nbr + lo) == c) ? lo : -1;
}

__global__ void __launch_bounds__(AR_THREADS)
aracne_scan_kernel(const long long* __restrict__ a, const long long* __restrict__ b,
                   const double* __restrict__ w, long long E,
                   const long long* __restrict__ offs, const int* __restrict__ nbr,
                   const double* __restrict__ wadj, double margin_add,
                   unsigned char* __restrict__ out) {
    const long long e = (long long)blockIdx.x * AR_WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (e >= E) return;  // whole warps leave together: e is the warp's
    const long long na = a[e], nb = b[e];
    const long long a0 = offs[na], a1 = offs[na + 1];
    const long long b0 = offs[nb], b1 = offs[nb + 1];
    // u: the shorter row (scanned); v: the longer one (searched)
    const bool a_short = (a1 - a0) <= (b1 - b0);
    const long long u0 = a_short ? a0 : b0, du = a_short ? a1 - a0 : b1 - b0;
    const long long v0 = a_short ? b0 : a0, v1 = a_short ? b1 : a1;
    const int v = (int)(a_short ? nb : na);
    const double need = w[e] + margin_add;
    bool hit = false;
    for (long long base = 0; base < du; base += 32) {
        bool mine = false;
        const long long p = base + lane;
        if (p < du) {
            const int c = __ldg(nbr + u0 + p);
            if (c != v) {
                const long long q = find_sorted(nbr, v0, v1, c);
                if (q >= 0) {
                    const double wu = __ldg(wadj + u0 + p), wv = __ldg(wadj + q);
                    mine = (wu < wv ? wu : wv) >= need;
                }
            }
        }
        if (__any_sync(FULL, mine)) {
            hit = true;
            break;
        }
    }
    if (lane == 0) out[e] = hit ? 0 : 1;
}

}  // namespace

// a, b: (E,) int64 node ids; w: (E,) f64; offs: (n_nodes + 1,) int64; nbr:
// (2E,) int32; wadj: (2E,) f64; out: (E,) uint8.  Returns cudaGetLastError().
extern "C" int spk_aracne_scan(const void* a, const void* b, const void* w, long long E,
                               const void* offs, const void* nbr, const void* wadj,
                               double margin_add, void* out, void* stream) {
    if (E <= 0) return 0;
    const long long blocks = (E + AR_WARPS - 1) / AR_WARPS;
    aracne_scan_kernel<<<(unsigned)blocks, AR_THREADS, 0, (cudaStream_t)stream>>>(
        (const long long*)a, (const long long*)b, (const double*)w, E, (const long long*)offs,
        (const int*)nbr, (const double*)wadj, margin_add, (unsigned char*)out);
    return (int)cudaGetLastError();
}
