// Weighted 5x5 joint-count tables of explicit column pairs: the pairs'
// crosstables of the threshold tournament and the lazy wo-gaps resolve.
//
// Replaces the reference's _pairs_xtab (spydrpick_tpu/engine/solver.py:862,
// plain XLA there: a compare/select/sum over samples that XLA fuses), which
// the port ran as plain torch (an (S, 25, P) f32 temporary per chunk of
// pairs).  No pallas_call did this work.
//
// In: ci, cj, the (S, P) uint8 codes of the pairs' i and j columns
// (row-major: sample s of pair p at s * P + p), and the (S,) f32 sample
// weights.  Out: (P, 25) f32, bin ci * 5 + cj of pair p the sum of the
// weights of the samples with that joint state; a code above 4 on either
// side (255: padding) adds to no bin.
//
// The sum is exact and free of order.  Every bin is accumulated in float64
// and rounded to f32 once.  An f32 weight is a multiple of 2^(e - 23) for
// its exponent e, so while log2 S + e_max - e_min + 24 <= 53 every partial
// sum is an exact f64 value, whatever the order of the adds: the kernel,
// its plain version (ops/pairs.py) and any order of the pairs or the
// samples then give the same bits.  Weights <= 1 qualify when every
// nonzero weight is at least 2^(ceil(log2 S) - 29); computed weights (>=
// 1/S), unit weights and weights in [0.1, 1) do.  Outside that range the
// order below is still fixed, and the results agree with any other order
// within one f32 ulp.
//
// Design.  A block of 128 threads takes 32 pairs; its 4 warps split the
// samples into 4 contiguous ranges, lane l of warp g summing pair p0 + l
// over range g in sample order.  A warp's loads of one sample row are 32
// adjacent bytes of ci and of cj.  The 25 bins live in shared memory laid
// out [bin][thread] (25 * 128 * 8 B = 25.6 KB, no opt-in above 48 KB), so
// a sample costs one f64 add into the bin its joint state picks, where 25
// predicated adds in registers would cost 25 (the H100's f64 rate would
// then bound the kernel), and lanes of a warp hit 32 distinct banks pairs
// whatever their bins.  At the end the block adds the 4 ranges of each
// bin in the fixed order 0, 1, 2, 3 and writes the (32, 25) tables as f32,
// consecutive threads on consecutive words.  No atomics: each output word
// has one writer.
//
// What bounds it on the H100: the bytes.  2 * S * P code bytes read once
// and 100 * P written, against S * P f64 adds (chip_smoke.py prints the
// share).  The gathers that make ci and cj from the engine's codes are
// torch index_select calls before the launch.

#include "common.cuh"

namespace {

constexpr int PX_PAIRS = 32;   // pairs per block: one per lane
constexpr int PX_GROUPS = 4;   // sample ranges per block: one per warp
constexpr int PX_THREADS = PX_PAIRS * PX_GROUPS;
constexpr int PX_BINS = SPK_NS * SPK_NS;

__global__ void __launch_bounds__(PX_THREADS)
pairs_xtab_kernel(const unsigned char* __restrict__ ci, const unsigned char* __restrict__ cj,
                  const float* __restrict__ w, int S, long long P, float* __restrict__ out) {
    __shared__ double bins[PX_BINS * PX_THREADS];
    const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
    for (int k = threadIdx.x; k < PX_BINS * PX_THREADS; k += PX_THREADS) bins[k] = 0.0;
    __syncthreads();
    const long long p0 = (long long)blockIdx.x * PX_PAIRS;
    const long long p = p0 + lane;
    const int per = (S + PX_GROUPS - 1) / PX_GROUPS;
    const int s0 = g * per, s1 = min(S, s0 + per);
    if (p < P) {
        double* mine = bins + threadIdx.x;
        // unrolled so that the loads of later samples issue ahead of the
        // chain of shared-memory adds
#pragma unroll 8
        for (int s = s0; s < s1; ++s) {
            const long long at = (long long)s * P + p;
            const unsigned q = __ldg(ci + at) * SPK_NS + __ldg(cj + at);
            if (q < PX_BINS) mine[q * PX_THREADS] += (double)__ldg(w + s);
        }
    }
    __syncthreads();
    const int n = (int)min((long long)PX_PAIRS, P - p0);
    for (int k = threadIdx.x; k < n * PX_BINS; k += PX_THREADS) {
        const int pl = k / PX_BINS, b = k % PX_BINS;
        const double* row = bins + b * PX_THREADS + pl;
        double acc = row[0];
#pragma unroll
        for (int gg = 1; gg < PX_GROUPS; ++gg) acc += row[gg * PX_PAIRS];
        out[p0 * PX_BINS + k] = __double2float_rn(acc);
    }
}

}  // namespace

// ci, cj: (S, P) uint8; w: (S,) f32; out: (P, 25) f32.  Returns
// cudaGetLastError().
extern "C" int spk_pairs_xtab(const void* ci, const void* cj, const void* w, int S,
                              long long P, void* out, void* stream) {
    if (P <= 0) return 0;
    const long long blocks = (P + PX_PAIRS - 1) / PX_PAIRS;
    pairs_xtab_kernel<<<(unsigned)blocks, PX_THREADS, 0, (cudaStream_t)stream>>>(
        (const unsigned char*)ci, (const unsigned char*)cj, (const float*)w, S, P, (float*)out);
    return (int)cudaGetLastError();
}
