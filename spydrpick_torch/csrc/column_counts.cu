// Per-column state counts of an (S, L) uint8 code matrix on the device.
//
// Replaces the host's per-column histogram of the filter and the presence
// masks (spydrpick_torch/core/alignment.py:state_counts, the port's copy of
// spydrpick_tpu/core/alignment.py:69: five np.count_nonzero passes over the
// codes): no TPU kernel did this work.  out[c, s] is the number of samples
// whose code in column c is s, for s in 0..4; any other code (255, the
// engine's padding) counts nowhere.  Integer counts: exact, and equal to
// the host's whatever the order of the adds.
//
// Design.  Thread t of the x grid owns the 4 adjacent columns 4t..4t+3
// and reads them as one 32-bit word per sample row, so a warp's 32 loads
// of a row are one 128-byte line.  The counts are kept in SWAR form: for
// each state s, __vcmpeq4 marks the bytes of the word equal to s with 0xff,
// masked to 1 and added to a packed word of four 8-bit counters (five
// words a thread, 3 integer operations per state and row, no branch).  A
// byte counter holds at most 255, so the samples are cut into chunks of at
// most 255 rows, one chunk per y index of the grid; at a chunk's end each
// thread unpacks its 20 counters and adds them to out with integer atomics
// (red.global.add: exact, and the order of the adds cannot change a sum).
// The chunks also give the grid its width: at L = 30720 the columns alone
// make 7,680 threads, too few to keep the H100's memory busy.  A matrix
// whose rows are not 4-byte aligned (L % 4 != 0) takes the same path with
// the word assembled from single bytes, the missing tail bytes set to 255.
//
// What bounds it on the H100: the bytes.  S*L bytes read once and 20*L
// written (27.5 us at S=3000 x L=30720 at 3.35 TB/s); the SWAR loop is ~16
// integer operations per 4 codes, below the integer rate, and the atomics
// are 20 per thread and chunk (chip_smoke.py prints the share of the bound).

#include "common.cuh"

namespace {

constexpr int CC_THREADS = 256;
constexpr int CC_MAX_ROWS = 255;  // a packed 8-bit counter's capacity
constexpr unsigned ONES = 0x01010101u;

template <bool kAligned>
__device__ __forceinline__ unsigned load_word(const unsigned char* __restrict__ codes,
                                              long long row, int L, int c0) {
    const unsigned char* p = codes + row * (long long)L + c0;
    if (kAligned) return __ldg(reinterpret_cast<const unsigned*>(p));
    unsigned w = 0xffffffffu;  // missing columns read as code 255: no state
    const int n = L - c0 < 4 ? L - c0 : 4;
    for (int k = 0; k < n; ++k) w = (w & ~(0xffu << (8 * k))) | ((unsigned)__ldg(p + k) << (8 * k));
    return w;
}

template <bool kAligned>
__global__ void __launch_bounds__(CC_THREADS)
column_counts_kernel(const unsigned char* __restrict__ codes, int S, int L, int rows_per_chunk,
                     int* __restrict__ out) {
    const int c0 = (blockIdx.x * CC_THREADS + threadIdx.x) * 4;
    if (c0 >= L) return;
    const int r0 = blockIdx.y * rows_per_chunk;
    const int r1 = min(S, r0 + rows_per_chunk);
    unsigned acc[SPK_NS] = {0u, 0u, 0u, 0u, 0u};
#pragma unroll 4
    for (int r = r0; r < r1; ++r) {
        const unsigned w = load_word<kAligned>(codes, r, L, c0);
#pragma unroll
        for (int s = 0; s < SPK_NS; ++s) acc[s] += __vcmpeq4(w, s * ONES) & ONES;
    }
    const int n = L - c0 < 4 ? L - c0 : 4;
    for (int k = 0; k < n; ++k) {
#pragma unroll
        for (int s = 0; s < SPK_NS; ++s) {
            const int v = (acc[s] >> (8 * k)) & 0xff;
            if (v) atomicAdd(out + (long long)(c0 + k) * SPK_NS + s, v);
        }
    }
}

}  // namespace

// codes: (S, L) uint8, row-major, contiguous; out: (L, 5) int32, zeroed
// by the caller.  Returns cudaGetLastError().
extern "C" int spk_column_counts(const void* codes, int S, int L, void* out, void* stream) {
    if (S <= 0 || L <= 0) return 0;
    const int blocks_x = (L / 4 + (L % 4 != 0) + CC_THREADS - 1) / CC_THREADS;
    // enough chunks for ~8 blocks per SM of a 132-SM card, never more
    // than 255 rows in one (the packed counters' capacity)
    int chunks = (1056 + blocks_x - 1) / blocks_x;
    const int least = (S + CC_MAX_ROWS - 1) / CC_MAX_ROWS;
    const int most = (S + 15) / 16;
    chunks = chunks < least ? least : (chunks > most ? (most > least ? most : least) : chunks);
    const int rows = (S + chunks - 1) / chunks;
    chunks = (S + rows - 1) / rows;
    const dim3 grid(blocks_x, chunks);
    const bool aligned = (L % 4 == 0) && ((reinterpret_cast<unsigned long long>(codes) & 3) == 0);
    if (aligned)
        column_counts_kernel<true><<<grid, CC_THREADS, 0, (cudaStream_t)stream>>>(
            (const unsigned char*)codes, S, L, rows, (int*)out);
    else
        column_counts_kernel<false><<<grid, CC_THREADS, 0, (cudaStream_t)stream>>>(
            (const unsigned char*)codes, S, L, rows, (int*)out);
    return (int)cudaGetLastError();
}
