// Kernel B2: row_select, one pass over a block-row's MI buffer that
// thresholds it, updates colmax and appends the surviving edges to a
// device edge store.
//
// Replaces spydrpick_tpu/ops/compact_route.py:route_rows_pallas (the
// per-row compaction) and the mask and colmax part of
// spydrpick_tpu/engine/solver.py:row_sweep_core.  For an item of a sweep,
// block-row i0 against the columns [j0, j0 + W) (the full-width row: j0 =
// i0, W = Lp - i0; a j-window: any j0), it reads the (T, W) f32 buffer of
// K1 (or B3's mi and wog buffers) once and, for element (r, c), pair
// (i, j) = (i0 + r, j0 + c):
//   * store mask: i < L, j < L, j > i and mi > thr (f32 compare);
//   * colmax mask: the first three, plus genome distance > ld, the
//     distance |orig_pos[i] - orig_pos[j]| (min(d, genome - d) on a
//     circular genome) computed per element from the (Lp,) orig_pos;
//   * colmax[j] and colmax[i] take the masked maxima in place;
//   * a survivor is appended as (i, j, mi[, wog]) to the store, wog being
//     B3's where column i or j has gaps and mi elsewhere
//     (_wog_effective, applied to survivors only).
//
// Maxima use one total order on floats: the integer image
// ord_key(x) = bits ^ ((bits >> 31) & 0x7fffffff), monotone in x, with
// -0 below +0.  The atomic on colmax's own float bits is atomicMax on
// the int for a non-negative value and atomicMin on the unsigned for a
// negative one, which is the same order; so the result is exact and does
// not depend on the order in which blocks finish (ops/compact.py's plain
// version uses the same image).
//
// The store: slots [0, cap) of four (or three, without wog) arrays and
// one 64-bit counter of edges appended.  A warp claims slots with one
// atomicAdd for a whole queue of survivors; slots at or past cap are not
// written, but the counter still counts them, so the host sees an
// overflow when it reads the counter and re-runs the rows (the order of
// slots is the order of the atomics; the host sorts them).
//
// What bounds it on the H100: device-memory bytes.  The buffer is read
// once (63 MB at T = 512, W = 30720; twice that with wog), the survivors
// are written once (12 or 16 bytes each), and colmax, orig_pos and gap
// are read once.  Design: a 2-D grid of (column strip of 1024) x (32 rows)
// blocks of 256 threads, four blocks to an SM (so the main path's 480
// blocks run in one wave); each thread owns four neighbouring columns and
// loads them as one float4 per row (neighbouring threads on neighbouring
// addresses), with four rows' loads in flight (two rows of mi and wog).
// A block first bounds its rows' and columns' global indices and genome
// positions: where every pair is valid, above the diagonal and past the
// LD gate (most blocks), an element costs its key, a max and a compare.  Column maxima
// stay in the thread's registers over its 32 rows and row maxima are
// reduced per warp (__reduce_max_sync) and across the block in shared
// memory, so a block makes at most one colmax atomic per column and row
// it touches, and none where its maximum cannot raise colmax.  Survivors
// go first to a per-warp queue in shared memory (a ballot per column
// gives each its slot); a full queue is written out with one counter
// atomic, and at the end the block's queues with one atomic for the
// block.  No mask tensor, no zero-filled lane and no output of row shape
// exist.

#include <limits.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int RS_THREADS = 256;
constexpr int RS_WARPS = RS_THREADS / 32;
constexpr int RS_COLS = 4 * RS_THREADS;  // columns per block: one float4 per thread
constexpr int RS_ROWS = 32;              // rows per block
constexpr int RS_QCAP = 256;             // survivors a warp queues before it writes
constexpr int NEG_INF_KEY = (int)0x807FFFFF;  // ord_key(-inf)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int ord_key(float x) {
    const int b = __float_as_int(x);
    return b ^ ((b >> 31) & 0x7FFFFFFF);
}

__device__ __forceinline__ float key_value(int k) {
    return __int_as_float(k ^ ((k >> 31) & 0x7FFFFFFF));
}

// *p = max(*p, key_value(key)) in ord_key's order, on the float's bits;
// skipped when a plain read shows *p already at least as large (a stale
// read only costs an atomic that changes nothing)
__device__ __forceinline__ void colmax_update(float* p, int key) {
    if (key == NEG_INF_KEY || ord_key(*p) >= key) return;
    if (key >= 0)
        atomicMax(reinterpret_cast<int*>(p), key);
    else
        atomicMin(reinterpret_cast<unsigned*>(p), (unsigned)__float_as_int(key_value(key)));
}

template <bool WOG>
__global__ void __launch_bounds__(RS_THREADS, 4)
row_select_kernel(const float* __restrict__ mi, const float* __restrict__ wog,
                  const uint8_t* __restrict__ gap, const int* __restrict__ orig_pos,
                  float* colmax, int* __restrict__ s_i, int* __restrict__ s_j,
                  float* __restrict__ s_mi, float* __restrict__ s_wog,
                  unsigned long long* __restrict__ count, long long cap, int T, int W,
                  int i0, int j0, int L, float thr, int ld, int circular, int genome) {
    constexpr int UNROLL = WOG ? 2 : 4;  // rows whose loads a thread keeps in flight
    __shared__ int q_i[RS_WARPS][RS_QCAP];
    __shared__ int q_j[RS_WARPS][RS_QCAP];
    __shared__ float q_mi[RS_WARPS][RS_QCAP];
    __shared__ float q_wog[WOG ? RS_WARPS : 1][WOG ? RS_QCAP : 1];
    __shared__ int row_key[RS_WARPS][RS_ROWS];
    __shared__ int bounds[RS_WARPS][4];
    __shared__ int warp_n[RS_WARPS];
    __shared__ unsigned long long block_base;

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned below = (1u << lane) - 1u;
    const int c0 = blockIdx.x * RS_COLS;
    const int c = c0 + threadIdx.x * 4;  // first of this thread's buffer columns
    const int r0 = blockIdx.y * RS_ROWS;
    const bool has_cols = c < W;  // W % 4 == 0: all four columns or none
    const float neg_inf = __int_as_float(0xff800000);

    int pj[4] = {0, 0, 0, 0};
    bool gj[4] = {false, false, false, false};
    int bmin = INT_MAX, bmax = INT_MIN, amin = INT_MAX, amax = INT_MIN;
    if (has_cols) {
        const int4 p = *reinterpret_cast<const int4*>(orig_pos + j0 + c);
        pj[0] = p.x, pj[1] = p.y, pj[2] = p.z, pj[3] = p.w;
        bmin = min(min(p.x, p.y), min(p.z, p.w));
        bmax = max(max(p.x, p.y), max(p.z, p.w));
        if (WOG) {
            const uchar4 g = *reinterpret_cast<const uchar4*>(gap + j0 + c);
            gj[0] = g.x, gj[1] = g.y, gj[2] = g.z, gj[3] = g.w;
        }
    }
    if (threadIdx.x < RS_ROWS && r0 + (int)threadIdx.x < T)
        amin = amax = __ldg(orig_pos + i0 + r0 + threadIdx.x);
    // the block is "inside" when every pair of it is valid, above the
    // diagonal (its last row's global index below its first column's) and
    // past the LD gate: its columns' positions all lie above its rows', so
    // d = pj - pi is bounded by the four extremes
    bmin = __reduce_min_sync(FULL, bmin);
    bmax = __reduce_max_sync(FULL, bmax);
    amin = __reduce_min_sync(FULL, amin);
    amax = __reduce_max_sync(FULL, amax);
    if (lane == 0) bounds[warp][0] = bmin, bounds[warp][1] = bmax, bounds[warp][2] = amin,
                   bounds[warp][3] = amax;
    __syncthreads();
    for (int q = 0; q < RS_WARPS; ++q) {
        bmin = min(bmin, bounds[q][0]), bmax = max(bmax, bounds[q][1]);
        amin = min(amin, bounds[q][2]), amax = max(amax, bounds[q][3]);
    }
    const int r_last = min(r0 + RS_ROWS, T) - 1, c_last = min(c0 + RS_COLS, W) - 1;
    int dmin = bmin - amax;
    if (circular) dmin = min(dmin, genome - (bmax - amin));
    const bool inside = i0 + r_last < j0 + c0 && i0 + r_last < L && j0 + c_last < L &&
                        bmin > amax && dmin > ld;

    int ckey[4] = {NEG_INF_KEY, NEG_INF_KEY, NEG_INF_KEY, NEG_INF_KEY};
    int qn = 0;  // this warp's queued survivors (the same in every lane)

    auto flush = [&]() {
        __syncwarp();
        unsigned long long base = 0;
        if (lane == 0) base = atomicAdd(count, (unsigned long long)qn);
        base = __shfl_sync(FULL, base, 0);
        for (int e = lane; e < qn; e += 32) {
            const unsigned long long dst = base + e;
            if (dst < (unsigned long long)cap) {
                s_i[dst] = q_i[warp][e];
                s_j[dst] = q_j[warp][e];
                s_mi[dst] = q_mi[warp][e];
                if (WOG) s_wog[dst] = q_wog[warp][e];
            }
        }
        __syncwarp();
        qn = 0;
    };

    auto rows = [&](auto inside_tag) {
        constexpr bool INSIDE = decltype(inside_tag)::value;
        for (int rr = 0; rr < RS_ROWS; rr += UNROLL) {
            float4 v[UNROLL], w[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                const int r = r0 + rr + u;
                if (has_cols && r < T) {
                    const long long off = (long long)r * W + c;
                    v[u] = __ldg(reinterpret_cast<const float4*>(mi + off));
                    if (WOG) w[u] = __ldg(reinterpret_cast<const float4*>(wog + off));
                } else {
                    v[u] = make_float4(neg_inf, neg_inf, neg_inf, neg_inf);
                    w[u] = v[u];
                }
            }
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                const int r = r0 + rr + u;
                const int i = i0 + r;
                const bool row_ok = r < T && i < L;
                const bool gi = WOG && r < T && __ldg(gap + i);
                int pi = 0;
                if (!INSIDE && r < T) pi = __ldg(orig_pos + i);
                const float x[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
                const float y[4] = {w[u].x, w[u].y, w[u].z, w[u].w};
                bool keep[4];
                int rkey = NEG_INF_KEY;
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    int key;
                    bool base;
                    if (INSIDE) {
                        base = true;
                        key = ord_key(x[k]);
                    } else {
                        base = row_ok && has_cols && j0 + c + k < L && j0 + c + k > i;
                        int d = abs(pi - pj[k]);
                        if (circular) d = min(d, genome - d);
                        key = base && d > ld ? ord_key(x[k]) : NEG_INF_KEY;
                    }
                    ckey[k] = max(ckey[k], key);
                    rkey = max(rkey, key);
                    keep[k] = base && x[k] > thr;
                }
                rkey = __reduce_max_sync(FULL, rkey);
                if (lane == 0) row_key[warp][rr + u] = rkey;
                if (!__any_sync(FULL, keep[0] || keep[1] || keep[2] || keep[3])) continue;
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const unsigned b = __ballot_sync(FULL, keep[k]);
                    if (b == 0) continue;
                    if (qn + 32 > RS_QCAP) flush();
                    if (keep[k]) {
                        const int pos = qn + __popc(b & below);
                        q_i[warp][pos] = i;
                        q_j[warp][pos] = j0 + c + k;
                        q_mi[warp][pos] = x[k];
                        if (WOG) q_wog[warp][pos] = gi || gj[k] ? y[k] : x[k];
                    }
                    qn += __popc(b);
                }
            }
        }
    };
    if (inside)
        rows(std::true_type{});
    else
        rows(std::false_type{});

    // the block's queues: one counter atomic, each warp at its offset
    if (lane == 0) warp_n[warp] = qn;
    __syncthreads();  // warp_n and row_key complete
    if (threadIdx.x == 0) {
        int total = 0;
        for (int q = 0; q < RS_WARPS; ++q) total += warp_n[q];
        block_base = total ? atomicAdd(count, (unsigned long long)total) : 0ull;
    }
    __syncthreads();
    unsigned long long base = block_base;
    for (int q = 0; q < warp; ++q) base += warp_n[q];
    for (int e = lane; e < qn; e += 32) {
        const unsigned long long dst = base + e;
        if (dst < (unsigned long long)cap) {
            s_i[dst] = q_i[warp][e];
            s_j[dst] = q_j[warp][e];
            s_mi[dst] = q_mi[warp][e];
            if (WOG) s_wog[dst] = q_wog[warp][e];
        }
    }
    if (has_cols) {
#pragma unroll
        for (int k = 0; k < 4; ++k) colmax_update(colmax + j0 + c + k, ckey[k]);
    }
    if (threadIdx.x < RS_ROWS && r0 + (int)threadIdx.x < T) {
        int m = row_key[0][threadIdx.x];
#pragma unroll
        for (int q = 1; q < RS_WARPS; ++q) m = max(m, row_key[q][threadIdx.x]);
        colmax_update(colmax + i0 + r0 + threadIdx.x, m);
    }
}

template <bool WOG>
void launch(const void* mi, const void* wog, const void* gap, const void* orig_pos, void* colmax,
            void* s_i, void* s_j, void* s_mi, void* s_wog, void* count, long long cap, int T,
            int W, int i0, int j0, int L, float thr, int ld, int circular, int genome,
            cudaStream_t st) {
    const dim3 grid((W + RS_COLS - 1) / RS_COLS, (T + RS_ROWS - 1) / RS_ROWS);
    row_select_kernel<WOG><<<grid, RS_THREADS, 0, st>>>(
        (const float*)mi, (const float*)wog, (const uint8_t*)gap, (const int*)orig_pos,
        (float*)colmax, (int*)s_i, (int*)s_j, (float*)s_mi, (float*)s_wog,
        (unsigned long long*)count, cap, T, W, i0, j0, L, thr, ld, circular, genome);
}

}  // namespace

// mi, wog: contiguous (T, W) f32 of rows [i0, i0 + T) and columns [j0, j0 +
// W) (wog null in a lazy sweep; then s_wog is null too), j0 and W
// multiples of 4, both buffers 16-byte aligned; gap:
// (Lp,) bool bytes; orig_pos: (Lp,) int32; colmax: (Lp,) f32, updated in
// place; s_i, s_j, s_mi, s_wog: the store's cap slots; count: its uint64
// counter.  Returns the launch's cudaGetLastError() (0 on success).
extern "C" int spk_row_select(const void* mi, const void* wog, const void* gap,
                              const void* orig_pos, void* colmax, void* s_i, void* s_j,
                              void* s_mi, void* s_wog, void* count, long long cap, int T, int W,
                              int i0, int j0, int L, float thr, int ld, int circular, int genome,
                              void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (wog)
        launch<true>(mi, wog, gap, orig_pos, colmax, s_i, s_j, s_mi, s_wog, count, cap, T, W, i0,
                     j0, L, thr, ld, circular, genome, st);
    else
        launch<false>(mi, wog, gap, orig_pos, colmax, s_i, s_j, s_mi, s_wog, count, cap, T, W,
                      i0, j0, L, thr, ld, circular, genome, st);
    return (int)cudaGetLastError();
}
