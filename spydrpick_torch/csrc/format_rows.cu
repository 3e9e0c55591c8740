// Kernel B: the couplings row formatter, "{p1} {p2} {dist} {flag} {mi:.6f}\n"
// per edge, in two passes (row lengths, then the rows at their offsets).
//
// Replaces the host's formatter (spydrpick_torch/native/format.cpp, the
// port's copy of spydrpick_tpu/native/format.cpp:42, which the JAX
// package's io/writers.py:write_couplings calls) on the main path: no TPU
// kernel did this work.  The bytes equal snprintf's and Python's:
// integers in decimal with a '-' when negative, the flag as '0' or '1',
// and the MI field as f"{x:.6f}" gives it, the exact binary value
// correctly rounded to six decimals, ties to even.  That field is integer
// arithmetic, not floating point: x = m * 2^-k with m < 2^53, so N = m *
// 10^6 < 2^73 fits an unsigned __int128; q = N >> k, rounded up when the
// remainder exceeds 2^(k-1), or equals it with q odd; for k >= 74, N <
// 2^(k-1) and q = 0.  The field is q / 10^6, '.', and q % 10^6 in six
// digits.  The wrapper (ops/format.py) refuses what this rule does not
// print as snprintf does: NaN, +-inf, negatives, -0.0 and x >= 2^53 / 10^6.
//
// Pass 1 (format_lengths_kernel) writes each row's length; the wrapper's
// cumsum gives the offsets; pass 2 (format_rows_kernel) writes each row.
// In pass 2 a block of 256 threads, one row each, builds its rows in
// shared memory at their offsets relative to the block's first row (at
// most FR_MAXROW bytes a row), then copies that span to the output with
// neighbouring threads on neighbouring bytes, so the device-memory writes
// are coalesced.
//
// What bounds it on the H100: device-memory bytes, each row's 33 input
// bytes (p1, p2, dist, mi, flag) read once and its text (~28 bytes at the
// 30k shape) written once.  The kernel reads the inputs in both passes and
// runs a few dozen integer divisions by constants (a multiply-high each)
// per row; it reaches 10-14% of that bound at the 30k shape (PERF.md).

#include "common.cuh"

namespace {

constexpr int FR_THREADS = 256;
// the longest row: three 20-character int64 fields, the flag, the MI
// field (10 integer digits below 2^53 / 10^6, '.', 6), 4 spaces, '\n'
constexpr int FR_MAXROW = 3 * 20 + 1 + 17 + 4 + 1;

__device__ __forceinline__ int u64_digits(unsigned long long u) {
    int n = 1;
    while (u >= 10) {
        u /= 10;
        ++n;
    }
    return n;
}

__device__ __forceinline__ unsigned long long magnitude(long long v) {
    return v < 0 ? 0ull - (unsigned long long)v : (unsigned long long)v;
}

__device__ __forceinline__ int i64_len(long long v) {
    return (v < 0 ? 1 : 0) + u64_digits(magnitude(v));
}

// round-half-even of x * 10^6 for finite x, +0.0 <= x < 2^53 / 10^6
__device__ __forceinline__ unsigned long long mi_micro(double x) {
    const unsigned long long bits = (unsigned long long)__double_as_longlong(x);
    if (bits == 0) return 0;
    const int eb = (int)((bits >> 52) & 0x7ff);
    unsigned long long m = bits & ((1ull << 52) - 1);
    int k = 1074;  // subnormal: x = m * 2^-1074
    if (eb) {
        m |= 1ull << 52;
        k = 1075 - eb;  // >= 19 below 2^53 / 10^6
    }
    if (k >= 74) return 0;
    const unsigned __int128 N = (unsigned __int128)m * 1000000u;
    unsigned long long q = (unsigned long long)(N >> k);
    const unsigned __int128 r = N & ((((unsigned __int128)1) << k) - 1);
    const unsigned __int128 half = ((unsigned __int128)1) << (k - 1);
    if (r > half || (r == half && (q & 1))) ++q;
    return q;
}

__device__ __forceinline__ int row_length(long long p1, long long p2, long long d,
                                          unsigned long long q) {
    return i64_len(p1) + i64_len(p2) + i64_len(d) + u64_digits(q / 1000000u) + 7 + 1 + 5;
}

// writes u's n digits ending just before `end`
__device__ __forceinline__ void put_digits(char* end, unsigned long long u, int n) {
    for (int i = 1; i <= n; ++i) {
        end[-i] = (char)('0' + (int)(u % 10));
        u /= 10;
    }
}

__device__ __forceinline__ char* put_i64(char* p, long long v) {
    if (v < 0) *p++ = '-';
    const unsigned long long u = magnitude(v);
    const int n = u64_digits(u);
    put_digits(p + n, u, n);
    return p + n;
}

__global__ void __launch_bounds__(FR_THREADS)
format_lengths_kernel(const long long* __restrict__ p1, const long long* __restrict__ p2,
                      const long long* __restrict__ dist, const double* __restrict__ mi,
                      long long n, int* __restrict__ len) {
    const long long k = (long long)blockIdx.x * FR_THREADS + threadIdx.x;
    if (k >= n) return;
    len[k] = row_length(p1[k], p2[k], dist[k], mi_micro(mi[k]));
}

__global__ void __launch_bounds__(FR_THREADS)
format_rows_kernel(const long long* __restrict__ p1, const long long* __restrict__ p2,
                   const long long* __restrict__ dist, const unsigned char* __restrict__ flags,
                   const double* __restrict__ mi, long long n,
                   const long long* __restrict__ starts, unsigned char* __restrict__ out) {
    __shared__ char buf[FR_THREADS * FR_MAXROW];
    const long long first = (long long)blockIdx.x * FR_THREADS;
    const long long last = min(first + FR_THREADS, n);  // rows [first, last)
    const long long k = first + threadIdx.x;
    const long long base = starts[first];
    if (k < last) {
        char* p = buf + (starts[k] - base);
        p = put_i64(p, p1[k]);
        *p++ = ' ';
        p = put_i64(p, p2[k]);
        *p++ = ' ';
        p = put_i64(p, dist[k]);
        *p++ = ' ';
        *p++ = flags[k] ? '1' : '0';
        *p++ = ' ';
        const unsigned long long q = mi_micro(mi[k]);
        const unsigned long long ip = q / 1000000u;
        const int n_ip = u64_digits(ip);
        put_digits(p + n_ip, ip, n_ip);
        p += n_ip;
        *p++ = '.';
        put_digits(p + 6, q % 1000000u, 6);
        p += 6;
        *p = '\n';
    }
    __syncthreads();
    const int span = (int)(starts[last] - base);
    for (int i = threadIdx.x; i < span; i += FR_THREADS) out[base + i] = (unsigned char)buf[i];
}

}  // namespace

// p1, p2, dist: (n,) int64; mi: (n,) f64; len: (n,) int32.
extern "C" int spk_format_lengths(const void* p1, const void* p2, const void* dist,
                                  const void* mi, long long n, void* len, void* stream) {
    if (n <= 0) return 0;
    const long long blocks = (n + FR_THREADS - 1) / FR_THREADS;
    format_lengths_kernel<<<(unsigned)blocks, FR_THREADS, 0, (cudaStream_t)stream>>>(
        (const long long*)p1, (const long long*)p2, (const long long*)dist, (const double*)mi,
        n, (int*)len);
    return (int)cudaGetLastError();
}

// flags: (n,) uint8; starts: (n + 1,) int64, starts[0] = 0 and starts[k + 1]
// - starts[k] row k's length; out: starts[n] bytes.
extern "C" int spk_format_rows(const void* p1, const void* p2, const void* dist,
                               const void* flags, const void* mi, long long n,
                               const void* starts, void* out, void* stream) {
    if (n <= 0) return 0;
    const long long blocks = (n + FR_THREADS - 1) / FR_THREADS;
    format_rows_kernel<<<(unsigned)blocks, FR_THREADS, 0, (cudaStream_t)stream>>>(
        (const long long*)p1, (const long long*)p2, (const long long*)dist,
        (const unsigned char*)flags, (const double*)mi, n, (const long long*)starts,
        (unsigned char*)out);
    return (int)cudaGetLastError();
}
