// Kernels K1 (with-gaps MI tile), B3 (dual MI tile) and B4 (crosstable
// tile) on the tensor cores: one main loop (xtab_mma.cuh) with three
// epilogues.
//
// K1 replaces spydrpick_tpu/ops/mi_pallas.py:mi_tile_pallas_single (its
// serial schedule; the deferred one is a TPU MXU/VPU overlap with
// bit-identical results): the (TI, TJ) f32 MI of every column pair from
// the weighted crosstable and the fused entropy epilogue of _mi_from_block
// (mi_pallas.py:88-121).  B3 replaces mi_pallas.py:mi_tile_pallas (body
// _kernel): the same crosstable, with the epilogue run twice, once with
// the presence (mi) and once with the presence whose gap bit is cleared
// (wog).  B4 replaces mi_pallas.py:crosstab_tile_pallas (body
// _xtab_kernel): the (TI*5, TJ*5) slab crosstable itself, unscaled, int32
// for int8 operands (so sample shards sum it exactly) and f32 for bf16
// operands.
//
// Bound on the H100, for all three: 2 * S * 25 * TI * TJ * passes
// operations on the tensor cores (1,979 int8 TOP/s, 989 bf16 TFLOP/s
// dense); bytes: one read of the j operand (S * TJ * 5 elements) plus the
// output (K1: TI * TJ f32; B3: twice that; B4: TI * TJ * 25 words).  At
// S=3072, 512 x 30720 that is 2.44 ms for fixed14's two int8 passes
// against 0.16 ms (K1), 0.18 ms (B3) or 0.61 ms (B4) of bytes:
// compute-bound.
//
// What the design does about it: a block computes a 160 x 160 crosstable
// tile (32 i-columns x 32 j-columns, all 5 x 5 states) with mma.sync over
// a 3-stage cp.async ring (xtab_mma.cuh), so each staged byte feeds 160
// products and the copies overlap the MMAs.  The tile then goes through
// shared memory: K1 and B3 convert each count as before,
// __fmul_rn(__int2float_rn(c), acc_scale), and one thread per pair calls
// the same mi_epilogue as B5, so B3's mi equals K1's bit for bit in every
// mode, and in the int8 modes K1's mi equals its plain version and
// B4 -> convert -> B5 gives K1's mi and B3's wog bit for bit; B4 writes
// its tile with coalesced 16-byte stores.  Blocks run i-fastest, so the
// blocks in flight share their j rows in L2 and the i operand of a launch
// (at most 2560 rows) stays there.

#include "mi_epilogue.cuh"
#include "xtab_mma.cuh"

namespace {

using namespace spk_mma;

// K1's conversion of a count to weight units: the rounding of the scalar
// kernel it replaced (int8: one f32 rounding of the exact integer, one
// f32 multiply).
template <typename Acc>
struct ToWeight;

template <>
struct ToWeight<int> {
    int m;
    float acc_scale;
    __device__ __forceinline__ uint32_t operator()(int v) const {
        return __float_as_uint(__fmul_rn(__int2float_rn(v * m), acc_scale));
    }
};

template <>
struct ToWeight<float> {
    float m;
    float acc_scale;
    __device__ __forceinline__ uint32_t operator()(float v) const {
        const float c = m == 1.f ? v : __fmul_rn(v, m);
        return __float_as_uint(acc_scale == 1.f ? c : __fmul_rn(c, acc_scale));
    }
};

// B4's result: the count (int32) or sum (f32) times the last pass's
// multiplier.
template <typename Acc>
struct Unscaled;

template <>
struct Unscaled<int> {
    int m;
    __device__ __forceinline__ uint32_t operator()(int v) const { return (uint32_t)(v * m); }
};

template <>
struct Unscaled<float> {
    float m;
    __device__ __forceinline__ uint32_t operator()(float v) const {
        return __float_as_uint(m == 1.f ? v : __fmul_rn(v, m));
    }
};

template <typename T>
__global__ void __launch_bounds__(NT, 1)
mi_tile_mma_kernel(const T* __restrict__ xi_hi, const T* __restrict__ xi_lo,
                   const T* __restrict__ xj, long long ldi, long long ldj,
                   const float* __restrict__ ipf, const float* __restrict__ jpf,
                   float* __restrict__ out, long long ldo, int S, int bw_i, int bw_j, int nbi,
                   int n_passes, typename Mma<T>::Acc q, typename Mma<T>::Acc mlast,
                   float acc_scale, float pc) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int i0 = (blockIdx.x % nbi) * TC, j0 = (blockIdx.x / nbi) * TC;
    typename Mma<T>::Acc acc[MI][NI][4];
    crosstab_tile<T>(acc, xi_hi, xi_lo, xj, ldi, ldj, S, bw_i, bw_j, i0, j0, n_passes, q, smem);
    uint32_t* cs = reinterpret_cast<uint32_t*>(smem);
    store_tile<T>(acc, cs, ToWeight<typename Mma<T>::Acc>{mlast, acc_scale});
    __syncthreads();
    for (int p = threadIdx.x; p < TC * TC; p += NT) {
        const int ci = p / TC, cj = p % TC;  // a warp: one i, 32 neighbouring j
        float C[SPK_NS][SPK_NS];
#pragma unroll
        for (int t = 0; t < SPK_NS; ++t)
#pragma unroll
            for (int u = 0; u < SPK_NS; ++u)
                C[t][u] = __uint_as_float(cs[(t * TC + ci) * CPITCH + u * TC + cj]);
        float ip[SPK_NS], jp[SPK_NS];
        load_presence(ipf, i0 + ci, bw_i, ip);
        load_presence(jpf, j0 + cj, bw_j, jp);
        out[(long long)(i0 + ci) * ldo + j0 + cj] = mi_epilogue(C, ip, jp, pc);
    }
}

// B3: K1's tile and conversion, then each pair's 25 cells read once and
// the epilogue run twice, with the presence (out) and with the wo-gaps
// presence (out_wog, which shares out's row stride).  A kernel of its own:
// K1's parameters and body stay as they were measured.
template <typename T>
__global__ void __launch_bounds__(NT, 1)
mi_tile_dual_mma_kernel(const T* __restrict__ xi_hi, const T* __restrict__ xi_lo,
                        const T* __restrict__ xj, long long ldi, long long ldj,
                        const float* __restrict__ ipf, const float* __restrict__ jpf,
                        const float* __restrict__ ipwf, const float* __restrict__ jpwf,
                        float* __restrict__ out, float* __restrict__ out_wog, long long ldo,
                        int S, int bw_i, int bw_j, int nbi, int n_passes,
                        typename Mma<T>::Acc q, typename Mma<T>::Acc mlast, float acc_scale,
                        float pc) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int i0 = (blockIdx.x % nbi) * TC, j0 = (blockIdx.x / nbi) * TC;
    typename Mma<T>::Acc acc[MI][NI][4];
    crosstab_tile<T>(acc, xi_hi, xi_lo, xj, ldi, ldj, S, bw_i, bw_j, i0, j0, n_passes, q, smem);
    uint32_t* cs = reinterpret_cast<uint32_t*>(smem);
    store_tile<T>(acc, cs, ToWeight<typename Mma<T>::Acc>{mlast, acc_scale});
    __syncthreads();
    for (int p = threadIdx.x; p < TC * TC; p += NT) {
        const int ci = p / TC, cj = p % TC;
        float C[SPK_NS][SPK_NS];
#pragma unroll
        for (int t = 0; t < SPK_NS; ++t)
#pragma unroll
            for (int u = 0; u < SPK_NS; ++u)
                C[t][u] = __uint_as_float(cs[(t * TC + ci) * CPITCH + u * TC + cj]);
        float ip[SPK_NS], jp[SPK_NS];
        const long long o = (long long)(i0 + ci) * ldo + j0 + cj;
        load_presence(ipf, i0 + ci, bw_i, ip);
        load_presence(jpf, j0 + cj, bw_j, jp);
        out[o] = mi_epilogue(C, ip, jp, pc);
        load_presence(ipwf, i0 + ci, bw_i, ip);
        load_presence(jpwf, j0 + cj, bw_j, jp);
        out_wog[o] = mi_epilogue(C, ip, jp, pc);
    }
}

template <typename T>
__global__ void __launch_bounds__(NT, 1)
crosstab_mma_kernel(const T* __restrict__ xi_hi, const T* __restrict__ xi_lo,
                    const T* __restrict__ xj, long long ldi, long long ldj,
                    uint32_t* __restrict__ out, long long ldc, int S, int bw_i, int bw_j, int nbi,
                    int n_passes, typename Mma<T>::Acc q, typename Mma<T>::Acc mlast) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int i0 = (blockIdx.x % nbi) * TC, j0 = (blockIdx.x / nbi) * TC;
    typename Mma<T>::Acc acc[MI][NI][4];
    crosstab_tile<T>(acc, xi_hi, xi_lo, xj, ldi, ldj, S, bw_i, bw_j, i0, j0, n_passes, q, smem);
    uint32_t* cs = reinterpret_cast<uint32_t*>(smem);
    store_tile<T>(acc, cs, Unscaled<typename Mma<T>::Acc>{mlast});
    __syncthreads();
    // a tile row is 5 runs of 32 words in the output (one per j-state):
    // 8 threads store each run as 16-byte vectors
    constexpr int VROW = ROWS / 4;
    for (int v = threadIdx.x; v < ROWS * VROW; v += NT) {
        const int r = v / VROW, u = (v % VROW) / (TC / 4), w = v % (TC / 4);
        const uint4 val = *reinterpret_cast<const uint4*>(cs + r * CPITCH + u * TC + 4 * w);
        *reinterpret_cast<uint4*>(out + slab_row(i0, bw_i, r) * ldc +
                                  spk_slab_col(j0 + 4 * w, bw_j, u)) = val;
    }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The operand and shape rules of the three kernels; false for a launch they
// cannot run (the wrappers in ops/mi_kernels.py never make one).
bool shapes_ok(int dtype, const void* xi_hi, const void* xi_lo, const void* xj, long long ldi,
               long long ldj, int S, int TI, int TJ, int bw_i, int bw_j, int n_passes) {
    const long long esz = dtype == 0 ? 1 : 2;
    return S >= 0 && TI % TC == 0 && TJ % TC == 0 && bw_i % TC == 0 && bw_j % TC == 0 &&
           (n_passes == 1 || n_passes == 2) && ldi * esz % 16 == 0 && ldj * esz % 16 == 0 &&
           aligned16(xi_hi) && aligned16(xi_lo) && aligned16(xj);
}

// Horner split of the pass multipliers: q = m0 / m1 and the last pass's
// multiplier (int8: false unless m1 divides m0).
bool pass_split_i8(int n_passes, double m0, double m1, int* q, int* mlast) {
    const int a = (int)m0, b = (int)m1;
    if (n_passes == 1) {
        *q = 1;
        *mlast = a;
        return true;
    }
    if (b == 0 || a % b != 0) return false;
    *q = a / b;
    *mlast = b;
    return true;
}

void pass_split_f32(int n_passes, double m0, double m1, float* q, float* mlast) {
    *q = n_passes == 2 ? (float)(m0 / m1) : 1.f;
    *mlast = (float)(n_passes == 2 ? m1 : m0);
}

// The launch of one of the three kernels on a (TI, TJ) tile of dtype's
// operands (0: int8, 1: bf16): the pass split (int8: refused unless m1
// divides m0), the grid, then go(T{}, q, mlast, grid, nbi) with T the
// operand type; returns cudaGetLastError().
template <typename Go>
int launch_tile(int dtype, int TI, int TJ, int n_passes, double m0, double m1, Go go) {
    const int nbi = TI / TC;
    const dim3 grid((unsigned)((long long)nbi * (TJ / TC)));
    if (dtype == 0) {
        int q, ml;
        if (!pass_split_i8(n_passes, m0, m1, &q, &ml)) return (int)cudaErrorInvalidValue;
        go(int8_t{}, q, ml, grid, nbi);
    } else {
        float q, ml;
        pass_split_f32(n_passes, m0, m1, &q, &ml);
        go(__nv_bfloat16{}, q, ml, grid, nbi);
    }
    return (int)cudaGetLastError();
}

// Kernel instance k on grid with NT threads and SMEM_BYTES of dynamic
// shared memory, in stream.
template <typename Kernel, typename... Args>
void launch(Kernel k, dim3 grid, void* stream, Args... args) {
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    k<<<grid, NT, SMEM_BYTES, (cudaStream_t)stream>>>(args...);
}

}  // namespace

// K1.  dtype: 0 = int8 operands (int32 accumulation), 1 = bf16 operands
// (f32).  Operands are K-major: xi_hi/xi_lo hold TI*5 slab rows of S
// samples with row stride ldi, xj TJ*5 rows with stride ldj (elements;
// each stride a multiple of 16 bytes, pointers 16-byte aligned); TI, TJ,
// bw_i and bw_j multiples of 32; two int8 passes need m1 to divide m0.
// out is (TI, TJ) f32 with row stride ldo.  Returns the launch's
// cudaGetLastError(), or cudaErrorInvalidValue for arguments outside
// these rules (nothing launched).
extern "C" int spk_mi_tile_single(int dtype, const void* xi_hi, const void* xi_lo, const void* xj,
                                  long long ldi, long long ldj, const void* ipf, const void* jpf,
                                  void* out, long long ldo, int S, int TI, int TJ, int bw_i,
                                  int bw_j, int n_passes, double m0, double m1, float acc_scale,
                                  float pc, void* stream) {
    if (!shapes_ok(dtype, xi_hi, xi_lo, xj, ldi, ldj, S, TI, TJ, bw_i, bw_j, n_passes))
        return (int)cudaErrorInvalidValue;
    return launch_tile(dtype, TI, TJ, n_passes, m0, m1, [&](auto t, auto q, auto ml, dim3 grid,
                                                            int nbi) {
        using T = decltype(t);
        launch(mi_tile_mma_kernel<T>, grid, stream, (const T*)xi_hi, (const T*)xi_lo,
               (const T*)xj, ldi, ldj, (const float*)ipf, (const float*)jpf, (float*)out, ldo, S,
               bw_i, bw_j, nbi, n_passes, q, ml, acc_scale, pc);
    });
}

// B3.  Operands and rules as for spk_mi_tile_single; ipwf/jpwf are the
// slab presence with the gap bit cleared and out_wog, like out, is (TI, TJ)
// f32 with row stride ldo.
extern "C" int spk_mi_tile_dual(int dtype, const void* xi_hi, const void* xi_lo, const void* xj,
                                long long ldi, long long ldj, const void* ipf, const void* jpf,
                                const void* ipwf, const void* jpwf, void* out, void* out_wog,
                                long long ldo, int S, int TI, int TJ, int bw_i, int bw_j,
                                int n_passes, double m0, double m1, float acc_scale, float pc,
                                void* stream) {
    if (!shapes_ok(dtype, xi_hi, xi_lo, xj, ldi, ldj, S, TI, TJ, bw_i, bw_j, n_passes))
        return (int)cudaErrorInvalidValue;
    return launch_tile(dtype, TI, TJ, n_passes, m0, m1, [&](auto t, auto q, auto ml, dim3 grid,
                                                            int nbi) {
        using T = decltype(t);
        launch(mi_tile_dual_mma_kernel<T>, grid, stream, (const T*)xi_hi, (const T*)xi_lo,
               (const T*)xj, ldi, ldj, (const float*)ipf, (const float*)jpf, (const float*)ipwf,
               (const float*)jpwf, (float*)out, (float*)out_wog, ldo, S, bw_i, bw_j, nbi,
               n_passes, q, ml, acc_scale, pc);
    });
}

// B4.  Operands as for spk_mi_tile_single; out is the (TI*5, TJ*5) slab
// crosstable, int32 (dtype 0) or f32 (dtype 1), row stride ldc (a
// multiple of 4, out 16-byte aligned).
extern "C" int spk_crosstab_tile(int dtype, const void* xi_hi, const void* xi_lo, const void* xj,
                                 long long ldi, long long ldj, void* out, long long ldc, int S,
                                 int TI, int TJ, int bw_i, int bw_j, int n_passes, double m0,
                                 double m1, void* stream) {
    if (!shapes_ok(dtype, xi_hi, xi_lo, xj, ldi, ldj, S, TI, TJ, bw_i, bw_j, n_passes) ||
        ldc % 4 != 0 || !aligned16(out))
        return (int)cudaErrorInvalidValue;
    return launch_tile(dtype, TI, TJ, n_passes, m0, m1, [&](auto t, auto q, auto ml, dim3 grid,
                                                            int nbi) {
        using T = decltype(t);
        launch(crosstab_mma_kernel<T>, grid, stream, (const T*)xi_hi, (const T*)xi_lo,
               (const T*)xj, ldi, ldj, (uint32_t*)out, ldc, S, bw_i, bw_j, nbi, n_passes, q, ml);
    });
}
