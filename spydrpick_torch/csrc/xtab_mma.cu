// Kernels K1 (with-gaps MI tile), B3 (dual MI tile) and B4 (crosstable
// tile) on the tensor cores.  K1's int8 modes run on Hopper's warpgroup
// path (xtab_wgmma.cuh); B3, B4 and K1 in bf16 run on the mma.sync loop
// (xtab_mma.cuh) with their own epilogues.
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
// Bound on the H100, for all three: 2 * 25 * S * TI * TJ * passes
// operations on the tensor cores (1,979 int8 TOP/s, 989 bf16 TFLOP/s
// dense); bytes: one read of the j operand (S * TJ * 5 elements) plus the
// output (K1: TI * TJ f32; B3: twice that; B4: TI * TJ * 25 words).  At
// S=3072, 512 x 30720 that is 2.44 ms for fixed14's two int8 passes
// against 0.16 ms (K1), 0.18 ms (B3) or 0.61 ms (B4) of bytes:
// compute-bound.
//
// K1, int8 (unit and fixed14): mi_tile_mma_kernel<int8_t, Wgmma>.  A block
// of two consumer warpgroups and a producer warpgroup computes the
// crosstable of 64 i-columns x 32 j-columns (320 x 160 slab rows, all 25
// state products) with wgmma.mma_async s8 x s8 -> s32, fed by TMA through
// a 3-stage mbarrier ring (xtab_wgmma.cuh): 213 operations per staged
// byte (the mma.sync tile: 160).  Each consumer thread ends with all 25
// cells of 8 whole pairs in its registers; it converts them as before,
// __fmul_rn(__int2float_rn(c * mlast), acc_scale), into a stash of its own
// in the idle ring and runs the same mi_epilogue over them in one loop,
// so K1's mi equals its plain version, the mma.sync loop's and B3's bit
// for bit.  Tile rules: the wrapper's (TI,
// TJ, bw multiples of 32; K-major operands, rows 16-byte aligned); a TI
// that is an odd multiple of 32 leaves a ragged last i tile, which the
// copy engine fills with zeros and the epilogue skips.  S = 0 has no TMA
// map and takes the mma.sync loop (k1_loop).
//
// B3, B4, and K1 with bf16 operands (the "off" mode, weights spread over
// 32) keep mma.sync m16n8k32 / m16n8k16 over a 3-stage cp.async ring: a
// block computes a 160 x 160 crosstable tile (32 i-columns x 32
// j-columns), so each staged byte feeds 160 products and the copies
// overlap the MMAs.  No cell of the benchmark runs them, so nothing could
// show a change there; their machine code is as it was.  The tile goes
// through shared memory: K1 and B3 convert each count as above and one
// thread per pair calls mi_epilogue, so B3's mi equals K1's bit for bit in
// every mode, and in the int8 modes B4 -> convert -> B5 gives K1's mi and
// B3's wog bit for bit; B4 writes its tile with coalesced 16-byte stores.
// Blocks of both loops run i-fastest, so the blocks in flight share their
// j rows in L2 and the i operand of a launch (at most 2560 rows) stays
// there.

#include "mi_epilogue.cuh"
#include "xtab_mma.cuh"
#include "xtab_wgmma.cuh"

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

// K1 on the wgmma loop (xtab_wgmma.cuh), int8 operands: a 64 x 32 tile of
// pairs a block.  After the loop each consumer thread converts its 200
// cells (8 whole pairs) and stashes them in the idle ring, cell k at
// st[k * 256 + thread] (no bank conflicts, no exchange between threads),
// then runs one epilogue loop over its pairs: one copy of mi_epilogue in
// the machine code instead of eight unrolled over the accumulator
// registers, which did not fit the instruction cache (0.85 against 2.08 ms
// of epilogue a launch at S=3072, 512 x 30720).
struct Wgmma {};

template <typename T, typename Loop>
__global__ void __launch_bounds__(spk_wgmma::NT, 1)
mi_tile_mma_kernel(const __grid_constant__ CUtensorMap tm_hi,
                   const __grid_constant__ CUtensorMap tm_lo,
                   const __grid_constant__ CUtensorMap tm_j, const float* __restrict__ ipf,
                   const float* __restrict__ jpf, float* __restrict__ out, long long ldo, int S,
                   int TI, int bw_i, int bw_j, int nbi, int n_passes, int q, int mlast,
                   float acc_scale, float pc) {
    using spk_wgmma::CONSUMERS, spk_wgmma::JW, spk_wgmma::KC, spk_wgmma::NACC, spk_wgmma::Ring,
        spk_wgmma::TI_W, spk_wgmma::TJ_W;
    extern __shared__ __align__(16) unsigned char smem[];
    const int i0 = (blockIdx.x % nbi) * TI_W, j0 = (blockIdx.x / nbi) * TJ_W;
    const int nk = (S + KC - 1) / KC;
    const Ring ring(smem);
    const int wg = threadIdx.x / 128;  // 0, 1: consumers; 2: the producer
    if (threadIdx.x == 0) ring.init();
    __syncthreads();
    if (wg == 2) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        if (threadIdx.x == CONSUMERS)
            spk_wgmma::produce(ring, &tm_hi, &tm_lo, &tm_j, nk, n_passes, i0, j0, bw_i, bw_j);
        return;
    }
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    int acc[SPK_NS][NACC];
    spk_wgmma::consume(acc, ring, wg, nk, n_passes, q);
    const ToWeight<int> conv{mlast, acc_scale};
    float* st = reinterpret_cast<float*>(
        smem + (ring.base - (uint32_t)__cvta_generic_to_shared(smem)));
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");  // the ring is read
    // pair p of a thread: i-column ri = p / 4, j-column 8 jq + e with
    // jq = p / 2 % 2, e = p % 2 (xtab_wgmma.cuh); cell (t, u) of it is
    // acc[t][(2 u + jq) * 4 + 2 ri + e]
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int t = 0; t < SPK_NS; ++t)
#pragma unroll
            for (int u = 0; u < SPK_NS; ++u)
                st[(p * 25 + t * 5 + u) * CONSUMERS + threadIdx.x] = __uint_as_float(
                    conv(acc[t][(2 * u + ((p >> 1) & 1)) * 4 + 2 * (p >> 2) + (p & 1)]));
    const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
#pragma unroll 1
    for (int p = 0; p < 8; ++p) {
        const int ci = i0 + w * 16 + lane / 4 + 8 * (p >> 2);
        if (ci >= TI) continue;  // the ragged i tile's zero rows
        const int cj = j0 + wg * JW + ((p >> 1) & 1) * 8 + 2 * (lane & 3) + (p & 1);
        float C[SPK_NS][SPK_NS];
#pragma unroll
        for (int k = 0; k < 25; ++k) C[k / 5][k % 5] = st[(p * 25 + k) * CONSUMERS + threadIdx.x];
        float ip[SPK_NS], jp[SPK_NS];
        load_presence(ipf, ci, bw_i, ip);
        load_presence(jpf, cj, bw_j, jp);
        out[(long long)ci * ldo + cj] = mi_epilogue(C, ip, jp, pc);
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

// cuTensorMapEncodeTiled, found through the runtime (the library links no
// libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                                 12000, cudaEnableDefault, &res);
#else
        const cudaError_t err =
            cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
        if (err == cudaSuccess && res == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
    }
    return fn;
}

// The 2-D TMA map of a K-major int8 operand: `rows` rows of S bytes, ld
// bytes apart, read in 128-byte swizzled boxes of 128 bytes x box_rows.
bool operand_map(CUtensorMap* map, const void* x, int S, long long rows, long long ld,
                 int box_rows) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return false;
    const cuuint64_t dims[2] = {(cuuint64_t)S, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)ld};
    const cuuint32_t box[2] = {(cuuint32_t)spk_wgmma::KC, (cuuint32_t)box_rows};
    const cuuint32_t unit[2] = {1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(x), dims, strides, box,
                  unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// K1's main loop for these arguments: 1, the wgmma loop, for int8 operands
// with at least one sample (a TMA map needs one), else 0, the mma.sync
// loop (ops/mi_kernels.py:k1_loop is the same rule).
int k1_loop(int dtype, int S) { return dtype == 0 && S > 0 ? 1 : 0; }

}  // namespace

// K1 on the main loop `loop` (0: mma.sync, 1: wgmma; refused where
// k1_loop would not pick it), otherwise as spk_mi_tile_single.
extern "C" int spk_mi_tile_single_loop(int loop, int dtype, const void* xi_hi, const void* xi_lo,
                                       const void* xj, long long ldi, long long ldj,
                                       const void* ipf, const void* jpf, void* out, long long ldo,
                                       int S, int TI, int TJ, int bw_i, int bw_j, int n_passes,
                                       double m0, double m1, float acc_scale, float pc,
                                       void* stream) {
    if (!shapes_ok(dtype, xi_hi, xi_lo, xj, ldi, ldj, S, TI, TJ, bw_i, bw_j, n_passes) ||
        (loop != 0 && loop != 1) || (loop == 1 && k1_loop(dtype, S) != 1))
        return (int)cudaErrorInvalidValue;
    if (loop == 0)
        return launch_tile(dtype, TI, TJ, n_passes, m0, m1, [&](auto t, auto q, auto ml,
                                                                dim3 grid, int nbi) {
            using T = decltype(t);
            launch(mi_tile_mma_kernel<T>, grid, stream, (const T*)xi_hi, (const T*)xi_lo,
                   (const T*)xj, ldi, ldj, (const float*)ipf, (const float*)jpf, (float*)out,
                   ldo, S, bw_i, bw_j, nbi, n_passes, q, ml, acc_scale, pc);
        });
    using spk_wgmma::I_BOX, spk_wgmma::JW, spk_wgmma::NT, spk_wgmma::SMEM_BYTES, spk_wgmma::TI_W,
        spk_wgmma::TJ_W;
    int q, ml;
    CUtensorMap tm_hi, tm_lo, tm_j;
    if (!pass_split_i8(n_passes, m0, m1, &q, &ml) ||
        !operand_map(&tm_hi, xi_hi, S, 5LL * TI, ldi, I_BOX) ||
        !operand_map(&tm_lo, n_passes == 2 ? xi_lo : xi_hi, S, 5LL * TI, ldi, I_BOX) ||
        !operand_map(&tm_j, xj, S, 5LL * TJ, ldj, JW))
        return (int)cudaErrorInvalidValue;
    const int nbi = (TI + TI_W - 1) / TI_W;
    const dim3 grid((unsigned)((long long)nbi * (TJ / TJ_W)));
    auto kernel = mi_tile_mma_kernel<int8_t, Wgmma>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    kernel<<<grid, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
        tm_hi, tm_lo, tm_j, (const float*)ipf, (const float*)jpf, (float*)out, ldo, S, TI, bw_i,
        bw_j, nbi, n_passes, q, ml, acc_scale, pc);
    return (int)cudaGetLastError();
}

// K1.  dtype: 0 = int8 operands (int32 accumulation), 1 = bf16 operands
// (f32).  Operands are K-major: xi_hi/xi_lo hold TI*5 slab rows of S
// samples with row stride ldi, xj TJ*5 rows with stride ldj (elements;
// each stride a multiple of 16 bytes, pointers 16-byte aligned); TI, TJ,
// bw_i and bw_j multiples of 32; two int8 passes need m1 to divide m0.
// out is (TI, TJ) f32 with row stride ldo.  Returns the launch's
// cudaGetLastError(), or cudaErrorInvalidValue for arguments outside
// these rules (nothing launched).  The main loop is k1_loop's.
extern "C" int spk_mi_tile_single(int dtype, const void* xi_hi, const void* xi_lo, const void* xj,
                                  long long ldi, long long ldj, const void* ipf, const void* jpf,
                                  void* out, long long ldo, int S, int TI, int TJ, int bw_i,
                                  int bw_j, int n_passes, double m0, double m1, float acc_scale,
                                  float pc, void* stream) {
    return spk_mi_tile_single_loop(k1_loop(dtype, S), dtype, xi_hi, xi_lo, xj, ldi, ldj, ipf, jpf,
                                   out, ldo, S, TI, TJ, bw_i, bw_j, n_passes, m0, m1, acc_scale,
                                   pc, stream);
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
