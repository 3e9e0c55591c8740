// Shared helpers for the spydrpick_torch CUDA kernels (sm_90a).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define SPK_NS 5  // states per column: A C G T gap

// Slab layout (spydrpick_tpu/ops/mi_pallas.py:to_slab): within each
// bw-wide column block, state t of column c sits at b*5*bw + t*bw + c%bw.
__device__ __forceinline__ long long spk_slab_col(int c, int bw, int t) {
    return (long long)(c / bw) * (SPK_NS * bw) + (long long)t * bw + (c % bw);
}
