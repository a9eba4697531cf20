// Shared device helpers for the frontend kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace icg {

// Sum over the 32 lanes of a warp. The xor butterfly leaves the same value
// in every lane (each stage adds the same two partial sums in either
// order), so all lanes take identical data-dependent branches afterwards.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

}  // namespace icg
