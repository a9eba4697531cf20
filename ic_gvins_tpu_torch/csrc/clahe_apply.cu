// CLAHE apply: per-pixel 9-LUT lookup + separable bilinear blend.
//
// Replaces ic_gvins_tpu/ops/pallas_clahe.py:clahe_apply_pallas (the TPU
// kernel behind vision/pyramid.py:clahe). For pixel p of tile t with gray
// value v:  out[p] = sum_n w_row[dy] * w_col[dx] * LUT_{t+(dy-1, dx-1)}[v],
// n = 3*dy + dx over the 3x3 neighbouring tiles (edge-clamped), with bf16
// LUT entries and an f32 blend.
//
// What bounds it on the H100: its floor is memory. Each pixel reads one i32
// and writes one f32 (~10 MB per 1278x1022 frame, ~3 us at 3.35 TB/s); the
// 9 lookups hit shared memory. The TPU kernel received a precomputed
// (T, 9, P) f32 weight tensor (~47 MB) and resolved the lookup as a nibble
// one-hot matmul; here the weights are recomputed inline from the pixel
// coordinate (the rule of pyramid.py:_tile_offset_weights) and the lookup
// is a direct shared-memory read, so only the image itself crosses device
// memory. This simple form runs well above that floor (~27 us on an NVIDIA
// H100 80GB HBM3 at 700 W, PERF.md): per-pixel integer division and weight arithmetic,
// the 9 KB LUT staging per tile, and 441 blocks on 132 SMs bound it now.
//
// Design: one block per tile. The block stages its 9 neighbour LUTs
// (9 x 256 bf16 -> f32, 9 KB) in shared memory, then its threads stride
// over the tile's pixels.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int NBINS = 256;
constexpr int THREADS = 256;

// Blend weights over tile offsets {-1, 0, +1} for coordinate `c`: the f32
// arithmetic of pyramid.py:_tile_offset_weights, step by step.
__device__ __forceinline__ void offset_weights(int c, int tn, int tsize, float hi,
                                               float w[3]) {
    float tf = ((static_cast<float>(c) - static_cast<float>(tsize) * 0.5f) + 0.5f) /
               static_cast<float>(tsize);
    tf = fminf(fmaxf(tf, 0.0f), hi);
    float f0 = floorf(tf);
    int i0 = static_cast<int>(f0);
    float f = tf - f0;
    int own = c / tsize;
    int i1 = min(i0 + 1, tn - 1);
    w[0] = w[1] = w[2] = 0.0f;
    w[icg::clampi(i0 - own, -1, 1) + 1] += 1.0f - f;
    w[icg::clampi(i1 - own, -1, 1) + 1] += f;
}

__global__ void __launch_bounds__(THREADS)
clahe_apply_kernel(const int32_t* __restrict__ v, const __nv_bfloat16* __restrict__ lut,
                   float* __restrict__ out, int H, int W, int ty, int tx, int th, int tw,
                   float hi_y, float hi_x) {
    __shared__ float s_lut[9][NBINS];
    const int t = blockIdx.x;
    const int ti = t / tx, tj = t % tx;
    for (int i = threadIdx.x; i < 9 * NBINS; i += THREADS) {
        const int n = i / NBINS, b = i % NBINS;
        const int ni = icg::clampi(ti + n / 3 - 1, 0, ty - 1);
        const int nj = icg::clampi(tj + n % 3 - 1, 0, tx - 1);
        s_lut[n][b] = __bfloat162float(lut[(ni * tx + nj) * NBINS + b]);
    }
    __syncthreads();
    for (int p = threadIdx.x; p < th * tw; p += THREADS) {
        const int y = ti * th + p / tw;
        const int x = tj * tw + p % tw;
        if (y >= H || x >= W) continue;
        float wr[3], wc[3];
        offset_weights(y, ty, th, hi_y, wr);
        offset_weights(x, tx, tw, hi_x, wc);
        const int val = icg::clampi(v[y * W + x], 0, NBINS - 1);
        float acc = 0.0f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) acc += (wr[dy] * wc[dx]) * s_lut[3 * dy + dx][val];
        out[y * W + x] = acc;
    }
}

}  // namespace

// v: (H, W) i32 gray values in [0, 255]; lut: (ty*tx, 256) bf16 per-tile
// transfer functions; out: (H, W) f32. Tiles are th x tw pixels on a
// ty x tx grid; hi_y / hi_x are f32(ty - 1.000001) / f32(tx - 1.000001).
extern "C" int clahe_apply(const void* v, const void* lut, void* out, int H, int W, int ty,
                           int tx, int th, int tw, float hi_y, float hi_x, void* stream) {
    clahe_apply_kernel<<<ty * tx, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(v), static_cast<const __nv_bfloat16*>(lut),
        static_cast<float*>(out), H, W, ty, tx, th, tw, hi_y, hi_x);
    return static_cast<int>(cudaGetLastError());
}
