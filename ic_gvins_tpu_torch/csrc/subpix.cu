// Subpixel corner refinement (cv::cornerSubPix) for N detected corners.
//
// Replaces ic_gvins_tpu/ops/pallas_subpix.py:subpix_pallas (the TPU kernel
// behind vision/features.py:corner_subpix) and follows the jnp path of
// features.py:corner_subpix (:176-218):
//   - each step samples a 13x13 bilinear patch at the current position from
//     the UNPADDED image; extract_patch clips the slice corner inward, so
//     corners within 6 px of the edge get a shifted window (reproduced);
//   - central-difference gradients on the 11x11 window, weights
//     exp(-(d/5)^2) per axis, a 2x2 solve for the step toward the gradient
//     centroid, the step clipped to +-1 px;
//   - up to 20 steps, stopping after the first one below 0.01 px;
//   - the result is kept only if it moved < 5 px and the slot is valid.
// The Pallas kernel's staging-block guard is a TPU artifact and is absent.
//
// What bounds it on the H100: latency, as for LK (lk_pyr): each step depends
// on the reductions of the previous one (20 serial rounds of 121 window
// pixels x 4 bilinear samples). There are only ~210 corners per detection,
// so the card is mostly idle: their 14x14 slices are ~0.16 MB and the steps
// of a frame ~13.5 MFLOP, ~0.2 us of work against ~22 us (PERF.md). The
// design keeps each chain short instead.
// Design: one warp per corner, the 121 window pixels strided over its 32
// lanes (4 each), samples through the read-only cache, five warp-shuffle
// reductions per step that leave the same step in every lane.
#include "common.cuh"

namespace {

constexpr int HALF = 5;
constexpr int WIN = 2 * HALF + 1;          // 11
constexpr int NPX = WIN * WIN;             // 121
constexpr int PER_LANE = (NPX + 31) / 32;  // 4
constexpr int ITERS = 20;
constexpr float EPS = 0.01f;
constexpr int WARPS_PER_BLOCK = 2;

__device__ __forceinline__ float axis_weight(int d) {
    const float t = static_cast<float>(d) / static_cast<float>(HALF);
    return expf(-(t * t));
}

__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
subpix_kernel(const float* __restrict__ img, int H, int W, const float* __restrict__ pts,
              const uint8_t* __restrict__ valid, float* __restrict__ out,
              int* __restrict__ iters_out, int N) {
    const int c = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (c >= N) return;  // uniform per warp
    const float cx = pts[2 * c], cy = pts[2 * c + 1];
    float x = cx, y = cy;
    int iters = 0;
    if (valid[c]) {
        for (int it = 0; it < ITERS; ++it) {
            // extract_patch(img, (x, y), HALF + 1): 13x13 patch, 14x14 slice
            const float ix = floorf(x), iy = floorf(y);
            const float fx = x - ix, fy = y - iy;
            const int x0 = icg::clampi(static_cast<int>(ix) - (HALF + 1), 0, W - (WIN + 3));
            const int y0 = icg::clampi(static_cast<int>(iy) - (HALF + 1), 0, H - (WIN + 3));
            const float w00 = (1.0f - fy) * (1.0f - fx), w01 = (1.0f - fy) * fx;
            const float w10 = fy * (1.0f - fx), w11 = fy * fx;
            auto patch = [&](int i, int j) {
                const float* r0 = img + static_cast<size_t>(y0 + i) * W + (x0 + j);
                const float* r1 = r0 + W;
                return w00 * __ldg(r0) + w01 * __ldg(r0 + 1) + w10 * __ldg(r1) +
                       w11 * __ldg(r1 + 1);
            };
            float sxx = 0.0f, syy = 0.0f, sxy = 0.0f, sbx = 0.0f, sby = 0.0f;
#pragma unroll
            for (int k = 0; k < PER_LANE; ++k) {
                const int q = lane + 32 * k;
                if (q < NPX) {
                    const int i = q / WIN, j = q % WIN;  // window pixel; patch pixel (i+1, j+1)
                    const float gx = 0.5f * (patch(i + 1, j + 2) - patch(i + 1, j));
                    const float gy = 0.5f * (patch(i + 2, j + 1) - patch(i, j + 1));
                    const float w = axis_weight(i - HALF) * axis_weight(j - HALF);
                    const float wxx = w * gx * gx, wyy = w * gy * gy, wxy = w * gx * gy;
                    const float ddx = static_cast<float>(j - HALF);
                    const float ddy = static_cast<float>(i - HALF);
                    sxx += wxx;
                    syy += wyy;
                    sxy += wxy;
                    sbx += wxx * ddx + wxy * ddy;
                    sby += wxy * ddx + wyy * ddy;
                }
            }
            const float gxx = icg::warp_sum(sxx), gyy = icg::warp_sum(syy);
            const float gxy = icg::warp_sum(sxy);
            const float bx = icg::warp_sum(sbx), by = icg::warp_sum(sby);
            const float det = gxx * gyy - gxy * gxy;
            const bool safe = fabsf(det) > 1e-12f;
            const float sx = safe ? (gyy * bx - gxy * by) / det : 0.0f;
            const float sy = safe ? (gxx * by - gxy * bx) / det : 0.0f;
            const float dx = fminf(fmaxf(sx, -1.0f), 1.0f);
            const float dy = fminf(fmaxf(sy, -1.0f), 1.0f);
            x += dx;
            y += dy;
            ++iters;
            if (sqrtf(dx * dx + dy * dy) < EPS) break;
        }
        // keep the refinement only if it stayed close (guards divergence)
        if (!(sqrtf((x - cx) * (x - cx) + (y - cy) * (y - cy)) < static_cast<float>(HALF))) {
            x = cx;
            y = cy;
        }
    }
    if (lane == 0) {
        out[2 * c] = x;
        out[2 * c + 1] = y;
        if (iters_out != nullptr) iters_out[c] = iters;
    }
}

}  // namespace

// img: (H, W) f32; pts: (N, 2) f32 xy; valid: (N,) u8; out: (N, 2) f32;
// when iters_out is not null, each corner's number of steps (N,) i32.
extern "C" int subpix(const void* img, int H, int W, const void* pts, const void* valid, void* out,
                      void* iters_out, int N, void* stream) {
    if (N == 0) return 0;
    const int blocks = (N + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
    subpix_kernel<<<blocks, 32 * WARPS_PER_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(img), H, W, static_cast<const float*>(pts),
        static_cast<const uint8_t*>(valid), static_cast<float*>(out),
        static_cast<int*>(iters_out), N);
    return static_cast<int>(cudaGetLastError());
}
