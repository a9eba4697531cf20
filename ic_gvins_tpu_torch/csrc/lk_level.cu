// One pyramid level of Lucas-Kanade for N features.
//
// Replaces ic_gvins_tpu/ops/pallas_lk.py:lk_level_pallas (the TPU kernel
// behind vision/lk.py:pyr_lk) and follows the semantics of the gather
// reference vision/lk.py:_track_level:
//   - the level is edge-padded by PAD = 12 px (read here by clamping the
//     index; the padded image is never materialized) and the points are
//     shifted by PAD;
//   - a 23x23 bilinear patch at the previous point gives the 21x21 template
//     and its central-difference gradients; extract_patch CLIPS the slice
//     corner inward (pyramid.py:98-100), so near the padded border the
//     window shifts instead of clamping pixel by pixel;
//   - G = [gxx gxy; gxy gyy]; the track is ok when min-eig(G)/441 > 1e-4,
//     |det G| > 1e-12 and the slot is valid;
//   - up to 30 steps d = -G^-1 sum (I_next - T) grad T, each applied before
//     the 0.01 px stop test (cv::calcOpticalFlowPyrLK's criteria).
// There is no block-edge cull: the Pallas kernel's 64x256 staging block is
// a TPU artifact.
//
// What bounds it on the H100: latency. Each iteration's step depends on a
// reduction over the previous step's window, so one feature is a serial
// chain of up to 30 dependent rounds of 441 bilinear samples (1764 cached
// global loads) plus a warp reduction; the level image (at most 5 MB) sits
// in L2. Design: one warp per feature, the 441 window pixels strided over
// its 32 lanes; the template and gradients live in registers (14 pixels
// per lane); the next image is sampled through the read-only cache; bx and
// by are reduced with warp shuffles, which leave the same step in every
// lane, so the whole warp applies it and stops together. Independent
// features in other warps hide the chain's latency.
#include "common.cuh"

namespace {

constexpr int WIN_HALF = 10;
constexpr int WIN = 2 * WIN_HALF + 1;     // 21
constexpr int NPX = WIN * WIN;            // 441
constexpr int PER_LANE = (NPX + 31) / 32; // 14
constexpr int PAD = WIN_HALF + 2;         // 12
constexpr int MAX_ITERS = 30;
constexpr float EPS = 0.01f;
constexpr float MIN_EIG_THRESHOLD = 1e-4f;
constexpr int WARPS_PER_BLOCK = 2;

// Level image seen through an edge padding of PAD pixels.
struct Padded {
    const float* p;
    int H, W;
    __device__ __forceinline__ float operator()(int yy, int xx) const {
        const int y = icg::clampi(yy - PAD, 0, H - 1);
        const int x = icg::clampi(xx - PAD, 0, W - 1);
        return __ldg(p + static_cast<size_t>(y) * W + x);
    }
};

// extract_patch(img, (x, y), half): the patch origin and bilinear weights.
struct Patch {
    int y0, x0;
    float w00, w01, w10, w11;
    __device__ __forceinline__ Patch(float x, float y, int half, int Hp, int Wp) {
        const float ix = floorf(x), iy = floorf(y);
        const float fx = x - ix, fy = y - iy;
        const int size = 2 * half + 1;
        x0 = icg::clampi(static_cast<int>(ix) - half, 0, Wp - (size + 1));
        y0 = icg::clampi(static_cast<int>(iy) - half, 0, Hp - (size + 1));
        w00 = (1.0f - fy) * (1.0f - fx);
        w01 = (1.0f - fy) * fx;
        w10 = fy * (1.0f - fx);
        w11 = fy * fx;
    }
    __device__ __forceinline__ float at(const Padded& img, int i, int j) const {
        const int y = y0 + i, x = x0 + j;
        return w00 * img(y, x) + w01 * img(y, x + 1) + w10 * img(y + 1, x) +
               w11 * img(y + 1, x + 1);
    }
};

__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
lk_level_kernel(const float* __restrict__ prev, const float* __restrict__ next, int H, int W,
                const float* __restrict__ pts_prev, const float* __restrict__ pts_guess,
                const uint8_t* __restrict__ valid, float* __restrict__ pts_out,
                uint8_t* __restrict__ ok_out, int N) {
    const int f = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (f >= N) return;  // uniform per warp
    const int Hp = H + 2 * PAD, Wp = W + 2 * PAD;
    const Padded ip{prev, H, W}, in{next, H, W};

    // template + gradients from the 23x23 patch at the previous point
    const Patch tp(pts_prev[2 * f] + PAD, pts_prev[2 * f + 1] + PAD, WIN_HALF + 1, Hp, Wp);
    float tpl[PER_LANE], gx[PER_LANE], gy[PER_LANE];
    float sxx = 0.0f, syy = 0.0f, sxy = 0.0f;
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
        const int q = lane + 32 * k;
        tpl[k] = gx[k] = gy[k] = 0.0f;
        if (q < NPX) {
            const int i = q / WIN + 1, j = q % WIN + 1;  // window pixel in the 23x23 patch
            tpl[k] = tp.at(ip, i, j);
            gx[k] = 0.5f * (tp.at(ip, i, j + 1) - tp.at(ip, i, j - 1));
            gy[k] = 0.5f * (tp.at(ip, i + 1, j) - tp.at(ip, i - 1, j));
            sxx += gx[k] * gx[k];
            syy += gy[k] * gy[k];
            sxy += gx[k] * gy[k];
        }
    }
    const float gxx = icg::warp_sum(sxx), gyy = icg::warp_sum(syy), gxy = icg::warp_sum(sxy);
    const float det = gxx * gyy - gxy * gxy;
    const float min_eig =
        0.5f * ((gxx + gyy) - sqrtf((gxx - gyy) * (gxx - gyy) + 4.0f * gxy * gxy)) /
        static_cast<float>(NPX);
    const bool ok = (min_eig > MIN_EIG_THRESHOLD) && (fabsf(det) > 1e-12f) && valid[f];
    const float inv_det = fabsf(det) > 1e-12f ? 1.0f / det : 0.0f;

    float x = pts_guess[2 * f] + PAD, y = pts_guess[2 * f + 1] + PAD;
    if (ok) {
        for (int it = 0; it < MAX_ITERS; ++it) {
            const Patch cp(x, y, WIN_HALF, Hp, Wp);
            float bx = 0.0f, by = 0.0f;
#pragma unroll
            for (int k = 0; k < PER_LANE; ++k) {
                const int q = lane + 32 * k;
                if (q < NPX) {
                    const float diff = cp.at(in, q / WIN, q % WIN) - tpl[k];
                    bx += diff * gx[k];
                    by += diff * gy[k];
                }
            }
            bx = icg::warp_sum(bx);
            by = icg::warp_sum(by);
            const float dx = -(gyy * bx - gxy * by) * inv_det;
            const float dy = -(gxx * by - gxy * bx) * inv_det;
            x += dx;
            y += dy;
            if (sqrtf(dx * dx + dy * dy) < EPS) break;
        }
    }
    if (lane == 0) {
        pts_out[2 * f] = x - PAD;
        pts_out[2 * f + 1] = y - PAD;
        ok_out[f] = ok ? 1 : 0;
    }
}

}  // namespace

// prev, next: (H, W) f32 level images; pts_prev, pts_guess: (N, 2) f32 xy in
// level coordinates; valid: (N,) u8. Writes pts_out (N, 2) f32, ok (N,) u8.
extern "C" int lk_level(const void* prev, const void* next, int H, int W, const void* pts_prev,
                        const void* pts_guess, const void* valid, void* pts_out, void* ok_out,
                        int N, void* stream) {
    if (N == 0) return 0;
    const int blocks = (N + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
    lk_level_kernel<<<blocks, 32 * WARPS_PER_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(prev), static_cast<const float*>(next), H, W,
        static_cast<const float*>(pts_prev), static_cast<const float*>(pts_guess),
        static_cast<const uint8_t*>(valid), static_cast<float*>(pts_out),
        static_cast<uint8_t*>(ok_out), N);
    return static_cast<int>(cudaGetLastError());
}
