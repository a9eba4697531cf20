// Subpixel corner refinement (cv::cornerSubPix) for N detected corners.
//
// Replaces ic_gvins_tpu/ops/pallas_subpix.py:subpix_pallas (the TPU kernel
// behind vision/features.py:corner_subpix) and follows the jnp path of
// features.py:corner_subpix (:176-218):
//   - each step samples a 13x13 bilinear patch at the current position from
//     the UNPADDED image; extract_patch clips the 14x14 slice corner inward
//     to clamp(floor(x) - 6, 0, W - 14) (likewise in y), so corners within
//     6-7 px of the edge get a shifted window (reproduced);
//   - central-difference gradients on the 11x11 window, weights
//     exp(-(d/5)^2) per axis, a 2x2 solve for the step toward the gradient
//     centroid (none unless |det| > 1e-12), the step clipped to +-1 px;
//   - up to 20 steps, each applied before the stop test (norm < 0.01 px);
//   - the result is kept only if it moved < 5 px and the slot is valid;
//     invalid slots are left where they are.
// The Pallas kernel's staging-block guard is a TPU artifact and is absent.
//
// What bounds it on the H100: latency. Each step depends on the reductions
// of the previous one, and there are only ~210 corners per detection, so
// the card is mostly idle: their 14x14 slices are ~0.16 MB and the steps of
// a frame ~13.5 MFLOP, ~0.2 us of work. The time is the launch, one staging
// round trip to L2/HBM, and the longest corner's chain of up to 20 steps:
// on an H100 80GB HBM3 at 700 W (PERF.md, tools/kernel_variants.py) 10.7
// us for the slice's 210 corners: 2.8 us for launch and staging, then
// ~0.38 us a step.
//
// Design: one block of THREADS = 128 threads per corner, one window pixel
// each. The block stages the image around the corner's first slice in
// shared memory once (cp.async, all copies in flight together): the slice
// plus MARGIN px a side, clamped to the image like the slice, so near the
// edge the region and extract_patch's clip rule agree by construction. The
// region is a cache of the image: each step takes its slice origin from the
// clip rule unchanged and restages only when that slice leaves the region
// (with MARGIN = ITERS it would hold the whole reach and never restage;
// measured slower). A thread's pixel weight, offsets and tap address are
// fixed before the loop, so a step is 12 shared-memory taps and ~35 float
// operations a pixel (the four bilinear patch values in the plain
// version's arithmetic), with the row pitch = 11 (mod 32) so that a warp's
// taps hit 32 distinct banks. The five sums take interleaved warp-shuffle
// rounds and K1's double-buffered shared totals with one barrier. The chain
// holds no branch but the restage test and the loop: the threads past the
// 121 pixels add exact zeros, the 2x2 solve takes one fast reciprocal
// (within 2 ulp of the division) and a select, the stop test compares the
// squared norm, and the next step's slice origin and weights are computed
// while it resolves. Every thread reads the same totals, takes the same
// step and the same stop decision, so the block leaves together.
//
// World axis: B independent images (the JAX package's vmap over worlds)
// run in one launch on an (N, B) grid; world b reads its image at
// b * H * W and its corners at b * N. An unbatched call is B = 1.
#include "common.cuh"

namespace {

constexpr int HALF = 5;
constexpr int WIN = 2 * HALF + 1;          // 11
constexpr int NPX = WIN * WIN;             // 121
constexpr int SLICE = WIN + 3;             // 14: raw slice of the 13x13 patch
constexpr int ITERS = 20;
constexpr float EPS = 0.01f;
constexpr int THREADS = 128;               // per corner, one block each
constexpr int NWARPS = THREADS / 32;
constexpr int PER_THREAD = (NPX + THREADS - 1) / THREADS;
constexpr int MARGIN = 8;                  // staged region: slice + MARGIN px a side
constexpr int SSZ = SLICE + 2 * MARGIN;
constexpr int PITCH = SSZ + ((11 - SSZ) % 32 + 32) % 32;  // = 11 (mod 32)
constexpr int NSUM = 5;

struct Shared {
    float img[SSZ * PITCH];
    float red[2][NWARPS][NSUM];
};

__device__ __forceinline__ float axis_weight(int d) {
    const float t = static_cast<float>(d) / static_cast<float>(HALF);
    return expf(-(t * t));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

// Copy rows ry0 .. ry0 + rh - 1 and columns rx0 .. rx0 + rw - 1 of the
// image into the staged region; every thread returns once it is there.
__device__ void stage(Shared& sh, const float* __restrict__ img, int W, int ry0, int rx0, int rh,
                      int rw) {
    for (int idx = threadIdx.x; idx < SSZ * SSZ; idx += THREADS) {
        const int r = idx / SSZ, c = idx % SSZ;
        if (r < rh && c < rw)
            cp_async4(sh.img + r * PITCH + c, img + static_cast<size_t>(ry0 + r) * W + rx0 + c);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
}

// Block-wide sums of the NSUM values, the same totals in every thread: the
// values' shuffle rounds interleaved, then (more than one warp) one barrier
// over double-buffered shared partials, summed in the same order by every
// thread. After the butterfly every lane of a warp holds its warp's totals,
// so every lane stores them (one value per address): no branch.
__device__ __forceinline__ void block_sums(float (&v)[NSUM], Shared& sh, int& buf) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        float t[NSUM];
#pragma unroll
        for (int k = 0; k < NSUM; ++k) t[k] = __shfl_xor_sync(0xffffffffu, v[k], o);
#pragma unroll
        for (int k = 0; k < NSUM; ++k) v[k] += t[k];
    }
    if constexpr (NWARPS > 1) {
#pragma unroll
        for (int k = 0; k < NSUM; ++k) sh.red[buf][threadIdx.x >> 5][k] = v[k];
        __syncthreads();
#pragma unroll
        for (int k = 0; k < NSUM; ++k) {
            float s = sh.red[buf][0][k];
#pragma unroll
            for (int w = 1; w < NWARPS; ++w) s += sh.red[buf][w][k];
            v[k] = s;
        }
        buf ^= 1;
    }
}

__global__ void __launch_bounds__(THREADS)
subpix_kernel(const float* __restrict__ img, int H, int W, const float* __restrict__ pts,
              const uint8_t* __restrict__ valid, float* __restrict__ out,
              int* __restrict__ iters_out, int N) {
    __shared__ Shared sh;
    const int c = blockIdx.y * N + blockIdx.x;  // world blockIdx.y, corner blockIdx.x
    const int tid = threadIdx.x;
    img += static_cast<size_t>(blockIdx.y) * H * W;
    const float cx = pts[2 * c], cy = pts[2 * c + 1];
    float x = cx, y = cy;
    int iters = 0;
    if (valid[c]) {
        // this thread's window pixels: weights, offsets, tap addresses. A
        // slot past the window gets weight 0 at offset 0 and adds exact
        // zeros, so the step has no branch on it
        float wgt[PER_THREAD], ddx[PER_THREAD], ddy[PER_THREAD];
        int off[PER_THREAD];
#pragma unroll
        for (int k = 0; k < PER_THREAD; ++k) {
            const int q = tid + THREADS * k;
            const int i = q / WIN, j = q % WIN;
            wgt[k] = q < NPX ? axis_weight(i - HALF) * axis_weight(j - HALF) : 0.0f;
            ddx[k] = static_cast<float>(j - HALF);
            ddy[k] = static_cast<float>(i - HALF);
            off[k] = q < NPX ? i * PITCH + j : 0;
        }
        // the step's slice origin and bilinear weights at (x, y), as
        // extract_patch(img, (x, y), HALF + 1): a 13x13 patch of a 14x14 slice
        int x0, y0;
        float w00, w01, w10, w11;
        auto front = [&] {
            const float fx = x - floorf(x), fy = y - floorf(y);
            x0 = icg::clampi(__float2int_rd(x) - (HALF + 1), 0, W - SLICE);
            y0 = icg::clampi(__float2int_rd(y) - (HALF + 1), 0, H - SLICE);
            w00 = (1.0f - fy) * (1.0f - fx);
            w01 = (1.0f - fy) * fx;
            w10 = fy * (1.0f - fx);
            w11 = fy * fx;
        };
        front();
        // the staged region: the first slice plus MARGIN, clamped to the image
        const int rw = W < SSZ ? W : SSZ, rh = H < SSZ ? H : SSZ;
        int rx0 = icg::clampi(x0 - MARGIN, 0, W - rw), ry0 = icg::clampi(y0 - MARGIN, 0, H - rh);
        stage(sh, img, W, ry0, rx0, rh, rw);
        int buf = 0;
        for (int it = 0; it < ITERS; ++it) {
            if (x0 < rx0 || x0 + SLICE > rx0 + rw || y0 < ry0 || y0 + SLICE > ry0 + rh) {
                // the slice left the staged region: restage around it
                rx0 = icg::clampi(x0 - MARGIN, 0, W - rw);
                ry0 = icg::clampi(y0 - MARGIN, 0, H - rh);
                __syncthreads();  // no thread still reads the old region
                stage(sh, img, W, ry0, rx0, rh, rw);
            }
            const float* s = sh.img + (y0 - ry0) * PITCH + (x0 - rx0);
            float v[NSUM] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int k = 0; k < PER_THREAD; ++k) {
                // window pixel (i, j) is patch pixel (i+1, j+1); patch
                // pixel (a, b) blends slice pixels (a..a+1, b..b+1)
                const float* r = s + off[k];
                const float* r1 = r + PITCH;
                const float* r2 = r + 2 * PITCH;
                const float* r3 = r + 3 * PITCH;
                const float left = w00 * r1[0] + w01 * r1[1] + w10 * r2[0] + w11 * r2[1];
                const float right = w00 * r1[2] + w01 * r1[3] + w10 * r2[2] + w11 * r2[3];
                const float up = w00 * r[1] + w01 * r[2] + w10 * r1[1] + w11 * r1[2];
                const float down = w00 * r2[1] + w01 * r2[2] + w10 * r3[1] + w11 * r3[2];
                const float gx = 0.5f * (right - left);
                const float gy = 0.5f * (down - up);
                const float w = wgt[k];
                const float wxx = w * gx * gx, wyy = w * gy * gy, wxy = w * gx * gy;
                v[0] += wxx;
                v[1] += wyy;
                v[2] += wxy;
                v[3] += wxx * ddx[k] + wxy * ddy[k];
                v[4] += wxy * ddx[k] + wyy * ddy[k];
            }
            block_sums(v, sh, buf);
            const float gxx = v[0], gyy = v[1], gxy = v[2], bx = v[3], by = v[4];
            const float det = gxx * gyy - gxy * gxy;
            // one fast reciprocal (within 2 ulp) for both components and
            // a select: no branch on the chain
            const bool safe = fabsf(det) > 1e-12f;
            const float inv = __fdividef(1.0f, det);
            const float sx = safe ? (gyy * bx - gxy * by) * inv : 0.0f;
            const float sy = safe ? (gxx * by - gxy * bx) * inv : 0.0f;
            const float dx = fminf(fmaxf(sx, -1.0f), 1.0f);
            const float dy = fminf(fmaxf(sy, -1.0f), 1.0f);
            x += dx;
            y += dy;
            ++iters;
            const bool stop = dx * dx + dy * dy < EPS * EPS;  // the norm below EPS
            front();  // the next step's, while the stop test resolves
            if (stop) break;
        }
        // keep the refinement only if it stayed close (guards divergence)
        if (!(sqrtf((x - cx) * (x - cx) + (y - cy) * (y - cy)) < static_cast<float>(HALF))) {
            x = cx;
            y = cy;
        }
    }
    if (tid == 0) {
        out[2 * c] = x;
        out[2 * c + 1] = y;
        if (iters_out != nullptr) iters_out[c] = iters;
    }
}

}  // namespace

// img: (H, W) f32 with H, W >= 14; pts: (N, 2) f32 xy; valid: (N,) u8;
// out: (N, 2) f32; when iters_out is not null, each corner's number of
// steps (N,) i32. With B > 1 every array gains a leading world axis of B
// (img (B, H, W), pts (B, N, 2), ...), all in one launch.
extern "C" int subpix(const void* img, int H, int W, const void* pts, const void* valid, void* out,
                      void* iters_out, int N, int B, void* stream) {
    if (N == 0 || B == 0) return 0;
    if (H < SLICE || W < SLICE) return static_cast<int>(cudaErrorInvalidValue);
    subpix_kernel<<<dim3(N, B), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(img), H, W, static_cast<const float*>(pts),
        static_cast<const uint8_t*>(valid), static_cast<float*>(out),
        static_cast<int*>(iters_out), N);
    return static_cast<int>(cudaGetLastError());
}
