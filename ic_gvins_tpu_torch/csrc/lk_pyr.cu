// The whole bidirectional pyramidal Lucas-Kanade track of one frame, for N
// feature slots, in one launch.
//
// Replaces ic_gvins_tpu/ops/pallas_lk.py:lk_level_pallas (the TPU kernel
// behind vision/lk.py:pyr_lk) together with the cascade around it: for each
// slot it runs what ops/lk.py:lk_pyr_plain composes from lk_level_plain.
//   - forward: levels L-1 .. 0 at pts_prev / 2^l from pts_pred / 2^(L-1),
//     each level gated by the ORIGINAL valid flag (a slot whose template
//     fails at a coarse level keeps its guess and is still tracked below);
//     guess *= 2 between levels; status = AND of the level oks, then the
//     in-bounds test on level 0;
//   - backward (directions == 2): the same from the forward result toward
//     pts_prev, gated by valid & forward status; then ok = both statuses,
//     forward-backward distance < fb_threshold, the forward point not within
//     `border` px of the edge, and valid.
// One level follows the gather reference vision/lk.py:_track_level:
//   - the level is edge-padded by PAD = 12 px (read here by clamping the
//     index; the padded image is never materialized) and the points are
//     shifted by PAD;
//   - a 23x23 bilinear patch at the previous point gives the 21x21 template
//     and its central-difference gradients; extract_patch CLIPS the slice
//     corner inward (pyramid.py:98-100), so near the padded border the
//     window shifts instead of clamping pixel by pixel;
//   - G = [gxx gxy; gxy gyy]; the level is ok when min-eig(G)/441 > 1e-4
//     and |det G| > 1e-12;
//   - up to 30 steps d = -G^-1 sum (I_next - T) grad T, each applied before
//     the 0.01 px stop test (cv::calcOpticalFlowPyrLK's criteria).
// There is no block-edge cull: the Pallas kernel's 64x256 staging block is
// a TPU artifact.
//
// What bounds it on the H100: the dependent chain, not bytes. The pixels
// under the templates and windows of a 256-slot frame are ~2.8 MB (~0.8 us
// at 3.35 TB/s; the whole pyramids, 13.9 MB, are never read) and the float
// work ~50 MFLOP (~0.75 us), but each slot is a serial chain of up to
// 2 x 4 x 30 steps, every step a reduction over the previous step's
// window. The time is the longest slot's chain: per level one round trip to
// L2 for the template and the window neighbourhood, then per step the
// latency of shared-memory reads, a warp-shuffle tree and one block
// barrier. Measured on an H100 80GB HBM3 at 700 W (PERF.md): 60 us for a
// 256-slot frame, of which ~20 us is the launch and the levels' staging and
// ~40 us the longest slot's 120 steps (~0.33 us a step).
//
// Design: one block of 128 threads (4 warps) per slot; each thread owns 4
// of the 441 window pixels, whose template and gradients stay in registers
// for the level. Per level the block stages the 24x24 raw template slice of
// the previous image and a 32x32 region of the next image (the 22x22 raw
// window slice plus a 5 px margin per side) in shared memory, both loads in
// flight together; steps then read shared memory only. The staged region is
// a cache of the index-clamped padded image, so the window origin follows
// extract_patch's clip rule unchanged and the block restages only when the
// clipped window leaves the region. Sums are warp shuffles plus one
// shared-memory step (double-buffered, so one barrier per step); every
// thread then reads the same totals and takes the same step, so the block
// branches and exits together. Slots that are not valid write their
// (unmoved) guess at once. The host launches nothing between levels or
// directions.
//
// World axis: B independent frames (the JAX package's vmap over worlds,
// parallel/mesh.py:sharded_frontend) run in one launch on an (N, B) grid;
// world b reads level l at lvl[l] + b * H_l * W_l of a (B, H_l, W_l) stack
// and its slots at b * N. An unbatched call is B = 1. The level pointers
// stay as the launch passed them: each level call offsets its own two.
#include "common.cuh"

namespace {

constexpr int WIN_HALF = 10;
constexpr int WIN = 2 * WIN_HALF + 1;         // 21
constexpr int NPX = WIN * WIN;                // 441
constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int PER_THREAD = (NPX + THREADS - 1) / THREADS;  // 4
constexpr int PAD = WIN_HALF + 2;             // 12
constexpr int MAX_ITERS = 30;
constexpr float EPS = 0.01f;
constexpr float MIN_EIG_THRESHOLD = 1e-4f;
constexpr int MAX_LEVELS = 4;
constexpr int PSZ = WIN + 2;                  // 23: template patch
constexpr int TSZ = PSZ + 1;                  // 24: its raw slice
constexpr int WSZ = WIN + 1;                  // 22: raw slice of the window
constexpr int MARGIN = 5;
constexpr int SSZ = WSZ + 2 * MARGIN;         // 32: staged next-image region

struct Pyramid {
    const float* lvl[MAX_LEVELS];
};

struct Shared {
    float raw[TSZ * TSZ];
    float patch[PSZ * PSZ];
    float next[SSZ * SSZ];
    float red[2][NWARPS][3];
};

// Level image seen through an edge padding of PAD pixels.
__device__ __forceinline__ float padded(const float* img, int H, int W, int yy, int xx) {
    const int y = icg::clampi(yy - PAD, 0, H - 1);
    const int x = icg::clampi(xx - PAD, 0, W - 1);
    return __ldg(img + static_cast<size_t>(y) * W + x);
}

// extract_patch's slice corner along one axis: clipped inward.
__device__ __forceinline__ int corner(float c, int half, int extent_padded) {
    return icg::clampi(static_cast<int>(floorf(c)) - half, 0, extent_padded - (2 * half + 2));
}

// Block-wide sums of K values, the same totals in every thread. Buffers
// alternate between calls, so one barrier per call is enough.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], Shared& sh, int& buf) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = icg::warp_sum(v[k]);
    if (lane == 0) {
#pragma unroll
        for (int k = 0; k < K; ++k) sh.red[buf][warp][k] = v[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
        float s = sh.red[buf][0][k];
#pragma unroll
        for (int w = 1; w < NWARPS; ++w) s += sh.red[buf][w][k];
        v[k] = s;
    }
    buf ^= 1;
}

// One level for the block's slot. (px, py): previous point, (x, y): guess,
// both in level coordinates; the guess is updated in place (as
// lk_level_plain: shifted by PAD and back). Returns the level's ok.
__device__ bool track_level(const float* __restrict__ prev, const float* __restrict__ next,
                            int H, int W, float px, float py, float& gx_out, float& gy_out,
                            Shared& sh, int& buf, int& iters) {
    const int tid = threadIdx.x;
    const int Hp = H + 2 * PAD, Wp = W + 2 * PAD;
    float x = gx_out + PAD, y = gy_out + PAD;
    // the level of this block's world: one (H, W) image of a (B, H, W) stack
    prev += static_cast<size_t>(blockIdx.y) * H * W;
    next += static_cast<size_t>(blockIdx.y) * H * W;

    // stage the template's raw slice and the next image around the guess
    const float tx = px + PAD, ty = py + PAD;
    const int tx0 = corner(tx, WIN_HALF + 1, Wp), ty0 = corner(ty, WIN_HALF + 1, Hp);
    int sx0 = corner(x, WIN_HALF, Wp) - MARGIN, sy0 = corner(y, WIN_HALF, Hp) - MARGIN;
    for (int i = tid; i < TSZ * TSZ; i += THREADS)
        sh.raw[i] = padded(prev, H, W, ty0 + i / TSZ, tx0 + i % TSZ);
    for (int i = tid; i < SSZ * SSZ; i += THREADS)
        sh.next[i] = padded(next, H, W, sy0 + i / SSZ, sx0 + i % SSZ);
    __syncthreads();
    {
        const float fx = tx - floorf(tx), fy = ty - floorf(ty);
        const float w00 = (1.0f - fy) * (1.0f - fx), w01 = (1.0f - fy) * fx;
        const float w10 = fy * (1.0f - fx), w11 = fy * fx;
        for (int i = tid; i < PSZ * PSZ; i += THREADS) {
            const float* r = sh.raw + (i / PSZ) * TSZ + i % PSZ;
            sh.patch[i] = w00 * r[0] + w01 * r[1] + w10 * r[TSZ] + w11 * r[TSZ + 1];
        }
    }
    __syncthreads();

    // template and gradients of this thread's window pixels, in registers
    float tpl[PER_THREAD], gx[PER_THREAD], gy[PER_THREAD];
    int off[PER_THREAD];  // pixel offset inside a window of row pitch SSZ
    float g[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
        const int q = tid + THREADS * k;
        tpl[k] = gx[k] = gy[k] = 0.0f;
        off[k] = 0;
        if (q < NPX) {
            const int i = q / WIN, j = q % WIN;
            const float* p = sh.patch + (i + 1) * PSZ + (j + 1);
            tpl[k] = p[0];
            gx[k] = 0.5f * (p[1] - p[-1]);
            gy[k] = 0.5f * (p[PSZ] - p[-PSZ]);
            off[k] = i * SSZ + j;
            g[0] += gx[k] * gx[k];
            g[1] += gy[k] * gy[k];
            g[2] += gx[k] * gy[k];
        }
    }
    block_sum(g, sh, buf);
    const float gxx = g[0], gyy = g[1], gxy = g[2];
    const float det = gxx * gyy - gxy * gxy;
    const float min_eig =
        0.5f * ((gxx + gyy) - sqrtf((gxx - gyy) * (gxx - gyy) + 4.0f * gxy * gxy)) /
        static_cast<float>(NPX);
    const bool ok = (min_eig > MIN_EIG_THRESHOLD) && (fabsf(det) > 1e-12f);
    if (ok) {
        const float inv_det = 1.0f / det;
        for (int it = 0; it < MAX_ITERS; ++it) {
            const int wx0 = corner(x, WIN_HALF, Wp), wy0 = corner(y, WIN_HALF, Hp);
            if (wx0 < sx0 || wx0 + WSZ > sx0 + SSZ || wy0 < sy0 || wy0 + WSZ > sy0 + SSZ) {
                // the clipped window left the staged region: restage around it.
                // Every thread passed the last block_sum, so no one still reads.
                sx0 = wx0 - MARGIN;
                sy0 = wy0 - MARGIN;
                for (int i = tid; i < SSZ * SSZ; i += THREADS)
                    sh.next[i] = padded(next, H, W, sy0 + i / SSZ, sx0 + i % SSZ);
                __syncthreads();
            }
            const float fx = x - floorf(x), fy = y - floorf(y);
            const float w00 = (1.0f - fy) * (1.0f - fx), w01 = (1.0f - fy) * fx;
            const float w10 = fy * (1.0f - fx), w11 = fy * fx;
            const float* s = sh.next + (wy0 - sy0) * SSZ + (wx0 - sx0);
            float b[2] = {0.0f, 0.0f};
#pragma unroll
            for (int k = 0; k < PER_THREAD; ++k) {
                if (tid + THREADS * k < NPX) {
                    const float* r = s + off[k];
                    const float cur = w00 * r[0] + w01 * r[1] + w10 * r[SSZ] + w11 * r[SSZ + 1];
                    const float diff = cur - tpl[k];
                    b[0] += diff * gx[k];
                    b[1] += diff * gy[k];
                }
            }
            block_sum(b, sh, buf);
            const float dx = -(gyy * b[0] - gxy * b[1]) * inv_det;
            const float dy = -(gxx * b[1] - gxy * b[0]) * inv_det;
            x += dx;
            y += dy;
            ++iters;
            if (sqrtf(dx * dx + dy * dy) < EPS) break;
        }
    }
    gx_out = x - PAD;
    gy_out = y - PAD;
    return ok;
}

// pyr_lk for one slot: (x, y) enters as the level-0 initial guess and leaves
// as the tracked point. Returns the status.
__device__ bool cascade(const Pyramid& from, const Pyramid& to, const int* Hs, const int* Ws,
                        int levels, float px, float py, float& x, float& y, bool gate,
                        Shared& sh, int& buf, int& iters) {
    const float scale = static_cast<float>(1 << (levels - 1));
    x /= scale;
    y /= scale;
    bool status = gate;
    for (int l = levels - 1; l >= 0; --l) {
        const float s = static_cast<float>(1 << l);
        if (gate) {
            status = track_level(from.lvl[l], to.lvl[l], Hs[l], Ws[l], px / s, py / s, x, y, sh,
                                 buf, iters) && status;
        } else {  // lk_level_plain leaves the guess where it was (+PAD -PAD)
            x = (x + PAD) - PAD;
            y = (y + PAD) - PAD;
        }
        if (l > 0) {
            x *= 2.0f;
            y *= 2.0f;
        }
    }
    const bool inb = x >= 0.0f && x <= static_cast<float>(Ws[0] - 1) && y >= 0.0f &&
                     y <= static_cast<float>(Hs[0] - 1);
    return status && inb;
}

__global__ void __launch_bounds__(THREADS)
lk_pyr_kernel(Pyramid prev, Pyramid next, int H, int W, int levels,
              const float* __restrict__ pts_prev, const float* __restrict__ pts_pred,
              const uint8_t* __restrict__ valid, int directions, float fb_threshold, int border,
              float* __restrict__ fwd_out, uint8_t* __restrict__ ok_out,
              int* __restrict__ iters_out, int N) {
    __shared__ Shared sh;
    const int f = blockIdx.y * N + blockIdx.x;  // world blockIdx.y, slot blockIdx.x
    int Hs[MAX_LEVELS], Ws[MAX_LEVELS];
    Hs[0] = H;
    Ws[0] = W;
    for (int l = 1; l < MAX_LEVELS; ++l) {  // pyr_down: (n - 1) // 2 + 1
        Hs[l] = (Hs[l - 1] - 1) / 2 + 1;
        Ws[l] = (Ws[l - 1] - 1) / 2 + 1;
    }
    int buf = 0, iters = 0;
    const bool v = valid[f] != 0;
    const float px = pts_prev[2 * f], py = pts_prev[2 * f + 1];
    float fx = pts_pred[2 * f], fy = pts_pred[2 * f + 1];
    const bool st_f = cascade(prev, next, Hs, Ws, levels, px, py, fx, fy, v, sh, buf, iters);
    bool ok = st_f;
    if (directions == 2) {
        ok = false;
        if (st_f) {  // lk_pyr_plain gates the backward track by valid & st_f
            float bx = px, by = py;
            const bool st_b = cascade(next, prev, Hs, Ws, levels, fx, fy, bx, by, true, sh, buf,
                                      iters);
            const float ex = bx - px, ey = by - py;
            const bool on_border = fx < static_cast<float>(border) ||
                                   fy < static_cast<float>(border) ||
                                   fx > static_cast<float>(W - border) ||
                                   fy > static_cast<float>(H - border);
            ok = st_b && sqrtf(ex * ex + ey * ey) < fb_threshold && !on_border && v;
        }
    }
    if (threadIdx.x == 0) {
        fwd_out[2 * f] = fx;
        fwd_out[2 * f + 1] = fy;
        ok_out[f] = ok ? 1 : 0;
        if (iters_out != nullptr) iters_out[f] = iters;
    }
}

}  // namespace

// prev0..3, next0..3: the two pyramids' (H_l, W_l) f32 levels, level 0 of
// size (H, W) and each next level (H_l - 1) / 2 + 1 by (W_l - 1) / 2 + 1;
// pointers past `levels` are unused. pts_prev, pts_pred: (N, 2) f32 xy in
// level-0 pixels; valid: (N,) u8. Writes fwd (N, 2) f32 and ok (N,) u8, and,
// when iters_out is not null, each slot's number of LK steps (N,) i32.
// With B > 1 every array gains a leading world axis of B (levels
// (B, H_l, W_l), points (B, N, 2), ...), all in one launch.
extern "C" int lk_pyr(const void* prev0, const void* prev1, const void* prev2, const void* prev3,
                      const void* next0, const void* next1, const void* next2, const void* next3,
                      int H, int W, int levels, const void* pts_prev, const void* pts_pred,
                      const void* valid, int directions, float fb_threshold, int border,
                      void* fwd_out, void* ok_out, void* iters_out, int N, int B,
                      void* stream) {
    if (N == 0 || B == 0) return 0;
    if (levels < 1 || levels > MAX_LEVELS || (directions != 1 && directions != 2))
        return static_cast<int>(cudaErrorInvalidValue);
    const Pyramid prev{{static_cast<const float*>(prev0), static_cast<const float*>(prev1),
                        static_cast<const float*>(prev2), static_cast<const float*>(prev3)}};
    const Pyramid next{{static_cast<const float*>(next0), static_cast<const float*>(next1),
                        static_cast<const float*>(next2), static_cast<const float*>(next3)}};
    lk_pyr_kernel<<<dim3(N, B), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        prev, next, H, W, levels, static_cast<const float*>(pts_prev),
        static_cast<const float*>(pts_pred), static_cast<const uint8_t*>(valid), directions,
        fb_threshold, border, static_cast<float*>(fwd_out), static_cast<uint8_t*>(ok_out),
        static_cast<int*>(iters_out), N);
    return static_cast<int>(cudaGetLastError());
}
