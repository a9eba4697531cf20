// CLAHE apply: per-pixel 9-LUT lookup + separable bilinear blend.
//
// Replaces ic_gvins_tpu/ops/pallas_clahe.py:clahe_apply_pallas (the TPU
// kernel behind vision/pyramid.py:clahe). For pixel p of tile t with gray
// value v:  out[p] = sum_n w_row[dy] * w_col[dx] * LUT_{t+(dy-1, dx-1)}[v],
// n = 3*dy + dx over the 3x3 neighbouring tiles (edge-clamped), with bf16
// LUT entries and an f32 blend.
//
// What bounds it on the H100: memory. Each pixel reads one i32 and writes
// one f32, and the tables are 441 x 256 bf16 (10.7 MB per 1278x1022 frame,
// 3.2 us at 3.35 TB/s); a dozen float operations a pixel is far below the
// compute floor. The TPU kernel received a precomputed (T, 9, P) f32 weight
// tensor (~47 MB) and resolved the lookup as a nibble one-hot matmul; here
// the weights come from the pixel coordinate (the rule of
// pyramid.py:_tile_offset_weights) and only the image crosses device memory.
// To run near that floor the kernel must keep enough bytes in flight. What
// bounds it now is the throughput of the table reads, gathers through L1:
// 7.5 us a 1278x1022 frame on an H100 80GB HBM3 at 700 W, against 3.8 us
// for the same traversal writing the gray value without the 4 lookups a
// pixel (PERF.md, tools/kernel_variants.py). Issuing the reads earlier gained
// 0.4 us; overlapping them with the next rows' loads lost 1.4 us; staging
// each block's tables in shared memory lost 2.7 us (the copy costs more
// than the cheaper reads save).
//
// Design: row-major traversal. A thread owns VEC = 2 adjacent columns (one
// 8-byte int2 load and one float2 store per row; W even keeps every row
// 8-byte aligned, else VEC = 1) for ROWS rows. It issues all ROWS loads,
// then all 4 * VEC * ROWS table reads, before it uses any. Along each axis
// only two of the three offset weights can be nonzero, so a coordinate's
// weights fold into two (tile, weight) taps: the column taps are computed
// once per thread, the row taps once per row, and no pixel divides. A pixel
// then reads 4 LUT entries (through the read-only cache: the 225 KB of
// tables stay in L2 and the taps of a warp hit the same few L1 lines)
// instead of staging 9 tables per tile in shared memory. The blend keeps
// the plain version's order and its separate rounding of every product and
// sum (the zero weights it skips add +0), so the result equals
// ops/clahe.py:clahe_apply_plain.
//
// World axis: B independent images (the JAX package's vmap over worlds)
// run in one launch, world z = blockIdx.z reading its image at z * H * W
// and its tables at z * ty * tx * 256. An unbatched call is B = 1; the
// offsets are compiled in only where B > 1 (WORLDS): applied in every call,
// as pointer offsets or folded into the row and tile indices, they slowed
// the unbatched call by about a sixth on the H100.
#include "common.cuh"

namespace {

constexpr int NBINS = 256;
constexpr int THREADS = 128;
constexpr int ROWS = 8;

// The two tiles that carry a coordinate's weight, in offset order, with
// their weights; a tile is an index along the axis.
struct Taps {
    int lo, hi;
    float wlo, whi;
};

// _tile_offset_weights for coordinate `c`, step by step in f32: the weights
// over tile offsets {-1, 0, +1} (1 - f at the offset of i0, f at that of
// i1, summed where they coincide), folded into Taps.
__device__ __forceinline__ Taps taps(int c, int tn, int tsize, float hi) {
    float tf = ((static_cast<float>(c) - static_cast<float>(tsize) * 0.5f) + 0.5f) /
               static_cast<float>(tsize);
    tf = fminf(fmaxf(tf, 0.0f), hi);
    const float f0 = floorf(tf);
    const int i0 = static_cast<int>(f0);
    const float f = tf - f0;
    const int own = c / tsize;
    const int i1 = min(i0 + 1, tn - 1);
    const int o0 = icg::clampi(i0 - own, -1, 1), o1 = icg::clampi(i1 - own, -1, 1);
    const int t0 = icg::clampi(own + o0, 0, tn - 1), t1 = icg::clampi(own + o1, 0, tn - 1);
    if (o0 == o1) return Taps{t0, t0, __fadd_rn(1.0f - f, f), 0.0f};
    if (o0 < o1) return Taps{t0, t1, 1.0f - f, f};
    return Taps{t1, t0, f, 1.0f - f};
}

__device__ __forceinline__ float lut_at(const unsigned short* lut, int tile, int val) {
    return __uint_as_float(static_cast<unsigned>(__ldg(lut + tile * NBINS + val)) << 16);
}

template <int VEC, bool WORLDS>
__global__ void __launch_bounds__(THREADS)
clahe_apply_kernel(const int32_t* __restrict__ v, const unsigned short* __restrict__ lut,
                   float* __restrict__ out, int H, int W, int ty, int tx, int th, int tw,
                   float hi_y, float hi_x) {
    const int x = (blockIdx.x * THREADS + threadIdx.x) * VEC;
    const int y0 = blockIdx.y * ROWS;
    if (x >= W) return;
    if constexpr (WORLDS) {  // this world's image and tables
        const size_t world = blockIdx.z;
        v += world * H * W;
        out += world * H * W;
        lut += world * ty * tx * NBINS;
    }

    // rows past H are loaded (as row H - 1) and looked up, never stored
    int val[ROWS][VEC];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        const int32_t* src = v + static_cast<size_t>(min(y0 + r, H - 1)) * W + x;
        if constexpr (VEC == 2) {
            const int2 p = __ldg(reinterpret_cast<const int2*>(src));
            val[r][0] = p.x;
            val[r][1] = p.y;
        } else {
            val[r][0] = __ldg(src);
        }
    }
    Taps col[VEC], row[ROWS];
#pragma unroll
    for (int k = 0; k < VEC; ++k) col[k] = taps(x + k, tx, tw, hi_x);
    // every table entry of the thread's pixels, all issued before any is used
    float e[ROWS][VEC][4];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        row[r] = taps(min(y0 + r, H - 1), ty, th, hi_y);
        const int rlo = row[r].lo * tx, rhi = row[r].hi * tx;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
            const int b = icg::clampi(val[r][k], 0, NBINS - 1);
            e[r][k][0] = lut_at(lut, rlo + col[k].lo, b);
            e[r][k][1] = lut_at(lut, rlo + col[k].hi, b);
            e[r][k][2] = lut_at(lut, rhi + col[k].lo, b);
            e[r][k][3] = lut_at(lut, rhi + col[k].hi, b);
        }
    }

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        const int y = y0 + r;
        if (y >= H) break;
        const Taps& w = row[r];
        float res[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
            const Taps& u = col[k];
            float acc = __fmul_rn(__fmul_rn(w.wlo, u.wlo), e[r][k][0]);
            acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(w.wlo, u.whi), e[r][k][1]));
            acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(w.whi, u.wlo), e[r][k][2]));
            acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(w.whi, u.whi), e[r][k][3]));
            res[k] = acc;
        }
        float* dst = out + static_cast<size_t>(y) * W + x;
        if constexpr (VEC == 2) {
            *reinterpret_cast<float2*>(dst) = make_float2(res[0], res[1]);
        } else {
            dst[0] = res[0];
        }
    }
}

}  // namespace

// v: (H, W) i32 gray values in [0, 255]; lut: (ty*tx, 256) bf16 per-tile
// transfer functions; out: (H, W) f32. Tiles are th x tw pixels on a
// ty x tx grid; hi_y / hi_x are f32(ty - 1.000001) / f32(tx - 1.000001).
// vec = 2 needs W even and v, out 8-byte aligned; vec = 1 takes any W.
// With B > 1, v and out are (B, H, W) and lut (B, ty*tx, 256): one launch.
extern "C" int clahe_apply(const void* v, const void* lut, void* out, int H, int W, int ty,
                           int tx, int th, int tw, float hi_y, float hi_x, int vec, int B,
                           void* stream) {
    if (B == 0) return 0;
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* vp = static_cast<const int32_t*>(v);
    const auto* lp = static_cast<const unsigned short*>(lut);
    auto* op = static_cast<float*>(out);
    const dim3 grid_rows(1, (H + ROWS - 1) / ROWS, B);
    if (vec == 2) {
        if (W % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
        const dim3 grid((W / 2 + THREADS - 1) / THREADS, grid_rows.y, grid_rows.z);
        if (B > 1)
            clahe_apply_kernel<2, true><<<grid, THREADS, 0, s>>>(vp, lp, op, H, W, ty, tx, th, tw,
                                                                 hi_y, hi_x);
        else
            clahe_apply_kernel<2, false><<<grid, THREADS, 0, s>>>(vp, lp, op, H, W, ty, tx, th, tw,
                                                                  hi_y, hi_x);
    } else {
        const dim3 grid((W + THREADS - 1) / THREADS, grid_rows.y, grid_rows.z);
        if (B > 1)
            clahe_apply_kernel<1, true><<<grid, THREADS, 0, s>>>(vp, lp, op, H, W, ty, tx, th, tw,
                                                                 hi_y, hi_x);
        else
            clahe_apply_kernel<1, false><<<grid, THREADS, 0, s>>>(vp, lp, op, H, W, ty, tx, th, tw,
                                                                  hi_y, hi_x);
    }
    return static_cast<int>(cudaGetLastError());
}
