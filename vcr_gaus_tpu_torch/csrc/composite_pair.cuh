// The per-pair front end shared by the compositing kernels
// (rasterize_fwd.cu, rasterize_bwd.cu), the stats kernel
// (rasterize_stats.cu) and the forward-loop microprobe
// (kernel_microprobe.cu): the tile geometry, the pixel-to-thread map, an
// entry's staged words, the power of a (pixel, entry) pair, its liveness
// test with the dead-pair threshold, its alpha, and its depth. The kernels
// include this one header, so the liveness tests, alpha and T of the
// backward and the stats kernel round exactly as in the forward: they
// recompute T front to back, and a test flipped near alpha = 1/255 would
// move a weight by up to T/255. Every expression here is the plain PyTorch
// version's (ops/rasterize.py `_batch_pairs`), in its order, and the
// kernels are built with --fmad=false, so nothing is fused.
//
// The dead-pair threshold. A pair is live iff power <= 0 and
// opacity * expf(power) >= ALPHA_EPS. At staging each entry gets
//     thr = logf(ALPHA_EPS / opacity) - DEAD_MARGIN,
// and a pair with power < thr is dead without its expf. The margin is
// wider than every rounding on the way, so the skip never changes a pair's
// outcome (CUDA's float logf is within 1 ulp, expf within 2 ulp, the
// divide and the subtraction are correctly rounded):
//   * thr <= ln(ALPHA_EPS / opacity) - DEAD_MARGIN + 2.3e-5: the divide
//     adds at most 2^-24 relative (6e-8 to the log), logf one ulp of a value
//     below 128 in magnitude (an opacity that makes the ratio overflow gives
//     thr = +inf, and then op * expf(power) is below ALPHA_EPS anyway), at
//     most 2^-16 = 1.5e-5, the subtraction half an ulp, 7.6e-6;
//   * so power < thr gives opacity * e^power < ALPHA_EPS e^-0.000977, and
//     expf's 2 ulp (2.4e-7 relative) and the product's rounding (6e-8)
//     cannot lift it to ALPHA_EPS: exp(-0.000977) (1 + 3.1e-7) < 1.
// A NaN opacity or power never passes `power < thr` and takes the exact
// test. DEAD_MARGIN = 1e-3 is 40x the 2.3e-5 needed; the pairs it keeps on
// the exact path are those within 0.1% of the alpha threshold.

#pragma once

#include <cuda_runtime.h>

namespace vcr {

constexpr int TILE = 16;
constexpr int TILE_PIX = TILE * TILE;
constexpr int BATCH = 256;           // entries staged in shared memory a round
constexpr float ALPHA_EPS = 1.0f / 255.0f;
constexpr float ALPHA_CAP = 0.99f;
constexpr float T_EPS = 1e-4f;
constexpr float DENOM_EPS = 1e-2f;
constexpr float DEAD_MARGIN = 1e-3f;
constexpr unsigned FULL = 0xffffffffu;

// packed feature columns (vcr_gaus_tpu_torch/ops/projection.py)
constexpr int F_MEAN_X = 0, F_MEAN_Y = 1, F_CONIC_A = 2, F_CONIC_B = 3,
              F_CONIC_C = 4, F_OPACITY = 5, F_DEPTH_Z = 6, F_PLANE_D = 7,
              F_NORMAL = 8, F_RGB = 11, F_SEM = 14;

// The pixel-to-thread map of a SIDE x SIDE tile: P = 2 pixels a thread,
// SIDE^2 / 2 threads. Each warp covers a compact 8x8 patch of the tile, its
// lanes an 8x4 block of it, and a thread's two pixels share their column,
// LY = 4 rows apart. A compact patch keeps a warp clear of the entries
// that touch none of its pixels: a Gaussian's footprint is a blob, and the
// old map's 16x2 strips met more of them (chip_smoke.py counts the warp
// steps with a live lane under both maps). Four pixels a thread on 16x8
// patches ran 1.2-1.3x slower in both compositing kernels on the card
// (PERF.md). The kernels' 16x16 tiles take 128 threads; the microprobe's
// 32x32 tiles 512.
template <int SIDE>
struct TilePixelMap {
    static constexpr int P = 2;
    static constexpr int THREADS = SIDE * SIDE / P;
    static constexpr int WARPS = THREADS / 32;
    static constexpr int WX = 8;                 // patch width
    static constexpr int WY = 32 * P / WX;       // patch height
    static constexpr int LY = 32 / WX;           // rows between own pixels
    static_assert(SIDE % WX == 0 && SIDE % WY == 0, "whole patches");

    // the tile-local column and first row of thread `tid`'s pixels
    static __device__ __forceinline__ void first(int tid, int& x, int& y0)
    {
        const int warp = tid >> 5, lane = tid & 31;
        x = (warp % (SIDE / WX)) * WX + lane % WX;
        y0 = (warp / (SIDE / WX)) * WY + lane / WX;
    }
};
using PixelMap = TilePixelMap<TILE>;

// an entry's staged words: the front end every pair reads, as two 16-byte
// shared-memory broadcasts a thread serves its 2 pixels from
struct __align__(16) Front {
    float mx, my, a, b;
};
struct __align__(16) Front2 {
    float c, thr, op, d;    // thr: dead_threshold(op); d: depth_z, or
                            // plane_d in intersection mode
};

// the Gaussian's power at offset (dx, dy) from its mean
__device__ __forceinline__ float pair_power(float dx, float dy, float a,
                                            float b, float c)
{
    return -0.5f * (a * dx * dx + c * dy * dy) - b * dx * dy;
}

// an entry's dead-pair threshold, computed once at staging (see above)
__device__ __forceinline__ float dead_threshold(float opacity)
{
    return logf(ALPHA_EPS / opacity) - DEAD_MARGIN;
}

// false iff the pair is certainly dead: power > 0 (or NaN), or below the
// entry's dead-pair threshold; else the exact test decides
__device__ __forceinline__ bool pair_near(float power, float thr)
{
    return power <= 0.f && !(power < thr);
}

// true iff the pair is live; then alpha_raw = opacity * expf(power)
__device__ __forceinline__ bool pair_live(float power, float thr,
                                          float opacity, float& alpha_raw)
{
    if (!pair_near(power, thr)) return false;
    alpha_raw = opacity * expf(power);
    return alpha_raw >= ALPHA_EPS;
}

// the unit ray through the half-pixel centre of (px, py); cam = fx fy cx cy
__device__ __forceinline__ void pixel_ray(float px, float py,
                                          const float* cam, float& dirx,
                                          float& diry, float& dirz)
{
    dirx = (px + 0.5f - cam[2]) / cam[0];
    diry = (py + 0.5f - cam[3]) / cam[1];
    const float inv_n = rsqrtf(dirx * dirx + diry * diry + 1.0f);
    dirx *= inv_n;
    diry *= inv_n;
    dirz = inv_n;
}

// ray . n with the |ray . n| >= 1e-2 signed clamp; `clamped` says whether
// the clamp was active
__device__ __forceinline__ float clamped_denom(float dirx, float diry,
                                               float dirz, float n0, float n1,
                                               float n2, bool& clamped)
{
    float denom = dirx * n0 + diry * n1 + dirz * n2;
    clamped = fabsf(denom) < DENOM_EPS;
    if (clamped) denom = denom < 0.f ? -DENOM_EPS : DENOM_EPS;
    return denom;
}

}  // namespace vcr
