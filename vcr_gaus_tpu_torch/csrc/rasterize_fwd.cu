// Forward tile compositing for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `rasterize_forward` -> `_fwd_kernel` of
// vcr_gaus_tpu/ops/rasterize_tpu.py (call at :555, body :400-529). It computes
// what that kernel computes, not a block-by-block copy of it:
//
//   * one block per 16x16 pixel tile, 2 pixels a thread (128 threads), on
//     the pixel-to-thread map of composite_pair.cuh: each warp covers a
//     compact 8x8 patch;
//   * the block walks its tile's [start, start+count) range of depth-sorted
//     gaussian ids in batches of 256 entries; for each batch the threads
//     gather the entries' rows of the (N, 14+S) packed feature matrix
//     (ops/projection.py layout) into shared memory, with each entry's
//     dead-pair threshold, so no per-entry payload is ever materialized in
//     device memory;
//   * each thread composites the batch front to back for its pixels, each
//     with its own transmittance T and accumulators in registers. An entry's
//     front-end words (mean, conic, threshold, opacity) are read once per
//     thread as two 16-byte broadcasts and serve its 2 pixels, which share
//     their column and so the x offset; the rgb, normal and semantic words
//     only when one of them is live:
//       power = -0.5 (A dx^2 + C dy^2) - B dx dy   (integer pixel coords)
//       live  iff power <= 0 and op e^power >= 1/255; a pair below the
//             entry's threshold is dead without its expf
//       alpha = min(op e^power, 0.99);  w = alpha T;  T *= 1 - alpha
//     depth is the entry's camera z (traditional) or plane_d / (ray . n)
//     along the half-pixel ray with the |ray . n| >= 1e-2 signed clamp
//     (intersection);
//   * early stop follows the JAX kernel's rule, not the upstream per-pixel
//     one: before each batch the block votes __syncthreads_or(T >= 1e-4)
//     over all its pixels; once no pixel of the tile (those outside the
//     image included, as on the TPU) is alive, the block stops. Until then
//     every pixel keeps compositing, its own T < 1e-4 included, which keeps
//     the depth^2 channel within the forward tolerance in saturated tiles;
//   * the image is written straight into the (9+S, H, W) channel stack
//     (pixels outside the image are not written), and the number of batches
//     composited per tile goes to a small int32 side output, the counterpart
//     of the TPU kernel's hidden k_done channel, for the backward.
//
// What bounds it on the card: the pair evaluations, for the composited
// entries x 256 pixels, over the 67 TFLOP/s FP32 rate. Counting each add,
// mul, compare, min, abs, divide and expf as one operation, a pair costs 12
// up to the power test, 15 up to the alpha test, and 35 + 2 S if it is live
// (43 + 2 S in intersection mode); chip_smoke.py counts the pairs of each
// kind on a full-width view. The bytes are only the gid plus 4 (14+S)
// feature bytes per composited entry and 4 (9+S) output bytes per pixel, so
// at rendering shapes the kernel is bound by operations.
//
// What the design does about it (a thread per pixel ran 6x its bound; the
// forward-loop microprobe put most of a K1-shaped loop in the every-pair
// alpha test and in the divergent live body):
//   * the dead-pair threshold takes the expf, the multiply and the test off
//     every pair below it (half of a render view's pairs are dead past the
//     power test), without changing any pair's outcome;
//   * 2 pixels a thread share each entry's shared-memory reads and its x
//     offset, and a block of 128 threads lets several tiles share an SM, so
//     a tile's busiest warp holds up fewer threads at each batch barrier;
//   * the accumulators take explicit fmaf and the intersection depth
//     __fdividef (2 ulp where |ray . n| >= 1e-2); neither enters a liveness
//     test or T.
// It is compiled with --fmad=false, so that its liveness tests and T round
// exactly as the plain PyTorch version's do.

#include <cuda_runtime.h>

#include "composite_pair.cuh"

namespace {

using namespace vcr;

template <int CH_SEM, bool INTERSECT>
__global__ void __launch_bounds__(PixelMap::THREADS)
rasterize_fwd_kernel(const float* __restrict__ feats,
                     const int* __restrict__ sorted_gid,
                     const int* __restrict__ tile_starts,
                     const int* __restrict__ tile_counts,
                     const float* __restrict__ cam,  // fx fy cx cy bg_r bg_g bg_b 0
                     int n_tx, int width, int height,
                     float* __restrict__ out,        // (9+S, H, W)
                     int* __restrict__ batches_done) // (T,)
{
    using Map = PixelMap;
    constexpr int P = Map::P;
    constexpr int F = 14 + CH_SEM;
    constexpr int NACC = 6 + CH_SEM;   // normal, rgb, sem: feature order
    __shared__ Front s0[BATCH];
    __shared__ Front2 s1[BATCH];
    __shared__ float sacc[NACC][BATCH];

    const int t = blockIdx.x;
    const int tid = threadIdx.x;
    int lx, ly0;
    Map::first(tid, lx, ly0);
    const int pxi = (t % n_tx) * TILE + lx;
    const int py0 = (t / n_tx) * TILE + ly0;
    const float px = (float)pxi;
    const int start = tile_starts[t];
    const int count = tile_counts[t];

    float py[P], dirx[P], diry[P], dirz[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
        py[k] = (float)(py0 + k * Map::LY);
        dirx[k] = diry[k] = dirz[k] = 0.f;
        if (INTERSECT) pixel_ray(px, py[k], cam, dirx[k], diry[k], dirz[k]);
    }

    float T[P], acc[P][NACC], acc_d[P], acc_d2[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
        T[k] = 1.f;
        acc_d[k] = acc_d2[k] = 0.f;
#pragma unroll
        for (int c = 0; c < NACC; ++c) acc[k][c] = 0.f;
    }

    const int nbatch = (count + BATCH - 1) / BATCH;
    int kb = 0;
    for (; kb < nbatch; ++kb) {
        // tile-wide consensus; also the barrier before the stage is reused
        bool alive = false;
#pragma unroll
        for (int k = 0; k < P; ++k) alive |= T[k] >= T_EPS;
        if (!__syncthreads_or(alive)) break;
        const int base = kb * BATCH;
        const int nb = min(BATCH, count - base);
        for (int e = tid; e < nb; e += Map::THREADS) {
            const float* row = feats + (size_t)sorted_gid[start + base + e] * F;
            const float op = row[F_OPACITY];
            s0[e] = Front{row[F_MEAN_X], row[F_MEAN_Y], row[F_CONIC_A],
                          row[F_CONIC_B]};
            s1[e] = Front2{row[F_CONIC_C], dead_threshold(op), op,
                           row[INTERSECT ? F_PLANE_D : F_DEPTH_Z]};
#pragma unroll
            for (int c = 0; c < NACC; ++c) sacc[c][e] = row[F_NORMAL + c];
        }
        __syncthreads();
        for (int j = 0; j < nb; ++j) {
            const Front f0 = s0[j];
            const Front2 f1 = s1[j];
            const float dx = px - f0.mx;
            float alpha_raw[P];
            bool live[P];
            bool any = false;
#pragma unroll
            for (int k = 0; k < P; ++k) {
                const float dy = py[k] - f0.my;
                live[k] = pair_live(pair_power(dx, dy, f0.a, f0.b, f1.c),
                                    f1.thr, f1.op, alpha_raw[k]);
                any |= live[k];
            }
            if (!any) continue;
            float col[NACC];
#pragma unroll
            for (int c = 0; c < NACC; ++c) col[c] = sacc[c][j];
#pragma unroll
            for (int k = 0; k < P; ++k) {
                if (!live[k]) continue;
                const float alpha = fminf(alpha_raw[k], ALPHA_CAP);
                const float w = alpha * T[k];
                float d = f1.d;
                if (INTERSECT) {
                    bool clamped;
                    d = __fdividef(f1.d, clamped_denom(dirx[k], diry[k],
                                                       dirz[k], col[0],
                                                       col[1], col[2],
                                                       clamped));
                }
#pragma unroll
                for (int c = 0; c < NACC; ++c)
                    acc[k][c] = fmaf(w, col[c], acc[k][c]);
                const float wd = w * d;
                acc_d[k] += wd;
                acc_d2[k] = fmaf(wd, d, acc_d2[k]);
                T[k] *= 1.f - alpha;
            }
        }
    }
    if (tid == 0) batches_done[t] = kb;

    const size_t hw = (size_t)height * width;
#pragma unroll
    for (int k = 0; k < P; ++k) {
        const int pyi = py0 + k * Map::LY;
        if (pxi >= width || pyi >= height) continue;
        float* o = out + (size_t)pyi * width + pxi;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            o[c * hw] = acc[k][3 + c] + T[k] * cam[4 + c];
            o[(3 + c) * hw] = acc[k][c];
        }
        o[6 * hw] = acc_d[k];
        o[7 * hw] = acc_d2[k];
        o[8 * hw] = 1.f - T[k];
#pragma unroll
        for (int c = 0; c < CH_SEM; ++c) o[(9 + c) * hw] = acc[k][6 + c];
    }
}

template <int CH_SEM>
cudaError_t launch(bool intersect, int num_tiles, cudaStream_t stream,
                   const float* feats, const int* sorted_gid,
                   const int* tile_starts, const int* tile_counts,
                   const float* cam, int n_tx, int width, int height,
                   float* out, int* batches_done)
{
    constexpr int threads = PixelMap::THREADS;
    if (intersect)
        rasterize_fwd_kernel<CH_SEM, true><<<num_tiles, threads, 0, stream>>>(
            feats, sorted_gid, tile_starts, tile_counts, cam, n_tx, width,
            height, out, batches_done);
    else
        rasterize_fwd_kernel<CH_SEM, false><<<num_tiles, threads, 0,
                                              stream>>>(
            feats, sorted_gid, tile_starts, tile_counts, cam, n_tx, width,
            height, out, batches_done);
    return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns the cudaError_t of the
// launch (0 = cudaSuccess); the kernel runs on `stream` and is not awaited.
extern "C" int vcr_rasterize_fwd(const float* feats, const int* sorted_gid,
                                 const int* tile_starts, const int* tile_counts,
                                 const float* cam, int n_tx, int n_ty,
                                 int width, int height, int ch_sem,
                                 int intersect, float* out, int* batches_done,
                                 void* stream)
{
    const int num_tiles = n_tx * n_ty;
    if (num_tiles <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const bool inter = intersect != 0;
#define VCR_CASE(S)                                                          \
    case S:                                                                  \
        return (int)launch<S>(inter, num_tiles, s, feats, sorted_gid,        \
                              tile_starts, tile_counts, cam, n_tx, width,    \
                              height, out, batches_done);
    switch (ch_sem) {
        VCR_CASE(0) VCR_CASE(1) VCR_CASE(2) VCR_CASE(3) VCR_CASE(4)
        VCR_CASE(5) VCR_CASE(6) VCR_CASE(7) VCR_CASE(8)
        default:
            return (int)cudaErrorInvalidValue;
    }
#undef VCR_CASE
}
