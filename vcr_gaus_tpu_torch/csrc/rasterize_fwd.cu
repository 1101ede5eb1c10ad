// Forward tile compositing for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `rasterize_forward` -> `_fwd_kernel` of
// vcr_gaus_tpu/ops/rasterize_tpu.py (call at :555, body :400-529). It computes
// what that kernel computes, not a block-by-block copy of it:
//
//   * one block per 16x16 pixel tile, one thread per pixel (256 threads);
//   * the block walks its tile's [start, start+count) range of depth-sorted
//     gaussian ids in batches of 256 entries; for each batch the threads load
//     the ids and the gathered rows of the (N, 14+S) packed feature matrix
//     (ops/projection.py layout) into shared memory, so no per-entry payload
//     is ever materialized in device memory;
//   * each thread composites the batch front to back with its own
//     transmittance T and accumulators in registers:
//       power = -0.5 (A dx^2 + C dy^2) - B dx dy   (integer pixel coords)
//       live  iff power <= 0 and op e^power >= 1/255
//       alpha = min(op e^power, 0.99);  w = alpha T;  T *= 1 - alpha
//     depth is the entry's camera z (traditional) or plane_d / (ray . n)
//     along the half-pixel ray with the |ray . n| >= 1e-2 signed clamp
//     (intersection);
//   * early stop follows the JAX kernel's rule, not the upstream per-pixel
//     one: before each batch the block votes __syncthreads_or(T >= 1e-4);
//     once no pixel of the tile (those outside the image included, as on the
//     TPU) is alive, the block stops. Until then every pixel keeps
//     compositing, its own T < 1e-4 included, which keeps the depth^2
//     channel within the forward tolerance in saturated tiles;
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
// This first version keeps the arithmetic plain (no wgmma, TMA or warp
// specialization) and is compiled with --fmad=false, so that its liveness
// tests round exactly as the plain PyTorch version's do: a test flipped near
// alpha = 1/255 would change a weight by up to T/255.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int BLOCK = TILE * TILE;   // one thread per pixel
constexpr int BATCH = 256;           // entries staged in shared memory per round
constexpr float ALPHA_EPS = 1.0f / 255.0f;
constexpr float ALPHA_CAP = 0.99f;
constexpr float T_EPS = 1e-4f;

// packed feature columns (vcr_gaus_tpu_torch/ops/projection.py)
constexpr int F_MEAN_X = 0, F_MEAN_Y = 1, F_CONIC_A = 2, F_CONIC_B = 3,
              F_CONIC_C = 4, F_OPACITY = 5, F_DEPTH_Z = 6, F_PLANE_D = 7,
              F_NORMAL = 8, F_RGB = 11, F_SEM = 14;

template <int CH_SEM, bool INTERSECT>
__global__ void __launch_bounds__(BLOCK)
rasterize_fwd_kernel(const float* __restrict__ feats,
                     const int* __restrict__ sorted_gid,
                     const int* __restrict__ tile_starts,
                     const int* __restrict__ tile_counts,
                     const float* __restrict__ cam,  // fx fy cx cy bg_r bg_g bg_b 0
                     int n_tx, int width, int height,
                     float* __restrict__ out,        // (9+S, H, W)
                     int* __restrict__ batches_done) // (T,)
{
    constexpr int F = 14 + CH_SEM;
    __shared__ float sf[F][BATCH];

    const int t = blockIdx.x;
    const int tid = threadIdx.x;
    const int pxi = (t % n_tx) * TILE + tid % TILE;
    const int pyi = (t / n_tx) * TILE + tid / TILE;
    const float px = (float)pxi;
    const float py = (float)pyi;
    const int start = tile_starts[t];
    const int count = tile_counts[t];

    float dirx = 0.f, diry = 0.f, dirz = 0.f;
    if (INTERSECT) {
        dirx = (px + 0.5f - cam[2]) / cam[0];
        diry = (py + 0.5f - cam[3]) / cam[1];
        const float inv_n = rsqrtf(dirx * dirx + diry * diry + 1.0f);
        dirx *= inv_n;
        diry *= inv_n;
        dirz = inv_n;
    }

    float T = 1.f;
    float acc_rgb[3] = {0.f, 0.f, 0.f};
    float acc_nrm[3] = {0.f, 0.f, 0.f};
    float acc_sem[CH_SEM > 0 ? CH_SEM : 1] = {};
    float acc_d = 0.f, acc_d2 = 0.f;

    const int nbatch = (count + BATCH - 1) / BATCH;
    int k = 0;
    for (; k < nbatch; ++k) {
        // tile-wide consensus; also the barrier before sf is overwritten
        if (!__syncthreads_or(T >= T_EPS)) break;
        const int base = k * BATCH;
        const int nb = min(BATCH, count - base);
        if (tid < nb) {
            const float* row = feats + (size_t)sorted_gid[start + base + tid] * F;
#pragma unroll
            for (int c = 0; c < F; ++c) sf[c][tid] = row[c];
        }
        __syncthreads();
        for (int j = 0; j < nb; ++j) {
            const float dx = px - sf[F_MEAN_X][j];
            const float dy = py - sf[F_MEAN_Y][j];
            const float power = -0.5f * (sf[F_CONIC_A][j] * dx * dx
                                         + sf[F_CONIC_C][j] * dy * dy)
                                - sf[F_CONIC_B][j] * dx * dy;
            if (!(power <= 0.f)) continue;
            const float alpha_raw = sf[F_OPACITY][j] * expf(power);
            if (!(alpha_raw >= ALPHA_EPS)) continue;
            const float alpha = fminf(alpha_raw, ALPHA_CAP);
            const float w = alpha * T;
            float d;
            if (INTERSECT) {
                float denom = dirx * sf[F_NORMAL][j] + diry * sf[F_NORMAL + 1][j]
                              + dirz * sf[F_NORMAL + 2][j];
                if (fabsf(denom) < 1e-2f) denom = denom < 0.f ? -1e-2f : 1e-2f;
                d = sf[F_PLANE_D][j] / denom;
            } else {
                d = sf[F_DEPTH_Z][j];
            }
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                acc_rgb[c] += w * sf[F_RGB + c][j];
                acc_nrm[c] += w * sf[F_NORMAL + c][j];
            }
#pragma unroll
            for (int c = 0; c < CH_SEM; ++c) acc_sem[c] += w * sf[F_SEM + c][j];
            const float wd = w * d;
            acc_d += wd;
            acc_d2 += wd * d;
            T *= 1.f - alpha;
        }
    }
    if (tid == 0) batches_done[t] = k;
    if (pxi >= width || pyi >= height) return;

    const size_t hw = (size_t)height * width;
    float* o = out + (size_t)pyi * width + pxi;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        o[c * hw] = acc_rgb[c] + T * cam[4 + c];
        o[(3 + c) * hw] = acc_nrm[c];
    }
    o[6 * hw] = acc_d;
    o[7 * hw] = acc_d2;
    o[8 * hw] = 1.f - T;
#pragma unroll
    for (int c = 0; c < CH_SEM; ++c) o[(9 + c) * hw] = acc_sem[c];
}

template <int CH_SEM>
cudaError_t launch(bool intersect, int num_tiles, cudaStream_t stream,
                   const float* feats, const int* sorted_gid,
                   const int* tile_starts, const int* tile_counts,
                   const float* cam, int n_tx, int width, int height,
                   float* out, int* batches_done)
{
    if (intersect)
        rasterize_fwd_kernel<CH_SEM, true><<<num_tiles, BLOCK, 0, stream>>>(
            feats, sorted_gid, tile_starts, tile_counts, cam, n_tx, width,
            height, out, batches_done);
    else
        rasterize_fwd_kernel<CH_SEM, false><<<num_tiles, BLOCK, 0, stream>>>(
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
