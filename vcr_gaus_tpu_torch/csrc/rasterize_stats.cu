// Per-Gaussian visibility and importance stats for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `rasterize_stats` -> `_stats_kernel` of
// vcr_gaus_tpu/ops/rasterize_tpu.py (call at :948, body :846-920) together
// with the per-Gaussian scatter that follows it on the TPU path
// (`.at[gid].add(mode="drop")`, vcr_gaus_tpu/ops/rasterize.py:287-289). For
// every Gaussian it computes, over one view:
//
//   count = the live (pixel, entry) pairs of its entries: power <= 0,
//           op e^power >= 1/255, the pixel inside the image;
//   imp   = sum over those pairs of min(op e^power, 0.99) T, the
//           LightGaussian importance (blending weight).
//
// The shape is the forward kernel's (rasterize_fwd.cu): one block per 16x16
// tile, one thread per pixel, the tile's depth-sorted entries staged in
// shared memory in batches of 256 (only the six columns the test reads), T
// carried front to back per pixel with the forward kernel's expressions
// under --fmad=false, so liveness agrees with the plain version pair by
// pair. Two differences from the forward kernel:
//
//   * pixels outside the image (the ragged edge of a tile) never composite
//     and keep T = 1, as the TPU kernel's `pvalid` makes them. They still
//     vote in the tile-wide early stop (__syncthreads_or(T >= 1e-4) before
//     each batch), so a ragged tile never stops early here, while the
//     forward kernel, which composites them, can stop it;
//   * per entry, the pixels' hit and weight are summed with warp shuffles,
//     then over the 8 warps in shared memory in rounds of 32 entries, and
//     land with one atomicAdd per (entry, channel) in the (N, 2) output, as
//     the backward kernel (rasterize_bwd.cu) reduces its gradients. Batches
//     after the early stop add nothing. Float atomics vary the order of the
//     importance sums from run to run, so it agrees with the plain version
//     to a tolerance; the counts are integers below 2^24 and exact.
//
// What bounds it on the card: the pair evaluations over the 67 TFLOP/s FP32
// rate (chip_smoke.py counts the operations of this body per pair outcome);
// the bytes (gids, six feature columns, the (N, 2) output) are far below.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int BLOCK = TILE * TILE;   // one thread per pixel
constexpr int WARPS = BLOCK / 32;
constexpr int BATCH = 256;           // entries staged in shared memory per round
constexpr int SUB = 32;              // entries per block-reduction round
constexpr int NCOL = 6;              // mean x, y, conic a, b, c, opacity
constexpr float ALPHA_EPS = 1.0f / 255.0f;
constexpr float ALPHA_CAP = 0.99f;
constexpr float T_EPS = 1e-4f;

// packed feature columns (vcr_gaus_tpu_torch/ops/projection.py)
constexpr int F_MEAN_X = 0, F_MEAN_Y = 1, F_CONIC_A = 2, F_CONIC_B = 3,
              F_CONIC_C = 4, F_OPACITY = 5;

__device__ __forceinline__ float warp_sum(float v)
{
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

__global__ void __launch_bounds__(BLOCK)
rasterize_stats_kernel(const float* __restrict__ feats, int nfeat,
                       const int* __restrict__ sorted_gid,
                       const int* __restrict__ tile_starts,
                       const int* __restrict__ tile_counts,
                       int n_tx, int width, int height,
                       float* __restrict__ stats)      // (N, 2), zeroed
{
    __shared__ float sf[NCOL][BATCH];
    __shared__ int sgid[BATCH];
    __shared__ float sred[WARPS][2][SUB];

    const int t = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int pxi = (t % n_tx) * TILE + tid % TILE;
    const int pyi = (t / n_tx) * TILE + tid / TILE;
    const float px = (float)pxi;
    const float py = (float)pyi;
    const bool inside = pxi < width && pyi < height;
    const int start = tile_starts[t];
    const int count = tile_counts[t];

    float T = 1.f;
    const int nbatch = (count + BATCH - 1) / BATCH;
    for (int k = 0; k < nbatch; ++k) {
        // tile-wide consensus (out-of-image pixels vote with T = 1); also
        // the barrier before the staged batch is overwritten
        if (!__syncthreads_or(T >= T_EPS)) break;
        const int base = k * BATCH;
        const int nb = min(BATCH, count - base);
        if (tid < nb) {
            const int gid = sorted_gid[start + base + tid];
            sgid[tid] = gid;
            const float* row = feats + (size_t)gid * nfeat;
#pragma unroll
            for (int c = 0; c < NCOL; ++c) sf[c][tid] = row[c];
        }
        __syncthreads();
        for (int j0 = 0; j0 < nb; j0 += SUB) {
            const int jn = min(SUB, nb - j0);
            for (int jj = 0; jj < jn; ++jj) {
                const int j = j0 + jj;
                float hit = 0.f, w = 0.f;
                if (inside) {
                    // the forward kernel's expressions, in its order
                    const float dx = px - sf[F_MEAN_X][j];
                    const float dy = py - sf[F_MEAN_Y][j];
                    const float power = -0.5f * (sf[F_CONIC_A][j] * dx * dx
                                                 + sf[F_CONIC_C][j] * dy * dy)
                                        - sf[F_CONIC_B][j] * dx * dy;
                    if (power <= 0.f) {
                        const float alpha_raw = sf[F_OPACITY][j] * expf(power);
                        if (alpha_raw >= ALPHA_EPS) {
                            const float alpha = fminf(alpha_raw, ALPHA_CAP);
                            hit = 1.f;
                            w = alpha * T;
                            T *= 1.f - alpha;
                        }
                    }
                }
                if (__any_sync(0xffffffffu, hit != 0.f)) {
                    hit = warp_sum(hit);
                    w = warp_sum(w);
                }
                if (lane == 0) {
                    sred[warp][0][jj] = hit;
                    sred[warp][1][jj] = w;
                }
            }
            __syncthreads();
            for (int i = tid; i < 2 * jn; i += BLOCK) {
                const int c = i / jn;
                const int jj = i - c * jn;
                float v = 0.f;
#pragma unroll
                for (int wp = 0; wp < WARPS; ++wp) v += sred[wp][c][jj];
                if (v != 0.f)
                    atomicAdd(stats + (size_t)sgid[j0 + jj] * 2 + c, v);
            }
            __syncthreads();
        }
    }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns the cudaError_t of the
// launch (0 = cudaSuccess); the kernel runs on `stream` and is not awaited.
// `stats` must be zeroed: the kernel adds into it.
extern "C" int vcr_rasterize_stats(const float* feats, int nfeat,
                                   const int* sorted_gid,
                                   const int* tile_starts,
                                   const int* tile_counts, int n_tx, int n_ty,
                                   int width, int height, float* stats,
                                   void* stream)
{
    const int num_tiles = n_tx * n_ty;
    if (num_tiles <= 0 || nfeat < NCOL) return (int)cudaErrorInvalidValue;
    rasterize_stats_kernel<<<num_tiles, BLOCK, 0, (cudaStream_t)stream>>>(
        feats, nfeat, sorted_gid, tile_starts, tile_counts, n_tx, width,
        height, stats);
    return (int)cudaGetLastError();
}
