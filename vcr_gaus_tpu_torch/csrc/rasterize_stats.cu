// Per-Gaussian visibility and importance stats for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `rasterize_stats` -> `_stats_kernel` of
// vcr_gaus_tpu/ops/rasterize_tpu.py (body :846-920, call :948) together
// with the per-Gaussian scatter that follows it on the TPU path
// (`.at[gid].add(mode="drop")`, vcr_gaus_tpu/ops/rasterize.py:287-289). For
// every Gaussian it computes, over one view:
//
//   count = the live (pixel, entry) pairs of its entries: power <= 0,
//           op e^power >= 1/255, the pixel inside the image;
//   imp   = sum over those pairs of min(op e^power, 0.99) T, the
//           LightGaussian importance (blending weight).
//
// The walk is the forward kernel's (rasterize_fwd.cu): one block per 16x16
// tile, the tile's depth-sorted entries staged in shared memory in batches
// of 256, T carried front to back per pixel with the expressions of
// composite_pair.cuh under --fmad=false, so liveness agrees with the plain
// version pair by pair. Pixels outside the image (the ragged edge of a
// tile) never composite and keep T = 1, as the TPU kernel's `pvalid` makes
// them. They still vote in the tile-wide early stop (__syncthreads_or(T >=
// 1e-4) before each batch), so a ragged tile never stops early here, while
// the forward kernel, which composites them, can stop it. Batches after the
// stop add nothing.
//
// What bounds it on the card: the pair evaluations over the 67 TFLOP/s FP32
// rate. chip_smoke.py counts the operations per pair outcome (OPS_PAIR for
// every pair, OPS_POWER_PASS more past the power test, OPS_STATS_LIVE more
// for a live one); the bytes (gids, six feature columns, the (N, 2) output)
// are far below. A thread per pixel ran 10-11x that bound. Its pair
// arithmetic (an expf on every pair) took 72% of the time and its
// per-entry reduction (two 5-step shuffle sums on every warp step with a
// live lane, two barriers every 32 entries) 28%; and a tile's walk is a
// serial chain per warp, so the heaviest tiles (4.4x the median tile's
// entries on the densify view) set a long tail. This design:
//   * runs 2 pixels a thread (128 threads) on the 8x8 warp patches of
//     composite_pair.cuh's PixelMap, and stages each entry's front end as
//     K1 does: a thread reads two 16-byte broadcasts per entry for its 2
//     pixels, which share the x offset;
//   * takes the dead-pair threshold (`pair_near`): the expf of a certainly
//     dead pair is skipped without changing any pair's outcome (the
//     header's derivation; the test is K1's), and a warp step on which no
//     pixel passes it does nothing more;
//   * runs a thread's two pixels without a branch between them (a dead
//     pixel takes alpha = 0, which leaves T and the sums exactly as they
//     are), and unrolls the walk by 4 entries, so that the chains of both
//     pixels and of neighbouring entries overlap: with half the warps of a
//     thread per pixel, a tile's walk would otherwise be twice as long;
//   * counts a warp's hits with ballots, exactly and without shuffles,
//     and sums its weights in one 5-step butterfly, after each thread has
//     added its own two pixels', only on a step whose ballot is non-zero;
//   * lane 0 writes the warp's (count, weight) of every entry of the batch
//     into one row pair per warp; the block meets once after the batch,
//     and each thread adds 2 entries over the 4 warps and makes one
//     float2 atomic add for each entry that a pixel hit. That is 3
//     barriers a batch where the old design met at 17.
// Float atomics vary the order of the importance sums from run to run, so
// it agrees with the plain version to a tolerance; the counts are integers
// below 2^24 and exact.

#include <cuda_runtime.h>

#include "composite_pair.cuh"

namespace {

using namespace vcr;

constexpr int NCOL = F_OPACITY + 1;  // mean x, y, conic a, b, c, opacity

__device__ __forceinline__ float warp_sum(float v)
{
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    return v;
}

// one entry's (count, importance) into its row of the (N, 2) output
__device__ __forceinline__ void add_stats(float* dst, float hits, float w)
{
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(hits, w));
}

__global__ void __launch_bounds__(PixelMap::THREADS)
rasterize_stats_kernel(const float* __restrict__ feats, int nfeat,
                       const int* __restrict__ sorted_gid,
                       const int* __restrict__ tile_starts,
                       const int* __restrict__ tile_counts,
                       int n_tx, int width, int height,
                       float* __restrict__ stats)      // (N, 2), zeroed
{
    using Map = PixelMap;
    constexpr int P = Map::P;
    constexpr int WARPS = Map::WARPS;
    __shared__ Front s0[BATCH];
    __shared__ Front2 s1[BATCH];
    __shared__ int sgid[BATCH];
    __shared__ int shits[WARPS][BATCH];      // per warp and entry
    __shared__ float sw[WARPS][BATCH];

    const int t = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    int lx, ly0;
    Map::first(tid, lx, ly0);
    const int pxi = (t % n_tx) * TILE + lx;
    const int py0 = (t / n_tx) * TILE + ly0;
    const float px = (float)pxi;
    const int start = tile_starts[t];
    const int count = tile_counts[t];

    float py[P], T[P];
    bool inside[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
        const int pyi = py0 + k * Map::LY;
        py[k] = (float)pyi;
        inside[k] = pxi < width && pyi < height;
        T[k] = 1.f;
    }

    const int nbatch = (count + BATCH - 1) / BATCH;
    for (int kb = 0; kb < nbatch; ++kb) {
        // tile-wide consensus (out-of-image pixels vote with T = 1); also
        // the barrier before the stage and the rows are overwritten
        bool alive = false;
#pragma unroll
        for (int k = 0; k < P; ++k) alive |= T[k] >= T_EPS;
        if (!__syncthreads_or(alive)) break;
        const int base = kb * BATCH;
        const int nb = min(BATCH, count - base);
        for (int e = tid; e < nb; e += Map::THREADS) {
            const int gid = sorted_gid[start + base + e];
            const float* row = feats + (size_t)gid * nfeat;
            const float op = row[F_OPACITY];
            sgid[e] = gid;
            s0[e] = Front{row[F_MEAN_X], row[F_MEAN_Y], row[F_CONIC_A],
                          row[F_CONIC_B]};
            s1[e] = Front2{row[F_CONIC_C], dead_threshold(op), op, 0.f};
        }
        __syncthreads();
#pragma unroll 4
        for (int j = 0; j < nb; ++j) {
            const Front f0 = s0[j];
            const Front2 f1 = s1[j];
            const float dx = px - f0.mx;
            float power[P], alpha_raw[P];
            bool near[P];
            bool any_near = false;
#pragma unroll
            for (int k = 0; k < P; ++k) {
                alpha_raw[k] = 0.f;
                power[k] = pair_power(dx, py[k] - f0.my, f0.a, f0.b, f1.c);
                near[k] = inside[k] && pair_near(power[k], f1.thr);
                any_near |= near[k];
            }
            float w = 0.f;
            int hits = 0;
            // a warp step with no pixel past the threshold hits nothing
            if (__any_sync(FULL, any_near)) {
                if (any_near) {
#pragma unroll
                    for (int k = 0; k < P; ++k)
                        alpha_raw[k] = f1.op * expf(power[k]);
                }
                unsigned any = 0u;
#pragma unroll
                for (int k = 0; k < P; ++k) {
                    const bool live = near[k] && alpha_raw[k] >= ALPHA_EPS;
                    // a dead pixel takes alpha = 0: w gains +0, T is
                    // times 1
                    const float alpha = live ? fminf(alpha_raw[k], ALPHA_CAP)
                                             : 0.f;
                    w += alpha * T[k];
                    T[k] *= 1.f - alpha;
                    const unsigned ballot = __ballot_sync(FULL, live);
                    hits += __popc(ballot);
                    any |= ballot;
                }
                if (any) w = warp_sum(w);      // uniform over the warp
            }
            if (lane == 0) {
                shits[warp][j] = hits;
                sw[warp][j] = w;
            }
        }
        __syncthreads();
        for (int e = tid; e < nb; e += Map::THREADS) {
            int hits = 0;
            float w = 0.f;
#pragma unroll
            for (int wp = 0; wp < WARPS; ++wp) {
                hits += shits[wp][e];
                w += sw[wp][e];
            }
            if (hits) add_stats(stats + (size_t)sgid[e] * 2, (float)hits, w);
        }
    }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns the cudaError_t of the
// launch (0 = cudaSuccess); the kernel runs on `stream` and is not awaited.
// `stats` must be zeroed (the kernel adds into it) and 8-byte aligned.
extern "C" int vcr_rasterize_stats(const float* feats, int nfeat,
                                   const int* sorted_gid,
                                   const int* tile_starts,
                                   const int* tile_counts, int n_tx, int n_ty,
                                   int width, int height, float* stats,
                                   void* stream)
{
    const int num_tiles = n_tx * n_ty;
    if (num_tiles <= 0 || nfeat < NCOL) return (int)cudaErrorInvalidValue;
    rasterize_stats_kernel<<<num_tiles, PixelMap::THREADS, 0,
                             (cudaStream_t)stream>>>(
        feats, nfeat, sorted_gid, tile_starts, tile_counts, n_tx, width,
        height, stats);
    return (int)cudaGetLastError();
}
