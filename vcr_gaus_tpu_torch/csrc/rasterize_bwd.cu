// Backward tile compositing for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `rasterize_backward` -> `_bwd_kernel` of
// vcr_gaus_tpu/ops/rasterize_tpu.py (call at :831, body :568-798) together
// with the per-Gaussian reduction that follows it on the TPU path
// (`_segment_sum_grouped` and the entry-gather VJP,
// vcr_gaus_tpu/ops/rasterize.py:107-135). It computes what they compute, not
// a block-by-block copy:
//
//   * one block per 16x16 tile, 2 pixels a thread (128 threads) on the
//     pixel-to-thread map of composite_pair.cuh, the same batches of 256
//     depth-sorted entries as the
//     forward kernel (rasterize_fwd.cu), and only the batches that kernel
//     composited (its per-tile `batches_done`, the TPU's hidden k_done):
//     later entries get no gradient;
//   * the walk is FRONT TO BACK. Each pixel's transmittance T is recomputed
//     exactly as the forward kernel computes it (the same front end from
//     composite_pair.cuh, the same order, --fmad=false), so T is never
//     divided and a pixel whose T underflows in a saturated tile still gets
//     exact weights. The upstream reverse walk T <- T / (1 - alpha) from
//     T_final breaks there; the TPU kernel works in log space instead;
//   * the suffix sum_{i>j} w_i s_i of the later entries is the pixel's total
//     S minus the running prefix. S comes from the forward image:
//       S = g_rgb.(rgb - T_final bg) + g_nrm.nrm + g_d d + g_d2 d^2
//           + g_sem.sem,  T_final = 1 - alpha,
//     and T_final enters only the background term b = bg.g_rgb - g_alpha:
//       dL/dalpha_j = T_j s_j - (suffix_j + T_final b) / (1 - alpha_j);
//   * where alpha was capped at 0.99 no gradient reaches the power (opacity,
//     mean, conic); where the |ray . n| >= 1e-2 clamp was active none
//     reaches the normal through the depth; dead pairs (power > 0 or
//     alpha < 1/255) and pixels outside the image contribute nothing;
//   * the |d mean2d| densification stream is the sum over pixels of
//     |dpower * (A dx + B dy)| (and the y counterpart): a sum of absolute
//     values, not the absolute value of the sum;
//   * each (entry, channel) sum goes to the (N, 16 + S) per-Gaussian
//     gradient with one atomicAdd per block. Float atomics make the
//     summation order vary from run to run, so results agree with the plain
//     version to a tolerance, not bit for bit.
//
// What bounds it on the card: the pair evaluations over the 67 TFLOP/s FP32
// rate (chip_smoke.py counts the operations of this body per pair outcome);
// the bytes (gids, feature rows, two images, the gradient rows) are far
// below. A thread per pixel ran 12x that bound: its per-entry reduction
// cost a warp 5 shuffles for each of the 16 + S
// channels on every entry where one lane was live, lane 0 then wrote the
// warp's sums to shared memory, and the block met at two barriers every 16
// entries to add the warps' sums and issue the atomics. This design:
//   * reduces a warp's 16 + S channels, padded to NGP = 16 or 32, with a
//     transpose (reduce-scatter) butterfly: at each step a lane sends half of
//     its remaining values to its partner and keeps the sum of the other
//     half, so after log2(NGP) steps lane c holds one channel's warp sum:
//     8 + 4 + 2 + 1 shuffles (and one more to join the two half-warps) at
//     S = 0, 31 for S up to 16, where the old sum took 5 per channel;
//   * gives each thread 2 pixels, on compact 8x8 warp patches: an entry's
//     shared-memory words are read once per thread for both, their terms
//     are summed in registers before the warp reduction, and a warp steps
//     through an entry for 64 pixels at once;
//   * each warp writes its per-entry sums as one row of NG floats into
//     shared memory; the block adds the warps' rows and issues the atomics
//     once per SUB = 256 / WARPS = 64 entries, not every 16, so it meets at
//     10 barriers a batch instead of 34. The stage and the rows take 31-48
//     KB of dynamic shared memory;
//   * the dead-pair threshold of composite_pair.cuh spares the expf of every
//     pair below it without changing any pair's outcome, so T and the
//     liveness stay those of the forward kernel bit for bit;
//   * the gradient terms take explicit fmaf and __fdividef (the depth's
//     denominator has |ray . n| >= 1e-2, 1 - alpha >= 0.01); neither enters
//     a liveness test or T.

#include <cuda_runtime.h>

#include "composite_pair.cuh"

namespace {

using namespace vcr;

// One step of the transpose reduction over a warp: H values kept of 2 H,
// partner lane ^ O. The lane whose bit O is set keeps the upper half.
template <int H, int O>
struct ReduceScatter {
    static __device__ __forceinline__ void run(float* v, int lane)
    {
        const bool upper = (lane & O) != 0;
#pragma unroll
        for (int i = 0; i < H; ++i) {
            const float send = upper ? v[i] : v[i + H];
            const float keep = upper ? v[i + H] : v[i];
            v[i] = keep + __shfl_xor_sync(FULL, send, O);
        }
        ReduceScatter<H / 2, O / 2>::run(v, lane);
    }
};
template <int O>
struct ReduceScatter<0, O> {
    static __device__ __forceinline__ void run(float*, int) {}
};

// The warp sums of v[0..N) (N = 16 or 32): returns the sum of the channel
// `warp_channel<N>(lane)`.
template <int N>
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[N], int lane)
{
    static_assert(N == 16 || N == 32, "16 or 32 channels");
    ReduceScatter<N / 2, 16>::run(v, lane);
    // N = 16: four steps left lanes l and l ^ 1 with halves of one channel
    return N == 16 ? v[0] + __shfl_xor_sync(FULL, v[0], 1) : v[0];
}

template <int N>
__device__ __forceinline__ int warp_channel(int lane)
{
    return N == 16 ? lane >> 1 : lane;
}

template <int CH_SEM>
constexpr int shared_bytes()
{
    constexpr int NG = 16 + CH_SEM;
    constexpr int NACC = 6 + CH_SEM;
    // the stage (two front-end words, the composited columns, the gid) and
    // one row of sums per (warp, entry of a round)
    return BATCH * (int)(2 * sizeof(Front) + (NACC + 1) * sizeof(float))
           + BATCH * NG * (int)sizeof(float);
}

template <int CH_SEM, bool INTERSECT>
__global__ void __launch_bounds__(PixelMap::THREADS)
rasterize_bwd_kernel(const float* __restrict__ feats,
                     const int* __restrict__ sorted_gid,
                     const int* __restrict__ tile_starts,
                     const int* __restrict__ tile_counts,
                     const int* __restrict__ batches_done,
                     const float* __restrict__ cam,   // fx fy cx cy bg_r bg_g bg_b 0
                     const float* __restrict__ img,   // forward image (9+S, H, W)
                     const float* __restrict__ g_img, // its gradient (9+S, H, W)
                     int n_tx, int width, int height,
                     float* __restrict__ grad)        // (N, 16+S), zeroed
{
    using Map = PixelMap;
    constexpr int P = Map::P;
    constexpr int F = 14 + CH_SEM;
    constexpr int NG = F + 2;          // feature grads + |d mean2d| x, y
    constexpr int NGP = NG <= 16 ? 16 : 32;
    constexpr int NACC = 6 + CH_SEM;   // composited columns: normal, rgb, sem
    constexpr int WARPS = Map::WARPS;
    constexpr int SUB = BATCH / WARPS; // entries a block-reduction round
    static_assert(NG <= 32, "at most 16 semantic channels");

    extern __shared__ float4 smem[];
    Front* s0 = reinterpret_cast<Front*>(smem);
    Front2* s1 = reinterpret_cast<Front2*>(s0 + BATCH);
    float* sacc = reinterpret_cast<float*>(s1 + BATCH);   // [NACC][BATCH]
    int* sgid = reinterpret_cast<int*>(sacc + NACC * BATCH);
    float* spart = reinterpret_cast<float*>(sgid + BATCH); // [WARPS][SUB][NG]

    const int t = blockIdx.x;
    const int nbatch = batches_done[t];
    if (nbatch == 0) return;           // uniform over the block
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

    // each pixel's ray, upstream gradient, total S and background term
    float py[P], dirx[P], diry[P], dirz[P];
    bool inside[P];
    float g_acc[P][NACC], g_d[P], g_d2[P], s_total[P], tb[P];
    const size_t hw = (size_t)height * width;
#pragma unroll
    for (int k = 0; k < P; ++k) {
        const int pyi = py0 + k * Map::LY;
        py[k] = (float)pyi;
        dirx[k] = diry[k] = dirz[k] = 0.f;
        if (INTERSECT) pixel_ray(px, py[k], cam, dirx[k], diry[k], dirz[k]);
        inside[k] = pxi < width && pyi < height;
#pragma unroll
        for (int c = 0; c < NACC; ++c) g_acc[k][c] = 0.f;
        g_d[k] = g_d2[k] = s_total[k] = tb[k] = 0.f;
        if (!inside[k]) continue;
        const size_t o = (size_t)pyi * width + pxi;
        const float t_final = 1.f - img[8 * hw + o];
        float b = -g_img[8 * hw + o];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            const float gr = g_img[c * hw + o];
            const float gn = g_img[(3 + c) * hw + o];
            g_acc[k][c] = gn;
            g_acc[k][3 + c] = gr;
            b += cam[4 + c] * gr;
            s_total[k] += gr * (img[c * hw + o] - t_final * cam[4 + c])
                          + gn * img[(3 + c) * hw + o];
        }
#pragma unroll
        for (int c = 0; c < CH_SEM; ++c) {
            g_acc[k][6 + c] = g_img[(9 + c) * hw + o];
            s_total[k] += g_acc[k][6 + c] * img[(9 + c) * hw + o];
        }
        g_d[k] = g_img[6 * hw + o];
        g_d2[k] = g_img[7 * hw + o];
        s_total[k] += g_d[k] * img[6 * hw + o] + g_d2[k] * img[7 * hw + o];
        tb[k] = t_final * b;
    }

    float T[P], prefix[P];             // prefix: sum of w s so far
#pragma unroll
    for (int k = 0; k < P; ++k) T[k] = 1.f, prefix[k] = 0.f;

    const int ch = warp_channel<NGP>(lane);
    const bool writer = ch < NG && (NGP == 32 || (lane & 1) == 0);
    for (int kb = 0; kb < nbatch; ++kb) {
        const int base = kb * BATCH;
        const int nb = min(BATCH, count - base);
        __syncthreads();               // the previous batch is fully reduced
        for (int e = tid; e < nb; e += Map::THREADS) {
            const int gid = sorted_gid[start + base + e];
            const float* row = feats + (size_t)gid * F;
            const float op = row[F_OPACITY];
            sgid[e] = gid;
            s0[e] = Front{row[F_MEAN_X], row[F_MEAN_Y], row[F_CONIC_A],
                          row[F_CONIC_B]};
            s1[e] = Front2{row[F_CONIC_C], dead_threshold(op), op,
                           row[INTERSECT ? F_PLANE_D : F_DEPTH_Z]};
#pragma unroll
            for (int c = 0; c < NACC; ++c)
                sacc[c * BATCH + e] = row[F_NORMAL + c];
        }
        __syncthreads();
        for (int j0 = 0; j0 < nb; j0 += SUB) {
            const int jn = min(SUB, nb - j0);
            for (int jj = 0; jj < jn; ++jj) {
                const int j = j0 + jj;
                float* out_row = spart + (warp * SUB + jj) * NG;
                const Front f0 = s0[j];
                const Front2 f1 = s1[j];
                const float dx = px - f0.mx;
                float dy[P], alpha_raw[P];
                bool live[P];
                bool any = false;
#pragma unroll
                for (int k = 0; k < P; ++k) {
                    dy[k] = py[k] - f0.my;
                    live[k] = inside[k]
                              && pair_live(pair_power(dx, dy[k], f0.a, f0.b,
                                                      f1.c),
                                           f1.thr, f1.op, alpha_raw[k]);
                    any |= live[k];
                }
                if (!__any_sync(FULL, any)) {
                    if (writer) out_row[ch] = 0.f;
                    continue;
                }
                float gs[NGP];
#pragma unroll
                for (int c = 0; c < NGP; ++c) gs[c] = 0.f;
                if (any) {
                    float col[NACC];
#pragma unroll
                    for (int c = 0; c < NACC; ++c) col[c] = sacc[c * BATCH + j];
                    const float adx = f0.a * dx, bdx = f0.b * dx;
                    const float dx2 = dx * dx;
#pragma unroll
                    for (int k = 0; k < P; ++k) {
                        if (!live[k]) continue;
                        const float alpha = fminf(alpha_raw[k], ALPHA_CAP);
                        const float w = alpha * T[k];
                        float d = f1.d, inv = 1.f;
                        bool clamped = false;
                        if (INTERSECT) {
                            inv = __fdividef(1.f, clamped_denom(
                                dirx[k], diry[k], dirz[k], col[0], col[1],
                                col[2], clamped));
                            d = f1.d * inv;
                        }
                        float s = 0.f;
#pragma unroll
                        for (int c = 0; c < NACC; ++c)
                            s = fmaf(g_acc[k][c], col[c], s);
                        s = fmaf(d, fmaf(d, g_d2[k], g_d[k]), s);
                        prefix[k] = fmaf(w, s, prefix[k]);
                        const float suffix = s_total[k] - prefix[k];
                        const float dalpha = fmaf(
                            T[k], s, -__fdividef(suffix + tb[k], 1.f - alpha));
                        const float dpw = alpha_raw[k] > ALPHA_CAP
                                              ? 0.f : dalpha * alpha;
                        const float u1 = dpw * fmaf(f0.b, dy[k], adx);
                        const float u2 = dpw * fmaf(f1.c, dy[k], bdx);
                        gs[F_MEAN_X] += u1;
                        gs[F_MEAN_Y] += u2;
                        gs[F_CONIC_A] = fmaf(-0.5f * dpw, dx2, gs[F_CONIC_A]);
                        gs[F_CONIC_B] = fmaf(-dpw, dx * dy[k], gs[F_CONIC_B]);
                        gs[F_CONIC_C] = fmaf(-0.5f * dpw, dy[k] * dy[k],
                                             gs[F_CONIC_C]);
                        // divided by the opacity once, after the sums
                        gs[F_OPACITY] += dpw;
                        const float gd = w * fmaf(2.f * d, g_d2[k], g_d[k]);
                        if (INTERSECT) {
                            gs[F_PLANE_D] = fmaf(gd, inv, gs[F_PLANE_D]);
                            const float coef = clamped ? 0.f
                                                       : -gd * f1.d * inv * inv;
                            gs[F_NORMAL] = fmaf(coef, dirx[k], gs[F_NORMAL]);
                            gs[F_NORMAL + 1] = fmaf(coef, diry[k],
                                                    gs[F_NORMAL + 1]);
                            gs[F_NORMAL + 2] = fmaf(coef, dirz[k],
                                                    gs[F_NORMAL + 2]);
                        } else {
                            gs[F_DEPTH_Z] += gd;
                        }
#pragma unroll
                        for (int c = 0; c < NACC; ++c)
                            gs[F_NORMAL + c] = fmaf(w, g_acc[k][c],
                                                    gs[F_NORMAL + c]);
                        gs[F] += fabsf(u1);
                        gs[F + 1] += fabsf(u2);
                        T[k] *= 1.f - alpha;
                    }
                }
                float v = warp_reduce_scatter<NGP>(gs, lane);
                if (ch == F_OPACITY) v /= fmaxf(f1.op, 1e-12f);
                if (writer) out_row[ch] = v;
            }
            __syncthreads();
            for (int i = tid; i < NG * jn; i += Map::THREADS) {
                const int jj = i / NG;
                const int c = i - jj * NG;
                float v = 0.f;
#pragma unroll
                for (int wp = 0; wp < WARPS; ++wp)
                    v += spart[(wp * SUB + jj) * NG + c];
                if (v != 0.f)
                    atomicAdd(grad + (size_t)sgid[j0 + jj] * NG + c, v);
            }
            __syncthreads();
        }
    }
}

template <int CH_SEM, bool INTERSECT>
cudaError_t launch_one(int num_tiles, cudaStream_t stream,
                       const float* feats, const int* sorted_gid,
                       const int* tile_starts, const int* tile_counts,
                       const int* batches_done, const float* cam,
                       const float* img, const float* g_img, int n_tx,
                       int width, int height, float* grad)
{
    auto kern = rasterize_bwd_kernel<CH_SEM, INTERSECT>;
    constexpr int bytes = shared_bytes<CH_SEM>();
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    kern<<<num_tiles, PixelMap::THREADS, bytes, stream>>>(
        feats, sorted_gid, tile_starts, tile_counts, batches_done, cam, img,
        g_img, n_tx, width, height, grad);
    return cudaGetLastError();
}

template <int CH_SEM>
cudaError_t launch(bool intersect, int num_tiles, cudaStream_t stream,
                   const float* feats, const int* sorted_gid,
                   const int* tile_starts, const int* tile_counts,
                   const int* batches_done, const float* cam,
                   const float* img, const float* g_img, int n_tx, int width,
                   int height, float* grad)
{
    if (intersect)
        return launch_one<CH_SEM, true>(num_tiles, stream, feats, sorted_gid,
                                        tile_starts, tile_counts,
                                        batches_done, cam, img, g_img, n_tx,
                                        width, height, grad);
    return launch_one<CH_SEM, false>(num_tiles, stream, feats, sorted_gid,
                                     tile_starts, tile_counts, batches_done,
                                     cam, img, g_img, n_tx, width, height,
                                     grad);
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns the cudaError_t of the
// launch (0 = cudaSuccess); the kernel runs on `stream` and is not awaited.
// `grad` must be zeroed: the kernel adds into it.
extern "C" int vcr_rasterize_bwd(const float* feats, const int* sorted_gid,
                                 const int* tile_starts, const int* tile_counts,
                                 const int* batches_done, const float* cam,
                                 const float* img, const float* g_img,
                                 int n_tx, int n_ty, int width, int height,
                                 int ch_sem, int intersect, float* grad,
                                 void* stream)
{
    const int num_tiles = n_tx * n_ty;
    if (num_tiles <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const bool inter = intersect != 0;
#define VCR_CASE(S)                                                          \
    case S:                                                                  \
        return (int)launch<S>(inter, num_tiles, s, feats, sorted_gid,        \
                              tile_starts, tile_counts, batches_done, cam,   \
                              img, g_img, n_tx, width, height, grad);
    switch (ch_sem) {
        VCR_CASE(0) VCR_CASE(1) VCR_CASE(2) VCR_CASE(3) VCR_CASE(4)
        VCR_CASE(5) VCR_CASE(6) VCR_CASE(7) VCR_CASE(8)
        default:
            return (int)cudaErrorInvalidValue;
    }
#undef VCR_CASE
}
