// Backward tile compositing for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `rasterize_backward` -> `_bwd_kernel` of
// vcr_gaus_tpu/ops/rasterize_tpu.py (call at :831, body :568-798) together
// with the per-Gaussian reduction that follows it on the TPU path
// (`_segment_sum_grouped` and the entry-gather VJP,
// vcr_gaus_tpu/ops/rasterize.py:107-135). It computes what they compute, not
// a block-by-block copy:
//
//   * one block per 16x16 tile, one thread per pixel, the same batches of
//     256 depth-sorted entries as the forward kernel (rasterize_fwd.cu), and
//     only the batches that kernel composited (its per-tile `batches_done`,
//     the TPU's hidden k_done): later entries get no gradient;
//   * the walk is FRONT TO BACK. Each thread recomputes its transmittance T
//     exactly as the forward kernel does (same expressions, same order,
//     --fmad=false), so T is never divided and a pixel whose T underflows
//     in a saturated tile still gets exact weights. The upstream reverse
//     walk T <- T / (1 - alpha) from T_final breaks there; the TPU kernel
//     works in log space instead;
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
//   * the per-pixel terms of each entry are reduced inside the block, with
//     warp shuffles and then shared memory over 16-entry rounds, and each
//     (entry, channel) sum goes to the (N, 16 + S) per-Gaussian gradient
//     with one atomicAdd. Float atomics make the summation order vary from
//     run to run, so results agree with the plain version to a tolerance,
//     not bit for bit.
//
// What bounds it on the card: the pair evaluations over the 67 TFLOP/s FP32
// rate (chip_smoke.py counts the operations of this body per pair outcome);
// the bytes (gids, feature rows, two images, the gradient rows) are far
// below. This first version is plain: one thread per pixel, shuffles per
// live entry, no wgmma, TMA or warp specialization.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int BLOCK = TILE * TILE;   // one thread per pixel
constexpr int WARPS = BLOCK / 32;
constexpr int BATCH = 256;           // entries staged in shared memory per round
constexpr int SUB = 16;              // entries per block-reduction round
constexpr float ALPHA_EPS = 1.0f / 255.0f;
constexpr float ALPHA_CAP = 0.99f;

// packed feature columns (vcr_gaus_tpu_torch/ops/projection.py)
constexpr int F_MEAN_X = 0, F_MEAN_Y = 1, F_CONIC_A = 2, F_CONIC_B = 3,
              F_CONIC_C = 4, F_OPACITY = 5, F_DEPTH_Z = 6, F_PLANE_D = 7,
              F_NORMAL = 8;

__device__ __forceinline__ float warp_sum(float v)
{
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

template <int CH_SEM, bool INTERSECT>
__global__ void __launch_bounds__(BLOCK)
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
    constexpr int F = 14 + CH_SEM;
    constexpr int NG = F + 2;          // feature grads + |d mean2d| x, y
    constexpr int NACC = 6 + CH_SEM;   // composited columns: normal, rgb, sem
    __shared__ float sf[F][BATCH];
    __shared__ int sgid[BATCH];
    __shared__ float sred[WARPS][NG][SUB];

    const int t = blockIdx.x;
    const int nbatch = batches_done[t];
    if (nbatch == 0) return;           // uniform over the block
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

    float dirx = 0.f, diry = 0.f, dirz = 0.f;
    if (INTERSECT) {
        dirx = (px + 0.5f - cam[2]) / cam[0];
        diry = (py + 0.5f - cam[3]) / cam[1];
        const float inv_n = rsqrtf(dirx * dirx + diry * diry + 1.0f);
        dirx *= inv_n;
        diry *= inv_n;
        dirz = inv_n;
    }

    // the pixel's upstream gradient, its total S and background term
    float g_acc[NACC];
#pragma unroll
    for (int c = 0; c < NACC; ++c) g_acc[c] = 0.f;
    float g_d = 0.f, g_d2 = 0.f, s_total = 0.f, tb = 0.f;
    if (inside) {
        const size_t hw = (size_t)height * width;
        const size_t o = (size_t)pyi * width + pxi;
        const float t_final = 1.f - img[8 * hw + o];
        float b = -g_img[8 * hw + o];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            const float gr = g_img[c * hw + o];
            const float gn = g_img[(3 + c) * hw + o];
            g_acc[c] = gn;
            g_acc[3 + c] = gr;
            b += cam[4 + c] * gr;
            s_total += gr * (img[c * hw + o] - t_final * cam[4 + c])
                       + gn * img[(3 + c) * hw + o];
        }
#pragma unroll
        for (int c = 0; c < CH_SEM; ++c) {
            g_acc[6 + c] = g_img[(9 + c) * hw + o];
            s_total += g_acc[6 + c] * img[(9 + c) * hw + o];
        }
        g_d = g_img[6 * hw + o];
        g_d2 = g_img[7 * hw + o];
        s_total += g_d * img[6 * hw + o] + g_d2 * img[7 * hw + o];
        tb = t_final * b;
    }

    float T = 1.f;
    float prefix = 0.f;                // sum of w s over the entries so far
    for (int k = 0; k < nbatch; ++k) {
        const int base = k * BATCH;
        const int nb = min(BATCH, count - base);
        __syncthreads();               // the previous batch is fully reduced
        if (tid < nb) {
            const int gid = sorted_gid[start + base + tid];
            sgid[tid] = gid;
            const float* row = feats + (size_t)gid * F;
#pragma unroll
            for (int c = 0; c < F; ++c) sf[c][tid] = row[c];
        }
        __syncthreads();
        for (int j0 = 0; j0 < nb; j0 += SUB) {
            const int jn = min(SUB, nb - j0);
            for (int jj = 0; jj < jn; ++jj) {
                const int j = j0 + jj;
                float gr[NG];
#pragma unroll
                for (int c = 0; c < NG; ++c) gr[c] = 0.f;
                bool live = false;
                if (inside) {
                    // the forward kernel's expressions, so the liveness tests
                    // and T round exactly as they did there
                    const float dx = px - sf[F_MEAN_X][j];
                    const float dy = py - sf[F_MEAN_Y][j];
                    const float power = -0.5f * (sf[F_CONIC_A][j] * dx * dx
                                                 + sf[F_CONIC_C][j] * dy * dy)
                                        - sf[F_CONIC_B][j] * dx * dy;
                    float alpha_raw = 0.f;
                    if (power <= 0.f) {
                        alpha_raw = sf[F_OPACITY][j] * expf(power);
                        live = alpha_raw >= ALPHA_EPS;
                    }
                    if (live) {
                        const float alpha = fminf(alpha_raw, ALPHA_CAP);
                        const float w = alpha * T;
                        float d, denom = 1.f;
                        bool clamped = false;
                        if (INTERSECT) {
                            denom = dirx * sf[F_NORMAL][j]
                                    + diry * sf[F_NORMAL + 1][j]
                                    + dirz * sf[F_NORMAL + 2][j];
                            if (fabsf(denom) < 1e-2f) {
                                denom = denom < 0.f ? -1e-2f : 1e-2f;
                                clamped = true;
                            }
                            d = sf[F_PLANE_D][j] / denom;
                        } else {
                            d = sf[F_DEPTH_Z][j];
                        }
                        float s = 0.f;
#pragma unroll
                        for (int c = 0; c < NACC; ++c)
                            s += g_acc[c] * sf[F_NORMAL + c][j];
                        s += d * (g_d + d * g_d2);
                        prefix += w * s;
                        const float suffix = s_total - prefix;
                        const float dalpha = T * s - (suffix + tb) / (1.f - alpha);
                        const float dpw = alpha_raw > ALPHA_CAP ? 0.f
                                                                : dalpha * alpha;
                        const float A = sf[F_CONIC_A][j];
                        const float B = sf[F_CONIC_B][j];
                        const float C = sf[F_CONIC_C][j];
                        const float u1 = dpw * (A * dx + B * dy);
                        const float u2 = dpw * (C * dy + B * dx);
                        gr[F_MEAN_X] = u1;
                        gr[F_MEAN_Y] = u2;
                        gr[F_CONIC_A] = -0.5f * dpw * dx * dx;
                        gr[F_CONIC_B] = -dpw * dx * dy;
                        gr[F_CONIC_C] = -0.5f * dpw * dy * dy;
                        gr[F_OPACITY] = dpw / fmaxf(sf[F_OPACITY][j], 1e-12f);
                        const float gd = w * (g_d + 2.f * d * g_d2);
                        if (INTERSECT) {
                            const float inv = 1.f / denom;
                            gr[F_PLANE_D] = gd * inv;
                            const float coef = clamped ? 0.f
                                : -gd * sf[F_PLANE_D][j] * inv * inv;
                            gr[F_NORMAL] = coef * dirx;
                            gr[F_NORMAL + 1] = coef * diry;
                            gr[F_NORMAL + 2] = coef * dirz;
                        } else {
                            gr[F_DEPTH_Z] = gd;
                        }
#pragma unroll
                        for (int c = 0; c < NACC; ++c) gr[F_NORMAL + c] += w * g_acc[c];
                        gr[F] = fabsf(u1);
                        gr[F + 1] = fabsf(u2);
                        T *= 1.f - alpha;
                    }
                }
                if (__any_sync(0xffffffffu, live)) {
#pragma unroll
                    for (int c = 0; c < NG; ++c) {
                        const float v = warp_sum(gr[c]);
                        if (lane == 0) sred[warp][c][jj] = v;
                    }
                } else if (lane == 0) {
#pragma unroll
                    for (int c = 0; c < NG; ++c) sred[warp][c][jj] = 0.f;
                }
            }
            __syncthreads();
            for (int i = tid; i < NG * jn; i += BLOCK) {
                const int c = i / jn;
                const int jj = i - c * jn;
                float v = 0.f;
#pragma unroll
                for (int wp = 0; wp < WARPS; ++wp) v += sred[wp][c][jj];
                if (v != 0.f)
                    atomicAdd(grad + (size_t)sgid[j0 + jj] * NG + c, v);
            }
            __syncthreads();
        }
    }
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
        rasterize_bwd_kernel<CH_SEM, true><<<num_tiles, BLOCK, 0, stream>>>(
            feats, sorted_gid, tile_starts, tile_counts, batches_done, cam,
            img, g_img, n_tx, width, height, grad);
    else
        rasterize_bwd_kernel<CH_SEM, false><<<num_tiles, BLOCK, 0, stream>>>(
            feats, sorted_gid, tile_starts, tile_counts, batches_done, cam,
            img, g_img, n_tx, width, height, grad);
    return cudaGetLastError();
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
