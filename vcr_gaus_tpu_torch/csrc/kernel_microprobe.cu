// The forward-loop microprobe (K4) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel `kernel` built by `build` in main() of
// scripts/kernel_microprobe.py (body :60-186, pallas_call :205). It
// computes each variant's function as vcr_gaus_tpu_torch/ops/microprobe.py
// defines it, not a copy of the TPU blocks: the triangular matmuls of the
// transmittance prefix become a running sum per pixel, the DMA double buffer
// a ring of cp.async stages. Its purpose is to attribute the cost of the
// forward kernel's loop (csrc/rasterize_fwd.cu) on the card, component by
// component: the transcendentals, the running prefix, the channel
// accumulation, the depth block, staging depth, chunk size, unroll. So it
// runs that loop's shape:
//   * one block per 32x32 tile, 2 pixels a thread (512 threads, 16 warps)
//     on the 8x8 warp patches of composite_pair.cuh's TilePixelMap: a
//     thread's two pixels share their column and so the x offset;
//   * rows 0..11 of each chunk (the only rows the body reads) are staged in
//     shared memory, 12 x Gc floats a stage, in a ring of `depth` stages
//     filled by 16-byte cp.async copies with depth - 1 chunks in flight:
//     the counterpart of the TPU's DMA ring (a stage is 6-24 KB, the ring
//     up to 96 KB for depth 4 at Gc 512);
//   * once a chunk's copies have landed, one pass of the block repacks each
//     entry's front end into the forward kernel's two 16-byte words (mean,
//     conic, the dead-pair threshold, the opacity, the depth; 8-16 KB
//     more), so a pair reads two broadcasts, not six scalars. The
//     exponential-alpha variants take the forward kernel's dead-pair
//     threshold and live test (`pair_near`, then the exact test), which
//     never change a pair's outcome; no_exp's linear test and the variants
//     without alpha keep their exact, test-free paths. The normal and
//     accumulated rows are read from the stage, once for both pixels, only
//     when one is live;
//   * a thread's two pixels run their tests, alphas and live bodies
//     without a branch between them (a dead pixel of a live step takes
//     alpha = 0, which adds nothing), so that their chains overlap: on the
//     probe's inputs every Gaussian sits at a tile's corner, so one warp
//     of every tile has a live lane on every entry. Here alone it departs
//     from the forward kernel, which branches per pixel;
//   * the block meets at three barriers a chunk (before the refill, after
//     the copies land, after the repack), each over 16 warps, and
//     __launch_bounds__(512, 2) holds a thread to 64 registers, so that two
//     tiles share an SM: a tile's time is its busiest warp's serial walk;
//   * each thread keeps its pixels' running log-prefix and 9 non-zero
//     channels in registers; the prefix restarts at every chunk, as the
//     probe's transmittance does;
//   * the switches, Gc, depth and unroll are template parameters; unroll
//     steps `unroll` guarded chunk bodies per loop iteration, as the script
//     does. The 14 variants of ops/microprobe.VARIANTS are instantiated;
//   * a thread skips an entry on which neither of its pixels is live, as
//     the forward kernel does. The TPU loop is branchless, so the card's
//     ablation deltas have to be read with each variant's live share: on
//     the probe's inputs 2.3% of the pairs are live with the exponential
//     alpha and 29.9% with the linear one (no_exp);
//   * the accumulations take explicit fmaf and the depth __fdividef (2 ulp
//     where |denom| >= 1e-2), as in the forward kernel; built with
//     --fmad=false, so the liveness tests round as in the plain version.
//
// What bounds it: operations, not bytes. At the protocol shape (1900 tiles
// x 1536 entries x 1024 pixels = 2.99G pairs) it reads 12 rows x 4 B x
// 2.92M entries = 140 MB and writes 78 MB, 0.07 ms of HBM at 3.35 TB/s,
// against about 0.7 ms of FP32 at 67 TFLOP/s for the ~16 operations per
// pair of `full` (12 for every pair, 3 more past the power test, 31 more
// for a live one; tools/kernel_microprobe.py counts them per variant).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "composite_pair.cuh"

namespace {

constexpr int SIDE = 32;
constexpr int NPIX = SIDE * SIDE;
using Map = vcr::TilePixelMap<SIDE>;
constexpr int THREADS = Map::THREADS;
constexpr int P = Map::P;
constexpr int NROW = 12;             // feature rows the body reads
constexpr int OUT_CH = 10;

// feature rows: mean x, y, conic a, b, c, opacity, then depth (also the
// first accumulated row) and the normal
constexpr int R_MX = 0, R_MY = 1, R_A = 2, R_B = 3, R_C = 4, R_OP = 5,
              R_DZ = 6, R_N = 7;

template <int DEPTH, int GC>
constexpr int shared_bytes()
{
    return DEPTH * NROW * GC * (int)sizeof(float)
           + GC * (int)(sizeof(vcr::Front) + sizeof(vcr::Front2));
}

// Start the copies of rows 0..11 of columns [col0, col0 + GC) into one
// stage; each thread issues its share of the 16-byte pieces.
template <int GC>
__device__ __forceinline__ void stage_chunk(float* dst,
                                            const float* __restrict__ feats,
                                            long long e, long long col0,
                                            int tid)
{
    constexpr int PER_ROW = GC / 4;
    for (int i = tid; i < NROW * PER_ROW; i += THREADS) {
        const int r = i / PER_ROW;
        const int q = i - r * PER_ROW;
        __pipeline_memcpy_async(dst + r * GC + 4 * q,
                                feats + r * e + col0 + 4 * q, 16);
    }
}

template <bool DEPTH_ON, bool TRI, bool DACC, bool EXP, bool ALPHA,
          int DEPTH, int GC, int UNROLL>
__global__ void __launch_bounds__(THREADS, 2)
kernel_microprobe(const float* __restrict__ feats,  // (24, e)
                  long long e,
                  const int* __restrict__ starts,
                  const int* __restrict__ counts,
                  float* __restrict__ out)          // (tiles, 1024, 10)
{
    constexpr bool EXP_ALPHA = EXP && ALPHA;
    extern __shared__ __align__(16) float smem[];
    float* ring = smem;                              // DEPTH x NROW x GC
    vcr::Front* s0 = reinterpret_cast<vcr::Front*>(ring + DEPTH * NROW * GC);
    vcr::Front2* s1 = reinterpret_cast<vcr::Front2*>(s0 + GC);

    const int t = blockIdx.x;
    const int tid = threadIdx.x;
    int lx, ly0;
    Map::first(tid, lx, ly0);
    const float px = (float)lx;
    const long long start = starts[t];
    const int nchunks = counts[t] / GC;

    // each pixel's unit ray through its centre, scaled as the probe does
    float py[P], rx[P], ry[P], rz[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
        py[k] = (float)(ly0 + k * Map::LY);
        rx[k] = ry[k] = rz[k] = 0.f;
        if (DEPTH_ON) {
            const float dirx = (px + 0.5f - 16.0f) / 30.0f;
            const float diry = (py[k] + 0.5f - 16.0f) / 30.0f;
            const float inv_n = rsqrtf(dirx * dirx + diry * diry + 1.0f);
            rx[k] = dirx * inv_n;
            ry[k] = diry * inv_n;
            rz[k] = inv_n;
        }
    }

    float acc_csum[P], acc_wd[P], acc_wd2[P], acc_f[P][6];
#pragma unroll
    for (int k = 0; k < P; ++k) {
        acc_csum[k] = acc_wd[k] = acc_wd2[k] = 0.f;
#pragma unroll
        for (int c = 0; c < 6; ++c) acc_f[k][c] = 0.f;
    }

    // keep depth - 1 chunks in flight; one commit group per chunk (empty
    // past the tile's last), so that chunk k is group k
#pragma unroll
    for (int j = 0; j < DEPTH - 1; ++j) {
        if (j < nchunks)
            stage_chunk<GC>(ring + j * NROW * GC, feats, e,
                            start + (long long)j * GC, tid);
        __pipeline_commit();
    }

    auto body = [&](int k) {
        // every thread is done with chunk k - 1, whose stage the next copy
        // refills and whose words the repack overwrites
        __syncthreads();
        const int kn = k + DEPTH - 1;
        if (kn < nchunks)
            stage_chunk<GC>(ring + (kn % DEPTH) * NROW * GC, feats, e,
                            start + (long long)kn * GC, tid);
        __pipeline_commit();
        __pipeline_wait_prior(DEPTH - 1);
        __syncthreads();

        const float* f = ring + (k % DEPTH) * NROW * GC;
        for (int j = tid; j < GC; j += THREADS) {
            const float op = f[R_OP * GC + j];
            if (ALPHA)
                s0[j] = vcr::Front{f[R_MX * GC + j], f[R_MY * GC + j],
                                   f[R_A * GC + j], f[R_B * GC + j]};
            s1[j] = vcr::Front2{ALPHA ? f[R_C * GC + j] : 0.f,
                                EXP_ALPHA ? vcr::dead_threshold(op) : 0.f,
                                op, f[R_DZ * GC + j]};
        }
        __syncthreads();

        // the running prefix (use_tri), else the lg of the last entry the
        // warp composited and its index (a dead pixel's lg is 0)
        float s[P];
        int j_last[P];
#pragma unroll
        for (int q = 0; q < P; ++q) s[q] = 0.f, j_last[q] = -1;
        for (int j = 0; j < GC; ++j) {
            const vcr::Front2 f1 = s1[j];
            float alpha[P];
            bool live[P];
            if (ALPHA) {
                const vcr::Front f0 = s0[j];
                const float dx = px - f0.mx;
                float power[P], alpha_raw[P];
                bool near[P];
                bool any_near = false;
#pragma unroll
                for (int q = 0; q < P; ++q) {
                    power[q] = vcr::pair_power(dx, py[q] - f0.my, f0.a, f0.b,
                                               f1.c);
                    // the linear alpha has no threshold: its test is exact
                    near[q] = EXP ? vcr::pair_near(power[q], f1.thr)
                                  : power[q] <= 0.f;
                    any_near |= near[q];
                }
                if (!any_near) continue;
                // both pixels' alphas without a branch between them
                bool any = false;
#pragma unroll
                for (int q = 0; q < P; ++q) {
                    alpha_raw[q] = EXP ? f1.op * expf(power[q])
                                       : f1.op * (1.0f + power[q] * 0.01f);
                    live[q] = near[q] && alpha_raw[q] >= vcr::ALPHA_EPS;
                    alpha[q] = fminf(alpha_raw[q], vcr::ALPHA_CAP);
                    any |= live[q];
                }
                if (!any) continue;
            } else {
#pragma unroll
                for (int q = 0; q < P; ++q) {
                    live[q] = true;
                    alpha[q] = f1.op * 0.001f;
                }
            }
            float nrm[3], racc[6];
            if (DEPTH_ON) {
#pragma unroll
                for (int c = 0; c < 3; ++c) nrm[c] = f[(R_N + c) * GC + j];
            }
            if (DACC) {
                racc[0] = f1.d;
#pragma unroll
                for (int c = 1; c < 6; ++c) racc[c] = f[(R_DZ + c) * GC + j];
            }
            // both pixels' live bodies without a branch between them, so
            // that their chains overlap: a dead pixel of a live step takes
            // alpha = 0, so lg = -0 and w = 0, which add nothing
#pragma unroll
            for (int q = 0; q < P; ++q) {
                alpha[q] = live[q] ? alpha[q] : 0.f;
                const float lg = EXP_ALPHA ? log1pf(-alpha[q]) : -alpha[q];
                if (TRI) {
                    s[q] += lg;
                } else {
                    s[q] = lg;
                    j_last[q] = j;
                }
                const float w = EXP_ALPHA ? alpha[q] * expf(s[q] - lg)
                                          : alpha[q] * (s[q] - lg + 1.0f);
                if (DACC) {
#pragma unroll
                    for (int c = 0; c < 6; ++c)
                        acc_f[q][c] = fmaf(w, racc[c], acc_f[q][c]);
                }
                float d = f1.d;
                if (DEPTH_ON) {
                    float denom = rx[q] * nrm[0] + ry[q] * nrm[1]
                                  + rz[q] * nrm[2];
                    // the probe's unsigned clamp, not clamped_denom's
                    if (fabsf(denom) < vcr::DENOM_EPS)
                        denom = vcr::DENOM_EPS;
                    d = __fdividef(d, denom);
                }
                const float wd = w * d;
                acc_wd[q] += wd;
                acc_wd2[q] = fmaf(wd, d, acc_wd2[q]);
            }
        }
        // channel 1 adds the chunk's last csum: the prefix, or the last
        // entry's own lg
#pragma unroll
        for (int q = 0; q < P; ++q)
            acc_csum[q] += (TRI || j_last[q] == GC - 1) ? s[q] : 0.f;
    };

    for (int k0 = 0; k0 < nchunks; k0 += UNROLL) {
#pragma unroll
        for (int i = 0; i < UNROLL; ++i)
            if (k0 + i < nchunks) body(k0 + i);
    }

#pragma unroll
    for (int q = 0; q < P; ++q) {
        const int pix = (ly0 + q * Map::LY) * SIDE + lx;
        float* o = out + ((size_t)t * NPIX + pix) * OUT_CH;
        o[0] = 0.f;
        o[1] = acc_csum[q];
        o[2] = acc_wd[q];
        o[3] = acc_wd2[q];
#pragma unroll
        for (int c = 0; c < 6; ++c) o[4 + c] = acc_f[q][c];
    }
}

template <bool DEPTH_ON, bool TRI, bool DACC, bool EXP, bool ALPHA,
          int DEPTH, int GC, int UNROLL>
cudaError_t launch(const float* feats, long long e, const int* starts,
                   const int* counts, int n_tiles, float* out,
                   cudaStream_t stream)
{
    auto kern = kernel_microprobe<DEPTH_ON, TRI, DACC, EXP, ALPHA, DEPTH, GC,
                                  UNROLL>;
    constexpr int bytes = shared_bytes<DEPTH, GC>();
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    kern<<<n_tiles, THREADS, bytes, stream>>>(feats, e, starts, counts, out);
    return cudaGetLastError();
}

}  // namespace

// The 14 variants of ops/microprobe.VARIANTS: use_depth, use_tri,
// use_dacc, use_exp, use_alpha, depth, Gc, unroll.
#define VCR_VARIANTS(X)                                                      \
    X(1, 1, 1, 1, 1, 2, 256, 1) /* full */                                   \
    X(0, 1, 1, 1, 1, 2, 256, 1) /* no_depth */                               \
    X(1, 0, 1, 1, 1, 2, 256, 1) /* no_tri */                                 \
    X(1, 1, 0, 1, 1, 2, 256, 1) /* no_dacc */                                \
    X(1, 1, 1, 0, 1, 2, 256, 1) /* no_exp */                                 \
    X(0, 0, 0, 0, 0, 2, 256, 1) /* dma_only */                               \
    X(1, 1, 1, 1, 1, 4, 256, 1) /* full_d4 */                                \
    X(1, 1, 1, 1, 1, 6, 256, 1) /* full_d6 */                                \
    X(1, 1, 1, 1, 1, 2, 512, 1) /* full_g512 */                              \
    X(1, 1, 1, 1, 1, 2, 128, 1) /* full_g128 */                              \
    X(1, 1, 1, 1, 1, 4, 512, 1) /* full_d4_g512 */                           \
    X(1, 1, 1, 1, 1, 2, 256, 3) /* full_u3 */                                \
    X(1, 1, 1, 1, 1, 2, 256, 6) /* full_u6 */                                \
    X(0, 0, 0, 0, 0, 2, 256, 6) /* dma_u6 */

// Plain C entry point, loaded with ctypes. Returns the cudaError_t of the
// launch (0 = cudaSuccess; cudaErrorInvalidValue for toggles that are not a
// variant's); the kernel runs on `stream` and is not awaited. The caller
// guarantees every start a multiple of 128, every count a multiple of Gc,
// every range inside the (24, e) matrix and e a multiple of 4.
extern "C" int vcr_kernel_microprobe(const float* feats, long long e,
                                     const int* starts, const int* counts,
                                     int n_tiles, int use_depth, int use_tri,
                                     int use_dacc, int use_exp, int use_alpha,
                                     int depth, int gc, int unroll,
                                     float* out, void* stream)
{
    if (n_tiles <= 0) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
#define VCR_CASE(DP, TR, DA, EX, AL, D, GCV, U)                              \
    if (use_depth == DP && use_tri == TR && use_dacc == DA                   \
        && use_exp == EX && use_alpha == AL && depth == D && gc == GCV       \
        && unroll == U)                                                      \
        return (int)launch<DP != 0, TR != 0, DA != 0, EX != 0, AL != 0, D,  \
                           GCV, U>(feats, e, starts, counts, n_tiles, out,  \
                                   s);
    VCR_VARIANTS(VCR_CASE)
#undef VCR_CASE
    return (int)cudaErrorInvalidValue;
}
