// The forward-loop microprobe (K4) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel `kernel` built by `build` in main() of
// scripts/kernel_microprobe.py (body :60-186, pallas_call :205). It
// computes each variant's function as vcr_gaus_tpu_torch/ops/microprobe.py
// defines it, not a copy of the TPU blocks: the triangular matmuls of the
// transmittance prefix become a running sum per pixel, the DMA double buffer
// a ring of cp.async stages. Its purpose is to attribute the cost of a
// K1-shaped CUDA loop (csrc/rasterize_fwd.cu: a block per tile, a thread per
// pixel, entries staged in shared memory, dead pairs skipped) on the card,
// component by component: the transcendentals, the running prefix, the
// channel accumulation, the depth block, staging depth, chunk size, unroll.
//
// Design:
//   * one block per 32x32 tile, 1024 threads, one per pixel. A thread per
//     pixel is K1's shape: every pair costs a thread one broadcast
//     shared-memory read per feature row it uses, as in K1. Four pixels per
//     thread would share those reads and probe a loop K1 does not run;
//   * each thread keeps the chunk's running log-prefix and the 9 non-zero
//     channels in registers; the prefix restarts at every chunk, as the
//     probe's transmittance does;
//   * rows 0..11 of each chunk (the only rows the body reads) are staged in
//     shared memory, 12 x Gc floats a stage, in a ring of `depth` stages
//     filled by 16-byte cp.async copies with depth - 1 chunks in flight:
//     the counterpart of the TPU's DMA ring. A stage is 6-24 KB, and the
//     ring (up to 96 KB for depth 4 at Gc 512) is dynamic shared memory;
//   * the switches, Gc, depth and unroll are template parameters; unroll
//     steps `unroll` guarded chunk bodies per loop iteration, as the script
//     does. The 14 variants of ops/microprobe.VARIANTS are instantiated;
//   * a pair that fails a live test is skipped (`continue`), as in K1. The
//     TPU loop is branchless, so the card's ablation deltas have to be read
//     with each variant's live share: on the probe's inputs 2.3% of the
//     pairs are live with the exponential alpha and 29.9% with the linear
//     one (no_exp);
//   * built with --fmad=false, so the liveness tests round as in the plain
//     version.
//
// What bounds it: operations, not bytes. At the protocol shape (1900 tiles
// x 1536 entries x 1024 pixels = 2.99G pairs) it reads 12 rows x 4 B x
// 2.92M entries = 140 MB and writes 78 MB, 0.07 ms of HBM at 3.35 TB/s,
// against about 0.7 ms of FP32 at 67 TFLOP/s for the ~16 operations per
// pair of `full` (12 for every pair, 3 more past the power test, 31 more
// for a live one; tools/kernel_microprobe.py counts them per variant).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int P = TILE * TILE;       // one thread per pixel
constexpr int NROW = 12;             // feature rows the body reads
constexpr int OUT_CH = 10;
constexpr float ALPHA_EPS = 1.0f / 255.0f;
constexpr float ALPHA_CAP = 0.99f;
constexpr float DENOM_EPS = 1e-2f;

// feature rows: mean x, y, conic a, b, c, opacity, then depth (also the
// first accumulated row) and the normal
constexpr int R_MX = 0, R_MY = 1, R_A = 2, R_B = 3, R_C = 4, R_OP = 5,
              R_DZ = 6, R_N = 7;

// Start the copies of rows 0..11 of columns [col0, col0 + GC) into one
// stage; each thread issues its share of the 16-byte pieces.
template <int GC>
__device__ __forceinline__ void stage_chunk(float* dst,
                                            const float* __restrict__ feats,
                                            long long e, long long col0,
                                            int tid)
{
    constexpr int PER_ROW = GC / 4;
    for (int i = tid; i < NROW * PER_ROW; i += P) {
        const int r = i / PER_ROW;
        const int q = i - r * PER_ROW;
        __pipeline_memcpy_async(dst + r * GC + 4 * q,
                                feats + r * e + col0 + 4 * q, 16);
    }
}

template <bool DEPTH_ON, bool TRI, bool DACC, bool EXP, bool ALPHA,
          int DEPTH, int GC, int UNROLL>
__global__ void __launch_bounds__(P)
kernel_microprobe(const float* __restrict__ feats,  // (24, e)
                  long long e,
                  const int* __restrict__ starts,
                  const int* __restrict__ counts,
                  float* __restrict__ out)          // (tiles, 1024, 10)
{
    extern __shared__ __align__(16) float ring[];   // DEPTH x NROW x GC

    const int t = blockIdx.x;
    const int tid = threadIdx.x;
    const float px = (float)(tid % TILE);
    const float py = (float)(tid / TILE);
    const long long start = starts[t];
    const int nchunks = counts[t] / GC;

    // the unit ray through the pixel's centre, scaled as the probe does
    float rx = 0.f, ry = 0.f, rz = 0.f;
    if (DEPTH_ON) {
        const float dirx = (px + 0.5f - 16.0f) / 30.0f;
        const float diry = (py + 0.5f - 16.0f) / 30.0f;
        const float inv_n = rsqrtf(dirx * dirx + diry * diry + 1.0f);
        rx = dirx * inv_n;
        ry = diry * inv_n;
        rz = inv_n;
    }

    float acc_csum = 0.f, acc_wd = 0.f, acc_wd2 = 0.f;
    float acc_f[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

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
        // refills
        __syncthreads();
        const int kn = k + DEPTH - 1;
        if (kn < nchunks)
            stage_chunk<GC>(ring + (kn % DEPTH) * NROW * GC, feats, e,
                            start + (long long)kn * GC, tid);
        __pipeline_commit();
        __pipeline_wait_prior(DEPTH - 1);
        __syncthreads();

        const float* f = ring + (k % DEPTH) * NROW * GC;
        // the running prefix (use_tri), else the last live entry's lg and
        // its index: a dead pair has lg = 0 and adds nothing to either
        float s = 0.f;
        int j_last = -1;
        for (int j = 0; j < GC; ++j) {
            float alpha;
            if (ALPHA) {
                const float dx = px - f[R_MX * GC + j];
                const float dy = py - f[R_MY * GC + j];
                const float power = -0.5f * (f[R_A * GC + j] * dx * dx
                                             + f[R_C * GC + j] * dy * dy)
                                    - f[R_B * GC + j] * dx * dy;
                if (!(power <= 0.f)) continue;
                const float alpha_raw =
                    EXP ? f[R_OP * GC + j] * expf(power)
                        : f[R_OP * GC + j] * (1.0f + power * 0.01f);
                if (!(alpha_raw >= ALPHA_EPS)) continue;
                alpha = fminf(alpha_raw, ALPHA_CAP);
            } else {
                alpha = f[R_OP * GC + j] * 0.001f;
            }
            const float lg = (EXP && ALPHA) ? log1pf(-alpha) : -alpha;
            if (TRI) {
                s += lg;
            } else {
                s = lg;
                j_last = j;
            }
            const float w = (EXP && ALPHA) ? alpha * expf(s - lg)
                                           : alpha * (s - lg + 1.0f);
            if (DACC) {
#pragma unroll
                for (int c = 0; c < 6; ++c)
                    acc_f[c] += w * f[(R_DZ + c) * GC + j];
            }
            float d = f[R_DZ * GC + j];
            if (DEPTH_ON) {
                float denom = rx * f[R_N * GC + j] + ry * f[(R_N + 1) * GC + j]
                              + rz * f[(R_N + 2) * GC + j];
                if (fabsf(denom) < DENOM_EPS) denom = DENOM_EPS;
                d = d / denom;
            }
            const float wd = w * d;
            acc_wd += wd;
            acc_wd2 += wd * d;
        }
        // channel 1 adds the chunk's last csum: the prefix, or the last
        // entry's own lg
        acc_csum += (TRI || j_last == GC - 1) ? s : 0.f;
    };

    for (int k0 = 0; k0 < nchunks; k0 += UNROLL) {
#pragma unroll
        for (int i = 0; i < UNROLL; ++i)
            if (k0 + i < nchunks) body(k0 + i);
    }

    float* o = out + ((size_t)t * P + tid) * OUT_CH;
    o[0] = 0.f;
    o[1] = acc_csum;
    o[2] = acc_wd;
    o[3] = acc_wd2;
#pragma unroll
    for (int c = 0; c < 6; ++c) o[4 + c] = acc_f[c];
}

template <bool DEPTH_ON, bool TRI, bool DACC, bool EXP, bool ALPHA,
          int DEPTH, int GC, int UNROLL>
cudaError_t launch(const float* feats, long long e, const int* starts,
                   const int* counts, int n_tiles, float* out,
                   cudaStream_t stream)
{
    auto kern = kernel_microprobe<DEPTH_ON, TRI, DACC, EXP, ALPHA, DEPTH, GC,
                                  UNROLL>;
    const int bytes = DEPTH * NROW * GC * (int)sizeof(float);
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    kern<<<n_tiles, P, bytes, stream>>>(feats, e, starts, counts, out);
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
