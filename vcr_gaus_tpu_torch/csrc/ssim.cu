// The SSIM loss and its gradient for NVIDIA Hopper (sm_90a): one forward
// and one backward kernel.
//
// Replaces no TPU kernel. It replaces the JAX package's banded-matrix
// SSIM (vcr_gaus_tpu/train/losses.py `ssim`), which blurs with two float32
// matrix products against dense (H, H) and (W, W) banded matrices of the
// 11-tap window, a layout for the TPU's matrix unit that XLA runs as
// GEMMs. On the card those ran as cuBLAS float32 GEMMs, about 258 GFLOP a
// 1600x1200 step with their backward, with some 60 eager elementwise
// launches around them. Here (train/losses.py `ssim`; its plain version
// `ssim_torch`, the banded products, runs on CPU tensors alone):
//
//   vcr_ssim_fwd: img1, img2 (C, H, W) float32 -> the mean SSIM over the
//     C H W pixels (each block's partial sum, then one fixed-order pass in
//     double: no float atomics, so the value repeats bit for bit), and,
//     for the backward, three per-pixel maps of the SSIM's derivatives in
//     the blurred quantities mu1 = blur(x), E11 = blur(x^2), E12 = blur(xy):
//       dm   = dS/dmu1, with the -mu1^2 of sigma1^2 and the -mu1 mu2 of
//              sigma12 folded in: 2 mu2 (A2 - A1) / D + 2 mu1 S (1/B2 - 1/B1)
//       ds1  = dS/dE11 = dS/dsigma1^2 = -S / B2
//       ds12 = dS/dE12 = dS/dsigma12  = 2 A1 / D
//     where A1 = 2 mu1 mu2 + C1, A2 = 2 sigma12 + C2, B1 = mu1^2 + mu2^2 +
//     C1, B2 = sigma1^2 + sigma2^2 + C2, D = B1 B2, S = A1 A2 / D;
//   vcr_ssim_bwd: dL/dimg1 = (g / N) (blur(dm) + 2 img1 blur(ds1) +
//     img2 blur(ds12)), N = C H W, g the upstream gradient read on the
//     card. The window is symmetric and zero-padded (the band matrices are
//     symmetric), so the blur is its own adjoint. img2 (the ground truth)
//     gets no gradient.
//
// The blur is the plain version's: the 11 float32 taps (the wrapper passes
// the band matrices' window), zero outside the image, the vertical pass
// first, then the horizontal one (By^T x Bx). All arithmetic is float32,
// no TF32 or half: sigma^2 = E[x^2] - mu^2 is a cancellation. Each tap is
// one fused multiply-add (explicit fmaf; the library is built with
// --fmad=false).
//
// What bounds it on the card: the bytes. The SSIM and its gradient need
// 20 B a pixel: the forward reads the two images (8 B), the backward reads
// them again and writes the gradient (12 B); 115 MB at 3 x 1600 x 1200,
// 0.034 ms at 3.35 TB/s. The arithmetic is about 300 operations a pixel
// (1.7 GFLOP at that size, 0.026 ms at the float32 peak). So every
// intermediate stays on chip: a block of 256 threads takes one channel's
// 32 x 32 output tile, stages the inputs over the tile and its 5-pixel
// halo in shared memory (the halo's re-reads, 1.72x the tile, mostly hit
// L2, since neighbouring tiles run together), runs the vertical pass into
// shared memory and the horizontal pass into registers. Each thread takes
// runs of 4 outputs along a pass and slides the 11 taps over 14 staged
// values, so a pixel costs about 27 shared-memory reads, not 84. A design
// choice the bound does not count: the three maps the backward needs go
// through device memory (12 B written, 12 B read back: 44 B a pixel in
// all). Recomputing the forward's five blurs in the backward instead
// would save those 24 B, at the cost of a 10-pixel halo and twice the
// arithmetic.
// Without a gradient (the evaluation's SSIM) the maps are not written.

#include <cuda_runtime.h>

namespace {

constexpr int RADIUS = 5;
constexpr int TAPS = 2 * RADIUS + 1;
constexpr int TILE = 32;                    // a block's output tile side
constexpr int STAGED = TILE + 2 * RADIUS;   // 42: the tile and its halo
constexpr int RUN = 4;                      // outputs a thread takes a pass
constexpr int WINDOW = RUN + TAPS - 1;      // 14 staged values a run reads
constexpr int VSTRIDE = STAGED + 1;         // 43: an odd row stride, so the
                                            // horizontal pass (a row a lane)
                                            // reads 32 banks
constexpr int THREADS = TILE * TILE / RUN;  // 256
constexpr int MEAN_THREADS = 1024;
// the plain version's constants, as PyTorch rounds a Python float against
// a float32 tensor
constexpr float C1 = (float)(0.01 * 0.01);
constexpr float C2 = (float)(0.03 * 0.03);

struct Taps {
    float w[TAPS];
};

// The quantities a vertical pass blurs, from the NIN staged inputs of a
// pixel: the forward's x, y, x^2, y^2, xy (the products rounded to float
// as the plain version's img1 * img1), the backward's three maps.
struct Forward {
    static constexpr int NIN = 2, NQ = 5;
    __device__ static void get(const float (&in)[NIN], float (&q)[NQ])
    {
        q[0] = in[0];
        q[1] = in[1];
        q[2] = in[0] * in[0];
        q[3] = in[1] * in[1];
        q[4] = in[0] * in[1];
    }
};

struct Backward {
    static constexpr int NIN = 3, NQ = 3;
    __device__ static void get(const float (&in)[NIN], float (&q)[NQ])
    {
        q[0] = in[0];
        q[1] = in[1];
        q[2] = in[2];
    }
};

// Stage NIN planes over the block's tile and halo into
// staged[NIN][STAGED][STAGED], zero outside the image.
template <int NIN>
__device__ void stage(const float* const (&src)[NIN], float* staged,
                      int x0, int y0, int h, int w)
{
    for (int i = threadIdx.x; i < STAGED * STAGED; i += THREADS) {
        const int gy = y0 - RADIUS + i / STAGED;
        const int gx = x0 - RADIUS + i % STAGED;
        const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
        const size_t o = (size_t)gy * w + gx;
#pragma unroll
        for (int p = 0; p < NIN; ++p)
            staged[p * STAGED * STAGED + i] = in ? src[p][o] : 0.0f;
    }
}

// Blur Q's quantities over the tile: the vertical pass over the staged
// columns into vert[NQ][TILE][VSTRIDE], then the horizontal pass of the
// calling thread's run (row threadIdx.x % TILE, columns c0 .. c0 + RUN - 1,
// c0 = threadIdx.x / TILE * RUN) into out[NQ][RUN].
template <class Q>
__device__ void blur_tile(const float* staged, float* vert, const Taps& t,
                          float (&out)[Q::NQ][RUN])
{
    for (int item = threadIdx.x; item < STAGED * (TILE / RUN);
         item += THREADS) {
        const int col = item % STAGED, r0 = item / STAGED * RUN;
        float acc[Q::NQ][RUN];
#pragma unroll
        for (int q = 0; q < Q::NQ; ++q)
#pragma unroll
            for (int j = 0; j < RUN; ++j)
                acc[q][j] = 0.0f;
#pragma unroll
        for (int k = 0; k < WINDOW; ++k) {
            float in[Q::NIN], v[Q::NQ];
#pragma unroll
            for (int p = 0; p < Q::NIN; ++p)
                in[p] = staged[(p * STAGED + r0 + k) * STAGED + col];
            Q::get(in, v);
#pragma unroll
            for (int j = 0; j < RUN; ++j) {
                const int tap = k - j;
                if (tap >= 0 && tap < TAPS) {
#pragma unroll
                    for (int q = 0; q < Q::NQ; ++q)
                        acc[q][j] = fmaf(t.w[tap], v[q], acc[q][j]);
                }
            }
        }
#pragma unroll
        for (int q = 0; q < Q::NQ; ++q)
#pragma unroll
            for (int j = 0; j < RUN; ++j)
                vert[(q * TILE + r0 + j) * VSTRIDE + col] = acc[q][j];
    }
    __syncthreads();
    const int row = threadIdx.x % TILE, c0 = threadIdx.x / TILE * RUN;
#pragma unroll
    for (int q = 0; q < Q::NQ; ++q)
#pragma unroll
        for (int j = 0; j < RUN; ++j)
            out[q][j] = 0.0f;
#pragma unroll
    for (int k = 0; k < WINDOW; ++k) {
#pragma unroll
        for (int q = 0; q < Q::NQ; ++q) {
            const float v = vert[(q * TILE + row) * VSTRIDE + c0 + k];
#pragma unroll
            for (int j = 0; j < RUN; ++j) {
                const int tap = k - j;
                if (tap >= 0 && tap < TAPS)
                    out[q][j] = fmaf(t.w[tap], v, out[q][j]);
            }
        }
    }
}

// Store a run of RUN values of one row at pixel offset o, of which the
// first n lie in the image: one 16-byte store where the row's width is a
// multiple of 4 (the run is then whole and aligned), else one a pixel.
__device__ __forceinline__ void store_run(float* dst, size_t o,
                                          const float (&v)[RUN], int n,
                                          bool vec)
{
    if (vec) {
        *reinterpret_cast<float4*>(dst + o) =
            make_float4(v[0], v[1], v[2], v[3]);
        return;
    }
#pragma unroll
    for (int j = 0; j < RUN; ++j)
        if (j < n)
            dst[o + j] = v[j];
}

__global__ void __launch_bounds__(THREADS)
ssim_fwd_kernel(const float* __restrict__ img1,
                const float* __restrict__ img2, int h, int w, Taps t,
                float* __restrict__ partial, float* __restrict__ dm,
                float* __restrict__ ds1, float* __restrict__ ds12)
{
    __shared__ float staged[Forward::NIN * STAGED * STAGED];
    __shared__ float vert[Forward::NQ * TILE * VSTRIDE];
    __shared__ float warp_sum[THREADS / 32];
    const int x0 = blockIdx.x * TILE, y0 = blockIdx.y * TILE;
    const size_t plane = (size_t)blockIdx.z * h * w;
    const float* const src[2] = {img1 + plane, img2 + plane};
    stage<2>(src, staged, x0, y0, h, w);
    __syncthreads();
    float b[Forward::NQ][RUN];
    blur_tile<Forward>(staged, vert, t, b);

    const int gy = y0 + threadIdx.x % TILE;
    const int gx = x0 + threadIdx.x / TILE * RUN;
    const int n = gy < h ? min(RUN, w - gx) : 0;
    float sum = 0.0f, o_dm[RUN], o_ds1[RUN], o_ds12[RUN];
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
        const float mu1 = b[0][j], mu2 = b[1][j];
        const float mu1_sq = mu1 * mu1, mu2_sq = mu2 * mu2;
        const float mu1_mu2 = mu1 * mu2;
        const float sigma1_sq = b[2][j] - mu1_sq;
        const float sigma2_sq = b[3][j] - mu2_sq;
        const float sigma12 = b[4][j] - mu1_mu2;
        const float a1 = 2.0f * mu1_mu2 + C1, a2 = 2.0f * sigma12 + C2;
        const float b1 = mu1_sq + mu2_sq + C1;
        const float b2 = sigma1_sq + sigma2_sq + C2;
        const float d = b1 * b2;
        const float s = (a1 * a2) / d;
        if (j < n)
            sum += s;
        o_ds12[j] = 2.0f * a1 / d;
        o_ds1[j] = -s / b2;
        o_dm[j] = 2.0f * mu2 * (a2 - a1) / d
                  + 2.0f * mu1 * s * (1.0f / b2 - 1.0f / b1);
    }
    if (dm != nullptr && n > 0) {
        const size_t o = plane + (size_t)gy * w + gx;
        const bool vec = (w % RUN) == 0;
        store_run(dm, o, o_dm, n, vec);
        store_run(ds1, o, o_ds1, n, vec);
        store_run(ds12, o, o_ds12, n, vec);
    }
    // the block's partial sum in a fixed order: lanes, then warps
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_down_sync(0xffffffffu, sum, off);
    if (threadIdx.x % 32 == 0)
        warp_sum[threadIdx.x / 32] = sum;
    __syncthreads();
    if (threadIdx.x == 0) {
        float total = 0.0f;
#pragma unroll
        for (int k = 0; k < THREADS / 32; ++k)
            total += warp_sum[k];
        partial[((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x
                + blockIdx.x] = total;
    }
}

// The mean from the blocks' partial sums: one block, each thread's share
// in index order, then a fixed tree, in double.
__global__ void __launch_bounds__(MEAN_THREADS)
ssim_mean_kernel(const float* __restrict__ partial, int n, double count,
                 float* __restrict__ value)
{
    __shared__ double acc[MEAN_THREADS];
    double s = 0.0;
    for (int i = threadIdx.x; i < n; i += MEAN_THREADS)
        s += partial[i];
    acc[threadIdx.x] = s;
    __syncthreads();
    for (int half = MEAN_THREADS / 2; half > 0; half >>= 1) {
        if (threadIdx.x < half)
            acc[threadIdx.x] += acc[threadIdx.x + half];
        __syncthreads();
    }
    if (threadIdx.x == 0)
        *value = (float)(acc[0] / count);
}

__global__ void __launch_bounds__(THREADS)
ssim_bwd_kernel(const float* __restrict__ g, const float* __restrict__ dm,
                const float* __restrict__ ds1,
                const float* __restrict__ ds12,
                const float* __restrict__ img1,
                const float* __restrict__ img2, int h, int w, float count,
                Taps t, float* __restrict__ grad)
{
    __shared__ float staged[Backward::NIN * STAGED * STAGED];
    __shared__ float vert[Backward::NQ * TILE * VSTRIDE];
    const int x0 = blockIdx.x * TILE, y0 = blockIdx.y * TILE;
    const size_t plane = (size_t)blockIdx.z * h * w;
    const float* const src[3] = {dm + plane, ds1 + plane, ds12 + plane};
    stage<3>(src, staged, x0, y0, h, w);
    __syncthreads();
    float b[Backward::NQ][RUN];
    blur_tile<Backward>(staged, vert, t, b);

    const int gy = y0 + threadIdx.x % TILE;
    const int gx = x0 + threadIdx.x / TILE * RUN;
    const int n = gy < h ? min(RUN, w - gx) : 0;
    if (n <= 0)
        return;
    const float scale = *g / count;
    const size_t o = plane + (size_t)gy * w + gx;
    float out[RUN];
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
        const float x = j < n ? img1[o + j] : 0.0f;
        const float y = j < n ? img2[o + j] : 0.0f;
        out[j] = scale * (b[0][j] + 2.0f * x * b[1][j] + y * b[2][j]);
    }
    store_run(grad, o, out, n, (w % RUN) == 0);
}

dim3 grid_of(int c, int h, int w)
{
    return dim3((unsigned)((w + TILE - 1) / TILE),
                (unsigned)((h + TILE - 1) / TILE), (unsigned)c);
}

void load_taps(const float* taps, Taps& t)
{
    for (int k = 0; k < TAPS; ++k)
        t.w[k] = taps[k];
}

}  // namespace

// The number of partial sums vcr_ssim_fwd writes for a (c, h, w) image:
// one a block.
extern "C" long long vcr_ssim_blocks(int c, int h, int w)
{
    const dim3 g = grid_of(c, h, w);
    return (long long)g.x * g.y * g.z;
}

// The forward: `value` (one float) <- the mean SSIM of img1 and img2 (c, h,
// w, contiguous float32); `partial` holds vcr_ssim_blocks floats of
// scratch. dm, ds1, ds12 ((c, h, w) each, 16-byte aligned) receive the
// backward's maps, or are all null where no gradient is wanted. `taps`
// is a host array of the 11 window weights. Returns the launches' error
// (0 = cudaSuccess); the kernels run on `stream` and are not awaited.
extern "C" int vcr_ssim_fwd(const float* img1, const float* img2, int c,
                            int h, int w, const float* taps, float* partial,
                            float* value, float* dm, float* ds1, float* ds12,
                            void* stream)
{
    Taps t;
    load_taps(taps, t);
    const cudaStream_t s = (cudaStream_t)stream;
    ssim_fwd_kernel<<<grid_of(c, h, w), THREADS, 0, s>>>(
        img1, img2, h, w, t, partial, dm, ds1, ds12);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess)
        return (int)err;
    ssim_mean_kernel<<<1, MEAN_THREADS, 0, s>>>(
        partial, (int)vcr_ssim_blocks(c, h, w), (double)c * h * w, value);
    return (int)cudaGetLastError();
}

// The backward: grad (c, h, w, 16-byte aligned) <- dL/dimg1 from the
// upstream gradient `g` (one float on the card), the forward's maps and
// the two images. Returns the launch's error; not awaited.
extern "C" int vcr_ssim_bwd(const float* g, const float* dm, const float* ds1,
                            const float* ds12, const float* img1,
                            const float* img2, int c, int h, int w,
                            const float* taps, float* grad, void* stream)
{
    Taps t;
    load_taps(taps, t);
    ssim_bwd_kernel<<<grid_of(c, h, w), THREADS, 0, (cudaStream_t)stream>>>(
        g, dm, ds1, ds12, img1, img2, h, w, (float)c * h * w, t, grad);
    return (int)cudaGetLastError();
}
