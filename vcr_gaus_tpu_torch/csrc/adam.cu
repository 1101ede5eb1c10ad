// The Gaussians' masked Adam step and densification statistics for NVIDIA
// Hopper (sm_90a), in one launch.
//
// Replaces no TPU kernel. On the TPU, XLA fuses the JAX package's
// per-leaf update (vcr_gaus_tpu/models/gaussians.py: mask_grads,
// adam_step, add_densification_stats) by itself; the port ran it as some
// 120 eager PyTorch kernels a step, each streaming a full (C, w)
// temporary. Here `vcr_adam_stats` (models/gaussians.py
// `adam_and_stats`; plain versions `mask_grads`, `adam_step`,
// `add_densification_stats`) walks every slot of every leaf once:
//
//   a table of up to 7 leaves (xyz, f_dc, f_rest, log_scale, quat,
//     logit_opacity, obj_dc; a leaf of width 0 is left out), each a flat
//     float array of n elements and `width` floats a slot, with its
//     parameters, gradient and moments in and new parameters and moments
//     out, and its learning rate -> for each element, with a = active[slot]:
//       g  = g * a
//       mu = B1 mu + (1 - B1) g
//       nu = B2 nu + ((1 - B2) g) g
//       p  = p - (lr (mu / bc1)) / (sqrt(nu / bc2) + EPS)
//   and, over the C slots, with vis = visibility & active and the (C, 2)
//     |d mean2d| gradient (row stride ldg) scaled by the ndc scale:
//       grad_accum += vis ? |g2d| : 0, denom += vis,
//       max_radii2d = vis ? max(max_radii2d, radii) : max_radii2d.
//
// The update is out of place: the inputs are left as they were, as the
// plain chain leaves them. The arithmetic is the plain chain's on the
// card, operation for operation in float32: every Python constant arrives
// as PyTorch rounds a Python float against a float32 tensor (the double
// cast to float), `t / s` for a Python float s is PyTorch's `t * (1 / s)`
// with the reciprocal taken in float on the host (the launch receives it),
// and the library is built with --fmad=false, so nothing is fused; the
// outputs equal the plain chain's bit for bit. The norm of a row of two
// is PyTorch's CUDA reduction of a last dim of 2: each square rounded,
// then their sum.
//
// What bounds it on the card: the bytes. Each element reads p, g, mu, nu
// and writes p, mu, nu (28 B); the statistics read the (C, 2) gradient,
// radii, visibility, active and the three statistics and write three (38 B
// a slot). The arithmetic (about 15 operations an element, a square root
// and a division among them) is far below the card's rate. So a block of
// 256 threads takes 1,024 consecutive elements of one leaf, 4 a thread
// with 16-byte loads and stores where the leaf's seven arrays are 16-byte
// aligned, and reads the active byte of each element's slot (element /
// width); a block of the statistics takes 256 slots. Every block lies in
// one leaf, so the table lookup is uniform across the block.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEAVES = 7;
constexpr int BLOCK = 256;
constexpr int PER_THREAD = 4;
constexpr int TILE = BLOCK * PER_THREAD;      // elements a leaf block takes

struct Leaf {
    const float* p;
    const float* g;
    const float* mu;
    const float* nu;
    float* p_out;
    float* mu_out;
    float* nu_out;
    unsigned n;             // elements
    unsigned width;         // floats a slot
    float lr;
    int vec;                // the seven arrays are 16-byte aligned
    int first_block;        // the leaf's first block in the grid
};

struct Table {
    Leaf leaf[MAX_LEAVES];
    int n_leaves;
    int stats_block;        // the statistics' first block
    float b1, c1, b2, c2, inv_bc1, inv_bc2, eps;
    const bool* active;
    int slots;
    const float* g2d;
    int ldg;
    float sx, sy;
    const int* radii;
    const bool* visibility;
    const float* grad_accum;
    const float* denom;
    const float* max_radii;
    float* grad_accum_out;
    float* denom_out;
    float* max_radii_out;
};

__device__ __forceinline__ void update(const Table& t, float lr, float a,
                                       float p, float g, float m, float v,
                                       float& p_out, float& m_out,
                                       float& v_out)
{
    const float gm = g * a;
    const float mu = t.b1 * m + t.c1 * gm;
    const float nu = t.b2 * v + (t.c2 * gm) * gm;
    const float den = sqrtf(nu * t.inv_bc2) + t.eps;
    p_out = p - (lr * (mu * t.inv_bc1)) / den;
    m_out = mu;
    v_out = nu;
}

// torch.maximum on the card: a NaN on either side wins, else fmaxf
__device__ __forceinline__ float maximum(float a, float b)
{
    return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ void stats(const Table& t, int i)
{
    const float gx = t.g2d[(size_t)i * t.ldg] * t.sx;
    const float gy = t.g2d[(size_t)i * t.ldg + 1] * t.sy;
    const float gnorm = sqrtf(gx * gx + gy * gy);
    const bool vis = t.visibility[i] && t.active[i];
    t.grad_accum_out[i] = t.grad_accum[i] + (vis ? gnorm : 0.0f);
    t.denom_out[i] = t.denom[i] + (vis ? 1.0f : 0.0f);
    const float mr = t.max_radii[i];
    t.max_radii_out[i] = vis ? maximum(mr, (float)t.radii[i]) : mr;
}

__global__ void __launch_bounds__(BLOCK)
adam_stats_kernel(const __grid_constant__ Table t)
{
    const int block = blockIdx.x;
    if (block >= t.stats_block) {
        const int i = (block - t.stats_block) * BLOCK + threadIdx.x;
        if (i < t.slots) stats(t, i);
        return;
    }
    int s = 0;
#pragma unroll
    for (int k = 1; k < MAX_LEAVES; ++k)
        if (k < t.n_leaves && block >= t.leaf[k].first_block) s = k;
    const Leaf& L = t.leaf[s];
    const unsigned e0 = (unsigned)(block - L.first_block) * TILE
                        + threadIdx.x * PER_THREAD;
    if (e0 >= L.n) return;
    const unsigned todo = min(L.n - e0, (unsigned)PER_THREAD);

    // the active flag of each element's slot
    float a[PER_THREAD];
    unsigned slot = e0 / L.width, r = e0 - slot * L.width;
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
        a[k] = (k < todo && t.active[slot]) ? 1.0f : 0.0f;
        if (++r == L.width) { r = 0; ++slot; }
    }

    if (L.vec && todo == PER_THREAD) {
        const float4 p = __ldcs(reinterpret_cast<const float4*>(L.p + e0));
        const float4 g = __ldcs(reinterpret_cast<const float4*>(L.g + e0));
        const float4 m = __ldcs(reinterpret_cast<const float4*>(L.mu + e0));
        const float4 v = __ldcs(reinterpret_cast<const float4*>(L.nu + e0));
        float4 po, mo, vo;
        update(t, L.lr, a[0], p.x, g.x, m.x, v.x, po.x, mo.x, vo.x);
        update(t, L.lr, a[1], p.y, g.y, m.y, v.y, po.y, mo.y, vo.y);
        update(t, L.lr, a[2], p.z, g.z, m.z, v.z, po.z, mo.z, vo.z);
        update(t, L.lr, a[3], p.w, g.w, m.w, v.w, po.w, mo.w, vo.w);
        __stcs(reinterpret_cast<float4*>(L.p_out + e0), po);
        __stcs(reinterpret_cast<float4*>(L.mu_out + e0), mo);
        __stcs(reinterpret_cast<float4*>(L.nu_out + e0), vo);
        return;
    }
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
        if (k >= todo) break;
        const unsigned e = e0 + k;
        update(t, L.lr, a[k], L.p[e], L.g[e], L.mu[e], L.nu[e], L.p_out[e],
               L.mu_out[e], L.nu_out[e]);
    }
}

}  // namespace

// ptrs: n_leaves rows of 7 device pointers (p, g, mu, nu, p_out, mu_out,
// nu_out); counts, widths, lrs: each leaf's element count (below 2^31),
// floats a slot and learning rate. Returns a cudaError_t.
extern "C" int vcr_adam_stats(
    const long long* ptrs, const long long* counts, const int* widths,
    const float* lrs, int n_leaves, float b1, float c1, float b2, float c2,
    float inv_bc1, float inv_bc2, float eps, const bool* active, int slots,
    const float* g2d, int ldg, float sx, float sy, const int* radii,
    const bool* visibility, const float* grad_accum, const float* denom,
    const float* max_radii, float* grad_accum_out, float* denom_out,
    float* max_radii_out, void* stream)
{
    if (n_leaves < 0 || n_leaves > MAX_LEAVES || slots < 0 || ldg < 2)
        return (int)cudaErrorInvalidValue;
    Table t = {};
    long long blocks = 0;
    for (int s = 0; s < n_leaves; ++s) {
        const long long* q = ptrs + 7 * s;
        if (widths[s] < 1 || counts[s] < 0 || counts[s] > 0x7fffffffLL
            || counts[s] != (long long)widths[s] * slots)
            return (int)cudaErrorInvalidValue;
        Leaf& L = t.leaf[s];
        L.p = (const float*)q[0];
        L.g = (const float*)q[1];
        L.mu = (const float*)q[2];
        L.nu = (const float*)q[3];
        L.p_out = (float*)q[4];
        L.mu_out = (float*)q[5];
        L.nu_out = (float*)q[6];
        L.n = (unsigned)counts[s];
        L.width = (unsigned)widths[s];
        L.lr = lrs[s];
        L.vec = ((q[0] | q[1] | q[2] | q[3] | q[4] | q[5] | q[6]) & 15) == 0;
        L.first_block = (int)blocks;
        blocks += (counts[s] + TILE - 1) / TILE;
    }
    t.n_leaves = n_leaves;
    t.stats_block = (int)blocks;
    blocks += (slots + BLOCK - 1) / BLOCK;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (blocks == 0) return 0;
    t.b1 = b1;
    t.c1 = c1;
    t.b2 = b2;
    t.c2 = c2;
    t.inv_bc1 = inv_bc1;
    t.inv_bc2 = inv_bc2;
    t.eps = eps;
    t.active = active;
    t.slots = slots;
    t.g2d = g2d;
    t.ldg = ldg;
    t.sx = sx;
    t.sy = sy;
    t.radii = radii;
    t.visibility = visibility;
    t.grad_accum = grad_accum;
    t.denom = denom;
    t.max_radii = max_radii;
    t.grad_accum_out = grad_accum_out;
    t.denom_out = denom_out;
    t.max_radii_out = max_radii_out;
    adam_stats_kernel<<<(unsigned)blocks, BLOCK, 0, (cudaStream_t)stream>>>(t);
    return (int)cudaGetLastError();
}
