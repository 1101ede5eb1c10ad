// The renderer's per-slot preprocess for NVIDIA Hopper (sm_90a): forward
// and backward, one Gaussian a thread.
//
// Replaces no TPU kernel. On the TPU, XLA fuses the renderer's per-slot
// chain (vcr_gaus_tpu/render/renderer.py: activations, projection,
// utils/sh.py, the shortest-axis normal, ops/projection.py pack_features)
// by itself; the port ran it as some 250 eager PyTorch kernels and autograd
// as about twice as many, each streaming (C,) columns over every slot. Both
// directions are one kernel here (ops/projection.py `preprocess`, a
// torch.autograd.Function; plain versions `preprocess_torch`,
// `preprocess_backward_torch`):
//
//   vcr_preprocess_fwd: the leaves in their own layouts (xyz, f_dc (C,1,3),
//     f_rest (C,K,3), log_scale, quat, logit_opacity, obj_dc (C,1,S)), the
//     active flags and the packed camera -> the (C, 14+S) packed features
//     (ops/projection.py's layout) and binning's inputs: the int32 radius
//     (0 where culled or inactive), the (C, 2) extents, and the mean2d
//     (C, 2) and depth (C,) columns again, contiguous, so that binning's
//     passes over them do not stride through the packed rows;
//   vcr_preprocess_bwd: the leaves and the camera again, and the features'
//     gradient (a row-major (C, ld) matrix whose first 14+S columns are
//     read: K2's output is (C, 16+S)) -> each leaf's gradient in the
//     leaf's layout. It recomputes the forward's terms; nothing per slot is
//     saved between the passes, and each slot owns its gradient rows, so
//     no atomics.
//
// The arithmetic is the plain version's, expression by expression in its
// order, with PyTorch's rounding of a Python float against a float32 tensor
// (the double constant cast to float) and its `a / t` as `(1 / t) * a`
// (Tensor.__rtruediv__ is reciprocal() * other); the library is built with
// --fmad=false, so nothing is fused, and the integer outputs (radius,
// extents, hence binning) equal those of the plain chain on the card. The
// plain version's two small reductions over a last dim (torch.sum of 3 and
// of 4 terms) add in the order of PyTorch's CUDA reduction (`sum3`,
// `sum4`). The normal's (C,3) @ (3,3) goes to cuBLAS in the plain chain and
// is a plain sum here; it feeds no integer output.
//
// The backward is the closed form of what autograd of the plain chain
// differentiates: the tanfov clamp's zero gradient outside its bounds
// (inclusive), the tz_safe and det_safe branches, safe_normalize's eps
// inside the rsqrt (the quaternion and the SH direction), the direction's
// gradient into the mean, the colour's clamp_min mask (v + 0.5 >= 0
// passes), the shortest axis's gather (first on ties) with its detached
// sign, plane_d into both the normal and the mean, the sigmoid and the exp.
//
// What bounds it on the card: the bytes. The forward reads 61 + S floats
// and the active byte a slot at SH 3 and writes 14 + S + 6; the backward
// reads the 61 + S leaves' floats and 14 + S gradient columns again and
// writes 61 + S; the arithmetic (a few hundred operations a slot) is far
// below the 67 TFLOP/s rate. So the design keeps every read and write
// coalesced: a block of 128 slots stages its contiguous f_rest rows (180 B
// a slot at SH 3, the largest stream) and its gradient rows through shared
// memory with 16-byte loads, writes its packed rows and its f_rest
// gradient back the same way, and reads the small per-slot rows (12-16 B)
// directly, a warp's loads covering a contiguous span. Shared rows have an
// odd stride, so a thread walking its own row hits a bank of its own. The
// SH degree is a template parameter (0..3, or -1 for zero colour: the
// stats sweeps); S and the normal columns are runtime flags.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;
constexpr int MAX_K = 15;         // f_rest rows at SH degree 3
constexpr int MAX_SEM = 8;
constexpr int N_FIXED = 14;
// the packed camera (ops/projection.py camera_vector)
constexpr int CAM_VIEW = 0, CAM_PROJ = 16, CAM_CENTER = 32, CAM_TANFOV = 35;
constexpr int CAM_FLOATS = 37;
// the packed feature columns (ops/projection.py)
constexpr int F_MEAN_X = 0, F_MEAN_Y = 1, F_CONIC_A = 2, F_CONIC_B = 3,
              F_CONIC_C = 4, F_OPACITY = 5, F_DEPTH_Z = 6, F_PLANE_D = 7,
              F_NORMAL = 8, F_RGB = 11, F_SEM = 14;

// utils/sh.py's constants as a float32 tensor op rounds them
constexpr float C0 = (float)0.28209479177387814;
constexpr float C1 = (float)0.4886025119029199;
constexpr float C2_0 = (float)1.0925484305920792;
constexpr float C2_1 = (float)-1.0925484305920792;
constexpr float C2_2 = (float)0.31539156525252005;
constexpr float C2_3 = (float)-1.0925484305920792;
constexpr float C2_4 = (float)0.5462742152960396;
constexpr float C3_0 = (float)-0.5900435899266435;
constexpr float C3_1 = (float)2.890611442640554;
constexpr float C3_2 = (float)-0.4570457994644658;
constexpr float C3_3 = (float)0.3731763325901154;
constexpr float C3_4 = (float)-0.4570457994644658;
constexpr float C3_5 = (float)1.445305721320277;
constexpr float C3_6 = (float)-0.5900435899266435;

constexpr float EPS_NORM = (float)1e-24;   // safe_normalize
constexpr float EPS_W = (float)1e-7;       // 1 / (w + 1e-7)
constexpr float EPS_Z = (float)1e-6;       // tz_safe
constexpr float LIM = (float)1.3;          // the tanfov clamp
constexpr float DILATE = (float)0.3;
constexpr float LAM_MIN = (float)0.1;
constexpr float NEAR = (float)0.2;
constexpr float OP_MIN = (float)1e-12;
constexpr float LVL_MAX = (float)4.5;

// torch.sum over a last dim of 3 and of 4 on the card: the reduction puts
// last_pow2(n) lanes on a row, lane 0 adds terms 0 and 2, lane 1 terms 1
// (and 3), and one shuffle adds the lanes
__device__ __forceinline__ float sum3(float a, float b, float c)
{
    return (a + c) + b;
}

__device__ __forceinline__ float sum4(float a, float b, float c, float d)
{
    return (a + c) + (b + d);
}

// torch.clamp and clamp_min: NaN passes through
__device__ __forceinline__ float clampf(float v, float lo, float hi)
{
    return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float clamp_minf(float v, float lo)
{
    return v < lo ? lo : v;
}

// Rows [0, nrows) of a row-major matrix with row stride `ld` (floats [0,
// (nrows - 1) ld + w), a contiguous span) into shared rows of stride `ws`,
// with 16-byte loads when the span is 16-byte aligned.
__device__ __forceinline__ void stage_in(float* s, int ws, const float* g,
                                         int ld, int w, int nrows)
{
    const int n = (nrows - 1) * ld + w;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
        const int n4 = n >> 2;
        const float4* g4 = reinterpret_cast<const float4*>(g);
        for (int i = threadIdx.x; i < n4; i += BLOCK) {
            const float4 v = g4[i];
            const float vals[4] = {v.x, v.y, v.z, v.w};
            int r = (4 * i) / ld;
            int c = 4 * i - r * ld;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                s[r * ws + c] = vals[j];
                if (++c == ld) { c = 0; ++r; }
            }
        }
        done = 4 * n4;
    }
    for (int i = done + threadIdx.x; i < n; i += BLOCK) {
        const int r = i / ld;
        s[r * ws + i - r * ld] = g[i];
    }
}

// Shared rows [0, nrows) of stride `ws` and width `w` into a contiguous
// row-major matrix of width `w`, with 16-byte stores when aligned.
__device__ __forceinline__ void stage_out(float* g, const float* s, int ws,
                                          int w, int nrows)
{
    const int n = nrows * w;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
        const int n4 = n >> 2;
        float4* g4 = reinterpret_cast<float4*>(g);
        for (int i = threadIdx.x; i < n4; i += BLOCK) {
            float vals[4];
            int r = (4 * i) / w;
            int c = 4 * i - r * w;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                vals[j] = s[r * ws + c];
                if (++c == w) { c = 0; ++r; }
            }
            g4[i] = make_float4(vals[0], vals[1], vals[2], vals[3]);
        }
        done = 4 * n4;
    }
    for (int i = done + threadIdx.x; i < n; i += BLOCK) {
        const int r = i / w;
        g[i] = s[r * ws + i - r * w];
    }
}

// The projection's terms of one slot (ops/projection.py `_terms`).
struct Terms {
    float tx, ty, tz, cx, cy, pw;
    float q[4];                  // normalized (w, x, y, z)
    float rq;                    // rsqrt(|q|^2 + eps)
    float R[3][3];
    float s_raw[3], s[3];        // exp(log_scale), times the modifier
    float fx, fy, tzs, ux, uy, limx, limy, txtz, tytz, inv_z, inv_z2;
    float T[2][3], M[2][3], U[2][3];
    float a, b, c, det, ds;
};

__device__ __forceinline__ void terms(const float* cam, int width, int height,
                                      float sm, float x, float y, float z,
                                      const float ls[3], const float qr[4],
                                      Terms& t)
{
    const float* V = cam + CAM_VIEW;
    const float* P = cam + CAM_PROJ;
    t.tx = x * V[0] + y * V[4] + z * V[8] + V[12];
    t.ty = x * V[1] + y * V[5] + z * V[9] + V[13];
    t.tz = x * V[2] + y * V[6] + z * V[10] + V[14];
    t.cx = x * P[0] + y * P[4] + z * P[8] + P[12];
    t.cy = x * P[1] + y * P[5] + z * P[9] + P[13];
    const float cw = x * P[3] + y * P[7] + z * P[11] + P[15];
    t.pw = 1.0f / (cw + EPS_W);

    t.rq = rsqrtf(sum4(qr[0] * qr[0], qr[1] * qr[1], qr[2] * qr[2],
                       qr[3] * qr[3]) + EPS_NORM);
#pragma unroll
    for (int i = 0; i < 4; ++i) t.q[i] = qr[i] * t.rq;
    const float qw = t.q[0], qx = t.q[1], qy = t.q[2], qz = t.q[3];
    t.R[0][0] = 1.0f - 2.0f * (qy * qy + qz * qz);
    t.R[0][1] = 2.0f * (qx * qy - qw * qz);
    t.R[0][2] = 2.0f * (qx * qz + qw * qy);
    t.R[1][0] = 2.0f * (qx * qy + qw * qz);
    t.R[1][1] = 1.0f - 2.0f * (qx * qx + qz * qz);
    t.R[1][2] = 2.0f * (qy * qz - qw * qx);
    t.R[2][0] = 2.0f * (qx * qz - qw * qy);
    t.R[2][1] = 2.0f * (qy * qz + qw * qx);
    t.R[2][2] = 1.0f - 2.0f * (qx * qx + qy * qy);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        t.s_raw[k] = expf(ls[k]);
        t.s[k] = t.s_raw[k] * sm;
    }

    const float tfx = cam[CAM_TANFOV], tfy = cam[CAM_TANFOV + 1];
    t.fx = (1.0f / (2.0f * tfx)) * (float)width;
    t.fy = (1.0f / (2.0f * tfy)) * (float)height;
    t.tzs = fabsf(t.tz) < EPS_Z ? EPS_Z : t.tz;
    t.limx = LIM * tfx;
    t.limy = LIM * tfy;
    t.ux = t.tx / t.tzs;
    t.uy = t.ty / t.tzs;
    t.txtz = clampf(t.ux, -t.limx, t.limx) * t.tz;
    t.tytz = clampf(t.uy, -t.limy, t.limy) * t.tz;
    t.inv_z = 1.0f / t.tzs;
    t.inv_z2 = t.inv_z * t.inv_z;
    const float j00 = t.fx * t.inv_z;
    const float j02 = -t.fx * t.txtz * t.inv_z2;
    const float j11 = t.fy * t.inv_z;
    const float j12 = -t.fy * t.tytz * t.inv_z2;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        t.T[0][j] = j00 * V[4 * j] + j02 * V[4 * j + 2];
        t.T[1][j] = j11 * V[4 * j + 1] + j12 * V[4 * j + 2];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            t.M[r][k] = t.T[r][0] * t.R[0][k] + t.T[r][1] * t.R[1][k]
                        + t.T[r][2] * t.R[2][k];
            t.U[r][k] = t.M[r][k] * t.s[k];
        }
    }
    const float(&U)[2][3] = t.U;
    t.a = U[0][0] * U[0][0] + U[0][1] * U[0][1] + U[0][2] * U[0][2] + DILATE;
    t.b = U[0][0] * U[1][0] + U[0][1] * U[1][1] + U[0][2] * U[1][2];
    t.c = U[1][0] * U[1][0] + U[1][1] * U[1][1] + U[1][2] * U[1][2] + DILATE;
    t.det = t.a * t.c - t.b * t.b;
    t.ds = t.det == 0.0f ? 1.0f : t.det;
}

// the shortest scale axis, first on ties (torch.argmin)
__device__ __forceinline__ int shortest_axis(const float s[3])
{
    return (s[0] <= s[1] && s[0] <= s[2]) ? 0 : (s[1] <= s[2] ? 1 : 2);
}

// SH basis function k (1..15) of utils/sh.py at the unit direction, and its
// gradient; eval_sh's own expression order is in sh_channel
__device__ __forceinline__ float sh_basis(int k, float x, float y, float z)
{
    const float xx = x * x, yy = y * y, zz = z * z;
    switch (k) {
    case 1: return -C1 * y;
    case 2: return C1 * z;
    case 3: return -C1 * x;
    case 4: return C2_0 * x * y;
    case 5: return C2_1 * y * z;
    case 6: return C2_2 * (2.0f * zz - xx - yy);
    case 7: return C2_3 * x * z;
    case 8: return C2_4 * (xx - yy);
    case 9: return C3_0 * y * (3.0f * xx - yy);
    case 10: return C3_1 * x * y * z;
    case 11: return C3_2 * y * (4.0f * zz - xx - yy);
    case 12: return C3_3 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
    case 13: return C3_4 * x * (4.0f * zz - xx - yy);
    case 14: return C3_5 * z * (xx - yy);
    default: return C3_6 * x * (xx - 3.0f * yy);
    }
}

__device__ __forceinline__ void sh_basis_grad(int k, float x, float y,
                                              float z, float& gx, float& gy,
                                              float& gz)
{
    const float xx = x * x, yy = y * y, zz = z * z;
    gx = gy = gz = 0.0f;
    switch (k) {
    case 1: gy = -C1; break;
    case 2: gz = C1; break;
    case 3: gx = -C1; break;
    case 4: gx = C2_0 * y; gy = C2_0 * x; break;
    case 5: gy = C2_1 * z; gz = C2_1 * y; break;
    case 6: gx = -2.0f * C2_2 * x; gy = -2.0f * C2_2 * y;
            gz = 4.0f * C2_2 * z; break;
    case 7: gx = C2_3 * z; gz = C2_3 * x; break;
    case 8: gx = 2.0f * C2_4 * x; gy = -2.0f * C2_4 * y; break;
    case 9: gx = 6.0f * C3_0 * x * y; gy = C3_0 * (3.0f * xx - 3.0f * yy);
            break;
    case 10: gx = C3_1 * y * z; gy = C3_1 * x * z; gz = C3_1 * x * y; break;
    case 11: gx = -2.0f * C3_2 * x * y;
             gy = C3_2 * (4.0f * zz - xx - 3.0f * yy);
             gz = 8.0f * C3_2 * y * z; break;
    case 12: gx = -6.0f * C3_3 * x * z; gy = -6.0f * C3_3 * y * z;
             gz = C3_3 * (6.0f * zz - 3.0f * xx - 3.0f * yy); break;
    case 13: gx = C3_4 * (4.0f * zz - 3.0f * xx - yy);
             gy = -2.0f * C3_4 * x * y; gz = 8.0f * C3_4 * x * z; break;
    case 14: gx = 2.0f * C3_5 * x * z; gy = -2.0f * C3_5 * y * z;
             gz = C3_5 * (xx - yy); break;
    default: gx = C3_6 * (3.0f * xx - 3.0f * yy); gy = -6.0f * C3_6 * x * y;
             break;
    }
}

// eval_sh of one colour channel, in its expression order: dc the DC
// coefficient, rest the slot's f_rest row (K rows of 3)
template <int D>
__device__ __forceinline__ float sh_channel(float dc, const float* rest,
                                            int ch, float x, float y, float z)
{
    float r = C0 * dc;
    if (D > 0) {
        r = r - C1 * y * rest[0 + ch] + C1 * z * rest[3 + ch]
            - C1 * x * rest[6 + ch];
    }
    if (D > 1) {
        const float xx = x * x, yy = y * y, zz = z * z;
        const float xy = x * y, yz = y * z, xz = x * z;
        r = r + C2_0 * xy * rest[9 + ch] + C2_1 * yz * rest[12 + ch]
            + C2_2 * (2.0f * zz - xx - yy) * rest[15 + ch]
            + C2_3 * xz * rest[18 + ch] + C2_4 * (xx - yy) * rest[21 + ch];
        if (D > 2) {
            r = r + C3_0 * y * (3.0f * xx - yy) * rest[24 + ch]
                + C3_1 * xy * z * rest[27 + ch]
                + C3_2 * y * (4.0f * zz - xx - yy) * rest[30 + ch]
                + C3_3 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy)
                      * rest[33 + ch]
                + C3_4 * x * (4.0f * zz - xx - yy) * rest[36 + ch]
                + C3_5 * z * (xx - yy) * rest[39 + ch]
                + C3_6 * x * (xx - 3.0f * yy) * rest[42 + ch];
        }
    }
    return r;
}

// v[a] for a runtime a, kept in registers
__device__ __forceinline__ float pick(const float v[3], int a)
{
    return a == 0 ? v[0] : (a == 1 ? v[1] : v[2]);
}

// the slot's camera-space normal: R's shortest-axis column, flipped to
// face the camera, times V[:3,:3]
__device__ __forceinline__ void normal_cam(const float* V, const Terms& t,
                                           float dx, float dy, float dz,
                                           int& axis, float& sign,
                                           float nc[3])
{
    axis = shortest_axis(t.s_raw);
    const float n0 = pick(t.R[0], axis), n1 = pick(t.R[1], axis),
                n2 = pick(t.R[2], axis);
    sign = sum3(dx * n0, dy * n1, dz * n2) > 0.0f ? 1.0f : -1.0f;
    const float m0 = n0 * sign, m1 = n1 * sign, m2 = n2 * sign;
#pragma unroll
    for (int j = 0; j < 3; ++j)
        nc[j] = m0 * V[j] + m1 * V[4 + j] + m2 * V[8 + j];
}

template <int D>
__global__ void __launch_bounds__(BLOCK) preprocess_fwd_kernel(
    const float* __restrict__ xyz, const float* __restrict__ f_dc,
    const float* __restrict__ f_rest, const float* __restrict__ log_scale,
    const float* __restrict__ quat, const float* __restrict__ logit_opacity,
    const float* __restrict__ obj_dc, int k_rest,
    const bool* __restrict__ active, const float* __restrict__ cam_g, int n,
    int width, int height, float sm, int ch_sem, int with_normal,
    float* __restrict__ feats, int* __restrict__ radius,
    float* __restrict__ ext, float* __restrict__ mean2d,
    float* __restrict__ depth)
{
    extern __shared__ float smem[];
    __shared__ float cam[CAM_FLOATS];
    const int row0 = blockIdx.x * BLOCK;
    const int nrows = min(BLOCK, n - row0);
    const int i = row0 + threadIdx.x;
    const bool live = threadIdx.x < nrows;
    const int wr = 3 * k_rest, wsr = wr | 1;
    const int nf = N_FIXED + ch_sem, wsf = nf | 1;

    if (threadIdx.x < CAM_FLOATS) cam[threadIdx.x] = cam_g[threadIdx.x];
    if (D > 0) stage_in(smem, wsr, f_rest + (size_t)row0 * wr, wr, wr, nrows);
    __syncthreads();

    float out[N_FIXED];
    if (live) {
        const float x = xyz[3 * i], y = xyz[3 * i + 1], z = xyz[3 * i + 2];
        const float ls[3] = {log_scale[3 * i], log_scale[3 * i + 1],
                             log_scale[3 * i + 2]};
        const float4 q4 = reinterpret_cast<const float4*>(quat)[i];
        const float qr[4] = {q4.x, q4.y, q4.z, q4.w};
        Terms t;
        terms(cam, width, height, sm, x, y, z, ls, qr, t);
        const float op = 1.0f / (1.0f + expf(-logit_opacity[i]));

        const float mid = 0.5f * (t.a + t.c);
        const float lam1 = mid + sqrtf(clamp_minf(mid * mid - t.det, LAM_MIN));
        const float rf = ceilf(3.0f * sqrtf(lam1));
        const float lvl = clampf(logf(255.0f * clamp_minf(op, OP_MIN)), 0.0f,
                                 LVL_MAX);
        float ex = ceilf(sqrtf(2.0f * lvl * t.a));
        float ey = ceilf(sqrtf(2.0f * lvl * t.c));
        if (op * 255.0f <= 1.0f) ex = ey = 0.0f;
        const float mx = ((t.cx * t.pw + 1.0f) * (float)width - 1.0f) * 0.5f;
        const float my = ((t.cy * t.pw + 1.0f) * (float)height - 1.0f) * 0.5f;
        const bool keep = t.tz > NEAR && t.det > 0.0f && mx + rf > 0.0f
                          && mx - rf < (float)width && my + rf > 0.0f
                          && my - rf < (float)height;
        radius[i] = keep && active[i] ? (int)rf : 0;
        reinterpret_cast<float2*>(ext)[i] =
            keep ? make_float2(ex, ey) : make_float2(0.0f, 0.0f);
        reinterpret_cast<float2*>(mean2d)[i] = make_float2(mx, my);
        depth[i] = t.tz;

        const float* Vm = cam + CAM_VIEW;
        const float dx = x - cam[CAM_CENTER], dy = y - cam[CAM_CENTER + 1],
                    dz = z - cam[CAM_CENTER + 2];
        float rgb[3] = {0.0f, 0.0f, 0.0f};
        if (D >= 0) {
            const float rd = rsqrtf(sum3(dx * dx, dy * dy, dz * dz)
                                    + EPS_NORM);
            const float X = dx * rd, Y = dy * rd, Z = dz * rd;
            const float* rest = smem + threadIdx.x * wsr;
#pragma unroll
            for (int ch = 0; ch < 3; ++ch)
                rgb[ch] = clamp_minf(
                    sh_channel<D>(f_dc[3 * i + ch], rest, ch, X, Y, Z) + 0.5f,
                    0.0f);
        }
        float nc[3] = {0.0f, 0.0f, 0.0f};
        if (with_normal) {
            int axis;
            float sign;
            normal_cam(Vm, t, dx, dy, dz, axis, sign, nc);
        }
        out[F_MEAN_X] = mx;
        out[F_MEAN_Y] = my;
        out[F_CONIC_A] = t.c / t.ds;
        out[F_CONIC_B] = -t.b / t.ds;
        out[F_CONIC_C] = t.a / t.ds;
        out[F_OPACITY] = op;
        out[F_DEPTH_Z] = t.tz;
        out[F_PLANE_D] = sum3(nc[0] * t.tx, nc[1] * t.ty, nc[2] * t.tz);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            out[F_NORMAL + j] = nc[j];
            out[F_RGB + j] = rgb[j];
        }
    }
    __syncthreads();            // every f_rest row is read: reuse the rows
    if (live) {
        float* row = smem + threadIdx.x * wsf;
#pragma unroll
        for (int j = 0; j < N_FIXED; ++j) row[j] = out[j];
        for (int s = 0; s < ch_sem; ++s)
            row[F_SEM + s] = obj_dc[(size_t)i * ch_sem + s];
    }
    __syncthreads();
    stage_out(feats + (size_t)row0 * nf, smem, wsf, nf, nrows);
}

template <int D>
__global__ void __launch_bounds__(BLOCK) preprocess_bwd_kernel(
    const float* __restrict__ xyz, const float* __restrict__ f_dc,
    const float* __restrict__ f_rest, const float* __restrict__ log_scale,
    const float* __restrict__ quat, const float* __restrict__ logit_opacity,
    int k_rest, const float* __restrict__ cam_g, int n, int width,
    int height, float sm, int ch_sem, int with_normal,
    const float* __restrict__ g_feats, int ldg, float* __restrict__ g_xyz,
    float* __restrict__ g_f_dc, float* __restrict__ g_f_rest,
    float* __restrict__ g_log_scale, float* __restrict__ g_quat,
    float* __restrict__ g_logit_opacity, float* __restrict__ g_obj_dc)
{
    extern __shared__ float smem[];
    __shared__ float cam[CAM_FLOATS];
    const int row0 = blockIdx.x * BLOCK;
    const int nrows = min(BLOCK, n - row0);
    const int i = row0 + threadIdx.x;
    const bool live = threadIdx.x < nrows;
    const int wr = 3 * k_rest, wsr = wr | 1;
    const int nf = N_FIXED + ch_sem, wsg = ldg | 1;
    float* s_rest = smem;
    float* s_g = smem + BLOCK * wsr;

    if (threadIdx.x < CAM_FLOATS) cam[threadIdx.x] = cam_g[threadIdx.x];
    if (D > 0) stage_in(s_rest, wsr, f_rest + (size_t)row0 * wr, wr, wr,
                        nrows);
    stage_in(s_g, wsg, g_feats + (size_t)row0 * ldg, ldg, nf, nrows);
    __syncthreads();

    if (live) {
        const float* gr = s_g + threadIdx.x * wsg;
        float* rest = s_rest + threadIdx.x * wsr;
        const float* V = cam + CAM_VIEW;
        const float* P = cam + CAM_PROJ;
        const float x = xyz[3 * i], y = xyz[3 * i + 1], z = xyz[3 * i + 2];
        const float ls[3] = {log_scale[3 * i], log_scale[3 * i + 1],
                             log_scale[3 * i + 2]};
        const float4 q4 = reinterpret_cast<const float4*>(quat)[i];
        const float qr[4] = {q4.x, q4.y, q4.z, q4.w};
        Terms t;
        terms(cam, width, height, sm, x, y, z, ls, qr, t);

        // conic (c, -b, a) / det_safe
        const float ds = t.ds;
        float ga = gr[F_CONIC_C] / ds;
        float gb = -gr[F_CONIC_B] / ds;
        float gc = gr[F_CONIC_A] / ds;
        if (t.det != 0.0f) {
            const float gds = -(gr[F_CONIC_A] * t.c - gr[F_CONIC_B] * t.b
                                + gr[F_CONIC_C] * t.a) / (ds * ds);
            ga += gds * t.c;
            gc += gds * t.a;
            gb -= 2.0f * t.b * gds;
        }
        // a, b, c of U; U = M diag(s); M = T R
        float gs[3], gM[2][3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const float gu0 = 2.0f * t.U[0][k] * ga + t.U[1][k] * gb;
            const float gu1 = 2.0f * t.U[1][k] * gc + t.U[0][k] * gb;
            gs[k] = gu0 * t.M[0][k] + gu1 * t.M[1][k];
            gM[0][k] = gu0 * t.s[k];
            gM[1][k] = gu1 * t.s[k];
        }
        float gT[2][3], gR[3][3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
#pragma unroll
            for (int r = 0; r < 2; ++r)
                gT[r][j] = gM[r][0] * t.R[j][0] + gM[r][1] * t.R[j][1]
                           + gM[r][2] * t.R[j][2];
#pragma unroll
            for (int k = 0; k < 3; ++k)
                gR[j][k] = gM[0][k] * t.T[0][j] + gM[1][k] * t.T[1][j];
        }
        // T0j = j00 V[j,0] + j02 V[j,2], T1j = j11 V[j,1] + j12 V[j,2]
        float gj00 = 0.0f, gj02 = 0.0f, gj11 = 0.0f, gj12 = 0.0f;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            gj00 += gT[0][j] * V[4 * j];
            gj02 += gT[0][j] * V[4 * j + 2];
            gj11 += gT[1][j] * V[4 * j + 1];
            gj12 += gT[1][j] * V[4 * j + 2];
        }
        const float g_inv_z2 = -(t.fx * t.txtz * gj02 + t.fy * t.tytz * gj12);
        const float g_inv_z = t.fx * gj00 + t.fy * gj11
                              + 2.0f * t.inv_z * g_inv_z2;
        const float g_txtz = -t.fx * t.inv_z2 * gj02;
        const float g_tytz = -t.fy * t.inv_z2 * gj12;
        float g_tz = clampf(t.ux, -t.limx, t.limx) * g_txtz
                     + clampf(t.uy, -t.limy, t.limy) * g_tytz;
        const float g_ux = (t.ux >= -t.limx && t.ux <= t.limx)
                               ? t.tz * g_txtz : 0.0f;
        const float g_uy = (t.uy >= -t.limy && t.uy <= t.limy)
                               ? t.tz * g_tytz : 0.0f;
        float g_tx = g_ux / t.tzs;
        float g_ty = g_uy / t.tzs;
        if (!(fabsf(t.tz) < EPS_Z))
            g_tz += -(g_ux * t.ux + g_uy * t.uy) / t.tzs - g_inv_z * t.inv_z2;
        g_tz += gr[F_DEPTH_Z];

        // mean2d = ((c pw + 1) size - 1) / 2, pw = 1 / (cw + eps)
        const float hw = 0.5f * (float)width, hh = 0.5f * (float)height;
        const float g_cx = gr[F_MEAN_X] * hw * t.pw;
        const float g_cy = gr[F_MEAN_Y] * hh * t.pw;
        const float g_pw = gr[F_MEAN_X] * hw * t.cx + gr[F_MEAN_Y] * hh * t.cy;
        const float g_cw = -g_pw * t.pw * t.pw;

        const float dx = x - cam[CAM_CENTER], dy = y - cam[CAM_CENTER + 1],
                    dz = z - cam[CAM_CENTER + 2];
        if (with_normal) {
            int axis;
            float sign, nc[3];
            normal_cam(V, t, dx, dy, dz, axis, sign, nc);
            const float g_pd = gr[F_PLANE_D];
            const float mc[3] = {t.tx, t.ty, t.tz};
            float g_nc[3];
#pragma unroll
            for (int j = 0; j < 3; ++j)
                g_nc[j] = gr[F_NORMAL + j] + g_pd * mc[j];
            g_tx += g_pd * nc[0];
            g_ty += g_pd * nc[1];
            g_tz += g_pd * nc[2];
#pragma unroll
            for (int r = 0; r < 3; ++r) {
                const float g_n = sign * (V[4 * r] * g_nc[0]
                                          + V[4 * r + 1] * g_nc[1]
                                          + V[4 * r + 2] * g_nc[2]);
#pragma unroll
                for (int k = 0; k < 3; ++k)
                    if (k == axis) gR[r][k] += g_n;
            }
        }

        // R of the normalized quaternion, then safe_normalize
        const float qw = t.q[0], qx = t.q[1], qy = t.q[2], qz = t.q[3];
        const float(&G)[3][3] = gR;
        float gq[4];
        gq[0] = 2.0f * (-qz * G[0][1] + qy * G[0][2] + qz * G[1][0]
                        - qx * G[1][2] - qy * G[2][0] + qx * G[2][1]);
        gq[1] = 2.0f * (qy * G[0][1] + qz * G[0][2] + qy * G[1][0]
                        - 2.0f * qx * G[1][1] - qw * G[1][2] + qz * G[2][0]
                        + qw * G[2][1] - 2.0f * qx * G[2][2]);
        gq[2] = 2.0f * (-2.0f * qy * G[0][0] + qx * G[0][1] + qw * G[0][2]
                        + qx * G[1][0] + qz * G[1][2] - qw * G[2][0]
                        + qz * G[2][1] - 2.0f * qy * G[2][2]);
        gq[3] = 2.0f * (-2.0f * qz * G[0][0] - qw * G[0][1] + qx * G[0][2]
                        + qw * G[1][0] - 2.0f * qz * G[1][1] + qy * G[1][2]
                        + qx * G[2][0] + qy * G[2][1]);
        const float gqq = gq[0] * qr[0] + gq[1] * qr[1] + gq[2] * qr[2]
                          + gq[3] * qr[3];
        const float rq3 = t.rq * t.rq * t.rq;
        reinterpret_cast<float4*>(g_quat)[i] = make_float4(
            t.rq * gq[0] - rq3 * gqq * qr[0],
            t.rq * gq[1] - rq3 * gqq * qr[1],
            t.rq * gq[2] - rq3 * gqq * qr[2],
            t.rq * gq[3] - rq3 * gqq * qr[3]);

        // the mean, through camera space and clip space
        float gx = V[0] * g_tx + V[1] * g_ty + V[2] * g_tz + P[0] * g_cx
                   + P[1] * g_cy + P[3] * g_cw;
        float gy = V[4] * g_tx + V[5] * g_ty + V[6] * g_tz + P[4] * g_cx
                   + P[5] * g_cy + P[7] * g_cw;
        float gz = V[8] * g_tx + V[9] * g_ty + V[10] * g_tz + P[8] * g_cx
                   + P[9] * g_cy + P[11] * g_cw;

        // colour: rgb = max(eval_sh + 0.5, 0); f_rest rows past the degree
        // get zeros
        constexpr int NK = D >= 0 ? (D + 1) * (D + 1) : 0;
        float gdc[3] = {0.0f, 0.0f, 0.0f};
        if (D >= 0) {
            const float rd = rsqrtf(sum3(dx * dx, dy * dy, dz * dz)
                                    + EPS_NORM);
            const float X = dx * rd, Y = dy * rd, Z = dz * rd;
            float gv[3];
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) {
                const float v = sh_channel<D>(f_dc[3 * i + ch], rest, ch, X,
                                              Y, Z);
                gv[ch] = v + 0.5f >= 0.0f ? gr[F_RGB + ch] : 0.0f;
                gdc[ch] = gv[ch] * C0;
            }
            float gdx = 0.0f, gdy = 0.0f, gdz = 0.0f;
#pragma unroll
            for (int k = 1; k < NK; ++k) {
                float* row = rest + 3 * (k - 1);
                const float w = gv[0] * row[0] + gv[1] * row[1]
                                + gv[2] * row[2];
                float bx, by, bz;
                sh_basis_grad(k, X, Y, Z, bx, by, bz);
                gdx += w * bx;
                gdy += w * by;
                gdz += w * bz;
                const float b = sh_basis(k, X, Y, Z);
#pragma unroll
                for (int ch = 0; ch < 3; ++ch) row[ch] = gv[ch] * b;
            }
            const float gdd = gdx * dx + gdy * dy + gdz * dz;
            const float rd3 = rd * rd * rd;
            gx += rd * gdx - rd3 * gdd * dx;
            gy += rd * gdy - rd3 * gdd * dy;
            gz += rd * gdz - rd3 * gdd * dz;
        }
        for (int j = 3 * (NK > 0 ? NK - 1 : 0); j < wr; ++j) rest[j] = 0.0f;

        g_xyz[3 * i] = gx;
        g_xyz[3 * i + 1] = gy;
        g_xyz[3 * i + 2] = gz;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) g_f_dc[3 * i + ch] = gdc[ch];
#pragma unroll
        for (int k = 0; k < 3; ++k)
            g_log_scale[3 * i + k] = gs[k] * sm * t.s_raw[k];
        const float op = 1.0f / (1.0f + expf(-logit_opacity[i]));
        g_logit_opacity[i] = gr[F_OPACITY] * (1.0f - op) * op;
        for (int s = 0; s < ch_sem; ++s)
            g_obj_dc[(size_t)i * ch_sem + s] = gr[F_SEM + s];
    }
    __syncthreads();
    if (wr > 0)
        stage_out(g_f_rest + (size_t)row0 * wr, s_rest, wsr, wr, nrows);
}

template <int D>
cudaError_t launch_fwd(const float* xyz, const float* f_dc,
                       const float* f_rest, const float* log_scale,
                       const float* quat, const float* logit_opacity,
                       const float* obj_dc, int k_rest, const bool* active,
                       const float* cam, int n, int width, int height,
                       float sm, int ch_sem, int with_normal, float* feats,
                       int* radius, float* ext, float* mean2d, float* depth,
                       cudaStream_t stream)
{
    const int wsr = D > 0 ? (3 * k_rest) | 1 : 0;
    const int wsf = (N_FIXED + ch_sem) | 1;
    const size_t smem = sizeof(float) * BLOCK * (wsr > wsf ? wsr : wsf);
    preprocess_fwd_kernel<D><<<(n + BLOCK - 1) / BLOCK, BLOCK, smem,
                               stream>>>(
        xyz, f_dc, f_rest, log_scale, quat, logit_opacity, obj_dc, k_rest,
        active, cam, n, width, height, sm, ch_sem, with_normal, feats,
        radius, ext, mean2d, depth);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const float* xyz, const float* f_dc,
                       const float* f_rest, const float* log_scale,
                       const float* quat, const float* logit_opacity,
                       int k_rest, const float* cam, int n, int width,
                       int height, float sm, int ch_sem, int with_normal,
                       const float* g_feats, int ldg, float* g_xyz,
                       float* g_f_dc, float* g_f_rest, float* g_log_scale,
                       float* g_quat, float* g_logit_opacity,
                       float* g_obj_dc, cudaStream_t stream)
{
    const size_t smem = sizeof(float) * BLOCK
                        * (((3 * k_rest) | 1) + (ldg | 1));
    preprocess_bwd_kernel<D><<<(n + BLOCK - 1) / BLOCK, BLOCK, smem,
                               stream>>>(
        xyz, f_dc, f_rest, log_scale, quat, logit_opacity, k_rest, cam, n,
        width, height, sm, ch_sem, with_normal, g_feats, ldg, g_xyz, g_f_dc,
        g_f_rest, g_log_scale, g_quat, g_logit_opacity, g_obj_dc);
    return cudaGetLastError();
}

bool valid(int k_rest, int sh_degree, int ch_sem)
{
    return k_rest >= 0 && k_rest <= MAX_K && ch_sem >= 0 && ch_sem <= MAX_SEM
           && sh_degree >= -1 && sh_degree <= 3
           && (sh_degree + 1) * (sh_degree + 1) - 1 <= k_rest;
}

}  // namespace

extern "C" int vcr_preprocess_fwd(
    const float* xyz, const float* f_dc, const float* f_rest,
    const float* log_scale, const float* quat, const float* logit_opacity,
    const float* obj_dc, int k_rest, const bool* active, const float* cam,
    int n, int width, int height, float scale_modifier, int sh_degree,
    int ch_sem, int with_normal, float* feats, int* radius, float* ext,
    float* mean2d, float* depth, void* stream)
{
    if (!valid(k_rest, sh_degree, ch_sem) || n < 0)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
#define FWD(D)                                                               \
    launch_fwd<D>(xyz, f_dc, f_rest, log_scale, quat, logit_opacity, obj_dc, \
                  k_rest, active, cam, n, width, height, scale_modifier,     \
                  ch_sem, with_normal, feats, radius, ext, mean2d, depth, s)
    switch (sh_degree) {
    case -1: return (int)FWD(-1);
    case 0: return (int)FWD(0);
    case 1: return (int)FWD(1);
    case 2: return (int)FWD(2);
    default: return (int)FWD(3);
    }
#undef FWD
}

extern "C" int vcr_preprocess_bwd(
    const float* xyz, const float* f_dc, const float* f_rest,
    const float* log_scale, const float* quat, const float* logit_opacity,
    const float* obj_dc, int k_rest, const float* cam, int n, int width,
    int height, float scale_modifier, int sh_degree, int ch_sem,
    int with_normal, const float* g_feats, int ldg, float* g_xyz,
    float* g_f_dc, float* g_f_rest, float* g_log_scale, float* g_quat,
    float* g_logit_opacity, float* g_obj_dc, void* stream)
{
    (void)obj_dc;               // its gradient is the semantic columns'
    if (!valid(k_rest, sh_degree, ch_sem) || n < 0
        || ldg < N_FIXED + ch_sem || ldg > N_FIXED + ch_sem + 2)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
#define BWD(D)                                                               \
    launch_bwd<D>(xyz, f_dc, f_rest, log_scale, quat, logit_opacity, k_rest, \
                  cam, n, width, height, scale_modifier, ch_sem, with_normal, \
                  g_feats, ldg, g_xyz, g_f_dc, g_f_rest, g_log_scale, g_quat, \
                  g_logit_opacity, g_obj_dc, s)
    switch (sh_degree) {
    case -1: return (int)BWD(-1);
    case 0: return (int)BWD(0);
    case 1: return (int)BWD(1);
    case 2: return (int)BWD(2);
    default: return (int)BWD(3);
    }
#undef BWD
}
