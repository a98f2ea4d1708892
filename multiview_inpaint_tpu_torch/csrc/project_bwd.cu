// K7: the backward of the splat projection (K6) for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package differentiates its jnp
// projection through XLA (multiview_inpaint_tpu/ops/rasterizer/
// geometry.py `project_gaussians`); the port's plain path records
// GaussianParams' activations, ops/rasterizer/geometry.py
// `project_gaussians` and utils/sh.py `eval_sh` as some 490 autograd nodes
// over the rows, whose backward is some 620 more launches, the SH stack's
// 16 full-size zero fills and their sum among them. This kernel is the
// whole backward of one camera's projection in one launch that the host
// never waits for; ops/rasterizer/project_cuda.py's autograd Function
// takes it after K6's forward.
//
// What it computes, per splat row: from the cotangents of means2d, conic,
// depth, colour and opacity (each a strided column, or absent for zero),
// the gradients of xyz, features_dc, features_rest, opacity, scaling and
// rotation and of the means2d offset, through the chain K6 computes:
// sigmoid, exp(minimum(scaling, 20)) (ties split in halves, as autograd
// splits them), the two quaternion normalisations (the first one's clamp
// at 1e-12 as torch.clamp passes it), the view and clip transforms, the
// EWA covariance with the 1.3 tan-fov clamp (gradient where the value
// lies within the bounds, ends included), the conic's inverse
// determinant, the SH colour at degrees 0-3 with its view direction's
// gradient into xyz, and clamp(min=0) on the colour. A culled or dead row
// (radius 0) gets zeros: the render gives it no cotangent.
//
// Rounding: the row's forward is recomputed as K6 computes it, operation
// for operation (this source too is built with -fmad=false), so that each
// clamp, the scale's minimum and the colour's cut at 0 take the side the
// forward took. The backward's own operations round as float32 does; the
// plain version (project_cuda.project_bwd_ref) agrees to rounding.
//
// What bounds it on the H100: bytes. At SH degree 3 a splat reads its 59
// parameters (236 B), its radius (4) and 10 cotangents (40), and writes
// 59 gradients and the offset's 2 (244): ~524 B, 0.31 ms for 2M splats at
// 3.35 TB/s. Its ~1,000 FP32 operations a splat are far under the card's
// rate.
//
// What the design does about it: K6's. One thread per splat, kRows
// splats a block; the block stages its rows of every parameter array in
// shared memory by coalesced 16-byte loads, each thread reads its row at
// an odd pitch, writes the row's gradients over it in place, and the
// block stores the staged gradients back as coalesced runs (16-byte
// stores where the rows are packed). The cotangents, a few floats a row
// at any row stride (the packed attributes' gradient is read where it
// lies, with no copy), are read by each thread straight from memory.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;   // splats (threads) per block

// K6's scalars (csrc/project.cu), rounded from double as PyTorch rounds a
// scalar against a float32 tensor.
constexpr float kEps7 = (float)1e-7;
constexpr float kEps12 = (float)1e-12;
constexpr float kEps24 = (float)1e-24;
constexpr float kLowPass = (float)0.3;
constexpr float kScaleMax = (float)20.0;

// utils/sh.py's basis constants.
constexpr float kC0 = (float)0.28209479177387814;
constexpr float kC1 = (float)0.4886025119029199;
constexpr float kC2_0 = (float)1.0925484305920792;
constexpr float kC2_1 = (float)-1.0925484305920792;
constexpr float kC2_2 = (float)0.31539156525252005;
constexpr float kC2_3 = (float)-1.0925484305920792;
constexpr float kC2_4 = (float)0.5462742152960396;
constexpr float kC3_0 = (float)-0.5900435899266435;
constexpr float kC3_1 = (float)2.890611442640554;
constexpr float kC3_2 = (float)-0.4570457994644658;
constexpr float kC3_3 = (float)0.3731763325901154;
constexpr float kC3_4 = (float)-0.4570457994644658;
constexpr float kC3_5 = (float)1.445305721320277;
constexpr float kC3_6 = (float)-0.5900435899266435;

struct View {
  float width, height;      // pixels
  float focal_x, focal_y;   // width / (2 tan_fovx), height / (2 tan_fovy)
  float lim_x, lim_y;       // 1.3 tan_fov
  float modifier;           // scaling_modifier
};

// A cotangent's rows lie `stride` floats apart; NULL reads as zero.
struct Cotangent {
  const float* p;
  long long stride;
  __device__ __forceinline__ float at(long long i, int k) const {
    return p ? p[i * stride + k] : 0.0f;
  }
};

struct Cotangents {
  Cotangent means2d, conic, depth, color, opacity;
};

struct Grads {
  float* xyz;        // [N, 3]
  float* dc;         // [N, 1, 3]
  float* rest;       // [N, M, 3]
  float* opacity;    // [N, 1]
  float* scaling;    // [N, 3]
  float* rotation;   // [N, 4]
  float* offset;     // [N, 2] or NULL
};

// torch.clamp(v, lo, hi), clamp(min=lo): NaN passes.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// K6's torch.sum over a contiguous row of four.
__device__ __forceinline__ float sum4(float a, float b, float c, float d) {
  return (a + c) + (b + d);
}

// Float i of a block's run of rows into dst at kPitch floats a row.
template <int kWidth, int kPitch>
__device__ __forceinline__ void put(float* dst, int i, float x) {
  const int row = i / kWidth;
  dst[row * kPitch + i - row * kWidth] = x;
}

// K6's staging: rows [r0, r0 + rows) of a [N, kWidth] array whose rows
// lie `stride` floats apart into dst at kPitch floats a row.
template <int kWidth, int kPitch>
__device__ __forceinline__ void stage(float* dst,
                                      const float* __restrict__ src,
                                      long long r0, int rows,
                                      long long stride) {
  const float* run = src + r0 * stride;
  const int total = rows * kWidth;
  int done = 0;
  if (stride == kWidth && (reinterpret_cast<size_t>(run) & 15) == 0) {
    const float4* run4 = reinterpret_cast<const float4*>(run);
    done = total & ~3;
#pragma unroll 4
    for (int i = threadIdx.x; i < done / 4; i += kRows) {
      const float4 x = run4[i];
      if constexpr (kPitch == kWidth) {
        reinterpret_cast<float4*>(dst)[i] = x;
      } else {
        put<kWidth, kPitch>(dst, 4 * i, x.x);
        put<kWidth, kPitch>(dst, 4 * i + 1, x.y);
        put<kWidth, kPitch>(dst, 4 * i + 2, x.z);
        put<kWidth, kPitch>(dst, 4 * i + 3, x.w);
      }
    }
  }
#pragma unroll 4
  for (int i = done + threadIdx.x; i < total; i += kRows) {
    const int row = i / kWidth;
    put<kWidth, kPitch>(dst, i, run[row * stride + i - row * kWidth]);
  }
}

// The reverse: src's rows (kWidth floats at kPitch a row) into rows [r0,
// r0 + rows) of a [N, stride] array, whose floats past kWidth in a row
// are written 0. 16-byte stores where the run is packed and aligned.
template <int kWidth, int kPitch>
__device__ __forceinline__ void unstage(float* __restrict__ dst,
                                        const float* src, long long r0,
                                        int rows, int stride) {
  float* run = dst + r0 * stride;
  const int total = rows * stride;
  int done = 0;
  if constexpr (kPitch == kWidth && kWidth > 0) {
    if (stride == kWidth && (reinterpret_cast<size_t>(run) & 15) == 0) {
      float4* run4 = reinterpret_cast<float4*>(run);
      done = total & ~3;
#pragma unroll 4
      for (int i = threadIdx.x; i < done / 4; i += kRows)
        run4[i] = reinterpret_cast<const float4*>(src)[i];
    }
  }
#pragma unroll 4
  for (int i = done + threadIdx.x; i < total; i += kRows) {
    const int row = i / stride;
    const int col = i - row * stride;
    run[i] = col < kWidth ? src[row * kPitch + col] : 0.0f;
  }
}

// utils/sh.py's basis function k (1-15) at the unit direction (x, y, z):
// its value and its partial derivatives.
__device__ __forceinline__ void sh_term(int k, float x, float y, float z,
                                        float& v, float& gx, float& gy,
                                        float& gz) {
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, yz = y * z, xz = x * z;
  switch (k) {
    case 1: v = -kC1 * y; gx = 0.0f; gy = -kC1; gz = 0.0f; break;
    case 2: v = kC1 * z; gx = 0.0f; gy = 0.0f; gz = kC1; break;
    case 3: v = -kC1 * x; gx = -kC1; gy = 0.0f; gz = 0.0f; break;
    case 4: v = kC2_0 * xy; gx = kC2_0 * y; gy = kC2_0 * x; gz = 0.0f;
      break;
    case 5: v = kC2_1 * yz; gx = 0.0f; gy = kC2_1 * z; gz = kC2_1 * y;
      break;
    case 6:
      v = kC2_2 * (2.0f * zz - xx - yy);
      gx = -2.0f * kC2_2 * x; gy = -2.0f * kC2_2 * y; gz = 4.0f * kC2_2 * z;
      break;
    case 7: v = kC2_3 * xz; gx = kC2_3 * z; gy = 0.0f; gz = kC2_3 * x;
      break;
    case 8:
      v = kC2_4 * (xx - yy);
      gx = 2.0f * kC2_4 * x; gy = -2.0f * kC2_4 * y; gz = 0.0f;
      break;
    case 9:
      v = kC3_0 * y * (3.0f * xx - yy);
      gx = 6.0f * kC3_0 * xy; gy = 3.0f * kC3_0 * (xx - yy); gz = 0.0f;
      break;
    case 10:
      v = kC3_1 * xy * z;
      gx = kC3_1 * yz; gy = kC3_1 * xz; gz = kC3_1 * xy;
      break;
    case 11:
      v = kC3_2 * y * (4.0f * zz - xx - yy);
      gx = -2.0f * kC3_2 * xy; gy = kC3_2 * (4.0f * zz - xx - 3.0f * yy);
      gz = 8.0f * kC3_2 * yz;
      break;
    case 12:
      v = kC3_3 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
      gx = -6.0f * kC3_3 * xz; gy = -6.0f * kC3_3 * yz;
      gz = kC3_3 * (6.0f * zz - 3.0f * xx - 3.0f * yy);
      break;
    case 13:
      v = kC3_4 * x * (4.0f * zz - xx - yy);
      gx = kC3_4 * (4.0f * zz - 3.0f * xx - yy); gy = -2.0f * kC3_4 * xy;
      gz = 8.0f * kC3_4 * xz;
      break;
    case 14:
      v = kC3_5 * z * (xx - yy);
      gx = 2.0f * kC3_5 * xz; gy = -2.0f * kC3_5 * yz; gz = kC3_5 * (xx - yy);
      break;
    default:   // 15
      v = kC3_6 * x * (xx - 3.0f * yy);
      gx = 3.0f * kC3_6 * (xx - yy); gy = -6.0f * kC3_6 * xy; gz = 0.0f;
      break;
  }
}

template <int kDeg>
__global__ void __launch_bounds__(kRows)
project_bwd_kernel(const float* __restrict__ xyz,
                   const float* __restrict__ dc,
                   const float* __restrict__ rest,
                   const float* __restrict__ opacity,
                   const float* __restrict__ scaling,
                   const float* __restrict__ rotation,
                   const int* __restrict__ radius,
                   const float* __restrict__ world_view,
                   const float* __restrict__ full_proj,
                   const float* __restrict__ campos, int n, int rest_stride,
                   View v, Cotangents g, Grads out) {
  constexpr int kCoefs = (kDeg + 1) * (kDeg + 1);
  constexpr int kRest = (kCoefs - 1) * 3;
  constexpr int kRestPitch = kRest | 1;   // odd: conflict-free rows
  __shared__ float s_cam[35];   // world_view, full_proj, campos
  __shared__ __align__(16) float s_xyz[kRows * 3];
  __shared__ __align__(16) float s_dc[kRows * 3];
  __shared__ __align__(16) float s_scale[kRows * 3];
  __shared__ __align__(16) float s_rot[kRows * 5];
  __shared__ __align__(16) float s_rest[kRows * kRestPitch];

  const int t = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * kRows;
  const int rows = (int)min((long long)kRows, (long long)n - r0);
  if (t < 16) s_cam[t] = world_view[t];
  else if (t < 32) s_cam[t] = full_proj[t - 16];
  else if (t < 35) s_cam[t] = campos[t - 32];
  stage<3, 3>(s_xyz, xyz, r0, rows, 3);
  stage<3, 3>(s_dc, dc, r0, rows, 3);
  stage<3, 3>(s_scale, scaling, r0, rows, 3);
  stage<4, 5>(s_rot, rotation, r0, rows, 4);
  if constexpr (kRest > 0)
    stage<kRest, kRestPitch>(s_rest, rest, r0, rows, rest_stride);
  __syncthreads();

  if (t < rows) {
    const long long i = r0 + t;
    float* sh = s_rest + t * kRestPitch;   // coefficient k at 3(k-1)
    if (radius[i] <= 0) {
      // Culled or dead: no cotangent reaches the row.
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        s_xyz[3 * t + k] = 0.0f;
        s_dc[3 * t + k] = 0.0f;
        s_scale[3 * t + k] = 0.0f;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) s_rot[5 * t + k] = 0.0f;
#pragma unroll
      for (int k = 0; k < kRest; ++k) sh[k] = 0.0f;
      out.opacity[i] = 0.0f;
      if (out.offset)
        reinterpret_cast<float2*>(out.offset)[i] = make_float2(0.0f, 0.0f);
    } else {
      const float* W = s_cam;
      const float* F = s_cam + 16;
      const float* C = s_cam + 32;
      const float px = s_xyz[3 * t], py = s_xyz[3 * t + 1],
                  pz = s_xyz[3 * t + 2];

      // ---- The forward, as K6 computes it. ----
      const float tx = px * W[0] + py * W[1] + pz * W[2] + W[3];
      const float ty = px * W[4] + py * W[5] + pz * W[6] + W[7];
      const float tz = px * W[8] + py * W[9] + pz * W[10] + W[11];
      const float ph0 = px * F[0] + py * F[1] + pz * F[2] + F[3];
      const float ph1 = px * F[4] + py * F[5] + pz * F[6] + F[7];
      const float pw = px * F[12] + py * F[13] + pz * F[14] + F[15];
      const float inv_w = 1.0f / (pw + kEps7);

      const float inv_z = 1.0f / tz;
      const float xr = tx * inv_z, yr = ty * inv_z;
      const float cx = clamp(xr, -v.lim_x, v.lim_x);
      const float cy = clamp(yr, -v.lim_y, v.lim_y);
      const float txz = cx * tz;
      const float tyz = cy * tz;
      const float al = v.focal_x * inv_z;
      const float be = -v.focal_x * txz * inv_z * inv_z;
      const float ga = v.focal_y * inv_z;
      const float de = -v.focal_y * tyz * inv_z * inv_z;
      float m0[3], m1[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        m0[k] = al * W[k] + be * W[8 + k];
        m1[k] = ga * W[4 + k] + de * W[8 + k];
      }

      const float q[4] = {s_rot[5 * t], s_rot[5 * t + 1], s_rot[5 * t + 2],
                          s_rot[5 * t + 3]};
      const float norm = sqrtf(sum4(q[0] * q[0], q[1] * q[1], q[2] * q[2],
                                    q[3] * q[3]));
      const float nrm = clamp_min(norm, kEps12);
      float qn[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) qn[k] = q[k] / nrm;
      const float n2 = sqrtf(sum4(qn[0] * qn[0], qn[1] * qn[1],
                                  qn[2] * qn[2], qn[3] * qn[3]) + kEps12);
      const float r = qn[0] / n2, x = qn[1] / n2, y = qn[2] / n2,
                  z = qn[3] / n2;
      const float R[3][3] = {
          {1.0f - 2.0f * (y * y + z * z), 2.0f * (x * y - r * z),
           2.0f * (x * z + r * y)},
          {2.0f * (x * y + r * z), 1.0f - 2.0f * (x * x + z * z),
           2.0f * (y * z - r * x)},
          {2.0f * (x * z - r * y), 2.0f * (y * z + r * x),
           1.0f - 2.0f * (x * x + y * y)}};

      float ls[3], ex[3], s[3], A[3], B[3], u[3], w[3];
      float a = 0.0f, b = 0.0f, c = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        ls[k] = s_scale[3 * t + k];
        ex[k] = expf(isnan(ls[k]) ? ls[k] : fminf(ls[k], kScaleMax));
        s[k] = ex[k] * v.modifier;
        A[k] = m0[0] * R[0][k] + m0[1] * R[1][k] + m0[2] * R[2][k];
        B[k] = m1[0] * R[0][k] + m1[1] * R[1][k] + m1[2] * R[2][k];
        u[k] = s[k] * A[k];
        w[k] = s[k] * B[k];
        a = a + u[k] * u[k];
        b = b + u[k] * w[k];
        c = c + w[k] * w[k];
      }
      a = a + kLowPass;
      c = c + kLowPass;
      const float inv_det = 1.0f / (a * c - b * b);   // positive: visible
      const float op = 1.0f / (1.0f + expf(-opacity[i]));

      // ---- The colour: clamp(min=0), the SH basis, the direction. ----
      float dx = 0.0f, dy = 0.0f, dz = 0.0f, ex0 = 0.0f, ey0 = 0.0f,
            ez0 = 0.0f, sq = 0.0f, inv_n = 0.0f;
      if constexpr (kDeg > 0) {
        ex0 = px - C[0];
        ey0 = py - C[1];
        ez0 = pz - C[2];
        sq = ex0 * ex0 + ey0 * ey0 + ez0 * ez0;
        inv_n = rsqrtf(clamp_min(sq, kEps24));
        dx = ex0 * inv_n;
        dy = ey0 * inv_n;
        dz = ez0 * inv_n;
      }
      const float xx = dx * dx, yy = dy * dy, zz = dz * dz;
      const float xy = dx * dy, yz = dy * dz, xz = dx * dz;
      float g_rgb[3];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        // K6's sum, for the side of the cut at 0.
        float res = kC0 * s_dc[3 * t + ch];
        if constexpr (kDeg > 0) {
          res = res - kC1 * dy * sh[ch];
          res = res + kC1 * dz * sh[3 + ch];
          res = res - kC1 * dx * sh[6 + ch];
        }
        if constexpr (kDeg > 1) {
          res = res + kC2_0 * xy * sh[9 + ch];
          res = res + kC2_1 * yz * sh[12 + ch];
          res = res + kC2_2 * (2.0f * zz - xx - yy) * sh[15 + ch];
          res = res + kC2_3 * xz * sh[18 + ch];
          res = res + kC2_4 * (xx - yy) * sh[21 + ch];
        }
        if constexpr (kDeg > 2) {
          res = res + kC3_0 * dy * (3.0f * xx - yy) * sh[24 + ch];
          res = res + kC3_1 * xy * dz * sh[27 + ch];
          res = res + kC3_2 * dy * (4.0f * zz - xx - yy) * sh[30 + ch];
          res = res + kC3_3 * dz * (2.0f * zz - 3.0f * xx - 3.0f * yy)
                          * sh[33 + ch];
          res = res + kC3_4 * dx * (4.0f * zz - xx - yy) * sh[36 + ch];
          res = res + kC3_5 * dz * (xx - yy) * sh[39 + ch];
          res = res + kC3_6 * dx * (xx - 3.0f * yy) * sh[42 + ch];
        }
        g_rgb[ch] = res + 0.5f >= 0.0f ? g.color.at(i, ch) : 0.0f;
        s_dc[3 * t + ch] = kC0 * g_rgb[ch];
      }
      float gp[3] = {0.0f, 0.0f, 0.0f};
      if constexpr (kDeg > 0) {
        float gd[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int k = 1; k < kCoefs; ++k) {
          float bk, bx, by, bz;
          sh_term(k, dx, dy, dz, bk, bx, by, bz);
          float* coef = sh + 3 * (k - 1);
          const float ws = g_rgb[0] * coef[0] + g_rgb[1] * coef[1]
                           + g_rgb[2] * coef[2];
          gd[0] = gd[0] + ws * bx;
          gd[1] = gd[1] + ws * by;
          gd[2] = gd[2] + ws * bz;
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) coef[ch] = bk * g_rgb[ch];
        }
        // dirs = e * rsqrt(max(|e|^2, 1e-24)), e = xyz - campos.
        const float g_inv_n = gd[0] * ex0 + gd[1] * ey0 + gd[2] * ez0;
        const float g_sq = sq >= kEps24
                               ? -0.5f * g_inv_n * inv_n * inv_n * inv_n
                               : 0.0f;
        gp[0] = gd[0] * inv_n + 2.0f * ex0 * g_sq;
        gp[1] = gd[1] * inv_n + 2.0f * ey0 * g_sq;
        gp[2] = gd[2] * inv_n + 2.0f * ez0 * g_sq;
      }

      // ---- means2d (and the offset), then the clip transform. ----
      const float g_mx = g.means2d.at(i, 0), g_my = g.means2d.at(i, 1);
      if (out.offset)
        reinterpret_cast<float2*>(out.offset)[i] = make_float2(g_mx, g_my);
      const float g_ph0 = g_mx * (0.5f * v.width) * inv_w;
      const float g_ph1 = g_my * (0.5f * v.height) * inv_w;
      const float g_inv_w = 0.5f * (g_mx * v.width * ph0
                                    + g_my * v.height * ph1);
      const float g_pw = -g_inv_w * inv_w * inv_w;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        gp[k] = gp[k] + F[k] * g_ph0 + F[4 + k] * g_ph1 + F[12 + k] * g_pw;

      // ---- The conic, then the EWA covariance. ----
      const float g_c1 = g.conic.at(i, 0), g_c2 = g.conic.at(i, 1),
                  g_c3 = g.conic.at(i, 2);
      const float g_det = -(c * g_c1 - b * g_c2 + a * g_c3) * inv_det
                          * inv_det;
      const float g_a = inv_det * g_c3 + c * g_det;
      const float g_b = -inv_det * g_c2 - 2.0f * b * g_det;
      const float g_c = inv_det * g_c1 + a * g_det;
      float g_m0[3] = {0.0f, 0.0f, 0.0f}, g_m1[3] = {0.0f, 0.0f, 0.0f};
      float g_R[3][3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float g_u = 2.0f * u[k] * g_a + w[k] * g_b;
        const float g_w = u[k] * g_b + 2.0f * w[k] * g_c;
        const float g_s = g_u * A[k] + g_w * B[k];
        const float g_A = g_u * s[k], g_B = g_w * s[k];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          g_m0[j] = g_m0[j] + g_A * R[j][k];
          g_m1[j] = g_m1[j] + g_B * R[j][k];
          g_R[j][k] = g_A * m0[j] + g_B * m1[j];
        }
        // exp(minimum(scaling, 20)) times the modifier.
        const float tie = ls[k] < kScaleMax ? 1.0f
                          : ls[k] == kScaleMax ? 0.5f
                          : isnan(ls[k]) ? 1.0f : 0.0f;
        s_scale[3 * t + k] = g_s * v.modifier * ex[k] * tie;
      }
      const float g_al = g_m0[0] * W[0] + g_m0[1] * W[1] + g_m0[2] * W[2];
      const float g_be = g_m0[0] * W[8] + g_m0[1] * W[9] + g_m0[2] * W[10];
      const float g_ga = g_m1[0] * W[4] + g_m1[1] * W[5] + g_m1[2] * W[6];
      const float g_de = g_m1[0] * W[8] + g_m1[1] * W[9] + g_m1[2] * W[10];
      const float g_txz = -v.focal_x * inv_z * inv_z * g_be;
      const float g_tyz = -v.focal_y * inv_z * inv_z * g_de;
      const float g_xr = (xr >= -v.lim_x && xr <= v.lim_x) ? g_txz * tz
                                                           : 0.0f;
      const float g_yr = (yr >= -v.lim_y && yr <= v.lim_y) ? g_tyz * tz
                                                           : 0.0f;
      const float g_inv_z = v.focal_x * g_al + v.focal_y * g_ga
                            - 2.0f * v.focal_x * txz * inv_z * g_be
                            - 2.0f * v.focal_y * tyz * inv_z * g_de
                            + g_xr * tx + g_yr * ty;
      const float g_tx = g_xr * inv_z, g_ty = g_yr * inv_z;
      const float g_tz = g.depth.at(i, 0) + cx * g_txz + cy * g_tyz
                         - g_inv_z * inv_z * inv_z;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        s_xyz[3 * t + k] = gp[k] + W[k] * g_tx + W[4 + k] * g_ty
                           + W[8 + k] * g_tz;

      // ---- The rotation and its two normalisations. ----
      const float g_qr[4] = {
          2.0f * (-z * g_R[0][1] + y * g_R[0][2] + z * g_R[1][0]
                  - x * g_R[1][2] - y * g_R[2][0] + x * g_R[2][1]),
          2.0f * (y * g_R[0][1] + z * g_R[0][2] + y * g_R[1][0]
                  - 2.0f * x * g_R[1][1] - r * g_R[1][2] + z * g_R[2][0]
                  + r * g_R[2][1] - 2.0f * x * g_R[2][2]),
          2.0f * (-2.0f * y * g_R[0][0] + x * g_R[0][1] + r * g_R[0][2]
                  + x * g_R[1][0] + z * g_R[1][2] - r * g_R[2][0]
                  + z * g_R[2][1] - 2.0f * y * g_R[2][2]),
          2.0f * (-2.0f * z * g_R[0][0] - r * g_R[0][1] + x * g_R[0][2]
                  + r * g_R[1][0] - 2.0f * z * g_R[1][1] + y * g_R[1][2]
                  + x * g_R[2][0] + y * g_R[2][1])};
      const float qr[4] = {r, x, y, z};
      const float dot2 = g_qr[0] * qr[0] + g_qr[1] * qr[1] + g_qr[2] * qr[2]
                         + g_qr[3] * qr[3];
      float g_qn[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) g_qn[k] = (g_qr[k] - qr[k] * dot2) / n2;
      const float dot1 = g_qn[0] * q[0] + g_qn[1] * q[1] + g_qn[2] * q[2]
                         + g_qn[3] * q[3];
      // The clamp passes the norm's gradient where norm >= 1e-12; a zero
      // quaternion gets 0 / 0 from sqrt's backward, as under autograd.
      const float g_norm = norm >= kEps12 ? -dot1 / (nrm * nrm) : 0.0f;
      const float g_ss = g_norm / norm;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        s_rot[5 * t + k] = g_qn[k] / nrm + q[k] * g_ss;

      out.opacity[i] = g.opacity.at(i, 0) * (1.0f - op) * op;
    }
  }
  __syncthreads();
  unstage<3, 3>(out.xyz, s_xyz, r0, rows, 3);
  unstage<3, 3>(out.dc, s_dc, r0, rows, 3);
  unstage<3, 3>(out.scaling, s_scale, r0, rows, 3);
  unstage<4, 5>(out.rotation, s_rot, r0, rows, 4);
  if (rest_stride > 0)
    unstage<kRest, kRestPitch>(out.rest, s_rest, r0, rows, rest_stride);
}

}  // namespace

// n splat rows; the SH rest holds rest_stride / 3 coefficients a row, of
// which degree sh_degree (0-3) reads the first (sh_degree + 1)^2 - 1 (the
// others get 0). Each cotangent (or NULL) with its rows' stride in
// floats; offset_grad NULL where the projection took no offset.
extern "C" int mvi_project_bwd(
    const void* xyz, const void* dc, const void* rest, const void* opacity,
    const void* scaling, const void* rotation, const void* radius,
    const void* world_view, const void* full_proj, const void* campos,
    int n, int rest_stride, int sh_degree, float width, float height,
    float focal_x, float focal_y, float lim_x, float lim_y, float modifier,
    const void* g_means2d, long long s_means2d, const void* g_conic,
    long long s_conic, const void* g_depth, long long s_depth,
    const void* g_color, long long s_color, const void* g_opacity,
    long long s_opacity, void* xyz_grad, void* dc_grad, void* rest_grad,
    void* opacity_grad, void* scaling_grad, void* rotation_grad,
    void* offset_grad, void* stream) {
  if (n <= 0) return 0;
  if (sh_degree < 0 || sh_degree > 3
      || rest_stride < 3 * ((sh_degree + 1) * (sh_degree + 1) - 1))
    return (int)cudaErrorInvalidValue;
  const View v{width, height, focal_x, focal_y, lim_x, lim_y, modifier};
  const Cotangents g{{(const float*)g_means2d, s_means2d},
                     {(const float*)g_conic, s_conic},
                     {(const float*)g_depth, s_depth},
                     {(const float*)g_color, s_color},
                     {(const float*)g_opacity, s_opacity}};
  const Grads out{(float*)xyz_grad, (float*)dc_grad, (float*)rest_grad,
                  (float*)opacity_grad, (float*)scaling_grad,
                  (float*)rotation_grad, (float*)offset_grad};
  const unsigned grid = (unsigned)((n + kRows - 1) / kRows);
  const cudaStream_t s = (cudaStream_t)stream;
#define MVI_PROJECT_BWD(DEG)                                               \
  project_bwd_kernel<DEG><<<grid, kRows, 0, s>>>(                          \
      (const float*)xyz, (const float*)dc, (const float*)rest,             \
      (const float*)opacity, (const float*)scaling, (const float*)rotation, \
      (const int*)radius, (const float*)world_view,                        \
      (const float*)full_proj, (const float*)campos, n, rest_stride, v, g, \
      out)
  switch (sh_degree) {
    case 0: MVI_PROJECT_BWD(0); break;
    case 1: MVI_PROJECT_BWD(1); break;
    case 2: MVI_PROJECT_BWD(2); break;
    default: MVI_PROJECT_BWD(3); break;
  }
#undef MVI_PROJECT_BWD
  return (int)cudaGetLastError();
}
