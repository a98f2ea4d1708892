// K6: the gradient-free splat projection for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package projects in jnp that XLA fuses
// (multiview_inpaint_tpu/ops/rasterizer/geometry.py `project_gaussians`);
// the port's plain path, GaussianParams' activations followed by
// ops/rasterizer/geometry.py `project_gaussians` and utils/sh.py
// `eval_sh`, is some 300 eager PyTorch launches over the rows, a
// concatenation of the SH stack and a blocking copy of the scale clamp's
// bound to the card. This kernel does the whole projection of one camera
// in one launch that the host never waits for; the wrapper
// (ops/rasterizer/project_cuda.py) takes it when no gradient is needed.
//
// What it computes, per splat row: sigmoid(opacity), exp(min(scaling,
// 20)) times the scaling modifier, and the quaternion normalised as
// act_rotation and then project_gaussians normalise it; the view and clip
// transforms, the EWA 2D covariance with the 1.3 tan-fov clamp, the
// conic, the radius and the opacity-aware extent; the frustum,
// determinant, live and non-finite culls; and the SH colour at degrees
// 0-3 from features_dc and features_rest. It writes the fields of
// ProjectedGaussians.
//
// Rounding: each operation is the one a PyTorch op of the plain path
// performs, in the plain path's order, rounded to float32 as that op
// rounds it. This source is built with -fmad=false, so no multiply and
// add fuse; the calls are those of PyTorch's elementwise kernels (expf,
// logf, sqrtf, rsqrtf, ceilf, IEEE division); a Python scalar is its
// double rounded once to float32; the quaternion's sum of squares adds
// in the order of PyTorch's reduction over a row of four. radius, extent
// and the visibility decide the pair lists, so they have to match the
// plain path exactly.
//
// What bounds it on the H100: bytes. At SH degree 3 a splat reads xyz 12
// B, SH 192, opacity 4, scale 12, rotation 16 and live 1 and writes 52
// (means2d 8, conic 12, depth 4, radius 4, colour 12, opacity 4, extent
// 8): ~289 B, 0.17 ms for 2M splats at 3.35 TB/s. Its few hundred FP32
// operations a splat are far under the card's rate.
//
// What the design does about it: one thread per splat, kRows splats a
// block. The block copies its rows of every input array into shared
// memory first, consecutive threads on consecutive 16-byte words (where
// the rows are packed and aligned; floats otherwise), so that every load
// is coalesced whatever the row width (xyz 3 floats, the SH rest 45);
// each thread then reads its own row there at an odd pitch, free of bank
// conflicts. Conic and colour, 12 bytes a row, go back through shared
// memory and leave as contiguous runs; the other outputs are 4- and
// 8-byte stores of consecutive rows. The camera's matrices stay on the
// device and are read once a block.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;   // splats (threads) per block

// Python scalars of the plain path, rounded from double as PyTorch
// rounds a scalar against a float32 tensor.
constexpr float kNear = (float)0.2;          // frustum cull at z <= 0.2
constexpr float kEps7 = (float)1e-7;         // 1 / (w + 1e-7)
constexpr float kEps12 = (float)1e-12;       // quaternion norms
constexpr float kEps24 = (float)1e-24;       // view direction norm
constexpr float kLowPass = (float)0.3;       // EWA low-pass
constexpr float kLamFloor = (float)0.1;      // eigenvalue discriminant
constexpr float kScaleMax = (float)20.0;     // act_scaling's bound
constexpr float kAlphaMin = (float)255.0;    // alpha >= 1/255
constexpr float kSigmaMax = (float)3.0;      // the 3-sigma outer bound

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
  float radius_max;         // 4 (width + height)
};

struct Outputs {
  float* means2d;   // [N, 2]
  float* conic;     // [N, 3]
  float* depth;     // [N]
  int* radius;      // [N]
  float* color;     // [N, 3]
  float* opacity;   // [N]
  float* extent;    // [N, 2]
};

// torch.clamp(v, min=lo), clamp(max=hi), minimum(v, hi): NaN passes.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// torch.sum over a contiguous row of four: the reduction kernel gives
// each element to one of four lanes and adds them by shuffles at
// decreasing offsets, 2 then 1.
__device__ __forceinline__ float sum4(float a, float b, float c, float d) {
  return (a + c) + (b + d);
}

// Float i of a block's run of rows into dst at kPitch floats a row.
template <int kWidth, int kPitch>
__device__ __forceinline__ void put(float* dst, int i, float x) {
  const int row = i / kWidth;
  dst[row * kPitch + i - row * kWidth] = x;
}

// Rows [r0, r0 + rows) of a [N, kWidth] array whose rows lie `stride`
// floats apart into dst (16-byte aligned) at kPitch floats a row. Where
// the rows are packed and the block's run is 16-byte aligned, by 16-byte
// loads (and stores, where the pitch is the width).
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

template <int kDeg>
__global__ void __launch_bounds__(kRows)
project_kernel(const float* __restrict__ xyz, const float* __restrict__ dc,
               const float* __restrict__ rest,
               const float* __restrict__ opacity,
               const float* __restrict__ scaling,
               const float* __restrict__ rotation,
               const unsigned char* __restrict__ live,
               const float* __restrict__ world_view,
               const float* __restrict__ full_proj,
               const float* __restrict__ campos, int n, int rest_stride,
               View v, Outputs out) {
  constexpr int kRest = ((kDeg + 1) * (kDeg + 1) - 1) * 3;
  constexpr int kRestPitch = kRest | 1;   // odd: conflict-free rows
  __shared__ float s_cam[35];   // world_view, full_proj, campos
  __shared__ __align__(16) float s_xyz[kRows * 3];
  __shared__ __align__(16) float s_dc[kRows * 3];
  __shared__ __align__(16) float s_scale[kRows * 3];
  __shared__ __align__(16) float s_rot[kRows * 5];
  __shared__ __align__(16) float s_rest[kRows * kRestPitch];
  __shared__ __align__(16) float s_conic[kRows * 3];
  __shared__ __align__(16) float s_color[kRows * 3];

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
    const float* W = s_cam;
    const float* F = s_cam + 16;
    const float* C = s_cam + 32;
    const float px = s_xyz[3 * t], py = s_xyz[3 * t + 1],
                pz = s_xyz[3 * t + 2];

    const float tx = px * W[0] + py * W[1] + pz * W[2] + W[3];
    const float ty = px * W[4] + py * W[5] + pz * W[6] + W[7];
    const float tz = px * W[8] + py * W[9] + pz * W[10] + W[11];
    const bool in_front = tz > kNear;

    // Clip space -> pixel centres.
    const float ph0 = px * F[0] + py * F[1] + pz * F[2] + F[3];
    const float ph1 = px * F[4] + py * F[5] + pz * F[6] + F[7];
    const float pw = px * F[12] + py * F[13] + pz * F[14] + F[15];
    const float inv_w = 1.0f / (pw + kEps7);
    const float mx = ((ph0 * inv_w + 1.0f) * v.width - 1.0f) * 0.5f;
    const float my = ((ph1 * inv_w + 1.0f) * v.height - 1.0f) * 0.5f;

    // EWA: M = J W, J the perspective Jacobian at the clamped centre.
    const float inv_z = 1.0f / tz;
    const float txz = clamp(tx * inv_z, -v.lim_x, v.lim_x) * tz;
    const float tyz = clamp(ty * inv_z, -v.lim_y, v.lim_y) * tz;
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

    // act_rotation, then project_gaussians' own normalisation.
    float q0 = s_rot[5 * t], q1 = s_rot[5 * t + 1], q2 = s_rot[5 * t + 2],
          q3 = s_rot[5 * t + 3];
    const float nrm = clamp_min(
        sqrtf(sum4(q0 * q0, q1 * q1, q2 * q2, q3 * q3)), kEps12);
    q0 = q0 / nrm;
    q1 = q1 / nrm;
    q2 = q2 / nrm;
    q3 = q3 / nrm;
    const float nrm2 = sqrtf(sum4(q0 * q0, q1 * q1, q2 * q2, q3 * q3)
                             + kEps12);
    const float r = q0 / nrm2, x = q1 / nrm2, y = q2 / nrm2, z = q3 / nrm2;
    const float R[3][3] = {
        {1.0f - 2.0f * (y * y + z * z), 2.0f * (x * y - r * z),
         2.0f * (x * z + r * y)},
        {2.0f * (x * y + r * z), 1.0f - 2.0f * (x * x + z * z),
         2.0f * (y * z - r * x)},
        {2.0f * (x * z - r * y), 2.0f * (y * z + r * x),
         1.0f - 2.0f * (x * x + y * y)}};

    float a = 0.0f, b = 0.0f, c = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float ls = s_scale[3 * t + k];
      const float lsc = isnan(ls) ? ls : fminf(ls, kScaleMax);
      const float s = expf(lsc) * v.modifier;
      const float u = s * (m0[0] * R[0][k] + m0[1] * R[1][k]
                           + m0[2] * R[2][k]);
      const float w = s * (m1[0] * R[0][k] + m1[1] * R[1][k]
                           + m1[2] * R[2][k]);
      a = a + u * u;
      b = b + u * w;
      c = c + w * w;
    }
    a = a + kLowPass;
    c = c + kLowPass;

    const float det = a * c - b * b;
    const bool det_ok = det > 0.0f;
    const float inv_det = det_ok ? 1.0f / det : 0.0f;
    s_conic[3 * t] = c * inv_det;
    s_conic[3 * t + 1] = -b * inv_det;
    s_conic[3 * t + 2] = a * inv_det;

    const float mid = 0.5f * (a + c);
    const float lam1 = mid + sqrtf(clamp_min(mid * mid - det, kLamFloor));
    const float radius_f = clamp_max(
        ceilf(3.0f * sqrtf(clamp_min(lam1, 0.0f))), v.radius_max);

    // The non-finite quarantine and the culls.
    const bool visible = in_front && det_ok && live[i] != 0
                         && isfinite(det) && isfinite(mx) && isfinite(my)
                         && isfinite(tz);
    reinterpret_cast<float2*>(out.means2d)[i] =
        visible ? make_float2(mx, my) : make_float2(0.0f, 0.0f);
    out.radius[i] = visible ? (int)radius_f : 0;
    out.depth[i] = tz;

    // Opacity and its sigma cutoff k = min(sqrt(2 ln(255 op)), 3).
    const float op = 1.0f / (1.0f + expf(-opacity[i]));
    out.opacity[i] = visible ? op : 0.0f;
    const float ks = clamp_max(
        sqrtf(2.0f * clamp_min(logf(kAlphaMin * clamp_min(op, kEps12)),
                               0.0f)), kSigmaMax);
    reinterpret_cast<float2*>(out.extent)[i] =
        visible ? make_float2(ceilf(ks * sqrtf(clamp_min(a, 0.0f))),
                              ceilf(ks * sqrtf(clamp_min(c, 0.0f))))
                : make_float2(0.0f, 0.0f);

    // SH -> RGB along the campos -> splat direction.
    float dx = 0.0f, dy = 0.0f, dz = 0.0f;
    if constexpr (kDeg > 0) {
      const float ex = px - C[0], ey = py - C[1], ez = pz - C[2];
      const float inv_n = rsqrtf(clamp_min(ex * ex + ey * ey + ez * ez,
                                           kEps24));
      dx = ex * inv_n;
      dy = ey * inv_n;
      dz = ez * inv_n;
    }
    const float xx = dx * dx, yy = dy * dy, zz = dz * dz;
    const float xy = dx * dy, yz = dy * dz, xz = dx * dz;
    const float* sh = s_rest + t * kRestPitch;   // coefficient k at 3(k-1)
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
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
      s_color[3 * t + ch] = clamp_min(res + 0.5f, 0.0f);
    }
  }
  __syncthreads();
  if (rows == kRows) {   // 16-byte runs: r0 * 12 bytes is a multiple of 16
    float4* conic4 = reinterpret_cast<float4*>(out.conic + r0 * 3);
    float4* color4 = reinterpret_cast<float4*>(out.color + r0 * 3);
    for (int j = t; j < kRows * 3 / 4; j += kRows) {
      conic4[j] = reinterpret_cast<const float4*>(s_conic)[j];
      color4[j] = reinterpret_cast<const float4*>(s_color)[j];
    }
  } else {
    for (int j = t; j < rows * 3; j += kRows) {
      out.conic[r0 * 3 + j] = s_conic[j];
      out.color[r0 * 3 + j] = s_color[j];
    }
  }
}

}  // namespace

// n splat rows; the SH rest holds rest_stride / 3 coefficients a row, of
// which degree sh_degree (0-3) reads the first (sh_degree + 1)^2 - 1.
extern "C" int mvi_project(
    const void* xyz, const void* dc, const void* rest, const void* opacity,
    const void* scaling, const void* rotation, const void* live,
    const void* world_view, const void* full_proj, const void* campos,
    int n, int rest_stride, int sh_degree, float width, float height,
    float focal_x, float focal_y, float lim_x, float lim_y, float modifier,
    void* means2d, void* conic, void* depth, void* radius, void* color,
    void* opacity_out, void* extent, void* stream) {
  if (n <= 0) return 0;
  if (sh_degree < 0 || sh_degree > 3) return (int)cudaErrorInvalidValue;
  const View v{width, height, focal_x, focal_y, lim_x, lim_y, modifier,
               4.0f * (width + height)};
  const Outputs out{(float*)means2d, (float*)conic, (float*)depth,
                    (int*)radius, (float*)color, (float*)opacity_out,
                    (float*)extent};
  const unsigned grid = (unsigned)((n + kRows - 1) / kRows);
  const cudaStream_t s = (cudaStream_t)stream;
#define MVI_PROJECT(DEG)                                                   \
  project_kernel<DEG><<<grid, kRows, 0, s>>>(                              \
      (const float*)xyz, (const float*)dc, (const float*)rest,             \
      (const float*)opacity, (const float*)scaling, (const float*)rotation, \
      (const unsigned char*)live, (const float*)world_view,                \
      (const float*)full_proj, (const float*)campos, n, rest_stride, v, out)
  switch (sh_degree) {
    case 0: MVI_PROJECT(0); break;
    case 1: MVI_PROJECT(1); break;
    case 2: MVI_PROJECT(2); break;
    default: MVI_PROJECT(3); break;
  }
#undef MVI_PROJECT
  return (int)cudaGetLastError();
}
