// K3: the backward of the composite kernel (K2), for Hopper (sm_90a).
//
// Replaces the TPU kernel
// multiview_inpaint_tpu/ops/rasterizer/pallas_backward.py `_bwd_kernel`
// (via `composite_pallas_bwd`).
//
// What it computes: for each tile, from K2's raw output rows (rgb and
// depth accumulators, final T) and their cotangent g, the gradient of
// every pair of the tile's segment, with the reference's identity
// (pallas_backward.py:8-16), per pixel and per contributing splat i:
//   A_i = g_rgb . c_i + g_d d_i
//   S_i = TotalContrib - Prefix_i,  TotalContrib = g . acc (forward rows)
//   dL/dalpha_i = T_i A_i - (S_i + T_fin g_T) / (1 - alpha_i)
// then through alpha = min(0.99, op * exp(power)) to opacity and power,
// and through power = -0.5 (a dx^2 + c dy^2) - b dx dy to the mean and
// conic; d rgb and d depth are w g. The pixel sums give pair rows 0-1
// d mean, 2-4 d conic, 5 d opacity, 6-8 d rgb, 9 d depth; rows 10-15 are
// 0 (row 10 is the alpha gate, a comparison without gradient).
//
// What bounds it on the H100: operations. Every pair-pixel runs K2's gate
// path (~15 FP32 ops and an expf); a contributing one adds log1pf, two
// expf, a division and ~40 FP32 ops, and each splat's ten sums are reduced
// over the tile's pixels. Bytes are 64 per pair in and out plus 64 per
// pixel of forward rows and cotangent.
//
// What the design does about it: one block per tile and one thread per
// pixel (<= 256, whole warps), as K2. The walk is K2's, forward order in
// 128-splat chunks anchored at the segment start, with the same gate,
// alpha, log1p and stop decisions taken from composite_common.cuh; T, the
// in-chunk log prefix and the prefix of w.A live in registers, and the
// suffix is TotalContrib minus that prefix, so one forward pass suffices.
// The mean terms are summed directly per pixel (d power / d mx = a dx + b
// dy, d power / d my = c dy + b dx): the TPU kernel's moment-basis matmul
// was a workaround for its matrix unit. Per splat, each warp reduces its
// ten values with shuffles (skipped when no lane of the warp contributes)
// into shared memory; at the end of the chunk one thread per splat adds
// the warp partials in warp order and writes the pair's row. The order of
// every sum is fixed, so the kernel repeats bit for bit. Each pair belongs
// to one tile, so the rows are written without atomics; the TPU kernel's
// 128-aligned window merge and cross-step carry have no counterpart. The
// reduction of pairs to gaussians stays outside (the gather's backward).

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using mvi::kChunk;
using mvi::kOutRows;
using mvi::kRows;

constexpr int kGradRows = 10;   // rows 0-9 of a pair's gradient
constexpr int kStage = 12;      // staged floats per splat (rows 0-10 used)
constexpr int kMaxWarps = 8;    // 256 threads

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(256)
composite_bwd_kernel(const float* __restrict__ attrs,
                     const long long* __restrict__ seg_start,
                     const long long* __restrict__ counts,
                     const float* __restrict__ fwd,
                     const float* __restrict__ grad,
                     float* __restrict__ d_attrs, int tiles_x, int tile_w,
                     int tile_h) {
  __shared__ float s_attr[kChunk * kStage];
  // Per-warp partial sums: [splat][row][warp].
  __shared__ float s_part[kChunk * kGradRows * kMaxWarps];

  const int tile = blockIdx.x;
  const long long count = counts[tile];
  if (count == 0) return;  // the tile owns no pair
  const long long start = seg_start[tile];
  const int pix = tile_w * tile_h;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int n_warps = blockDim.x >> 5;
  const float px = (float)((tile % tiles_x) * tile_w + t % tile_w);
  const float py = (float)((tile / tiles_x) * tile_h + t / tile_w);

  const float* f = fwd + (long long)tile * kOutRows * pix + t;
  const float* gp = grad + (long long)tile * kOutRows * pix + t;
  const float g0 = gp[0], g1 = gp[pix], g2 = gp[2 * pix], g3 = gp[3 * pix];
  const float total = g0 * f[0] + g1 * f[pix] + g2 * f[2 * pix]
                      + g3 * f[3 * pix];
  const float b_term = f[4 * pix] * gp[4 * pix];  // T_fin g_T

  float trans = 1.0f;
  float prefix = 0.0f;  // sum of w.A over the splats walked so far

  for (long long c0 = 0; c0 < count; c0 += kChunk) {
    const long long left = count - c0;
    const int n = left < kChunk ? (int)left : kChunk;
    const float* src = attrs + (start + c0) * kRows;
    __syncthreads();  // the previous chunk's rows are written
    for (int i = t; i < n * kRows; i += blockDim.x) {
      const int r = i % kRows;
      if (r < kStage) s_attr[(i / kRows) * kStage + r] = src[i];
    }
    __syncthreads();

    float cum = 0.0f;      // inclusive prefix of this chunk's logs
    float contrib = 0.0f;  // sum of the contributing logs
    bool walking = true;   // false once the pixel stopped in this chunk
    for (int j = 0; j < n; ++j) {
      const float* a = s_attr + j * kStage;
      float v[kGradRows];
#pragma unroll
      for (int r = 0; r < kGradRows; ++r) v[r] = 0.0f;
      bool any = false;
      float dx, dy, ex, alpha_raw, alpha, l, t_in;
      if (walking && mvi::eval_splat(a, px, py, dx, dy, ex, alpha_raw,
                                     alpha)) {
        if (!mvi::transmit(trans, alpha, cum, l, t_in)) {
          walking = false;
        } else {
          const float w = alpha * t_in;
          const float big_a = g0 * a[6] + g1 * a[7] + g2 * a[8] + g3 * a[9];
          prefix += w * big_a;
          const float suffix = total - prefix;
          const float d_alpha = t_in * big_a - (suffix + b_term)
                                / (1.0f - alpha);
          const float d_raw = alpha_raw < mvi::kAlphaMax ? d_alpha : 0.0f;
          const float d_power = d_raw * alpha_raw;
          v[0] = d_power * (a[2] * dx + a[3] * dy);
          v[1] = d_power * (a[4] * dy + a[3] * dx);
          v[2] = -0.5f * d_power * dx * dx;
          v[3] = -d_power * dx * dy;
          v[4] = -0.5f * d_power * dy * dy;
          v[5] = d_raw * ex;
          v[6] = w * g0;
          v[7] = w * g1;
          v[8] = w * g2;
          v[9] = w * g3;
          contrib = __fadd_rn(contrib, l);
          any = true;
        }
      }
      float* part = s_part + j * kGradRows * kMaxWarps + warp;
      if (__any_sync(0xffffffffu, any)) {
#pragma unroll
        for (int r = 0; r < kGradRows; ++r) {
          const float s = warp_sum(v[r]);
          if (lane == 0) part[r * kMaxWarps] = s;
        }
      } else if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kGradRows; ++r) part[r * kMaxWarps] = 0.0f;
      }
    }
    trans = __fmul_rn(trans, expf(contrib));
    __syncthreads();  // every warp's partials are in shared memory

    for (int j = t; j < n; j += blockDim.x) {
      const float* part = s_part + j * kGradRows * kMaxWarps;
      float row[kRows];
#pragma unroll
      for (int r = 0; r < kGradRows; ++r) {
        float s = 0.0f;
        for (int wi = 0; wi < n_warps; ++wi) s += part[r * kMaxWarps + wi];
        row[r] = s;
      }
#pragma unroll
      for (int r = kGradRows; r < kRows; ++r) row[r] = 0.0f;
      float4* o = reinterpret_cast<float4*>(d_attrs
                                            + (start + c0 + j) * kRows);
#pragma unroll
      for (int q = 0; q < kRows / 4; ++q)
        o[q] = make_float4(row[4 * q], row[4 * q + 1], row[4 * q + 2],
                           row[4 * q + 3]);
    }
  }
}

}  // namespace

extern "C" int mvi_composite_bwd(const void* attrs, const void* seg_start,
                                 const void* counts, const void* fwd,
                                 const void* grad, void* d_attrs,
                                 int num_tiles, int tiles_x, int tile_w,
                                 int tile_h, void* stream) {
  if (num_tiles > 0) {
    composite_bwd_kernel<<<num_tiles, tile_w * tile_h, 0,
                           (cudaStream_t)stream>>>(
        (const float*)attrs, (const long long*)seg_start,
        (const long long*)counts, (const float*)fwd, (const float*)grad,
        (float*)d_attrs, tiles_x, tile_w, tile_h);
  }
  return (int)cudaGetLastError();
}
