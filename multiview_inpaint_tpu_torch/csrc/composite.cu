// K2: fused front-to-back compositing of every tile, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// multiview_inpaint_tpu/ops/rasterizer/pallas_composite.py `_kernel` (via
// `composite_pallas`, wrapped by `api._pallas_composite_diff`).
//
// What it computes: for each tile, the blend of its pair segment
// attrs[seg_start .. seg_start + count) (packed rows: mean xy, conic abc,
// opacity, rgb, depth, alpha gate; 16 floats per pair) over the tile's
// pixels, in 128-splat chunks anchored at the segment start, with the
// reference's chunk-scoped stop rule:
//   alpha = min(0.99, op * exp(power)), kept iff alpha >= gate, power <= 0
//   cum  += log1p(-alpha);  T_out = T * exp(cum);  T_in = T * exp(cum - l)
//   a splat with T_out < 1e-4 is skipped, and so is the rest of its chunk
//   (the later prefixes include its log); T *= exp(sum of the contributing
//   logs) at the end of the chunk, so the next chunk may contribute again.
// It writes raw rows per tile [8, PIX]: bg-free rgb and depth
// accumulators, the final T in row 4, zeros in rows 5-7. Empty tiles
// write (0,0,0,0,1,0,0,0). When the caller will run the backward (K3,
// composite_bwd.cu), it also stores the per-item state [items, 5, PIX]:
// at the first chunk of every work item (kItemChunks chunks of the
// tile's segment, numbered through `item_end`), the T carried into it
// and the four accumulators there, which K3 starts that item from. The
// T is the kernel's own __fmul_rn(trans, expf(contrib)) carry, the
// recurrence K3 walks, so an item starts from exactly the T that the
// walk from the tile's start reaches. Storing it changes no other
// output.
//
// What bounds it on the H100: operations. Every pair-pixel runs ~15 FP32
// ops and an expf (the gate path); the contributing ones add log1pf, two
// expf and the accumulation. At 1080p that is ~0.3-1.2 G pair-pixels per
// frame against 67 TFLOP/s FP32 and ~4.2 T/s of special-function
// throughput, while the bytes (64 per pair in, 32 per pixel out) are a
// few hundred MB.
//
// What the design does about it: one block per tile and one thread per
// pixel, so a pixel's transmittance, accumulators and in-chunk stop state
// live in registers; each chunk's attributes are staged once in shared
// memory by coalesced loads and read back as broadcasts. A pixel whose
// alpha is gated out skips everything after the gate test (its log is 0,
// so the prefix is unchanged), and a pixel that stops stops for the rest
// of its chunk. The prefix is a sequential sum per thread instead of the
// TPU's triangular-matmul cumsum. The float ops that decide a splat's fate
// (power, alpha, the gates, the stop) come from composite_common.cuh,
// which the backward kernel (K3) shares, with one rounding per operation
// as in the plain PyTorch version, so nvcc's FMA contraction cannot move a
// gate or stop decision off the plain version's or off K3's. The state
// adds 20 bytes per item and pixel (there are at most tiles + pairs /
// 1,024 items), written coalesced. Tensor cores, TMA and a block-level
// early exit are left to the work that makes it fast.

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using mvi::kChunk;
using mvi::kItemPairs;
using mvi::kOutRows;
using mvi::kRows;
using mvi::kStateRows;

__global__ void __launch_bounds__(256)
composite_kernel(const float* __restrict__ attrs,
                 const long long* __restrict__ seg_start,
                 const long long* __restrict__ counts,
                 const long long* __restrict__ item_end,
                 float* __restrict__ state, float* __restrict__ out,
                 int tiles_x, int tile_w, int tile_h) {
  __shared__ float s_attr[kChunk * kRows];

  const int tile = blockIdx.x;
  const int pix = tile_w * tile_h;
  const int t = threadIdx.x;
  // Integer pixel coordinates (no +0.5), as the reference.
  const float px = (float)((tile % tiles_x) * tile_w + t % tile_w);
  const float py = (float)((tile / tiles_x) * tile_h + t / tile_w);
  const long long start = seg_start[tile];
  const long long count = counts[tile];

  float trans = 1.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;
  // This pixel's state at the tile's first item (null without a state).
  float* st = nullptr;
  if (state != nullptr)
    st = state + (item_end[tile] - (count + kItemPairs - 1) / kItemPairs)
                     * kStateRows * pix + t;

  for (long long c0 = 0; c0 < count; c0 += kChunk) {
    if (st != nullptr && c0 % kItemPairs == 0) {
      float* s = st + (c0 / kItemPairs) * kStateRows * pix;
      s[0] = trans;
      s[pix] = acc_r;
      s[2 * pix] = acc_g;
      s[3 * pix] = acc_b;
      s[4 * pix] = acc_d;
    }
    const long long left = count - c0;
    const int n = left < kChunk ? (int)left : kChunk;
    const float* src = attrs + (start + c0) * kRows;
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = t; i < n * kRows; i += blockDim.x) s_attr[i] = src[i];
    __syncthreads();

    float cum = 0.0f;      // inclusive prefix of this chunk's logs
    float contrib = 0.0f;  // sum of the contributing logs
    for (int j = 0; j < n; ++j) {
      const float* a = s_attr + j * kRows;
      float dx, dy, ex, alpha_raw, alpha, l, t_in;
      if (!mvi::eval_splat(a, px, py, dx, dy, ex, alpha_raw, alpha))
        continue;  // log is 0
      if (!mvi::transmit(trans, alpha, cum, l, t_in))
        break;  // skipped, with the rest of the chunk
      const float wgt = __fmul_rn(alpha, t_in);
      acc_r = __fadd_rn(acc_r, __fmul_rn(wgt, a[6]));
      acc_g = __fadd_rn(acc_g, __fmul_rn(wgt, a[7]));
      acc_b = __fadd_rn(acc_b, __fmul_rn(wgt, a[8]));
      acc_d = __fadd_rn(acc_d, __fmul_rn(wgt, a[9]));
      contrib = __fadd_rn(contrib, l);
    }
    trans = __fmul_rn(trans, expf(contrib));
  }

  float* o = out + (long long)tile * kOutRows * pix + t;
  o[0 * pix] = acc_r;
  o[1 * pix] = acc_g;
  o[2 * pix] = acc_b;
  o[3 * pix] = acc_d;
  o[4 * pix] = trans;
  o[5 * pix] = 0.0f;
  o[6 * pix] = 0.0f;
  o[7 * pix] = 0.0f;
}

}  // namespace

// `item_end` and `state` are both null (no state) or both set.
extern "C" int mvi_composite(const void* attrs, const void* seg_start,
                             const void* counts, const void* item_end,
                             void* state, void* out, int num_tiles,
                             int tiles_x, int tile_w, int tile_h,
                             void* stream) {
  if (num_tiles > 0) {
    composite_kernel<<<num_tiles, tile_w * tile_h, 0,
                       (cudaStream_t)stream>>>(
        (const float*)attrs, (const long long*)seg_start,
        (const long long*)counts, (const long long*)item_end,
        (float*)state, (float*)out, tiles_x, tile_w, tile_h);
  }
  return (int)cudaGetLastError();
}
