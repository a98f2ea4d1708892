// K3: the backward of the composite kernel (K2), for Hopper (sm_90a).
//
// Replaces the TPU kernel
// multiview_inpaint_tpu/ops/rasterizer/pallas_backward.py:54 `_bwd_kernel`
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
// What bounds it on the H100: operations where many pair-pixels
// contribute, bytes where few do. Every walked pair-pixel runs K2's gate
// path (~15 FP32 ops and an expf); a kept one adds log1pf and the expf of
// the stop test, a contributing one a division and ~40 FP32 ops, and each
// splat's ten sums are reduced over the tile's pixels. Bytes are 64 per
// pair in and out plus 64 per pixel of forward rows and cotangent. What
// held the first design (one block per tile, ten warp_sum per splat) far
// from that bound: 50 shuffles per splat and warp, warps whose pixels had
// all stopped still walking to the end of every chunk, and deep tiles
// (31k pairs) walked in series by one block. What holds this one: where
// many pixels contribute, a warp runs the contribution math whenever any
// of its lanes is kept (about 9 of 32 on average at the orbit scene's
// first step), so the kernel is issue-bound at ~140 slots per warp and
// splat, not bound by the operations its lanes need.
//
// What the design does about it:
// - Work items. A block takes one item: kItemChunks chunks of one tile's
//   segment, numbered over the frame through `item_end` (a block finds
//   its tile by binary search; blocks past the last item exit, so the
//   grid is a bound the host knows without reading the counts). It
//   starts from K2's per-item state: the T carried into the item, which
//   is K2's own __fmul_rn(trans, expf(contrib)) carry and so exactly what
//   this walk would reach, and the prefix of w.A there, g . the
//   accumulators. Every item, the first of a tile included, takes that
//   one path. Deep tiles spread over many blocks.
// - One thread per pixel (<= 256, whole warps), as K2. The walk is K2's,
//   forward order in 128-splat chunks anchored at the segment start, with
//   the gate, alpha, log1p and stop decisions taken from
//   composite_common.cuh; T, the in-chunk log prefix and the prefix of
//   w.A live in registers, and the suffix is TotalContrib minus that
//   prefix, so one forward pass suffices. The mean terms are summed
//   directly per pixel (d power / d mx = a dx + b dy, d power / d my = c dy
//   + b dx): the TPU kernel's moment-basis matmul was a workaround for its
//   matrix unit.
// - Transposed warp reductions. A lane holds the ten row values of
//   kBatch consecutive splats and the warp reduce-scatters them by
//   recursive halving (31 shuffles for three splats, against 150 for ten
//   warp sums each); lane l ends with the warp sum of value l and stores
//   it to shared memory. A batch that no lane of the warp contributed to
//   stores zeros without shuffles.
// - Warp-level stop. A warp whose pixels have all stopped in the chunk
//   leaves it and records where; the combine reads its later partials as
//   0.
// - Fewer exponentials than K2's walk, the decisions unchanged: a splat
//   whose power is below kPowerGated is gated out before its expf, and a
//   kept splat's T_in is the previous kept splat's T_out (trans * exp of
//   the same prefix) instead of a second expf.
// - The combine uses every thread: each adds the partials of one row of
//   one splat in warp order and the block's stores are consecutive.
// The order of every sum is fixed, so the kernel repeats bit for bit.
// Each pair belongs to one item, so the rows are written without atomics;
// the TPU kernel's 128-aligned window merge and cross-step carry have no
// counterpart. The reduction of pairs to gaussians stays outside (the
// gather's backward). In band mode (pallas_backward.py:374) a tile of
// local row l sits at the frame's tile row row0 + l * stride, as in K2.

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using mvi::kChunk;
using mvi::kItemPairs;
using mvi::kOutRows;
using mvi::kRows;
using mvi::kStateRows;

constexpr int kGradRows = 10;   // rows 0-9 of a pair's gradient
constexpr int kStage = 12;      // staged floats per splat (rows 0-10 used)
constexpr int kMaxWarps = 8;    // 256 threads
// Splats whose row values a lane holds before one warp reduction, and the
// values per lane that reduction takes (10 per splat, padded to a power
// of two): 31 shuffles for three splats.
constexpr int kBatch = 3;
constexpr int kVals = kBatch * kGradRows <= 16 ? 16 : 32;
static_assert(kBatch * kGradRows <= 32, "one reduced value per lane");

// One halving step of the warp's reduce-scatter: each lane keeps the half
// of its H pairs of values that its lane bit H selects, sends the other
// half to lane ^ H and adds what that lane sent.
template <int H>
__device__ __forceinline__ void halve(float (&v)[kVals], int lane) {
  const bool upper = (lane & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

// The warp sums of kVals values held by every lane, scattered: lane l
// returns the sum over the warp of value l % kVals. Recursive halving
// (16 + 8 + 4 + 2 + 1 shuffles for 32 values), then for 16 values one
// butterfly step over the lane bit 16. The tree is fixed, so the sums
// repeat bit for bit.
__device__ __forceinline__ float reduce_scatter(float (&v)[kVals],
                                                int lane) {
  if constexpr (kVals == 32) halve<16>(v, lane);
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  if constexpr (kVals == 16)
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], 16);
  return v[0];
}

__global__ void __launch_bounds__(256)
composite_bwd_kernel(const float* __restrict__ attrs,
                     const long long* __restrict__ seg_start,
                     const long long* __restrict__ counts,
                     const long long* __restrict__ item_end,
                     const float* __restrict__ state,
                     const float* __restrict__ fwd,
                     const float* __restrict__ grad,
                     float* __restrict__ d_attrs, int num_tiles,
                     int tiles_x, int tile_w, int tile_h, int row0,
                     int stride) {
  __shared__ float s_attr[kChunk * kStage];
  // Per-warp partial sums: [warp][splat * 10 + row].
  __shared__ float s_part[kMaxWarps * kChunk * kGradRows];
  // Splats of the chunk each warp reduced before all its pixels stopped.
  __shared__ int s_stop[kMaxWarps];
  __shared__ int s_tile;

  // The item's tile: the first whose item_end exceeds the item number.
  const long long item = blockIdx.x;
  if (threadIdx.x == 0) {
    int lo = 0, hi = num_tiles;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (item_end[mid] > item) hi = mid; else lo = mid + 1;
    }
    s_tile = lo;
  }
  __syncthreads();
  const int tile = s_tile;
  if (tile == num_tiles) return;  // past the frame's last item
  const long long count = counts[tile];
  const long long first =
      item_end[tile] - (count + kItemPairs - 1) / kItemPairs;
  const long long c_begin = (item - first) * kItemPairs;
  const long long c_end = min(count, c_begin + kItemPairs);
  const long long start = seg_start[tile];
  const int pix = tile_w * tile_h;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int n_warps = blockDim.x >> 5;
  const float px = (float)((tile % tiles_x) * tile_w + t % tile_w);
  const float py =
      (float)((row0 + (tile / tiles_x) * stride) * tile_h + t / tile_w);

  const float* f = fwd + (long long)tile * kOutRows * pix + t;
  const float* gp = grad + (long long)tile * kOutRows * pix + t;
  const float* st = state + item * kStateRows * pix + t;
  const float g0 = gp[0], g1 = gp[pix], g2 = gp[2 * pix], g3 = gp[3 * pix];
  const float total = g0 * f[0] + g1 * f[pix] + g2 * f[2 * pix]
                      + g3 * f[3 * pix];
  const float b_term = f[4 * pix] * gp[4 * pix];  // T_fin g_T
  float* part = s_part + warp * (kChunk * kGradRows);

  float trans = st[0];  // T carried into the item (K2's carry)
  // The prefix of w.A over the splats before the item: g . accumulators.
  float prefix = g0 * st[pix] + g1 * st[2 * pix] + g2 * st[3 * pix]
                 + g3 * st[4 * pix];

  for (long long c0 = c_begin; c0 < c_end; c0 += kChunk) {
    const long long left = c_end - c0;
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
    float t_prev = trans;  // trans * exp(cum): the next kept splat's T_in
    bool walking = true;   // false once the pixel stopped in this chunk
    int stop = n;          // the warp's first splat without partials
    for (int j0 = 0; j0 < n; j0 += kBatch) {
      // A warp whose pixels have all stopped leaves the chunk: the rest of
      // its partials are 0, and the combine reads them as such.
      if (!__any_sync(0xffffffffu, walking)) {
        stop = j0;
        break;
      }
      float v[kVals];
#pragma unroll
      for (int i = 0; i < kVals; ++i) v[i] = 0.0f;
      bool any = false;
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const float* a = s_attr + (j0 + b) * kStage;
        if (j0 + b >= n || !walking) continue;
        float dx, dy, ex, alpha_raw, alpha, l;
        const float power = mvi::splat_power(a, px, py, dx, dy);
        if (power < mvi::kPowerGated
            || !mvi::splat_gate(a, power, ex, alpha_raw, alpha))
          continue;  // gated out: log 0
        const float t_out = mvi::splat_t_out(trans, alpha, cum, l);
        if (!(t_out >= mvi::kTStop)) {
          walking = false;
          continue;
        }
        const float t_in = t_prev;
        t_prev = t_out;
        const float w = alpha * t_in;
        const float big_a = g0 * a[6] + g1 * a[7] + g2 * a[8] + g3 * a[9];
        prefix += w * big_a;
        const float suffix = total - prefix;
        const float d_alpha = t_in * big_a
                              - __fdividef(suffix + b_term, 1.0f - alpha);
        const float d_raw = alpha_raw < mvi::kAlphaMax ? d_alpha : 0.0f;
        const float d_power = d_raw * alpha_raw;
        float* o = v + b * kGradRows;
        o[0] = d_power * (a[2] * dx + a[3] * dy);
        o[1] = d_power * (a[4] * dy + a[3] * dx);
        o[2] = -0.5f * d_power * dx * dx;
        o[3] = -d_power * dx * dy;
        o[4] = -0.5f * d_power * dy * dy;
        o[5] = d_raw * ex;
        o[6] = w * g0;
        o[7] = w * g1;
        o[8] = w * g2;
        o[9] = w * g3;
        contrib = __fadd_rn(contrib, l);
        any = true;
      }
      // Lane l < 10 * (splats in this batch) stores the warp sum of value
      // l, or 0 when no lane of the warp contributed to the batch.
      const int n_vals = min(kBatch, n - j0) * kGradRows;
      const float s = __any_sync(0xffffffffu, any) ? reduce_scatter(v, lane)
                                                   : 0.0f;
      if (lane < n_vals) part[j0 * kGradRows + lane] = s;
    }
    if (lane == 0) s_stop[warp] = stop;
    trans = __fmul_rn(trans, expf(contrib));
    __syncthreads();  // every warp's partials are in shared memory

    // Every thread combines: output float i of the chunk is row i % 16 of
    // splat i / 16, the partials of the warps that reached the splat added
    // in warp order (past the last warp's stop, 0 without reading); the
    // stores of consecutive threads are consecutive.
    int reached = 0;
    for (int wi = 0; wi < n_warps; ++wi) reached = max(reached, s_stop[wi]);
    float* o = d_attrs + (start + c0) * kRows;
    for (int i = t; i < n * kRows; i += blockDim.x) {
      const int j = i / kRows, r = i % kRows;
      float sum = 0.0f;
      if (r < kGradRows && j < reached) {
        const float* p = s_part + j * kGradRows + r;
        for (int wi = 0; wi < n_warps; ++wi)
          if (j < s_stop[wi]) sum += p[wi * (kChunk * kGradRows)];
      }
      o[i] = sum;
    }
  }
}

}  // namespace

// Launches one block per item, `max_items` of them: a bound on the
// frame's items (tiles + pairs / kItemPairs); the surplus blocks exit.
// Local tile row l is the frame's row row0 + l * stride.
extern "C" int mvi_composite_bwd(const void* attrs, const void* seg_start,
                                 const void* counts, const void* item_end,
                                 const void* state, const void* fwd,
                                 const void* grad, void* d_attrs,
                                 int num_tiles, int max_items, int tiles_x,
                                 int tile_w, int tile_h, int row0,
                                 int stride, void* stream) {
  if (num_tiles > 0 && max_items > 0) {
    composite_bwd_kernel<<<max_items, tile_w * tile_h, 0,
                           (cudaStream_t)stream>>>(
        (const float*)attrs, (const long long*)seg_start,
        (const long long*)counts, (const long long*)item_end,
        (const float*)state, (const float*)fwd, (const float*)grad,
        (float*)d_attrs, num_tiles, tiles_x, tile_w, tile_h, row0, stride);
  }
  return (int)cudaGetLastError();
}

// Residency of the kernel at `threads` per block: out[0] blocks per SM,
// out[1] the splats per warp reduction; `out` is written only on success.
extern "C" int mvi_composite_bwd_residency(int threads, int* out) {
  int blocks = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, composite_bwd_kernel, threads, 0);
  if (e == cudaSuccess) {
    out[0] = blocks;
    out[1] = kBatch;
  }
  return (int)e;
}
