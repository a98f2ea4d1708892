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
// write (0,0,0,0,1,0,0,0). In band mode (the JAX render's band_rows,
// pallas_composite.py:137) the grid's tiles_y rows are the frame's tile
// rows row0 + l * stride, and a pixel's global row is (row0 + (tile /
// tiles_x) * stride) * tile_h + ly; a full frame is row0 = 0, stride = 1,
// the same integer arithmetic as before. When the caller will run the backward (K3,
// composite_bwd.cu), it also stores the per-item state [items, 5, PIX]:
// at the first chunk of every work item (kItemChunks chunks of the
// tile's segment, numbered through `item_end`), the T carried into it
// and the four accumulators there, which K3 starts that item from. The
// T is the kernel's own __fmul_rn(trans, expf(contrib)) carry, the
// recurrence K3 walks, so an item starts from exactly the T that the
// walk from the tile's start reaches. Storing it changes no other
// output.
//
// What bounds it on the H100: operations, and how many of them the SIMT
// lanes waste. A walked pair-pixel runs the power (~11 FP32 ops); one
// that can pass its gate adds an expf and the gate test, a kept one
// log1pf, the expf of the stop test and the accumulation (~110
// instructions in all). A warp issues that path for a splat whenever any
// of its 32 lanes needs it, so the kernel is issue-bound at a few times
// the operations its lanes need. The bytes (64 per pair in, 32 per pixel
// out) are a few hundred MB a frame.
//
// What the design does about it:
// - One block per tile, one thread per pixel, a warp per 8x4 pixel
//   rectangle (16x16 and 8x16 tiles; other shapes map 32 consecutive
//   pixels to a warp). A pixel's transmittance, accumulators and
//   in-chunk stop state live in registers; outputs and state are indexed
//   by pixel.
// - Double-buffered staging. Chunk c+1's rows are copied into a second
//   shared buffer by 16-byte cp.async while chunk c is composited; one
//   barrier per chunk publishes a chunk and frees the other buffer.
// - Per-warp gate culling. While a chunk is staged, one thread per splat
//   writes its gate bound and gate box to shared memory (from the rows in
//   global memory, beside the copy). The bound is the least power at
//   which the splat can pass its gate, ln(gate / opacity) less the
//   roundings of expf, the product and logf; the box bounds the ellipse
//   where the power reaches it. Each warp tests the chunk's boxes against
//   its rectangle by __ballot_sync, 32 splats at a time, and walks only
//   the splats whose box meets it, in chunk order. A culled splat is
//   below its bound at every pixel of the warp, so its log is 0 there
//   either way and no decision moves. A warp whose lanes have all
//   stopped leaves the chunk.
// - Early gate reject. A pixel where a splat's power is below its bound
//   skips the gate's expf: nothing there passes the gate.
// - One expf fewer per kept splat: its T_in is the previous kept splat's
//   T_out in the chunk (the carry for the first), as in K3.
// The float ops that decide a splat's fate (power, alpha, the gates, the
// stop) come from composite_common.cuh, which K3 shares, with one
// rounding per operation as in the plain PyTorch version, so nvcc's FMA
// contraction cannot move a gate or stop decision off the plain version's
// or off K3's; the bound and the box only decide what need not be
// evaluated. The state adds 20 bytes per item and pixel (there are at
// most tiles + pairs / 1,024 items), written coalesced. There is no
// tile-level early exit: under the chunk-scoped rule the carried T is
// the T_out of a contributing splat, which is >= 1e-4, so no pixel's
// carry ever falls below the stop. Tensor cores would round the power
// otherwise than K3 and the plain version, whose decisions K2 shares.

#include <cuda_runtime.h>
#include <math.h>

#include "composite_common.cuh"

namespace {

using mvi::kChunk;
using mvi::kItemPairs;
using mvi::kOutRows;
using mvi::kRows;
using mvi::kStateRows;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 256;

// The gate bound of a splat of opacity op and gate g: alpha = min(op
// expf(power), 0.99) >= g needs op expf(power) >= g, so power >= ln(g /
// op) less the rounding of expf and the product (~3e-7) and of this logf
// (~1e-6); kBoundMargin covers them. +inf where nothing passes; -inf
// where the gate is not positive or the opacity is NaN (fminf then
// clamps alpha to 0.99, which passes).
constexpr float kBoundMargin = 1e-4f;

__device__ __forceinline__ float gate_bound(float op, float g) {
  if (!(g > 0.0f) || isnan(op)) return -INFINITY;
  if (!(op > 0.0f)) return INFINITY;
  return __fsub_rn(logf(__fdiv_rn(g, op)), kBoundMargin);
}

// The gate box: a pixel box around the ellipse {power >= bound} = {Q <=
// -2 bound}, Q = a dx^2 + 2 b dx dy + c dy^2, with half-extents
// sqrt(q c / det) and sqrt(q a / det) (det = a c - b^2) at q = -2 bound
// enlarged by kBoxSlack, plus kBoxPad pixels, less `shrink` (a planted
// fault; 0 otherwise). Where the float power that the kernel computes
// reaches the bound the pixel lies inside the box: that power's rounding
// is at most (20 ac / det + 1) 2^-24 of Q, 0.12% of Q at ac / det <=
// kBoxCond, under the 1% slack. A conic that is not positive definite,
// too near singular (ac / det above kBoxCond) or not finite, and a bound
// of -inf, get the whole plane: no warp culls them.
constexpr float kBoxSlack = 1.01f;
constexpr float kBoxPad = 0.0625f;
constexpr float kBoxCond = 1000.0f;

__device__ __forceinline__ float4 gate_box(float mx, float my, float a,
                                           float b, float c, float bound,
                                           float shrink) {
  const float q = bound < 0.0f ? __fmul_rn(-2.0f * kBoxSlack, bound) : 0.0f;
  const float ac = __fmul_rn(a, c);
  const float det = __fsub_rn(ac, __fmul_rn(b, b));
  if (!(a > 0.0f && det > 0.0f && ac < INFINITY
        && ac <= __fmul_rn(kBoxCond, det) && q < INFINITY))
    return make_float4(-INFINITY, INFINITY, -INFINITY, INFINITY);
  const float hx = __fsub_rn(
      __fadd_rn(sqrtf(__fdiv_rn(__fmul_rn(q, c), det)), kBoxPad), shrink);
  const float hy = __fsub_rn(
      __fadd_rn(sqrtf(__fdiv_rn(__fmul_rn(q, a), det)), kBoxPad), shrink);
  return make_float4(__fsub_rn(mx, hx), __fadd_rn(mx, hx), __fsub_rn(my, hy),
                     __fadd_rn(my, hy));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(kMaxThreads)
composite_kernel(const float* __restrict__ attrs,
                 const long long* __restrict__ seg_start,
                 const long long* __restrict__ counts,
                 const long long* __restrict__ item_end,
                 const long long* __restrict__ order,
                 float* __restrict__ state, float* __restrict__ out,
                 int tiles_x, int tile_w, int tile_h, int row0,
                 int stride, float shrink) {
  // Two chunk buffers, each with its splats' gate boxes and bounds.
  __shared__ __align__(16) float s_attr[2][kChunk * kRows];
  __shared__ float4 s_box[2][kChunk];
  __shared__ float s_bound[2][kChunk];

  const int tile = order != nullptr ? (int)order[blockIdx.x] : blockIdx.x;
  const int pix = tile_w * tile_h;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  int lx, ly;
  if (tile_w % 8 == 0 && tile_h % 4 == 0) {
    const int per_row = tile_w / 8;
    lx = (warp % per_row) * 8 + (lane & 7);
    ly = (warp / per_row) * 4 + (lane >> 3);
  } else {
    lx = t % tile_w;
    ly = t / tile_w;
  }
  const int p = ly * tile_w + lx;
  // Integer pixel coordinates (no +0.5), as the reference.
  const int ix = (tile % tiles_x) * tile_w + lx;
  const int iy = (row0 + (tile / tiles_x) * stride) * tile_h + ly;
  const float px = (float)ix, py = (float)iy;
  // The warp's pixel rectangle.
  const float rx0 = (float)__reduce_min_sync(kFull, ix);
  const float rx1 = (float)__reduce_max_sync(kFull, ix);
  const float ry0 = (float)__reduce_min_sync(kFull, iy);
  const float ry1 = (float)__reduce_max_sync(kFull, iy);
  const long long start = seg_start[tile];
  const long long count = counts[tile];
  const int n_chunks = (int)((count + kChunk - 1) / kChunk);

  float trans = 1.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;
  // This pixel's state at the tile's first item (null without a state).
  float* st = nullptr;
  if (state != nullptr)
    st = state + (item_end[tile] - (count + kItemPairs - 1) / kItemPairs)
                     * kStateRows * pix + p;

  auto chunk_n = [&](int c) {
    const long long left = count - (long long)c * kChunk;
    return left < kChunk ? (int)left : kChunk;
  };
  auto row = [&](int c, int j) {
    return attrs + (start + (long long)c * kChunk + j) * kRows;
  };
  // Chunk c's rows into buffer `buf`, 16 bytes per copy.
  auto issue = [&](int c, int buf) {
    const float4* src = reinterpret_cast<const float4*>(row(c, 0));
    float4* dst = reinterpret_cast<float4*>(s_attr[buf]);
    for (int i = t; i < chunk_n(c) * (kRows / 4); i += blockDim.x)
      cp_async16(dst + i, src + i);
    cp_async_commit();
  };
  // Thread t's splat of a chunk: its box and bound into buffer `buf`.
  auto put_box = [&](int buf, float4 m, float c4, float op, float g) {
    const float bound = gate_bound(op, g);
    s_bound[buf][t] = bound;
    s_box[buf][t] = gate_box(m.x, m.y, m.z, m.w, c4, bound, shrink);
  };

  if (n_chunks > 0) {
    issue(0, 0);
    if (t < chunk_n(0)) {
      const float* a = row(0, t);
      put_box(0, __ldg(reinterpret_cast<const float4*>(a)), __ldg(a + 4),
              __ldg(a + 5), __ldg(a + 10));
    }
  }

  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    const int n = chunk_n(c);
    if (st != nullptr && ((long long)c * kChunk) % kItemPairs == 0) {
      float* s = st + ((long long)c * kChunk / kItemPairs) * kStateRows * pix;
      s[0] = trans;
      s[pix] = acc_r;
      s[2 * pix] = acc_g;
      s[3 * pix] = acc_b;
      s[4 * pix] = acc_d;
    }
    cp_async_wait_all();
    __syncthreads();  // chunk c and its boxes are in; chunk c-1 is done
    // The next chunk's copy, and this thread's row of it for the box, in
    // flight while this chunk is composited.
    const bool next = c + 1 < n_chunks && t < chunk_n(c + 1);
    float4 nm = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float nc = 0.0f, nop = 0.0f, ng = 0.0f;
    if (c + 1 < n_chunks) {
      issue(c + 1, buf ^ 1);
      if (next) {
        const float* a = row(c + 1, t);
        nm = __ldg(reinterpret_cast<const float4*>(a));
        nc = __ldg(a + 4);
        nop = __ldg(a + 5);
        ng = __ldg(a + 10);
      }
    }
    const float* sa = s_attr[buf];

    float cum = 0.0f;      // inclusive prefix of this chunk's logs
    float contrib = 0.0f;  // sum of the contributing logs
    float t_prev = trans;  // trans * exp(cum): the next kept splat's T_in
    bool walking = true;   // false once the pixel stopped in this chunk
    bool left = false;     // the warp's pixels have all stopped
#pragma unroll 1
    for (int g = 0; g * 32 < n && !left; ++g) {
      // The splats of this group whose box meets the warp's rectangle.
      const int jl = g * 32 + lane;
      bool hit = false;
      if (jl < n) {
        const float4 b = s_box[buf][jl];
        hit = b.x <= rx1 && b.y >= rx0 && b.z <= ry1 && b.w >= ry0;
      }
      unsigned m = __ballot_sync(kFull, hit);
      while (m != 0u) {
        const int j = g * 32 + __ffs(m) - 1;
        m &= m - 1u;
        const float* a = sa + j * kRows;
        float dx, dy, ex, alpha_raw, alpha, l;
        const float power = mvi::splat_power(a, px, py, dx, dy);
        const float bound = s_bound[buf][j];
        if (walking && power >= bound
            && mvi::splat_gate(a, power, ex, alpha_raw, alpha)) {
          const float t_out = mvi::splat_t_out(trans, alpha, cum, l);
          if (!(t_out >= mvi::kTStop)) {
            walking = false;  // skipped, with the rest of the chunk
          } else {
            const float t_in = t_prev;
            t_prev = t_out;
            const float wgt = __fmul_rn(alpha, t_in);
            acc_r = __fadd_rn(acc_r, __fmul_rn(wgt, a[6]));
            acc_g = __fadd_rn(acc_g, __fmul_rn(wgt, a[7]));
            acc_b = __fadd_rn(acc_b, __fmul_rn(wgt, a[8]));
            acc_d = __fadd_rn(acc_d, __fmul_rn(wgt, a[9]));
            contrib = __fadd_rn(contrib, l);
          }
        }
        if (!__any_sync(kFull, walking)) {
          left = true;
          break;
        }
      }
    }
    if (next) put_box(buf ^ 1, nm, nc, nop, ng);
    trans = __fmul_rn(trans, expf(contrib));
  }

  float* o = out + (long long)tile * kOutRows * pix + p;
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

// `item_end` and `state` are both null (no state) or both set; `order`
// (null: tile order) is a permutation of the tiles, block b taking tile
// order[b]. Blocks of tile_w * tile_h threads, 128-256 in whole warps.
// Local tile row l is the frame's row row0 + l * stride (0 and 1 for a
// full frame).
extern "C" int mvi_composite(const void* attrs, const void* seg_start,
                             const void* counts, const void* item_end,
                             const void* order, void* state, void* out,
                             int num_tiles, int tiles_x, int tile_w,
                             int tile_h, int row0, int stride, float shrink,
                             void* stream) {
  if (num_tiles > 0) {
    composite_kernel<<<num_tiles, tile_w * tile_h, 0,
                       (cudaStream_t)stream>>>(
        (const float*)attrs, (const long long*)seg_start,
        (const long long*)counts, (const long long*)item_end,
        (const long long*)order, (float*)state, (float*)out, tiles_x,
        tile_w, tile_h, row0, stride, shrink);
  }
  return (int)cudaGetLastError();
}

// Blocks of `threads` threads per SM; `out` is written only on success.
extern "C" int mvi_composite_residency(int threads, int* out) {
  int blocks = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, composite_kernel, threads, 0);
  if (e == cudaSuccess) out[0] = blocks;
  return (int)e;
}
