// Per-splat math shared by the composite forward (K2, composite.cu) and
// its backward (K3, composite_bwd.cu).
//
// The backward recomputes the forward's alpha and transmittance, so a gate
// or stop decision that differed between the two would change a gradient
// by O(1e-2). Both kernels therefore take every decision from these two
// functions: the float ops use explicit round-to-nearest intrinsics (one
// rounding per operation, as the plain PyTorch version), so nvcc's FMA
// contraction cannot move a decision, and expf / log1pf are the accurate
// library functions (the kernels are built without --use_fast_math).

#pragma once

namespace mvi {

constexpr int kChunk = 128;      // splats per compositing step
constexpr int kRows = 16;        // packed attribute floats per pair
constexpr int kOutRows = 8;      // raw output rows per tile
// A work item is kItemChunks chunks of one tile's segment (composite.py's
// ITEM_CHUNKS). Items are numbered over the frame in tile order: tile t
// owns [item_end[t] - ceil(count_t / kItemPairs), item_end[t]). The
// forward can store kStateRows floats per item and pixel at the item's
// start (T, then the rgb and depth accumulators) for the backward.
constexpr int kItemChunks = 8;
constexpr int kItemPairs = kItemChunks * kChunk;
constexpr int kStateRows = 5;
constexpr float kAlphaMax = 0.99f;
constexpr float kTStop = 1e-4f;

// Splat `a` (packed rows: 0-1 mean, 2-4 conic abc) at integer pixel
// (px, py): the offsets and the power of its gaussian.
__device__ __forceinline__ float splat_power(const float* a, float px,
                                             float py, float& dx,
                                             float& dy) {
  dx = __fsub_rn(px, a[0]);
  dy = __fsub_rn(py, a[1]);
  // power = -0.5 * (ca*dx*dx + cc*dy*dy) - cb*dx*dy
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(a[2], dx), dx),
                               __fmul_rn(__fmul_rn(a[4], dy), dy));
  return __fsub_rn(__fmul_rn(-0.5f, quad),
                   __fmul_rn(__fmul_rn(a[3], dx), dy));
}

// The gate of splat `a` (5 opacity, 10 alpha gate) at a pixel where its
// power is `power`: exp(power), the raw and the clamped alpha. Returns
// whether the splat passes (alpha >= its gate and power <= 0); a splat
// that does not adds log 0 to the prefix.
__device__ __forceinline__ bool splat_gate(const float* a, float power,
                                           float& ex, float& alpha_raw,
                                           float& alpha) {
  ex = expf(power);
  alpha_raw = __fmul_rn(a[5], ex);
  alpha = fminf(alpha_raw, kAlphaMax);
  return alpha >= a[10] && power <= 0.0f;
}

// Both of the above.
__device__ __forceinline__ bool eval_splat(const float* a, float px,
                                           float py, float& dx, float& dy,
                                           float& ex, float& alpha_raw,
                                           float& alpha) {
  return splat_gate(a, splat_power(a, px, py, dx, dy), ex, alpha_raw,
                    alpha);
}

// Below this power no splat passes its gate: the gate is at least
// opacity * e^-4.5 (composite.alpha_gate), so alpha >= it needs
// exp(power) >= e^-4.5; at -4.6 exp(power) is 10% short of that, far
// beyond the rounding of expf and the products.
constexpr float kPowerGated = -4.6f;

// Adds a kept splat's log1p(-alpha) to the in-chunk prefix `cum` (its log
// in `l`) and returns its T_out = trans * exp(cum). Below kTStop the
// splat and the rest of its chunk are skipped (the chunk-scoped stop
// rule).
__device__ __forceinline__ float splat_t_out(float trans, float alpha,
                                             float& cum, float& l) {
  l = log1pf(-alpha);
  cum = __fadd_rn(cum, l);
  return __fmul_rn(trans, expf(cum));
}

// splat_t_out's stop test: returns false when the splat is skipped, else
// sets its T_in = trans * exp(cum - l).
__device__ __forceinline__ bool transmit(float trans, float alpha, float& cum,
                                         float& l, float& t_in) {
  const float t_out = splat_t_out(trans, alpha, cum, l);
  if (!(t_out >= kTStop)) return false;
  t_in = __fmul_rn(trans, expf(__fsub_rn(cum, l)));
  return true;
}

}  // namespace mvi
