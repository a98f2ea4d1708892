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
constexpr float kAlphaMax = 0.99f;
constexpr float kTStop = 1e-4f;

// Splat `a` (packed rows: 0-1 mean, 2-4 conic abc, 5 opacity, 10 alpha
// gate) at integer pixel (px, py): the offsets, exp(power), the raw and
// the clamped alpha. Returns whether the splat passes the gate (alpha >=
// its gate and power <= 0); a splat that does not adds log 0 to the prefix.
__device__ __forceinline__ bool eval_splat(const float* a, float px,
                                           float py, float& dx, float& dy,
                                           float& ex, float& alpha_raw,
                                           float& alpha) {
  dx = __fsub_rn(px, a[0]);
  dy = __fsub_rn(py, a[1]);
  // power = -0.5 * (ca*dx*dx + cc*dy*dy) - cb*dx*dy
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(a[2], dx), dx),
                               __fmul_rn(__fmul_rn(a[4], dy), dy));
  const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
                                __fmul_rn(__fmul_rn(a[3], dx), dy));
  ex = expf(power);
  alpha_raw = __fmul_rn(a[5], ex);
  alpha = fminf(alpha_raw, kAlphaMax);
  return alpha >= a[10] && power <= 0.0f;
}

// Adds a kept splat's log1p(-alpha) to the in-chunk prefix `cum`. Returns
// false when T_out = trans * exp(cum) falls below kTStop: that splat and
// the rest of its chunk are skipped (the chunk-scoped stop rule). Else
// sets its log `l` and its T_in.
__device__ __forceinline__ bool transmit(float trans, float alpha, float& cum,
                                         float& l, float& t_in) {
  l = log1pf(-alpha);
  cum = __fadd_rn(cum, l);
  const float t_out = __fmul_rn(trans, expf(cum));
  if (!(t_out >= kTStop)) return false;
  t_in = __fmul_rn(trans, expf(__fsub_rn(cum, l)));
  return true;
}

}  // namespace mvi
