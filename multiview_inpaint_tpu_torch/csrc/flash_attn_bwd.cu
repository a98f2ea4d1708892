// K5: flash-attention backward (non-causal, unmasked) for Hopper (sm_90a).
//
// Replaces the TPU kernel multiview_inpaint_tpu/diffusion/flash_attention.py
// `_bwd_kernel` (via `_flash_bwd_impl`, the backward of `flash_mha`), which
// the SVD training path reaches through `attention_op.attention` for every
// long self-attention that carries a gradient: the ds1 spatial blocks
// ([B, T, H*D] = [14, 3072, 5*64] per video) and ds2 ([14, 768, 10*64]) of
// the ControlNet trunk and the UNet decoder.
//
// What it computes, per head, from q, k, v, dO (the output's cotangent in
// the input type), the forward's row logsumexp lse and delta = rowsum(dO*O)
// (both [B*H, T] f32):
//   p  = exp(s * scale - lse),  s = q.k^T (f32 sums of bf16 products)
//   dv = sum over queries of bf16(p)^T . dO
//   dp = dO . v^T
//   ds = bf16(p * (dp - delta) * scale)
//   dk = sum over queries of ds^T . q,   dq = sum over keys of ds . k
// with f32 accumulators cast to the input type at the end (dq too: the TPU
// kernel's f32 dq is cast once at the end as well). f32 inputs are rounded
// to bf16 as they are staged, as in K4.
//
// What bounds it on the H100: operations. Five products of 2*T*T*D FLOP per
// head (s, dp, dv, dk, dq) on the bf16 tensor cores (989 TFLOP/s) and T*T
// exponentials; its bytes (q, k, v, dO, dq, dk, dv once each) are ~100x
// fewer than the card's balance point at the SVD shapes.
//
// What the design does about it (simple form, no atomics, so runs repeat
// bit for bit): two kernels. The TPU kernel keeps dq resident across its
// sequential grid; blocks here run in no order, so
//   1. dkdv: one block of 4 warps per (head, 64-key tile); each warp holds
//      its 16 keys of k and v as mma A fragments and its 16 x D dk and dv
//      accumulators in registers, and walks every 64-query tile of q and
//      dO staged in shared memory (row-major and transposed, padded), with
//      lse and delta. s^T = k.q^T and dp^T = v.dO^T are computed 16 queries
//      at a time; p^T and ds^T go from those accumulators to the A
//      fragments of dv += p^T.dO and dk += ds^T.q without leaving
//      registers.
//   2. dq: one block per (head, 64-query tile); each warp holds its 16 rows
//      of q and dO as A fragments and lse, delta of those rows in
//      registers, walks every 64-key tile of k (row-major and transposed)
//      and v, recomputes s and dp, and accumulates dq += ds.k.
// Both recompute s (one product more than the TPU kernel's five). Not yet
// done (later work): wgmma, TMA loads, a multi-stage ring, one pass.
//
// Addressing: element (n, h, t, d) of q, k, v, dO, dq, dk and dv lies at
// n*sb + h*sh + t*st + d (the packed [B, T, H*D] layout, or a folded
// [B*H, T, D] one with heads = 1); lse and delta at (n*heads + h)*T + t.
// T must be a multiple of 64, D one of 16 ... 128 in steps of 16.

#include "flash_attn_common.cuh"

namespace {

constexpr int BQ = 64;       // queries per staged tile (dkdv), per block (dq)
constexpr int BK = 64;       // keys per block (dkdv), per staged tile (dq)
constexpr int THREADS = 128;
constexpr int PAD = 8;       // bf16 elements of padding per shared row

template <int D>
constexpr size_t dkdv_smem() {  // q, dO row-major + transposed, lse, delta
  return 2 * sizeof(__nv_bfloat16) * (BQ * (D + PAD) + D * (BQ + PAD)) +
         2 * BQ * sizeof(float);
}
template <int D>
constexpr size_t dq_smem() {    // k row-major + transposed, v row-major
  return sizeof(__nv_bfloat16) * (2 * BK * (D + PAD) + D * (BK + PAD));
}

// Stage one 64-row tile of a [T, D] operand: row-major into `rm` (pitch
// D + PAD) and, if `tr` is given, transposed into `tr` (pitch 64 + PAD).
// Consecutive threads go down the rows so that the transposed 2-byte stores
// of one instruction fall in distinct banks.
template <typename T, int D>
__device__ __forceinline__ void stage(const T* src, long long st,
                                      __nv_bfloat16* rm, __nv_bfloat16* tr,
                                      int tid) {
  constexpr int CHUNKS = 64 * D / 8;   // 16-byte pieces of one tile
#pragma unroll
  for (int i = 0; i < CHUNKS / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int r = idx % 64, c = idx / 64;
    const uint4 w = load8(src + (long long)r * st + c * 8);
    *reinterpret_cast<uint4*>(rm + r * (D + PAD) + c * 8) = w;
    if (tr != nullptr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
      for (int j = 0; j < 8; ++j) tr[(c * 8 + j) * (64 + PAD) + r] = e[j];
    }
  }
}

// p and ds of one 16 x 8 accumulator pair (s, dp) in place: s becomes p =
// exp2(s * scale_log2 - lse2) and dp becomes p * (dp - delta) * scale, with
// lse2 (lse in log2 units) and delta given per accumulator element.
__device__ __forceinline__ void p_ds(float (&s)[4], float (&dp)[4],
                                     const float (&lse2)[4],
                                     const float (&dl)[4], float scale_log2,
                                     float scale) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float p = exp2f(fmaf(s[e], scale_log2, -lse2[e]));
    s[e] = p;
    dp[e] = p * (dp[e] - dl[e]) * scale;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int heads, int t_len, long long sb,
                      long long st, long long sh, float scale_log2,
                      float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);   // [BQ][D+P]
  __nv_bfloat16* os = qs + BQ * (D + PAD);                      // dO [BQ][D+P]
  __nv_bfloat16* qt = os + BQ * (D + PAD);                      // [D][BQ+P]
  __nv_bfloat16* dt = qt + D * (BQ + PAD);                       // dO^T
  float* lse_s = reinterpret_cast<float*>(dt + D * (BQ + PAD));  // log2 units
  float* dl_s = lse_s + BQ;

  const int bh = blockIdx.x;
  const int n = bh / heads, h = bh - n * heads;
  const long long base = (long long)n * sb + (long long)h * sh;
  const float* lse_bh = lse + (long long)bh * t_len;
  const float* dl_bh = delta + (long long)bh * t_len;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int key0 = blockIdx.y * BK + warp * 16;

  uint32_t kf[D / 16][4], vf[D / 16][4];   // this warp's 16 keys of k, v
  load_a_rows<T, D>(kf, k + base + (long long)key0 * st, st, g, tig);
  load_a_rows<T, D>(vf, v + base + (long long)key0 * st, st, g, tig);

  float adk[D / 8][4], adv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[j][e] = adv[j][e] = 0.f;

  for (int q0 = 0; q0 < t_len; q0 += BQ) {
    __syncthreads();   // the previous tile is no longer read
    stage<T, D>(q + base + (long long)q0 * st, st, qs, qt, tid);
    stage<T, D>(dout + base + (long long)q0 * st, st, os, dt, tid);
    if (tid < BQ) {
      lse_s[tid] = lse_bh[q0 + tid] * LOG2E;
      dl_s[tid] = dl_bh[q0 + tid];
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {   // queries 16 kk ... 16 kk + 15
      // s^T and dp^T of this warp's 16 keys x the 16 queries, as two 8-query
      // tiles: element e at key g (+8 for e >= 2), query 8 nt + 2 tig + e%2.
      float s[2][4], dp[2][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int nt = 2 * kk + hh;
#pragma unroll
        for (int e = 0; e < 4; ++e) s[hh][e] = dp[hh][e] = 0.f;
#pragma unroll
        for (int c = 0; c < D / 16; ++c) {
          const __nv_bfloat16* qp = qs + (nt * 8 + g) * (D + PAD) + c * 16 +
                                    tig * 2;
          mma16816(s[hh], kf[c], load_pair(qp), load_pair(qp + 8));
          const __nv_bfloat16* op = os + (nt * 8 + g) * (D + PAD) + c * 16 +
                                    tig * 2;
          mma16816(dp[hh], vf[c], load_pair(op), load_pair(op + 8));
        }
        const int qi = nt * 8 + tig * 2;
        const float l2[4] = {lse_s[qi], lse_s[qi + 1], lse_s[qi],
                             lse_s[qi + 1]};
        const float dl[4] = {dl_s[qi], dl_s[qi + 1], dl_s[qi], dl_s[qi + 1]};
        p_ds(s[hh], dp[hh], l2, dl, scale_log2, scale);
      }
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                              pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]),
                              pack_bf16(s[1][2], s[1][3])};
      const uint32_t da[4] = {pack_bf16(dp[0][0], dp[0][1]),
                              pack_bf16(dp[0][2], dp[0][3]),
                              pack_bf16(dp[1][0], dp[1][1]),
                              pack_bf16(dp[1][2], dp[1][3])};
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {   // columns 8 j ... 8 j + 7 of d
        const int off = (j * 8 + g) * (BQ + PAD) + kk * 16 + tig * 2;
        mma16816(adv[j], pa, load_pair(dt + off), load_pair(dt + off + 8));
        mma16816(adk[j], da, load_pair(qt + off), load_pair(qt + off + 8));
      }
    }
  }

  T* k0 = dk + base + (long long)(key0 + g) * st;
  T* v0 = dv + base + (long long)(key0 + g) * st;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + tig * 2;
    store_pair(k0 + c, adk[j][0], adk[j][1]);
    store_pair(k0 + 8 * st + c, adk[j][2], adk[j][3]);
    store_pair(v0 + c, adv[j][0], adv[j][1]);
    store_pair(v0 + 8 * st + c, adv[j][2], adv[j][3]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int heads, int t_len, long long sb, long long st,
                    long long sh, float scale_log2, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);   // [BK][D+P]
  __nv_bfloat16* vs = ks + BK * (D + PAD);                       // [BK][D+P]
  __nv_bfloat16* kt = vs + BK * (D + PAD);                       // [D][BK+P]

  const int bh = blockIdx.x;
  const int n = bh / heads, h = bh - n * heads;
  const long long base = (long long)n * sb + (long long)h * sh;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.y * BQ + warp * 16;

  uint32_t qf[D / 16][4], of[D / 16][4];   // this warp's 16 rows of q, dO
  load_a_rows<T, D>(qf, q + base + (long long)row0 * st, st, g, tig);
  load_a_rows<T, D>(of, dout + base + (long long)row0 * st, st, g, tig);
  const long long r = (long long)bh * t_len + row0 + g;
  const float l2[4] = {lse[r] * LOG2E, lse[r] * LOG2E, lse[r + 8] * LOG2E,
                       lse[r + 8] * LOG2E};
  const float dl[4] = {delta[r], delta[r], delta[r + 8], delta[r + 8]};

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int k0 = 0; k0 < t_len; k0 += BK) {
    __syncthreads();
    stage<T, D>(k + base + (long long)k0 * st, st, ks, kt, tid);
    stage<T, D>(v + base + (long long)k0 * st, st, vs, nullptr, tid);
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {   // keys 16 kk ... 16 kk + 15
      float s[2][4], dp[2][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int nt = 2 * kk + hh;
#pragma unroll
        for (int e = 0; e < 4; ++e) s[hh][e] = dp[hh][e] = 0.f;
#pragma unroll
        for (int c = 0; c < D / 16; ++c) {
          const int off = (nt * 8 + g) * (D + PAD) + c * 16 + tig * 2;
          mma16816(s[hh], qf[c], load_pair(ks + off), load_pair(ks + off + 8));
          mma16816(dp[hh], of[c], load_pair(vs + off),
                   load_pair(vs + off + 8));
        }
        p_ds(s[hh], dp[hh], l2, dl, scale_log2, scale);
      }
      const uint32_t da[4] = {pack_bf16(dp[0][0], dp[0][1]),
                              pack_bf16(dp[0][2], dp[0][3]),
                              pack_bf16(dp[1][0], dp[1][1]),
                              pack_bf16(dp[1][2], dp[1][3])};
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int off = (j * 8 + g) * (BK + PAD) + kk * 16 + tig * 2;
        mma16816(acc[j], da, load_pair(kt + off), load_pair(kt + off + 8));
      }
    }
  }

  T* o0 = dq + base + (long long)(row0 + g) * st;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + tig * 2;
    store_pair(o0 + c, acc[j][0], acc[j][1]);
    store_pair(o0 + 8 * st + c, acc[j][2], acc[j][3]);
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, void* dq, void* dk,
             void* dv, int batch, int heads, int t_len, long long sb,
             long long st, long long sh, float scale, cudaStream_t stream) {
  const dim3 grid(batch * heads, t_len / 64);
  const float sl = scale * LOG2E;
  constexpr size_t s1 = dkdv_smem<D>(), s2 = dq_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)s2);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv_kernel<T, D><<<grid, THREADS, s1, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, heads, t_len, sb, st, sh, sl, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_kernel<T, D><<<grid, THREADS, s2, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, heads, t_len, sb, st, sh, sl, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk, void* dv,
           int batch, int heads, int t_len, int d, long long sb, long long st,
           long long sh, float scale, cudaStream_t stream) {
#define MVI_FLASH_BWD_CASE(DD)                                              \
  case DD:                                                                  \
    return launch_d<T, DD>(q, k, v, dout, lse, delta, dq, dk, dv, batch,    \
                           heads, t_len, sb, st, sh, scale, stream);
  switch (d) {
    MVI_FLASH_BWD_CASE(16)
    MVI_FLASH_BWD_CASE(32)
    MVI_FLASH_BWD_CASE(48)
    MVI_FLASH_BWD_CASE(64)
    MVI_FLASH_BWD_CASE(80)
    MVI_FLASH_BWD_CASE(96)
    MVI_FLASH_BWD_CASE(112)
    MVI_FLASH_BWD_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MVI_FLASH_BWD_CASE
}

}  // namespace

extern "C" int mvi_flash_attn_bwd(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dq, void* dk,
                                  void* dv, int is_f32, int batch, int heads,
                                  int t_len, int d, long long sb,
                                  long long st, long long sh, float scale,
                                  void* stream) {
  if (batch <= 0 || heads <= 0 || t_len <= 0 || t_len % 64 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* dl = (const float*)delta;
  return is_f32 ? launch<float>(q, k, v, dout, l, dl, dq, dk, dv, batch, heads,
                                t_len, d, sb, st, sh, scale, s)
                : launch<__nv_bfloat16>(q, k, v, dout, l, dl, dq, dk, dv,
                                        batch, heads, t_len, d, sb, st, sh,
                                        scale, s);
}
