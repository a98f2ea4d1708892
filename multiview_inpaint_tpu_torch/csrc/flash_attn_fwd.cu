// K4: flash-attention forward (non-causal, unmasked) for Hopper (sm_90a).
//
// Replaces the TPU kernel multiview_inpaint_tpu/diffusion/flash_attention.py
// `_kernel` (via `_flash_fwd_impl` and `flash_mha`), which the diffusion
// stack's one attention op (`attention_op.attention`) calls for long
// self-attention: tq == tk, T >= 768, T % 256 == 0, head dim <= 128. On the
// SVD path these are the spatial blocks at ds1 ([B*H, T, D] = [140, 3072,
// 64] with the CFG batch of 28 frames) and ds2 ([280, 768, 64]).
//
// What it computes, per head and query row: s = q.k^T * scale with f32
// accumulation; a running max and denominator in f32 (online softmax); p
// rounded to bf16 before p.v, whose sum is f32; out = acc / denom in the
// input's type; optionally the row logsumexp m + log(denom) as [B*H, T]
// f32 (the TPU kernel's 128-lane broadcast has no use here). f32 inputs
// are rounded to bf16 as they are staged, so q.k and p.v take bf16
// operands with f32 sums in both types, as in the TPU kernel.
//
// What bounds it on the H100: operations. 4*T*T*D FLOP per head (q.k and
// p.v) on the bf16 tensor cores (989 TFLOP/s) and T*T exponentials on the
// special-function units; its bytes, q, k, v and o once each, are 64-128x
// fewer than the card's balance point at these shapes.
//
// What the design does about it (FlashAttention-2's layout, simple form):
// one block of 4 warps per (head, 64-row query tile); each warp owns 16
// query rows, holds them as mma.sync A fragments in registers for the whole
// loop, and keeps its 16 x D f32 accumulator, row max and row sum in
// registers. The block walks the keys in 64-row tiles staged in shared
// memory (K row-major, V transposed, both padded against bank conflicts);
// s = q.k^T and acc += p.v run as bf16 m16n8k16 tensor-core products with
// f32 accumulation, and p goes from the s accumulator to the p.v A
// fragment without leaving registers, so no [T, T] tile is ever written.
// Sums are taken in a fixed order, so runs repeat bit for bit. Not yet
// done (later work): wgmma, TMA loads, a multi-stage ring that overlaps
// the next tile's load with this tile's products, warp specialisation.
//
// Addressing: element (n, h, t, d) of q, k, v and o lies at n*sb + h*sh +
// t*st + d, so the packed [B, T, H*D] projections are read in place (sb =
// T*H*D, st = H*D, sh = D) and a folded [B*H, T, D] tensor is the case
// heads = 1. T must be a multiple of 64, D one of 16 ... 128 in steps of
// 16; the wrapper checks both.

#include "flash_attn_common.cuh"

namespace {

constexpr int BQ = 64;       // query rows per block, 16 per warp
constexpr int BK = 64;       // keys per staged tile
constexpr int THREADS = 128;
constexpr int PAD = 8;       // bf16 elements of padding per shared row
constexpr float NEG = -1e30f;  // the TPU kernel's initial row max

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int heads, int t_len,
                 long long sb, long long st, long long sh,
                 float scale_log2) {
  // K tile row-major [key][d]; V tile transposed [d][key], so both B
  // operands are two consecutive bf16 along the reduction axis.
  __shared__ __align__(16) __nv_bfloat16 ks[BK][D + PAD];
  __shared__ __align__(16) __nv_bfloat16 vt[D][BK + PAD];

  const int bh = blockIdx.x;
  const int n = bh / heads, h = bh - n * heads;
  const long long base = (long long)n * sb + (long long)h * sh;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;   // mma group and thread in group
  const int row0 = blockIdx.y * BQ + warp * 16;

  // This warp's 16 query rows as A fragments: rows g and g + 8, columns
  // 16 kk + 2 tig (+1) and 16 kk + 8 + 2 tig (+1).
  uint32_t qf[D / 16][4];
  load_a_rows<T, D>(qf, q + base + (long long)row0 * st, st, g, tig);

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {NEG, NEG};   // running max (log2 units) of rows g, g + 8
  float l[2] = {0.f, 0.f};   // this thread's share of the row sums

  constexpr int CHUNKS = BK * D / 8;   // 16-byte pieces of one tile
  for (int kt = 0; kt < t_len; kt += BK) {
    __syncthreads();   // the previous tile is no longer read
#pragma unroll
    for (int i = 0; i < CHUNKS / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      // K: consecutive threads along a row (coalesced, conflict-free).
      const int kr = idx / (D / 8), kc = idx % (D / 8);
      *reinterpret_cast<uint4*>(&ks[kr][kc * 8]) =
          load8(k + base + (long long)(kt + kr) * st + kc * 8);
      // V: consecutive threads down the keys, so the transposed 2-byte
      // stores of one instruction fall in distinct banks.
      const int vr = idx % BK, vc = idx / BK;
      const uint4 w = load8(v + base + (long long)(kt + vr) * st + vc * 8);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[vc * 8 + j][vr] = e[j];
    }
    __syncthreads();

    // s = q.k^T for this warp's 16 rows and the tile's 64 keys: eight
    // 16x8 accumulators (rows g / g + 8, keys 8 nt + 2 tig (+1)).
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kp = &ks[nt * 8 + g][kk * 16 + tig * 2];
        mma16816(s[nt], qf[kk], load_pair(kp), load_pair(kp + 8));
      }
    }

    // Online softmax in f32, in log2 units: s * scale * log2(e).
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] *= scale_log2;
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {   // the 4 threads of a row's group
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    const float corr0 = exp2f(m[0] - mx[0]), corr1 = exp2f(m[1] - mx[1]);
    m[0] = mx[0];
    m[1] = mx[1];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mx[0]);
      s[nt][1] = exp2f(s[nt][1] - mx[0]);
      s[nt][2] = exp2f(s[nt][2] - mx[1]);
      s[nt][3] = exp2f(s[nt][3] - mx[1]);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
    l[0] = l[0] * corr0 + sum0;   // the f32 p, as the TPU kernel sums it
    l[1] = l[1] * corr1 + sum1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= corr0;
      acc[j][1] *= corr0;
      acc[j][2] *= corr1;
      acc[j][3] *= corr1;
    }

    // acc += p.v with p rounded to bf16: the accumulators of key tiles
    // 2 kk and 2 kk + 1 are exactly the A fragment of keys 16 kk .. +15.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const __nv_bfloat16* vp = &vt[j * 8 + g][kk * 16 + tig * 2];
        mma16816(acc[j], pa, load_pair(vp), load_pair(vp + 8));
      }
    }
  }

  // Whole-row sums, then out = acc / denom in the input's type.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
  T* o0 = o + base + (long long)(row0 + g) * st;
  T* o8 = o0 + 8 * st;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + tig * 2;
    store_pair(o0 + c, acc[j][0] * inv0, acc[j][1] * inv0);
    store_pair(o8 + c, acc[j][2] * inv1, acc[j][3] * inv1);
  }
  if (lse != nullptr && tig == 0) {
    float* out = lse + (long long)bh * t_len + row0 + g;
    out[0] = (m[0] + log2f(l[0])) * LN2;
    out[8] = (m[1] + log2f(l[1])) * LN2;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int batch, int heads, int t_len, int d, long long sb,
           long long st, long long sh, float scale, cudaStream_t stream) {
  const dim3 grid(batch * heads, t_len / BQ);
  const float sl = scale * LOG2E;
#define MVI_FLASH_CASE(DD)                                                \
  case DD:                                                                \
    flash_fwd_kernel<T, DD><<<grid, THREADS, 0, stream>>>(                \
        (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, heads, \
        t_len, sb, st, sh, sl);                                           \
    break;
  switch (d) {
    MVI_FLASH_CASE(16)
    MVI_FLASH_CASE(32)
    MVI_FLASH_CASE(48)
    MVI_FLASH_CASE(64)
    MVI_FLASH_CASE(80)
    MVI_FLASH_CASE(96)
    MVI_FLASH_CASE(112)
    MVI_FLASH_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MVI_FLASH_CASE
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mvi_flash_attn_fwd(const void* q, const void* k,
                                  const void* v, void* o, void* lse,
                                  int is_f32, int batch, int heads, int t_len,
                                  int d, long long sb, long long st,
                                  long long sh, float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || t_len <= 0 || t_len % BQ != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_f32 ? launch<float>(q, k, v, o, lse, batch, heads, t_len, d, sb,
                                st, sh, scale, s)
                : launch<__nv_bfloat16>(q, k, v, o, lse, batch, heads, t_len,
                                        d, sb, st, sh, scale, s);
}
