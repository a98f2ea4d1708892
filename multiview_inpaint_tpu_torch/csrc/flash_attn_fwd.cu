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
// accumulation of bf16 products; a running max and denominator in f32
// (online softmax, f32 sum of the unrounded p); p rounded to bf16 before
// p.v, whose sum is f32; out = acc / denom in the output's type; optionally
// the row logsumexp m + log(denom) as [B*H, T] f32. q, k and v arrive in
// bf16 (the wrapper rounds f32 inputs once, as the TPU kernel's products
// do); o is bf16 or f32.
//
// What bounds it on the H100: operations, of two kinds at once. 4*T*T*D
// FLOP per head (q.k and p.v) on the bf16 tensor cores (989 TFLOP/s) and
// T*T exponentials on the special-function units (16 per SM and clock,
// ~4.2e12/s): at D = 64 the exponentials alone take 92% of the tensor
// cores' time, so the softmax has to overlap the products to come near
// either. Its bytes, q, k, v and o once each, are 64-128x fewer than the
// card's balance point at these shapes. Only wgmma reaches the tensor
// cores' full rate, and it needs its operands in shared memory in time.
//
// What the design does about it (FlashAttention-3's shape): one block per
// (head, 64 * NWG query rows), NWG = 3 consumer warpgroups for D <= 64 (2
// for D > 64), plus a producer warpgroup that gives up its registers
// (setmaxnreg) and from one thread issues TMA loads: q once, then the
// 128-key tiles of K and V into a ring of 3 (D <= 64) or 2 shared-memory
// stages tracked by mbarriers (K and V each signal their own arrival;
// empty: every consumer is done with the stage). Each consumer owns 64
// query rows: s = q.k^T is an SS wgmma product (m64 n128, both operands
// K-major in shared memory); the online softmax runs in f32 registers (the
// max on the raw logits, the scale folded into one fma per exponent, max
// and sum as independent partials); p is rounded to bf16 into the
// consumer's own swizzled shared tile, and o += p.v is an SS wgmma product
// with V read MN-major from the very tile TMA wrote, so nothing is
// transposed. The products of s for tile j and p.v for tile j - 1 are
// issued together, so the softmax of tile j overlaps p.v; the consumers
// interleave freely. Keeping p out of registers is what lets three
// consumers fit in 160 registers each: more warps to hide the softmax's
// latency, and each K/V tile serves 192 queries. (A strict ping-pong of two
// consumers on named barriers measured slower on the H100.) Sums are taken
// in a fixed order, so runs repeat bit for bit.
//
// Addressing: element (n, h, t, i) of q, k, v and o lies at n*sb + h*sh +
// t*st + i, so the packed [B, T, H*D] projections are read in place (TMA
// sees them as a 4-D tensor (D, H, T, B)) and a folded [B*H, T, D] tensor
// is the case heads = 1. T must be a multiple of 128 (the rows of a last,
// partial query tile read as zeros and are not stored), D one of 16 ...
// 128 in steps of 16 (held in shared memory as 64 or 128 columns, TMA
// filling the rest with zeros); the wrapper checks both.

#include "flash_attn_common.cuh"

namespace {

constexpr int BK = 128;        // keys per staged tile
constexpr float NEG = -1e30f;  // the TPU kernel's initial row max

// Consumer warpgroups (64 query rows each) and ring depth by padded head
// dim: three consumers at 160 registers for D <= 64, two at 240 above.
template <int DP>
constexpr int NWG = DP == 64 ? 3 : 2;
template <int DP>
constexpr int BQ = 64 * NWG<DP>;
template <int DP>
constexpr int STAGES = DP == 64 ? 3 : 2;
template <int DP>
constexpr int THREADS = WG * (1 + NWG<DP>);

template <int DP>
constexpr size_t fwd_smem() {  // q, the ring of K and V, p, barriers, align
  return (size_t)BQ<DP> * DP * 2 + (size_t)STAGES<DP> * 2 * BK * DP * 2 +
         (size_t)NWG<DP> * 64 * BK * 2 + (1 + 3 * STAGES<DP>) * 8 + 1024;
}

// One tile of the online softmax in f32, in log2 units (s * scale *
// log2(e)): updates the running max and row sums of rows g and g + 8, turns
// s into the unrounded p and returns the rescale factors of the old sums.
// The max is taken on the raw logits (scaling by a positive factor keeps
// it) and the scale folds into the exponent's argument, one fma each. Max
// and sum run as NP independent partials joined by a fixed tree: with two
// warps per scheduler there is little else to hide a 64-long dependent
// chain behind.
template <int R>
__device__ __forceinline__ void online_softmax(float (&s)[R], float& m0,
                                               float& m8, float& l0,
                                               float& l8, float scale_log2,
                                               float& corr0, float& corr8) {
  constexpr int NP = 8;   // partials per row half
  static_assert(R % (4 * NP) == 0, "tile width");
  float a0[NP], a8[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    a0[i] = fmaxf(s[4 * i], s[4 * i + 1]);
    a8[i] = fmaxf(s[4 * i + 2], s[4 * i + 3]);
  }
#pragma unroll
  for (int j = NP; j < R / 4; ++j) {
    a0[j % NP] = fmaxf(a0[j % NP], fmaxf(s[4 * j], s[4 * j + 1]));
    a8[j % NP] = fmaxf(a8[j % NP], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int w = NP / 2; w > 0; w /= 2)
#pragma unroll
    for (int i = 0; i < w; ++i) {
      a0[i] = fmaxf(a0[i], a0[i + w]);
      a8[i] = fmaxf(a8[i], a8[i + w]);
    }
  float mx0 = a0[0], mx8 = a8[0];
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx8 = fmaxf(mx8, __shfl_xor_sync(0xffffffffu, mx8, 1));
  mx8 = fmaxf(mx8, __shfl_xor_sync(0xffffffffu, mx8, 2));
  mx0 = fmaxf(m0, mx0 * scale_log2);
  mx8 = fmaxf(m8, mx8 * scale_log2);
  corr0 = exp2_approx(m0 - mx0);
  corr8 = exp2_approx(m8 - mx8);
  m0 = mx0;
  m8 = mx8;
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    s[4 * j] = exp2_approx(fmaf(s[4 * j], scale_log2, -mx0));
    s[4 * j + 1] = exp2_approx(fmaf(s[4 * j + 1], scale_log2, -mx0));
    s[4 * j + 2] = exp2_approx(fmaf(s[4 * j + 2], scale_log2, -mx8));
    s[4 * j + 3] = exp2_approx(fmaf(s[4 * j + 3], scale_log2, -mx8));
    const float p0 = s[4 * j] + s[4 * j + 1];
    const float p8 = s[4 * j + 2] + s[4 * j + 3];
    a0[j % NP] = j < NP ? p0 : a0[j % NP] + p0;
    a8[j % NP] = j < NP ? p8 : a8[j % NP] + p8;
  }
#pragma unroll
  for (int w = NP / 2; w > 0; w /= 2)
#pragma unroll
    for (int i = 0; i < w; ++i) {
      a0[i] += a0[i + w];
      a8[i] += a8[i + w];
    }
  l0 = l0 * corr0 + a0[0];   // the f32 p, as the TPU kernel sums it
  l8 = l8 * corr8 + a8[0];
}

template <typename TO, int DP>
__global__ void __launch_bounds__(THREADS<DP>, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, TO* __restrict__ o,
                 float* __restrict__ lse, int heads, int t_len, int d,
                 long long sb, long long st, long long sh,
                 float scale_log2) {
  constexpr int S = STAGES<DP>, NC = NWG<DP>, ROWS = BQ<DP>;
  constexpr int TILE = BK * DP * 2, PTILE = 64 * BK * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* qs = smem;
  unsigned char* ring = qs + ROWS * DP * 2;   // stage s: K at 2s, V at 2s+1
  unsigned char* pbuf = ring + S * 2 * TILE;  // p of each consumer
  uint64_t* bars = reinterpret_cast<uint64_t*>(pbuf + NC * PTILE);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;          // the K tile of a stage landed
  uint64_t* v_full = bars + 1 + S;      // its V tile landed
  uint64_t* empty = bars + 1 + 2 * S;   // every consumer is done with it

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int n = bh / heads, h = bh - n * heads;
  const int q0 = blockIdx.x * ROWS;
  const int n_tiles = t_len / BK;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < S; ++i) {
      mbar_init(&k_full[i], 1);
      mbar_init(&v_full[i], 1);
      mbar_init(&empty[i], NC * WG / 32);   // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid < WG) {
    // ---- producer warpgroup: one thread issues every load ----
    reg_dealloc<24>();
    if (tid == 0) {
      // Rows of the last q tile beyond T read as zeros; they are not stored.
      mbar_expect_tx(q_full, ROWS * DP * 2);
      tma_load_tile<DP>(qs, &tq, q_full, ROWS, h, q0, n);
      for (int it = 0; it < n_tiles; ++it) {
        const int i = it % S;
        if (it >= S) mbar_wait(&empty[i], ((it / S) - 1) & 1);
        mbar_expect_tx(&k_full[i], TILE);
        tma_load_tile<DP>(ring + 2 * i * TILE, &tk, &k_full[i], BK, h,
                          it * BK, n);
        mbar_expect_tx(&v_full[i], TILE);
        tma_load_tile<DP>(ring + (2 * i + 1) * TILE, &tv, &v_full[i], BK, h,
                          it * BK, n);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    // Software-pipelined: the products s = q.k^T of tile j and o += p.v of
    // tile j - 1 are issued together, and the softmax of tile j runs while
    // p.v is still on the tensor cores. p goes to this warpgroup's shared
    // tile (bf16) once p.v of tile j - 1 has read the previous one, which
    // keeps the registers free for a third consumer.
    if constexpr (NC == 3)
      reg_alloc<160>();
    else
      reg_alloc<240>();
    const int wg = tid / WG - 1;
    const int r0 = wg * 64;   // this warpgroup's rows in q
    const int lane = tid % 32;
    unsigned char* ps = pbuf + wg * PTILE;
    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    float m0 = NEG, m8 = NEG;   // running max (log2 units), rows g, g + 8
    float l0 = 0.f, l8 = 0.f;   // this thread's share of the row sums
    float s[BK / 2];            // rows g, g + 8 x keys 8 j + 2 c (+1)
    float corr0, corr8;
    mbar_wait(q_full, 0);

    mbar_wait(&k_full[0], 0);
    wg_fence();
    gemm_ss<BK, DP>(s, qs, ROWS, r0, ring, BK);
    wg_commit();
    wg_wait();
    fence_regs(s);
    online_softmax(s, m0, m8, l0, l8, scale_log2, corr0, corr8);
    store_a_tile<BK>(ps, s, tid);
    publish_to_wgmma(1 + wg);

    for (int it = 1; it < n_tiles; ++it) {
      const int i = it % S, ip = (it - 1) % S;
      mbar_wait(&k_full[i], (it / S) & 1);
      mbar_wait(&v_full[ip], ((it - 1) / S) & 1);
      wg_fence();
      gemm_ss<BK, DP>(s, qs, ROWS, r0, ring + 2 * i * TILE, BK);
      wg_commit();
      gemm_ss_mn<DP, BK>(acc, ps, ring + (2 * ip + 1) * TILE);
      wg_commit();
      wg_wait<1>();   // s is ready; p.v may still run
      fence_regs(s);
      online_softmax(s, m0, m8, l0, l8, scale_log2, corr0, corr8);
      wg_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[ip]);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        acc[4 * j] *= corr0;
        acc[4 * j + 1] *= corr0;
        acc[4 * j + 2] *= corr8;
        acc[4 * j + 3] *= corr8;
      }
      store_a_tile<BK>(ps, s, tid);
      publish_to_wgmma(1 + wg);
    }
    const int il = (n_tiles - 1) % S;
    mbar_wait(&v_full[il], ((n_tiles - 1) / S) & 1);
    wg_fence();
    gemm_ss_mn<DP, BK>(acc, ps, ring + (2 * il + 1) * TILE);
    wg_commit();
    wg_wait();
    fence_regs(acc);

    // Whole-row sums, then out = acc / denom in the output's type.
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l8 += __shfl_xor_sync(0xffffffffu, l8, 1);
    l8 += __shfl_xor_sync(0xffffffffu, l8, 2);
    const long long base = (long long)n * sb + (long long)h * sh;
    const int valid = t_len - (q0 + r0);   // rows of this warpgroup in T
    store_rows<TO, DP>(o + base + (long long)(q0 + r0) * st, st, d, acc,
                       1.f / l0, 1.f / l8, tid, valid);
    const int r = 16 * ((tid % WG) / 32) + lane / 4;
    if (lse != nullptr && (lane & 3) == 0) {
      float* out = lse + (long long)bh * t_len + q0 + r0 + r;
      if (r < valid) out[0] = (m0 + log2f(l0)) * LN2;
      if (r + 8 < valid) out[8] = (m8 + log2f(l8)) * LN2;
    }
  }
}

template <typename TO, int DP>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int batch, int heads, int t_len, int d, long long sb, long long st,
           long long sh, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, batch, heads, t_len, d, sb, st, sh, BQ<DP>) ||
      !make_map(&mk, k, batch, heads, t_len, d, sb, st, sh, BK) ||
      !make_map(&mv, v, batch, heads, t_len, d, sb, st, sh, BK))
    return (int)cudaErrorInvalidValue;
  constexpr size_t bytes = fwd_smem<DP>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<TO, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((t_len + BQ<DP> - 1) / BQ<DP>, batch * heads);
  flash_fwd_kernel<TO, DP><<<grid, THREADS<DP>, bytes, stream>>>(
      mq, mk, mv, (TO*)o, (float*)lse, heads, t_len, d, sb, st, sh,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v bf16; o bf16 or (is_f32) f32; lse [batch*heads, T] f32 or NULL.
extern "C" int mvi_flash_attn_fwd(const void* q, const void* k,
                                  const void* v, void* o, void* lse,
                                  int is_f32, int batch, int heads, int t_len,
                                  int d, long long sb, long long st,
                                  long long sh, float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || t_len <= 0 || t_len % BK != 0 || d <= 0 ||
      d > 128 || d % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= 64)
    return is_f32 ? launch<float, 64>(q, k, v, o, lse, batch, heads, t_len,
                                      d, sb, st, sh, scale, s)
                  : launch<__nv_bfloat16, 64>(q, k, v, o, lse, batch, heads,
                                              t_len, d, sb, st, sh, scale, s);
  return is_f32 ? launch<float, 128>(q, k, v, o, lse, batch, heads, t_len, d,
                                     sb, st, sh, scale, s)
                : launch<__nv_bfloat16, 128>(q, k, v, o, lse, batch, heads,
                                             t_len, d, sb, st, sh, scale, s);
}

// Dynamic shared memory of the forward kernel at padded head dim dp.
extern "C" int mvi_flash_attn_fwd_smem(int dp) {
  return dp <= 64 ? (int)fwd_smem<64>() : (int)fwd_smem<128>();
}
