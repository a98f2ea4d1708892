// K5: flash-attention backward (non-causal, unmasked) for Hopper (sm_90a).
//
// Replaces the TPU kernel multiview_inpaint_tpu/diffusion/flash_attention.py
// `_bwd_kernel` (via `_flash_bwd_impl`, the backward of `flash_mha`), which
// the SVD training path reaches through `attention_op.attention` for every
// long self-attention that carries a gradient: the ds1 spatial blocks
// ([B, T, H*D] = [14, 3072, 5*64] per video) and ds2 ([14, 768, 10*64]) of
// the ControlNet trunk and the UNet decoder.
//
// What it computes, per head, from q, k, v, dO (bf16: the wrapper casts the
// cotangent to the input type, and f32 operands to bf16 once), the
// forward's row logsumexp lse and delta = rowsum(dO*O) (both [B*H, T] f32):
//   p  = exp(s * scale - lse),  s = q.k^T (f32 sums of bf16 products)
//   dv = sum over queries of bf16(p)^T . dO
//   dp = dO . v^T
//   ds = bf16(p * (dp - delta) * scale)
//   dk = sum over queries of ds^T . q,   dq = sum over keys of ds . k
// with f32 accumulators written in the output type at the end (bf16, or f32
// for f32 inputs; dq too: the TPU kernel's f32 dq is cast once at the end).
//
// What bounds it on the H100: operations. Five products of 2*T*T*D FLOP per
// head (s, dp, dv, dk, dq) on the bf16 tensor cores (989 TFLOP/s) and T*T
// exponentials; its bytes (q, k, v, dO, dq, dk, dv once each) are ~100x
// fewer than the card's balance point at the SVD shapes. Only wgmma reaches
// the tensor cores' full rate, and it needs its operands in shared memory
// in time.
//
// What the design does about it (no atomics, so runs repeat bit for bit):
// two kernels, each a block of three warpgroups. Warpgroup 0 is the
// producer: it gives up its registers (setmaxnreg) and one thread issues
// TMA loads of the block's resident tiles and then streams tiles through a
// ring of STAGES shared-memory stages tracked by mbarriers. Warpgroups 1
// and 2 run the wgmma products, 64 rows each, with f32 accumulators; while
// one computes p and ds, the other's products can use the tensor cores.
//   1. dkdv, one block per (head, 128 keys): k and v loaded once; 64-query
//      tiles of q and dO, with their lse and delta (bulk copies), stream
//      through the ring. s^T = k.q^T and dp^T = v.dO^T are SS products
//      (m64 n64, K-major); p^T and ds^T are computed in f32 registers and
//      rounded to bf16 A fragments; dv += p^T.dO and dk += ds^T.q are RS
//      products that read dO and q MN-major from the same tiles.
//   2. dq, one block per (head, 128 queries): q, dO, lse and delta loaded
//      once; 64-key tiles of k and v stream through the ring. s and dp are
//      SS products, dq += ds.k an RS product with the k tile read MN-major.
// The dq pass recomputes s and dp (seven products in all against the TPU
// kernel's five), the price of keeping dq free of unordered atomics.
//
// Addressing: element (n, h, t, i) of q, k, v, dO, dq, dk and dv lies at
// n*sb + h*sh + t*st + i (the packed [B, T, H*D] layout, seen by TMA as a
// 4-D tensor (D, H, T, B), or a folded [B*H, T, D] one with heads = 1);
// lse and delta at (n*heads + h)*T + t. T must be a multiple of 128, D one
// of 16 ... 128 in steps of 16 (64 or 128 columns in shared memory).

#include "flash_attn_common.cuh"

namespace {

constexpr int BR = 128;      // resident rows per block (keys, or queries)
constexpr int BS = 64;       // rows per streamed tile (queries, or keys)
constexpr int STAGES = 2;
constexpr int THREADS = 3 * WG;
constexpr int CONSUMER_WARPS = 2 * WG / 32;

template <int DP>
constexpr size_t dkdv_smem() {  // k, v; ring of q, dO; lse, delta; barriers
  return (size_t)2 * BR * DP * 2 + (size_t)STAGES * 2 * BS * DP * 2 +
         (size_t)STAGES * 2 * BS * 4 + (1 + 2 * STAGES) * 8 + 1024;
}
template <int DP>
constexpr size_t dq_smem() {    // q, dO, lse, delta; ring of k, v; barriers
  return (size_t)2 * BR * DP * 2 + 2 * BR * 4 +
         (size_t)STAGES * 2 * BS * DP * 2 + (1 + 2 * STAGES) * 8 + 1024;
}

__device__ __forceinline__ void init_ring(uint64_t* bars) {
  mbar_init(bars, 1);
  for (int s = 0; s < STAGES; ++s) {
    mbar_init(&bars[1 + s], 1);
    mbar_init(&bars[1 + STAGES + s], CONSUMER_WARPS);
  }
  mbar_fence_init();
}

template <typename TO, int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, TO* __restrict__ dk,
                      TO* __restrict__ dv, int heads, int t_len, int d,
                      long long sb, long long st, long long sh,
                      float scale_log2, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  constexpr int RES = BR * DP * 2, TILE = BS * DP * 2;
  unsigned char* ks = smem;
  unsigned char* vs = ks + RES;
  unsigned char* ring = vs + RES;   // stage s: q at 2s, dO at 2s + 1
  float* rows = reinterpret_cast<float*>(ring + STAGES * 2 * TILE);
  uint64_t* bars = reinterpret_cast<uint64_t*>(rows + STAGES * 2 * BS);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int n = bh / heads, h = bh - n * heads;
  const int k0 = blockIdx.x * BR;
  const int n_tiles = t_len / BS;

  if (tid == 0) init_ring(bars);
  __syncthreads();

  if (tid < WG) {
    reg_dealloc<24>();
    if (tid == 0) {
      mbar_expect_tx(kv_full, 2 * RES);
      tma_load_tile<DP>(ks, &tk, kv_full, BR, h, k0, n);
      tma_load_tile<DP>(vs, &tv, kv_full, BR, h, k0, n);
      const float* lse_bh = lse + (long long)bh * t_len;
      const float* dl_bh = delta + (long long)bh * t_len;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * TILE + 2 * BS * 4);
        tma_load_tile<DP>(ring + 2 * s * TILE, &tq, &full[s], BS, h,
                          it * BS, n);
        tma_load_tile<DP>(ring + (2 * s + 1) * TILE, &tdo, &full[s], BS, h,
                          it * BS, n);
        bulk_load(rows + 2 * s * BS, lse_bh + it * BS, BS * 4, &full[s]);
        bulk_load(rows + (2 * s + 1) * BS, dl_bh + it * BS, BS * 4,
                  &full[s]);
      }
    }
  } else {
    reg_alloc<240>();
    const int r0 = (tid / WG - 1) * 64;   // this warpgroup's keys in k, v
    const int lane = tid % 32, c = lane & 3;
    float adk[DP / 2], adv[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) adk[i] = adv[i] = 0.f;
    mbar_wait(kv_full, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int s_idx = it % STAGES;
      const unsigned char* qt = ring + 2 * s_idx * TILE;
      const unsigned char* dot = qt + TILE;
      const float* lse_s = rows + 2 * s_idx * BS;
      const float* dl_s = lse_s + BS;
      mbar_wait(&full[s_idx], (it / STAGES) & 1);

      // s^T and dp^T: this warpgroup's 64 keys (rows) x the 64 queries.
      float s[BS / 2], dp[BS / 2];
      wg_fence();
      gemm_ss<BS, DP>(s, ks, BR, r0, qt, BS);
      gemm_ss<BS, DP>(dp, vs, BR, r0, dot, BS);
      wg_commit();
      wg_wait();
      fence_regs(s);
      fence_regs(dp);

      // p^T = exp2(s^T scale log2 e - lse log2 e), ds^T = p^T (dp^T -
      // delta) scale, per query column 8 j + 2 c (+1).
#pragma unroll
      for (int j = 0; j < BS / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * j + 2 * c + (e & 1);
          const float p = exp2_approx(
              fmaf(s[4 * j + e], scale_log2, -(lse_s[qi] * LOG2E)));
          s[4 * j + e] = p;
          dp[4 * j + e] = p * (dp[4 * j + e] - dl_s[qi]) * scale;
        }
      }
      uint32_t pa[BS / 16][4], da[BS / 16][4];
      a_frag(pa, s);
      a_frag(da, dp);
      wg_fence();
      gemm_rs<DP, BS / 16>(adv, pa, dot, BS);
      gemm_rs<DP, BS / 16>(adk, da, qt, BS);
      wg_commit();
      wg_wait();
      fence_regs(adv);
      fence_regs(adk);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s_idx]);
    }

    const long long off = (long long)n * sb + (long long)h * sh +
                          (long long)(k0 + r0) * st;
    store_rows<TO, DP>(dk + off, st, d, adk, 1.f, 1.f, tid);
    store_rows<TO, DP>(dv + off, st, d, adv, 1.f, 1.f, tid);
  }
}

template <typename TO, int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, TO* __restrict__ dq,
                    int heads, int t_len, int d, long long sb, long long st,
                    long long sh, float scale_log2, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  constexpr int RES = BR * DP * 2, TILE = BS * DP * 2;
  unsigned char* qs = smem;
  unsigned char* dos = qs + RES;
  unsigned char* ring = dos + RES;   // stage s: k at 2s, v at 2s + 1
  float* rows = reinterpret_cast<float*>(ring + STAGES * 2 * TILE);
  uint64_t* bars = reinterpret_cast<uint64_t*>(rows + 2 * BR);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int n = bh / heads, h = bh - n * heads;
  const int q0 = blockIdx.x * BR;
  const int n_tiles = t_len / BS;

  if (tid == 0) init_ring(bars);
  __syncthreads();

  if (tid < WG) {
    reg_dealloc<24>();
    if (tid == 0) {
      mbar_expect_tx(q_full, 2 * RES + 2 * BR * 4);
      tma_load_tile<DP>(qs, &tq, q_full, BR, h, q0, n);
      tma_load_tile<DP>(dos, &tdo, q_full, BR, h, q0, n);
      bulk_load(rows, lse + (long long)bh * t_len + q0, BR * 4, q_full);
      bulk_load(rows + BR, delta + (long long)bh * t_len + q0, BR * 4,
                q_full);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * TILE);
        tma_load_tile<DP>(ring + 2 * s * TILE, &tk, &full[s], BS, h,
                          it * BS, n);
        tma_load_tile<DP>(ring + (2 * s + 1) * TILE, &tv, &full[s], BS, h,
                          it * BS, n);
      }
    }
  } else {
    reg_alloc<240>();
    const int r0 = (tid / WG - 1) * 64;   // this warpgroup's queries
    const int lane = tid % 32;
    const int row = r0 + 16 * ((tid % WG) / 32) + lane / 4;
    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    mbar_wait(q_full, 0);
    const float l2_0 = rows[row] * LOG2E, l2_8 = rows[row + 8] * LOG2E;
    const float dl0 = rows[BR + row], dl8 = rows[BR + row + 8];

    for (int it = 0; it < n_tiles; ++it) {
      const int s_idx = it % STAGES;
      const unsigned char* kt = ring + 2 * s_idx * TILE;
      const unsigned char* vt = kt + TILE;
      mbar_wait(&full[s_idx], (it / STAGES) & 1);

      // s and dp: this warpgroup's 64 queries x the 64 keys.
      float s[BS / 2], dp[BS / 2];
      wg_fence();
      gemm_ss<BS, DP>(s, qs, BR, r0, kt, BS);
      gemm_ss<BS, DP>(dp, dos, BR, r0, vt, BS);
      wg_commit();
      wg_wait();
      fence_regs(s);
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < BS / 2; ++i) {
        const bool hi = (i & 2) != 0;   // row g + 8
        const float p =
            exp2_approx(fmaf(s[i], scale_log2, -(hi ? l2_8 : l2_0)));
        dp[i] = p * (dp[i] - (hi ? dl8 : dl0)) * scale;
      }
      uint32_t da[BS / 16][4];
      a_frag(da, dp);
      wg_fence();
      gemm_rs<DP, BS / 16>(acc, da, kt, BS);
      wg_commit();
      wg_wait();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s_idx]);
    }

    const long long off = (long long)n * sb + (long long)h * sh +
                          (long long)(q0 + r0) * st;
    store_rows<TO, DP>(dq + off, st, d, acc, 1.f, 1.f, tid);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename TO, int DP>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk, void* dv,
           int batch, int heads, int t_len, int d, long long sb, long long st,
           long long sh, float scale, cudaStream_t stream) {
  // Maps with resident (BR) and streamed (BS) boxes.
  CUtensorMap q_r, do_r, k_r, v_r, q_s, do_s, k_s, v_s;
  const void* src[4] = {q, k, v, dout};
  CUtensorMap* res[4] = {&q_r, &k_r, &v_r, &do_r};
  CUtensorMap* str[4] = {&q_s, &k_s, &v_s, &do_s};
  for (int i = 0; i < 4; ++i)
    if (!make_map(res[i], src[i], batch, heads, t_len, d, sb, st, sh, BR) ||
        !make_map(str[i], src[i], batch, heads, t_len, d, sb, st, sh, BS))
      return (int)cudaErrorInvalidValue;
  constexpr size_t s1 = dkdv_smem<DP>(), s2 = dq_smem<DP>();
  cudaError_t e = allow_smem(flash_bwd_dkdv_kernel<TO, DP>, s1);
  if (e == cudaSuccess) e = allow_smem(flash_bwd_dq_kernel<TO, DP>, s2);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(t_len / BR, batch * heads);
  const float sl = scale * LOG2E;
  flash_bwd_dkdv_kernel<TO, DP><<<grid, THREADS, s1, stream>>>(
      q_s, k_r, v_r, do_s, lse, delta, (TO*)dk, (TO*)dv, heads, t_len, d, sb,
      st, sh, sl, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_kernel<TO, DP><<<grid, THREADS, s2, stream>>>(
      q_r, k_s, v_s, do_r, lse, delta, (TO*)dq, heads, t_len, d, sb, st, sh,
      sl, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, dout bf16; dq, dk, dv bf16 or (is_f32) f32; lse, delta
// [batch*heads, T] f32.
extern "C" int mvi_flash_attn_bwd(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dq, void* dk,
                                  void* dv, int is_f32, int batch, int heads,
                                  int t_len, int d, long long sb,
                                  long long st, long long sh, float scale,
                                  void* stream) {
  if (batch <= 0 || heads <= 0 || t_len <= 0 || t_len % BR != 0 || d <= 0 ||
      d > 128 || d % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* dl = (const float*)delta;
#define MVI_BWD(TO, DP)                                                     \
  launch<TO, DP>(q, k, v, dout, l, dl, dq, dk, dv, batch, heads, t_len, d, \
                 sb, st, sh, scale, s)
  if (d <= 64)
    return is_f32 ? MVI_BWD(float, 64) : MVI_BWD(__nv_bfloat16, 64);
  return is_f32 ? MVI_BWD(float, 128) : MVI_BWD(__nv_bfloat16, 128);
#undef MVI_BWD
}

// Dynamic shared memory of the dk/dv (which 0) or dq (1) kernel at padded
// head dim dp.
extern "C" int mvi_flash_attn_bwd_smem(int which, int dp) {
  if (which == 0) return dp <= 64 ? (int)dkdv_smem<64>() : (int)dkdv_smem<128>();
  return dp <= 64 ? (int)dq_smem<64>() : (int)dq_smem<128>();
}
