// Hopper machinery shared by the flash-attention forward (K4,
// flash_attn_fwd.cu) and backward (K5, flash_attn_bwd.cu): TMA tensor maps
// of the [B, T, H*D] projections, TMA loads into 128-byte-swizzled shared
// tiles, mbarrier rings, warpgroup register hand-over and the bf16 wgmma
// products (f32 accumulators) that read those tiles.
//
// Shared tiles. A [rows, D] operand lives in shared memory as DP / 64
// column blocks (DP = D padded to 64 or 128), each [rows][64] bf16: rows of
// 128 bytes, the 16-byte chunks of row r XOR-swizzled by r % 8 (TMA's
// SWIZZLE_128B), blocks 1024-byte aligned. TMA fills the columns beyond D
// with zeros, which add nothing to any product. The same tile serves as a
// K-major operand (rows are M or N, d is the reduction axis: q.k^T) and as
// an MN-major one (rows are the reduction axis, d is N: p.v, ds.k), so
// nothing is transposed by hand.
//
// Accumulators (m64nN, f32): thread t of a warpgroup, warp w = t / 32,
// g = lane / 4, c = lane % 4, holds d[4j + e] at row 16 w + g + 8 (e >= 2),
// column 8 j + 2 c + (e & 1). The accumulators of columns 16 kk ... +15 are
// exactly the A register fragment of k-step kk (a_frag below), so K5's p
// and ds go from one product to the next without leaving registers; K4
// stages p through a swizzled shared tile instead (store_a_tile), which
// frees the registers for a third consumer.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int WG = 128;           // threads of a warpgroup
constexpr int ATOM = 64;          // bf16 columns of one swizzled block
constexpr int ATOM_ROW = 128;     // bytes of one swizzled row

// ---- host: tensor maps -----------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, fetched once through the runtime
// (no link against libcuda).
inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 [batch, T, heads, d] tensor (element (n, h, t, i) at n*sb + h*sh +
// t*st + i) as a 4-D map (i, h, t, n) whose box is 64 columns x 1 head x
// `rows` rows, 128-byte swizzled; columns beyond d read as zeros.
inline bool make_map(CUtensorMap* map, const void* base, int batch,
                     int heads, int t_len, int d, long long sb, long long st,
                     long long sh, int rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)t_len, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {ATOM, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---- device: shared addresses, mbarriers, TMA ------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
// A wait that lasts ~10 s can only be a broken ring: it traps, so the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (!done) {
    if (clock64() - t0 > 20000000000ll) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// One [rows][64] block of a map at (column c0, head h, row t0, batch n).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int h, int t0,
                                         int n) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(h), "r"(t0), "r"(n)
      : "memory");
}

// All DP / 64 column blocks of `rows` rows (blocks of rows * 128 bytes).
template <int DP>
__device__ __forceinline__ void tma_load_tile(void* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int rows, int h,
                                              int t0, int n) {
#pragma unroll
  for (int c = 0; c < DP / ATOM; ++c)
    tma_load(static_cast<char*>(dst) + c * rows * ATOM_ROW, map, bar,
             c * ATOM, h, t0, n);
}

// `bytes` contiguous bytes (16-byte aligned, a multiple of 16).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- device: wgmma ---------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand at shared address `a`: lbo and
// sbo in bytes (K-major: sbo = 1024 between 8-row groups, lbo unused;
// MN-major: lbo between 64-column blocks, sbo = 1024 between 8-row groups
// of the reduction axis).
__device__ __forceinline__ uint64_t desc(uint32_t a, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((a & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major operand of `rows` rows in DP / 64 blocks: the descriptor of
// k-step kk (16 columns) of the 64 rows that start at row r0.
__device__ __forceinline__ uint64_t desc_k(const void* tile, int rows, int r0,
                                           int kk) {
  const uint32_t a = smem_addr(tile) + (kk >> 2) * rows * ATOM_ROW +
                     r0 * ATOM_ROW + (kk & 3) * 32;
  return desc(a, 16, 1024);
}

// MN-major operand of `rows` rows (the reduction axis) in blocks: the
// descriptor of k-step kk (rows 16 kk ... 16 kk + 15), N spanning blocks.
__device__ __forceinline__ uint64_t desc_mn(const void* tile, int rows,
                                            int kk) {
  return desc(smem_addr(tile) + kk * 16 * ATOM_ROW, rows * ATOM_ROW, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of products are in flight.
template <int N = 0>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 2^x on the special-function unit (subnormal results flush to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

#define MVI_F8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define MVI_F32(i) MVI_F8(i), MVI_F8(i + 8), MVI_F8(i + 16), MVI_F8(i + 24)

#define MVI_R32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define MVI_R64                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x N) (+)= A (64 x 16, K-major in shared) . B (16 x N, K-major in
// shared); `acc` 0 overwrites d.
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da,
                                       uint64_t db, int acc);

template <>
__device__ __forceinline__ void mma_ss<64>(float (&d)[32], uint64_t da,
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MVI_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : MVI_F32(0)
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void mma_ss<128>(float (&d)[64], uint64_t da,
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " MVI_R64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : MVI_F32(0), MVI_F32(32)
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x N) += A (64 x 16, K-major in shared) . B (16 x N, MN-major in
// shared).
template <int N>
__device__ __forceinline__ void mma_ss_mn(float (&d)[N / 2], uint64_t da,
                                          uint64_t db);

template <>
__device__ __forceinline__ void mma_ss_mn<64>(float (&d)[32], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MVI_R32
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : MVI_F32(0)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void mma_ss_mn<128>(float (&d)[64], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " MVI_R64
      ", %64, %65, p, 1, 1, 0, 1;\n}\n"
      : MVI_F32(0), MVI_F32(32)
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x N) += A (64 x 16 from registers) . B (16 x N, MN-major in shared).
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void mma_rs<64>(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MVI_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : MVI_F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void mma_rs<128>(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " MVI_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : MVI_F32(0), MVI_F32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef MVI_F8
#undef MVI_F32
#undef MVI_R32
#undef MVI_R64

// d = A (64 x K, K-major tile rows r0 ... r0 + 63) . B^T (B K-major, N
// rows): K / 16 products, committed as one group.
template <int N, int K>
__device__ __forceinline__ void gemm_ss(float (&d)[N / 2], const void* a,
                                        int a_rows, int r0, const void* b,
                                        int b_rows) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    mma_ss<N>(d, desc_k(a, a_rows, r0, kk), desc_k(b, b_rows, 0, kk),
              kk > 0);
}

// d += A (64 x K, K-major tile of 64 rows) . B (MN-major tile of K rows,
// the reduction axis).
template <int N, int K>
__device__ __forceinline__ void gemm_ss_mn(float (&d)[N / 2], const void* a,
                                           const void* b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    mma_ss_mn<N>(d, desc_k(a, 64, 0, kk), desc_mn(b, K, kk));
}

// d += A (64 x 16 kk-steps from registers) . B (MN-major tile of b_rows
// rows, the reduction axis).
template <int N, int KS>
__device__ __forceinline__ void gemm_rs(float (&d)[N / 2],
                                        const uint32_t (&a)[KS][4],
                                        const void* b, int b_rows) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) mma_rs<N>(d, a[kk], desc_mn(b, b_rows, kk));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo, low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulators of columns 16 kk ... 16 kk + 15, rounded to bf16, as the
// A register fragment of k-step kk.
template <int R>
__device__ __forceinline__ void a_frag(uint32_t (&a)[R / 8][4],
                                       const float (&d)[R]) {
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// The m64nR accumulator, rounded to bf16, into a K-major 128-byte-swizzled
// tile of 64 rows (R / 64 blocks of [64][64]) that wgmma then reads as A;
// the 8 row groups of a warp's store land in distinct banks.
template <int R>
__device__ __forceinline__ void store_a_tile(unsigned char* tile,
                                             const float (&d)[R / 2],
                                             int tid) {
  const int w = (tid % WG) / 32, lane = tid % 32;
  const int r = 16 * w + lane / 4, c = lane % 4;
#pragma unroll
  for (int j = 0; j < R / 8; ++j) {
    const int col = 8 * j + 2 * c;
    unsigned char* p = tile + (col / ATOM) * 64 * ATOM_ROW + r * ATOM_ROW +
                       ((((col % ATOM) / 8) ^ (r % 8)) * 16) + (col % 8) * 2;
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(d[4 * j], d[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(p + 8 * ATOM_ROW) =
        pack_bf16(d[4 * j + 2], d[4 * j + 3]);
  }
}

// Makes this thread's shared stores visible to wgmma, then waits for the
// other threads of its warpgroup (named barrier `id`).
__device__ __forceinline__ void publish_to_wgmma(int id) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(WG) : "memory");
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Writes the m64nDP accumulator (times `mul`, per row half) of the 64 rows
// at `out` to a [T, d] operand with row stride st: columns below d and the
// first `rows` rows only.
template <typename TO, int DP>
__device__ __forceinline__ void store_rows(TO* out, long long st, int d,
                                           const float (&acc)[DP / 2],
                                           float mul0, float mul8, int tid,
                                           int rows = 64) {
  const int w = (tid % WG) / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int r = 16 * w + g;
  TO* o0 = out + (long long)r * st;
  TO* o8 = o0 + 8 * st;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + 2 * c;
    if (col < d) {
      if (r < rows)
        store_pair(o0 + col, acc[4 * j] * mul0, acc[4 * j + 1] * mul0);
      if (r + 8 < rows)
        store_pair(o8 + col, acc[4 * j + 2] * mul8, acc[4 * j + 3] * mul8);
    }
  }
}

// Rounds `base` up to 1024 bytes, as the swizzled tiles need.
__device__ __forceinline__ unsigned char* align1024(unsigned char* base) {
  const uint32_t a = smem_addr(base);
  return base + ((1024 - (a & 1023)) & 1023);
}

}  // namespace
