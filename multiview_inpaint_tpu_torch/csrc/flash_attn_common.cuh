// Helpers shared by the flash-attention forward (K4, flash_attn_fwd.cu) and
// backward (K5, flash_attn_bwd.cu): bf16 packing, loads and stores that
// round f32 to bf16 as they stage, and the bf16 m16n8k16 tensor-core
// product with an f32 accumulator.
//
// Fragment layout of mma.sync m16n8k16 (g = lane / 4, tig = lane % 4):
// A (16 x 16, row): a0 = (row g, cols 2 tig, 2 tig + 1), a1 = (row g + 8,
// same cols), a2 = (row g, cols 2 tig + 8, + 9), a3 = (row g + 8, same);
// B (16 x 8, col): b0 = (rows 2 tig, 2 tig + 1, col g), b1 = (rows
// 2 tig + 8, + 9, col g); C (16 x 8): c0, c1 = (row g, cols 2 tig, + 1),
// c2, c3 = (row g + 8, same cols). The accumulators of two neighbouring
// 8-column C tiles are therefore exactly one 16-column A fragment.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo, low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two consecutive elements (an even column) as one bf16 pair.
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t load_pair(const float* p) {
  const float2 f = *reinterpret_cast<const float2*>(p);
  return pack_bf16(f.x, f.y);
}

// Eight consecutive elements (16-byte aligned) as eight bf16.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ uint4 load8(const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  return make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                    pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// d += a (16x16, row) * b (16x8, col), bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragments of 16 rows (row0 + g, row0 + g + 8) of a [T, D] operand
// read from global memory with row stride st: frag[kk] covers columns
// 16 kk ... 16 kk + 15.
template <typename T, int D>
__device__ __forceinline__ void load_a_rows(uint32_t (&frag)[D / 16][4],
                                            const T* rows, long long st,
                                            int g, int tig) {
  const T* r0 = rows + (long long)g * st;
  const T* r8 = r0 + 8 * st;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + tig * 2;
    frag[kk][0] = load_pair(r0 + c);
    frag[kk][1] = load_pair(r8 + c);
    frag[kk][2] = load_pair(r0 + c + 8);
    frag[kk][3] = load_pair(r8 + c + 8);
  }
}

}  // namespace
