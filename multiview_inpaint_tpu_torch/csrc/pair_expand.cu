// K1: gaussian-tile pair-key expansion for Hopper (sm_90a).
//
// Replaces the TPU kernel multiview_inpaint_tpu/ops/rasterizer/pair_expand.py
// `_kernel` (via `expand_keys`, called from
// `binning.bin_gaussians(expand_kernel=True)`).
//
// What it computes: the depth-rank-compacted rect table holds the
// `n_active` pair-emitting gaussians first; gaussian g owns pair slots
// starts[g] .. starts[g] + count[g] and writes there, in row-major order
// over its tile rect (x0, y0, width w, count = w*h), the int64 key
// `tile << 32 | g`. A torch.sort of the keys then groups pairs by tile
// in depth order (the sort was `lax.sort`, outside any kernel, on the TPU
// as well).
//
// What bounds it on the H100: bytes. It reads ~32 bytes per active
// gaussian and writes 8 bytes per pair, with no arithmetic to speak of,
// so its floor is (pairs*8 + actives*32) / 3.35 TB/s.
//
// What the design does about it: one thread per active gaussian (the
// duplicateWithKeys shape of the CUDA reference) writes its pairs with no
// search, no window and no atomics; the TPU kernel had to rebuild every
// slot's owner through windowed indicator matmuls because TPU scatters
// serialise. Rects are small (1-4 tiles on typical scenes), so a thread's
// writes are short runs; the grid-stride loop keeps every SM busy at any
// gaussian count. Coalescing the key stores (one warp per gaussian, or a
// block-wide exclusive scan) is left to the work that makes it fast.

#include <cuda_runtime.h>

namespace {

__global__ void expand_keys_kernel(const long long* __restrict__ starts,
                                   const int* __restrict__ x0,
                                   const int* __restrict__ y0,
                                   const int* __restrict__ w,
                                   const long long* __restrict__ count,
                                   int n_active, int tiles_x,
                                   long long* __restrict__ keys) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < n_active; g += stride) {
    const int width = w[g];
    const int rows = (int)(count[g] / width);
    const long long rank = g;
    long long* dst = keys + starts[g];
    for (int q = 0; q < rows; ++q) {
      const long long tile0 = (long long)(y0[g] + q) * tiles_x + x0[g];
      for (int r = 0; r < width; ++r) {
        *dst++ = ((tile0 + r) << 32) | rank;
      }
    }
  }
}

}  // namespace

extern "C" int mvi_expand_keys(const void* starts, const void* x0,
                               const void* y0, const void* w,
                               const void* count, int n_active, int tiles_x,
                               void* keys, void* stream) {
  if (n_active > 0) {
    const int block = 256;
    int grid = (n_active + block - 1) / block;
    if (grid > 132 * 32) grid = 132 * 32;  // grid-stride beyond this
    expand_keys_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const long long*)starts, (const int*)x0, (const int*)y0,
        (const int*)w, (const long long*)count, n_active, tiles_x,
        (long long*)keys);
  }
  return (int)cudaGetLastError();
}
