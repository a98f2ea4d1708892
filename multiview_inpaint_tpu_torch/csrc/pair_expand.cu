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
// What bounds it on the H100: bytes. It reads 20 bytes per active
// gaussian (start, x0, y0, w; the counts follow from the starts and the
// total) and writes 8 bytes per pair, with no arithmetic to speak of, so
// its floor is (pairs*8 + actives*20) / 3.35 TB/s.
//
// What the design does about it: the stores are coalesced and every
// block does the same work. A block owns kSlots consecutive pair slots.
// Its threads first find the gaussians that own its first and last slot
// by one kWays-ary search over `starts` for both (each round the first
// kWays threads probe one start per slot and __syncthreads_count gives
// the interval: four rounds reach 16M gaussians), then stage the starts
// of that gaussian range in shared memory. Thread s of each pass takes
// the block's slot lo + s, finds its gaussian by a binary search over
// the staged starts (every active gaussian owns at least one slot, so
// they strictly increase; the thread's previous slot's owner bounds it
// from below) and writes that one key: consecutive threads store
// consecutive 8-byte keys. A rect of any size spreads over as many
// blocks as its slots fill. What holds it: each block's two searches and
// its per-slot binary search and gathers of x0, y0, w are chains of
// dependent loads, and a frame is only a few waves of blocks, so the
// latency shows. The first design, one thread per gaussian writing its
// own keys (the duplicateWithKeys shape of the CUDA reference), had
// stores strided by the owners' counts and, where a few gaussians own
// thousands of slots, threads that wrote them alone. The TPU kernel
// rebuilt every slot's owner through windowed indicator matmuls because
// TPU scatters serialise; the searches here do that job.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 2048;  // pair slots per block
constexpr int kWays = 64;     // probes per search round

// The owners of slots t0 <= t1 among the n active gaussians: the last
// whose start is <= each, by one kWays-ary search for both. Every thread
// of the block calls it and gets the same answer.
__device__ __forceinline__ void owners(const long long* __restrict__ starts,
                                       int n, long long t0, long long t1,
                                       int& g0, int& g1) {
  int a0 = 0, n0 = n, a1 = 0, n1 = n;
  const long long q = threadIdx.x;
  const bool probe = threadIdx.x < kWays;
  while (n0 > 1 || n1 > 1) {
    // Probes are non-decreasing in the thread, so the first k hold.
    const bool p0 = probe && starts[a0 + (int)(q * n0 / kWays)] <= t0;
    const bool p1 = probe && starts[a1 + (int)(q * n1 / kWays)] <= t1;
    const int k0 = __syncthreads_count(p0);
    const int k1 = __syncthreads_count(p1);
    const int e0 = k0 < kWays ? a0 + (int)((long long)k0 * n0 / kWays)
                              : a0 + n0;
    const int e1 = k1 < kWays ? a1 + (int)((long long)k1 * n1 / kWays)
                              : a1 + n1;
    a0 += (int)((long long)(k0 - 1) * n0 / kWays);
    a1 += (int)((long long)(k1 - 1) * n1 / kWays);
    n0 = e0 - a0;
    n1 = e1 - a1;
  }
  g0 = a0;
  g1 = a1;
}

__global__ void __launch_bounds__(kThreads)
expand_keys_kernel(const long long* __restrict__ starts,
                   const int* __restrict__ x0, const int* __restrict__ y0,
                   const int* __restrict__ w, int n_active, long long total,
                   int tiles_x, long long* __restrict__ keys) {
  __shared__ long long s_start[kSlots];
  const long long lo = (long long)blockIdx.x * kSlots;
  const long long hi = min(lo + kSlots, total);
  int g_lo, g_hi;
  owners(starts, n_active, lo, hi - 1, g_lo, g_hi);
  // At most kSlots gaussians: those between own whole slots of the range.
  const int ng = g_hi - g_lo + 1;
  for (int i = threadIdx.x; i < ng; i += kThreads)
    s_start[i] = starts[g_lo + i];
  __syncthreads();

  int a = 0;  // the owner of the thread's previous slot: a lower bound
  for (long long slot = lo + threadIdx.x; slot < hi; slot += kThreads) {
    // The last staged gaussian whose start is <= slot.
    int b = ng - 1;
    while (a < b) {
      const int mid = (a + b + 1) >> 1;
      if (s_start[mid] <= slot) a = mid; else b = mid - 1;
    }
    const int g = g_lo + a;
    const int local = (int)(slot - s_start[a]);
    const int width = w[g];
    const int q = local / width;
    const long long tile =
        (long long)(y0[g] + q) * tiles_x + x0[g] + (local - q * width);
    keys[slot] = (tile << 32) | (long long)g;
  }
}

}  // namespace

// `n_active` > 0 gaussians own `total` > 0 slots (else nothing runs).
extern "C" int mvi_expand_keys(const void* starts, const void* x0,
                               const void* y0, const void* w,
                               int n_active, long long total, int tiles_x,
                               void* keys, void* stream) {
  if (n_active > 0 && total > 0) {
    const long long grid = (total + kSlots - 1) / kSlots;
    expand_keys_kernel<<<(unsigned)grid, kThreads, 0,
                         (cudaStream_t)stream>>>(
        (const long long*)starts, (const int*)x0, (const int*)y0,
        (const int*)w, n_active, total, tiles_x, (long long*)keys);
  }
  return (int)cudaGetLastError();
}
