// Standalone 1-WTA lateral inhibition for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_wta_kernel` in src/repro/kernels/wta.py
// (built by `wta_pallas`, entered through `ops.wta`). The plain PyTorch version,
// the ctypes wrapper and the tile plan are in src/repro_torch/kernels/wta.py.
//
// What it computes, per row r of z (R, q) int32:
//   key_j = z_j * q + j;  winner = min_j key_j  (earliest spike, ties to the
//   lowest index);  out_j = z_j if key_j == winner and z_j < T, else T.
//
// Bound on this card (H100 SXM, 3.35 TB/s): bytes. It reads and writes
// 4 * R * q bytes each way and does about 3 integer operations per element.
//
// Design: a block of `threads` threads takes a tile of `tile` rows (a
// multiple of 4; the wrapper cuts the served shape into about 8 small
// blocks per SM, all resident at once, since the kernel is a latency chain
// of copy in, WTA, copy out), one contiguous range of tile * q words.
//  * In: one 1-D bulk copy (TMA) of the range into shared memory, completing
//    on an mbarrier; where the range is not 16-byte aligned (q odd and a view
//    that starts mid-row, or a short last tile) every thread issues coalesced
//    4-byte cp.async copies that arrive on the same mbarrier instead.
//  * Compute: a group of G lanes per row, G a power of two up to 32 (the
//    wrapper takes the one >= q / 4, so about 4 words a lane; 32 / G rows per
//    warp); lane l reads the row's words l, l + G, ... from shared memory,
//    takes the minimum key, and the group's minimum comes from log2(G) xor
//    shuffles. For q = 12 a warp's 8 rows of 4 lanes read 32 distinct banks.
//    Each lane then writes its words' results back in place.
//  * Out: one bulk store of the range (`cp.async.bulk.global.shared::cta`),
//    or coalesced 4-byte stores where it is not 16-byte aligned.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "tnn_async.cuh"

#define TNN_WTA_MAX_THREADS 1024
#define TNN_WTA_MAX_Q 128
#define TNN_WTA_MAX_TILE_BYTES 16384

__global__ void __launch_bounds__(TNN_WTA_MAX_THREADS)
tnn_wta_kernel(const int32_t* __restrict__ z, int32_t* __restrict__ out,
               long long rows, int q, int T, int tile, int G) {
  extern __shared__ __align__(16) int32_t zs[];
  __shared__ uint64_t bar;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const long long r0 = (long long)blockIdx.x * tile;
  const int nrows = (int)min((long long)tile, rows - r0);
  const int n = nrows * q;
  const int32_t* src = z + r0 * q;
  int32_t* dst = out + r0 * q;
  const uint32_t bytes = 4u * n;
  const bool bulk_in = (((unsigned long long)src | bytes) & 15) == 0;
  const bool bulk_out = (((unsigned long long)dst | bytes) & 15) == 0;

  if (tid == 0) tnn_mbar_init(&bar, bulk_in ? 1 : nthr);
  __syncthreads();
  if (bulk_in) {
    if (tid == 0) {
      tnn_mbar_expect_tx(&bar, bytes);
      tnn_bulk_load(zs, src, bytes, &bar);
    }
  } else {
    for (int e = tid; e < n; e += nthr) tnn_cp_async4(zs + e, src + e);
    tnn_cp_async_arrive(&bar);
  }
  tnn_mbar_wait(&bar, 0);

  const int lane = tid & 31, per_warp = 32 / G;
  const int g = lane / G, l = lane - g * G;
  for (int rb = (tid >> 5) * per_warp; rb < nrows; rb += (nthr >> 5) * per_warp) {
    const int r = rb + g;
    const bool live = r < nrows;
    int32_t* zr = zs + r * q;
    int best = INT_MAX;
    if (live)
      for (int j = l; j < q; j += G) best = min(best, zr[j] * q + j);
    for (int off = G >> 1; off > 0; off >>= 1)
      best = min(best, __shfl_xor_sync(0xffffffffu, best, off));
    if (live)
      for (int j = l; j < q; j += G) {
        const int zj = zr[j];
        zr[j] = (zj * q + j == best && zj < T) ? zj : T;
      }
  }

  if (bulk_out) {
    tnn_fence_async_smem();
    __syncthreads();
    if (tid == 0) tnn_bulk_store(dst, zs, bytes);
  } else {
    __syncthreads();
    for (int e = tid; e < n; e += nthr) dst[e] = zs[e];
  }
}

extern "C" {

// Enqueue the WTA of `rows` rows of q on `stream`: `tile` rows per block of
// `threads` threads, `group` lanes per row (a power of two, at most 32);
// returns cudaGetLastError().
int tnn_wta_launch(const int32_t* z, int32_t* out, long long rows, int q, int T,
                   int tile, int threads, int group, void* stream) {
  if (rows < 1 || q < 1 || q > TNN_WTA_MAX_Q || tile < 4 || tile % 4 ||
      (long long)tile * q * 4 > TNN_WTA_MAX_TILE_BYTES || threads < 32 ||
      threads % 32 || threads > TNN_WTA_MAX_THREADS || group < 1 ||
      group > 32 || (group & (group - 1)))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (rows + tile - 1) / tile;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  tnn_wta_kernel<<<(unsigned)blocks, threads, (size_t)tile * q * 4,
                   (cudaStream_t)stream>>>(z, out, rows, q, T, tile, group);
  return (int)cudaGetLastError();
}

const char* tnn_wta_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
