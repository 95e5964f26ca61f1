// Standalone 1-WTA lateral inhibition for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_wta_kernel` in src/repro/kernels/wta.py
// (built by `wta_pallas`, entered through `ops.wta`). The plain PyTorch version
// and the ctypes wrapper are in src/repro_torch/kernels/wta.py.
//
// What it computes, per row r of z (R, q) int32:
//   key_j = z_j * q + j;  winner = min_j key_j  (earliest spike, ties to the
//   lowest index);  out_j = z_j if key_j == winner and z_j < T, else T.
//
// Bound on this card (H100 SXM, 3.35 TB/s): bytes. It reads and writes
// 4 * R * q bytes each way and does about 3 integer operations per element.
//
// Design: one thread per row, q <= 128 in a loop, two passes over the row
// (the second reads it again from L1). A row's q words are contiguous, so
// one warp touches 32 neighbouring rows: every byte of z is read from device
// memory once. Simple and right first; a warp per row, with coalesced loads,
// is later work if a caller ever puts this kernel on a hot path (no entry
// point does: the column kernel fuses its own WTA).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#define TNN_WTA_THREADS 256

__global__ void __launch_bounds__(TNN_WTA_THREADS)
tnn_wta_kernel(const int32_t* __restrict__ z, int32_t* __restrict__ out,
               long long rows, int q, int T) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const int32_t* zr = z + r * q;
  int32_t* orow = out + r * q;
  int best = INT_MAX;
  for (int j = 0; j < q; ++j) best = min(best, zr[j] * q + j);
  for (int j = 0; j < q; ++j) {
    const int zj = zr[j];
    orow[j] = (zj * q + j == best && zj < T) ? zj : T;
  }
}

extern "C" {

// Enqueue the WTA of `rows` rows of q on `stream`; returns cudaGetLastError().
int tnn_wta_launch(const int32_t* z, int32_t* out, long long rows, int q, int T,
                   void* stream) {
  if (rows < 1 || q < 1 || q > 128) return (int)cudaErrorInvalidValue;
  const long long blocks = (rows + TNN_WTA_THREADS - 1) / TNN_WTA_THREADS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  tnn_wta_kernel<<<(unsigned)blocks, TNN_WTA_THREADS, 0, (cudaStream_t)stream>>>(
      z, out, rows, q, T);
  return (int)cudaGetLastError();
}

const char* tnn_wta_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
