// Per-layer TNN column forward for Hopper (sm_90a): RNL accumulate, threshold
// crossing and optional 1-WTA for every column of a layer, in ONE launch.
//
// Replaces the Pallas TPU kernel `_column_kernel` in
// src/repro/kernels/tnn_column.py (built by `column_forward_pallas`, entered
// through `ops.column_forward` and `ops.layer_forward_fused`, which vmaps it
// over the layer's columns), together with the bodies it calls, `ramp_matmul`
// and `crossing_wta`. The plain PyTorch version and the ctypes wrapper are in
// src/repro_torch/kernels/tnn_column.py.
//
// What it computes, per site c, batch row b and neuron j:
//   V[t, j] = sum_i min(max(t - x[b, c, i], 0), w[c, i, j])   (int32, t < T)
//   z_j     = first t with V[t, j] >= theta, else T
//   1-WTA   (when wta) keep the minimum of the key z_j * q + j (earliest
//           spike, ties to the lowest index) if it is < T * q; every other
//           neuron gets T
// The integer ramp sum (tnn_common.cuh) equals the reference's f32-accumulated
// bf16 A@N 0/1 product exactly, for any p.
//
// Bound on this card (H100 SXM, 3.35 TB/s, 67 TFLOP/s float32 rate used for
// the 32-bit integer work): operations. At the serving shape (625 sites, B=64,
// layer 1 p=32 q=12) the layer moves about 3.4 MB (x and w in, int32 z out,
// about 1 us) but does a min and an add per synapse per tick up to each
// neuron's crossing: up to 246 M integer ops (about 3.7 us), a data-dependent
// count that chip_smoke.py takes from the run's data.
//
// Design.
//  * Grid: (site, chunk of `rows` batch rows). The TPU kernel walks synapse
//    tiles as a sequential grid axis with an f32 VMEM accumulator; here a
//    thread owns one (row, neuron) pair and walks all p synapses itself, so no
//    accumulator crosses blocks and any p is taken in one launch.
//  * One thread per (row, neuron): q times the parallelism of one thread per
//    row, enough blocks to fill 132 SMs at the serving shape. Each thread stops
//    at its neuron's crossing.
//  * Shared memory holds the chunk's volleys, [row][synapse], read through the
//    caller's strides (no transposes or padding around the launch), and the
//    site's p*q int8 weights when they fit; beyond that (p*q over about 220 KB)
//    the weights are read from device memory through the same pointer type.
//  * WTA: each thread writes its crossing time to shared memory, then reads
//    its row's q times and keeps its own only if it holds the minimum key.
//  * A ragged last chunk is masked; nothing is padded.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "tnn_common.cuh"

#define TNN_COLUMN_MAX_THREADS 256

extern "C" {

// Must match `_ColumnArgs` in tnn_column.py field for field.
struct ColumnArgs {
  const uint8_t* x;              // (B, C, p) spike times, strided
  long long x_sb, x_sc, x_si;    // element strides of x
  const int8_t* w;               // (C, p, q) contiguous
  int32_t* z;                    // (B, C, q) contiguous
  int B, C, p, q, T, theta, wta;
  int rows;                      // batch rows per block; rows * q threads
  int w_smem;                    // 1: stage the site's weights in shared memory
};

}  // extern "C"

__host__ __device__ static inline int col_round16(int n) { return (n + 15) & ~15; }

__host__ __device__ static inline size_t col_smem_bytes(const ColumnArgs& a) {
  return (size_t)a.rows * a.q * 4 + col_round16(a.rows * a.p) +
         (a.w_smem ? (size_t)a.p * a.q : 0);
}

__global__ void __launch_bounds__(TNN_COLUMN_MAX_THREADS)
tnn_column_kernel(const __grid_constant__ ColumnArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.x;
  const int P = a.p, Q = a.q, R = a.rows, T = a.T;
  const int b0 = blockIdx.y * R;
  const int nrows = min(R, a.B - b0);
  const int tid = threadIdx.x, nthr = blockDim.x;
  int* zpre = reinterpret_cast<int*>(smem);                  // [row][neuron]
  uint8_t* xs = smem + (size_t)R * Q * 4;                      // [row][synapse]
  int8_t* ws = reinterpret_cast<int8_t*>(xs + col_round16(R * P));
  const int8_t* wg = a.w + (size_t)c * P * Q;

  if (a.w_smem)
    for (int k = tid; k < P * Q; k += nthr) ws[k] = wg[k];
  for (int k = tid; k < nrows * P; k += nthr) {
    const int r = k / P, i = k - r * P;
    xs[k] = a.x[(long long)(b0 + r) * a.x_sb + (long long)c * a.x_sc +
                (long long)i * a.x_si];
  }
  __syncthreads();

  const int r = tid / Q, j = tid - r * Q;
  const bool live = r < nrows;
  const int8_t* wsrc = a.w_smem ? ws : wg;
  int zj = T;
  if (live) {
    zj = tnn_crossing(xs + r * P, 1, wsrc + j, Q, P, T, a.theta);
    zpre[r * Q + j] = zj;
  }
  if (a.wta) {
    __syncthreads();
    if (live) {
      int best = INT_MAX;
      for (int k = 0; k < Q; ++k) best = min(best, zpre[r * Q + k] * Q + k);
      if (!(zj * Q + j == best && zj < T)) zj = T;
    }
  }
  if (live) a.z[((long long)(b0 + r) * a.C + c) * Q + j] = zj;
}

extern "C" {

// Dynamic shared memory one launch with these arguments needs.
size_t tnn_column_smem_bytes(const ColumnArgs* a) { return col_smem_bytes(*a); }

// Enqueue one layer on `stream`; returns cudaGetLastError() (0 = launched).
int tnn_column_launch(const ColumnArgs* a, void* stream) {
  if (a->B < 1 || a->C < 1 || a->p < 1 || a->q < 1 || a->q > 128 ||
      a->rows < 1 || a->rows * a->q > TNN_COLUMN_MAX_THREADS ||
      (a->B + a->rows - 1) / a->rows > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = col_smem_bytes(*a);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        tnn_column_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(a->C, (a->B + a->rows - 1) / a->rows);
  tnn_column_kernel<<<grid, a->rows * a->q, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

const char* tnn_column_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
