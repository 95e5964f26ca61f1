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
//   V[t, j] = sum_{i,k} [x[b, c, i] + k <= t] * [k <= w[c, i, j]]  (t < T)
//   z_j     = first t with V[t, j] >= theta, else T
//   1-WTA   (when wta) keep the minimum of the key z_j * q + j (earliest
//           spike, ties to the lowest index) if it is < T * q; every other
//           neuron gets T
// V is the reference's A@N 0/1 product itself, on int8 tensor cores
// (tnn_common.cuh), equal to its bf16/f32 product bit for bit for any p.
//
// Bound on this card (H100 SXM, 3.35 TB/s, 67 T 32-bit op/s): operations, as
// chip_smoke.py counts the direct ramp form (a min and an add per synapse per
// tick up to each neuron's crossing): 162 M at the serving shape (625 sites,
// B = 64, layer 1 p = 32, q = 12), about 2.4 us, against about 1 us for its
// 3.4 MB. The first port (one thread per (row, neuron), every tick's ramp sum
// recomputed from single-byte shared loads) took 24x that. Here the padded
// product runs on int8 tensor cores, far from their rate; what is left is
// integer instructions: building fragments, the votes, the WTA shuffles.
//
// Design.
//  * Grid: (site, chunk of `rows` batch rows); the wrapper sizes the chunks
//    evenly (no nearly empty chunk) and to a multiple of the rows one m16
//    tile holds. No accumulator crosses blocks; any p takes one launch.
//  * The block stages the chunk's volleys ([row][synapse], through the
//    caller's strides, 4 bytes at a time where the layout allows) and the
//    site's p*q weights when they fit (else they are read from device
//    memory, the p = 2048, q = 128 case).
//  * Each warp owns m16 tiles of (row, tick) pairs and runs the A@N product
//    on `mma.sync` m16n8k32 (tnn_common.cuh): A's thermometer fragments
//    built in registers from volley bytes, N's from weight bytes.
//  * The serving shapes (T = 8, p a multiple of 4 up to 32, q <= 16) take
//    tnn_layer_t8: N in registers for the whole layer, two tiles per pass,
//    the crossing by warp votes and the 1-WTA by shuffles inside the warp
//    that holds the row, each lane storing its own z. Other shapes take
//    tnn_layer_crossings (T at run time, N rebuilt in the K loop), then a
//    block-wide WTA through shared memory.
//  * A ragged last chunk is masked; nothing is padded in memory.

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
  int rows;                      // batch rows per block, a multiple of 16/T
  int w_smem;                    // 1: stage the site's weights in shared memory
};

}  // extern "C"

__host__ __device__ static inline int col_round16(int n) { return (n + 15) & ~15; }

// Warps per block: one per m16 tile unit of the chunk, at most 8.
__host__ __device__ static inline int col_warps(const ColumnArgs& a) {
  const int units = a.T >= 16 ? a.rows : (a.rows * a.T) / 16;
  const int w = units < 1 ? 1 : units;
  return w < TNN_COLUMN_MAX_THREADS / 32 ? w : TNN_COLUMN_MAX_THREADS / 32;
}

__host__ __device__ static inline size_t col_smem_bytes(const ColumnArgs& a) {
  return (size_t)a.rows * a.q * 4 + (size_t)a.rows * 4 +
         col_round16(a.rows * a.p) + (a.w_smem ? (size_t)a.p * a.q : 0);
}

// T8: tnn_layer_t8, else tnn_layer_crossings; the launch picks it from the
// shape.
template <bool T8>
__global__ void __launch_bounds__(TNN_COLUMN_MAX_THREADS, T8 ? 3 : 1)
tnn_column_kernel(const __grid_constant__ ColumnArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.x;
  const int P = a.p, Q = a.q, R = a.rows, T = a.T;
  const int b0 = blockIdx.y * R;
  const int nrows = min(R, a.B - b0);
  const int tid = threadIdx.x, nthr = blockDim.x;
  int* zpre = reinterpret_cast<int*>(smem);                    // [row][neuron]
  int* best = zpre + (size_t)R * Q;                            // [row]
  uint8_t* xs = reinterpret_cast<uint8_t*>(best + R);          // [row][synapse]
  int8_t* ws = reinterpret_cast<int8_t*>(xs + col_round16(R * P));
  const int8_t* wg = a.w + (size_t)c * P * Q;

  if (a.w_smem)
    for (int k = tid; k < P * Q; k += nthr) ws[k] = wg[k];
  const uint8_t* xg = a.x + (long long)b0 * a.x_sb + (long long)c * a.x_sc;
  if (a.x_si == 1 && (P & 3) == 0 && (a.x_sb & 3) == 0 &&
      (((uintptr_t)xg) & 3) == 0) {
    const int P4 = P >> 2;
    for (int k = tid; k < nrows * P4; k += nthr) {
      const int r = k / P4, i4 = k - r * P4;
      reinterpret_cast<uint32_t*>(xs)[k] =
          reinterpret_cast<const uint32_t*>(xg + (long long)r * a.x_sb)[i4];
    }
  } else {
    for (int k = tid; k < nrows * P; k += nthr) {
      const int r = k / P, i = k - r * P;
      xs[k] = xg[(long long)r * a.x_sb + (long long)i * a.x_si];
    }
  }
  __syncthreads();

  int32_t* zg = a.z + ((long long)b0 * a.C + c) * Q;
  const long long zrs = (long long)a.C * Q;
  if constexpr (T8) {  // (the launch stages these weights)
    tnn_layer_t8(xs, P, R, nrows, ws, P, Q, a.theta, a.wta, tid >> 5, nthr >> 5,
                 [&](int r, int j, int zj) { zg[r * zrs + j] = zj; });
  } else {
    tnn_layer_crossings(xs, P, R, nrows, a.w_smem ? ws : wg, P, Q, T, a.theta,
                        zpre, tid >> 5, nthr >> 5);
    __syncthreads();
    if (a.wta) {
      tnn_row_best(zpre, nrows, Q, best, tid, nthr);
      __syncthreads();
    }
    for (int k = tid; k < nrows * Q; k += nthr) {
      const int r = k / Q, j = k - r * Q;
      const int zj = zpre[k];
      zg[r * zrs + j] = a.wta ? tnn_wta_keep(zj, j, Q, T, best[r]) : zj;
    }
  }
}

extern "C" {

// Dynamic shared memory one launch with these arguments needs.
size_t tnn_column_smem_bytes(const ColumnArgs* a) { return col_smem_bytes(*a); }

// Enqueue one layer on `stream`; returns cudaGetLastError() (0 = launched).
int tnn_column_launch(const ColumnArgs* a, void* stream) {
  const int T = a->T;
  const int tile_rows = T >= 16 ? 1 : 16 / (T > 0 ? T : 1);
  if (a->B < 1 || a->C < 1 || a->p < 1 || a->q < 1 || a->q > 128 || T < 2 ||
      T > 128 || (T & (T - 1)) != 0 || a->rows < 1 || a->rows % tile_rows != 0 ||
      (a->B + a->rows - 1) / a->rows > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = col_smem_bytes(*a);
  const bool t8 = tnn_t8_shape(a->p, a->q, T) && a->w_smem;
  auto kernel = t8 ? tnn_column_kernel<true> : tnn_column_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(a->C, (a->B + a->rows - 1) / a->rows);
  kernel<<<grid, 32 * col_warps(*a), smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

const char* tnn_column_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
