// Whole-network TNN gamma wave for Hopper (sm_90a): forward cascade of every
// layer plus the optional STDP-counter epilogue, in ONE launch.
//
// Replaces the Pallas TPU kernel `_wave_kernel` in src/repro/kernels/tnn_wave.py
// (built by `_wave_pallas_call`, entered through `wave_forward` / `wave_train`),
// together with the bodies it inlines: `ramp_matmul` and `crossing_wta`
// (src/repro/kernels/tnn_column.py) and `stdp_net_tile`
// (src/repro/kernels/stdp_update.py). The plain PyTorch version of the same
// function is `wave_forward` / `wave_train` on CPU tensors in
// src/repro_torch/kernels/tnn_wave.py, which also holds the ctypes wrapper.
//
// What it computes, per site c and batch row b, layer by layer:
//   V[t, j] = sum_i min(max(t - x_i, 0), w_ij)     (int32, t in [0, T))
//   z_j     = first t with V[t, j] >= theta, else T
//   1-WTA   = keep the minimum of the key z_j * q + j (earliest spike, ties to
//             the lowest index); every other neuron gets T
// and the layer's z is the next layer's input. With learn=1, for every synapse
// (i, j) of every layer:
//   net[c, i, j] = sum_b [u_up < p_up] - [u_dn < p_dn]
// with p_up/p_dn built in float32 exactly as stdp_net_tile builds them
// (F = table[w], then f32(mu) * F), the pre-clip counter form.
//
// The integer ramp sum equals the reference's bf16 A@N product exactly: every
// operand is a small integer and a ramp never exceeds T-1. The crossing, the
// stabilize select and the per-pair STDP vote live in tnn_common.cuh, shared
// with the per-layer kernels tnn_column.cu and stdp_update.cu.
//
// Design.
//  * Grid: one block per site. The TPU kernel walks batch tiles as a
//    sequential grid axis and carries the counters in scratch; here a loop
//    inside the block walks chunks of `rows` batch rows, and the block that
//    owns site c is the only writer of net[c], so the counters need no atomics
//    and their sums are deterministic. A ragged batch is masked in the loop.
//  * x is read and z written in the public (B, C, .) layout through strides:
//    no transposes or padding around the launch.
//  * Shared memory holds the site's weights of every layer (int8) and the
//    chunk's volleys of every layer, stored [neuron][row] so that neighbouring
//    threads (rows) touch neighbouring bytes.
//  * Forward: one thread carries one batch row through the whole cascade; the
//    weight reads are the same address for every thread (a broadcast).
//  * Learn epilogue: threads switch to one thread per synapse; each loops over
//    the chunk's rows and reads u_up/u_dn[c, b, i, j], so a warp reads 32
//    consecutive floats of one row (coalesced).
//
// Bound on this card (H100 SXM, 3.35 TB/s, 80 GB):
//  * learning: the uniforms dominate the bytes, 8 * C * B * sum_i(p_i q_i)
//    bytes per wave (about 40 MB at the prototype's C=625, B=16), so the
//    epilogue is memory-bound; the design reads each uniform exactly once,
//    coalesced, and keeps everything else (weights, volleys) on chip.
//  * serving: x, w and z are about 2.5 MB at B=64, so the forward is bound by
//    its integer work and, at this size, by launch latency: one launch per
//    wave whatever the depth is what the design does about it.

#include <cstdint>
#include <cuda_runtime.h>

#include "tnn_common.cuh"

#define TNN_MAX_LAYERS 8
#define TNN_MAX_THREADS 256

extern "C" {

// Must match `_WaveArgs` in tnn_wave.py field for field.
struct WaveArgs {
  const uint8_t* x;                       // (B, C, p1) spike times, strided
  long long x_sb, x_sc, x_si;             // element strides of x
  int n_layers, C, B, T, w_max, learn, rows, threads;
  int p[TNN_MAX_LAYERS], q[TNN_MAX_LAYERS], theta[TNN_MAX_LAYERS];
  const int8_t* w[TNN_MAX_LAYERS];        // (C, p, q) contiguous
  uint8_t* z[TNN_MAX_LAYERS];             // (B, C, q) contiguous
  const float* u_up[TNN_MAX_LAYERS];      // (C, B, p, q): strides c, b; (p, q) contiguous
  const float* u_dn[TNN_MAX_LAYERS];
  long long uu_sc[TNN_MAX_LAYERS], uu_sb[TNN_MAX_LAYERS];
  long long ud_sc[TNN_MAX_LAYERS], ud_sb[TNN_MAX_LAYERS];
  int* net[TNN_MAX_LAYERS];               // (C, p, q) contiguous int32
  const float* consts;                    // (n_layers, w_max + 4): table, mu_c, mu_b, mu_s
};

}  // extern "C"

__host__ __device__ static inline int weights_bytes(const WaveArgs& a) {
  int n = 0;
  for (int l = 0; l < a.n_layers; ++l) n += a.p[l] * a.q[l];
  return (n + 15) & ~15;
}

__host__ __device__ static inline int volley_bytes(const WaveArgs& a) {
  int n = a.p[0];
  for (int l = 0; l < a.n_layers; ++l) n += a.q[l];
  return n * a.rows;
}

__global__ void __launch_bounds__(TNN_MAX_THREADS)
tnn_wave_kernel(const __grid_constant__ WaveArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int R = a.rows;
  const int L = a.n_layers;
  const int T = a.T;
  int8_t* w_s = reinterpret_cast<int8_t*>(smem);
  uint8_t* vol = smem + weights_bytes(a);

  // The site's weights of every layer, loaded once.
  {
    int off = 0;
    for (int l = 0; l < L; ++l) {
      const int pq = a.p[l] * a.q[l];
      const int8_t* wg = a.w[l] + (size_t)c * pq;
      for (int k = tid; k < pq; k += nthr) w_s[off + k] = wg[k];
      off += pq;
    }
  }

  for (int b0 = 0; b0 < a.B; b0 += R) {
    const int nrows = min(R, a.B - b0);

    // Stage the chunk's input volley as [i][row].
    {
      const int P0 = a.p[0];
      for (int k = tid; k < nrows * P0; k += nthr) {
        const int r = k / P0, i = k - r * P0;
        vol[i * R + r] = a.x[(long long)(b0 + r) * a.x_sb +
                             (long long)c * a.x_sc + (long long)i * a.x_si];
      }
    }
    __syncthreads();

    // Forward cascade: one thread per batch row.
    if (tid < nrows) {
      const int r = tid;
      const long long b = b0 + r;
      int w_off = 0, v_in = 0, v_out = a.p[0] * R;
      for (int l = 0; l < L; ++l) {
        const int P = a.p[l], Q = a.q[l], th = a.theta[l];
        const int8_t* wl = w_s + w_off;
        const uint8_t* vin = vol + v_in;
        uint8_t* vout = vol + v_out;
        int best = (T + 1) * Q;  // larger than any key z * Q + j
        for (int j = 0; j < Q; ++j) {
          const int zj = tnn_crossing(vin + r, R, wl + j, Q, P, T, th);
          best = min(best, zj * Q + j);
        }
        const int win = best % Q, zwin = best / Q;
        uint8_t* zg = a.z[l] + (b * a.C + c) * (long long)Q;
        for (int j = 0; j < Q; ++j) {
          const uint8_t out = (uint8_t)((j == win && zwin < T) ? zwin : T);
          vout[j * R + r] = out;
          zg[j] = out;
        }
        w_off += P * Q;
        v_in = v_out;
        v_out += Q * R;
      }
    }
    __syncthreads();

    // STDP-counter epilogue: one thread per synapse, loop over the rows.
    if (a.learn) {
      int w_off = 0, v_in = 0, v_out = a.p[0] * R;
      for (int l = 0; l < L; ++l) {
        const int P = a.p[l], Q = a.q[l], PQ = P * Q;
        const float* cst = a.consts + l * (a.w_max + 4);
        const float mu_c = cst[a.w_max + 1], mu_b = cst[a.w_max + 2],
                    mu_s = cst[a.w_max + 3];
        const uint8_t* vin = vol + v_in;
        const uint8_t* vz = vol + v_out;
        const float* uu0 = a.u_up[l] + (long long)c * a.uu_sc[l];
        const float* ud0 = a.u_dn[l] + (long long)c * a.ud_sc[l];
        for (int s = tid; s < PQ; s += nthr) {
          const int i = s / Q, j = s - i * Q;
          const int wv = w_s[w_off + s];
          const float f = tnn_stabilize(cst, wv, a.w_max);
          const float pc = mu_c * f, pb = mu_b * f;
          int acc = 0;
          for (int r = 0; r < nrows; ++r) {
            const long long b = b0 + r;
            acc += tnn_stdp_vote(vin[i * R + r], vz[j * R + r], T, pc, pb, mu_s,
                                 uu0[b * a.uu_sb[l] + s], ud0[b * a.ud_sb[l] + s]);
          }
          int* ng = a.net[l] + (size_t)c * PQ + s;
          *ng = (b0 == 0) ? acc : *ng + acc;  // only this thread touches it
        }
        w_off += PQ;
        v_in = v_out;
        v_out += Q * R;
      }
      __syncthreads();  // the next chunk overwrites the volleys
    }
  }
}

extern "C" {

// Dynamic shared memory one launch with these arguments needs.
size_t tnn_wave_smem_bytes(const WaveArgs* a) {
  return (size_t)weights_bytes(*a) + (size_t)volley_bytes(*a);
}

// Enqueue one wave on `stream`; returns cudaGetLastError() (0 = launched).
int tnn_wave_launch(const WaveArgs* a, void* stream) {
  if (a->n_layers < 1 || a->n_layers > TNN_MAX_LAYERS ||
      a->threads < 1 || a->threads > TNN_MAX_THREADS || a->rows > a->threads)
    return (int)cudaErrorInvalidValue;
  const size_t smem = tnn_wave_smem_bytes(a);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        tnn_wave_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  tnn_wave_kernel<<<a->C, a->threads, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

const char* tnn_wave_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
