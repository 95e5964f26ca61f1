// Per-layer STDP update for Hopper (sm_90a): one wave of batched-"sum" STDP
// for every synapse of a layer, in ONE launch.
//
// Replaces the Pallas TPU kernel `_stdp_kernel` in
// src/repro/kernels/stdp_update.py (built by `stdp_update_pallas`, entered
// through `ops.stdp_update` and `ops.layer_stdp_fused`, which vmaps it over the
// layer's columns), together with the body it calls, `stdp_net_tile`. The
// plain PyTorch version and the ctypes wrapper are in
// src/repro_torch/kernels/stdp_update.py.
//
// What it computes, per synapse (c, i, j):
//   net = sum_b [u_up[c, b, i, j] < p_up] - [u_dn[c, b, i, j] < p_dn]
// with the case planes of x[b, c, i] versus z[b, c, j] and p_up / p_dn built in
// float32 exactly as stdp_net_tile builds them (F = table[w] by the select
// chain, then f32(mu) * F; tnn_common.cuh). The output is `net` (out="net",
// the pre-clip counters) or clip(w + net, 0, w_max) (out="weights"), as int32.
//
// Bound on this card (H100 SXM, 3.35 TB/s): bytes. The two float32 uniform
// tensors are 8 * C * B * p * q bytes, 30,720,000 for layer 1 of the prototype
// at B=16 (about 9.2 us) and everything else is under 2 MB; the work is two
// compares and a few selects per uniform pair.
//
// Design.
//  * One thread per synapse, looping over the whole batch: the thread is the
//    only writer of its counter, so there are no atomics and the sum is
//    deterministic. The TPU kernel walks batch tiles as a sequential grid axis
//    with a VMEM accumulator; here the loop over batch chunks is inside the
//    thread and the counter stays in a register.
//  * Grid: (site, tile of 256 synapses). Neighbouring threads own neighbouring
//    (i, j) of one site, so each uniform load of a warp is 32 consecutive
//    floats of one (p, q) plane: coalesced, each uniform read exactly once.
//  * Shared memory holds the stabilize table and a chunk of the site's volleys
//    x[b, c, :] and z[b, c, :], read through the caller's strides; every
//    thread of the block reads them from there.
//  * The uniforms may be strided views u[:, 0], u[:, 1] of a (C, 2, B, p, q)
//    draw: the site and row strides are arguments, the (p, q) plane must be
//    contiguous (the wrapper checks).

#include <cstdint>
#include <cuda_runtime.h>

#include "tnn_common.cuh"

#define TNN_STDP_THREADS 256
#define TNN_STDP_MAX_TABLE 128

extern "C" {

// Must match `_StdpArgs` in stdp_update.py field for field.
struct StdpArgs {
  const int8_t* w;                 // (C, p, q) contiguous
  const uint8_t* x;                // (B, C, p) spike times, strided
  long long x_sb, x_sc, x_si;
  const uint8_t* z;                // (B, C, q) spike times, strided
  long long z_sb, z_sc, z_sj;
  const float* u_up;               // (C, B, p, q): strides c, b; (p, q) contiguous
  long long uu_sc, uu_sb;
  const float* u_dn;
  long long ud_sc, ud_sb;
  int32_t* out;                    // (C, p, q) contiguous
  int B, C, p, q, T, w_max;
  int rows;                        // batch rows staged per chunk
  int weights_out;                 // 1: clip(w + net, 0, w_max); 0: net
  float mu_c, mu_b, mu_s;          // float32, as the reference's compare sees them
  float table[TNN_STDP_MAX_TABLE]; // stabilize table, w_max + 1 entries
};

}  // extern "C"

__host__ __device__ static inline size_t stdp_smem_bytes(const StdpArgs& a) {
  return (size_t)a.rows * (a.p + a.q);
}

__global__ void __launch_bounds__(TNN_STDP_THREADS)
tnn_stdp_kernel(const __grid_constant__ StdpArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float tab[TNN_STDP_MAX_TABLE];
  const int c = blockIdx.x;
  const int P = a.p, Q = a.q, PQ = P * Q, R = a.rows, T = a.T;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int s = blockIdx.y * nthr + tid;   // synapse i * q + j of site c
  const bool live = s < PQ;
  const int i = s / Q, j = s - (s / Q) * Q;
  uint8_t* xs = smem;                       // [row][synapse]
  uint8_t* zs = smem + (size_t)R * P;       // [row][neuron]

  for (int k = tid; k <= a.w_max; k += nthr) tab[k] = a.table[k];
  __syncthreads();
  const int wv = live ? (int)a.w[(size_t)c * PQ + s] : 0;
  const float f = tnn_stabilize(tab, wv, a.w_max);
  const float pc = a.mu_c * f, pb = a.mu_b * f;
  const float* uu = a.u_up + (long long)c * a.uu_sc + s;
  const float* ud = a.u_dn + (long long)c * a.ud_sc + s;

  int acc = 0;
  for (int b0 = 0; b0 < a.B; b0 += R) {
    const int nrows = min(R, a.B - b0);
    for (int k = tid; k < nrows * P; k += nthr) {
      const int r = k / P, ii = k - r * P;
      xs[k] = a.x[(long long)(b0 + r) * a.x_sb + (long long)c * a.x_sc +
                  (long long)ii * a.x_si];
    }
    for (int k = tid; k < nrows * Q; k += nthr) {
      const int r = k / Q, jj = k - r * Q;
      zs[k] = a.z[(long long)(b0 + r) * a.z_sb + (long long)c * a.z_sc +
                  (long long)jj * a.z_sj];
    }
    __syncthreads();
    if (live) {
      for (int r = 0; r < nrows; ++r) {
        const long long b = b0 + r;
        acc += tnn_stdp_vote(xs[r * P + i], zs[r * Q + j], T, pc, pb, a.mu_s,
                             uu[b * a.uu_sb], ud[b * a.ud_sb]);
      }
    }
    __syncthreads();  // the next chunk overwrites the volleys
  }
  if (live)
    a.out[(size_t)c * PQ + s] =
        a.weights_out ? min(max(wv + acc, 0), a.w_max) : acc;
}

extern "C" {

// Dynamic shared memory one launch with these arguments needs.
size_t tnn_stdp_smem_bytes(const StdpArgs* a) { return stdp_smem_bytes(*a); }

// Enqueue one layer's update on `stream`; returns cudaGetLastError().
int tnn_stdp_launch(const StdpArgs* a, void* stream) {
  const long long tiles = ((long long)a->p * a->q + TNN_STDP_THREADS - 1) / TNN_STDP_THREADS;
  if (a->B < 1 || a->C < 1 || a->p < 1 || a->q < 1 || a->rows < 1 ||
      a->w_max < 0 || a->w_max >= TNN_STDP_MAX_TABLE || tiles > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = stdp_smem_bytes(*a);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        tnn_stdp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(a->C, (unsigned)tiles);
  tnn_stdp_kernel<<<grid, TNN_STDP_THREADS, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

const char* tnn_stdp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
