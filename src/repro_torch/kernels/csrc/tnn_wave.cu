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
//   V[t, j] = sum_{i,k} [x_i + k <= t] * [k <= w_ij]   (t in [0, T))
//   z_j     = first t with V[t, j] >= theta, else T
//   1-WTA   = keep the minimum of the key z_j * q + j (earliest spike, ties to
//             the lowest index); every other neuron gets T
// and the layer's z is the next layer's input. With learn=1, for every synapse
// (i, j) of every layer:
//   net[c, i, j] = sum_b [u_up < p_up] - [u_dn < p_dn]
// with p_up/p_dn built in float32 exactly as stdp_net_tile builds them
// (F = table[w], then f32(mu) * F), the pre-clip counter form.
//
// V is the reference's A@N 0/1 product on int8 tensor cores, the body shared
// with tnn_column.cu (tnn_common.cuh, bit for bit the reference's bf16/f32
// product); so are the WTA, the stabilize select and the per-pair STDP vote.
//
// Bound on this card (H100 SXM, 3.35 TB/s):
//  * serving: x, w and z are about 2.5 MB at B = 64; chip_smoke.py's count of
//    the direct ramp form's integer work (239 M ops, 3.6 us at 67 T op/s)
//    bounds it. The first port gave each batch row one thread walking every
//    neuron, tick and synapse serially (about 3,000 dependent steps, 9.5
//    warps per SM); here every warp of the block takes part in every layer.
//  * learning: the uniforms dominate the bytes, 8 * C * B * sum_l(p_l q_l)
//    (about 40 MB at C = 625, B = 16, 12.7 us), so it is bound by bytes. The
//    first port read them only after the forward, in a loop of dependent
//    loads; here they are in flight while the forward runs.
//
// Design.
//  * Grid: (site, batch chunk). The TPU kernel walks batch tiles as a
//    sequential grid axis and carries the counters in scratch. Forward: one
//    block per chunk of `rows` rows. Learning: one block per site walks the
//    chunks itself, the only writer of net[c], so the counters need no
//    atomics and their sums are deterministic.
//  * x is read and z written in the public (B, C, .) layout through strides:
//    no transposes or padding around the launch.
//  * Shared memory holds the site's weights of every layer (int8), the
//    chunk's volleys of every layer ([row][synapse] bytes), one layer's
//    pre-WTA crossing times (int32) and, when learning, the chunk's uniform
//    planes.
//  * Forward, per layer: every warp runs its m16 tiles of the layer's A@N
//    product and writes the layer's post-WTA z to shared memory (the next
//    layer's input) and to device memory; a __syncthreads separates the
//    layers, so z never leaves the chip between them and the cascade is one
//    launch. The prototype's layers (T = 8) take tnn_layer_t8, which does
//    the WTA inside the warp; other shapes take tnn_layer_crossings and a
//    block-wide WTA through shared memory.
//  * Learning: at the start of each chunk every thread issues cp.async copies
//    of the chunk's u_up/u_dn planes of every layer into shared memory (16
//    bytes at a time where the planes are 16-byte aligned); the forward runs
//    while they land. The epilogue then takes one thread per synapse (the
//    synapses of all layers dealt out as one list), reads the uniforms from
//    shared memory and sums its rows' votes. Where one
//    chunk's uniforms cannot fit (more than about 220 KB per row beside the
//    rest), the epilogue reads them from device memory, coalesced.

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
  int u_stage;                            // 1: copy each chunk's uniforms to shared memory
};

}  // extern "C"

__host__ __device__ static inline int r16(int n) { return (n + 15) & ~15; }
__host__ __device__ static inline int r4(int n) { return (n + 3) & ~3; }

// Float offset of layer l's staged uniforms: [up rows][down rows] per layer.
__host__ __device__ static inline int ustage_floats(const WaveArgs& a, int l) {
  int n = 0;
  for (int k = 0; k < l; ++k) n += r4(2 * a.rows * a.p[k] * a.q[k]);
  return n;
}

struct WaveSmem {
  size_t ust, zpre, best, w, vol, total;
};

__host__ __device__ static inline WaveSmem wave_smem(const WaveArgs& a) {
  int wq = 0, qmax = 0, vq = a.p[0];
  for (int l = 0; l < a.n_layers; ++l) {
    wq += a.p[l] * a.q[l];
    vq += a.q[l];
    qmax = a.q[l] > qmax ? a.q[l] : qmax;
  }
  WaveSmem s;
  s.ust = 0;
  s.zpre = (a.learn && a.u_stage) ? (size_t)4 * ustage_floats(a, a.n_layers) : 0;
  s.best = s.zpre + (size_t)4 * a.rows * qmax;
  s.w = s.best + (size_t)4 * a.rows;
  s.vol = s.w + r16(wq);
  s.total = s.vol + r16(vq * a.rows);
  return s;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// Copy nrows planes of PQ floats, plane r at src + r * sb, to dst + r * PQ.
__device__ __forceinline__ void stage_planes(float* dst, const float* src,
                                             long long sb, int PQ, int nrows,
                                             int tid, int nthr) {
  if ((((uintptr_t)src) & 15) == 0 && (sb & 3) == 0 && (PQ & 3) == 0) {
    const int n4 = PQ >> 2;
    for (int k = tid; k < nrows * n4; k += nthr) {
      const int r = k / n4, e = (k - r * n4) << 2;
      cp_async16(dst + r * PQ + e, src + r * sb + e);
    }
  } else {
    for (int k = tid; k < nrows * PQ; k += nthr) {
      const int r = k / PQ, e = k - r * PQ;
      cp_async4(dst + r * PQ + e, src + r * sb + e);
    }
  }
}

// FAST: every layer takes tnn_layer_t8 (the prototype's layers), so only
// that body is compiled in; else every layer takes tnn_layer_crossings.
template <bool FAST>
__global__ void __launch_bounds__(TNN_MAX_THREADS, FAST ? 3 : 1)
tnn_wave_kernel(const __grid_constant__ WaveArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.x;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, nwarps = nthr >> 5;
  const int R = a.rows, L = a.n_layers, T = a.T;
  const bool stage = a.learn && a.u_stage;
  const WaveSmem sm = wave_smem(a);
  float* ust = reinterpret_cast<float*>(smem + sm.ust);
  int* zpre = reinterpret_cast<int*>(smem + sm.zpre);
  int* best = reinterpret_cast<int*>(smem + sm.best);
  int8_t* w_s = reinterpret_cast<int8_t*>(smem + sm.w);
  uint8_t* vol = smem + sm.vol;

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

  const int n_chunks = (a.B + R - 1) / R;
  for (int ch = blockIdx.y; ch < n_chunks; ch += gridDim.y) {
    const int b0 = ch * R;
    const int nrows = min(R, a.B - b0);

    // The chunk's uniforms, in flight during the forward.
    if (stage) {
      for (int l = 0; l < L; ++l) {
        const int PQ = a.p[l] * a.q[l];
        float* dst = ust + ustage_floats(a, l);
        stage_planes(dst, a.u_up[l] + c * a.uu_sc[l] + b0 * a.uu_sb[l],
                     a.uu_sb[l], PQ, nrows, tid, nthr);
        stage_planes(dst + R * PQ, a.u_dn[l] + c * a.ud_sc[l] + b0 * a.ud_sb[l],
                     a.ud_sb[l], PQ, nrows, tid, nthr);
      }
      asm volatile("cp.async.commit_group;\n" ::);
    }

    // Stage the chunk's input volley as [row][synapse].
    {
      const int P0 = a.p[0];
      const uint8_t* xg = a.x + (long long)b0 * a.x_sb + (long long)c * a.x_sc;
      for (int k = tid; k < nrows * P0; k += nthr) {
        const int r = k / P0, i = k - r * P0;
        vol[k] = xg[(long long)r * a.x_sb + (long long)i * a.x_si];
      }
    }
    __syncthreads();

    // Forward cascade: every warp in every layer.
    {
      int w_off = 0, v_in = 0, v_out = a.p[0] * R;
      for (int l = 0; l < L; ++l) {
        const int P = a.p[l], Q = a.q[l];
        const int8_t* wl = w_s + w_off;
        uint8_t* vout = vol + v_out;
        uint8_t* zg = a.z[l] + ((long long)b0 * a.C + c) * Q;
        const long long zrs = (long long)a.C * Q;
        if constexpr (FAST) {
          tnn_layer_t8(vol + v_in, P, R, nrows, wl, P, Q, a.theta[l], true, warp,
                       nwarps, [&](int r, int j, int z) {
                         vout[r * Q + j] = (uint8_t)z;
                         zg[r * zrs + j] = (uint8_t)z;
                       });
        } else {
          tnn_layer_crossings(vol + v_in, P, R, nrows, wl, P, Q, T, a.theta[l],
                              zpre, warp, nwarps);
          __syncthreads();
          tnn_row_best(zpre, nrows, Q, best, tid, nthr);
          __syncthreads();
          for (int k = tid; k < nrows * Q; k += nthr) {
            const int r = k / Q, j = k - r * Q;
            const uint8_t out = (uint8_t)tnn_wta_keep(zpre[k], j, Q, T, best[r]);
            vout[k] = out;
            zg[r * zrs + j] = out;
          }
        }
        __syncthreads();
        w_off += P * Q;
        v_in = v_out;
        v_out += Q * R;
      }
    }

    // STDP-counter epilogue: one thread per synapse, the synapses of every
    // layer dealt out as one list; each loops over the chunk's rows.
    if (a.learn) {
      if (stage) {
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncthreads();
      }
      int n_syn = 0;
      for (int l = 0; l < L; ++l) n_syn += a.p[l] * a.q[l];
      for (int task = tid; task < n_syn; task += nthr) {
        int l = 0, s = task, w_off = 0, v_in = 0, v_out = a.p[0] * R;
        while (s >= a.p[l] * a.q[l]) {
          s -= a.p[l] * a.q[l];
          w_off += a.p[l] * a.q[l];
          v_in = v_out;
          v_out += a.q[l] * R;
          ++l;
        }
        const int P = a.p[l], Q = a.q[l], PQ = P * Q;
        const float* cst = a.consts + l * (a.w_max + 4);
        const float mu_c = cst[a.w_max + 1], mu_b = cst[a.w_max + 2],
                    mu_s = cst[a.w_max + 3];
        const uint8_t* vin = vol + v_in;
        const uint8_t* vz = vol + v_out;
        const int i = s / Q, j = s - i * Q;
        const int wv = w_s[w_off + s];
        const float f = tnn_stabilize(cst, wv, a.w_max);
        const float pc = mu_c * f, pb = mu_b * f;
        int acc = 0;
        if (stage) {
          const float* su = ust + ustage_floats(a, l) + s;
#pragma unroll 4
          for (int r = 0; r < nrows; ++r)
            acc += tnn_stdp_vote(vin[r * P + i], vz[r * Q + j], T, pc, pb, mu_s,
                                 su[r * PQ], su[(R + r) * PQ]);
        } else {
          const float* gu = a.u_up[l] + c * a.uu_sc[l] + b0 * a.uu_sb[l] + s;
          const float* gd = a.u_dn[l] + c * a.ud_sc[l] + b0 * a.ud_sb[l] + s;
          for (int r = 0; r < nrows; ++r)
            acc += tnn_stdp_vote(vin[r * P + i], vz[r * Q + j], T, pc, pb, mu_s,
                                 gu[r * a.uu_sb[l]], gd[r * a.ud_sb[l]]);
        }
        int* ng = a.net[l] + (size_t)c * PQ + s;
        *ng = (b0 == 0) ? acc : *ng + acc;  // only this thread touches it
      }
      __syncthreads();  // the next chunk overwrites volleys and uniforms
    }
  }
}

extern "C" {

// Dynamic shared memory one launch with these arguments needs.
size_t tnn_wave_smem_bytes(const WaveArgs* a) { return wave_smem(*a).total; }

// Enqueue one wave on `stream`; returns cudaGetLastError() (0 = launched).
int tnn_wave_launch(const WaveArgs* a, void* stream) {
  const int T = a->T;
  const int tile_rows = T >= 16 ? 1 : 16 / (T > 0 ? T : 1);
  if (a->n_layers < 1 || a->n_layers > TNN_MAX_LAYERS || a->threads < 32 ||
      a->threads > TNN_MAX_THREADS || a->threads % 32 != 0 || a->rows < 1 ||
      a->rows % tile_rows != 0 || T < 2 || T > 128 || (T & (T - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = tnn_wave_smem_bytes(a);
  bool fast = true;
  for (int l = 0; l < a->n_layers; ++l) fast = fast && tnn_t8_shape(a->p[l], a->q[l], T);
  auto kernel = fast ? tnn_wave_kernel<true> : tnn_wave_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_chunks = (a->B + a->rows - 1) / a->rows;
  const int gy = a->learn ? 1 : (n_chunks < 65535 ? n_chunks : 65535);
  kernel<<<dim3(a->C, gy), a->threads, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

const char* tnn_wave_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
