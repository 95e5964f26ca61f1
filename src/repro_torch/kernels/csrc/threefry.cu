// Threefry-2x32 STDP uniforms for Hopper (sm_90a), bit for bit jax.random's.
//
// Replaces jax.random.uniform as the reference's layer_uniforms calls it
// (src/repro/core/layer.py:76): XLA's threefry2x32 under a vmap over the
// layer's column keys. It is no Pallas kernel; the reference draws the STDP
// uniforms with it on the device every learning wave. The plain PyTorch
// version and the ctypes wrapper are in src/repro_torch/kernels/threefry.py
// (plain: repro_torch.random.uniform over repro_torch.random.split).
//
// What it computes, for a layer key K, n_cols columns and n = 2 * B * p * q
// floats per column (the (2, B, p, q) draw of one column):
//   col_key(c)  = threefry2x32(K, (0, c))             (split(K, n_cols)[c])
//   (b1, b2)    = threefry2x32(col_key(c), (j >> 32, j & 0xffffffff))
//   out[c, j]   = float_from_bits(((b1 ^ b2) >> 9) | 0x3f800000) - 1.0f
// for j in [0, n): each column has its own counter from 0, as the vmap over
// the column keys gives, not one counter over the whole (C, 2, B, p, q).
//
// A second entry draws two split levels in one launch, the "seq" STDP
// mode's per-image uniforms (the reference's stdp_update, batch_reduce
// "seq": split(column_key, B)[b], then uniform(image_key, (2, p, q))):
//   img_key(c, b) = threefry2x32(col_key(c), (0, b))  (split(col_key(c), B)[b])
//   out[(c * B + b) * n + j] = the float of j under img_key(c, b)
// each (column, image) row with its own counter from 0.
//
// A third entry draws one rank's WINDOW of a layer's (n_cols, 2, B, p, q)
// draw on a (data, model) mesh, and nothing else: local columns
// c = col0 + cl (cl < n_local) and batch rows row0 .. row0 + b_local - 1, as
// the reference slices its global draw per shard (shard_u,
// src/repro/core/network.py:477-486). With pq = p * q and
// m = 2 * b_local * pq floats per local column:
//   s = jl / (b_local * pq),  r = jl % (b_local * pq)
//   out[cl, jl] = the float of counter s * B * pq + row0 * pq + r under
//                 col_key(c)                     if c < n_cols
//               = 1.0 (a pad site: u < p never fires)   otherwise
// so within each of the two planes the window is one contiguous run of the
// column's counters. Its bound and design are the first entry's, on
// n_local * m floats.
//
// Bound on this card (H100 SXM): integer issue, not bytes. One threefry call
// per float: 20 rounds of (add, rotate, xor), 5 key injections of two adds,
// 2 initial adds, then xor, shift and or. The 43 rotates, xors, shift and or
// issue only on the 64 INT32 lanes of an SM (132 SMs at 1.98 GHz, 16.7 T/s);
// the 32 adds also issue on the float32 lanes (IMAD), beside them. So the
// 10,080,000 floats of a learning wave at B = 16 take >= 0.026 ms; their
// 40.3 MB at 3.35 TB/s take 0.012 ms.
//
// Design: grid (chunks of a column, columns); a block's thread 0 computes
// its column's key once into shared memory (never per element). Each thread
// then draws 4 consecutive floats, 4 independent hashes in flight for the
// issue slots, rotates with __funnelshift_l, builds the float by its bit
// pattern and __fsub_rn, and writes one 16-byte store where the 4 floats are
// 16-byte aligned (scalar stores at a column's ragged end or where n is not a
// multiple of 4). No input is read: the key arrives as two kernel arguments.

#include <cstdint>
#include <cuda_runtime.h>

#define TNN_TF_MAX_THREADS 1024
#define TNN_TF_PER_THREAD 4

__device__ __forceinline__ void tnn_threefry2x32(uint32_t k0, uint32_t k1,
                                                 uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
#define TNN_TF_ROUND(r)               \
  x0 += x1;                           \
  x1 = __funnelshift_l(x1, x1, (r));  \
  x1 ^= x0;
#define TNN_TF_ROUNDS_A TNN_TF_ROUND(13) TNN_TF_ROUND(15) TNN_TF_ROUND(26) TNN_TF_ROUND(6)
#define TNN_TF_ROUNDS_B TNN_TF_ROUND(17) TNN_TF_ROUND(29) TNN_TF_ROUND(16) TNN_TF_ROUND(24)
  TNN_TF_ROUNDS_A x0 += k1; x1 += k2 + 1u;
  TNN_TF_ROUNDS_B x0 += k2; x1 += k0 + 2u;
  TNN_TF_ROUNDS_A x0 += k0; x1 += k1 + 3u;
  TNN_TF_ROUNDS_B x0 += k1; x1 += k2 + 4u;
  TNN_TF_ROUNDS_A x0 += k2; x1 += k0 + 5u;
#undef TNN_TF_ROUNDS_B
#undef TNN_TF_ROUNDS_A
#undef TNN_TF_ROUND
}

// float32 in [0, 1) from 32 random bits, as jax.random.uniform builds it
__device__ __forceinline__ float tnn_unit_float(uint32_t bits) {
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}

// One thread's 4 consecutive floats j0 .. j0 + 3 (< n) of the row keyed
// (k0, k1), written at out[base ..]: 4 hashes in flight, one 16-byte store
// where the floats are 16-byte aligned.
__device__ __forceinline__ void tnn_draw4(float* __restrict__ out, long long base,
                                          long long j0, long long n,
                                          uint32_t k0, uint32_t k1) {
  float v[TNN_TF_PER_THREAD];
#pragma unroll
  for (int e = 0; e < TNN_TF_PER_THREAD; ++e) {
    const unsigned long long j = (unsigned long long)(j0 + e);
    uint32_t a = (uint32_t)(j >> 32), b = (uint32_t)j;
    tnn_threefry2x32(k0, k1, a, b);
    v[e] = tnn_unit_float(a ^ b);
  }
  if (j0 + TNN_TF_PER_THREAD <= n && (base & 3) == 0) {
    *reinterpret_cast<float4*>(out + base) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < TNN_TF_PER_THREAD; ++e)
      if (j0 + e < n) out[base + e] = v[e];
  }
}

__global__ void __launch_bounds__(TNN_TF_MAX_THREADS)
tnn_threefry_uniform_kernel(float* __restrict__ out, uint32_t key0,
                            uint32_t key1, int n_cols, long long n) {
  __shared__ uint32_t col_key[2];
  const long long j0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * TNN_TF_PER_THREAD;
  for (int c = blockIdx.y; c < n_cols; c += gridDim.y) {
    __syncthreads();  // the previous column's key is no longer read
    if (threadIdx.x == 0) {
      uint32_t a = 0u, b = (uint32_t)c;
      tnn_threefry2x32(key0, key1, a, b);
      col_key[0] = a;
      col_key[1] = b;
    }
    __syncthreads();
    if (j0 >= n) continue;
    tnn_draw4(out, (long long)c * n + j0, j0, n, col_key[0], col_key[1]);
  }
}

// The two-level draw: grid (chunks of a row, rows), a row (c, b) for each
// column c < n_cols and image b < n_rows, walked by blockIdx.y with stride
// gridDim.y; a block's thread 0 derives the row's key (two hashes) once.
__global__ void __launch_bounds__(TNN_TF_MAX_THREADS)
tnn_threefry_nested_kernel(float* __restrict__ out, uint32_t key0,
                           uint32_t key1, int n_cols, int n_rows, long long n) {
  __shared__ uint32_t row_key[2];
  const long long j0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * TNN_TF_PER_THREAD;
  const long long rows = (long long)n_cols * n_rows;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    __syncthreads();  // the previous row's key is no longer read
    if (threadIdx.x == 0) {
      const long long c = r / n_rows;
      uint32_t a = 0u, b = (uint32_t)c;
      tnn_threefry2x32(key0, key1, a, b);          // split(key, C)[c]
      uint32_t a2 = 0u, b2 = (uint32_t)(r - c * n_rows);
      tnn_threefry2x32(a, b, a2, b2);              // split(col key, B)[b]
      row_key[0] = a2;
      row_key[1] = b2;
    }
    __syncthreads();
    if (j0 >= n) continue;
    tnn_draw4(out, r * n + j0, j0, n, row_key[0], row_key[1]);
  }
}

// One thread's 4 consecutive window floats jl0 .. jl0 + 3 (< m) of a local
// column keyed (k0, k1): the counter of each is mapped from its plane and
// row, as the header says; one 16-byte store where aligned.
__device__ __forceinline__ void tnn_draw4_window(
    float* __restrict__ out, long long base, long long jl0, long long m,
    long long plane, long long skip, long long offset, uint32_t k0,
    uint32_t k1) {
  float v[TNN_TF_PER_THREAD];
#pragma unroll
  for (int e = 0; e < TNN_TF_PER_THREAD; ++e) {
    const long long jl = jl0 + e;
    const long long s = jl / plane;
    const unsigned long long j = (unsigned long long)(jl + s * skip + offset);
    uint32_t a = (uint32_t)(j >> 32), b = (uint32_t)j;
    tnn_threefry2x32(k0, k1, a, b);
    v[e] = tnn_unit_float(a ^ b);
  }
  if (jl0 + TNN_TF_PER_THREAD <= m && (base & 3) == 0) {
    *reinterpret_cast<float4*>(out + base) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < TNN_TF_PER_THREAD; ++e)
      if (jl0 + e < m) out[base + e] = v[e];
  }
}

// The window draw: grid (chunks of a local column, local columns); a block's
// thread 0 derives its column's key once. plane = b_local * pq floats of one
// half (up or down); skip = (B - b_local) * pq counters lie between the two
// halves' runs; offset = row0 * pq is where the window's rows begin.
__global__ void __launch_bounds__(TNN_TF_MAX_THREADS)
tnn_threefry_window_kernel(float* __restrict__ out, uint32_t key0,
                           uint32_t key1, int n_cols, int col0, int n_local,
                           long long plane, long long skip, long long offset) {
  __shared__ uint32_t col_key[2];
  const long long m = 2 * plane;
  const long long jl0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * TNN_TF_PER_THREAD;
  for (int cl = blockIdx.y; cl < n_local; cl += gridDim.y) {
    const int c = col0 + cl;
    if (c >= n_cols) {  // a pad site: no key, every float 1.0
      if (jl0 < m) {
        const long long base = (long long)cl * m + jl0;
#pragma unroll
        for (int e = 0; e < TNN_TF_PER_THREAD; ++e)
          if (jl0 + e < m) out[base + e] = 1.0f;
      }
      continue;
    }
    __syncthreads();  // the previous column's key is no longer read
    if (threadIdx.x == 0) {
      uint32_t a = 0u, b = (uint32_t)c;
      tnn_threefry2x32(key0, key1, a, b);
      col_key[0] = a;
      col_key[1] = b;
    }
    __syncthreads();
    if (jl0 >= m) continue;
    tnn_draw4_window(out, (long long)cl * m + jl0, jl0, m, plane, skip,
                     offset, col_key[0], col_key[1]);
  }
}

// The bare hash of n counter pairs under one key: the known-answer check of
// tnn_threefry2x32 on the card (no path launches it).
__global__ void tnn_threefry_hash_kernel(const uint32_t* __restrict__ x0,
                                         const uint32_t* __restrict__ x1,
                                         uint32_t* __restrict__ y0,
                                         uint32_t* __restrict__ y1,
                                         uint32_t key0, uint32_t key1, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t a = x0[i], b = x1[i];
  tnn_threefry2x32(key0, key1, a, b);
  y0[i] = a;
  y1[i] = b;
}

extern "C" {

// Enqueue the (n_cols, n) float32 draw of the layer key (key0, key1) into
// `out` (contiguous, 16-byte aligned) on `stream`, `threads` threads a block;
// returns cudaGetLastError().
int tnn_threefry_uniform_launch(float* out, unsigned key0, unsigned key1,
                                int n_cols, long long n, int threads,
                                void* stream) {
  if (n_cols < 1 || n < 1 || threads < 32 || threads % 32 ||
      threads > TNN_TF_MAX_THREADS || ((unsigned long long)out & 15))
    return (int)cudaErrorInvalidValue;
  const long long per_block = (long long)threads * TNN_TF_PER_THREAD;
  const long long chunks = (n + per_block - 1) / per_block;
  if (chunks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)chunks, (unsigned)(n_cols < 65535 ? n_cols : 65535));
  tnn_threefry_uniform_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      out, key0, key1, n_cols, n);
  return (int)cudaGetLastError();
}

// Enqueue the (n_cols, n_rows, n) float32 two-level draw of the layer key
// (key0, key1) into `out` (contiguous, 16-byte aligned) on `stream`;
// returns cudaGetLastError().
int tnn_threefry_nested_launch(float* out, unsigned key0, unsigned key1,
                               int n_cols, int n_rows, long long n, int threads,
                               void* stream) {
  if (n_cols < 1 || n_rows < 1 || n < 1 || threads < 32 || threads % 32 ||
      threads > TNN_TF_MAX_THREADS || ((unsigned long long)out & 15))
    return (int)cudaErrorInvalidValue;
  const long long per_block = (long long)threads * TNN_TF_PER_THREAD;
  const long long chunks = (n + per_block - 1) / per_block;
  const long long rows = (long long)n_cols * n_rows;
  if (chunks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)chunks, (unsigned)(rows < 65535 ? rows : 65535));
  tnn_threefry_nested_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      out, key0, key1, n_cols, n_rows, n);
  return (int)cudaGetLastError();
}

// Enqueue one rank's window of a layer's draw: (n_local, 2, b_local, pq)
// float32 into `out` (contiguous, 16-byte aligned), local column cl being
// the layer's column col0 + cl of n_cols (1.0 at and beyond n_cols), rows
// row0 .. row0 + b_local - 1 of B; returns cudaGetLastError().
int tnn_threefry_window_launch(float* out, unsigned key0, unsigned key1,
                               int n_cols, int col0, int n_local, long long B,
                               long long row0, long long b_local, long long pq,
                               int threads, void* stream) {
  if (n_cols < 1 || col0 < 0 || n_local < 1 || b_local < 1 || pq < 1 ||
      row0 < 0 || row0 + b_local > B || threads < 32 || threads % 32 ||
      threads > TNN_TF_MAX_THREADS || ((unsigned long long)out & 15))
    return (int)cudaErrorInvalidValue;
  const long long plane = b_local * pq;
  const long long per_block = (long long)threads * TNN_TF_PER_THREAD;
  const long long chunks = (2 * plane + per_block - 1) / per_block;
  if (chunks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)chunks,
                  (unsigned)(n_local < 65535 ? n_local : 65535));
  tnn_threefry_window_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      out, key0, key1, n_cols, col0, n_local, plane, (B - b_local) * pq,
      row0 * pq);
  return (int)cudaGetLastError();
}

// Enqueue the hash of n counter pairs (x0[i], x1[i]) under (key0, key1)
// into (y0[i], y1[i]); returns cudaGetLastError().
int tnn_threefry_hash_launch(const unsigned* x0, const unsigned* x1,
                             unsigned* y0, unsigned* y1, unsigned key0,
                             unsigned key1, long long n, void* stream) {
  if (n < 1 || n > 2147483647LL * 256) return (int)cudaErrorInvalidValue;
  tnn_threefry_hash_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                             (cudaStream_t)stream>>>(x0, x1, y0, y1, key0, key1, n);
  return (int)cudaGetLastError();
}

const char* tnn_threefry_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
