// Per-layer STDP update for Hopper (sm_90a): one wave of batched-"sum" STDP
// for every synapse of a layer, in ONE launch.
//
// Replaces the Pallas TPU kernel `_stdp_kernel` in
// src/repro/kernels/stdp_update.py (built by `stdp_update_pallas`, entered
// through `ops.stdp_update` and `ops.layer_stdp_fused`, which vmaps it over the
// layer's columns), together with the body it calls, `stdp_net_tile`. The
// plain PyTorch version, the ctypes wrapper and the launch plan are in
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
// compares and a few selects per uniform pair. So the design is a streaming
// one: keep enough bytes in flight on every SM, and let no counting thread
// wait on a load of its own.
//
// Design.
//  * Work items are (site, tile): a tile is tk rows of i by tw columns of j of
//    a site's (p, q) plane, whole rows (tw = q, as many as fit 992
//    synapses: every served layer is one tile a site) or, for q > 992, a
//    piece of one row (tk = 1). Either way a tile's synapses are one
//    contiguous range of the plane. Persistent blocks, as many as fit the
//    card (the wrapper sizes the grid from the SM count and the occupancy
//    query), walk the items blockIdx.x, + gridDim.x, ... and each item's
//    batch in chunks of `rows` rows. A block owns all rows of an item, so
//    each counter has one writer: no atomics, and the sum is taken in batch
//    order, deterministically.
//  * The uniforms stream through a ring of `stages` shared-memory stages,
//    each holding one chunk's u_up and u_dn rows, with a "full" and an
//    "empty" mbarrier. One producer warp keeps the ring filled ahead of the
//    counters with 1-D bulk copies (TMA) counted in transaction bytes on the
//    full barrier: one copy per half when the chunk's rows are one
//    contiguous range (one tile per site and row stride p*q, as for every
//    caller's (C, 2, B, p, q) draw), else one per row and half. Where the
//    uniforms are not 16-byte aligned (p*q or the tile not a multiple of 4
//    floats, or a view that starts mid-plane; `bulk` = 0) the lanes copy
//    them 4 bytes at a time with cp.async, arriving on the same barrier. A
//    stage is refilled once every counting warp has arrived on its empty
//    barrier.
//  * The counting warps take one thread per synapse of the tile. The small
//    inputs, a group of chunks' volley rows (x[b, c, i-range] and
//    z[b, c, j-range]) and the tile's weights, are loaded by the counting
//    threads themselves with ordinary loads, at most 4 bytes each, one group
//    ahead: the loads of group g + 1 are issued before group g is counted
//    and stored to the other of two shared buffers after it. A group is as
//    many of an item's chunks as the buffer holds (all of them at the served
//    shapes). Group 0's loads are issued before the producer starts the bulk
//    copies, so they do not queue behind them.
//  * A thread's counter stays in a register across its item's chunks; the
//    int32 result is stored coalesced after the item's last chunk.

#include <cstdint>
#include <cuda_runtime.h>

#include "tnn_common.cuh"
#include "tnn_async.cuh"

#define TNN_STDP_MAX_THREADS 1024
#define TNN_STDP_MAX_TABLE 128
#define TNN_STDP_MAX_STAGES 8
#define TNN_STDP_VOLLEYS 4

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
  int tk, tw;                      // a tile: tk rows of i by tw columns of j
  int rows;                        // batch rows per stage
  int stages;                      // stages of the ring
  int group;                       // chunks per volley group, at most
  int bulk;                        // 1: bulk copies bring the uniforms; 0: cp.async
  int threads;                     // block size: tk * tw rounded up to 32, + 32
  int blocks;                      // persistent blocks
  int weights_out;                 // 1: clip(w + net, 0, w_max); 0: net
  float mu_c, mu_b, mu_s;          // float32, as the reference's compare sees them
  float table[TNN_STDP_MAX_TABLE]; // stabilize table, w_max + 1 entries
};

}  // extern "C"

// Sizes shared by the kernel and the launch checks; `plan`, `stage_bytes`
// and `smem_bytes` in stdp_update.py mirror them.
__host__ __device__ static inline int stdp_round4(int v) { return (v + 3) / 4 * 4; }
__host__ __device__ static inline int stdp_n(const StdpArgs& a) { return a.tk * a.tw; }
// floats between two rows of a stage (16-byte multiples for bulk copies)
__host__ __device__ static inline int stdp_ustride(const StdpArgs& a) {
  return stdp_round4(stdp_n(a));
}
// a volley buffer: the tile's weights (round4(n) bytes), then group * rows
// rows of tk x bytes and tw z bytes
__host__ __device__ static inline int stdp_vrow(const StdpArgs& a) { return a.tk + a.tw; }
__host__ __device__ static inline int stdp_vcap(const StdpArgs& a) {
  return TNN_STDP_VOLLEYS * (a.threads - 32);
}
__host__ __device__ static inline size_t stdp_smem_bytes(const StdpArgs& a) {
  return (size_t)16 * a.stages                                   // mbarriers
         + (size_t)a.stages * 8 * a.rows * stdp_ustride(a)       // the ring
         + (size_t)2 * stdp_vcap(a);                             // volleys
}

// One work item: site c, tile rows i in [i0, i0 + ni), columns j in
// [j0, j0 + nj); its synapses are [s0, s0 + nt) of the site's plane.
struct StdpItem {
  int c, i0, ni, j0, nj, s0, nt;
};

__device__ __forceinline__ StdpItem stdp_item(const StdpArgs& a, int item) {
  const int ti = (a.p + a.tk - 1) / a.tk, tj = (a.q + a.tw - 1) / a.tw;
  StdpItem u;
  u.c = item / (ti * tj);
  const int t = item - u.c * ti * tj, it = t / tj;
  u.i0 = it * a.tk;
  u.ni = min(a.tk, a.p - u.i0);
  u.j0 = (t - it * tj) * a.tw;
  u.nj = min(a.tw, a.q - u.j0);
  u.s0 = u.i0 * a.q + u.j0;
  u.nt = u.ni == 1 ? u.nj : u.ni * a.q;  // whole rows, or a piece of one
  return u;
}

// The producer warp's fill of one stage with rows [b0, b0 + nrows) of item u.
__device__ __forceinline__ void stdp_fill(const StdpArgs& a, const StdpItem& u,
                                          int b0, int nrows, float* up, float* dn,
                                          uint64_t* full, int lane) {
  const int us = stdp_ustride(a);
  const float* su = a.u_up + (long long)u.c * a.uu_sc + (long long)b0 * a.uu_sb + u.s0;
  const float* sd = a.u_dn + (long long)u.c * a.ud_sc + (long long)b0 * a.ud_sb + u.s0;
  if (a.bulk) {
    if (lane == 0) tnn_mbar_expect_tx(full, 8u * nrows * u.nt);
    __syncwarp();
    const uint32_t row_bytes = 4u * u.nt;
    if (u.nt == us && a.uu_sb == us && a.ud_sb == us) {  // one range per half
      if (lane == 0) tnn_bulk_load(up, su, row_bytes * nrows, full);
      if (lane == 1) tnn_bulk_load(dn, sd, row_bytes * nrows, full);
    } else {
      for (int k = lane; k < 2 * nrows; k += 32) {
        const int r = k >> 1;
        if (k & 1)
          tnn_bulk_load(dn + r * us, sd + r * a.ud_sb, row_bytes, full);
        else
          tnn_bulk_load(up + r * us, su + r * a.uu_sb, row_bytes, full);
      }
    }
  } else {
    for (int e = lane; e < nrows * u.nt; e += 32) {
      const int r = e / u.nt, s = e - r * u.nt;
      tnn_cp_async4(up + r * us + s, su + r * a.uu_sb + s);
      tnn_cp_async4(dn + r * us + s, sd + r * a.ud_sb + s);
    }
    tnn_cp_async_arrive(full);
  }
}

// This thread's share of a volley group of item u: rows [b0, b0 + grows)
// and, on the item's first group, its weights, in the buffer's order.
__device__ __forceinline__ void stdp_load_group(const StdpArgs& a, const StdpItem& u,
                                                int b0, int grows, int tid, int nthr,
                                                uint8_t (&v)[TNN_STDP_VOLLEYS]) {
  const int nw = stdp_round4(stdp_n(a)), vr = stdp_vrow(a);
  const int n = nw + grows * vr;
#pragma unroll
  for (int k = 0; k < TNN_STDP_VOLLEYS; ++k) {
    const int e = tid + k * nthr;
    v[k] = 0;
    if (e >= n) continue;
    if (e < nw) {  // the weight of tile thread e
      const int il = e / a.tw, jl = e - il * a.tw;
      if (b0 == 0 && il < u.ni && jl < u.nj)
        v[k] = (uint8_t)a.w[(size_t)u.c * a.p * a.q + (u.i0 + il) * a.q + u.j0 + jl];
      continue;
    }
    const int r = (e - nw) / vr, col = e - nw - r * vr;
    const long long b = b0 + r;
    if (col < a.tk) {
      if (col < u.ni)
        v[k] = a.x[b * a.x_sb + (long long)u.c * a.x_sc + (long long)(u.i0 + col) * a.x_si];
    } else if (col - a.tk < u.nj) {
      v[k] = a.z[b * a.z_sb + (long long)u.c * a.z_sc + (long long)(u.j0 + col - a.tk) * a.z_sj];
    }
  }
}

__device__ __forceinline__ void stdp_store_group(const StdpArgs& a, int grows, int tid,
                                                 int nthr, const uint8_t (&v)[TNN_STDP_VOLLEYS],
                                                 uint8_t* dst) {
  const int n = stdp_round4(stdp_n(a)) + grows * stdp_vrow(a);
#pragma unroll
  for (int k = 0; k < TNN_STDP_VOLLEYS; ++k) {
    const int e = tid + k * nthr;
    if (e < n) dst[e] = v[k];
  }
}

// Named barriers among the counting warps (id 1), and the producer's wait
// for the counters' first volley loads to be issued (id 2).
__device__ __forceinline__ void stdp_sync_counters(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

__global__ void __launch_bounds__(TNN_STDP_MAX_THREADS)
tnn_stdp_kernel(const __grid_constant__ StdpArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float tab[TNN_STDP_MAX_TABLE];
  const int tid = threadIdx.x, lane = tid & 31;
  const int counters = blockDim.x - 32;  // the last warp produces
  const int PQ = a.p * a.q, NS = a.stages, us = stdp_ustride(a);
  const int items = a.C * ((a.p + a.tk - 1) / a.tk) * ((a.q + a.tw - 1) / a.tw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + NS;
  float* ring = reinterpret_cast<float*>(smem + 16 * NS);
  const int stage_floats = 2 * a.rows * us;
  uint8_t* vbuf = reinterpret_cast<uint8_t*>(ring + NS * stage_floats);
  const int vcap = stdp_vcap(a);

  for (int k = tid; k <= a.w_max; k += blockDim.x) tab[k] = a.table[k];
  if (tid == 0)
    for (int s = 0; s < NS; ++s) {
      tnn_mbar_init(&full[s], a.bulk ? 1 : 32);
      tnn_mbar_init(&empty[s], counters / 32);
    }
  __syncthreads();

  // Both roles walk the same chunks: items blockIdx.x, + gridDim.x, ..., each
  // in chunks of `rows` batch rows, through stage st of round parity ph.
  int st = 0;
  uint32_t ph = 0;
  if (tid >= counters) {  // the producer warp
    asm volatile("bar.sync 2, %0;\n" ::"r"(blockDim.x) : "memory");
    bool refill = false;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const StdpItem u = stdp_item(a, item);
      for (int b0 = 0; b0 < a.B; b0 += a.rows) {
        if (refill) tnn_mbar_wait(&empty[st], ph ^ 1);
        float* up = ring + st * stage_floats;
        stdp_fill(a, u, b0, min(a.rows, a.B - b0), up, up + a.rows * us, &full[st], lane);
        if (++st == NS) st = 0, ph ^= 1, refill = true;
      }
    }
    tnn_cp_async_wait_all();
    return;
  }

  // The counting warps. Volley groups: an item's chunks, `group` at a time.
  const int grow_max = a.group * a.rows, vr = stdp_vrow(a);
  const int il = tid / a.tw, jl = tid - (tid / a.tw) * a.tw;
  uint8_t v[TNN_STDP_VOLLEYS];
  int item = blockIdx.x, gb0 = 0, buf = 0;
  StdpItem u{};
  if (item < items) {
    u = stdp_item(a, item);
    stdp_load_group(a, u, 0, min(grow_max, a.B), tid, counters, v);
  }
  asm volatile("bar.arrive 2, %0;\n" ::"r"(blockDim.x) : "memory");
  if (item < items) stdp_store_group(a, min(grow_max, a.B), tid, counters, v, vbuf);
  stdp_sync_counters(counters);
  int wv = 0, acc = 0;
  float pc = 0.f, pb = 0.f;
  while (item < items) {
    const int grows = min(grow_max, a.B - gb0);
    // the next group's volleys on their way while this one is counted
    int nitem = item, ngb0 = gb0 + grows;
    if (ngb0 >= a.B) nitem += gridDim.x, ngb0 = 0;
    StdpItem nu = u;
    if (nitem < items) {
      if (nitem != item) nu = stdp_item(a, nitem);
      stdp_load_group(a, nu, ngb0, min(grow_max, a.B - ngb0), tid, counters, v);
    }
    const uint8_t* vb = vbuf + buf * vcap;
    const bool live = il < u.ni && jl < u.nj;
    if (gb0 == 0 && live) {
      wv = (int)(int8_t)vb[tid];
      const float f = tnn_stabilize(tab, wv, a.w_max);
      pc = a.mu_c * f;
      pb = a.mu_b * f;
      acc = 0;
    }
    const uint8_t* xv = vb + stdp_round4(stdp_n(a)) + il;
    const uint8_t* zv = xv - il + a.tk + jl;
    for (int b0 = gb0; b0 < gb0 + grows; b0 += a.rows) {
      const int nrows = min(a.rows, a.B - b0);
      const float* up = ring + st * stage_floats + tid;
      const float* dn = up + a.rows * us;
      tnn_mbar_wait(&full[st], ph);
      if (live) {
#pragma unroll 4
        for (int r = 0; r < nrows; ++r)
          acc += tnn_stdp_vote(xv[r * vr], zv[r * vr], a.T, pc, pb, a.mu_s,
                               up[r * us], dn[r * us]);
      }
      xv += nrows * vr;
      zv += nrows * vr;
      __syncwarp();
      if (lane == 0) tnn_mbar_arrive(&empty[st]);
      if (++st == NS) st = 0, ph ^= 1;
    }
    if (ngb0 == 0 && live)  // the item's last group
      a.out[(size_t)u.c * PQ + (u.i0 + il) * a.q + u.j0 + jl] =
          a.weights_out ? min(max(wv + acc, 0), a.w_max) : acc;
    // every counter is done with the other buffer (group g - 1)
    if (nitem < items)
      stdp_store_group(a, min(grow_max, a.B - ngb0), tid, counters, v,
                       vbuf + (buf ^ 1) * vcap);
    stdp_sync_counters(counters);
    item = nitem, gb0 = ngb0, buf ^= 1, u = nu;
  }
}

extern "C" {

// Dynamic shared memory one launch with these arguments needs.
size_t tnn_stdp_smem_bytes(const StdpArgs* a) { return stdp_smem_bytes(*a); }

static int stdp_check(const StdpArgs* a) {
  const long long pq = (long long)a->p * a->q;
  if (a->B < 1 || a->C < 1 || a->p < 1 || a->q < 1 || pq > 0x7fffffffLL ||
      a->tk < 1 || a->tw < 1 || a->tk > a->p || a->tw > a->q ||
      (a->tk > 1 && a->tw != a->q) || a->rows < 1 || a->group < 1 ||
      a->stages < 1 || a->stages > TNN_STDP_MAX_STAGES ||
      a->threads != (a->tk * a->tw + 31) / 32 * 32 + 32 ||
      a->threads > TNN_STDP_MAX_THREADS ||
      (long long)a->C * ((a->p + a->tk - 1) / a->tk) * ((a->q + a->tw - 1) / a->tw) >
          0x7fffffffLL ||
      // one group's volleys and weights fit a buffer
      stdp_round4(a->tk * a->tw) + (long long)a->group * a->rows * (a->tk + a->tw) >
          stdp_vcap(*a) ||
      a->w_max < 0 || a->w_max >= TNN_STDP_MAX_TABLE)
    return (int)cudaErrorInvalidValue;
  if (a->bulk) {  // bulk copies need 16-byte aligned addresses and sizes
    const long long n = a->tk * a->tw;
    const unsigned long long mis =
        (unsigned long long)a->u_up | (unsigned long long)a->u_dn |
        (unsigned long long)(a->uu_sc | a->uu_sb | a->ud_sc | a->ud_sb | pq | n |
                             (a->tk == 1 ? a->q : 0)) << 2;
    if (mis & 15) return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// Blocks of this launch that fit one SM (occupancy query; `blocks` and the
// pointers are not read, but the bulk flag is checked against the strides);
// also opts the kernel in to all the dynamic shared memory the card has.
// < 0: -(CUDA error).
int tnn_stdp_blocks_per_sm(const StdpArgs* a) {
  const int bad = stdp_check(a);
  if (bad) return -bad;
  // opt in to all the dynamic shared memory the card allows, not just this
  // plan's, so that no later plan's query lowers what an earlier one needs
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, tnn_stdp_kernel);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(tnn_stdp_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - (int)fa.sharedSizeBytes);
  if (e != cudaSuccess) return -(int)e;
  int n = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, tnn_stdp_kernel,
                                                    a->threads, stdp_smem_bytes(*a));
  return e != cudaSuccess ? -(int)e : n;
}

// Enqueue one layer's update on `stream`; returns cudaGetLastError(). The
// caller has called tnn_stdp_blocks_per_sm with the same plan on this device.
int tnn_stdp_launch(const StdpArgs* a, void* stream) {
  const int bad = stdp_check(a);
  if (bad) return bad;
  if (a->blocks < 1) return (int)cudaErrorInvalidValue;
  tnn_stdp_kernel<<<a->blocks, a->threads, stdp_smem_bytes(*a),
                    (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

const char* tnn_stdp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
