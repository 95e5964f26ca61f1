// Arithmetic shared by the port's Hopper kernels (tnn_wave.cu, tnn_column.cu,
// stdp_update.cu): the parity-critical bodies, kept in one place as the JAX
// package keeps `ramp_matmul` / `crossing_wta` (src/repro/kernels/
// tnn_column.py) and `stdp_net_tile` (src/repro/kernels/stdp_update.py) in
// one place for its Pallas kernels.
//
// The ramp body: the reference's own factorization on int8 tensor cores.
// `ramp_matmul` writes the RNL body potential as a 0/1 matrix product,
//   V[(b,t), j] = sum_{(i,k)} A[(b,t),(i,k)] * N[(i,k),j]
//   A[(b,t),(i,k)] = [x_bi + k <= t]        N[(i,k),j] = [k <= w_ij]
// with ramp steps k = 1..T there. Since t <= T-1 and x >= 0, the steps
// k >= T never contribute, so here each synapse takes Kw = T-1 rounded up
// to a multiple of 4 steps (T is a power of two, so Kw = max(T, 4)), the
// extra steps reading 0. Every operand is 0 or 1 and every sum at most
// p * (T-1), so `mma.sync` m16n8k32 s8 x s8 -> s32 gives the reference's
// bf16/f32 product bit for bit. The K axis is (synapse, step) with the step
// fastest (tnn_layer_t8 orders the groups inside each k32 step its own way;
// tests/test_torch_ramp.py restates both): one 4-byte fragment
// register holds 4 consecutive steps of ONE synapse, built in registers
// from a single volley or weight byte as a thermometer code. The M axis is (batch row, tick) with the tick fastest,
// so 16/T rows share an m16 tile when T <= 16 and a row spans T/16 tiles
// when T > 16; the N axis is the neurons, n8 tiles, two at a time.
//
// Cost on this card: the padded product is ~Kw/2 times the direct form's
// integer work, but at the tensor cores' int8 rate that is a few percent of
// the time; what is left is building the fragments (a few integer
// instructions per 4 bytes of A), the crossing votes and the WTA.

#pragma once

#include <cstdint>
#include <type_traits>

// Bytes e = 0..3 of the result are [k0 + e <= d]: four consecutive ramp
// steps of one synapse as a 0/1 thermometer code, lowest step in the lowest
// byte (element order of an mma fragment register). A: d = t - x (a volley
// of T, no spike, gives 0). N: d = w.
__device__ __forceinline__ uint32_t tnn_thermo4(int d, int k0) {
  const int s = max(8 * (k0 + 3 - d), 0);  // 8 * (4 - bytes set), >= 32 -> 0
  return __funnelshift_rc(0x01010101u, 0u, (unsigned)s);
}

// acc += A (16x32, row) * B (32x8, col), int8 in, int32 accumulate.
__device__ __forceinline__ void tnn_mma_s8(int (&acc)[4], const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Per-row 1-WTA over zpre (rows x Q, in shared memory): the minimum key
// z * Q + j (earliest spike, ties to the lowest index) if its z < T, else T
// (the all-T row stays all T). best[r] receives the winner's key; the
// caller syncs between the two passes.
__device__ __forceinline__ void tnn_row_best(const int* zpre, int nrows, int Q,
                                             int* best, int tid, int nthr) {
  for (int r = tid; r < nrows; r += nthr) {
    int b = zpre[r * Q] * Q;
    for (int j = 1; j < Q; ++j) b = min(b, zpre[r * Q + j] * Q + j);
    best[r] = b;
  }
}

__device__ __forceinline__ int tnn_wta_keep(int zj, int j, int Q, int T, int best) {
  return (zj * Q + j == best && zj < T) ? zj : T;
}

// K steps of tnn_layer_t8, whose N fragments a warp keeps in registers for
// the whole layer: 8 steps = 32 synapses at T = 8, layer 1's fan-in.
#define TNN_T8_KS 8

// Pre-WTA crossing times of one layer for one chunk of batch rows, by the
// calling warp's share of the chunk's m16 tiles:
//   zpre[r * Q + j] = first t with V[r, t, j] >= theta, else T,   r < nrows
// xs      the chunk's volleys, row r at xs + r * xrs, P bytes each; rows in
//         [nrows, rows) may hold anything (they are never written out), and
//         rows must be a multiple of 16/T when T < 16
// w       the site's weights, [synapse][neuron], P * Q int8 (shared or
//         device memory)
// N's fragments are rebuilt from w in the K loop of every tile (any P).
// Every lane of the warp must call it (it votes); the caller syncs before
// reading zpre.
__device__ __forceinline__ void tnn_layer_crossings(
    const uint8_t* xs, int xrs, int rows, int nrows, const int8_t* w, int P,
    int Q, int T, int theta, int* zpre, int warp, int nwarps) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int lT = __ffs(T) - 1;
  const int Kw = T < 4 ? 4 : T, lkw = T < 4 ? 2 : lT;
  const int KS = (P * Kw + 31) >> 5;               // k32 steps
  const int S = T > 16 ? T >> 4 : 1;               // m16 tiles per unit
  const int n_units = T >= 16 ? rows : (rows * T) >> 4;
  // A lane's fragment rows g and g + 8 hold the ticks t_lo, t_hi (plus 16
  // per sub-tile when T > 16); the lanes of one row are the fragment rows
  // g0 .. g0 + min(T, 8) - 1 of the same tig, lane bits 4 * g + tig.
  const int g0 = T >= 8 ? 0 : (g & ~(T - 1));
  const unsigned vshift = 4 * g0 + tig;
  const unsigned vmask = T >= 8 ? 0x11111111u : (0x11111111u >> (32 - 4 * T));

  // Synapse and first ramp step of this lane's fragment half h of step s.
  auto k_of = [&](int s, int h, int& i, int& k0) {
    const int kk = (s << 5) + (h << 4) + (tig << 2);
    i = kk >> lkw;
    k0 = (kk & (Kw - 1)) + 1;
  };
  auto nfrag = [&](int s, int n0, int h) -> uint32_t {
    int i, k0;
    k_of(s, h, i, k0);
    const int j = n0 + g;
    const int wv = (i < P && j < Q) ? (int)w[i * Q + j] : 0;
    return tnn_thermo4(wv, k0);
  };

  for (int n0 = 0; n0 < Q; n0 += 16) {
    const bool two = n0 + 8 < Q;                   // second n8 tile live
    for (int u = warp; u < n_units; u += nwarps) {
      int zc[2][4];                                // [n8 tile][acc slot]
#pragma unroll
      for (int e = 0; e < 8; ++e) zc[e >> 2][e & 3] = T;
      const int r_lo = ((u * S) << 4 >> lT) + (g >> lT);
      const int r_hi = ((u * S) << 4 >> lT) + ((g + 8) >> lT);
      const uint8_t* x_lo = xs + r_lo * xrs;
      const uint8_t* x_hi = xs + r_hi * xrs;
      for (int sub = 0; sub < S; ++sub) {
        const int t_lo = ((sub << 4) + g) & (T - 1);
        const int t_hi = ((sub << 4) + g + 8) & (T - 1);
        int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
        for (int s = 0; s < KS; ++s) {
          uint32_t a[4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            int i, k0;
            k_of(s, h, i, k0);
            const bool live = i < P;
            const int xl = live ? (int)x_lo[i] : T;
            const int xh = live ? (int)x_hi[i] : T;
            a[2 * h] = tnn_thermo4(t_lo - xl, k0);
            a[2 * h + 1] = tnn_thermo4(t_hi - xh, k0);
          }
          tnn_mma_s8(acc[0], a, nfrag(s, n0, 0), nfrag(s, n0, 1));
          if (two) tnn_mma_s8(acc[1], a, nfrag(s, n0 + 8, 0), nfrag(s, n0 + 8, 1));
        }
        // accumulator slots: 0, 1 row g (t_lo), 2, 3 row g + 8 (t_hi). One
        // vote per slot; a row's first crossing tick is its lowest set lane
        // among the lanes that hold its ticks.
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const unsigned m =
              (__ballot_sync(0xffffffffu, acc[e >> 2][e & 3] >= theta) >> vshift) & vmask;
          const int base = T >= 16 ? (sub << 4) + ((e & 2) << 2) : 0;
          const int cand = m ? base + ((__ffs(m) - 1) >> 2) : T;
          zc[e >> 2][e & 3] = min(zc[e >> 2][e & 3], cand);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {                // (n8 tile, column)
        const int nt = e >> 1, col = e & 1;
        const int j = n0 + 8 * nt + 2 * tig + col;
        if (j >= Q) continue;
        if (T >= 16) {                             // one row: both halves
          if (g == 0 && u < nrows)
            zpre[u * Q + j] = min(zc[nt][col], zc[nt][2 + col]);
        } else if (g == g0) {
          if (r_lo < nrows) zpre[r_lo * Q + j] = zc[nt][col];
          if (r_hi < nrows) zpre[r_hi * Q + j] = zc[nt][2 + col];
        }
      }
    }
  }
}

// The same layer at the prototype's shapes (T = 8, P a multiple of 4 up to
// 32, Q <= 16), with everything fixed at compile time that can be. Kw = 8,
// and within k32 step s the K order puts synapse 4s + tig in fragment group
// (h, tig) for both halves h (ramp steps 4h+1 .. 4h+4): the two halves of a
// lane's fragments then come from one volley byte per row and one weight
// byte per n8 tile, each as two funnel shifts of one register. A k32 step
// is one 16x16 tile of (2 rows x 8 ticks) x 16 neurons, N in registers for
// the whole layer, two such units per pass for independent work. The
// crossing: one vote per accumulator slot, and lane g decodes slot g. The
// warp then holds whole rows, so the 1-WTA is a min over the 16 lanes of a
// row (4 shuffles), and each lane hands its (row, neuron) result to
// emit(r, j, z) itself: no block-wide pass.
__host__ __device__ __forceinline__ bool tnn_t8_shape(int P, int Q, int T) {
  return T == 8 && (P & 3) == 0 && P <= 4 * TNN_T8_KS && Q <= 16;
}

template <typename Emit>
__device__ __forceinline__ void tnn_layer_t8(
    const uint8_t* xs, int xrs, int rows, int nrows, const int8_t* w, int P,
    int Q, int theta, bool wta, int warp, int nwarps, Emit emit) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int KS = P >> 2;
  const bool two = Q > 8;
  // Steps 1..4 of a count c >= 0 (bytes [e < c]): lo4(8c), saturating at
  // 32; steps 5..8: hi4(8 * (8 - c)) for 8 - c >= 0. One register of ones,
  // opaque to the compiler so it is not rebuilt for every use.
  uint32_t ones = 0x01010101u;
  asm volatile("" : "+r"(ones));
  auto lo4 = [&](int s) { return __funnelshift_lc(ones, 0u, (unsigned)s); };
  auto hi4 = [&](int s) { return __funnelshift_rc(ones, 0u, (unsigned)s); };
  uint32_t nb[TNN_T8_KS][4];   // N: the count is w
#pragma unroll
  for (int s = 0; s < TNN_T8_KS; ++s)
    if (s < KS) {
      const int8_t* wi = w + (4 * s + tig) * Q;
      const int w0 = g < Q ? (int)wi[g] : 0, w1 = g + 8 < Q ? (int)wi[g + 8] : 0;
      nb[s][0] = lo4(max(8 * w0, 0));
      nb[s][1] = hi4(max(64 - 8 * w0, 0));
      nb[s][2] = lo4(max(8 * w1, 0));
      nb[s][3] = hi4(max(64 - 8 * w1, 0));
    }
  // A: the count is t - x with t = g in both fragment rows; e8 = 8 * (8 -
  // (t - x)) >= 8 for any volley byte
  const int e8g = 64 - 8 * g;
  auto afrag = [&](int x, uint32_t& h0, uint32_t& h1) {
    const int e8 = 8 * x + e8g;
    h1 = hi4(e8);
    h0 = lo4(max(64 - e8, 0));
  };
  // this lane's result: slot g of the accumulators, n8 tile g >> 2, row
  // 2u + ((g >> 1) & 1), column 2 * tig + (g & 1)
  const int j = 8 * (g >> 2) + 2 * tig + (g & 1);
  const int rh = (g >> 1) & 1;
  const int n_units = rows >> 1;                     // unit u: rows 2u, 2u + 1
  // NP (1 or 2) units per pass: two where the warp has two left, for
  // independent work; the branch is uniform over the warp.
  auto pass = [&](int u0, auto np) {
    constexpr int NP = decltype(np)::value;
    int uu[NP];
    const uint8_t* xp[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      uu[p] = u0 + p * nwarps;
      xp[p] = xs + 2 * uu[p] * xrs + tig;
    }
    int acc[NP][2][4] = {};
#pragma unroll
    for (int s = 0; s < TNN_T8_KS; ++s)
      if (s < KS) {
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          uint32_t a[4];   // (row lo, steps 1-4), (row hi, 1-4), (lo, 5-8), (hi, 5-8)
          afrag(xp[p][4 * s], a[0], a[2]);
          afrag(xp[p][xrs + 4 * s], a[1], a[3]);
          tnn_mma_s8(acc[p][0], a, nb[s][0], nb[s][1]);
          if (two) tnn_mma_s8(acc[p][1], a, nb[s][2], nb[s][3]);
        }
      }
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      // a slot's ticks are lane bits 4 * t + tig of its vote
      unsigned m = 0;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const unsigned v = __ballot_sync(0xffffffffu, acc[p][e >> 2][e & 3] >= theta);
        if (e == g) m = v;
      }
      m = (m >> tig) & 0x11111111u;
      int z = m ? (__ffs(m) - 1) >> 2 : 8;
      const int r = 2 * uu[p] + rh;
      const bool live = j < Q && r < nrows;
      if (wta) {  // min key over the row's lanes: lane bits 0, 1, 2 and 4
        int best = live ? z * Q + j : 0x7fffffff;
        best = min(best, __shfl_xor_sync(0xffffffffu, best, 1));
        best = min(best, __shfl_xor_sync(0xffffffffu, best, 2));
        best = min(best, __shfl_xor_sync(0xffffffffu, best, 4));
        best = min(best, __shfl_xor_sync(0xffffffffu, best, 16));
        z = tnn_wta_keep(z, j, Q, 8, best);
      }
      if (live) emit(r, j, z);
    }
  };
  for (int u0 = warp; u0 < n_units; u0 += 2 * nwarps) {
    if (u0 + nwarps < n_units)
      pass(u0, std::integral_constant<int, 2>{});
    else
      pass(u0, std::integral_constant<int, 1>{});
  }
}

// F[w] by the reference's select chain: a weight outside [1, w_max] reads
// F[0].
__device__ __forceinline__ float tnn_stabilize(const float* table, int wv,
                                               int w_max) {
  return (wv >= 1 && wv <= w_max) ? table[wv] : table[0];
}

// One (input x, output z) pair's vote on one synapse: +1 when the up
// Bernoulli fires, -1 when the down one fires (both may). The case planes are
// stdp_net_tile's; pc = f32(mu_capture) * F and pb = f32(mu_backoff) * F are
// built by the caller in float32. Capture and search exclude each other, so
// p_up = capture ? pc : (search ? mu_s : 0), which is the reference's
// capture * pc + search * mu_s bit for bit.
__device__ __forceinline__ int tnn_stdp_vote(int xv, int zv, int T, float pc,
                                             float pb, float mu_s, float uu,
                                             float ud) {
  const bool xf = xv < T, zf = zv < T;
  const bool cap = xf && zf && (xv <= zv);
  const bool back = (xf && zf && (xv > zv)) || (!xf && zf);
  const bool sea = xf && !zf;
  const float p_up = cap ? pc : (sea ? mu_s : 0.0f);
  const float p_dn = back ? pb : 0.0f;
  return (int)(uu < p_up) - (int)(ud < p_dn);
}
