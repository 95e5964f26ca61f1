// Arithmetic shared by the port's Hopper kernels (tnn_wave.cu, tnn_column.cu,
// stdp_update.cu): the parity-critical bodies, kept in one place as the JAX
// package keeps `ramp_matmul` / `crossing_wta` (src/repro/kernels/
// tnn_column.py) and `stdp_net_tile` (src/repro/kernels/stdp_update.py) in
// one place for its Pallas kernels.
#pragma once

#include <cstdint>

// First wave position t in [0, T) at which the body potential
//   V[t] = sum_i min(max(t - x_i, 0), w_i),   x_i = x[i * xs], w_i = w[i * ws]
// reaches theta, else T. Computed in int32; it equals the reference's bf16
// A@N 0/1 product exactly, since every operand is a small integer and a ramp
// never exceeds T-1.
__device__ __forceinline__ int tnn_crossing(const uint8_t* x, int xs,
                                            const int8_t* w, int ws,
                                            int P, int T, int theta) {
  for (int t = 0; t < T; ++t) {
    int V = 0;
    for (int i = 0; i < P; ++i) {
      const int ramp = max(t - (int)x[i * xs], 0);
      V += min(ramp, (int)w[i * ws]);
    }
    if (V >= theta) return t;
  }
  return T;
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
