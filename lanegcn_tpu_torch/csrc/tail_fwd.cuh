// The residual row tail's forward chain on wgmma accumulators, shared by the
// bf16 forwards that end in it: lane_layer_tc_kernel (lane_layer.cu; x =
// temp, already in the accumulators of the band products) and
// row_tail_tc_kernel (row_tail.cu, K = 1 and K = 2; x loaded from a staged
// tile):
//
//   h = rnd(relu(GN1(x)));  z = h @ W;  out = relu(GN2(z) + res)
//
// A warpgroup holds 64 rows in the m64n128 accumulator layout: each thread
// two rows (tc::acc_row) of 32 columns, a row's 128 columns in the 4 lanes
// of a quad, so GN's row statistics finish with two xor shuffles
// (tc::acc_row_stats). One k16 slice of that layout is the register-A
// fragment of wgmma, so h goes from the registers it is computed in to the
// product without shared memory (`gn_relu_frags`, `frag_mm`).
//
// Each helper takes the row width W (default 128; 64 for Att's tail on the
// actor side, row_tail.cu): a W-wide row is accumulator elements i < W/2 and
// k slices ks < W/16, padded columns hold zeros, and the statistics are
// over W columns (common.cuh).
#pragma once

#include "common.cuh"

namespace lgk {
namespace tail {

// h = rnd(relu((v − μ)·inv·gw + gb)) of the thread's two accumulator rows
// (single-group GN statistics of v), as the A fragments of h @ W: fragment
// register q of k slice ks holds accumulator elements 8ks + 2q, + 1 (zero
// past W).
template <int W = C>
__device__ __forceinline__ void gn_relu_frags(const float (&v)[64], const float* gw,
                                              const float* gb, float eps,
                                              uint32_t (&ha)[C / 16][4]) {
  float mu[2], inv[2];
  tc::acc_row_stats<W>(v, eps, mu, inv);
#pragma unroll
  for (int ks = 0; ks < C / 16; ++ks) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (ks >= W / 16) {
        ha[ks][q] = 0u;
        continue;
      }
      const int i = 8 * ks + 2 * q, h = tc::acc_half(i), c = tc::acc_col(i);
      const float x0 = (v[i] - mu[h]) * inv[h] * gw[c] + gb[c];
      const float x1 = (v[i + 1] - mu[h]) * inv[h] * gw[c + 1] + gb[c + 1];
      ha[ks][q] = tc::pack_bf2(fmaxf(x0, 0.f), fmaxf(x1, 0.f));
    }
  }
}

// acc = h @ W over K = W (128 or 64), h as register-A fragments, W [128 x
// 128] (zero past a narrower W) read MN-major from core tiles; waits for the
// products.
template <int W = C>
__device__ __forceinline__ void frag_mm(float (&acc)[64], const uint32_t (&ha)[C / 16][4],
                                        const tc::Tiles& w) {
  tc::zero(acc);
  tc::fence_acc(acc);
  tc::fence();
#pragma unroll
  for (int ks = 0; ks < W / 16; ++ks) tc::mma_rs<1>(acc, ha[ks], tc::desc(w, false, ks, 0));
  tc::commit();
  tc::wait_all();
  tc::fence_acc(acc);
}

// out = relu((z − μ)·inv·gw + gb + res) of the thread's two accumulator
// rows: res(r, c) gives the residual's float2 at the warpgroup's row r and
// columns c, c + 1; store(r, c, y0, y1) takes the two outputs (only
// columns below W).
template <int W = C, class Res, class Store>
__device__ __forceinline__ void gn_res_relu(const float (&z)[64], const float* gw,
                                            const float* gb, float eps, Res res, Store store) {
  float mu[2], inv[2];
  tc::acc_row_stats<W>(z, eps, mu, inv);
#pragma unroll
  for (int i = 0; i < W / 2; i += 2) {
    const int r = tc::acc_row(i), c = tc::acc_col(i), h = tc::acc_half(i);
    const float2 rv = res(r, c);
    const float y0 = (z[i] - mu[h]) * inv[h] * gw[c] + gb[c] + rv.x;
    const float y1 = (z[i + 1] - mu[h]) * inv[h] * gw[c + 1] + gb[c + 1] + rv.y;
    store(r, c, fmaxf(y0, 0.f), fmaxf(y1, 0.f));
  }
}

}  // namespace tail
}  // namespace lgk
