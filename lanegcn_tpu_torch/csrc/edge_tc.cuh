// The per-row chain's bf16 pieces on wgmma accumulators, shared by the
// tensor-core passes of win_edge.cu (Att's window-pair chain, forward and
// backward), edge_mlp.cu (LanePooling's flat edge chain, forward and
// backward) and row_tail.cu (LanePooling's two-Linear tail, backward), and
// the staged core tiles they read rows from and write rows through.
//
// A warpgroup holds 64 rows in the m64n128 accumulator layout: each thread
// two rows (tc::acc_row: r and r + 8) of 32 columns, a row's 128 columns in
// the 4 lanes of a quad. Activations that feed the next product leave the
// accumulators as bf16 pairs (element i and i + 1 in register i / 2), which
// is also wgmma's register-A fragment (k slice ks: registers 4ks .. 4ks + 3),
// so the chain runs from product to product without shared memory.
#pragma once

#include "common.cuh"

namespace lgk {

// The warpgroup's 128 threads (named barrier 1 + warpgroup).
__device__ __forceinline__ void wg_sync() {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + (threadIdx.x >> 7)) : "memory");
}

__device__ __forceinline__ float2 ld_bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 unpack_bf2(uint32_t u) {
  __nv_bfloat162 h;
  memcpy(&h, &u, 4);
  return __bfloat1622float2(h);
}

// Rows [row0, row0 + n) of a [e, C] bf16 matrix into core tiles at dst
// (tc::tiles(dst, n)) by cp.async, zeros past e; thread t of `threads`
// copies 16-byte chunks, a warp two whole rows at a time.
__device__ __forceinline__ void fetch_rows(uint8_t* dst, const bf16* src, long row0, int n,
                                           int e, int t, int threads) {
  const tc::Tiles T = tc::tiles(dst, n);
  for (int i = t; i < n * (C / 8); i += threads) {
    const int r = i >> 4, c = (i & 15) * 8;
    const bool in = row0 + r < e;
    cp_async16_zfill(dst + tc::tile_off(T, r, c), in ? src + (row0 + r) * C + c : src,
                     in ? 16 : 0);
  }
}

// Columns c, c + 1 of row r of a staged core tile.
__device__ __forceinline__ float2 staged_pair(const uint8_t* X_b, const tc::Tiles& X, int r,
                                              int c) {
  return unpack_bf2(*reinterpret_cast<const uint32_t*>(X_b + tc::tile_off(X, r, c)));
}

// acc ← the thread's two rows (r0 and r0 + 8) of a staged core tile, in the
// accumulator layout.
__device__ __forceinline__ void load_pairs(float (&acc)[64], const uint8_t* X_b,
                                           const tc::Tiles& X, int r0) {
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const float2 v = staged_pair(X_b, X, r0 + 8 * tc::acc_half(i), tc::acc_col(i));
    acc[i] = v.x;
    acc[i + 1] = v.y;
  }
}

// bf16 pairs (the accumulator layout of the thread's rows r0, r0 + 8) into
// a staged core tile.
__device__ __forceinline__ void put_pairs(uint8_t* X_b, const tc::Tiles& X, int r0,
                                          const uint32_t (&a)[32]) {
#pragma unroll
  for (int i = 0; i < 64; i += 2)
    *reinterpret_cast<uint32_t*>(X_b + tc::tile_off(X, r0 + 8 * tc::acc_half(i), tc::acc_col(i))) =
        a[i / 2];
}

// s += the row's additions (add(h, c, s[i], s[i + 1]) for the thread's row h
// at columns c, c + 1); then acc ← nrm_s, GN_ch's normalised rows, and e1 =
// rnd(relu(nrm_s ⊙ w + b)) as bf16 pairs (the register-A fragments of
// e1 @ Wout). inv: s's 1/sqrt(var + eps) per row.
template <class Add>
__device__ __forceinline__ void e1_from_s(float (&acc)[64], Add add, const float* w,
                                          const float* b, float eps, float (&inv)[2],
                                          uint32_t (&e1)[32]) {
#pragma unroll
  for (int i = 0; i < 64; i += 2) add(tc::acc_half(i), tc::acc_col(i), acc[i], acc[i + 1]);
  float mu[2];
  tc::acc_row_stats(acc, eps, mu, inv);
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int h = tc::acc_half(i), c = tc::acc_col(i);
    acc[i] = (acc[i] - mu[h]) * inv[h];
    acc[i + 1] = (acc[i + 1] - mu[h]) * inv[h];
    e1[i / 2] = tc::pack_bf2(fmaxf(acc[i] * w[c] + b[c], 0.f),
                             fmaxf(acc[i + 1] * w[c + 1] + b[c + 1], 0.f));
  }
}

// acc += A B with A the warpgroup's 64 rows as register-A fragments (a:
// bf16 pairs of an m64n128 accumulator's layout) and B a [128 x 128] weight
// from core tiles, read MN-major (B = W) or, with BT, K-major (B = Wᵀ);
// issued, committed and waited for.
template <bool BT = false>
__device__ __forceinline__ void mm_frag(float (&acc)[64], const uint32_t (&a)[32],
                                        const tc::Tiles& b) {
  tc::fence_acc(acc);
  tc::fence();
#pragma unroll
  for (int ks = 0; ks < C / 16; ++ks)
    tc::mma_rs<BT ? 0 : 1>(acc, *reinterpret_cast<const uint32_t(*)[4]>(&a[4 * ks]),
                           tc::desc(b, BT, ks, 0));
  tc::commit();
  tc::wait_all();
  tc::fence_acc(acc);
}

// One stage of col_sums' butterfly: slots 0 .. M−1 keep the lane's half of
// slots 0 .. 2M−1 (the low half where lane bit M is clear) plus its
// partner's (lane ^ M) sum of the same columns. A template, so that every
// index is a constant and x stays in registers.
template <int M>
__device__ __forceinline__ void col_stage(float (&x)[32], int lane) {
  const bool hi = (lane & M) != 0;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const float send = hi ? x[j] : x[j + M];
    const float keep = hi ? x[j + M] : x[j];
    x[j] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
}

// v[k] += the sum over the tile's 64 rows of a[i]·b[i] (MUL) or a[i], for
// this lane's 4 columns (2g·8 + 2q + {0, 1} and (2g + 1)·8 + 2q + {0, 1},
// g = lane / 4, q = lane % 4). The thread's two rows are added first, then
// a halving butterfly over the 8 lanes of one q: each stage keeps half of
// the columns and sends the other half to its partner (28 shuffles).
template <bool MUL>
__device__ __forceinline__ void col_sums(float (&v)[4], const float (&a)[64],
                                         const float (&b)[64]) {
  const int lane = threadIdx.x & 31;
  float x[32];  // slot j: columns of accumulator elements 4(j >> 1) + (j & 1) (+2)
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int i0 = 4 * (j >> 1) + (j & 1), i1 = i0 + 2;
    x[j] = MUL ? a[i0] * b[i0] + a[i1] * b[i1] : a[i0] + a[i1];
  }
  col_stage<16>(x, lane);
  col_stage<8>(x, lane);
  col_stage<4>(x, lane);
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] += x[k];
}

// The column of the lane's column sum j (0..3) in col_sums' layout.
__device__ __forceinline__ int col_sum_col(int j) {
  const int lane = threadIdx.x & 31;
  return (2 * (lane >> 2) + (j >> 1)) * 8 + 2 * (lane & 3) + (j & 1);
}

// GroupNorm backward on the accumulators: d[i] = inv·(d_nrm − mean(d_nrm) −
// nrm·mean(d_nrm·nrm)), d_nrm = dy[i]·w[col], per row (as common.cuh
// gn_bwd_row), returned as bf16 pairs in `out` (element pair i/2).
__device__ __forceinline__ void gn_bwd_acc(const float (&dy)[64], const float (&nrm)[64],
                                           const float (&inv)[2], const float* w,
                                           uint32_t (&out)[32]) {
  float c1[2] = {0.f, 0.f}, c2[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float dn = dy[i] * w[tc::acc_col(i)];
    c1[tc::acc_half(i)] += dn;
    c2[tc::acc_half(i)] += dn * nrm[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    c1[h] = tc::quad_sum(c1[h]) * (1.f / C);
    c2[h] = tc::quad_sum(c2[h]) * (1.f / C);
  }
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int h = tc::acc_half(i), c = tc::acc_col(i);
    out[i / 2] = tc::pack_bf2(inv[h] * (dy[i] * w[c] - c1[h] - nrm[i] * c2[h]),
                              inv[h] * (dy[i + 1] * w[c + 1] - c1[h] - nrm[i + 1] * c2[h]));
  }
}

}  // namespace lgk
