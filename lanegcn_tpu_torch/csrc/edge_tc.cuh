// The per-row chain's bf16 pieces on wgmma accumulators, shared by the
// tensor-core passes of win_edge.cu (Att's window-pair chain, forward and
// backward), edge_mlp.cu (Att's and LanePooling's flat edge chains, forward
// and backward) and row_tail.cu (LanePooling's two-Linear tail, backward),
// the staged core tiles they read rows from and write rows through, and
// the weight-gradient pass of Att's chain (dw_tc).
//
// A warpgroup holds 64 rows in the m64n128 accumulator layout: each thread
// two rows (tc::acc_row: r and r + 8) of 32 columns, a row's 128 columns in
// the 4 lanes of a quad. Activations that feed the next product leave the
// accumulators as bf16 pairs (element i and i + 1 in register i / 2), which
// is also wgmma's register-A fragment (k slice ks: registers 4ks .. 4ks + 3),
// so the chain runs from product to product without shared memory.
//
// The helpers that edge_mlp.cu's Att chain also runs at width W = 64 take
// W as a template parameter (default 128, the code they were before): a
// W-wide row is accumulator elements i < W/2 and k slices ks < W/16, its
// padded columns are kept at zero, and its statistics are over W columns
// (common.cuh).
#pragma once

#include "common.cuh"

namespace lgk {

__device__ __forceinline__ float2 ld_bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Rows [row0, row0 + n) of a [e, W] bf16 matrix into core tiles at dst
// (tc::tiles(dst, n), 128 columns) by cp.async, zeros past e and past W;
// thread t of `threads` copies 16-byte chunks, a warp two whole rows at a
// time.
template <int W = C>
__device__ __forceinline__ void fetch_rows(uint8_t* dst, const bf16* src, long row0, int n,
                                           int e, int t, int threads) {
  const tc::Tiles T = tc::tiles(dst, n);
  for (int i = t; i < n * (C / 8); i += threads) {
    const int r = i >> 4, c = (i & 15) * 8;
    const bool in = row0 + r < e && (W == C || c < W);
    cp_async16_zfill(dst + tc::tile_off(T, r, c), in ? src + (row0 + r) * W + c : src,
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
// e1 @ Wout). inv: s's 1/sqrt(var + eps) per row. Past W, add is not called
// and acc and e1 are zero.
template <int W = C, class Add>
__device__ __forceinline__ void e1_from_s(float (&acc)[64], Add add, const float* w,
                                          const float* b, float eps, float (&inv)[2],
                                          uint32_t (&e1)[32]) {
#pragma unroll
  for (int i = 0; i < W / 2; i += 2) add(tc::acc_half(i), tc::acc_col(i), acc[i], acc[i + 1]);
  float mu[2];
  tc::acc_row_stats<W>(acc, eps, mu, inv);
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    if (i >= W / 2) {
      acc[i] = acc[i + 1] = 0.f;
      e1[i / 2] = 0u;
      continue;
    }
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
// issued, committed and waited for. K runs over the first W channels.
template <bool BT = false, int W = C>
__device__ __forceinline__ void mm_frag(float (&acc)[64], const uint32_t (&a)[32],
                                        const tc::Tiles& b) {
  tc::fence_acc(acc);
  tc::fence();
#pragma unroll
  for (int ks = 0; ks < W / 16; ++ks)
    tc::mma_rs<BT ? 0 : 1>(acc, *reinterpret_cast<const uint32_t(*)[4]>(&a[4 * ks]),
                           tc::desc(b, BT, ks, 0));
  tc::commit();
  tc::wait_all();
  tc::fence_acc(acc);
}

// GroupNorm backward on the accumulators: d[i] = inv·(d_nrm − mean(d_nrm) −
// nrm·mean(d_nrm·nrm)), d_nrm = dy[i]·w[col], per row (as common.cuh
// gn_bwd_row), returned as bf16 pairs in `out` (element pair i/2; zero
// past W).
template <int W = C>
__device__ __forceinline__ void gn_bwd_acc(const float (&dy)[64], const float (&nrm)[64],
                                           const float (&inv)[2], const float* w,
                                           uint32_t (&out)[32]) {
  float c1[2] = {0.f, 0.f}, c2[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < W / 2; ++i) {
    const float dn = dy[i] * w[tc::acc_col(i)];
    c1[tc::acc_half(i)] += dn;
    c2[tc::acc_half(i)] += dn * nrm[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    c1[h] = tc::quad_sum(c1[h]) * (1.f / W);
    c2[h] = tc::quad_sum(c2[h]) * (1.f / W);
  }
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    if (i >= W / 2) {
      out[i / 2] = 0u;
      continue;
    }
    const int h = tc::acc_half(i), c = tc::acc_col(i);
    out[i / 2] = tc::pack_bf2(inv[h] * (dy[i] * w[c] - c1[h] - nrm[i] * c2[h]),
                              inv[h] * (dy[i + 1] * w[c + 1] - c1[h] - nrm[i + 1] * c2[h]));
  }
}


// --- Att's chain (dist_out stage, query and context rows): win_edge.cu's
// window-pair edges and edge_mlp.cu's flat list ----------------------------

// Wdo | K1 | Wout into core tiles at W_b, one [128 x 128] weight every
// tc::tiles_bytes(C) bytes (one cp.async group, not waited for), by the
// block's `threads` threads; [W x W] weights zero-padded.
template <int W = C>
__device__ __forceinline__ void load_chain_weights(uint8_t* W_b, const bf16* kdo, const bf16* k1,
                                                   const bf16* kout, int threads) {
  constexpr int WB = tc::tiles_bytes(C);
  const tc::Tiles t = tc::tiles(W_b, C);
  for (int i = threadIdx.x; i < 3 * C * C / 8; i += threads) {
    const int m = i / (C * C / 8), j = i % (C * C / 8);
    const int r = ((j >> 7) << 3) + (j & 7), c = ((j >> 3) & 15) * 8;
    const bf16* src = m == 0 ? kdo : m == 1 ? k1 : kout;
    if constexpr (W == C) {
      cp_async16(W_b + m * WB + tc::tile_off(t, r, c), src + r * C + c);
    } else {
      const bool in = r < W && c < W;
      cp_async16_zfill(W_b + m * WB + tc::tile_off(t, r, c), in ? src + r * W + c : src,
                       in ? 16 : 0);
    }
  }
  cp_async_commit();
}

// t2 = rnd(relu(GN_do(z))) from z's accumulator as bf16 pairs: t2[i / 2]
// holds elements i and i + 1, which is also the register-A fragment of
// t2 @ K1 (k slice ks: t2[4ks .. 4ks + 3]); zero past W. mu / inv: z's row
// statistics.
template <int W = C>
__device__ __forceinline__ void t2_from_z(const float (&acc)[64], const float* w, const float* b,
                                          float eps, float (&mu)[2], float (&inv)[2],
                                          uint32_t (&t2)[32]) {
  tc::acc_row_stats<W>(acc, eps, mu, inv);
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    if (i >= W / 2) {
      t2[i / 2] = 0u;
      continue;
    }
    const int h = tc::acc_half(i), c = tc::acc_col(i);
    t2[i / 2] = tc::pack_bf2(fmaxf((acc[i] - mu[h]) * inv[h] * w[c] + b[c], 0.f),
                             fmaxf((acc[i + 1] - mu[h]) * inv[h] * w[c + 1] + b[c + 1], 0.f));
  }
}

// e1_from_s's row addition for Att's chain: s += Cs[v] + Qd[u] on the
// thread's rows that are edges (ok), read from device memory (the flat
// list: u = v = the row; rows W wide).
template <int W = C>
__device__ __forceinline__ auto add_cq(const bool (&ok)[2], const int (&uu)[2],
                                       const int (&vv)[2], const bf16* cs, const bf16* qd) {
  return [&ok, &uu, &vv, cs, qd](int h, int c, float& x0, float& x1) {
    if (ok[h]) {
      const float2 cv = ld_bf2(cs + (long)vv[h] * W + c), qv = ld_bf2(qd + (long)uu[h] * W + c);
      x0 = x0 + cv.x + qv.x;
      x1 = x1 + cv.y + qv.y;
    }
  };
}

// GN_do's backward on the accumulators: from d_t2 in dt2 and z in z (mu /
// inv: z's row statistics), z ← nrm_z and dt2 ← d_gn_z = d_t2 ⊙ [t2 > 0]
// (t2 made again from nrm_z; 0 on rows that are not edges); vw += Σ
// d_gn_z·nrm_z and vb += Σ d_gn_z over the tile's rows (col_sums); dz ←
// rnd(d_z) as bf16 pairs, the register-A fragments of d_z @ Wdoᵀ. Past W, w
// and b (staged, zero there) make t2 and so d_gn_z zero.
template <int W = C>
__device__ __forceinline__ void gn_do_bwd(float (&dt2)[64], float (&z)[64], const float (&mu)[2],
                                          const float (&inv)[2], const bool (&ok)[2],
                                          const float* w, const float* b, float (&vw)[4],
                                          float (&vb)[4], uint32_t (&dz)[32]) {
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int h = tc::acc_half(i), c = tc::acc_col(i);
    z[i] = (z[i] - mu[h]) * inv[h];
    z[i + 1] = (z[i + 1] - mu[h]) * inv[h];
    const float2 t2 = unpack_bf2(tc::pack_bf2(fmaxf(z[i] * w[c] + b[c], 0.f),
                                              fmaxf(z[i + 1] * w[c + 1] + b[c + 1], 0.f)));
    dt2[i] = ok[h] && t2.x > 0.f ? dt2[i] : 0.f;
    dt2[i + 1] = ok[h] && t2.y > 0.f ? dt2[i + 1] : 0.f;
  }
  col_sums<true>(vw, dt2, z);
  col_sums<false>(vb, dt2, dt2);
  gn_bwd_acc<W>(dt2, z, inv, w, dz);
}

// Att's weight gradients in bf16 (the backward's second pass, after the
// chain pass has written each edge's operands): block (split, k) of a
// (splits, 3) grid of NT threads sums A[p]ᵀ B[p] over the DW_TE-edge tiles
// split, split + splits, ... of the e edges, for k = 0: dWdo (t1,
// rnd(d_z)), 1: dK1 (t2, rnd(d_s)), 2: dWout (e1, g), K running over a
// tile's edges (rows past e zero-filled). act [e, 4C]: t1 | t2 | e1 |
// rnd(d_z) of each edge; ds: rnd(d_s) at row stride ld_ds; g: edge p's
// cotangent at row eu[p] (p where eu is null). Both operands MN-major from
// a DW_STAGES ring of core tiles by cp.async, as lane_band.cuh's
// band_dw_tc_kernel; warpgroup w owns input channels 64w .. 64w + 63.
// part: [splits][3][C][C], one fp32 partial per split and gradient. At
// width W (64: Att's flat chain on the actor side) act is [e, 4W], g [., W],
// the operands zero-padded to 128 columns and part [splits][3][W][W].
constexpr int DW_TE = 64, DW_STAGES = 3;

inline int dw_tc_smem() { return DW_STAGES * 2 * tc::tiles_bytes(DW_TE); }

template <int W = C>
__device__ __forceinline__ void dw_tc(const bf16* act, const bf16* ds, int ld_ds, const bf16* g,
                                      const int* eu, int e, float* part) {
  constexpr int TB = tc::tiles_bytes(DW_TE);
  extern __shared__ float4 smem4[];
  uint8_t* buf = reinterpret_cast<uint8_t*>(smem4);  // [DW_STAGES][A, B] core tiles
  constexpr int PER = DW_TE * C / 8 / NT;  // 16-byte chunks per thread per operand
  const int k = blockIdx.y, wg = threadIdx.x >> 7;
  const int ntiles = (e + DW_TE - 1) / DW_TE, step = gridDim.x;
  const tc::Tiles t0 = tc::tiles(buf, DW_TE);  // offsets are the same in every stage
  const bf16* a_src = act + k * W;
  const bf16* b_src = k == 0 ? act + 3 * W : k == 1 ? ds : g;
  const int b_ld = k == 0 ? 4 * W : k == 1 ? ld_ds : W;

  auto issue = [&](int tile, int stage) {  // one commit group, empty past the last tile
    uint8_t* A_b = buf + stage * 2 * TB;
    if (tile < ntiles) {
#pragma unroll
      for (int kk = 0; kk < PER; ++kk) {
        const int i = threadIdx.x + kk * NT;
        const int r = ((i >> 7) << 3) + (i & 7), c = ((i >> 3) & 15) * 8;
        const uint32_t off = tc::tile_off(t0, r, c);
        const long p = (long)tile * DW_TE + r;
        const bool in = p < e && (W == C || c < W);
        const long brow = !in ? 0 : k == 2 && eu ? (long)eu[p] : p;
        cp_async16_zfill(A_b + off, in ? a_src + p * 4 * W + c : act, in ? 16 : 0);
        cp_async16_zfill(A_b + TB + off, in ? b_src + brow * b_ld + c : g, in ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  float acc[64];
  tc::zero(acc);
  const int first = blockIdx.x;
  issue(first, 0);
  issue(first + step, 1);
  for (int kk = 0; first + kk * step < ntiles; ++kk) {
    cp_async_wait<1>();  // stage kk landed (kk + 1 may be in flight)
    tc::fence_smem();
    // stage kk in place for every thread; every warpgroup done with kk − 1,
    // whose buffer stage kk + 2 now takes
    __syncthreads();
    issue(first + (kk + 2) * step, (kk + 2) % DW_STAGES);
    const int st = kk % DW_STAGES;
    const tc::Tiles A = tc::tiles(buf + st * 2 * TB, DW_TE),
                    B = tc::tiles(buf + st * 2 * TB + TB, DW_TE);
    tc::fence_acc(acc);
    tc::fence();
    tc::mm<DW_TE / 16, false, false>(acc, A, 64 * wg, B);
    tc::commit();
    tc::wait_all();
    tc::fence_acc(acc);
  }
  cp_async_wait<0>();  // no copy lands after the block is gone
  float* P = part + ((long)blockIdx.x * 3 + k) * W * W;
  if (W == C || 64 * wg < W) {  // at W = 64 the second warpgroup's channels are padding
#pragma unroll
    for (int i = 0; i < W / 2; i += 2)
      *reinterpret_cast<float2*>(P + (64 * wg + tc::acc_row(i)) * W + tc::acc_col(i)) =
          make_float2(acc[i], acc[i + 1]);
  }
}

}  // namespace lgk
