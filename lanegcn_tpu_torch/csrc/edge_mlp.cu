// Fused per-edge MLP over a flat edge list: Att's and LanePooling's, forward
// and backward.
//
// Replaces lanegcn_tpu/ops/pallas_edge_mlp.py `_fwd_kernel` / `_fwd_impl`
// and `_bwd_kernel` / `_bwd_impl` (the Pallas kernels behind
// `fused_edge_mlp`) in the Att configuration (has_dist2, has_query), and
// `_fwd_kernel` / `_fwd_impl` and `_bwd_kernel` / `_bwd_impl` in
// LanePooling's (no dist_out stage, no query, d [E, 4]: edge_mlp_pool_fwd and
// edge_mlp_pool_bwd, below). Att's chain: per row
// e of the list, padding included, the chain of edge_chain.cuh from
//
//   t1 = rnd(relu(rnd(d[e]) @ rnd(Wd) + bd)),  s = t2 @ K1 + qg[e] + cg[e],
//   out[e] = rnd(e1 @ Wout).
//
// d [E, 2] is fp32; qg/cg (the gathered query and context projections) and
// out are [E, 128] in the activation dtype. A padding row has d = qg = cg =
// 0, so its output is a constant row that the caller's masked scatter drops,
// and its cotangent is zero, so it adds exactly nothing to any gradient.
//
// What bounds it: three (forward) or nine (backward) [E x 128] x [128 x 128]
// products per row (3.2 and 9.7 GFLOP at the CLI geometry's 32,768-row
// A2M list) against d, qg, cg read and out written (25.4 MB, 7.6 us at
// 3.35 TB/s), or d, qg, cg, g read and dd, dqg, dcg written (42.5 MB):
// bytes, at the card's bf16 rates. About 87-93 % of the rows are padding at
// the CLI geometry's capacities; the kernels run them all, as the TPU
// kernels did (skipping them would need a live-row count the op does not
// take).
//
// edge_mlp_fwd:
//   bf16 (edge_mlp_tc_kernel, the path that serves and trains): the
//     LanePooling forward's walk below (fwd_tc, templated on the chain): a
//     persistent grid of PF_WGS warpgroups a block, Wdo, K1 and Wout held
//     once per block as bf16 core tiles, each warpgroup on 64-row tiles of
//     its own with the next tile's d and cg rows in flight by cp.async. t1
//     is made in registers from d as the register-A fragments of z = t1 @
//     Wdo; t2 on z's accumulators (edge_tc.cuh t2_from_z) as those of s =
//     t2 @ K1; cg (staged) then qg (from device memory: a third staged tile
//     would pass the block's shared memory) added to s in fp32; e1 as the
//     fragments of out = e1 @ Wout, which leaves through cg's tile in
//     16-byte rows.
//   fp32 (edge_mlp_kernel, the parity path: wgmma has no fp32 operands): a
//     block per 64-row tile keeps the tile's chain in shared memory (one
//     fp32 [64 x 128] tile, one [128 x 128] weight reloaded per stage,
//     edge_chain.cuh's chain_fwd on CUDA cores).
//
// edge_mlp_bwd: the chain recomputed per tile, as the TPU kernel does, and
// run backwards (edge_chain.cuh's header), with dqg = dcg = rnd(d_s), dWd
// += rnd(d)ᵀ rnd(d_t1p) and dd = rnd(d_t1p) @ Wdᵀ per row.
//   bf16, two passes over the rows, then the partial sums:
//   1. edge_mlp_bwd_tc_kernel: the LanePooling backward's walk (bwd_tc,
//      templated on the chain; the next tile's d and g in flight, cg and
//      qg read from device memory where s takes them: staged by cp.async
//      in one stage a warpgroup, which is all shared memory holds beside
//      the three weights, the pass took 7 % longer on the H100) running
//      win_edge_bwd_tc_kernel's chain on wgmma over the list's own rows:
//      z = t1 @ Wdo beside d_e1 = g @ Woutᵀ, s = t2 @ K1, d_t2 = rnd(d_s)
//      @ K1ᵀ, z again (the registers hold no nrm_z), d_t1 = rnd(d_z) @
//      Wdoᵀ; each GroupNorm forward and backward on the accumulators
//      (edge_tc.cuh gn_bwd_acc, gn_do_bwd). rnd(d_s) leaves for dqg and dcg
//      (two copies: a consumer may write into either gradient) through g's
//      staged tile; the vector sums (dbd, dgdow, dgdob, dgchw, dgchb, dWd's
//      two rows) are column sums over a tile's rows, kept per lane across
//      the tiles and summed over the warps once per block; dd by quad
//      sums. Each row's t1 | t2 | e1 | rnd(d_z) goes to a bf16 workspace
//      act [e, 4C].
//   2. edge_mlp_dw_tc_kernel: dWdo = t1ᵀ rnd(d_z), dK1 = t2ᵀ rnd(d_s),
//      dWout = e1ᵀ rnd(g) as split-K wgmma products over 64-edge tiles of
//      act, dcg and g (edge_tc.cuh dw_tc, win_edge's dW pass), one fp32
//      partial per split. Three [128 x 128] fp32 accumulators do not fit
//      beside the chain; making e1 again in pass 2 would take two products
//      and the cg and qg rows again.
//   The partials are summed in block and split order (reduce_partials):
//   no float atomics, bitwise reruns, no zeroed workspace.
//   fp32 (edge_mlp_bwd_kernel, the parity path): one block per SM walks
//   the tiles (tile = block, block + blocks, ...) with edge_chain.cuh's
//   chain_bwd on CUDA cores; it adds its products into its own slice of a
//   [blocks, 3*C*C + 7*C] workspace (zeroed by the wrapper; a read-modify-
//   write per tile by the block that owns the slice) and keeps its vector
//   sums per warp in registers; reduce_partials sums the slices in block
//   order.
//
// Width: Att's chain (edge_mlp_fwd / edge_mlp_bwd) also runs at W = 64
// (A2A where n_actor = 64), every Att kernel above templated on W by the
// padded route of common.cuh: d, qg, cg and g rows read W wide into the
// same 128-column tiles with zeros past W, Wd's and bd's columns and the GN
// affines zero past W, Wdo, K1 and Wout zero-padded to 128 x 128 in shared
// memory, GN statistics over W columns, only W columns stored; act is
// [E, 4W] and the weight gradients W x W. The wgmma products keep their
// m64n128k16 shape with K cut to W, so half of N multiplies zero columns.
// At W = 128 each kernel compiles to the code it was before the width
// existed. Att's chain also takes W = 256 both ways, on kernels of their
// own (the forward edge_mlp_wide_kernel and edge_mlp_wide_tc_kernel, on
// wide.cuh; the backward edge_mlp_bwd_wide_kernel and
// edge_mlp_bwd_wide_tc_kernel, then wide_bwd.cuh's weight-gradient pass;
// below).
// LanePooling's configuration (edge_mlp_pool_fwd / _bwd, below)
// takes W = 64 the same way (LaneRCNN at n_map = 64): cg, out, g and dcg
// rows, Wd's columns, bd and the GN affines W wide, K1 and Wout zero-padded,
// the weight-gradient pass's second warpgroup idle (its input channels are
// padding), the partials W x W and W.
//
// edge_mlp_pool_fwd (LaneRCNN's three LanePooling stages): per row,
//
//   t1 = rnd(relu(rnd(d[e]) @ rnd(Wd) + bd)),  s = t1 @ K1 + cg[e],
//   out[e] = rnd(rnd(relu(GN_ch(s))) @ Wout)
//
// with d [E, 4] fp32 (relative pose, context minus target) and cg the
// gathered context projection. What bounds it: d and cg read and out
// written (0.55 GB at E = 1,048,576 in bf16, ~0.165 ms) against 2 x 2 x
// 128 x 128 flops per row (69 GFLOP, ~0.07 ms at the bf16 matrix rate):
// bytes. About 11 % of the rows at the 256-scenario pack are padding; each
// gives one constant row that the caller's scatter drops.
//   bf16 (edge_mlp_pool_tc_kernel, the path that serves and trains): a
//     persistent grid of PF_WGS warpgroups a block, K1 and Wout held once
//     per block as bf16 core tiles. Each warpgroup walks 64-row tiles of its
//     own and keeps the next tile's d and cg rows in flight by cp.async
//     while the current one multiplies. t1 is made in registers straight
//     from d as the register-A fragments of s = t1 @ K1 (wgmma); cg is
//     added on the accumulators, e1 made there (edge_tc.cuh e1_from_s) and
//     fed to out = e1 @ Wout the same way; out leaves through cg's staged
//     tile in 16-byte rows. No fp32 tile in shared memory, no block-wide
//     barrier per tile.
//   fp32 (edge_mlp_pool_kernel, the parity path: wgmma has no fp32
//     operands): edge_mlp_fwd's block and tile, two [128 x 128] products per
//     row on CUDA cores.
//
// edge_mlp_pool_bwd: that chain run backwards from the cotangent g of out,
// recomputed per tile (only the inputs are saved), with d_t1 = d_t2 (no
// dist_out stage, pallas_edge_mlp.py:168-169):
//
//   d_e1 = g @ Woutᵀ;  dWout += e1ᵀ g;  d_gn = d_e1 ⊙ [e1 > 0]
//   d_s = rnd(GN_chᵀ(d_gn)) = dcg;  dK1 += t1ᵀ d_s;  dgchw += Σ d_gn·nrm_s, dgchb += Σ d_gn
//   d_t1p = d_s @ K1ᵀ ⊙ [t1 > 0];  dbd += Σ d_t1p;  dWd += rnd(d)ᵀ rnd(d_t1p)
//   dd = rnd(d_t1p) @ Wdᵀ   (only when the caller asks: d is pack data in the model)
//
// What bounds it: d, cg and g read and dcg written once (0.82 GB at E =
// 1,048,576 in bf16, ~0.25 ms) against five [128 x 128] products per row
// (172 GFLOP, ~0.17 ms at the bf16 matrix rate): bytes.
//   bf16, two passes over the rows:
//   1. edge_mlp_pool_bwd_tc_kernel: the forward's persistent grid and row
//      walk (the next tile's d, cg and g in flight by cp.async), the chain
//      on wgmma: s = t1 @ K1 from t1's register fragments beside d_e1 =
//      g @ Woutᵀ from g's staged tile (Wout K-major), the GN backward on
//      the accumulators, d_t1 = rnd(d_s) @ K1ᵀ from d_s's fragments. dcg
//      leaves through g's tile; the vector sums (dbd, dgchw, dgchb, the
//      din rows of dWd) are column sums over a tile's rows by shuffles,
//      kept per lane across the tiles and summed over the warps once per
//      block; dd by quad sums.
//   2. edge_mlp_pool_dw_tc_kernel: dK1 = t1ᵀ rnd(d_s) (y = 0) and dWout =
//      e1ᵀ rnd(g) (y = 1) as split-K wgmma products over 128-edge tiles
//      streamed through a cp.async ring, one fp32 partial per split: t1
//      made again from d (the thread's Wd and bd columns in registers), e1
//      by the chain again (d, cg), d_s read back from dcg. The two [128 x 128] fp32
//      accumulators (128 registers a thread each for a warpgroup) do not
//      fit beside the chain of pass 1, and a ring handing tiles to dW
//      warpgroups would need ~170 registers a thread over three
//      warpgroups; the second pass reads ~0.8 GB more at E = 1,048,576
//      instead, and writes no activations.
//   The partials are summed in block and split order (reduce_partials):
//   no float atomics, bitwise reruns.
//   fp32 (edge_mlp_pool_bwd_kernel, the parity path): one block per SM
//   walks the tiles with dK1 and dWout in registers (an 8 x 8 block of each
//   per thread) and the vector sums per warp in shared memory; four fp32
//   tiles (t1, nrm_s then d_t1, e1, g then d_e1 then d_s) and one 64 KB
//   weight slot (K1, Woutᵀ, K1ᵀ in turn): 224 KB, one block per SM. The
//   products run on CUDA cores.
#include <type_traits>

#include "edge_chain.cuh"
#include "edge_tc.cuh"
#include "wide_bwd.cuh"

using namespace lgk;

namespace {

constexpr int EB = TM;                       // rows per tile
// A block's fp32 partial at width W: dWdo, dK1, dWout, dbd, dgdow, dgdob,
// dgchw, dgchb, dWd.
template <int W = C>
__host__ __device__ constexpr int em_part() { return 3 * W * W + 7 * W; }

// A_s[r] = rnd(relu(rnd(d[row]) @ rnd(Wd) + bd)) for the tile's rows; 0 past
// e and past W. d is [e, DIN]; the DIN products are summed in order with
// fmaf.
template <typename T, int DIN, int W = C>
__device__ __forceinline__ void tile_t1(float* A_s, const float* d, const T* kd, const float* bd,
                                        long row0, int e) {
  for (int i = threadIdx.x; i < EB * (C / 4); i += NT) {
    const int r = i / (C / 4), c4 = (i % (C / 4)) * 4;
    const long row = row0 + r;
    float4 t = zero4();
    if (row < e && (W == C || c4 < W)) {
      const float d0 = rnd<T>(d[row * DIN]);
      const float4 k0 = load4<T>(kd + c4);
      t = make_float4(d0 * k0.x, d0 * k0.y, d0 * k0.z, d0 * k0.w);
#pragma unroll
      for (int k = 1; k < DIN; ++k) {
        const float dk = rnd<T>(d[row * DIN + k]);
        const float4 kk = load4<T>(kd + k * W + c4);
        t = make_float4(fmaf(dk, kk.x, t.x), fmaf(dk, kk.y, t.y), fmaf(dk, kk.z, t.z),
                        fmaf(dk, kk.w, t.w));
      }
      const float4 b = *reinterpret_cast<const float4*>(bd + c4);
      t = rnd4<T>(relu4(add4(t, b)));
    }
    *reinterpret_cast<float4*>(A_s + r * LDA + c4) = t;
  }
}

template <typename T, int W>
__global__ void __launch_bounds__(NT)
edge_mlp_kernel(const float* __restrict__ d, const T* __restrict__ qg, const T* __restrict__ cg,
                const T* __restrict__ kd, const float* __restrict__ bd, const T* __restrict__ kdo,
                const float* __restrict__ gdow, const float* __restrict__ gdob,
                const T* __restrict__ k1, const float* __restrict__ gchw,
                const float* __restrict__ gchb, const T* __restrict__ kout, T* __restrict__ out,
                int e, float eps) {
  extern __shared__ float4 smem4[];
  float* A_s = reinterpret_cast<float*>(smem4);  // [EB][LDA]
  float* W_s = A_s + EB * LDA;                   // [C][C]
  const long row0 = (long)blockIdx.x * EB;
  const int lane = threadIdx.x & 31;
  float mm[4][8];

  tile_t1<T, 2, W>(A_s, d, kd, bd, row0, e);
  chain_fwd<T, true, W>(A_s, W_s, Chain<T>{kdo, gdow, gdob, k1, gchw, gchb, kout, eps},
                        [&](int r, float4 s) {  // s += cg + qg
                          const long row = row0 + r;
                          if (row < e && lane_in<W>()) {
                            s = add4(s, load4<T>(cg + row * W + lane * 4));
                            s = add4(s, load4<T>(qg + row * W + lane * 4));
                          }
                          return s;
                        },
                        mm);  // e2 = e1 @ Wout
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long row = row0 + mm_row(i);
    if (row < e) {
      store4<T>(out + row * W + mm_col(0), make_float4(mm[i][0], mm[i][1], mm[i][2], mm[i][3]));
      if (W == C)
        store4<T>(out + row * W + mm_col(4),
                  make_float4(mm[i][4], mm[i][5], mm[i][6], mm[i][7]));
    }
  }
}

template <typename T, int W>
__global__ void __launch_bounds__(NT)
edge_mlp_bwd_kernel(const float* __restrict__ d, const T* __restrict__ qg,
                    const T* __restrict__ cg, const T* __restrict__ g, const T* __restrict__ kd,
                    const float* __restrict__ bd, const T* __restrict__ kdo,
                    const float* __restrict__ gdow, const float* __restrict__ gdob,
                    const T* __restrict__ k1, const float* __restrict__ gchw,
                    const float* __restrict__ gchb, const T* __restrict__ kout,
                    float* __restrict__ dd, T* __restrict__ dqg, T* __restrict__ dcg,
                    float* __restrict__ part, int e, float eps) {
  extern __shared__ float4 smem4[];
  float* A_s = reinterpret_cast<float*>(smem4);  // [EB][LDA] four row tiles
  float* B_s = A_s + EB * LDA;
  float* C_s = B_s + EB * LDA;
  float* D_s = C_s + EB * LDA;
  float* W_s = D_s + EB * LDA;  // [C][C]
  float* st_s = W_s + C * C;    // [EB][2] inv of GN(do), GN(ch)

  float* P = part + (long)blockIdx.x * em_part<W>();  // this block's own slice (zeroed)
  const Chain<T> w{kdo, gdow, gdob, k1, gchw, gchb, kout, eps};
  const int lane = threadIdx.x & 31;
  const bool in_w = lane_in<W>();  // the lane's columns lie in the row
  const int ntiles = (e + EB - 1) / EB;
  float4 vecs[5] = {zero4(), zero4(), zero4(), zero4(), zero4()};  // dbd, dgdow, dgdob, dgchw, dgchb
  float4 vkd[2] = {zero4(), zero4()};                               // dWd rows
  const float4 k0 = in_w ? load4<T>(kd + lane * 4) : zero4(),
               k1v = in_w ? load4<T>(kd + W + lane * 4) : zero4();

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long row0 = (long)tile * EB;
    chain_bwd<T, W>(
        A_s, B_s, C_s, D_s, W_s, st_s, P, vecs, w,
        [&](float* X_s) { tile_t1<T, 2, W>(X_s, d, kd, bd, row0, e); },
        [&](int r, float4 sv) {  // s += cg + qg
          const long row = row0 + r;
          if (row < e && in_w) {
            sv = add4(sv, load4<T>(cg + row * W + lane * 4));
            sv = add4(sv, load4<T>(qg + row * W + lane * 4));
          }
          return sv;
        },
        [&](int r) {
          return row0 + r < e && in_w ? load4<T>(g + (row0 + r) * W + lane * 4) : zero4();
        },
        [&](int r) { return row0 + r < e; },
        [&](int r, float4 ds) {  // dqg = dcg = rnd(d_s)
          if (!in_w) return;
          store4<T>(dqg + (row0 + r) * W + lane * 4, ds);
          store4<T>(dcg + (row0 + r) * W + lane * 4, ds);
        },
        [] {},
        [&](int r, float4 d1) {  // dWd += rnd(d)ᵀ rnd(d_t1p);  dd = rnd(d_t1p) @ Wdᵀ
          const long row = row0 + r;
          const float a0 = rnd<T>(d[row * 2]), a1 = rnd<T>(d[row * 2 + 1]);
          vkd[0] = add4(vkd[0], make_float4(a0 * d1.x, a0 * d1.y, a0 * d1.z, a0 * d1.w));
          vkd[1] = add4(vkd[1], make_float4(a1 * d1.x, a1 * d1.y, a1 * d1.z, a1 * d1.w));
          const float s0 = warp_sum(d1.x * k0.x + d1.y * k0.y + d1.z * k0.z + d1.w * k0.w);
          const float s1 = warp_sum(d1.x * k1v.x + d1.y * k1v.y + d1.z * k1v.z + d1.w * k1v.w);
          if (lane == 0) {
            dd[row * 2] = s0;
            dd[row * 2 + 1] = s1;
          }
        },
        [] {});
  }
  const float4 all[7] = {vecs[0], vecs[1], vecs[2], vecs[3], vecs[4], vkd[0], vkd[1]};
  reduce_warp_vecs<7, W>(all, B_s, P + 3 * W * W);
}

// LanePooling's chain (no dist_out stage, no query): t1 from d [e, DIN],
// s = t1 @ K1 + cg[e], out[e] = rnd(e1 @ Wout); fp32, the parity path; rows
// W wide.
template <typename T, int DIN, int W>
__global__ void __launch_bounds__(NT)
edge_mlp_pool_kernel(const float* __restrict__ d, const T* __restrict__ cg,
                     const T* __restrict__ kd, const float* __restrict__ bd,
                     const T* __restrict__ k1, const float* __restrict__ gchw,
                     const float* __restrict__ gchb, const T* __restrict__ kout,
                     T* __restrict__ out, int e, float eps) {
  extern __shared__ float4 smem4[];
  float* A_s = reinterpret_cast<float*>(smem4);  // [EB][LDA]
  float* W_s = A_s + EB * LDA;                   // [C][C]
  const long row0 = (long)blockIdx.x * EB;
  const int lane = threadIdx.x & 31;
  float mm[4][8];

  tile_t1<T, DIN, W>(A_s, d, kd, bd, row0, e);
  chain_fwd<T, false, W>(A_s, W_s,
                         Chain<T>{nullptr, nullptr, nullptr, k1, gchw, gchb, kout, eps},
                         [&](int r, float4 s) {  // s += cg
                           const long row = row0 + r;
                           if (row < e && lane_in<W>())
                             s = add4(s, load4<T>(cg + row * W + lane * 4));
                           return s;
                         },
                         mm);  // e2 = e1 @ Wout
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long row = row0 + mm_row(i);
    if (row < e) {
      store4<T>(out + row * W + mm_col(0), make_float4(mm[i][0], mm[i][1], mm[i][2], mm[i][3]));
      if (W == C)
        store4<T>(out + row * W + mm_col(4),
                  make_float4(mm[i][4], mm[i][5], mm[i][6], mm[i][7]));
    }
  }
}

// LanePooling's chain backwards in fp32 (see the header); part holds
// blocks rows of pool_part<DIN, W>() = [2*W*W + (3 + DIN)*W]: dK1, dWout
// (in, out), dbd, dgchw, dgchb, dWd rows.
template <int DIN, int W = C>
__host__ __device__ constexpr int pool_part() { return 2 * W * W + (3 + DIN) * W; }

template <typename T, int DIN, int W>
__global__ void __launch_bounds__(NT, 1)
edge_mlp_pool_bwd_kernel(const float* __restrict__ d, const T* __restrict__ cg,
                         const T* __restrict__ g, const T* __restrict__ kd,
                         const float* __restrict__ bd, const T* __restrict__ k1,
                         const float* __restrict__ gchw, const float* __restrict__ gchb,
                         const T* __restrict__ kout, float* __restrict__ dd, T* __restrict__ dcg,
                         float* __restrict__ part, int e, float eps) {
  constexpr int NV = 3 + DIN;  // dbd, dgchw, dgchb, dWd rows
  extern __shared__ float4 smem4[];
  float* A_s = reinterpret_cast<float*>(smem4);  // [EB][LDA] t1
  float* B_s = A_s + EB * LDA;                   // nrm_s, then d_t1
  float* C_s = B_s + EB * LDA;                   // e1
  float* D_s = C_s + EB * LDA;                   // g, then d_e1, then rnd(d_s)
  float* W_s = D_s + EB * LDA;                   // [C][C] K1, Woutᵀ, K1ᵀ in turn
  float* st_s = W_s + C * C;                     // [EB] 1/std of GN_ch
  float* vec_s = st_s + EB;                      // [NT/32][NV][C]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool in_w = lane_in<W>();  // the lane's columns lie in the row
  const float ones[4] = {1.f, 1.f, 1.f, 1.f};
  float accK1[8][8], accOut[8][8];
  zero_tn(accK1);
  zero_tn(accOut);
  zero_warp_vecs<NV>(vec_s);
  const int ntiles = (e + EB - 1) / EB;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long row0 = (long)tile * EB;
    __syncthreads();  // the previous tile is done with the tiles and W_s
    tile_t1<T, DIN, W>(A_s, d, kd, bd, row0, e);  // A = t1 (0 past e and past W)
    load_weight<T, W>(W_s, k1);
    __syncthreads();
    float acc[4][8];
    zero_acc(acc);
    mm_64x128(A_s, 0, ones, W_s, acc);  // t1 @ K1
    store_acc(B_s, acc);
    __syncthreads();
    for (int r = warp; r < EB; r += NT / 32) {  // B = nrm_s, C = e1, D = g
      const long row = row0 + r;
      float* pb = B_s + r * LDA + lane * 4;
      float4 sv = *reinterpret_cast<float4*>(pb);
      if (row < e && in_w) sv = add4(sv, load4<T>(cg + row * W + lane * 4));
      const float2 st = gn_stats<W>(sv, eps);
      const float4 nrm = gn_nrm(sv, st);
      *reinterpret_cast<float4*>(pb) = nrm;
      *reinterpret_cast<float4*>(C_s + r * LDA + lane * 4) =
          rnd4<T>(relu4(gn_affine<W>(nrm, gchw, gchb)));
      *reinterpret_cast<float4*>(D_s + r * LDA + lane * 4) =
          row < e && in_w ? load4<T>(g + row * W + lane * 4) : zero4();
      if (lane == 0) st_s[r] = st.y;
    }
    load_weight_t<T, W>(W_s, kout);
    __syncthreads();
    zero_acc(acc);
    mm_64x128(D_s, 0, ones, W_s, acc);  // d_e1 = g @ Woutᵀ
    mm_tn(C_s, D_s, EB, accOut);        // dWout += e1ᵀ g
    __syncthreads();
    store_acc(D_s, acc);
    __syncthreads();
    for (int r = warp; r < EB; r += NT / 32) {  // D = rnd(d_s) = dcg
      const long row = row0 + r;
      float4* pd = reinterpret_cast<float4*>(D_s + r * LDA + lane * 4);
      float4 ds = zero4();
      if (row < e) {
        const float4 nrm = *reinterpret_cast<const float4*>(B_s + r * LDA + lane * 4);
        const float4 e1 = *reinterpret_cast<const float4*>(C_s + r * LDA + lane * 4);
        const float4 dgn = pos_mask4(*pd, e1);
        add_warp_vec<NV>(vec_s, 1, mul4(dgn, nrm));
        add_warp_vec<NV>(vec_s, 2, dgn);
        ds = rnd4<T>(gn_bwd_row<W>(dgn, nrm, st_s[r], gchw));
        if (in_w) store4<T>(dcg + row * W + lane * 4, ds);
      }
      *pd = ds;
    }
    load_weight_t<T, W>(W_s, k1);
    __syncthreads();
    zero_acc(acc);
    mm_64x128(D_s, 0, ones, W_s, acc);  // d_t1 = rnd(d_s) @ K1ᵀ
    mm_tn(A_s, D_s, EB, accK1);         // dK1 += t1ᵀ rnd(d_s)
    __syncthreads();
    store_acc(B_s, acc);
    __syncthreads();
    for (int r = warp; r < EB; r += NT / 32) {  // d_t1p = d_t1 ⊙ [t1 > 0]
      const long row = row0 + r;
      if (row >= e) break;
      const float4 t1 = *reinterpret_cast<const float4*>(A_s + r * LDA + lane * 4);
      const float4 d_t1p = pos_mask4(*reinterpret_cast<const float4*>(B_s + r * LDA + lane * 4),
                                     t1);
      add_warp_vec<NV>(vec_s, 0, d_t1p);
      const float4 d1 = rnd4<T>(d_t1p);
#pragma unroll
      for (int k = 0; k < DIN; ++k) {
        const float a = rnd<T>(d[row * DIN + k]);
        add_warp_vec<NV>(vec_s, 3 + k, make_float4(a * d1.x, a * d1.y, a * d1.z, a * d1.w));
        if (dd) {
          const float4 kk = in_w ? load4<T>(kd + k * W + lane * 4) : zero4();
          const float sk = warp_sum(d1.x * kk.x + d1.y * kk.y + d1.z * kk.z + d1.w * kk.w);
          if (lane == 0) dd[row * DIN + k] = sk;
        }
      }
    }
  }
  float* P = part + (long)blockIdx.x * pool_part<DIN, W>();
  store_tn<W>(P, accK1, false);
  store_tn<W>(P + W * W, accOut, false);
  sum_warp_vecs<NV, W>(vec_s, P + 2 * W * W);
}

// --- the flat chains on tensor cores (bf16): LanePooling's, and Att's
// (ATT: the dist_out stage and the query rows) -------------------------------

constexpr int PF_WGS = 3;                          // the forward's warpgroups a block
constexpr int PF_THREADS = 128 * PF_WGS;
constexpr int PW_WGS = 2;                          // the backward's
constexpr int PW_THREADS = 128 * PW_WGS;
constexpr int PT = 64;                             // rows of a warpgroup's chain tile
constexpr int PD = PT * 4 * (int)sizeof(float);    // 64 rows of d (room for din 4)
constexpr int PTB = tc::tiles_bytes(PT);           // a [64 x 128] bf16 tile in core tiles
constexpr int PWB = tc::tiles_bytes(C);            // a [128 x 128] weight in core tiles
constexpr int DT = 128;                            // edges of a weight-gradient tile
constexpr int DTB = tc::tiles_bytes(DT);
static_assert(PW_THREADS == NT, "tc::load_tiles_128 strides by NT threads");

// The chain's weights in shared memory ((Wdo |) K1 | Wout) and its vectors
// (rnd(Wd) [DIN][C], bd, (gdow, gdob,) gchw, gchb).
template <bool ATT> __host__ __device__ constexpr int chain_mats() { return ATT ? 3 : 2; }
template <int DIN, bool ATT>
__host__ __device__ constexpr int chain_vecs() {
  return DIN + (ATT ? 5 : 3);
}

// A backward warpgroup's stage: [d | cg | g] (LanePooling) or [d | g] (Att,
// whose cg and qg rows s reads from device memory: two more staged tiles a
// warpgroup would pass the block's shared memory). A forward one's: [d | cg]
// (Att reads qg from device memory).
template <bool ATT> __host__ __device__ constexpr int bwd_stage() {
  return PD + (ATT ? 1 : 2) * PTB;
}

template <int DIN, bool ATT>
constexpr int fwd_tc_smem() {
  return chain_mats<ATT>() * PWB + chain_vecs<DIN, ATT>() * C * (int)sizeof(float) +
         PF_WGS * 2 * (PD + PTB);
}
template <int DIN, bool ATT>
constexpr int bwd_tc_smem() {
  return chain_mats<ATT>() * PWB + chain_vecs<DIN, ATT>() * C * (int)sizeof(float) +
         PW_WGS * 2 * bwd_stage<ATT>();
}
static_assert(fwd_tc_smem<2, true>() <= 232448 && fwd_tc_smem<4, false>() <= 232448 &&
                  bwd_tc_smem<2, true>() <= 232448 && bwd_tc_smem<4, false>() <= 232448,
              "a block's shared memory");

// The chain's vectors in shared memory (chain_vecs' order) by the block's
// `threads` threads; gdow and gdob only with ATT.
template <int DIN, bool ATT, int W = C>
__device__ __forceinline__ void load_chain_vecs(float* vec_s, const bf16* kd, const float* bd,
                                                const float* gdow, const float* gdob,
                                                const float* gchw, const float* gchb,
                                                int threads) {
  const float* v[5] = {bd, ATT ? gdow : gchw, ATT ? gdob : gchb, gchw, gchb};
  for (int i = threadIdx.x; i < chain_vecs<DIN, ATT>() * C; i += threads) {
    const int k = i / C, j = i % C;
    if (W < C && j >= W)  // the padded columns of a W-wide chain
      vec_s[i] = 0.f;
    else
      vec_s[i] = k < DIN ? __bfloat162float(kd[k * W + j]) : v[k - DIN][j];
  }
}

// The chain's weights into core tiles at W_b (chain_mats' order; [W x W]
// weights zero-padded), landed for the caller's barrier: LanePooling's by
// the first NT threads, Att's by cp.async (edge_tc.cuh load_chain_weights).
template <bool ATT, int W = C>
__device__ __forceinline__ void load_chain_mats(uint8_t* W_b, const bf16* kdo, const bf16* k1,
                                                const bf16* kout, int threads) {
  if constexpr (ATT) {
    load_chain_weights<W>(W_b, kdo, k1, kout, threads);
    cp_async_wait<0>();
  } else if (threadIdx.x < NT) {  // tc::load_tiles_128 strides by NT threads
    tc::load_tiles_128<W>(W_b, tc::tiles(W_b, C), k1);
    tc::load_tiles_128<W>(W_b + PWB, tc::tiles(W_b + PWB, C), kout);
  }
}

// Rows [row0, row0 + n) of d [e, DIN] (n·DIN contiguous floats) into D by
// cp.async, zeros past e; thread t of `threads`.
template <int DIN>
__device__ __forceinline__ void fetch_d(float* D, const float* d, long row0, int n, int e, int t,
                                        int threads) {
  const long rows = e - row0 < n ? e - row0 : n;  // ≥ 1: the tile holds a row
  const long valid = rows * DIN * (long)sizeof(float);
  for (int j = t; j < n * DIN / 4; j += threads) {
    const long left = valid - 16L * j;
    const int nb = left >= 16 ? 16 : left > 0 ? (int)left : 0;
    cp_async16_zfill(D + 4 * j, nb ? d + row0 * DIN + 4 * j : d, nb);
  }
}

// Rows [row0, row0 + n) of a staged core tile to dst [e, W] in 16-byte
// chunks; rows past e and columns past W are not written.
template <int W = C>
__device__ __forceinline__ void store_rows(bf16* dst, const uint8_t* X_b, const tc::Tiles& X,
                                           long row0, int n, int e, int t, int threads) {
  for (int i = t; i < n * (C / 8); i += threads) {
    const int r = i >> 4, c = (i & 15) * 8;
    if (row0 + r < e && (W == C || c < W))
      *reinterpret_cast<uint4*>(dst + (row0 + r) * W + c) =
          *reinterpret_cast<const uint4*>(X_b + tc::tile_off(X, r, c));
  }
}

// The thread's two accumulator rows (r0 and r0 + 8 of a staged tile) of d,
// rounded to bf16.
template <int DIN>
__device__ __forceinline__ void d_rows(float (&dr)[2][DIN], const float* D, int r0) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int k = 0; k < DIN; ++k) dr[h][k] = rnd<bf16>(D[(r0 + 8 * h) * DIN + k]);
  }
}

// t1 = rnd(relu(dr @ rnd(Wd) + bd)) of the thread's two rows as bf16 pairs
// in the accumulator layout: the register-A fragments of t1 @ K1 (Att:
// t1 @ Wdo). The DIN products are summed in order with fmaf, as tile_t1.
template <int DIN>
__device__ __forceinline__ void t1_frags(const float (&dr)[2][DIN], const float* wd,
                                         const float* bd, uint32_t (&a)[32]) {
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int h = tc::acc_half(i), c = tc::acc_col(i);
    float x0 = dr[h][0] * wd[c], x1 = dr[h][0] * wd[c + 1];
#pragma unroll
    for (int k = 1; k < DIN; ++k) {
      x0 = fmaf(dr[h][k], wd[k * C + c], x0);
      x1 = fmaf(dr[h][k], wd[k * C + c + 1], x1);
    }
    a[i / 2] = tc::pack_bf2(fmaxf(x0 + bd[c], 0.f), fmaxf(x1 + bd[c + 1], 0.f));
  }
}

// e1_from_s's row addition for LanePooling: s += cg, from its staged tile X
// (the thread's rows r0 and r0 + 8).
__device__ __forceinline__ auto add_staged(const uint8_t* X_b, const tc::Tiles& X, int r0) {
  return [X_b, X, r0](int h, int c, float& x0, float& x1) {
    const float2 v = staged_pair(X_b, X, r0 + 8 * h, c);
    x0 += v.x;
    x1 += v.y;
  };
}

// Att's: s += cg from its staged tile, then qg from device memory (rows
// before e; W-wide rows), in the plain version's order.
template <int W = C>
__device__ __forceinline__ auto add_staged_q(const uint8_t* X_b, const tc::Tiles& X, int r0,
                                             const bf16* qg, long row0, int e) {
  return [X_b, X, r0, qg, row0, e](int h, int c, float& x0, float& x1) {
    const float2 v = staged_pair(X_b, X, r0 + 8 * h, c);
    x0 += v.x;
    x1 += v.y;
    const long row = row0 + r0 + 8 * h;
    if (row < e) {
      const float2 q = ld_bf2(qg + row * W + c);
      x0 += q.x;
      x1 += q.y;
    }
  };
}

// The thread's two rows of bf16 pairs a (the accumulator layout) to columns
// col .. col + W − 1 of rows row0 + r0 and row0 + r0 + 8 of dst [e, ld],
// where ok.
template <int W = C>
__device__ __forceinline__ void store_pairs(bf16* dst, int ld, long row0, int r0,
                                            const bool (&ok)[2], int col,
                                            const uint32_t (&a)[32]) {
#pragma unroll
  for (int i = 0; i < W / 2; i += 2) {
    const int h = tc::acc_half(i);
    if (ok[h])
      *reinterpret_cast<uint32_t*>(dst + (row0 + r0 + 8 * h) * ld + col + tc::acc_col(i)) =
          a[i / 2];
  }
}

// The forward (see the header), LanePooling's chain or Att's: warpgroup g
// of block b takes tiles b·PF_WGS + g, then every PF_WGS·B-th one; per
// warpgroup two stages of [d | cg] (cg's tile then takes the output).
template <int DIN, bool ATT, int W = C>
__device__ __forceinline__ void fwd_tc(const float* d, const bf16* qg, const bf16* cg,
                                       const bf16* kd, const float* bd, const bf16* kdo,
                                       const float* gdow, const float* gdob, const bf16* k1,
                                       const float* gchw, const float* gchb, const bf16* kout,
                                       bf16* out, int e, float eps) {
  constexpr int NW = chain_mats<ATT>(), NV = chain_vecs<DIN, ATT>();
  constexpr int STAGE = PD + PTB;
  extern __shared__ float4 smem4[];
  uint8_t* W_b = reinterpret_cast<uint8_t*>(smem4);          // (Wdo |) K1 | Wout
  float* vec_s = reinterpret_cast<float*>(W_b + NW * PWB);    // Wd, bd, (gdow, gdob,) gchw, gchb
  uint8_t* S_b = reinterpret_cast<uint8_t*>(vec_s + NV * C);  // [PF_WGS][2][d | cg]
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const tc::Tiles Wdo = tc::tiles(W_b, C), K1 = tc::tiles(W_b + (NW - 2) * PWB, C),
                  Wout = tc::tiles(W_b + (NW - 1) * PWB, C);
  load_chain_mats<ATT, W>(W_b, kdo, k1, kout, PF_THREADS);
  load_chain_vecs<DIN, ATT, W>(vec_s, kd, bd, gdow, gdob, gchw, gchb, PF_THREADS);
  tc::fence_smem();
  __syncthreads();  // the weights (for wgmma) and the vectors in place
  const float *wd_s = vec_s, *bd_s = vec_s + DIN * C, *gw_s = vec_s + (NV - 2) * C,
              *gb_s = vec_s + (NV - 1) * C;

  const int ntiles = (e + PT - 1) / PT, step = gridDim.x * PF_WGS, r0 = tc::acc_row(0);
  uint8_t* stage0 = S_b + wg * 2 * STAGE;
  auto fetch = [&](int tile, int s) {  // one commit group: the tile's d and cg rows
    uint8_t* st = stage0 + s * STAGE;
    fetch_d<DIN>(reinterpret_cast<float*>(st), d, (long)tile * PT, PT, e, t, 128);
    fetch_rows<W>(st + PD, cg, (long)tile * PT, PT, e, t, 128);
    cp_async_commit();
  };
  int tile = blockIdx.x * PF_WGS + wg;
  if (tile < ntiles) fetch(tile, 0);
  for (int k = 0; tile < ntiles; ++k, tile += step) {
    const int s = k & 1;
    cp_async_wait<0>();  // this tile, the one group in flight
    // the tile in place for the warpgroup, which is done with the other
    // stage (the previous tile's output copy), where the next tile goes
    wg_sync();
    if (tile + step < ntiles) fetch(tile + step, s ^ 1);
    const float* D = reinterpret_cast<const float*>(stage0 + s * STAGE);
    uint8_t* X_b = stage0 + s * STAGE + PD;
    const tc::Tiles X = tc::tiles(X_b, PT);
    float dr[2][DIN], acc[64], inv[2];
    uint32_t a[32];
    d_rows<DIN>(dr, D, r0);
    t1_frags<DIN>(dr, wd_s, bd_s, a);
    if constexpr (ATT) {  // z = t1 @ Wdo; a ← t2 = rnd(relu(GN_do(z)))
      float mu[2];
      tc::zero(acc);
      mm_frag<false, W>(acc, a, Wdo);
      t2_from_z<W>(acc, bd_s + C, bd_s + 2 * C, eps, mu, inv, a);
    }
    tc::zero(acc);  // s = t2 @ K1 (LanePooling: t1 @ K1)
    mm_frag<false, W>(acc, a, K1);
    if constexpr (ATT)
      e1_from_s<W>(acc, add_staged_q<W>(X_b, X, r0, qg, (long)tile * PT, e), gw_s, gb_s, eps,
                   inv, a);
    else
      e1_from_s<W>(acc, add_staged(X_b, X, r0), gw_s, gb_s, eps, inv, a);
    tc::zero(acc);  // out = e1 @ Wout, into cg's tile
    mm_frag<false, W>(acc, a, Wout);
#pragma unroll
    for (int i = 0; i < 64; i += 2) a[i / 2] = tc::pack_bf2(acc[i], acc[i + 1]);
    put_pairs(X_b, X, r0, a);
    wg_sync();  // the output tile complete
    store_rows<W>(out, X_b, X, (long)tile * PT, PT, e, t, 128);
  }
}

template <int DIN, int W>
__global__ void __launch_bounds__(PF_THREADS, 1)
edge_mlp_pool_tc_kernel(const float* __restrict__ d, const bf16* __restrict__ cg,
                        const bf16* __restrict__ kd, const float* __restrict__ bd,
                        const bf16* __restrict__ k1, const float* __restrict__ gchw,
                        const float* __restrict__ gchb, const bf16* __restrict__ kout,
                        bf16* __restrict__ out, int e, float eps) {
  fwd_tc<DIN, false, W>(d, nullptr, cg, kd, bd, nullptr, nullptr, nullptr, k1, gchw, gchb, kout,
                        out, e, eps);
}

template <int W>
__global__ void __launch_bounds__(PF_THREADS, 1)
edge_mlp_tc_kernel(const float* __restrict__ d, const bf16* __restrict__ qg,
                   const bf16* __restrict__ cg, const bf16* __restrict__ kd,
                   const float* __restrict__ bd, const bf16* __restrict__ kdo,
                   const float* __restrict__ gdow, const float* __restrict__ gdob,
                   const bf16* __restrict__ k1, const float* __restrict__ gchw,
                   const float* __restrict__ gchb, const bf16* __restrict__ kout,
                   bf16* __restrict__ out, int e, float eps) {
  fwd_tc<2, true, W>(d, qg, cg, kd, bd, kdo, gdow, gdob, k1, gchw, gchb, kout, out, e, eps);
}

// The backward's chain pass (pass 1, see the header), LanePooling's chain
// or Att's: the forward's grid and walk with PW_WGS warpgroups a block, per
// warpgroup two stages (bwd_stage; g's tile then takes rnd(d_s)). part_v:
// [blocks][NV][C], the block's vector sums: dbd, (dgdow, dgdob,) dgchw,
// dgchb, the DIN rows of dWd. Att's also writes each row's weight-gradient
// operands t1 | t2 | e1 | rnd(d_z) to act [e, 4C], and rnd(d_s) to dqg too.
template <int DIN, bool ATT, int W = C>
__device__ __forceinline__ void bwd_tc(const float* d, const bf16* qg, const bf16* cg,
                                       const bf16* g, const bf16* kd, const float* bd,
                                       const bf16* kdo, const float* gdow, const float* gdob,
                                       const bf16* k1, const float* gchw, const float* gchb,
                                       const bf16* kout, float* dd, bf16* dqg, bf16* dcg,
                                       bf16* act, float* part_v, int e, float eps) {
  constexpr int NW = chain_mats<ATT>(), NV = chain_vecs<DIN, ATT>();
  constexpr int VCH = ATT ? 3 : 1;  // the column sums: dbd, (dgdow, dgdob,) dgchw, dgchb, dWd
  constexpr int STAGE = bwd_stage<ATT>();
  constexpr int G_AT = PD + (ATT ? 0 : PTB);  // g's tile in a stage (LanePooling: after cg's)
  extern __shared__ float4 smem4[];
  uint8_t* W_b = reinterpret_cast<uint8_t*>(smem4);          // (Wdo |) K1 | Wout
  float* vec_s = reinterpret_cast<float*>(W_b + NW * PWB);    // Wd, bd, (gdow, gdob,) gchw, gchb
  uint8_t* S_b = reinterpret_cast<uint8_t*>(vec_s + NV * C);  // [PW_WGS][2][stage]
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const tc::Tiles Wdo = tc::tiles(W_b, C), K1 = tc::tiles(W_b + (NW - 2) * PWB, C),
                  Wout = tc::tiles(W_b + (NW - 1) * PWB, C);
  load_chain_mats<ATT, W>(W_b, kdo, k1, kout, PW_THREADS);
  load_chain_vecs<DIN, ATT, W>(vec_s, kd, bd, gdow, gdob, gchw, gchb, PW_THREADS);
  tc::fence_smem();
  __syncthreads();  // the weights (for wgmma) and the vectors in place
  const float *wd_s = vec_s, *bd_s = vec_s + DIN * C, *gw_s = vec_s + (NV - 2) * C,
              *gb_s = vec_s + (NV - 1) * C;

  const int ntiles = (e + PT - 1) / PT, step = gridDim.x * PW_WGS, r0 = tc::acc_row(0);
  uint8_t* stage0 = S_b + wg * 2 * STAGE;
  auto fetch = [&](int tile, int s) {  // one commit group: the tile's d, (cg,) g rows
    uint8_t* st = stage0 + s * STAGE;
    fetch_d<DIN>(reinterpret_cast<float*>(st), d, (long)tile * PT, PT, e, t, 128);
    if constexpr (!ATT) fetch_rows<W>(st + PD, cg, (long)tile * PT, PT, e, t, 128);
    fetch_rows<W>(st + G_AT, g, (long)tile * PT, PT, e, t, 128);
    cp_async_commit();
  };
  float va[NV][4];  // column sums (this lane's 4 columns)
#pragma unroll
  for (int k = 0; k < NV; ++k) va[k][0] = va[k][1] = va[k][2] = va[k][3] = 0.f;
  int tile = blockIdx.x * PW_WGS + wg;
  if (tile < ntiles) fetch(tile, 0);
  for (int k = 0; tile < ntiles; ++k, tile += step) {
    const int s = k & 1;
    cp_async_wait<0>();
    tc::fence_smem();  // g's tile for wgmma
    wg_sync();         // as the forward's
    if (tile + step < ntiles) fetch(tile + step, s ^ 1);
    const long row0 = (long)tile * PT;
    const float* D = reinterpret_cast<const float*>(stage0 + s * STAGE);
    const uint8_t* X_b = stage0 + s * STAGE + PD;
    uint8_t* Y_b = stage0 + s * STAGE + G_AT;
    const tc::Tiles X = tc::tiles(X_b, PT), Y = tc::tiles(Y_b, PT);
    const bool ok[2] = {row0 + r0 < e, row0 + r0 + 8 < e};
    float dr[2][DIN], acc[64], acc2[64], inv[2], muz[2], invz[2];
    uint32_t a[32];
    d_rows<DIN>(dr, D, r0);
    t1_frags<DIN>(dr, wd_s, bd_s, a);

    // Att: z = t1 @ Wdo; LanePooling: s = t1 @ K1; beside d_e1 = g @ Woutᵀ.
    tc::zero(acc);
    tc::zero(acc2);
    tc::fence_acc(acc);
    tc::fence_acc(acc2);
    tc::fence();
#pragma unroll
    for (int ks = 0; ks < W / 16; ++ks)
      tc::mma_rs<1>(acc, *reinterpret_cast<const uint32_t(*)[4]>(&a[4 * ks]),
                    tc::desc(ATT ? Wdo : K1, false, ks, 0));
    tc::mm<W / 16, true, true>(acc2, Y, 0, Wout);
    tc::commit();
    tc::wait_all();
    tc::fence_acc(acc);
    tc::fence_acc(acc2);
    if constexpr (ATT) {  // t1, t2 to act; s = t2 @ K1; s += cg + qg; e1 to act
      const int uu[2] = {(int)row0 + r0, (int)row0 + r0 + 8};
      store_pairs<W>(act, 4 * W, row0, r0, ok, 0, a);
      t2_from_z<W>(acc, bd_s + C, bd_s + 2 * C, eps, muz, invz, a);
      store_pairs<W>(act, 4 * W, row0, r0, ok, W, a);
      tc::zero(acc);
      mm_frag<false, W>(acc, a, K1);
      e1_from_s<W>(acc, add_cq<W>(ok, uu, uu, cg, qg), gw_s, gb_s, eps, inv, a);
      store_pairs<W>(act, 4 * W, row0, r0, ok, 2 * W, a);
    } else {  // s += cg
      e1_from_s<W>(acc, add_staged(X_b, X, r0), gw_s, gb_s, eps, inv, a);
    }
    // acc ← nrm_s, a ← e1; acc2 ← d_gn = d_e1 ⊙ [e1 > 0] (0 past e).
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int h = tc::acc_half(i);
      const float2 ef = unpack_bf2(a[i / 2]);
      acc2[i] = ok[h] && ef.x > 0.f ? acc2[i] : 0.f;
      acc2[i + 1] = ok[h] && ef.y > 0.f ? acc2[i + 1] : 0.f;
    }
    col_sums<true>(va[VCH], acc2, acc);        // dgchw
    col_sums<false>(va[VCH + 1], acc2, acc2);  // dgchb
    gn_bwd_acc<W>(acc2, acc, inv, gw_s, a);  // a ← rnd(d_s) = dcg (= dqg)
    wg_sync();  // every warp's products are done with g's tile, which takes rnd(d_s)
    put_pairs(Y_b, Y, r0, a);

    // LanePooling: d_t1 = rnd(d_s) @ K1ᵀ. Att: d_t2 = rnd(d_s) @ K1ᵀ, z
    // again, rnd(d_z) to act, d_t1 = rnd(d_z) @ Wdoᵀ.
    tc::zero(acc);
    mm_frag<true, W>(acc, a, K1);
    if constexpr (ATT) {
      t1_frags<DIN>(dr, wd_s, bd_s, a);
      tc::zero(acc2);
      mm_frag<false, W>(acc2, a, Wdo);
      gn_do_bwd<W>(acc, acc2, muz, invz, ok, bd_s + C, bd_s + 2 * C, va[1], va[2], a);
      store_pairs<W>(act, 4 * W, row0, r0, ok, 3 * W, a);
      tc::zero(acc);
      mm_frag<true, W>(acc, a, Wdo);
    }
    // d_t1p = d_t1 ⊙ [t1 > 0] (t1 made again).
    t1_frags<DIN>(dr, wd_s, bd_s, a);
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int h = tc::acc_half(i);
      const float2 tv = unpack_bf2(a[i / 2]);
      acc[i] = ok[h] && tv.x > 0.f ? acc[i] : 0.f;
      acc[i + 1] = ok[h] && tv.y > 0.f ? acc[i + 1] : 0.f;
    }
    col_sums<false>(va[0], acc, acc);  // dbd
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = rnd<bf16>(acc[i]);  // rnd(d_t1p)
#pragma unroll
    for (int kk = 0; kk < DIN; ++kk) {  // dWd row kk += Σ rnd(d)[kk] · rnd(d_t1p)
      float dv[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) dv[i] = dr[tc::acc_half(i)][kk];
      col_sums<true>(va[VCH + 2 + kk], acc, dv);
      if (dd) {  // dd[row][kk] = rnd(d_t1p) · rnd(Wd)[kk]
        float p[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 64; ++i) p[tc::acc_half(i)] += acc[i] * wd_s[kk * C + tc::acc_col(i)];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          p[h] = tc::quad_sum(p[h]);
          if ((t & 3) == 0 && ok[h]) dd[(row0 + r0 + 8 * h) * DIN + kk] = p[h];
        }
      }
    }
    wg_sync();  // rnd(d_s)'s tile complete
    store_rows<W>(dcg, Y_b, Y, row0, PT, e, t, 128);
    if constexpr (ATT) store_rows<W>(dqg, Y_b, Y, row0, PT, e, t, 128);
  }

  // The block's vectors: each warp's columns, summed over the warps in order.
  __syncthreads();
  float* red_s = reinterpret_cast<float*>(S_b);  // [PW_THREADS / 32][NV][C]
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
#pragma unroll
    for (int j = 0; j < 4; ++j) red_s[(warp * NV + k) * C + col_sum_col(j)] = va[k][j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < NV * W; i += PW_THREADS) {  // [NV][W]: the row's columns
    const int at = W == C ? i : (i / W) * C + i % W;
    float sum = 0.f;
    for (int w = 0; w < PW_THREADS / 32; ++w) sum += red_s[w * NV * C + at];
    part_v[(long)blockIdx.x * NV * W + i] = sum;
  }
}

template <int DIN, int W>
__global__ void __launch_bounds__(PW_THREADS, 1)
edge_mlp_pool_bwd_tc_kernel(const float* __restrict__ d, const bf16* __restrict__ cg,
                            const bf16* __restrict__ g, const bf16* __restrict__ kd,
                            const float* __restrict__ bd, const bf16* __restrict__ k1,
                            const float* __restrict__ gchw, const float* __restrict__ gchb,
                            const bf16* __restrict__ kout, float* __restrict__ dd,
                            bf16* __restrict__ dcg, float* __restrict__ part_v, int e,
                            float eps) {
  bwd_tc<DIN, false, W>(d, nullptr, cg, g, kd, bd, nullptr, nullptr, nullptr, k1, gchw, gchb,
                        kout, dd, nullptr, dcg, nullptr, part_v, e, eps);
}

template <int W>
__global__ void __launch_bounds__(PW_THREADS, 1)
edge_mlp_bwd_tc_kernel(const float* __restrict__ d, const bf16* __restrict__ qg,
                       const bf16* __restrict__ cg, const bf16* __restrict__ g,
                       const bf16* __restrict__ kd, const float* __restrict__ bd,
                       const bf16* __restrict__ kdo, const float* __restrict__ gdow,
                       const float* __restrict__ gdob, const bf16* __restrict__ k1,
                       const float* __restrict__ gchw, const float* __restrict__ gchb,
                       const bf16* __restrict__ kout, float* __restrict__ dd,
                       bf16* __restrict__ dqg, bf16* __restrict__ dcg, bf16* __restrict__ act,
                       float* __restrict__ part_v, int e, float eps) {
  bwd_tc<2, true, W>(d, qg, cg, g, kd, bd, kdo, gdow, gdob, k1, gchw, gchb, kout, dd, dqg, dcg,
                     act, part_v, e, eps);
}

// Att's weight gradients (pass 2, edge_tc.cuh dw_tc): row p of the list is
// edge p; rnd(d_s) is dcg.
template <int W>
__global__ void __launch_bounds__(NT)
edge_mlp_dw_tc_kernel(const bf16* __restrict__ act, const bf16* __restrict__ dcg,
                      const bf16* __restrict__ g, int e, float* __restrict__ part) {
  dw_tc<W>(act, dcg, W, g, nullptr, e, part);
}

// The backward's weight-gradient pass (pass 2, see the header): block
// (split, y) sums Aᵀ B over the DT-edge tiles split, split + splits, ...,
// y = 0: dK1 (A = t1, B = dcg), y = 1: dWout (A = e1, B = g), K running over
// a tile's edges (rows past e zero-filled), both operands MN-major from
// core tiles; warpgroup w owns input channels 64w .. 64w + 63. The tiles
// stream through a ring of stages by cp.async, [d | B] (y = 0: DW0_STAGES,
// three tiles in flight) or [d | B | cg] (y = 1: DW1_STAGES, what shared
// memory holds beside K1); A is made in place by the block's threads: t1
// from d, or e1 by the chain, each warpgroup on its 64 edges of the tile.
// part: [splits][dK1, dWout]. At width W (64: LanePooling at n_map = 64)
// the rows are read W wide into the same tiles, zero past W, the second
// warpgroup's input channels are padding (it makes its rows of A and skips
// its products) and part is [splits][2][W][W].
constexpr int DW0_STAGES = 4, DW1_STAGES = 2;
constexpr int DW0_STAGE = 2 * PD + DTB, DW1_STAGE = 2 * PD + 2 * DTB;

template <int DIN>
constexpr int pool_dw_smem() {
  return PWB + (DIN + 3) * C * (int)sizeof(float) + DTB +
         (DW0_STAGES * DW0_STAGE > DW1_STAGES * DW1_STAGE ? DW0_STAGES * DW0_STAGE
                                                          : DW1_STAGES * DW1_STAGE);
}

template <int DIN, int W>
__global__ void __launch_bounds__(PW_THREADS, 1)
edge_mlp_pool_dw_tc_kernel(const float* __restrict__ d, const bf16* __restrict__ cg,
                           const bf16* __restrict__ g, const bf16* __restrict__ dcg,
                           const bf16* __restrict__ kd, const float* __restrict__ bd,
                           const bf16* __restrict__ k1, const float* __restrict__ gchw,
                           const float* __restrict__ gchb, float* __restrict__ part, int e,
                           float eps) {
  extern __shared__ float4 smem4[];
  uint8_t* W_b = reinterpret_cast<uint8_t*>(smem4);                  // K1 (y = 1)
  float* vec_s = reinterpret_cast<float*>(W_b + PWB);                 // Wd, bd, gchw, gchb
  uint8_t* A_b = reinterpret_cast<uint8_t*>(vec_s + (DIN + 3) * C);  // [DT x C]: t1 or e1
  uint8_t* S_b = A_b + DTB;                                           // the ring
  const int y = blockIdx.y, wg = threadIdx.x >> 7;
  const tc::Tiles K1 = tc::tiles(W_b, C), A = tc::tiles(A_b, DT);
  if (y == 1) tc::load_tiles_128<W>(W_b, K1, k1);
  load_chain_vecs<DIN, false, W>(vec_s, kd, bd, nullptr, nullptr, gchw, gchb, PW_THREADS);
  tc::fence_smem();
  __syncthreads();  // K1 (for wgmma) and the vectors in place
  const float *wd_s = vec_s, *bd_s = vec_s + DIN * C, *gw_s = bd_s + C, *gb_s = gw_s + C;
  const int ntiles = (e + DT - 1) / DT, step = gridDim.x, r0 = tc::acc_row(0);
  float accw[64];
  tc::zero(accw);

  // y = 0: a thread makes the same 8 channels of t1 (chunk threadIdx.x % 16
  // of rows threadIdx.x / 16 + 16j), so their rnd(Wd) columns and bd sit in
  // registers for the whole walk.
  static_assert(PW_THREADS % (C / 8) == 0, "a thread's t1 chunks share their channels");
  const int c8 = (threadIdx.x & 15) * 8;
  float wreg[DIN][8], breg[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    breg[q] = bd_s[c8 + q];
#pragma unroll
    for (int kk = 0; kk < DIN; ++kk) wreg[kk][q] = wd_s[kk * C + c8 + q];
  }

  // The walk with S stages of `stage` bytes (S − 1 tiles in flight).
  auto walk = [&](auto stages, int stage) {
    constexpr int S = decltype(stages)::value;
    auto issue = [&](int tile, int st) {  // one commit group, empty past the last tile
      uint8_t* p = S_b + st * stage;
      if (tile < ntiles) {
        const long row0 = (long)tile * DT;
        fetch_d<DIN>(reinterpret_cast<float*>(p), d, row0, DT, e, threadIdx.x, PW_THREADS);
        fetch_rows<W>(p + 2 * PD, y == 0 ? dcg : g, row0, DT, e, threadIdx.x, PW_THREADS);
        if (y == 1) fetch_rows<W>(p + 2 * PD + DTB, cg, row0, DT, e, threadIdx.x, PW_THREADS);
      }
      cp_async_commit();
    };
#pragma unroll
    for (int j = 0; j < S - 1; ++j) issue(blockIdx.x + j * step, j);
    for (int k = 0, tile = blockIdx.x; tile < ntiles; ++k, tile += step) {
      cp_async_wait<S - 2>();  // tile k landed (the S − 2 after it may be in flight)
      tc::fence_smem();
      // tile k in place for every thread; both warpgroups done with tile
      // k − 1's A and stage, where tile k + S − 1 goes
      __syncthreads();
      issue(tile + (S - 1) * step, (k + S - 1) % S);
      const uint8_t* p = S_b + (k % S) * stage;
      const float* D = reinterpret_cast<const float*>(p);
      if (y == 0) {  // A = t1 = rnd(relu(rnd(d) @ rnd(Wd) + bd)), 8 channels a chunk
#pragma unroll 2
        for (int r = threadIdx.x >> 4; r < DT; r += PW_THREADS / 16) {
          float dv[DIN];
#pragma unroll
          for (int kk = 0; kk < DIN; ++kk) dv[kk] = rnd<bf16>(D[r * DIN + kk]);
          uint4 o;
          uint32_t* op = &o.x;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float x0 = dv[0] * wreg[0][2 * q], x1 = dv[0] * wreg[0][2 * q + 1];
#pragma unroll
            for (int kk = 1; kk < DIN; ++kk) {
              x0 = fmaf(dv[kk], wreg[kk][2 * q], x0);
              x1 = fmaf(dv[kk], wreg[kk][2 * q + 1], x1);
            }
            op[q] = tc::pack_bf2(fmaxf(x0 + breg[2 * q], 0.f), fmaxf(x1 + breg[2 * q + 1], 0.f));
          }
          *reinterpret_cast<uint4*>(A_b + tc::tile_off(A, r, c8)) = o;
        }
      } else {  // A = e1 of the warpgroup's 64 edges: t1 → s = t1 @ K1 + cg → e1
        const int rw = 64 * wg + r0;
        const uint8_t* X_b = p + 2 * PD + DTB;
        float dr[2][DIN], acc[64], inv[2];
        uint32_t a[32];
        d_rows<DIN>(dr, D, rw);
        t1_frags<DIN>(dr, wd_s, bd_s, a);
        tc::zero(acc);
        mm_frag<false, W>(acc, a, K1);
        e1_from_s<W>(acc, add_staged(X_b, tc::tiles(X_b, DT), rw), gw_s, gb_s, eps, inv, a);
        put_pairs(A_b, A, rw, a);
      }
      tc::fence_smem();
      __syncthreads();  // A in place
      if (W == C || 64 * wg < W) {  // at W = 64 the second warpgroup's channels are padding
        tc::fence_acc(accw);
        tc::fence();
        tc::mm<DT / 16, false, false>(accw, A, 64 * wg, tc::tiles(p + 2 * PD, DT));
        tc::commit();
        tc::wait_all();
        tc::fence_acc(accw);
      }
    }
    cp_async_wait<0>();  // the empty groups past the last tile
  };
  if (y == 0)
    walk(std::integral_constant<int, DW0_STAGES>{}, DW0_STAGE);
  else
    walk(std::integral_constant<int, DW1_STAGES>{}, DW1_STAGE);

  float* P = part + ((long)blockIdx.x * 2 + y) * W * W;
  if (W == C || 64 * wg < W) {
#pragma unroll
    for (int i = 0; i < W / 2; i += 2)
      *reinterpret_cast<float2*>(P + (64 * wg + tc::acc_row(i)) * W + tc::acc_col(i)) =
          make_float2(accw[i], accw[i + 1]);
  }
}

template <typename T, int W>
int launch(const float* d, const void* qg, const void* cg, const void* kd, const float* bd,
           const void* kdo, const float* gdow, const float* gdob, const void* k1,
           const float* gchw, const float* gchb, const void* kout, void* out, int e, float eps,
           cudaStream_t stream) {
  cudaError_t err;
  if constexpr (std::is_same<T, bf16>::value) {
    const int smem = fwd_tc_smem<2, true>();
    err = set_smem((const void*)edge_mlp_tc_kernel<W>, smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return (int)cudaGetLastError();
    const int tiles = (e + PT - 1) / PT, blocks = min(sms, (tiles + PF_WGS - 1) / PF_WGS);
    if (blocks > 0)
      edge_mlp_tc_kernel<W><<<blocks, PF_THREADS, smem, stream>>>(
          d, (const bf16*)qg, (const bf16*)cg, (const bf16*)kd, bd, (const bf16*)kdo, gdow, gdob,
          (const bf16*)k1, gchw, gchb, (const bf16*)kout, (bf16*)out, e, eps);
  } else {
    const int smem = (EB * LDA + C * C) * (int)sizeof(float);
    err = set_smem((const void*)edge_mlp_kernel<T, W>, smem);
    if (err != cudaSuccess) return (int)err;
    const int tiles = (e + EB - 1) / EB;
    if (tiles > 0)
      edge_mlp_kernel<T, W><<<tiles, NT, smem, stream>>>(
          d, (const T*)qg, (const T*)cg, (const T*)kd, bd, (const T*)kdo, gdow, gdob, (const T*)k1,
          gchw, gchb, (const T*)kout, (T*)out, e, eps);
  }
  return (int)cudaGetLastError();
}

// part: bf16 [blocks][7*W] (the chain pass's vector sums) then
// [splits][3*W*W] (the dW pass's partials), act [e, 4*W] bf16; fp32 one
// zeroed row of em_part<W>() per block, act unused.
template <typename T, int W>
int launch_bwd(const float* d, const void* qg, const void* cg, const void* g, const void* kd,
               const float* bd, const void* kdo, const float* gdow, const float* gdob,
               const void* k1, const float* gchw, const float* gchb, const void* kout, float* dd,
               void* dqg, void* dcg, void* act, float* part, float* grads, int e, int blocks,
               int splits, float eps, cudaStream_t stream) {
  cudaError_t err;
  if constexpr (std::is_same<T, bf16>::value) {
    const int nb = min(blocks, ((e + PT - 1) / PT + PW_WGS - 1) / PW_WGS);
    const int sp = min(splits, (e + DW_TE - 1) / DW_TE);
    float* part_w = part + (long)blocks * 7 * W;
    if (nb > 0) {
      int smem = bwd_tc_smem<2, true>();
      err = set_smem((const void*)edge_mlp_bwd_tc_kernel<W>, smem);
      if (err != cudaSuccess) return (int)err;
      edge_mlp_bwd_tc_kernel<W><<<nb, PW_THREADS, smem, stream>>>(
          d, (const bf16*)qg, (const bf16*)cg, (const bf16*)g, (const bf16*)kd, bd,
          (const bf16*)kdo, gdow, gdob, (const bf16*)k1, gchw, gchb, (const bf16*)kout, dd,
          (bf16*)dqg, (bf16*)dcg, (bf16*)act, part, e, eps);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      smem = dw_tc_smem();
      err = set_smem((const void*)edge_mlp_dw_tc_kernel<W>, smem);
      if (err != cudaSuccess) return (int)err;
      edge_mlp_dw_tc_kernel<W><<<dim3(sp, 3), NT, smem, stream>>>(
          (const bf16*)act, (const bf16*)dcg, (const bf16*)g, e, part_w);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    err = reduce_partials(part_w, grads, sp, 3 * W * W, stream);
    if (err != cudaSuccess) return (int)err;
    return (int)reduce_partials(part, grads + 3 * W * W, nb, 7 * W, stream);
  } else {
    const int smem = (4 * EB * LDA + C * C + 2 * EB) * (int)sizeof(float);
    err = set_smem((const void*)edge_mlp_bwd_kernel<T, W>, smem);
    if (err != cudaSuccess) return (int)err;
    const int tiles = (e + EB - 1) / EB;
    if (blocks > tiles) blocks = tiles;
    if (blocks > 0) {
      edge_mlp_bwd_kernel<T, W><<<blocks, NT, smem, stream>>>(
          d, (const T*)qg, (const T*)cg, (const T*)g, (const T*)kd, bd, (const T*)kdo, gdow, gdob,
          (const T*)k1, gchw, gchb, (const T*)kout, dd, (T*)dqg, (T*)dcg, part, e, eps);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    return (int)reduce_partials(part, grads, blocks, em_part<W>(), stream);
  }
}

template <typename T, int DIN, int W>
int launch_pool(const float* d, const void* cg, const void* kd, const float* bd, const void* k1,
                const float* gchw, const float* gchb, const void* kout, void* out, int e,
                float eps, cudaStream_t stream) {
  cudaError_t err;
  if constexpr (std::is_same<T, bf16>::value) {
    const int smem = fwd_tc_smem<DIN, false>();
    err = set_smem((const void*)edge_mlp_pool_tc_kernel<DIN, W>, smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return (int)cudaGetLastError();
    const int tiles = (e + PT - 1) / PT, blocks = min(sms, (tiles + PF_WGS - 1) / PF_WGS);
    if (blocks > 0)
      edge_mlp_pool_tc_kernel<DIN, W><<<blocks, PF_THREADS, smem, stream>>>(
          d, (const bf16*)cg, (const bf16*)kd, bd, (const bf16*)k1, gchw, gchb,
          (const bf16*)kout, (bf16*)out, e, eps);
  } else {
    const int smem = (EB * LDA + C * C) * (int)sizeof(float);
    err = set_smem((const void*)edge_mlp_pool_kernel<T, DIN, W>, smem);
    if (err != cudaSuccess) return (int)err;
    const int tiles = (e + EB - 1) / EB;
    if (tiles > 0)
      edge_mlp_pool_kernel<T, DIN, W><<<tiles, NT, smem, stream>>>(
          d, (const T*)cg, (const T*)kd, bd, (const T*)k1, gchw, gchb, (const T*)kout, (T*)out,
          e, eps);
  }
  return (int)cudaGetLastError();
}

// part: [blocks][pool_part<DIN, W>()] floats. bf16: the dW pass's partials
// [splits][dK1, dWout] from the start, the chain pass's vector sums
// [chain blocks][(3 + DIN)*W] from blocks*2*W*W; fp32: one row per block.
template <typename T, int DIN, int W>
int launch_pool_bwd(const float* d, const void* cg, const void* g, const void* kd,
                    const float* bd, const void* k1, const float* gchw, const float* gchb,
                    const void* kout, float* dd, void* dcg, float* part, float* grads, int e,
                    int blocks, float eps, cudaStream_t stream) {
  constexpr int NV = 3 + DIN;
  cudaError_t err;
  if constexpr (std::is_same<T, bf16>::value) {
    const int nb = min(blocks, ((e + PT - 1) / PT + PW_WGS - 1) / PW_WGS);
    const int splits = min(blocks, (e + DT - 1) / DT);
    float* part_v = part + (long)blocks * 2 * W * W;
    if (nb > 0) {
      int smem = bwd_tc_smem<DIN, false>();
      err = set_smem((const void*)edge_mlp_pool_bwd_tc_kernel<DIN, W>, smem);
      if (err != cudaSuccess) return (int)err;
      edge_mlp_pool_bwd_tc_kernel<DIN, W><<<nb, PW_THREADS, smem, stream>>>(
          d, (const bf16*)cg, (const bf16*)g, (const bf16*)kd, bd, (const bf16*)k1, gchw, gchb,
          (const bf16*)kout, dd, (bf16*)dcg, part_v, e, eps);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      smem = pool_dw_smem<DIN>();
      err = set_smem((const void*)edge_mlp_pool_dw_tc_kernel<DIN, W>, smem);
      if (err != cudaSuccess) return (int)err;
      edge_mlp_pool_dw_tc_kernel<DIN, W><<<dim3(splits, 2), PW_THREADS, smem, stream>>>(
          d, (const bf16*)cg, (const bf16*)g, (const bf16*)dcg, (const bf16*)kd, bd,
          (const bf16*)k1, gchw, gchb, part, e, eps);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    err = reduce_partials(part, grads, splits, 2 * W * W, stream);
    if (err != cudaSuccess) return (int)err;
    return (int)reduce_partials(part_v, grads + 2 * W * W, nb, NV * W, stream);
  } else {
    const int smem = (4 * EB * LDA + C * C + EB + NT / 32 * NV * C) * (int)sizeof(float);
    err = set_smem((const void*)edge_mlp_pool_bwd_kernel<T, DIN, W>, smem);
    if (err != cudaSuccess) return (int)err;
    const int tiles = (e + EB - 1) / EB;
    if (blocks > tiles) blocks = tiles;
    if (blocks > 0) {
      edge_mlp_pool_bwd_kernel<T, DIN, W><<<blocks, NT, smem, stream>>>(
          d, (const T*)cg, (const T*)g, (const T*)kd, bd, (const T*)k1, gchw, gchb,
          (const T*)kout, dd, (T*)dcg, part, e, eps);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    return (int)reduce_partials(part, grads, blocks, pool_part<DIN, W>(), stream);
  }
}

// --- Att's chain at W = 256 (wide.cuh's tiling; the double-width model's
// fusion edges) -----------------------------------------------------------------
//
// fp32 (edge_mlp_wide_kernel, the parity path): a block per 64-row tile,
// the chain in one fp32 [64 x 256] tile (t1, then z → t2, s → e1 in
// place), GN by warp-a-row, the three products on CUDA cores with each
// weight streamed in KC-row chunks; 97 KB of shared memory.
// bf16 (edge_mlp_wide_tc_kernel): a persistent grid of two-warpgroup
// blocks walking pairs of 64-row tiles, one a warpgroup. Wdo, K1 and Wout
// (3 x 128 KB) do not fit whole: they stream through a ring of four
// quadrant slots (QuadRing), three quadrants ahead of the products, so the
// next weight loads while a GroupNorm runs. Each warpgroup makes t1 from
// d straight into its A operand in shared memory; z = t1 @ Wdo, s = t2 @
// K1 and out = e1 @ Wout on wgmma into two m64n128 accumulators; t2 and e1
// made on the accumulators (cg then qg added to s from device memory) and
// written back to the A operand; out rounded and stored from the
// accumulators. A warpgroup whose tile lies past e runs the chain on zero
// rows and stores nothing (every thread takes part in every ring step).
// What bounds it: d, qg, cg read and out written (8 bytes and 3·256 bf16 a
// row) against 3·2·256² operations a row: 255 operations a byte, just below
// the card's ~295, so bytes, and nearly operations.

__global__ void __launch_bounds__(NT)
edge_mlp_wide_kernel(const float* __restrict__ d, const float* __restrict__ qg,
                     const float* __restrict__ cg, const float* __restrict__ kd,
                     const float* __restrict__ bd, const float* __restrict__ kdo,
                     const float* __restrict__ gdow, const float* __restrict__ gdob,
                     const float* __restrict__ k1, const float* __restrict__ gchw,
                     const float* __restrict__ gchb, const float* __restrict__ kout,
                     float* __restrict__ out, int e, float eps) {
  constexpr int WW = wide::WW, LDW = wide::LDW;
  extern __shared__ float4 smem4[];
  float* A_s = reinterpret_cast<float*>(smem4);  // [EB][LDW]
  float* W_s = A_s + EB * LDW;                   // [KC][256]
  const long row0 = (long)blockIdx.x * EB;
  const int warp = threadIdx.x >> 5;
  const float ones[8] = {1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f};
  float acc[8][8];

  // t1 = relu(d @ Wd + bd), 0 past e (tile_t1's arithmetic)
  for (int i = threadIdx.x; i < EB * (WW / 4); i += NT) {
    const int r = i / (WW / 4), c4 = (i % (WW / 4)) * 4;
    const long row = row0 + r;
    float4 t = zero4();
    if (row < e) {
      const float d0 = d[row * 2], d1 = d[row * 2 + 1];
      const float4 k0 = load4<float>(kd + c4), kk = load4<float>(kd + WW + c4);
      t = make_float4(d0 * k0.x, d0 * k0.y, d0 * k0.z, d0 * k0.w);
      t = make_float4(fmaf(d1, kk.x, t.x), fmaf(d1, kk.y, t.y), fmaf(d1, kk.z, t.z),
                      fmaf(d1, kk.w, t.w));
      t = relu4(add4(t, *reinterpret_cast<const float4*>(bd + c4)));
    }
    *reinterpret_cast<float4*>(A_s + r * LDW + c4) = t;
  }
  wide::zero8(acc);
  wide::mm_rows(A_s, 0, ones, kdo, W_s, acc);  // z = t1 @ Wdo
  __syncthreads();
  wide::store_tile(A_s, acc);
  __syncthreads();
  wide::gn_relu_tile(A_s, gdow, gdob, eps);  // t2
  wide::zero8(acc);
  wide::mm_rows(A_s, 0, ones, k1, W_s, acc);  // s = t2 @ K1
  __syncthreads();
  wide::store_tile(A_s, acc);
  __syncthreads();
  for (int r = warp; r < EB; r += NT / 32) {  // e1 = relu(GN(s + cg + qg))
    const long row = row0 + r;
    float* p = A_s + r * LDW;
    wide::Row sv = wide::ld_row(p);
    if (row < e) {
      sv = wide::add_row(sv, wide::ld_row_g<float>(cg + row * WW));
      sv = wide::add_row(sv, wide::ld_row_g<float>(qg + row * WW));
    }
    wide::st_row(p, wide::relu_row(wide::gn_row(sv, gchw, gchb, eps)));
  }
  wide::zero8(acc);
  wide::mm_rows(A_s, 0, ones, kout, W_s, acc);  // e2 = e1 @ Wout
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long row = row0 + wide::wrow(i);
    if (row < e) {
      *reinterpret_cast<float4*>(out + row * WW + wide::wcol(0)) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(out + row * WW + wide::wcol(4)) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
}

constexpr int EW_WGS = 2;
constexpr int EW_THREADS = 128 * EW_WGS;
constexpr int EW_RING = 4;  // quadrant slots

inline int edge_mlp_wide_tc_smem() {
  return EW_RING * wide::QB + EW_WGS * 2 * wide::HB + 7 * wide::WW * (int)sizeof(float);
}

__global__ void __launch_bounds__(EW_THREADS, 1)
edge_mlp_wide_tc_kernel(const float* __restrict__ d, const bf16* __restrict__ qg,
                        const bf16* __restrict__ cg, const bf16* __restrict__ kd,
                        const float* __restrict__ bd, const bf16* __restrict__ kdo,
                        const float* __restrict__ gdow, const float* __restrict__ gdob,
                        const bf16* __restrict__ k1, const float* __restrict__ gchw,
                        const float* __restrict__ gchb, const bf16* __restrict__ kout,
                        bf16* __restrict__ out, int e, float eps) {
  constexpr int WW = wide::WW;
  extern __shared__ float4 smem4[];
  uint8_t* R_b = reinterpret_cast<uint8_t*>(smem4);  // the ring's quadrant slots
  uint8_t* H_all = R_b + EW_RING * wide::QB;
  // bd, gdow, gdob, gchw, gchb, then Wd's two rows (as floats)
  float* vec_s = reinterpret_cast<float*>(H_all + EW_WGS * 2 * wide::HB);
  const int wg = threadIdx.x >> 7;
  uint8_t* H_b = H_all + wg * 2 * wide::HB;  // the warpgroup's A operand

  const int ntiles = (e + EB - 1) / EB, pairs = (ntiles + EW_WGS - 1) / EW_WGS;
  const int mine = blockIdx.x < pairs ? (pairs - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  auto chain = [=](int k) { return k % 3 == 0 ? kdo : k % 3 == 1 ? k1 : kout; };
  auto ring = wide::quad_ring<EW_RING>(R_b, chain, 12 * mine);
  ring.start();
  for (int i = threadIdx.x; i < 7 * WW; i += EW_THREADS) {
    const int k = i / WW, c = i & (WW - 1);
    const float* v = k == 0 ? bd : k == 1 ? gdow : k == 2 ? gdob : k == 3 ? gchw : gchb;
    vec_s[i] = k < 5 ? v[c] : __bfloat162float(kd[(k - 5) * WW + c]);
  }
  const float *bd_s = vec_s, *gdow_s = vec_s + WW, *gdob_s = vec_s + 2 * WW,
              *gchw_s = vec_s + 3 * WW, *gchb_s = vec_s + 4 * WW, *kd_s = vec_s + 5 * WW;
  __syncthreads();  // the vectors in place

  for (int p = blockIdx.x; p < pairs; p += gridDim.x) {
    const long row0 = (long)(p * EW_WGS + wg) * EB;
    float dr[2][2];  // rnd(d) of the thread's two rows
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long row = row0 + tc::acc_row(2 * h);
      dr[h][0] = row < e ? rnd<bf16>(d[row * 2]) : 0.f;
      dr[h][1] = row < e ? rnd<bf16>(d[row * 2 + 1]) : 0.f;
    }
    wg_sync();  // the warpgroup's previous products are done with H
#pragma unroll
    for (int n = 0; n < 2; ++n) {  // t1 = rnd(relu(rnd(d) @ rnd(Wd) + bd)) into H
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int h = tc::acc_half(i), c = wide::acc_col(n, i);
        const bool in = row0 + tc::acc_row(i) < e;
        float t0 = fmaf(dr[h][1], kd_s[WW + c], dr[h][0] * kd_s[c]);
        float t1 = fmaf(dr[h][1], kd_s[WW + c + 1], dr[h][0] * kd_s[c + 1]);
        t0 = in ? fmaxf(t0 + bd_s[c], 0.f) : 0.f;
        t1 = in ? fmaxf(t1 + bd_s[c + 1], 0.f) : 0.f;
        *wide::a_pair(H_b, tc::acc_row(i), c) = tc::pack_bf2(t0, t1);
      }
    }
    float a[2][64];
    wide::zero2(a);
#pragma unroll
    for (int q = 0; q < 4; ++q) wide::mm_quadrant(a[q >> 1], H_b, q & 1, ring.take());  // z
    wg_sync();
    wide::gn_relu_to(H_b, a, gdow_s, gdob_s, eps);  // t2
    wide::zero2(a);
#pragma unroll
    for (int q = 0; q < 4; ++q) wide::mm_quadrant(a[q >> 1], H_b, q & 1, ring.take());  // s
#pragma unroll
    for (int n = 0; n < 2; ++n) {  // s += cg + qg
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const long row = row0 + tc::acc_row(i);
        if (row < e) {
          const int c = wide::acc_col(n, i);
          const float2 cv = ld_bf2(cg + row * WW + c), qv = ld_bf2(qg + row * WW + c);
          a[n][i] = a[n][i] + cv.x + qv.x;
          a[n][i + 1] = a[n][i + 1] + cv.y + qv.y;
        }
      }
    }
    wg_sync();
    wide::gn_relu_to(H_b, a, gchw_s, gchb_s, eps);  // e1
    wide::zero2(a);
#pragma unroll
    for (int q = 0; q < 4; ++q) wide::mm_quadrant(a[q >> 1], H_b, q & 1, ring.take());  // out
    wide::store_rows<bf16>(out, a, row0, e);
  }
}

template <typename T>
int launch_wide(const float* d, const void* qg, const void* cg, const void* kd, const float* bd,
                const void* kdo, const float* gdow, const float* gdob, const void* k1,
                const float* gchw, const float* gchb, const void* kout, void* out, int e,
                float eps, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    const int smem = edge_mlp_wide_tc_smem();
    cudaError_t err = set_smem((const void*)edge_mlp_wide_tc_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const int sms = wide::sm_count();
    if (sms < 0) return (int)cudaGetLastError();
    const int pairs = ((e + EB - 1) / EB + EW_WGS - 1) / EW_WGS, blocks = min(sms, pairs);
    if (blocks > 0)
      edge_mlp_wide_tc_kernel<<<blocks, EW_THREADS, smem, stream>>>(
          d, (const bf16*)qg, (const bf16*)cg, (const bf16*)kd, bd, (const bf16*)kdo, gdow, gdob,
          (const bf16*)k1, gchw, gchb, (const bf16*)kout, (bf16*)out, e, eps);
  } else {
    const int smem = wide::TILE_BYTES + wide::CHUNK_BYTES;
    cudaError_t err = set_smem((const void*)edge_mlp_wide_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (e + EB - 1) / EB;
    if (blocks > 0)
      edge_mlp_wide_kernel<<<blocks, NT, smem, stream>>>(
          d, (const float*)qg, (const float*)cg, (const float*)kd, bd, (const float*)kdo, gdow,
          gdob, (const float*)k1, gchw, gchb, (const float*)kout, (float*)out, e, eps);
  }
  return (int)cudaGetLastError();
}

// --- Att's backward at W = 256 (wide_bwd.cuh; the double-width model trains) ------------
//
// Two passes, as at 128, then the partial sums:
// 1. the chain pass: per row the chain again and back (edge_mlp_bwd_plain's
//    order): t1, z = t1 @ Wdo, t2, s = t2 @ K1 + cg + qg, e1; d_e1 = rnd(g)
//    @ Woutᵀ, d_s = rnd(GN_chᵀ(d_e1 ⊙ [e1 > 0])) = dqg = dcg; d_s @ K1ᵀ,
//    d_z = rnd(GN_doᵀ(· ⊙ [t2 > 0])); d_z @ Wdoᵀ, d_t1p = · ⊙ [t1 > 0]; dd =
//    rnd(d_t1p) @ Wdᵀ; the seven vector gradients (dbd, dgdow, dgdob, dgchw,
//    dgchb, dWd's rows) as column sums, per block. Each row's weight-
//    gradient operands t1 | t2 | e1 | rnd(d_z) go to act [e, 4·256] in the
//    activation dtype, and the normalised rows nrm_z | nrm_s, which the
//    GroupNorm backwards need after two more products, to an fp32 [e, 2·256]
//    workspace (the plain version keeps them in fp32).
//    bf16 (edge_mlp_bwd_wide_tc_kernel): edge_mlp_wide_tc_kernel's
//    persistent grid of two-warpgroup blocks on pairs of 64-row tiles. At
//    most one 256-wide product's accumulators (two m64n128, 128 registers a
//    thread) are live at a time: the five products run in turn from the
//    warpgroup's A operand in shared memory (t1, t2, rnd(g), rnd(d_s),
//    rnd(d_z)), and Wdo, K1, Wout, K1, Wdo (5 x 128 KB) stream through a ring
//    of EB_RING quadrant slots, read MN-major for z and s and K-major for
//    the three transposed products. A mask or GroupNorm input a later step
//    needs comes back from act or the fp32 workspace (the thread's own
//    elements). The column sums per warp in shared memory ([8][7][256]
//    fp32); 218 KB of shared memory.
//    fp32 (edge_mlp_bwd_wide_kernel): a persistent grid of 256-thread blocks
//    on 64-row tiles, the chain in one fp32 [64 x 256] tile by warp-a-row,
//    the products on CUDA cores with the weights streamed in KC-row chunks,
//    the column sums per warp in registers.
// 2. the weight-gradient pass (wide_bwd.cuh): dWdo = t1ᵀ rnd(d_z), dK1 =
//    t2ᵀ rnd(d_s), dWout = e1ᵀ rnd(g), (splits, 3·4) blocks, one [128 x 128]
//    quadrant of one gradient each.
// What bounds it: nine 256-wide products per row (2·9·256² operations)
// against d, qg, cg, g read and dd, dqg, dcg written (16 bytes and 5·256
// bf16 a row): operations.
constexpr int EB_RING = 3;  // quadrant slots of the chain pass's weight stream
constexpr int EB_NV = 7;    // its vector gradients

inline int edge_mlp_bwd_wide_tc_smem() {
  return EB_RING * wide::QB + EW_WGS * 2 * wide::HB +
         NT / 32 * EB_NV * wide::WW * (int)sizeof(float);
}
static_assert(EW_THREADS == NT, "the per-warp vectors are NT/32 rows");

__global__ void __launch_bounds__(EW_THREADS, 1)
edge_mlp_bwd_wide_tc_kernel(const float* __restrict__ d, const bf16* __restrict__ qg,
                            const bf16* __restrict__ cg, const bf16* __restrict__ g,
                            const bf16* __restrict__ kd, const float* __restrict__ bd,
                            const bf16* __restrict__ kdo, const float* __restrict__ gdow,
                            const float* __restrict__ gdob, const bf16* __restrict__ k1,
                            const float* __restrict__ gchw, const float* __restrict__ gchb,
                            const bf16* __restrict__ kout, float* __restrict__ dd,
                            bf16* __restrict__ dqg, bf16* __restrict__ dcg,
                            bf16* __restrict__ act, float* __restrict__ nrm,
                            float* __restrict__ part_v, int e, float eps) {
  constexpr int WW = wide::WW;
  extern __shared__ float4 smem4[];
  uint8_t* R_b = reinterpret_cast<uint8_t*>(smem4);  // the ring's quadrant slots
  uint8_t* H_all = R_b + EB_RING * wide::QB;
  float* vec_s = reinterpret_cast<float*>(H_all + EW_WGS * 2 * wide::HB);  // [8][7][256]
  const int wg = threadIdx.x >> 7, warp = threadIdx.x >> 5;
  uint8_t* H_b = H_all + wg * 2 * wide::HB;  // the warpgroup's A operand

  const int ntiles = (e + EB - 1) / EB, pairs = (ntiles + EW_WGS - 1) / EW_WGS;
  const int mine = blockIdx.x < pairs ? (pairs - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  auto chain = [=](int k) {  // per tile pair: Wdo, K1, Wout, K1ᵀ, Wdoᵀ
    const int s = k % 5;
    return s == 2 ? kout : s == 1 || s == 3 ? k1 : kdo;
  };
  auto ring = wide::quad_ring<EB_RING>(R_b, chain, 20 * mine);
  ring.start();
  for (int i = threadIdx.x; i < NT / 32 * EB_NV * WW; i += EW_THREADS) vec_s[i] = 0.f;
  __syncthreads();  // the zeroed vectors in place
  float* v_s = vec_s + warp * EB_NV * WW;  // dbd, dgdow, dgdob, dgchw, dgchb, dWd's rows

  for (int p = blockIdx.x; p < pairs; p += gridDim.x) {
    const long row0 = (long)(p * EW_WGS + wg) * EB;
    const bool ok[2] = {row0 + tc::acc_row(0) < e, row0 + tc::acc_row(2) < e};
    float dr[2][2];  // rnd(d) of the thread's two rows
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long row = row0 + tc::acc_row(2 * h);
      dr[h][0] = ok[h] ? rnd<bf16>(d[row * 2]) : 0.f;
      dr[h][1] = ok[h] ? rnd<bf16>(d[row * 2 + 1]) : 0.f;
    }
    // The thread's element pair i of half n2 of a row's act block k (t1, t2,
    // e1) or of its fp32 workspace block k (nrm_z, nrm_s); 0 past e.
    auto act2 = [&](int k, int n2, int i) {
      return ok[tc::acc_half(i)] ? ld_bf2(act + (row0 + tc::acc_row(i)) * 4 * WW + k * WW +
                                          wide::acc_col(n2, i))
                                 : make_float2(0.f, 0.f);
    };
    auto nrm2 = [&](int k, int n2, int i) {
      return ok[tc::acc_half(i)]
                 ? *reinterpret_cast<const float2*>(nrm + (row0 + tc::acc_row(i)) * 2 * WW +
                                                    k * WW + wide::acc_col(n2, i))
                 : make_float2(0.f, 0.f);
    };
    auto nrm1 = [&](int k, int n2, int i) {
      const float2 v = nrm2(k, n2, i & ~1);
      return (i & 1) ? v.y : v.x;
    };
    // out(n2, i, u): the bf16 pair u of element pair i of half n2 into H and,
    // on rows before e, into act's block k (k < 0: nowhere else).
    auto put = [&](int k, int n2, int i, uint32_t u) {
      const int r = tc::acc_row(i), c = wide::acc_col(n2, i);
      *wide::a_pair(H_b, r, c) = u;
      if (k >= 0 && ok[tc::acc_half(i)])
        *reinterpret_cast<uint32_t*>(act + (row0 + r) * 4 * WW + k * WW + c) = u;
    };
    float a[2][64], mu[2], invz[2], invs[2], c1[2], c2[2];

    wg_sync();  // the warpgroup's previous products are done with H
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2) {  // t1 = rnd(relu(rnd(d) @ rnd(Wd) + bd))
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int h = tc::acc_half(i), c = wide::acc_col(n2, i);
        const float k00 = __bfloat162float(kd[c]), k01 = __bfloat162float(kd[c + 1]);
        const float k10 = __bfloat162float(kd[WW + c]), k11 = __bfloat162float(kd[WW + c + 1]);
        const float t0 = fmaf(dr[h][1], k10, dr[h][0] * k00);
        const float t1 = fmaf(dr[h][1], k11, dr[h][0] * k01);
        put(0, n2, i, tc::pack_bf2(ok[h] ? fmaxf(t0 + bd[c], 0.f) : 0.f,
                                   ok[h] ? fmaxf(t1 + bd[c + 1], 0.f) : 0.f));
      }
    }
    tc::fence_smem();
    wg_sync();
    wide::zero2(a);
#pragma unroll
    for (int q = 0; q < 4; ++q) wide::mm_quadrant(a[q >> 1], H_b, q & 1, ring.take());  // z
    wide::row_stats(a, eps, mu, invz);
    wg_sync();  // the product is done with H
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2) {  // nrm_z out; t2 = rnd(relu(GN_do(z)))
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int h = tc::acc_half(i), c = wide::acc_col(n2, i);
        const float z0 = (a[n2][i] - mu[h]) * invz[h], z1 = (a[n2][i + 1] - mu[h]) * invz[h];
        if (ok[h])
          *reinterpret_cast<float2*>(nrm + (row0 + tc::acc_row(i)) * 2 * WW + c) =
              make_float2(z0, z1);
        put(1, n2, i, tc::pack_bf2(fmaxf(z0 * gdow[c] + gdob[c], 0.f),
                                   fmaxf(z1 * gdow[c + 1] + gdob[c + 1], 0.f)));
      }
    }
    tc::fence_smem();
    wg_sync();
    wide::zero2(a);
#pragma unroll
    for (int q = 0; q < 4; ++q) wide::mm_quadrant(a[q >> 1], H_b, q & 1, ring.take());  // s
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2) {  // s += cg + qg
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        if (!ok[tc::acc_half(i)]) continue;
        const long row = row0 + tc::acc_row(i);
        const int c = wide::acc_col(n2, i);
        const float2 cv = ld_bf2(cg + row * WW + c), qv = ld_bf2(qg + row * WW + c);
        a[n2][i] = a[n2][i] + cv.x + qv.x;
        a[n2][i + 1] = a[n2][i + 1] + cv.y + qv.y;
      }
    }
    wide::row_stats(a, eps, mu, invs);
    wg_sync();  // the product is done with H
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2) {  // nrm_s and e1 = rnd(relu(GN_ch(s))) out; H ← rnd(g)
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int h = tc::acc_half(i), c = wide::acc_col(n2, i);
        const long row = row0 + tc::acc_row(i);
        const float s0 = (a[n2][i] - mu[h]) * invs[h], s1 = (a[n2][i + 1] - mu[h]) * invs[h];
        uint32_t gu = 0u;
        if (ok[h]) {
          *reinterpret_cast<float2*>(nrm + row * 2 * WW + WW + c) = make_float2(s0, s1);
          *reinterpret_cast<uint32_t*>(act + row * 4 * WW + 2 * WW + c) =
              tc::pack_bf2(fmaxf(s0 * gchw[c] + gchb[c], 0.f),
                           fmaxf(s1 * gchw[c + 1] + gchb[c + 1], 0.f));
          gu = *reinterpret_cast<const uint32_t*>(g + row * WW + c);
        }
        put(-1, n2, i, gu);
      }
    }
    tc::fence_smem();
    wg_sync();
    wide::zero2(a);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      wide::mm_quadrant_t(a[q & 1], H_b, q >> 1, ring.take());  // d_e1 = rnd(g) @ Woutᵀ
    // d_gn_s = d_e1 ⊙ [e1 > 0] (0 past e); GN_ch's backward → rnd(d_s).
    c1[0] = c1[1] = c2[0] = c2[1] = 0.f;
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2) {
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int h = tc::acc_half(i), c = wide::acc_col(n2, i);
        const float2 ev = act2(2, n2, i), sv = nrm2(1, n2, i);
        a[n2][i] = ev.x > 0.f ? a[n2][i] : 0.f;
        a[n2][i + 1] = ev.y > 0.f ? a[n2][i + 1] : 0.f;
        const float dn0 = a[n2][i] * gchw[c], dn1 = a[n2][i + 1] * gchw[c + 1];
        c1[h] += dn0;
        c2[h] += dn0 * sv.x;
        c1[h] += dn1;
        c2[h] += dn1 * sv.y;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      c1[h] = tc::quad_sum(c1[h]) * (1.f / WW);
      c2[h] = tc::quad_sum(c2[h]) * (1.f / WW);
    }
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2) {  // dgchw, dgchb
      wide::col_add(v_s + 3 * WW, n2, [&](int i) { return a[n2][i] * nrm1(1, n2, i); });
      wide::col_add(v_s + 4 * WW, n2, [&](int i) { return a[n2][i]; });
    }
    wg_sync();  // the product is done with H
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2) {  // rnd(d_s) into H, dcg and dqg
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int h = tc::acc_half(i), c = wide::acc_col(n2, i);
        const float2 sv = nrm2(1, n2, i);
        const uint32_t u = tc::pack_bf2(invs[h] * (a[n2][i] * gchw[c] - c1[h] - sv.x * c2[h]),
                                        invs[h] * (a[n2][i + 1] * gchw[c + 1] - c1[h] - sv.y * c2[h]));
        put(-1, n2, i, u);
        if (ok[h]) {
          const long o = (row0 + tc::acc_row(i)) * WW + c;
          *reinterpret_cast<uint32_t*>(dcg + o) = u;
          *reinterpret_cast<uint32_t*>(dqg + o) = u;
        }
      }
    }
    tc::fence_smem();
    wg_sync();
    wide::zero2(a);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      wide::mm_quadrant_t(a[q & 1], H_b, q >> 1, ring.take());  // rnd(d_s) @ K1ᵀ
    // d_gn_z = · ⊙ [t2 > 0]; GN_do's backward → rnd(d_z).
    c1[0] = c1[1] = c2[0] = c2[1] = 0.f;
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2) {
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int h = tc::acc_half(i), c = wide::acc_col(n2, i);
        const float2 tv = act2(1, n2, i), zv = nrm2(0, n2, i);
        a[n2][i] = tv.x > 0.f ? a[n2][i] : 0.f;
        a[n2][i + 1] = tv.y > 0.f ? a[n2][i + 1] : 0.f;
        const float dn0 = a[n2][i] * gdow[c], dn1 = a[n2][i + 1] * gdow[c + 1];
        c1[h] += dn0;
        c2[h] += dn0 * zv.x;
        c1[h] += dn1;
        c2[h] += dn1 * zv.y;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      c1[h] = tc::quad_sum(c1[h]) * (1.f / WW);
      c2[h] = tc::quad_sum(c2[h]) * (1.f / WW);
    }
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2) {  // dgdow, dgdob
      wide::col_add(v_s + WW, n2, [&](int i) { return a[n2][i] * nrm1(0, n2, i); });
      wide::col_add(v_s + 2 * WW, n2, [&](int i) { return a[n2][i]; });
    }
    wg_sync();  // the product is done with H
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2) {  // rnd(d_z) into H and act
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int h = tc::acc_half(i), c = wide::acc_col(n2, i);
        const float2 zv = nrm2(0, n2, i);
        put(3, n2, i, tc::pack_bf2(invz[h] * (a[n2][i] * gdow[c] - c1[h] - zv.x * c2[h]),
                                   invz[h] * (a[n2][i + 1] * gdow[c + 1] - c1[h] - zv.y * c2[h])));
      }
    }
    tc::fence_smem();
    wg_sync();
    wide::zero2(a);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      wide::mm_quadrant_t(a[q & 1], H_b, q >> 1, ring.take());  // rnd(d_z) @ Wdoᵀ
    // d_t1p = · ⊙ [t1 > 0]: dbd; then rnd(d_t1p): dWd's rows and dd.
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2) {
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const float2 tv = act2(0, n2, i);
        a[n2][i] = tv.x > 0.f ? a[n2][i] : 0.f;
        a[n2][i + 1] = tv.y > 0.f ? a[n2][i + 1] : 0.f;
      }
    }
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2) {
      wide::col_add(v_s, n2, [&](int i) { return a[n2][i]; });  // dbd
#pragma unroll
      for (int i = 0; i < 64; ++i) a[n2][i] = rnd<bf16>(a[n2][i]);
      wide::col_add(v_s + 5 * WW, n2, [&](int i) { return a[n2][i] * dr[tc::acc_half(i)][0]; });
      wide::col_add(v_s + 6 * WW, n2, [&](int i) { return a[n2][i] * dr[tc::acc_half(i)][1]; });
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {  // dd[row][k] = rnd(d_t1p) · rnd(Wd)[k]
      float s[2] = {0.f, 0.f};
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2) {
#pragma unroll
        for (int i = 0; i < 64; ++i)
          s[tc::acc_half(i)] += a[n2][i] * __bfloat162float(kd[k * WW + wide::acc_col(n2, i)]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s[h] = tc::quad_sum(s[h]);
        if ((threadIdx.x & 3) == 0 && ok[h]) dd[(row0 + tc::acc_row(2 * h)) * 2 + k] = s[h];
      }
    }
  }
  wide::sum_warps<EB_NV>(vec_s, part_v + (long)blockIdx.x * EB_NV * WW);
}

__global__ void __launch_bounds__(NT)
edge_mlp_bwd_wide_kernel(const float* __restrict__ d, const float* __restrict__ qg,
                         const float* __restrict__ cg, const float* __restrict__ g,
                         const float* __restrict__ kd, const float* __restrict__ bd,
                         const float* __restrict__ kdo, const float* __restrict__ gdow,
                         const float* __restrict__ gdob, const float* __restrict__ k1,
                         const float* __restrict__ gchw, const float* __restrict__ gchb,
                         const float* __restrict__ kout, float* __restrict__ dd,
                         float* __restrict__ dqg, float* __restrict__ dcg,
                         float* __restrict__ act, float* __restrict__ nrm,
                         float* __restrict__ part_v, int e, float eps) {
  using wide::Row;
  constexpr int WW = wide::WW, LDW = wide::LDW;
  extern __shared__ float4 smem4[];
  float* T_s = reinterpret_cast<float*>(smem4);  // [EB][LDW] the chain's current rows
  float* W_s = T_s + EB * LDW;                   // [KC][256]
  float* st_s = W_s + wide::KC * WW;             // [EB][2] GN_do's and GN_ch's inv
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float ones[8] = {1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f};
  Row v[EB_NV];  // dbd, dgdow, dgdob, dgchw, dgchb, dWd's rows (this lane's columns)
#pragma unroll
  for (int q = 0; q < EB_NV; ++q) v[q] = wide::zero_row();
  auto rows = [&](float* base, int ld, long row) { return base + row * ld; };
  const int ntiles = (e + EB - 1) / EB;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long row0 = (long)tile * EB;
    __syncthreads();  // the previous tile is done with T_s and st_s
    for (int i = threadIdx.x; i < EB * (WW / 4); i += NT) {  // t1 (0 past e)
      const int r = i / (WW / 4), c4 = (i % (WW / 4)) * 4;
      const long row = row0 + r;
      float4 t = zero4();
      if (row < e) {
        const float d0 = d[row * 2], d1 = d[row * 2 + 1];
        const float4 k0 = load4<float>(kd + c4), kk = load4<float>(kd + WW + c4);
        t = make_float4(d0 * k0.x, d0 * k0.y, d0 * k0.z, d0 * k0.w);
        t = make_float4(fmaf(d1, kk.x, t.x), fmaf(d1, kk.y, t.y), fmaf(d1, kk.z, t.z),
                        fmaf(d1, kk.w, t.w));
        t = relu4(add4(t, *reinterpret_cast<const float4*>(bd + c4)));
        *reinterpret_cast<float4*>(act + row * 4 * WW + c4) = t;
      }
      *reinterpret_cast<float4*>(T_s + r * LDW + c4) = t;
    }
    float acc[8][8];
    auto product = [&](const float* w, bool transposed) {  // T_s ← T_s @ w (or wᵀ)
      wide::zero8(acc);
      if (transposed)
        wide::mm_rows<true>(T_s, 0, ones, w, W_s, acc);
      else
        wide::mm_rows(T_s, 0, ones, w, W_s, acc);
      __syncthreads();
      wide::store_tile(T_s, acc);
      __syncthreads();
    };
    product(kdo, false);  // z
    for (int r = warp; r < EB; r += NT / 32) {  // nrm_z out; t2 = relu(GN_do(z))
      const long row = row0 + r;
      Row t2 = wide::zero_row();
      if (row < e) {
        const Row z = wide::ld_row(T_s + r * LDW);
        const float2 st = wide::row_stats(z, eps);
        const Row nz = wide::nrm_row(z, st);
        wide::st_row_g<float>(rows(nrm, 2 * WW, row), nz);
        t2 = wide::relu_row(wide::affine_row(nz, gdow, gdob));
        wide::st_row_g<float>(rows(act, 4 * WW, row) + WW, t2);
        if (lane == 0) st_s[2 * r] = st.y;
      }
      wide::st_row(T_s + r * LDW, t2);
    }
    product(k1, false);  // s
    for (int r = warp; r < EB; r += NT / 32) {  // nrm_s and e1 out; T_s ← g
      const long row = row0 + r;
      Row gv = wide::zero_row();
      if (row < e) {
        const Row sv = wide::add_row(wide::add_row(wide::ld_row(T_s + r * LDW),
                                                   wide::ld_row_g<float>(cg + row * WW)),
                                     wide::ld_row_g<float>(qg + row * WW));
        const float2 st = wide::row_stats(sv, eps);
        const Row ns = wide::nrm_row(sv, st);
        wide::st_row_g<float>(rows(nrm, 2 * WW, row) + WW, ns);
        wide::st_row_g<float>(rows(act, 4 * WW, row) + 2 * WW,
                              wide::relu_row(wide::affine_row(ns, gchw, gchb)));
        if (lane == 0) st_s[2 * r + 1] = st.y;
        gv = wide::ld_row_g<float>(g + row * WW);
      }
      wide::st_row(T_s + r * LDW, gv);
    }
    product(kout, true);  // d_e1 = g @ Woutᵀ
    for (int r = warp; r < EB; r += NT / 32) {  // d_gn_s, GN_ch's backward → d_s
      const long row = row0 + r;
      Row ds = wide::zero_row();
      if (row < e) {
        const Row dg = wide::mask_row(wide::ld_row(T_s + r * LDW),
                                      wide::ld_row_g<float>(rows(act, 4 * WW, row) + 2 * WW));
        const Row ns = wide::ld_row_g<float>(rows(nrm, 2 * WW, row) + WW);
        v[3] = wide::add_row(v[3], wide::mul_row(dg, ns));
        v[4] = wide::add_row(v[4], dg);
        ds = wide::gn_bwd_row(dg, ns, st_s[2 * r + 1], gchw);
        wide::st_row_g<float>(dcg + row * WW, ds);
        wide::st_row_g<float>(dqg + row * WW, ds);
      }
      wide::st_row(T_s + r * LDW, ds);
    }
    product(k1, true);  // d_s @ K1ᵀ
    for (int r = warp; r < EB; r += NT / 32) {  // d_gn_z, GN_do's backward → d_z
      const long row = row0 + r;
      Row dz = wide::zero_row();
      if (row < e) {
        const Row dg = wide::mask_row(wide::ld_row(T_s + r * LDW),
                                      wide::ld_row_g<float>(rows(act, 4 * WW, row) + WW));
        const Row nz = wide::ld_row_g<float>(rows(nrm, 2 * WW, row));
        v[1] = wide::add_row(v[1], wide::mul_row(dg, nz));
        v[2] = wide::add_row(v[2], dg);
        dz = wide::gn_bwd_row(dg, nz, st_s[2 * r], gdow);
        wide::st_row_g<float>(rows(act, 4 * WW, row) + 3 * WW, dz);
      }
      wide::st_row(T_s + r * LDW, dz);
    }
    product(kdo, true);  // d_z @ Wdoᵀ
    for (int r = warp; r < EB; r += NT / 32) {  // d_t1p: dbd, dWd's rows, dd
      const long row = row0 + r;
      if (row >= e) break;
      const Row d1 = wide::mask_row(wide::ld_row(T_s + r * LDW),
                                    wide::ld_row_g<float>(rows(act, 4 * WW, row)));
      v[0] = wide::add_row(v[0], d1);
      v[5] = wide::add_row(v[5], wide::scale_row(d1, d[row * 2]));
      v[6] = wide::add_row(v[6], wide::scale_row(d1, d[row * 2 + 1]));
      const float s0 = warp_sum(wide::row_sum(wide::mul_row(d1, wide::vec_row(kd))));
      const float s1 = warp_sum(wide::row_sum(wide::mul_row(d1, wide::vec_row(kd + WW))));
      if (lane == 0) {
        dd[row * 2] = s0;
        dd[row * 2 + 1] = s1;
      }
    }
  }
  wide::reduce_rows<EB_NV>(v, T_s, part_v + (long)blockIdx.x * EB_NV * WW);
}

// dW's operands (wide_bwd.cuh launch_dw): 0: dWdo = t1ᵀ rnd(d_z), 1: dK1 =
// t2ᵀ rnd(d_s) (dcg), 2: dWout = e1ᵀ rnd(g).
template <typename T>
struct EdgeSrc {
  const T* act;
  const T* dcg;
  const T* g;
  const T* any;
  __device__ const T* a(int m, long u) const { return act + u * 4 * wide::WW + m * wide::WW; }
  __device__ const T* b(int m, long u) const {
    return m == 0 ? act + u * 4 * wide::WW + 3 * wide::WW : (m == 1 ? dcg : g) + u * wide::WW;
  }
};

// The workspaces at W = 256: act (bytes) = e·4·256 in T, then the fp32
// normalised rows e·2·256; part (floats) = blocks·7·256 (the chain pass's
// vector sums), then splits·3·256² (the dW pass's partials).
template <typename T>
int launch_bwd_wide(const float* d, const void* qg, const void* cg, const void* g, const void* kd,
                    const float* bd, const void* kdo, const float* gdow, const float* gdob,
                    const void* k1, const float* gchw, const float* gchb, const void* kout,
                    float* dd, void* dqg, void* dcg, void* act, float* part, float* grads, int e,
                    int blocks, int splits, float eps, cudaStream_t stream) {
  constexpr int WW = wide::WW;
  T* act_t = (T*)act;
  float* nrm = reinterpret_cast<float*>((uint8_t*)act + (long)e * 4 * WW * sizeof(T));
  float* part_w = part + (long)blocks * EB_NV * WW;
  const int ntiles = (e + EB - 1) / EB;
  cudaError_t err;
  int nb;
  if constexpr (std::is_same<T, bf16>::value) {
    nb = min(blocks, (ntiles + EW_WGS - 1) / EW_WGS);
    const int smem = edge_mlp_bwd_wide_tc_smem();
    err = set_smem((const void*)edge_mlp_bwd_wide_tc_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    if (nb > 0)
      edge_mlp_bwd_wide_tc_kernel<<<nb, EW_THREADS, smem, stream>>>(
          d, (const bf16*)qg, (const bf16*)cg, (const bf16*)g, (const bf16*)kd, bd,
          (const bf16*)kdo, gdow, gdob, (const bf16*)k1, gchw, gchb, (const bf16*)kout, dd,
          (bf16*)dqg, (bf16*)dcg, act_t, nrm, part, e, eps);
  } else {
    nb = min(blocks, ntiles);
    const int smem = wide::TILE_BYTES + wide::CHUNK_BYTES + 2 * EB * (int)sizeof(float);
    err = set_smem((const void*)edge_mlp_bwd_wide_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    if (nb > 0)
      edge_mlp_bwd_wide_kernel<<<nb, NT, smem, stream>>>(
          d, (const float*)qg, (const float*)cg, (const float*)g, (const float*)kd, bd,
          (const float*)kdo, gdow, gdob, (const float*)k1, gchw, gchb, (const float*)kout, dd,
          (float*)dqg, (float*)dcg, act_t, nrm, part, e, eps);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int e2 = wide::launch_dw<T>(EdgeSrc<T>{act_t, (const T*)dcg, (const T*)g, (const T*)g}, e,
                                    3, splits, part_w, grads, stream);
  if (e2 != 0) return e2;
  return (int)reduce_partials(part, grads + 3 * WW * WW, nb, EB_NV * WW, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (qg, cg, kd [2, W], kdo, k1, kout (in,
// out), out); d fp32 [e, 2]; bd and the GN vectors fp32 [W]; qg, cg, out
// [e, W]; W = width, 128, 64 or 256. bf16: d, qg, cg and out 16-byte aligned
// (cp.async and 16-byte row stores).
extern "C" int edge_mlp_fwd(const void* d, const void* qg, const void* cg, const void* kd,
                            const void* bd, const void* kdo, const void* gdow, const void* gdob,
                            const void* k1, const void* gchw, const void* gchb, const void* kout,
                            void* out, int e, int width, float eps, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float *dp = (const float*)d, *b = (const float*)bd, *g0 = (const float*)gdow,
              *g1 = (const float*)gdob, *g2 = (const float*)gchw, *g3 = (const float*)gchb;
  return with_width_dtype_256(width, dtype, [&](auto Wc, auto Tc) {
    using T = typename decltype(Tc)::type;
    if constexpr (decltype(Wc)::value == 2 * C)
      return launch_wide<T>(dp, qg, cg, kd, b, kdo, g0, g1, k1, g2, g3, kout, out, e, eps, st);
    else
      return launch<T, decltype(Wc)::value>(dp, qg, cg, kd, b, kdo, g0, g1, k1, g2, g3, kout,
                                             out, e, eps, st);
  });
}

// LanePooling's configuration (has_dist2 = has_query = false). dtype and
// width as edge_mlp_fwd (cg, kd [din, W], k1, kout, out; cg and out [e, W],
// bd and the GN vectors [W]); d fp32 [e, din], din 2 or 4. bf16: d, cg and
// out 16-byte aligned (cp.async and 16-byte row stores).
extern "C" int edge_mlp_pool_fwd(const void* d, const void* cg, const void* kd, const void* bd,
                                 const void* k1, const void* gchw, const void* gchb,
                                 const void* kout, void* out, int e, int width, int din,
                                 float eps, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float *dp = (const float*)d, *b = (const float*)bd, *g2 = (const float*)gchw,
              *g3 = (const float*)gchb;
  return with_width_dtype(width, dtype, [&](auto Wc, auto Tc) {
    using T = typename decltype(Tc)::type;
    constexpr int W = decltype(Wc)::value;
    if (din == 2) return launch_pool<T, 2, W>(dp, cg, kd, b, k1, g2, g3, kout, out, e, eps, st);
    if (din == 4) return launch_pool<T, 4, W>(dp, cg, kd, b, k1, g2, g3, kout, out, e, eps, st);
    return (int)cudaErrorInvalidValue;
  });
}

// Backward. g: the output cotangent [e, W] in the activation dtype (W =
// width, 128, 64 or 256); dd fp32 [e, 2]; dqg/dcg [e, W] in the activation
// dtype; grads: fp32 [3*W*W + 7*W] = dWdo, dK1, dWout (in, out), dbd,
// dgdow, dgdob, dgchw, dgchb, dWd row 0, dWd row 1, the partials' sums in
// block (split) order. part, act: workspaces (see launch_bwd): bf16 part
// fp32 [blocks*7*W + splits*3*W*W] and act bf16 [e, 4*W]; fp32 part
// [blocks, 3*W*W + 7*W], zero on entry, and act null; at 256, both dtypes,
// part as bf16's and act e*4*W elements of the activation dtype then e*2*W
// fp32 (launch_bwd_wide). blocks: the card's SMs; splits: the weight-
// gradient pass's splits. bf16: d, qg, cg, g, dqg and dcg 16-byte aligned.
extern "C" int edge_mlp_bwd(const void* d, const void* qg, const void* cg, const void* g,
                            const void* kd, const void* bd, const void* kdo, const void* gdow,
                            const void* gdob, const void* k1, const void* gchw, const void* gchb,
                            const void* kout, void* dd, void* dqg, void* dcg, void* act,
                            void* part, void* grads, int e, int width, int blocks, int splits,
                            float eps, int dtype, void* stream) {
  if (e < 0 || blocks < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float *dp = (const float*)d, *b = (const float*)bd, *g0 = (const float*)gdow,
              *g1 = (const float*)gdob, *g2 = (const float*)gchw, *g3 = (const float*)gchb;
  float *ddp = (float*)dd, *pt = (float*)part, *gr = (float*)grads;
  return with_width_dtype_256(width, dtype, [&](auto Wc, auto Tc) {
    using T = typename decltype(Tc)::type;
    if constexpr (decltype(Wc)::value == 2 * C)
      return launch_bwd_wide<T>(dp, qg, cg, g, kd, b, kdo, g0, g1, k1, g2, g3, kout, ddp, dqg,
                                dcg, act, pt, gr, e, blocks, splits, eps, st);
    else
      return launch_bwd<T, decltype(Wc)::value>(dp, qg, cg, g, kd, b, kdo, g0, g1, k1, g2, g3,
                                                 kout, ddp, dqg, dcg, act, pt, gr, e, blocks,
                                                 splits, eps, st);
  });
}

// LanePooling's backward. g: the output cotangent [e, W] in the activation
// dtype (W = width, 128 or 64); dd fp32 [e, din], or null to skip it; dcg
// [e, W] in the activation dtype; part: fp32 [blocks, 2*W*W + (3 + din)*W],
// a workspace (see launch_pool_bwd); grads: fp32 [2*W*W + (3 + din)*W] =
// dK1, dWout (in, out), dbd, dgchw, dgchb, then the din rows of dWd, the
// partials' sums in block (split) order. blocks: the card's SMs. bf16: d,
// cg, g and dcg 16-byte aligned.
extern "C" int edge_mlp_pool_bwd(const void* d, const void* cg, const void* g, const void* kd,
                                 const void* bd, const void* k1, const void* gchw,
                                 const void* gchb, const void* kout, void* dd, void* dcg,
                                 void* part, void* grads, int e, int width, int din, int blocks,
                                 float eps, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float *dp = (const float*)d, *b = (const float*)bd, *g2 = (const float*)gchw,
              *g3 = (const float*)gchb;
  float *ddp = (float*)dd, *pt = (float*)part, *gr = (float*)grads;
  return with_width_dtype(width, dtype, [&](auto Wc, auto Tc) {
    using T = typename decltype(Tc)::type;
    constexpr int W = decltype(Wc)::value;
    if (din == 2)
      return launch_pool_bwd<T, 2, W>(dp, cg, g, kd, b, k1, g2, g3, kout, ddp, dcg, pt, gr, e,
                                      blocks, eps, st);
    if (din == 4)
      return launch_pool_bwd<T, 4, W>(dp, cg, g, kd, b, k1, g2, g3, kout, ddp, dcg, pt, gr, e,
                                      blocks, eps, st);
    return (int)cudaErrorInvalidValue;
  });
}
