// Backward of the residual row tail both fused layers end in,
//
//   h = relu(GN1(x));  z = h @ W;  out = relu(GN2(z) + res)     (single-group GNs)
//
// used by row_tail_bwd (x = the Att aggregate, T) and by lane_layer_bwd's
// row pass (x = the forward's saved fp32 temp, res = feat). Per row it
// recomputes GN1, h and z, then
//
//   d_y = g ⊙ [y + res > 0]                       (the cotangent of res)
//   d_z = GN2ᵀ(d_y);   dW += hᵀ·rnd(d_z);   d_h = rnd(d_z) @ Wᵀ ⊙ [h_pre > 0]
//   d_x = GN1ᵀ(d_h)
//
// with dGN2 = (Σ d_y·nrm2, Σ d_y) and dGN1 = (Σ d_h·nrm1, Σ d_h). h and d_z
// are rounded to T before the products, as the Pallas backward rounds them.
//
// What bounds it: bytes on the card's matrix units (x, res and g read, dx
// and d_y written, ~590 MB at 208,896 fp32-temp rows, against three
// [N x 128] x [128 x 128] products, ~20 GFLOP), once the products run on
// tensor cores; on CUDA cores in fp32 the products bound it instead.
//
// A fixed number of blocks (one per SM) walks the row tiles; each keeps
// its dW in registers and its dGN column sums per warp, and writes them
// once as its partial [C*C + 4*C]; reduce_partials then sums the partials
// in block order, so a rerun is bitwise equal. Two instantiations:
//   fp32 (tail_bwd_kernel, T = float): 64-row tiles, the products on CUDA
//     cores (mm_64x128, mm_tn; dW an 8 x 8 block per thread), x/h and
//     z/d_z/d_h tiles, W and Wᵀ resident in fp32. It serves the parity
//     checks, which hold the card to the CPU in full fp32: wgmma has no
//     fp32 operands.
//   bf16 (tail_bwd_tc_kernel, T = bf16, the path that trains): 128-row
//     tiles, the three products on wgmma (common.cuh `tc`); below.
// Both take the row width W (template, default 128): row_tail_bwd also runs
// them on 64-wide rows (Att's tail at n_agt = 64), zero-padded in the tiles
// as common.cuh sets out; the partial is then [W*W + 4*W].
#pragma once

#include <type_traits>

#include "common.cuh"

namespace lgk {

// A block's partial at width W: dW, dg1w, dg1b, dg2w, dg2b.
template <int W = C>
__host__ __device__ constexpr int tail_part() { return W * W + 4 * W; }

inline int tail_bwd_smem() {
  return (2 * TM * LDA + 2 * C * C + 2 * TM) * (int)sizeof(float);
}

template <typename T, typename TX, int W>
__global__ void __launch_bounds__(NT)
tail_bwd_kernel(const TX* __restrict__ x, const T* __restrict__ res, const T* __restrict__ g,
                const T* __restrict__ w, const float* __restrict__ g1w,
                const float* __restrict__ g1b, const float* __restrict__ g2w,
                const float* __restrict__ g2b, T* __restrict__ dx, T* __restrict__ dy,
                float* __restrict__ dx32, float* __restrict__ dy32, float* __restrict__ part,
                int n, float eps) {
  extern __shared__ float4 smem4[];
  float* X_s = reinterpret_cast<float*>(smem4);  // [TM][LDA] x, then h
  float* Z_s = X_s + TM * LDA;                   // [TM][LDA] z, then rnd(d_z), then d_h
  float* W_s = Z_s + TM * LDA;                   // [C][C] W
  float* Wt_s = W_s + C * C;                     // [C][C] Wᵀ
  float* st_s = Wt_s + C * C;                    // [TM][2] GN1 mean, inv

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool in_w = lane_in<W>();  // the lane's columns lie in the row
  load_weight<T, W>(W_s, w);
  load_weight_t<T, W>(Wt_s, w);

  float accW[8][8];
  zero_tn(accW);
  float4 v1w = zero4(), v1b = zero4(), v2w = zero4(), v2b = zero4();
  const float ones[4] = {1.f, 1.f, 1.f, 1.f};
  const int ntiles = (n + TM - 1) / TM;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long row0 = (long)tile * TM;
    __syncthreads();  // the previous tile is done with X_s / Z_s; weights loaded
    for (int idx = threadIdx.x; idx < TM * (C / 4); idx += NT) {
      const int r = idx / (C / 4), c4 = (idx % (C / 4)) * 4;
      const long gr = row0 + r;
      *reinterpret_cast<float4*>(X_s + r * LDA + c4) =
          gr < n && (W == C || c4 < W) ? load4<TX>(x + gr * W + c4) : zero4();
    }
    __syncthreads();
    // h = rnd(relu(GN1(x))) in place; rows past n hold 0.
    for (int r = warp; r < TM; r += NT / 32) {
      float4* p = reinterpret_cast<float4*>(X_s + r * LDA + lane * 4);
      const float2 st = gn_stats<W>(*p, eps);
      const float4 h = rnd4<T>(relu4(gn_affine<W>(gn_nrm(*p, st), g1w, g1b)));
      *p = (row0 + r < n) ? h : zero4();
      if (lane == 0) {
        st_s[2 * r] = st.x;
        st_s[2 * r + 1] = st.y;
      }
    }
    __syncthreads();
    float acc[4][8];
    zero_acc(acc);
    mm_64x128(X_s, 0, ones, W_s, acc);  // z = h @ W
    store_acc(Z_s, acc);
    __syncthreads();
    // d_y, GN2 backward → rnd(d_z) in place of z.
    for (int r = warp; r < TM; r += NT / 32) {
      float4* p = reinterpret_cast<float4*>(Z_s + r * LDA + lane * 4);
      const long gr = row0 + r;
      float4 dz = zero4();
      if (gr < n) {
        const float2 st = gn_stats<W>(*p, eps);
        const float4 nrm = gn_nrm(*p, st);
        const float4 y = gn_affine<W>(nrm, g2w, g2b);
        const float4 rv = in_w ? load4<T>(res + gr * W + lane * 4) : zero4();
        const float4 d_y =
            pos_mask4(in_w ? load4<T>(g + gr * W + lane * 4) : zero4(), add4(y, rv));
        v2w = add4(v2w, mul4(d_y, nrm));
        v2b = add4(v2b, d_y);
        dz = rnd4<T>(gn_bwd_row<W>(d_y, nrm, st.y, g2w));
        if (dy && in_w) store4<T>(dy + gr * W + lane * 4, d_y);
        if (dy32 && in_w) *reinterpret_cast<float4*>(dy32 + gr * W + lane * 4) = d_y;
      }
      *p = dz;
    }
    __syncthreads();
    zero_acc(acc);
    mm_64x128(Z_s, 0, ones, Wt_s, acc);  // rnd(d_z) @ Wᵀ
    mm_tn(X_s, Z_s, TM, accW);           // dW += hᵀ rnd(d_z)
    __syncthreads();
    store_acc(Z_s, acc);
    __syncthreads();
    // d_h = (rnd(d_z) @ Wᵀ) ⊙ [h_pre > 0], GN1 backward → d_x.
    for (int r = warp; r < TM; r += NT / 32) {
      const long gr = row0 + r;
      if (gr >= n) break;
      const float2 st = make_float2(st_s[2 * r], st_s[2 * r + 1]);
      const float4 nrm = gn_nrm(in_w ? load4<TX>(x + gr * W + lane * 4) : zero4(), st);
      const float4 d_h = pos_mask4(*reinterpret_cast<const float4*>(Z_s + r * LDA + lane * 4),
                                   gn_affine<W>(nrm, g1w, g1b));
      v1w = add4(v1w, mul4(d_h, nrm));
      v1b = add4(v1b, d_h);
      const float4 d_x = gn_bwd_row<W>(d_h, nrm, st.y, g1w);
      if (!in_w) continue;
      store4<T>(dx + gr * W + lane * 4, d_x);
      if (dx32) *reinterpret_cast<float4*>(dx32 + gr * W + lane * 4) = d_x;
    }
  }
  float* P = part + (long)blockIdx.x * tail_part<W>();
  store_tn<W>(P, accW, false);
  const float4 vecs[4] = {v1w, v1b, v2w, v2b};
  reduce_warp_vecs<4, W>(vecs, X_s, P + W * W);
}

// The bf16 row pass on tensor cores. The same arithmetic per row, on
// 128-row tiles: h and rnd(d_z) are stored in bf16 (the values the CUDA-core
// path rounds them to), and the three products run as wgmma, warpgroup g
// owning rows 64g .. 64g+63 of z and of rnd(d_z) @ Wᵀ and input channels
// 64g .. 64g+63 of dW (its 64 accumulators per thread live across the
// block's tiles). One bf16 copy of W in core tiles serves both z = h @ W
// (W MN-major) and rnd(d_z) @ Wᵀ (W K-major). z and d_h come back through
// an fp32 row tile for the per-row GroupNorm work, which stays a warp per
// row as above.
constexpr int TC_ROWS = 128;
constexpr int ROW_AHEAD = 4;  // rows a warp loads before it works on the first

inline int tail_bwd_tc_smem() {
  return 3 * tc::tiles_bytes(TC_ROWS) + (TC_ROWS * LDA + 2 * TC_ROWS) * (int)sizeof(float);
}

template <typename TX, int W>
__global__ void __launch_bounds__(NT, 1)
tail_bwd_tc_kernel(const TX* __restrict__ x, const bf16* __restrict__ res,
                   const bf16* __restrict__ g, const bf16* __restrict__ w,
                   const float* __restrict__ g1w, const float* __restrict__ g1b,
                   const float* __restrict__ g2w, const float* __restrict__ g2b,
                   bf16* __restrict__ dx, bf16* __restrict__ dy, float* __restrict__ dx32,
                   float* __restrict__ dy32, float* __restrict__ part, int n, float eps) {
  extern __shared__ float4 smem4[];
  uint8_t* W_b = reinterpret_cast<uint8_t*>(smem4);   // W, core tiles
  uint8_t* H_b = W_b + tc::tiles_bytes(TC_ROWS);      // h tile
  uint8_t* Z_b = H_b + tc::tiles_bytes(TC_ROWS);      // rnd(d_z) tile
  float* R_s = reinterpret_cast<float*>(Z_b + tc::tiles_bytes(TC_ROWS));  // [TC_ROWS][LDA]
  float* st_s = R_s + TC_ROWS * LDA;                  // [TC_ROWS][2] GN1 mean, inv
  const tc::Tiles Wt = tc::tiles(W_b, C), Ht = tc::tiles(H_b, TC_ROWS),
                  Zt = tc::tiles(Z_b, TC_ROWS);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wg = threadIdx.x >> 7;
  const bool in_w = lane_in<W>();  // the lane's columns lie in the row
  tc::load_tiles_128<W>(W_b, Wt, w);

  float accW[64], acc[64];
  tc::zero(accW);
  float4 v1w = zero4(), v1b = zero4(), v2w = zero4(), v2b = zero4();
  const int ntiles = (n + TC_ROWS - 1) / TC_ROWS;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long row0 = (long)tile * TC_ROWS;
    __syncthreads();  // the previous tile is done with H/Z/R
    // h = rnd(relu(GN1(x))) into H; rows past n hold 0. A warp's rows go
    // ROW_AHEAD at a time, their loads issued before the first is used.
    for (int r0 = warp; r0 < TC_ROWS; r0 += ROW_AHEAD * (NT / 32)) {
      float4 xv[ROW_AHEAD];
#pragma unroll
      for (int k = 0; k < ROW_AHEAD; ++k) {
        const long gr = row0 + r0 + k * (NT / 32);
        xv[k] = gr < n && in_w ? load4<TX>(x + gr * W + lane * 4) : zero4();
      }
#pragma unroll
      for (int k = 0; k < ROW_AHEAD; ++k) {
        const int r = r0 + k * (NT / 32);
        const float2 st = gn_stats<W>(xv[k], eps);
        const float4 h = relu4(gn_affine<W>(gn_nrm(xv[k], st), g1w, g1b));
        tc::st_bf4(H_b, tc::tile_off(Ht, r, lane * 4), row0 + r < n ? h : zero4());
        if (lane == 0) {
          st_s[2 * r] = st.x;
          st_s[2 * r + 1] = st.y;
        }
      }
    }
    tc::fence_smem();
    __syncthreads();
    tc::zero(acc);
    tc::fence_acc(acc);
    tc::fence();
    tc::mm<W / 16, true, false>(acc, Ht, 64 * wg, Wt);  // z = h @ W
    tc::commit();
    tc::wait_all();
    tc::fence_acc(acc);
#pragma unroll
    for (int i = 0; i < 64; i += 2)
      *reinterpret_cast<float2*>(R_s + (64 * wg + tc::acc_row(i)) * LDA + tc::acc_col(i)) =
          make_float2(acc[i], acc[i + 1]);
    __syncthreads();
    // d_y, GN2 backward → rnd(d_z) into Z.
    for (int r0 = warp; r0 < TC_ROWS; r0 += ROW_AHEAD * (NT / 32)) {
      float4 rv[ROW_AHEAD], gv[ROW_AHEAD];
#pragma unroll
      for (int k = 0; k < ROW_AHEAD; ++k) {
        const long gr = row0 + r0 + k * (NT / 32);
        rv[k] = gr < n && in_w ? load4<bf16>(res + gr * W + lane * 4) : zero4();
        gv[k] = gr < n && in_w ? load4<bf16>(g + gr * W + lane * 4) : zero4();
      }
#pragma unroll
      for (int k = 0; k < ROW_AHEAD; ++k) {
        const int r = r0 + k * (NT / 32);
        const long gr = row0 + r;
        float4 dz = zero4();
        if (gr < n) {
          const float4 zv = *reinterpret_cast<const float4*>(R_s + r * LDA + lane * 4);
          const float2 st = gn_stats<W>(zv, eps);
          const float4 nrm = gn_nrm(zv, st);
          const float4 y = gn_affine<W>(nrm, g2w, g2b);
          const float4 d_y = pos_mask4(gv[k], add4(y, rv[k]));
          v2w = add4(v2w, mul4(d_y, nrm));
          v2b = add4(v2b, d_y);
          dz = gn_bwd_row<W>(d_y, nrm, st.y, g2w);
          if (dy && in_w) store4<bf16>(dy + gr * W + lane * 4, d_y);
          if (dy32 && in_w) *reinterpret_cast<float4*>(dy32 + gr * W + lane * 4) = d_y;
        }
        tc::st_bf4(Z_b, tc::tile_off(Zt, r, lane * 4), dz);
      }
    }
    tc::fence_smem();
    __syncthreads();
    tc::zero(acc);
    tc::fence_acc(acc);
    tc::fence_acc(accW);
    tc::fence();
    tc::mm<W / 16, true, true>(acc, Zt, 64 * wg, Wt);                 // rnd(d_z) @ Wᵀ
    tc::mm<TC_ROWS / 16, false, false>(accW, Ht, 64 * wg, Zt);        // dW += hᵀ rnd(d_z)
    tc::commit();
    tc::wait_all();
    tc::fence_acc(acc);
    tc::fence_acc(accW);
#pragma unroll
    for (int i = 0; i < 64; i += 2)
      *reinterpret_cast<float2*>(R_s + (64 * wg + tc::acc_row(i)) * LDA + tc::acc_col(i)) =
          make_float2(acc[i], acc[i + 1]);
    __syncthreads();
    // d_h = (rnd(d_z) @ Wᵀ) ⊙ [h_pre > 0], GN1 backward → d_x.
    for (int r0 = warp; r0 < TC_ROWS; r0 += ROW_AHEAD * (NT / 32)) {
      float4 xv[ROW_AHEAD];
#pragma unroll
      for (int k = 0; k < ROW_AHEAD; ++k) {
        const long gr = row0 + r0 + k * (NT / 32);
        xv[k] = gr < n && in_w ? load4<TX>(x + gr * W + lane * 4) : zero4();
      }
#pragma unroll
      for (int k = 0; k < ROW_AHEAD; ++k) {
        const int r = r0 + k * (NT / 32);
        const long gr = row0 + r;
        if (gr < n) {
          const float2 st = make_float2(st_s[2 * r], st_s[2 * r + 1]);
          const float4 nrm = gn_nrm(xv[k], st);
          const float4 d_h =
              pos_mask4(*reinterpret_cast<const float4*>(R_s + r * LDA + lane * 4),
                        gn_affine<W>(nrm, g1w, g1b));
          v1w = add4(v1w, mul4(d_h, nrm));
          v1b = add4(v1b, d_h);
          const float4 d_x = gn_bwd_row<W>(d_h, nrm, st.y, g1w);
          if (in_w) store4<bf16>(dx + gr * W + lane * 4, d_x);
          if (dx32 && in_w) *reinterpret_cast<float4*>(dx32 + gr * W + lane * 4) = d_x;
        }
      }
    }
  }
  float* P = part + (long)blockIdx.x * tail_part<W>();
  if (W == C || 64 * wg < W) {  // at W = 64 the second warpgroup's input channels are padding
#pragma unroll
    for (int i = 0; i < W / 2; i += 2)
      *reinterpret_cast<float2*>(P + (64 * wg + tc::acc_row(i)) * W + tc::acc_col(i)) =
          make_float2(accW[i], accW[i + 1]);
  }
  const float4 vecs[4] = {v1w, v1b, v2w, v2b};
  reduce_warp_vecs<4, W>(vecs, R_s, P + W * W);
}

// Launches the row pass on `blocks` blocks and sums their partials into
// grads [W*W + 4*W] (part: blocks * tail_part<W>() floats of workspace).
template <typename T, typename TX, int W = C>
int launch_tail_bwd(const TX* x, const T* res, const T* g, const T* w, const float* g1w,
                    const float* g1b, const float* g2w, const float* g2b, T* dx, T* dy,
                    float* dx32, float* dy32, float* part, float* grads, int n, int blocks,
                    float eps, cudaStream_t stream) {
  constexpr bool TC = std::is_same<T, bf16>::value;
  const void* kernel;
  int smem, rows;
  if constexpr (TC) {
    kernel = (const void*)tail_bwd_tc_kernel<TX, W>;
    smem = tail_bwd_tc_smem();
    rows = TC_ROWS;
  } else {
    kernel = (const void*)tail_bwd_kernel<T, TX, W>;
    smem = tail_bwd_smem();
    rows = TM;
  }
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (n + rows - 1) / rows;
  if (blocks > ntiles) blocks = ntiles;
  if (blocks > 0) {
    if constexpr (TC)
      tail_bwd_tc_kernel<TX, W><<<blocks, NT, smem, stream>>>(
          x, res, g, w, g1w, g1b, g2w, g2b, dx, dy, dx32, dy32, part, n, eps);
    else
      tail_bwd_kernel<T, TX, W><<<blocks, NT, smem, stream>>>(
          x, res, g, w, g1w, g1b, g2w, g2b, dx, dy, dx32, dy32, part, n, eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)reduce_partials(part, grads, blocks, tail_part<W>(), stream);
}

}  // namespace lgk
