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
// A fixed number of blocks (one per SM) walks the 64-row tiles; each keeps
// its dW in registers (an 8 x 8 block per thread) and its dGN column sums per
// warp, and writes them once as its partial [C*C + 4*C]; reduce_partials then
// sums the partials in block order. Shared memory: x/h and z/d_z/d_h tiles,
// W and Wᵀ (resident for the whole launch), per-row GN1 statistics.
#pragma once

#include "common.cuh"

namespace lgk {

constexpr int TAIL_PART = C * C + 4 * C;  // dW, dg1w, dg1b, dg2w, dg2b

inline int tail_bwd_smem() {
  return (2 * TM * LDA + 2 * C * C + 2 * TM) * (int)sizeof(float);
}

template <typename T, typename TX>
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
  load_weight<T>(W_s, w);
  load_weight_t<T>(Wt_s, w);

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
          gr < n ? load4<TX>(x + gr * C + c4) : zero4();
    }
    __syncthreads();
    // h = rnd(relu(GN1(x))) in place; rows past n hold 0.
    for (int r = warp; r < TM; r += NT / 32) {
      float4* p = reinterpret_cast<float4*>(X_s + r * LDA + lane * 4);
      const float2 st = gn_stats(*p, eps);
      const float4 h = rnd4<T>(relu4(gn_affine(gn_nrm(*p, st), g1w, g1b)));
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
        const float2 st = gn_stats(*p, eps);
        const float4 nrm = gn_nrm(*p, st);
        const float4 y = gn_affine(nrm, g2w, g2b);
        const float4 rv = load4<T>(res + gr * C + lane * 4);
        const float4 d_y = pos_mask4(load4<T>(g + gr * C + lane * 4), add4(y, rv));
        v2w = add4(v2w, mul4(d_y, nrm));
        v2b = add4(v2b, d_y);
        dz = rnd4<T>(gn_bwd_row(d_y, nrm, st.y, g2w));
        if (dy) store4<T>(dy + gr * C + lane * 4, d_y);
        if (dy32) *reinterpret_cast<float4*>(dy32 + gr * C + lane * 4) = d_y;
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
      const float4 nrm = gn_nrm(load4<TX>(x + gr * C + lane * 4), st);
      const float4 d_h = pos_mask4(*reinterpret_cast<const float4*>(Z_s + r * LDA + lane * 4),
                                   gn_affine(nrm, g1w, g1b));
      v1w = add4(v1w, mul4(d_h, nrm));
      v1b = add4(v1b, d_h);
      const float4 d_x = gn_bwd_row(d_h, nrm, st.y, g1w);
      store4<T>(dx + gr * C + lane * 4, d_x);
      if (dx32) *reinterpret_cast<float4*>(dx32 + gr * C + lane * 4) = d_x;
    }
  }
  float* P = part + (long)blockIdx.x * TAIL_PART;
  store_tn(P, accW, false);
  const float4 vecs[4] = {v1w, v1b, v2w, v2b};
  reduce_warp_vecs<4>(vecs, X_s, P + C * C);
}

// Launches the row pass on `blocks` blocks and sums their partials into
// grads [C*C + 4*C] (part: blocks * TAIL_PART floats of workspace).
template <typename T, typename TX>
int launch_tail_bwd(const TX* x, const T* res, const T* g, const T* w, const float* g1w,
                    const float* g1b, const float* g2w, const float* g2b, T* dx, T* dy,
                    float* dx32, float* dy32, float* part, float* grads, int n, int blocks,
                    float eps, cudaStream_t stream) {
  const int smem = tail_bwd_smem();
  cudaError_t err = set_smem((const void*)tail_bwd_kernel<T, TX>, smem);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (n + TM - 1) / TM;
  if (blocks > ntiles) blocks = ntiles;
  if (blocks > 0) {
    tail_bwd_kernel<T, TX><<<blocks, NT, smem, stream>>>(x, res, g, w, g1w, g1b, g2w, g2b, dx,
                                                         dy, dx32, dy32, part, n, eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)reduce_partials(part, grads, blocks, TAIL_PART, stream);
}

}  // namespace lgk
