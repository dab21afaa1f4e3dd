// The fusion stages' per-edge chain over one 64-row tile, forward and
// backward, on CUDA cores in fp32 arithmetic: the fp32 parity paths of
// win_edge.cu (Att's edges of a window-pair plan) and edge_mlp.cu (a flat
// edge list: Att's, or LanePooling's forward without the dist_out stage;
// LanePooling's backward, with its weight gradients kept on chip, is
// edge_mlp.cu's own). The bf16 passes run the chain on tensor cores
// (edge_tc.cuh). Per row, from t1 (the caller's: rnd(relu(d@Wd + bd)) in
// both):
//
//   t2 = rnd(relu(GN_do(t1 @ Wdo)));  s = t2 @ K1 + (the row's query and
//   context projections);  e1 = rnd(relu(GN_ch(s)));  e2 = e1 @ Wout
//
// and back from the cotangent g of e2:
//
//   d_e1 = g @ Woutᵀ;  dWout += e1ᵀ g
//   d_s  = GN_chᵀ(d_e1 ⊙ [e1 > 0]);  dK1 += t2ᵀ rnd(d_s)
//   d_z  = GN_doᵀ(rnd(d_s) @ K1ᵀ ⊙ [t2 > 0]);  dWdo += t1ᵀ rnd(d_z)
//   d_t1p = rnd(d_z) @ Wdoᵀ ⊙ [t1 > 0];  dbd += Σ d_t1p
//
// rnd rounds to the activation dtype where the TPU kernels round. The
// caller supplies, as functors, what differs between the two layouts: how
// a tile's t1 is made, which projections a row adds to s, its cotangent, and
// what becomes of rnd(d_s) and rnd(d_t1p).
//
// W: the chain's width (default 128; edge_mlp.cu's Att chain also runs at
// 64): the weights are read [W x W] and zero-padded, the GroupNorms take
// their statistics over W columns and give zeros past W (common.cuh), and
// the weight gradients go to P as [W x W].
#pragma once

#include "common.cuh"

namespace lgk {

// The chain's weights (in the activation dtype) and GN affines (fp32).
template <typename T>
struct Chain {
  const T* kdo;
  const float* gdow;
  const float* gdob;
  const T* k1;
  const float* gchw;
  const float* gchb;
  const T* kout;
  float eps;
};

// A_s holds rnd(t1) (written by the caller before a barrier-free return);
// leaves e2 = e1 @ Wout of the tile in mm (mm_64x128 layout). qc(r, s)
// returns s plus row r's projections. Ends without a barrier. DIST2 =
// false drops the dist_out stage (LanePooling's chain: t2 = t1, and kdo,
// gdow, gdob are not read).
template <typename T, bool DIST2 = true, int W = C, typename QC>
__device__ __forceinline__ void chain_fwd(float* A_s, float* W_s, const Chain<T>& w, QC qc,
                                          float mm[4][8]) {
  const float ones[4] = {1.f, 1.f, 1.f, 1.f};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if constexpr (DIST2) {
    load_weight<T, W>(W_s, w.kdo);
    __syncthreads();
    zero_acc(mm);
    mm_64x128(A_s, 0, ones, W_s, mm);  // z = t1 @ Wdo
    __syncthreads();
    store_acc(A_s, mm);
    __syncthreads();
    gn_relu_rows<T, W>(A_s, TM, w.gdow, w.gdob, w.eps);  // t2
  }
  load_weight<T, W>(W_s, w.k1);
  __syncthreads();
  zero_acc(mm);
  mm_64x128(A_s, 0, ones, W_s, mm);  // t2 @ K1
  __syncthreads();
  store_acc(A_s, mm);
  __syncthreads();
  for (int r = warp; r < TM; r += NT / 32) {  // e1 = rnd(relu(GN(s)))
    float* p = A_s + r * LDA + lane * 4;
    const float4 s = qc(r, *reinterpret_cast<float4*>(p));
    *reinterpret_cast<float4*>(p) = rnd4<T>(relu4(gn_row<W>(s, w.gchw, w.gchb, w.eps)));
  }
  load_weight<T, W>(W_s, w.kout);
  __syncthreads();
  zero_acc(mm);
  mm_64x128(A_s, 0, ones, W_s, mm);  // e2 = e1 @ Wout
}

// The tile's recompute and backward, with four fp32 [64][LDA] tiles, W_s
// [C][C] and st_s [64][2] of shared memory. t1(tile) writes the tile's
// rnd(t1) into a tile (called twice); qc(r, s) as in chain_fwd; g(r) is row
// r's cotangent; valid(r) whether row r is an edge. The products are added
// into P = dWdo | dK1 | dWout ([W*W] each, (in, out)), and the column sums
// into v = dbd, dgdow, dgdob, dgchw, dgchb (per warp). on_ds(r, rnd(d_s)) and
// on_dt1(r, rnd(d_t1p)) see each valid row; after_ds() runs after a barrier
// with C_s = rnd(d_s) (0 on invalid rows), after_dt1() after a barrier with
// A_s = rnd(d_t1p). Starts and ends with a barrier.
template <typename T, int W = C, typename T1, typename QC, typename G, typename V, typename DS,
          typename ADS, typename DT1, typename ADT1>
__device__ __forceinline__ void chain_bwd(float* A_s, float* B_s, float* C_s, float* D_s,
                                          float* W_s, float* st_s, float* P, float4 (&v)[5],
                                          const Chain<T>& w, T1 t1, QC qc, G g, V valid,
                                          DS on_ds, ADS after_ds, DT1 on_dt1, ADT1 after_dt1) {
  const float ones[4] = {1.f, 1.f, 1.f, 1.f};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float mm[4][8];
  float tw[8][8];
  __syncthreads();  // the tiles are free
  // --- forward recompute ---
  t1(A_s);  // A = t1
  load_weight<T, W>(W_s, w.kdo);
  __syncthreads();
  zero_acc(mm);
  mm_64x128(A_s, 0, ones, W_s, mm);  // z = t1 @ Wdo
  store_acc(B_s, mm);
  __syncthreads();
  for (int r = warp; r < TM; r += NT / 32) {  // B = nrm_z, C = t2
    float4* pb = reinterpret_cast<float4*>(B_s + r * LDA + lane * 4);
    const float2 st = gn_stats<W>(*pb, w.eps);
    const float4 nrm = gn_nrm(*pb, st);
    *pb = nrm;
    *reinterpret_cast<float4*>(C_s + r * LDA + lane * 4) =
        rnd4<T>(relu4(gn_affine<W>(nrm, w.gdow, w.gdob)));
    if (lane == 0) st_s[2 * r] = st.y;
  }
  load_weight<T, W>(W_s, w.k1);
  __syncthreads();
  zero_acc(mm);
  mm_64x128(C_s, 0, ones, W_s, mm);  // t2 @ K1
  store_acc(A_s, mm);                 // t1 is recomputed at the end
  __syncthreads();
  for (int r = warp; r < TM; r += NT / 32) {  // A = nrm_s, D = e1, C = g
    float4* pa = reinterpret_cast<float4*>(A_s + r * LDA + lane * 4);
    const float4 sv = qc(r, *pa);
    const float2 st = gn_stats<W>(sv, w.eps);
    const float4 nrm = gn_nrm(sv, st);
    *pa = nrm;
    *reinterpret_cast<float4*>(D_s + r * LDA + lane * 4) =
        rnd4<T>(relu4(gn_affine<W>(nrm, w.gchw, w.gchb)));
    *reinterpret_cast<float4*>(C_s + r * LDA + lane * 4) = g(r);
    if (lane == 0) st_s[2 * r + 1] = st.y;
  }
  load_weight_t<T, W>(W_s, w.kout);
  __syncthreads();
  // --- backward ---
  zero_acc(mm);
  mm_64x128(C_s, 0, ones, W_s, mm);  // d_e1 = g @ Woutᵀ
  zero_tn(tw);
  mm_tn(D_s, C_s, TM, tw);           // dWout += e1ᵀ g
  store_tn<W>(P + 2 * W * W, tw, true);
  __syncthreads();
  store_acc(D_s, mm);
  __syncthreads();
  for (int r = warp; r < TM; r += NT / 32) {  // C = rnd(d_s), D = t2
    const float4 nrm = *reinterpret_cast<const float4*>(A_s + r * LDA + lane * 4);
    float4* pd = reinterpret_cast<float4*>(D_s + r * LDA + lane * 4);
    const float4 e1 = rnd4<T>(relu4(gn_affine<W>(nrm, w.gchw, w.gchb)));
    const float4 dgn = pos_mask4(*pd, e1);
    float4 ds = zero4();
    if (valid(r)) {
      v[3] = add4(v[3], mul4(dgn, nrm));
      v[4] = add4(v[4], dgn);
      ds = rnd4<T>(gn_bwd_row<W>(dgn, nrm, st_s[2 * r + 1], w.gchw));
      on_ds(r, ds);
    }
    *reinterpret_cast<float4*>(C_s + r * LDA + lane * 4) = ds;
    const float4 nz = *reinterpret_cast<const float4*>(B_s + r * LDA + lane * 4);
    *pd = rnd4<T>(relu4(gn_affine<W>(nz, w.gdow, w.gdob)));
  }
  load_weight_t<T, W>(W_s, w.k1);
  __syncthreads();
  after_ds();
  zero_acc(mm);
  mm_64x128(C_s, 0, ones, W_s, mm);  // d_t2 = rnd(d_s) @ K1ᵀ
  zero_tn(tw);
  mm_tn(D_s, C_s, TM, tw);           // dK1 += t2ᵀ rnd(d_s)
  store_tn<W>(P + W * W, tw, true);
  __syncthreads();
  store_acc(A_s, mm);
  __syncthreads();
  for (int r = warp; r < TM; r += NT / 32) {  // C = rnd(d_z)
    const float4 t2 = *reinterpret_cast<const float4*>(D_s + r * LDA + lane * 4);
    const float4 nz = *reinterpret_cast<const float4*>(B_s + r * LDA + lane * 4);
    const float4 dgn = pos_mask4(*reinterpret_cast<const float4*>(A_s + r * LDA + lane * 4), t2);
    float4 dz = zero4();
    if (valid(r)) {
      v[1] = add4(v[1], mul4(dgn, nz));
      v[2] = add4(v[2], dgn);
      dz = rnd4<T>(gn_bwd_row<W>(dgn, nz, st_s[2 * r], w.gdow));
    }
    *reinterpret_cast<float4*>(C_s + r * LDA + lane * 4) = dz;
  }
  __syncthreads();
  t1(D_s);  // D = t1
  load_weight_t<T, W>(W_s, w.kdo);
  __syncthreads();
  zero_acc(mm);
  mm_64x128(C_s, 0, ones, W_s, mm);  // d_t1 = rnd(d_z) @ Wdoᵀ
  zero_tn(tw);
  mm_tn(D_s, C_s, TM, tw);           // dWdo += t1ᵀ rnd(d_z)
  store_tn<W>(P, tw, true);
  __syncthreads();
  store_acc(A_s, mm);
  __syncthreads();
  for (int r = warp; r < TM; r += NT / 32) {  // A = rnd(d_t1p)
    float4* pa = reinterpret_cast<float4*>(A_s + r * LDA + lane * 4);
    const float4 t1v = *reinterpret_cast<const float4*>(D_s + r * LDA + lane * 4);
    float4 d1 = zero4();
    if (valid(r)) {
      const float4 d_t1p = pos_mask4(*pa, t1v);
      v[0] = add4(v[0], d_t1p);
      d1 = rnd4<T>(d_t1p);
      on_dt1(r, d1);
    }
    *pa = d1;
  }
  __syncthreads();
  after_dt1();
}

}  // namespace lgk
