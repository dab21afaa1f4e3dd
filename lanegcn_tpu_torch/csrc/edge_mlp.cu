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
// edge_mlp_fwd: a block per 64-row tile keeps the tile's chain in shared
// memory (one fp32 [64 x 128] tile, one [128 x 128] weight reloaded per
// stage): only d, qg, cg are read and only out is written.
//
// edge_mlp_bwd: recomputes the chain per tile, as the TPU kernel does, and
// runs it backwards (edge_chain.cuh), with dqg = dcg = rnd(d_s), dWd +=
// rnd(d)ᵀ rnd(d_t1p) and dd = rnd(d_t1p) @ Wdᵀ per row. One block per SM
// walks the tiles (tile = block, block + blocks, ...); it adds its products
// into its own slice of a [blocks, 3*C*C + 7*C] workspace (zeroed by the
// wrapper; a read-modify-write per tile by the block that owns the slice)
// and keeps its vector sums per warp in registers; reduce_partials sums the
// slices in block order. No float atomics; reruns are bitwise equal.
//
// What bounds it: three (forward) or nine (backward) [E x 128] x [128 x 128]
// products per row against ~3 (forward) or ~7 (backward) [E x 128] rows of
// traffic: at the card's bf16 rates the rows' bytes bound it. This first
// version runs the products on CUDA cores in fp32, which makes the products
// the larger cost; about 93 % of the rows are padding at the CLI geometry's
// capacities, and the kernel runs them all, as the TPU kernel did.
//
// edge_mlp_pool_fwd (LaneRCNN's three LanePooling stages): per row,
//
//   t1 = rnd(relu(rnd(d[e]) @ rnd(Wd) + bd)),  s = t1 @ K1 + cg[e],
//   out[e] = rnd(rnd(relu(GN_ch(s))) @ Wout)
//
// with d [E, 4] fp32 (relative pose, context minus target) and cg the
// gathered context projection. The same tile and block as edge_mlp_fwd,
// two [128 x 128] products per row instead of three. What bounds it: d and
// cg read and out written (0.55 GB at E = 1,048,576 in bf16, ~0.16 ms)
// against 2 x 2 x 128 x 128 flops per row: memory-bound at the card's bf16
// matrix rate, product-bound on the CUDA cores used here. About 11 % of the
// rows at the 256-scenario pack are padding; each gives one constant row
// that the caller's scatter drops.
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
// Unlike edge_mlp_bwd's workspace slices, nothing per tile goes to device
// memory but dcg (and dd): one block per SM walks the tiles (16,384 at E =
// 1,048,576) with dK1 and dWout in registers (an 8 x 8 block of each per
// thread) and the vector sums (dbd, dgchw, dgchb, the DIN rows of dWd) per
// warp in shared memory, and writes one partial per block at the end;
// reduce_partials sums the partials in block order (no float atomics,
// bitwise reruns). Shared memory: four fp32 tiles (t1, nrm_s then d_t1,
// e1, g then d_e1 then d_s), one 64 KB weight slot (K1, Woutᵀ, K1ᵀ in turn)
// and the vector sums: 224 KB, one block per SM. What bounds it: d, cg and
// g read and dcg written once (0.82 GB at E = 1,048,576 in bf16, ~0.25 ms)
// against three [128 x 128] products per row (the forward's K1 recomputed,
// two transposed) and two weight gradients: memory-bound at the card's
// bf16 matrix rate, product-bound on the CUDA cores used here.
#include "edge_chain.cuh"

using namespace lgk;

namespace {

constexpr int EB = TM;                       // rows per tile
constexpr int EM_PART = 3 * C * C + 7 * C;  // dWdo, dK1, dWout, dbd, dgdow, dgdob, dgchw, dgchb, dWd

// A_s[r] = rnd(relu(rnd(d[row]) @ rnd(Wd) + bd)) for the tile's rows; 0 past
// e. d is [e, DIN]; the DIN products are summed in order with fmaf.
template <typename T, int DIN>
__device__ __forceinline__ void tile_t1(float* A_s, const float* d, const T* kd, const float* bd,
                                        long row0, int e) {
  for (int i = threadIdx.x; i < EB * (C / 4); i += NT) {
    const int r = i / (C / 4), c4 = (i % (C / 4)) * 4;
    const long row = row0 + r;
    float4 t = zero4();
    if (row < e) {
      const float d0 = rnd<T>(d[row * DIN]);
      const float4 k0 = load4<T>(kd + c4);
      t = make_float4(d0 * k0.x, d0 * k0.y, d0 * k0.z, d0 * k0.w);
#pragma unroll
      for (int k = 1; k < DIN; ++k) {
        const float dk = rnd<T>(d[row * DIN + k]);
        const float4 kk = load4<T>(kd + k * C + c4);
        t = make_float4(fmaf(dk, kk.x, t.x), fmaf(dk, kk.y, t.y), fmaf(dk, kk.z, t.z),
                        fmaf(dk, kk.w, t.w));
      }
      const float4 b = *reinterpret_cast<const float4*>(bd + c4);
      t = rnd4<T>(relu4(add4(t, b)));
    }
    *reinterpret_cast<float4*>(A_s + r * LDA + c4) = t;
  }
}

template <typename T>
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

  tile_t1<T, 2>(A_s, d, kd, bd, row0, e);
  chain_fwd<T>(A_s, W_s, Chain<T>{kdo, gdow, gdob, k1, gchw, gchb, kout, eps},
               [&](int r, float4 s) {  // s += cg + qg
                 const long row = row0 + r;
                 if (row < e) {
                   s = add4(s, load4<T>(cg + row * C + lane * 4));
                   s = add4(s, load4<T>(qg + row * C + lane * 4));
                 }
                 return s;
               },
               mm);  // e2 = e1 @ Wout
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long row = row0 + mm_row(i);
    if (row < e) {
      store4<T>(out + row * C + mm_col(0), make_float4(mm[i][0], mm[i][1], mm[i][2], mm[i][3]));
      store4<T>(out + row * C + mm_col(4), make_float4(mm[i][4], mm[i][5], mm[i][6], mm[i][7]));
    }
  }
}

template <typename T>
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

  float* P = part + (long)blockIdx.x * EM_PART;  // this block's own slice (zeroed)
  const Chain<T> w{kdo, gdow, gdob, k1, gchw, gchb, kout, eps};
  const int lane = threadIdx.x & 31;
  const int ntiles = (e + EB - 1) / EB;
  float4 vecs[5] = {zero4(), zero4(), zero4(), zero4(), zero4()};  // dbd, dgdow, dgdob, dgchw, dgchb
  float4 vkd[2] = {zero4(), zero4()};                               // dWd rows
  const float4 k0 = load4<T>(kd + lane * 4), k1v = load4<T>(kd + C + lane * 4);

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long row0 = (long)tile * EB;
    chain_bwd<T>(
        A_s, B_s, C_s, D_s, W_s, st_s, P, vecs, w,
        [&](float* X_s) { tile_t1<T, 2>(X_s, d, kd, bd, row0, e); },
        [&](int r, float4 sv) {  // s += cg + qg
          const long row = row0 + r;
          if (row < e) {
            sv = add4(sv, load4<T>(cg + row * C + lane * 4));
            sv = add4(sv, load4<T>(qg + row * C + lane * 4));
          }
          return sv;
        },
        [&](int r) { return row0 + r < e ? load4<T>(g + (row0 + r) * C + lane * 4) : zero4(); },
        [&](int r) { return row0 + r < e; },
        [&](int r, float4 ds) {  // dqg = dcg = rnd(d_s)
          store4<T>(dqg + (row0 + r) * C + lane * 4, ds);
          store4<T>(dcg + (row0 + r) * C + lane * 4, ds);
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
  reduce_warp_vecs<7>(all, B_s, P + 3 * C * C);
}

// LanePooling's chain (no dist_out stage, no query): t1 from d [e, DIN],
// s = t1 @ K1 + cg[e], out[e] = rnd(e1 @ Wout).
template <typename T, int DIN>
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

  tile_t1<T, DIN>(A_s, d, kd, bd, row0, e);
  chain_fwd<T, false>(A_s, W_s, Chain<T>{nullptr, nullptr, nullptr, k1, gchw, gchb, kout, eps},
                      [&](int r, float4 s) {  // s += cg
                        const long row = row0 + r;
                        if (row < e) s = add4(s, load4<T>(cg + row * C + lane * 4));
                        return s;
                      },
                      mm);  // e2 = e1 @ Wout
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long row = row0 + mm_row(i);
    if (row < e) {
      store4<T>(out + row * C + mm_col(0), make_float4(mm[i][0], mm[i][1], mm[i][2], mm[i][3]));
      store4<T>(out + row * C + mm_col(4), make_float4(mm[i][4], mm[i][5], mm[i][6], mm[i][7]));
    }
  }
}

template <typename T, int DIN>
int launch_pool(const float* d, const void* cg, const void* kd, const float* bd, const void* k1,
                const float* gchw, const float* gchb, const void* kout, void* out, int e,
                float eps, cudaStream_t stream) {
  const int smem = (EB * LDA + C * C) * (int)sizeof(float);
  cudaError_t err = set_smem((const void*)edge_mlp_pool_kernel<T, DIN>, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (e + EB - 1) / EB;
  if (tiles > 0) {
    edge_mlp_pool_kernel<T, DIN><<<tiles, NT, smem, stream>>>(
        d, (const T*)cg, (const T*)kd, bd, (const T*)k1, gchw, gchb, (const T*)kout, (T*)out, e,
        eps);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const float* d, const void* qg, const void* cg, const void* kd, const float* bd,
           const void* kdo, const float* gdow, const float* gdob, const void* k1,
           const float* gchw, const float* gchb, const void* kout, void* out, int e, float eps,
           cudaStream_t stream) {
  const int smem = (EB * LDA + C * C) * (int)sizeof(float);
  cudaError_t err = set_smem((const void*)edge_mlp_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (e + EB - 1) / EB;
  if (tiles > 0) {
    edge_mlp_kernel<T><<<tiles, NT, smem, stream>>>(
        d, (const T*)qg, (const T*)cg, (const T*)kd, bd, (const T*)kdo, gdow, gdob, (const T*)k1,
        gchw, gchb, (const T*)kout, (T*)out, e, eps);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const float* d, const void* qg, const void* cg, const void* g, const void* kd,
               const float* bd, const void* kdo, const float* gdow, const float* gdob,
               const void* k1, const float* gchw, const float* gchb, const void* kout, float* dd,
               void* dqg, void* dcg, float* part, float* grads, int e, int blocks, float eps,
               cudaStream_t stream) {
  const int smem = (4 * EB * LDA + C * C + 2 * EB) * (int)sizeof(float);
  cudaError_t err = set_smem((const void*)edge_mlp_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (e + EB - 1) / EB;
  if (blocks > tiles) blocks = tiles;
  if (blocks > 0) {
    edge_mlp_bwd_kernel<T><<<blocks, NT, smem, stream>>>(
        d, (const T*)qg, (const T*)cg, (const T*)g, (const T*)kd, bd, (const T*)kdo, gdow, gdob,
        (const T*)k1, gchw, gchb, (const T*)kout, dd, (T*)dqg, (T*)dcg, part, e, eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)reduce_partials(part, grads, blocks, EM_PART, stream);
}

// LanePooling's chain backwards (see the header); part holds blocks rows of
// [2*C*C + (3 + DIN)*C]: dK1, dWout (in, out), dbd, dgchw, dgchb, dWd rows.
template <typename T, int DIN>
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
  const float ones[4] = {1.f, 1.f, 1.f, 1.f};
  float accK1[8][8], accOut[8][8];
  zero_tn(accK1);
  zero_tn(accOut);
  zero_warp_vecs<NV>(vec_s);
  const int ntiles = (e + EB - 1) / EB;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long row0 = (long)tile * EB;
    __syncthreads();  // the previous tile is done with the tiles and W_s
    tile_t1<T, DIN>(A_s, d, kd, bd, row0, e);  // A = t1 (0 past e)
    load_weight<T>(W_s, k1);
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
      if (row < e) sv = add4(sv, load4<T>(cg + row * C + lane * 4));
      const float2 st = gn_stats(sv, eps);
      const float4 nrm = gn_nrm(sv, st);
      *reinterpret_cast<float4*>(pb) = nrm;
      *reinterpret_cast<float4*>(C_s + r * LDA + lane * 4) =
          rnd4<T>(relu4(gn_affine(nrm, gchw, gchb)));
      *reinterpret_cast<float4*>(D_s + r * LDA + lane * 4) =
          row < e ? load4<T>(g + row * C + lane * 4) : zero4();
      if (lane == 0) st_s[r] = st.y;
    }
    load_weight_t<T>(W_s, kout);
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
        ds = rnd4<T>(gn_bwd_row(dgn, nrm, st_s[r], gchw));
        store4<T>(dcg + row * C + lane * 4, ds);
      }
      *pd = ds;
    }
    load_weight_t<T>(W_s, k1);
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
          const float4 kk = load4<T>(kd + k * C + lane * 4);
          const float sk = warp_sum(d1.x * kk.x + d1.y * kk.y + d1.z * kk.z + d1.w * kk.w);
          if (lane == 0) dd[row * DIN + k] = sk;
        }
      }
    }
  }
  float* P = part + (long)blockIdx.x * (2 * C * C + NV * C);
  store_tn(P, accK1, false);
  store_tn(P + C * C, accOut, false);
  sum_warp_vecs<NV>(vec_s, P + 2 * C * C);
}

template <typename T, int DIN>
int launch_pool_bwd(const float* d, const void* cg, const void* g, const void* kd,
                    const float* bd, const void* k1, const float* gchw, const float* gchb,
                    const void* kout, float* dd, void* dcg, float* part, float* grads, int e,
                    int blocks, float eps, cudaStream_t stream) {
  const int smem = (4 * EB * LDA + C * C + EB + NT / 32 * (3 + DIN) * C) * (int)sizeof(float);
  cudaError_t err = set_smem((const void*)edge_mlp_pool_bwd_kernel<T, DIN>, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (e + EB - 1) / EB;
  if (blocks > tiles) blocks = tiles;
  if (blocks > 0) {
    edge_mlp_pool_bwd_kernel<T, DIN><<<blocks, NT, smem, stream>>>(
        d, (const T*)cg, (const T*)g, (const T*)kd, bd, (const T*)k1, gchw, gchb,
        (const T*)kout, dd, (T*)dcg, part, e, eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)reduce_partials(part, grads, blocks, 2 * C * C + (3 + DIN) * C, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (qg, cg, kd [2, C], kdo, k1, kout (in,
// out), out); d fp32 [e, 2]; bd and the GN vectors fp32 [128]; out [e, 128].
extern "C" int edge_mlp_fwd(const void* d, const void* qg, const void* cg, const void* kd,
                            const void* bd, const void* kdo, const void* gdow, const void* gdob,
                            const void* k1, const void* gchw, const void* gchb, const void* kout,
                            void* out, int e, float eps, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float *dp = (const float*)d, *b = (const float*)bd, *g0 = (const float*)gdow,
              *g1 = (const float*)gdob, *g2 = (const float*)gchw, *g3 = (const float*)gchb;
  if (dtype == 0)
    return launch<float>(dp, qg, cg, kd, b, kdo, g0, g1, k1, g2, g3, kout, out, e, eps, st);
  if (dtype == 1)
    return launch<bf16>(dp, qg, cg, kd, b, kdo, g0, g1, k1, g2, g3, kout, out, e, eps, st);
  return (int)cudaErrorInvalidValue;
}

// LanePooling's configuration (has_dist2 = has_query = false). dtype as
// edge_mlp_fwd (cg, kd [din, C], k1, kout, out); d fp32 [e, din], din 2 or 4.
extern "C" int edge_mlp_pool_fwd(const void* d, const void* cg, const void* kd, const void* bd,
                                 const void* k1, const void* gchw, const void* gchb,
                                 const void* kout, void* out, int e, int din, float eps,
                                 int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float *dp = (const float*)d, *b = (const float*)bd, *g2 = (const float*)gchw,
              *g3 = (const float*)gchb;
  if (dtype == 0 && din == 2)
    return launch_pool<float, 2>(dp, cg, kd, b, k1, g2, g3, kout, out, e, eps, st);
  if (dtype == 0 && din == 4)
    return launch_pool<float, 4>(dp, cg, kd, b, k1, g2, g3, kout, out, e, eps, st);
  if (dtype == 1 && din == 2)
    return launch_pool<bf16, 2>(dp, cg, kd, b, k1, g2, g3, kout, out, e, eps, st);
  if (dtype == 1 && din == 4)
    return launch_pool<bf16, 4>(dp, cg, kd, b, k1, g2, g3, kout, out, e, eps, st);
  return (int)cudaErrorInvalidValue;
}

// Backward. g: the output cotangent [e, 128] in the activation dtype; dd fp32
// [e, 2]; dqg/dcg [e, 128] in the activation dtype; part: fp32 [blocks,
// 3*C*C + 7*C], zero on entry; grads: fp32 [3*C*C + 7*C] = dWdo, dK1, dWout
// (in, out), dbd, dgdow, dgdob, dgchw, dgchb, dWd row 0, dWd row 1, the
// slices' sum in block order.
extern "C" int edge_mlp_bwd(const void* d, const void* qg, const void* cg, const void* g,
                            const void* kd, const void* bd, const void* kdo, const void* gdow,
                            const void* gdob, const void* k1, const void* gchw, const void* gchb,
                            const void* kout, void* dd, void* dqg, void* dcg, void* part,
                            void* grads, int e, int blocks, float eps, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float *dp = (const float*)d, *b = (const float*)bd, *g0 = (const float*)gdow,
              *g1 = (const float*)gdob, *g2 = (const float*)gchw, *g3 = (const float*)gchb;
  float *ddp = (float*)dd, *pt = (float*)part, *gr = (float*)grads;
  if (dtype == 0)
    return launch_bwd<float>(dp, qg, cg, g, kd, b, kdo, g0, g1, k1, g2, g3, kout, ddp, dqg, dcg,
                             pt, gr, e, blocks, eps, st);
  if (dtype == 1)
    return launch_bwd<bf16>(dp, qg, cg, g, kd, b, kdo, g0, g1, k1, g2, g3, kout, ddp, dqg, dcg,
                            pt, gr, e, blocks, eps, st);
  return (int)cudaErrorInvalidValue;
}

// LanePooling's backward. g: the output cotangent [e, 128] in the activation
// dtype; dd fp32 [e, din], or null to skip it; dcg [e, 128] in the activation
// dtype; part: fp32 [blocks, 2*C*C + (3 + din)*C]; grads: fp32
// [2*C*C + (3 + din)*C] = dK1, dWout (in, out), dbd, dgchw, dgchb, then the
// din rows of dWd, the partials' sum in block order.
extern "C" int edge_mlp_pool_bwd(const void* d, const void* cg, const void* g, const void* kd,
                                 const void* bd, const void* k1, const void* gchw,
                                 const void* gchb, const void* kout, void* dd, void* dcg,
                                 void* part, void* grads, int e, int din, int blocks, float eps,
                                 int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float *dp = (const float*)d, *b = (const float*)bd, *g2 = (const float*)gchw,
              *g3 = (const float*)gchb;
  float *ddp = (float*)dd, *pt = (float*)part, *gr = (float*)grads;
  if (dtype == 0 && din == 2)
    return launch_pool_bwd<float, 2>(dp, cg, g, kd, b, k1, g2, g3, kout, ddp, dcg, pt, gr, e,
                                     blocks, eps, st);
  if (dtype == 0 && din == 4)
    return launch_pool_bwd<float, 4>(dp, cg, g, kd, b, k1, g2, g3, kout, ddp, dcg, pt, gr, e,
                                     blocks, eps, st);
  if (dtype == 1 && din == 2)
    return launch_pool_bwd<bf16, 2>(dp, cg, g, kd, b, k1, g2, g3, kout, ddp, dcg, pt, gr, e,
                                    blocks, eps, st);
  if (dtype == 1 && din == 4)
    return launch_pool_bwd<bf16, 4>(dp, cg, g, kd, b, k1, g2, g3, kout, ddp, dcg, pt, gr, e,
                                    blocks, eps, st);
  return (int)cudaErrorInvalidValue;
}
