// The W = 256 backwards' shared pieces: the transposed products, the row
// pass of the residual row tail both fused layers end in, and the weight-
// gradient pass. They train the double-width LaneGCN (n_map = n_actor =
// 256) on the CLI's contiguous layout: row_tail_bwd at K = 1 (row_tail.cu),
// lane_layer_bwd (lane_layer.cu, whose row pass is this one on the saved
// fp32 temp) and Att's edge_mlp_bwd (edge_mlp.cu). The 128- and 64-wide
// backwards keep their own kernels (tail_bwd.cuh, lane_band.cuh,
// edge_tc.cuh); wide.cuh sets out the 256-wide tiling.
//
// Where the 128-wide design breaks at 256: tail_bwd_tc_kernel keeps each
// warpgroup's share of dW in 64 registers across its tiles, and at 256 that
// share (128 input channels x 256 outputs) would need 256 registers beside
// the two m64n128 accumulators of a 256-wide row. So dW leaves the row pass:
// the pass writes the two operands of each weight gradient to workspaces
// (h and rnd(d_z), in the activation dtype, the values the plain version
// multiplies), and a second pass, dw_wide_tc_kernel, sums Aᵀ·B over row
// tiles as split-K wgmma products, one block per (split, weight, quadrant),
// each partial summed in split order (reduce_partials): no float atomics, a
// rerun is bitwise. The row tile's z and d_h no longer fit an fp32 row
// tile beside the weight, so every GroupNorm runs on the accumulators
// (statistics from a quad's lanes over both halves in a fixed order, as
// wide.cuh's forwards), and values a later step needs come back from device
// memory (x) or from the warpgroup's A operand (d_y, exact in bf16: it is
// the bf16 cotangent or zero).
//
// The fp32 twins (the parity path, CUDA cores) have the same two passes:
// 64-row fp32 tiles in the warp-a-row layout (wide::Row), the products with
// the weight streamed in KC-row chunks (mm_rows, transposed for A @ Wᵀ),
// and dw_wide_kernel for the weight gradients.
#pragma once

#include "wide.cuh"

namespace lgk {
namespace wide {

// --- products -------------------------------------------------------------------

// acc += H[nh] @ Qᵀ: K half nh of the warpgroup's A operand against one
// quadrant read K-major (quadrant (kh, nh) of W gives output half kh of
// A @ Wᵀ); issued, committed and waited for.
__device__ __forceinline__ void mm_quadrant_t(float (&acc)[64], const uint8_t* H_b, int nh,
                                              const uint8_t* Q_b) {
  const tc::Tiles A = tc::tiles(H_b + nh * HB, 64), B = tc::tiles(Q_b, C);
  tc::fence_acc(acc);
  tc::fence();
#pragma unroll
  for (int ks = 0; ks < C / 16; ++ks)
    tc::mma_ss<0, 0>(acc, tc::desc(A, true, ks, 0), tc::desc(B, true, ks, 0));
  tc::commit();
  tc::wait_all();
  tc::fence_acc(acc);
}

// a[kh] = Σ_nh H[nh] @ W(kh, nh)ᵀ, A @ Wᵀ for a weight held whole in
// mm_weight's layout (quadrant (kh, nh) at W_b + (2·nh + kh)·QB).
__device__ __forceinline__ void mm_weight_t(float (&a)[2][64], const uint8_t* H_b,
                                            const uint8_t* W_b) {
  tc::fence_acc(a[0]);
  tc::fence_acc(a[1]);
  tc::fence();
#pragma unroll
  for (int nh = 0; nh < 2; ++nh) {
    const tc::Tiles A = tc::tiles(H_b + nh * HB, 64);
#pragma unroll
    for (int ks = 0; ks < C / 16; ++ks) {
      const uint64_t da = tc::desc(A, true, ks, 0);
      tc::mma_ss<0, 0>(a[0], da, tc::desc(tc::tiles(W_b + 2 * nh * QB, C), true, ks, 0));
      tc::mma_ss<0, 0>(a[1], da, tc::desc(tc::tiles(W_b + (2 * nh + 1) * QB, C), true, ks, 0));
    }
  }
  tc::commit();
  tc::wait_all();
  tc::fence_acc(a[0]);
  tc::fence_acc(a[1]);
}

// acc += (the masked A rows @ w, or @ wᵀ with `transposed`) formed on its
// own, then added: the plain version's order for a sum of relations' products
// (temp = pre + Σ_j P_j, dx = d_y + Σ_j P_j). Summing each product straight
// into acc instead rounds every one of its k-terms at acc's magnitude.
__device__ __forceinline__ void add_rows(const float* A_s, int row_off, const float (&scale)[8],
                                         const float* w, float* W_s, float (&acc)[8][8],
                                         bool transposed) {
  float p[8][8];
  zero8(p);
  if (transposed)
    mm_rows<true>(A_s, row_off, scale, w, W_s, p);
  else
    mm_rows(A_s, row_off, scale, w, W_s, p);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] += p[i][j];
  }
}

// --- rows in the warp-a-row layout (fp32) ------------------------------------------

__device__ __forceinline__ Row zero_row() { return Row{zero4(), zero4()}; }
__device__ __forceinline__ Row mul_row(const Row& a, const Row& b) {
  return Row{mul4(a.lo, b.lo), mul4(a.hi, b.hi)};
}
__device__ __forceinline__ Row scale_row(const Row& a, float s) {
  return Row{make_float4(a.lo.x * s, a.lo.y * s, a.lo.z * s, a.lo.w * s),
             make_float4(a.hi.x * s, a.hi.y * s, a.hi.z * s, a.hi.w * s)};
}
// v where m > 0, else 0 (a ReLU's backward mask).
__device__ __forceinline__ Row mask_row(const Row& v, const Row& m) {
  return Row{pos_mask4(v.lo, m.lo), pos_mask4(v.hi, m.hi)};
}
__device__ __forceinline__ float row_sum(const Row& v) {
  return (v.lo.x + v.lo.y + v.lo.z + v.lo.w) + (v.hi.x + v.hi.y + v.hi.z + v.hi.w);
}

__device__ __forceinline__ Row nrm_row(const Row& v, float2 st) {
  return Row{gn_nrm(v.lo, st), gn_nrm(v.hi, st)};
}
// The lane's eight columns of a [256] vector, read element by element (the
// layer's GN vectors may sit 4 bytes off a 16-byte boundary).
__device__ __forceinline__ Row vec_row(const float* v) {
  const int l4 = (threadIdx.x & 31) * 4;
  return Row{make_float4(v[l4], v[l4 + 1], v[l4 + 2], v[l4 + 3]),
             make_float4(v[C + l4], v[C + l4 + 1], v[C + l4 + 2], v[C + l4 + 3])};
}
// nrm ⊙ w + b for the lane's eight columns.
__device__ __forceinline__ Row affine_row(const Row& nrm, const float* w, const float* b) {
  return add_row(mul_row(nrm, vec_row(w)), vec_row(b));
}
// GroupNorm backward of one row (common.cuh gn_bwd_row at 256):
// inv·(d_nrm − mean(d_nrm) − nrm·mean(d_nrm·nrm)), d_nrm = dy ⊙ w.
__device__ __forceinline__ Row gn_bwd_row(const Row& dy, const Row& nrm, float inv,
                                          const float* w) {
  const Row dn = mul_row(dy, vec_row(w));
  const float c1 = warp_sum(row_sum(dn)) * (1.f / WW);
  const float c2 = warp_sum(row_sum(mul_row(dn, nrm))) * (1.f / WW);
  const float4 m1 = make_float4(c1, c1, c1, c1), m2 = make_float4(c2, c2, c2, c2);
  auto part = [&](float4 d, float4 x) {
    return make_float4(inv * (d.x - m1.x - x.x * m2.x), inv * (d.y - m1.y - x.y * m2.y),
                       inv * (d.z - m1.z - x.z * m2.z), inv * (d.w - m1.w - x.w * m2.w));
  };
  return Row{part(dn.lo, nrm.lo), part(dn.hi, nrm.hi)};
}

// Column sums kept per warp (lane: its eight columns) → their sum over the
// NT/32 warps, in warp order, to out[q·WW + c] for the NV vectors. red_s:
// NT/32·NV·WW floats of shared memory; starts with a barrier.
template <int NV>
__device__ __forceinline__ void reduce_rows(const Row (&v)[NV], float* red_s, float* out) {
  const int warp = threadIdx.x >> 5;
  __syncthreads();
#pragma unroll
  for (int q = 0; q < NV; ++q) st_row(red_s + (warp * NV + q) * WW, v[q]);
  __syncthreads();
  for (int i = threadIdx.x; i < NV * WW; i += NT) {
    float s = 0.f;
    for (int w = 0; w < NT / 32; ++w) s += red_s[w * NV * WW + i];
    out[i] = s;
  }
}

// --- the accumulator layout (bf16 passes) -------------------------------------------

// Columns c, c + 1 of row r of a [n, 256] matrix as floats.
template <typename T> __device__ __forceinline__ float2 ld2(const T* p, long r, int c);
template <> __device__ __forceinline__ float2 ld2<float>(const float* p, long r, int c) {
  return *reinterpret_cast<const float2*>(p + r * WW + c);
}
template <> __device__ __forceinline__ float2 ld2<bf16>(const bf16* p, long r, int c) {
  return ld_pair(p + r * WW + c);
}

// a ← rows row0 + tc::acc_row(i) of a [n, 256] matrix (zero past n).
template <typename T>
__device__ __forceinline__ void load_acc(float (&a)[2][64], const T* src, long row0, int n) {
#pragma unroll
  for (int n2 = 0; n2 < 2; ++n2) {
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const long gr = row0 + tc::acc_row(i);
      const float2 v = gr < n ? ld2<T>(src, gr, acc_col(n2, i)) : make_float2(0.f, 0.f);
      a[n2][i] = v.x;
      a[n2][i + 1] = v.y;
    }
  }
}

// v_s[half·C + c] += the sum over the warpgroup tile's rows of f(i) (element
// i of accumulator `half`) for the lane's four columns c (col_sums' layout:
// the thread's two rows first, then col_stage's butterfly over the eight
// lanes that share them). v_s: this warp's row of a per-warp vector in
// shared memory; the lanes' columns are distinct.
template <class F>
__device__ __forceinline__ void col_add(float* v_s, int half, F f) {
  const int lane = threadIdx.x & 31;
  float x[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int i0 = 4 * (j >> 1) + (j & 1);
    x[j] = f(i0) + f(i0 + 2);
  }
  col_stage<16>(x, lane);
  col_stage<8>(x, lane);
  col_stage<4>(x, lane);
#pragma unroll
  for (int k = 0; k < 4; ++k) v_s[half * C + col_sum_col(k)] += x[k];
}

// out[i] = Σ over the block's NT/32 warps of vec_s[w][i] (NV·WW per warp),
// in warp order: the block's vector partial. Starts with a barrier.
template <int NV>
__device__ __forceinline__ void sum_warps(const float* vec_s, float* out) {
  __syncthreads();
  for (int i = threadIdx.x; i < NV * WW; i += NT) {
    float s = 0.f;
    for (int w = 0; w < NT / 32; ++w) s += vec_s[w * NV * WW + i];
    out[i] = s;
  }
}

// --- the weight-gradient pass ---------------------------------------------------------
//
// part[split][m] (256 x 256, (in, out)) = Σ over the DWR-row tiles split,
// split + splits, ... of A_m[u]ᵀ B_m[u], for nmat weights at once. Src
// names the operands' rows: src.a(m, u) and src.b(m, u) point at the 256
// values of row u of A_m and B_m (u < n), or are null for a zero row;
// src.any is some valid address of the same type (a zero-filled copy's
// source). bf16 (dw_wide_tc_kernel): block (split, 4m + q) owns quadrant q
// = (kh, nh) = (q & 1, q >> 1) of dW_m; both operands' tiles ([DWR x 128],
// A's columns kh·128.., B's nh·128..) stream through a DW_RING-stage ring by
// cp.async, MN-major from core tiles, as edge_tc.cuh's dw_tc; warpgroup g
// owns input channels kh·128 + 64g .. +63. fp32 (dw_wide_kernel): the same
// blocks, the tiles in fp32 [DWR x 128] row tiles and common.cuh mm_tn's
// 8 x 8 blocks on CUDA cores.
constexpr int DWR = 64;    // rows per tile
constexpr int DW_RING = 3;

inline int dw_wide_tc_smem() { return DW_RING * 2 * tc::tiles_bytes(DWR); }
inline int dw_wide_smem() { return 2 * DWR * LDA * (int)sizeof(float); }

template <class Src>
__global__ void __launch_bounds__(NT)
dw_wide_tc_kernel(Src src, int n, int nmat, float* __restrict__ part) {
  constexpr int TB = tc::tiles_bytes(DWR);
  extern __shared__ float4 smem4[];
  uint8_t* buf = reinterpret_cast<uint8_t*>(smem4);  // [DW_RING][A, B] core tiles
  const int m = blockIdx.y >> 2, kh = blockIdx.y & 1, nh = (blockIdx.y >> 1) & 1;
  const int wg = threadIdx.x >> 7, ntiles = (n + DWR - 1) / DWR, step = gridDim.x;
  const tc::Tiles t0 = tc::tiles(buf, DWR);  // offsets are the same in every stage

  auto issue = [&](int tile, int stage) {  // one commit group, empty past the last tile
    uint8_t* A_b = buf + stage * 2 * TB;
    if (tile < ntiles) {
#pragma unroll
      for (int k = 0; k < DWR * C / 8 / NT; ++k) {
        const int i = threadIdx.x + k * NT;
        const int r = ((i >> 7) << 3) + (i & 7), c = ((i >> 3) & 15) * 8;
        const uint32_t off = tc::tile_off(t0, r, c);
        const long u = (long)tile * DWR + r;
        const auto* pa = u < n ? src.a(m, u) : nullptr;
        const auto* pb = u < n ? src.b(m, u) : nullptr;
        cp_async16_zfill(A_b + off, pa ? pa + kh * C + c : src.any, pa ? 16 : 0);
        cp_async16_zfill(A_b + TB + off, pb ? pb + nh * C + c : src.any, pb ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  float acc[64];
  tc::zero(acc);
  const int first = blockIdx.x;
  issue(first, 0);
  issue(first + step, 1);
  for (int k = 0; first + k * step < ntiles; ++k) {
    cp_async_wait<1>();  // tile k landed (k + 1 may be in flight)
    tc::fence_smem();
    // tile k in place for every thread; both warpgroups done with tile
    // k − 1, whose stage tile k + 2 now takes
    __syncthreads();
    issue(first + (k + 2) * step, (k + 2) % DW_RING);
    const int st = k % DW_RING;
    const tc::Tiles A = tc::tiles(buf + st * 2 * TB, DWR), B = tc::tiles(buf + st * 2 * TB + TB, DWR);
    tc::fence_acc(acc);
    tc::fence();
    tc::mm<DWR / 16, false, false>(acc, A, 64 * wg, B);
    tc::commit();
    tc::wait_all();
    tc::fence_acc(acc);
  }
  cp_async_wait<0>();  // no copy lands after the block is gone
  float* P = part + (((long)blockIdx.x * nmat + m) * WW + kh * C + 64 * wg) * WW + nh * C;
#pragma unroll
  for (int i = 0; i < 64; i += 2)
    *reinterpret_cast<float2*>(P + tc::acc_row(i) * WW + tc::acc_col(i)) =
        make_float2(acc[i], acc[i + 1]);
}

template <class Src>
__global__ void __launch_bounds__(NT)
dw_wide_kernel(Src src, int n, int nmat, float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  float* A_s = reinterpret_cast<float*>(smem4);  // [DWR][LDA] A's 128 columns of the quadrant
  float* B_s = A_s + DWR * LDA;                  // [DWR][LDA] B's
  const int m = blockIdx.y >> 2, kh = blockIdx.y & 1, nh = (blockIdx.y >> 1) & 1;
  const int ntiles = (n + DWR - 1) / DWR;
  float acc[8][8];
  zero_tn(acc);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    __syncthreads();  // the previous tile's products are done
    for (int idx = threadIdx.x; idx < DWR * (C / 4); idx += NT) {
      const int r = idx / (C / 4), c4 = (idx % (C / 4)) * 4;
      const long u = (long)tile * DWR + r;
      float4 a = zero4(), b = zero4();
      if (u < n) {
        const float* pa = src.a(m, u);
        const float* pb = src.b(m, u);
        if (pa) a = *reinterpret_cast<const float4*>(pa + kh * C + c4);
        if (pb) b = *reinterpret_cast<const float4*>(pb + nh * C + c4);
      }
      *reinterpret_cast<float4*>(A_s + r * LDA + c4) = a;
      *reinterpret_cast<float4*>(B_s + r * LDA + c4) = b;
    }
    __syncthreads();
    float p[8][8];  // the tile's product, added to acc whole (a sum over a
    zero_tn(p);     // split's rows, row after row, would round at acc's magnitude)
    mm_tn(A_s, B_s, DWR, p);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += p[i][j];
    }
  }
  store_tn<WW>(part + (((long)blockIdx.x * nmat + m) * WW + kh * C) * WW + nh * C, acc, false);
}

// The weight-gradient pass on min(splits, tiles) x 4·nmat blocks, then its
// partials summed in split order into grads [nmat, 256, 256]. T: the
// operands' type (bf16: wgmma; float: CUDA cores).
template <typename T, class Src>
int launch_dw(const Src& src, int n, int nmat, int splits, float* part, float* grads,
              cudaStream_t stream) {
  const int ntiles = (n + DWR - 1) / DWR;
  if (splits > ntiles) splits = ntiles;
  if (splits > 0 && nmat > 0) {
    const dim3 grid(splits, 4 * nmat);
    cudaError_t err;
    if constexpr (std::is_same<T, bf16>::value) {
      err = set_smem((const void*)dw_wide_tc_kernel<Src>, dw_wide_tc_smem());
      if (err != cudaSuccess) return (int)err;
      dw_wide_tc_kernel<Src><<<grid, NT, dw_wide_tc_smem(), stream>>>(src, n, nmat, part);
    } else {
      err = set_smem((const void*)dw_wide_kernel<Src>, dw_wide_smem());
      if (err != cudaSuccess) return (int)err;
      dw_wide_kernel<Src><<<grid, NT, dw_wide_smem(), stream>>>(src, n, nmat, part);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)reduce_partials(part, grads, splits, (long)nmat * WW * WW, stream);
}

// The row pass's dW operands: A = h, B = rnd(d_z), one weight.
template <typename T>
struct TailSrc {
  const T* h;
  const T* dz;
  const T* any;
  __device__ const T* a(int, long u) const { return h + u * WW; }
  __device__ const T* b(int, long u) const { return dz + u * WW; }
};

// --- the row pass: the residual row tail's backward at W = 256 --------------------------
//
// Per row, as tail_bwd.cuh states it: h = rnd(relu(GN1(x))), z = h @ W,
// d_y = g ⊙ [GN2(z) + res > 0], d_z = rnd(GN2ᵀ(d_y)), d_h = d_z @ Wᵀ ⊙
// [h_pre > 0], d_x = GN1ᵀ(d_h), the four GN vector gradients as column
// sums; dW = Σ hᵀ d_z in launch_tail_bwd's second pass. Outputs: dx (T)
// and dx32 (fp32, or null), dy (T, or null) and dy32 (fp32, or null); h
// and rnd(d_z) to the [n, 256] workspaces hws, dzws; the block's vector
// sums (dg1w, dg1b, dg2w, dg2b) to part_v[block].
//
// bf16 (tail_bwd_wide_tc_kernel): a persistent grid of two-warpgroup
// blocks, W held whole (four quadrants, 129 KB, read MN-major for z = h @ W
// and K-major for d_z @ Wᵀ), each warpgroup on 64-row tiles of its own with
// its A operand (two K halves of [64 x 128] bf16) taking h, then d_y, then
// rnd(d_z); the column sums per warp in shared memory ([8][4][256] fp32);
// 226 KB of shared memory, the GN vectors read from device memory.
// fp32 (tail_bwd_wide_kernel): a persistent grid of 256-thread blocks on
// 64-row tiles, the chain in one fp32 [64 x 256] tile by warp-a-row, the
// products on CUDA cores, the column sums per warp in registers.
constexpr int TW_WGS = 2;
constexpr int TW_THREADS = 128 * TW_WGS;
static_assert(TW_THREADS == NT, "the per-warp vectors are NT/32 rows");

inline int tail_bwd_wide_tc_smem() {
  return 4 * QB + TW_WGS * 2 * HB + NT / 32 * 4 * WW * (int)sizeof(float);
}
inline int tail_bwd_wide_smem() { return TILE_BYTES + CHUNK_BYTES + 2 * TM * (int)sizeof(float); }

template <typename TX>
__global__ void __launch_bounds__(TW_THREADS, 1)
tail_bwd_wide_tc_kernel(const TX* __restrict__ x, const bf16* __restrict__ res,
                        const bf16* __restrict__ g, const bf16* __restrict__ w,
                        const float* __restrict__ g1w, const float* __restrict__ g1b,
                        const float* __restrict__ g2w, const float* __restrict__ g2b,
                        bf16* __restrict__ dx, bf16* __restrict__ dy, float* __restrict__ dx32,
                        float* __restrict__ dy32, bf16* __restrict__ hws,
                        bf16* __restrict__ dzws, float* __restrict__ part_v, int n, float eps) {
  extern __shared__ float4 smem4[];
  uint8_t* W_b = reinterpret_cast<uint8_t*>(smem4);                        // 4 quadrants
  uint8_t* H_all = W_b + 4 * QB;                                           // [2][2 K halves]
  float* vec_s = reinterpret_cast<float*>(H_all + TW_WGS * 2 * HB);        // [8][4][256]
  const int wg = threadIdx.x >> 7, warp = threadIdx.x >> 5;
  uint8_t* H_b = H_all + wg * 2 * HB;  // the warpgroup's A operand

#pragma unroll
  for (int q = 0; q < 4; ++q) fetch_quadrant(W_b + q * QB, w, q & 1, q >> 1, threadIdx.x, NT);
  cp_async_commit();
  for (int i = threadIdx.x; i < NT / 32 * 4 * WW; i += NT) vec_s[i] = 0.f;
  cp_async_wait<0>();
  tc::fence_smem();
  __syncthreads();  // W and the zeroed vectors in place
  float* v_s = vec_s + warp * 4 * WW;  // this warp's dg1w, dg1b, dg2w, dg2b

  const int ntiles = (n + TM - 1) / TM;
  for (int tile = blockIdx.x * TW_WGS + wg; tile < ntiles; tile += gridDim.x * TW_WGS) {
    const long row0 = (long)tile * TM;
    const bool ok[2] = {row0 + tc::acc_row(0) < n, row0 + tc::acc_row(2) < n};
    auto xpair = [&](int n2, int i) {  // x at element pair i of half n2 (0 past n)
      return ok[tc::acc_half(i)] ? ld2<TX>(x, row0 + tc::acc_row(i), acc_col(n2, i))
                                 : make_float2(0.f, 0.f);
    };
    float a[2][64], mu1[2], inv1[2], mu2[2], inv2[2], c1[2], c2[2];
    load_acc<TX>(a, x, row0, n);
    row_stats(a, eps, mu1, inv1);
    wg_sync();  // the warpgroup's previous products are done with H
    // h = rnd(relu(GN1(x))) into H and to hws.
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2) {
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int hh = tc::acc_half(i), r = tc::acc_row(i), c = acc_col(n2, i);
        const float h0 = fmaxf((a[n2][i] - mu1[hh]) * inv1[hh] * g1w[c] + g1b[c], 0.f);
        const float h1 = fmaxf((a[n2][i + 1] - mu1[hh]) * inv1[hh] * g1w[c + 1] + g1b[c + 1], 0.f);
        const uint32_t u = tc::pack_bf2(h0, h1);
        *a_pair(H_b, r, c) = u;
        if (ok[hh]) *reinterpret_cast<uint32_t*>(hws + (row0 + r) * WW + c) = u;
      }
    }
    tc::fence_smem();
    wg_sync();
    zero2(a);
    mm_weight(a, H_b, W_b);  // z = h @ W
    row_stats(a, eps, mu2, inv2);
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2) {
#pragma unroll
      for (int i = 0; i < 64; ++i) a[n2][i] = (a[n2][i] - mu2[tc::acc_half(i)]) * inv2[tc::acc_half(i)];
    }
    wg_sync();  // the product is done with H
    // d_y = g ⊙ [nrm2·g2w + g2b + res > 0] (0 past n) into H (exact in bf16),
    // and the rows' sums of GN2's backward.
    c1[0] = c1[1] = c2[0] = c2[1] = 0.f;
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2) {
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int hh = tc::acc_half(i), r = tc::acc_row(i), c = acc_col(n2, i);
        float2 gv = make_float2(0.f, 0.f), rv = gv;
        if (ok[hh]) {
          gv = ld2<bf16>(g, row0 + r, c);
          rv = ld2<bf16>(res, row0 + r, c);
        }
        const float d0 = a[n2][i] * g2w[c] + g2b[c] + rv.x > 0.f ? gv.x : 0.f;
        const float d1 = a[n2][i + 1] * g2w[c + 1] + g2b[c + 1] + rv.y > 0.f ? gv.y : 0.f;
        *a_pair(H_b, r, c) = tc::pack_bf2(d0, d1);
        const float dn0 = d0 * g2w[c], dn1 = d1 * g2w[c + 1];
        c1[hh] += dn0;
        c2[hh] += dn0 * a[n2][i];
        c1[hh] += dn1;
        c2[hh] += dn1 * a[n2][i + 1];
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      c1[hh] = tc::quad_sum(c1[hh]) * (1.f / WW);
      c2[hh] = tc::quad_sum(c2[hh]) * (1.f / WW);
    }
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2) {  // dg2w, dg2b
      auto dyv = [&](int i) {
        const float2 p = unpack_bf2(*a_pair(H_b, tc::acc_row(i), acc_col(n2, i & ~1)));
        return (i & 1) ? p.y : p.x;
      };
      col_add(v_s + 2 * WW, n2, [&](int i) { return dyv(i) * a[n2][i]; });
      col_add(v_s + 3 * WW, n2, dyv);
    }
    // d_z = rnd(GN2ᵀ(d_y)) over d_y in H; d_y and d_z out.
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2) {
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int hh = tc::acc_half(i), r = tc::acc_row(i), c = acc_col(n2, i);
        uint32_t* p = a_pair(H_b, r, c);
        const uint32_t du = *p;
        const float2 d = unpack_bf2(du);
        const uint32_t u =
            tc::pack_bf2(inv2[hh] * (d.x * g2w[c] - c1[hh] - a[n2][i] * c2[hh]),
                         inv2[hh] * (d.y * g2w[c + 1] - c1[hh] - a[n2][i + 1] * c2[hh]));
        *p = u;
        if (!ok[hh]) continue;
        const long o = (row0 + r) * WW + c;
        *reinterpret_cast<uint32_t*>(dzws + o) = u;
        if (dy) *reinterpret_cast<uint32_t*>(dy + o) = du;
        if (dy32) *reinterpret_cast<float2*>(dy32 + o) = d;
      }
    }
    tc::fence_smem();
    wg_sync();
    zero2(a);
    mm_weight_t(a, H_b, W_b);  // rnd(d_z) @ Wᵀ
    // d_h = · ⊙ [h_pre > 0] (0 past n), the rows' sums of GN1's backward.
    c1[0] = c1[1] = c2[0] = c2[1] = 0.f;
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2) {
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int hh = tc::acc_half(i), c = acc_col(n2, i);
        const float2 xv = xpair(n2, i);
        const float x0 = (xv.x - mu1[hh]) * inv1[hh], x1 = (xv.y - mu1[hh]) * inv1[hh];
        const float d0 = ok[hh] && x0 * g1w[c] + g1b[c] > 0.f ? a[n2][i] : 0.f;
        const float d1 = ok[hh] && x1 * g1w[c + 1] + g1b[c + 1] > 0.f ? a[n2][i + 1] : 0.f;
        a[n2][i] = d0;
        a[n2][i + 1] = d1;
        const float dn0 = d0 * g1w[c], dn1 = d1 * g1w[c + 1];
        c1[hh] += dn0;
        c2[hh] += dn0 * x0;
        c1[hh] += dn1;
        c2[hh] += dn1 * x1;
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      c1[hh] = tc::quad_sum(c1[hh]) * (1.f / WW);
      c2[hh] = tc::quad_sum(c2[hh]) * (1.f / WW);
    }
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2) {  // dg1w, dg1b
      auto nrm1 = [&](int i) {
        const float2 xv = xpair(n2, i & ~1);
        return (((i & 1) ? xv.y : xv.x) - mu1[tc::acc_half(i)]) * inv1[tc::acc_half(i)];
      };
      col_add(v_s, n2, [&](int i) { return a[n2][i] * nrm1(i); });
      col_add(v_s + WW, n2, [&](int i) { return a[n2][i]; });
    }
    // d_x = GN1ᵀ(d_h).
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2) {
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int hh = tc::acc_half(i), r = tc::acc_row(i), c = acc_col(n2, i);
        if (!ok[hh]) continue;
        const float2 xv = xpair(n2, i);
        const float x0 = (xv.x - mu1[hh]) * inv1[hh], x1 = (xv.y - mu1[hh]) * inv1[hh];
        const float y0 = inv1[hh] * (a[n2][i] * g1w[c] - c1[hh] - x0 * c2[hh]);
        const float y1 = inv1[hh] * (a[n2][i + 1] * g1w[c + 1] - c1[hh] - x1 * c2[hh]);
        const long o = (row0 + r) * WW + c;
        *reinterpret_cast<__nv_bfloat162*>(dx + o) = __floats2bfloat162_rn(y0, y1);
        if (dx32) *reinterpret_cast<float2*>(dx32 + o) = make_float2(y0, y1);
      }
    }
  }
  sum_warps<4>(vec_s, part_v + (long)blockIdx.x * 4 * WW);
}

template <typename TX>
__global__ void __launch_bounds__(NT)
tail_bwd_wide_kernel(const TX* __restrict__ x, const float* __restrict__ res,
                     const float* __restrict__ g, const float* __restrict__ w,
                     const float* __restrict__ g1w, const float* __restrict__ g1b,
                     const float* __restrict__ g2w, const float* __restrict__ g2b,
                     float* __restrict__ dx, float* __restrict__ dy, float* __restrict__ dx32,
                     float* __restrict__ dy32, float* __restrict__ hws, float* __restrict__ dzws,
                     float* __restrict__ part_v, int n, float eps) {
  extern __shared__ float4 smem4[];
  float* T_s = reinterpret_cast<float*>(smem4);  // [TM][LDW] h, then z → rnd(d_z), then d_h
  float* W_s = T_s + TM * LDW;                   // [KC][256]
  float* st_s = W_s + KC * WW;                   // [TM][2] GN1 mean, inv
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float ones[8] = {1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f};
  Row v[4] = {zero_row(), zero_row(), zero_row(), zero_row()};  // dg1w, dg1b, dg2w, dg2b
  const int ntiles = (n + TM - 1) / TM;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long row0 = (long)tile * TM;
    __syncthreads();  // the previous tile is done with T_s and st_s
    for (int r = warp; r < TM; r += NT / 32) {  // h = relu(GN1(x)) (0 past n)
      const long gr = row0 + r;
      Row h = zero_row();
      if (gr < n) {
        const Row xv = ld_row_g<TX>(x + gr * WW);
        const float2 st = row_stats(xv, eps);
        h = relu_row(affine_row(nrm_row(xv, st), g1w, g1b));
        st_row_g<float>(hws + gr * WW, h);
        if (lane == 0) {
          st_s[2 * r] = st.x;
          st_s[2 * r + 1] = st.y;
        }
      }
      st_row(T_s + r * LDW, h);
    }
    float acc[8][8];
    zero8(acc);
    mm_rows(T_s, 0, ones, w, W_s, acc);  // z = h @ W
    __syncthreads();
    store_tile(T_s, acc);
    __syncthreads();
    for (int r = warp; r < TM; r += NT / 32) {  // d_y, d_z = GN2ᵀ(d_y)
      const long gr = row0 + r;
      Row dz = zero_row();
      if (gr < n) {
        const Row z = ld_row(T_s + r * LDW);
        const float2 st = row_stats(z, eps);
        const Row nrm = nrm_row(z, st);
        const Row y = add_row(affine_row(nrm, g2w, g2b), ld_row_g<float>(res + gr * WW));
        const Row d_y = mask_row(ld_row_g<float>(g + gr * WW), y);
        v[2] = add_row(v[2], mul_row(d_y, nrm));
        v[3] = add_row(v[3], d_y);
        dz = gn_bwd_row(d_y, nrm, st.y, g2w);
        st_row_g<float>(dzws + gr * WW, dz);
        if (dy) st_row_g<float>(dy + gr * WW, d_y);
        if (dy32) st_row_g<float>(dy32 + gr * WW, d_y);
      }
      st_row(T_s + r * LDW, dz);
    }
    zero8(acc);
    mm_rows<true>(T_s, 0, ones, w, W_s, acc);  // d_z @ Wᵀ
    __syncthreads();
    store_tile(T_s, acc);
    __syncthreads();
    for (int r = warp; r < TM; r += NT / 32) {  // d_h = · ⊙ [h_pre > 0], d_x = GN1ᵀ(d_h)
      const long gr = row0 + r;
      if (gr >= n) break;
      const float2 st = make_float2(st_s[2 * r], st_s[2 * r + 1]);
      const Row nrm = nrm_row(ld_row_g<TX>(x + gr * WW), st);
      const Row d_h = mask_row(ld_row(T_s + r * LDW), affine_row(nrm, g1w, g1b));
      v[0] = add_row(v[0], mul_row(d_h, nrm));
      v[1] = add_row(v[1], d_h);
      const Row d_x = gn_bwd_row(d_h, nrm, st.y, g1w);
      st_row_g<float>(dx + gr * WW, d_x);
      if (dx32) st_row_g<float>(dx32 + gr * WW, d_x);
    }
  }
  reduce_rows<4>(v, T_s, part_v + (long)blockIdx.x * 4 * WW);
}

// The row pass on min(blocks, its tiles) blocks, then dW over (splits, 4)
// blocks, each pass's partials summed in block (split) order into grads
// [256² + 4·256] = dW, dg1w, dg1b, dg2w, dg2b. part: the vector partials
// (blocks x 4·256), the dW pass's (max(1, blocks / 2) x 256²), then the h
// and rnd(d_z) workspaces, [n, 256] each in T (ops/row_tail.py
// `wide_part_floats`).
template <typename T, typename TX>
int launch_tail_bwd(const TX* x, const T* res, const T* g, const T* w, const float* g1w,
                    const float* g1b, const float* g2w, const float* g2b, T* dx, T* dy,
                    float* dx32, float* dy32, float* part, float* grads, int n, int blocks,
                    float eps, cudaStream_t stream) {
  constexpr bool TC = std::is_same<T, bf16>::value;
  const int splits = blocks / 2 > 1 ? blocks / 2 : 1;
  float* part_v = part;
  float* part_w = part + (long)blocks * 4 * WW;
  T* hws = reinterpret_cast<T*>(part_w + (long)splits * WW * WW);
  T* dzws = hws + (long)n * WW;
  const int ntiles = (n + TM - 1) / TM;
  int nb = TC ? (ntiles + TW_WGS - 1) / TW_WGS : ntiles;
  if (nb > blocks) nb = blocks;
  if (nb > 0) {
    cudaError_t err;
    if constexpr (TC) {
      err = set_smem((const void*)tail_bwd_wide_tc_kernel<TX>, tail_bwd_wide_tc_smem());
      if (err != cudaSuccess) return (int)err;
      tail_bwd_wide_tc_kernel<TX><<<nb, TW_THREADS, tail_bwd_wide_tc_smem(), stream>>>(
          x, res, g, w, g1w, g1b, g2w, g2b, dx, dy, dx32, dy32, hws, dzws, part_v, n, eps);
    } else {
      err = set_smem((const void*)tail_bwd_wide_kernel<TX>, tail_bwd_wide_smem());
      if (err != cudaSuccess) return (int)err;
      tail_bwd_wide_kernel<TX><<<nb, NT, tail_bwd_wide_smem(), stream>>>(
          x, res, g, w, g1w, g1b, g2w, g2b, dx, dy, dx32, dy32, hws, dzws, part_v, n, eps);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  int e = launch_dw<T>(TailSrc<T>{hws, dzws, res}, n, 1, splits, part_w, grads, stream);
  if (e != 0) return e;
  return (int)reduce_partials(part_v, grads + WW * WW, nb, 4 * WW, stream);
}

}  // namespace wide
}  // namespace lgk
