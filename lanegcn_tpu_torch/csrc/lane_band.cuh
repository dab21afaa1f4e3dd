// The band part and the row tail of the fused LaneConv layer, shared by
// lane_layer.cu (the layer alone), lane_plan.cu (the layer with the window
// plan's aggregate inside it) and band_conv.cu (the band sum alone, the
// unfused layer's). Per 64-row tile of node rows u:
//
//   forward   acc  = pre + Σ_{j<J} band_j[u] · feat[u + s_j] @ Wb_j   (|s_j| ≤ 32, rows
//                                                                      outside [0,N) read 0;
//                                                                      no pre: 0)
//             out  = relu(GN2(relu(GN1(temp)) @ W2) + feat)            (layer_tail, from T_s)
//   backward  acc  = d_y[p] + Σ_j band_j[p − s_j] · d_temp[p − s_j] @ Wb_jᵀ   (no d_y: 0)
//             dWb_j = Σ_u (band_j[u] · feat[u + s_j])ᵀ rnd(d_temp[u])   (band_dw_kernel)
//
// d_temp is the fp32 d_temp of the layer kernels' row pass, or band_conv's
// cotangent in the activation dtype (the template parameter D).
//
// A tile block holds its rows plus a ±32-row halo of feat (forward) or of
// d_temp (backward) in shared memory once, and reuses it for all J
// shifted products. What bounds both directions is the products (12 band
// products per masked row, ~57 GFLOP a pass at the 256-scenario pack,
// against ~160-320 MB moved), so they belong on the tensor cores.
//
// band_fwd / layer_tail / band_t (64-row tiles) run the products on CUDA
// cores in fp32 (mm_64x128 / mm_tn) and serve only the fp32
// instantiations: the fp32 path is what the parity checks hold to the CPU,
// and wgmma has no fp32 operands. Every bf16 product runs on wgmma
// (common.cuh `tc`): band_t_tc_kernel (dx, 192-row blocks of three
// warpgroups, A through registers at the shifted rows, fp32 d_temp split
// into bf16 hi + lo), band_dw_tc_kernel (dWb, both operands MN-major from a
// cp.async ring of shared core tiles) and tail_bwd.cuh's row pass; the bf16
// forwards of lane_layer.cu (lane_layer_tc_kernel), lane_plan.cu
// (lane_plan_tc_kernel) and band_conv.cu (band_conv_tc_kernel) run
// band_fwd_tc, which mirrors band_t_tc_kernel with its 192-row blocks, halo
// tile and weight buffers (DX_*, prefetch_weight), and the two layer
// kernels end in layer_tail_tc (tail_fwd.cuh's chain in registers).
//
// lane_plan.cu adds the window plan's messages into these sums: a
// [slots, W] workspace holds each plan edge's rounded message at its
// position in destination (forward) or source (backward) order, and a
// block adds its rows' runs of positions (segment_sum.cuh `run_table` over
// the sorted segment keys) in position order, into the accumulators before
// the tail (add_runs_tc, add_runs_mm) or before dx is stored (the PLAN
// instantiations of band_t_kernel and band_t_tc_kernel).
#pragma once

#include "segment_sum.cuh"
#include "tail_bwd.cuh"
#include "tail_fwd.cuh"

namespace lgk {

constexpr int HALO = 32;
constexpr int MAXJ = 16;

struct Shifts {
  int s[MAXJ];
};

inline int make_shifts(int nj, const int* shifts, Shifts* sh) {
  if (nj < 0 || nj > MAXJ) return (int)cudaErrorInvalidValue;
  for (int j = 0; j < MAXJ; ++j) sh->s[j] = 0;
  for (int j = 0; j < nj; ++j) {
    if (shifts[j] < -HALO || shifts[j] > HALO) return (int)cudaErrorInvalidValue;
    sh->s[j] = shifts[j];
  }
  return 0;
}

// Shared memory of a [TM + 2*HALO] halo tile.
constexpr int HALO_TILE = (TM + 2 * HALO) * LDA;

// S_s[r] = src rows tile0 − HALO + r (r < TM + 2*HALO), zero outside [0, n)
// (and past a row width W below C).
template <typename S, int W = C>
__device__ __forceinline__ void load_halo(float* S_s, const S* src, long tile0, int n) {
  for (int idx = threadIdx.x; idx < (TM + 2 * HALO) * (C / 4); idx += NT) {
    const int r = idx / (C / 4), c4 = (idx % (C / 4)) * 4;
    const long g = tile0 - HALO + r;
    float4 v = zero4();
    if (g >= 0 && g < n && (W == C || c4 < W)) v = load4<S>(src + g * W + c4);
    *reinterpret_cast<float4*>(S_s + r * LDA + c4) = v;
  }
}

// dst rows tile0 + mm_row(i) (those below n) = acc, rounded to T; W-wide
// rows (mm_col(4) ≥ 64: not stored below C).
template <typename T, int W = C>
__device__ __forceinline__ void store_rows(T* dst, const float acc[4][8], long tile0, int n) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long g = tile0 + mm_row(i);
    if (g < n) {
      store4<T>(dst + g * W + mm_col(0), make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      if (W == C)
        store4<T>(dst + g * W + mm_col(4),
                  make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
    }
  }
}

// acc[i] (the tile's row mm_row(i), the 64 x 128 product layout) += the
// fp32 rows [blo + lo_s[r], blo + hi_s[r]) of msg [slots, W], in order (a
// block's run table, segment_sum.cuh `run_table`). At a row width W below
// C the columns mm_col(4) ≥ 64 lie past W: acc[i][4..7] are left as they
// are (zero).
template <int W = C>
__device__ __forceinline__ void add_runs_mm(float acc[4][8], const float* msg, long blo,
                                            const int* lo_s, const int* hi_s) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = mm_row(i);
    for (long p = blo + lo_s[r]; p < blo + hi_s[r]; ++p) {
      const float4 a = load4<float>(msg + p * W + mm_col(0));
      acc[i][0] += a.x;
      acc[i][1] += a.y;
      acc[i][2] += a.z;
      acc[i][3] += a.w;
      if constexpr (W == C) {
        const float4 b = load4<float>(msg + p * C + mm_col(4));
        acc[i][4] += b.x;
        acc[i][5] += b.y;
        acc[i][6] += b.z;
        acc[i][7] += b.w;
      }
    }
  }
}

// acc = pre + Σ_j band_j[u] · X_s[u + s_j] @ Wb_j over the tile's rows (X_s:
// the feat halo tile, loaded; W_s: [C][C] scratch; pre may be null). At a
// row width W below C: pre and the [W x W] Wb_j zero-padded, so acc is zero
// past W.
template <typename T, int W = C>
__device__ __forceinline__ void band_fwd(const float* X_s, float* W_s, const T* pre,
                                         const uint8_t* masks, const T* wb, long tile0, int n,
                                         int nj, const Shifts& sh, float acc[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long g = tile0 + mm_row(i);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[i][j] = (pre && g < n && (W == C || mm_col(j) < W)) ? to_f<T>(pre[g * W + mm_col(j)])
                                                               : 0.f;
  }
  for (int j = 0; j < nj; ++j) {
    __syncthreads();  // previous product done with W_s (and X_s loaded)
    load_weight<T, W>(W_s, wb + (long)j * W * W);
    float m[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long g = tile0 + mm_row(i);
      m[i] = (g < n && masks[(long)j * n + g]) ? 1.f : 0.f;
    }
    __syncthreads();
    mm_64x128(X_s, HALO + sh.s[j], m, W_s, acc);
  }
}

// The layer tail from the tile's fp32 temp in T_s (complete, and visible to
// every thread): temp_out ← T_s when given, then
// out = relu(GN2(relu(GN1(temp)) @ W2) + feat) with h rounded to T before the
// product. X_s: the feat halo tile (the residual); W_s: [C][C] scratch. At
// a row width W below C: W-wide rows (temp zero past W), GN statistics over
// W, the [W x W] W2 zero-padded, only W columns stored.
template <typename T, int W = C>
__device__ __forceinline__ void layer_tail(const float* X_s, float* T_s, float* W_s, const T* w2,
                                           const float* g1w, const float* g1b, const float* g2w,
                                           const float* g2b, T* out, float* temp_out, long tile0,
                                           int n, float eps) {
  if (temp_out) {
    for (int idx = threadIdx.x; idx < TM * (C / 4); idx += NT) {
      const int r = idx / (C / 4), c4 = (idx % (C / 4)) * 4;
      const long g = tile0 + r;
      if (g < n && (W == C || c4 < W))
        *reinterpret_cast<float4*>(temp_out + g * W + c4) =
            *reinterpret_cast<const float4*>(T_s + r * LDA + c4);
    }
    __syncthreads();
  }
  gn_relu_rows<T, W>(T_s, TM, g1w, g1b, eps);  // h = relu(GN1(temp)), rounded to T
  load_weight<T, W>(W_s, w2);
  __syncthreads();
  const float ones[4] = {1.f, 1.f, 1.f, 1.f};
  float acc[4][8];
  zero_acc(acc);
  mm_64x128(T_s, 0, ones, W_s, acc);  // z = h @ W2
  __syncthreads();
  store_acc(T_s, acc);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < TM; r += NT / 32) {
    const long g = tile0 + r;
    if (g >= n) break;
    const float4 z = *reinterpret_cast<const float4*>(T_s + r * LDA + lane * 4);
    const float4 res = *reinterpret_cast<const float4*>(X_s + (HALO + r) * LDA + lane * 4);
    const float4 y = gn_row<W>(z, g2w, g2b, eps);
    if (lane_in<W>()) store4<T>(out + g * W + lane * 4, relu4(add4(y, res)));
  }
}

// acc = d_y[p] + Σ_j band_j[p − s_j] · d_temp[p − s_j] @ Wb_jᵀ over the tile's
// rows p (D_s: the d_temp halo tile in fp32, loaded; W_s: [C][C] scratch; dy
// may be null). At a row width W below C: dy read W wide, the [W x W] Wb_j
// zero-padded, so acc is zero past W.
template <typename T, int W = C>
__device__ __forceinline__ void band_t(const float* D_s, float* W_s, const float* dy,
                                       const uint8_t* masks, const T* wb, long tile0, int n,
                                       int nj, const Shifts& sh, float acc[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long g = tile0 + mm_row(i);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[i][j] = (dy && g < n && (W == C || mm_col(j) < W)) ? dy[g * W + mm_col(j)] : 0.f;
  }
  for (int j = 0; j < nj; ++j) {
    __syncthreads();  // the previous product is done with W_s (and D_s is loaded)
    load_weight_t<T, W>(W_s, wb + (long)j * W * W);
    float m[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long src = tile0 + mm_row(i) - sh.s[j];
      m[i] = (src >= 0 && src < n && masks[(long)j * n + src]) ? 1.f : 0.f;
    }
    __syncthreads();
    mm_64x128(D_s, HALO - sh.s[j], m, W_s, acc);
  }
}

// Band pass: dx[p] = d_y[p] + Σ_j band_j[p − s_j] · d_temp[p − s_j] @ Wb_jᵀ
// (rows p − s_j outside [0, n) give 0), stored in T. A block owns 64 rows p
// and loads the d_temp rows p − HALO .. p + TM + HALO − 1 once for all J
// products. PLAN (lane_plan.cu, fp32): dx[p] also adds p's run of the plan's
// transposed messages pm [slots, W], which sit at the positions whose
// source key pseg is p, in position order. W: the rows' width (dtemp, dy,
// dx [n, W], wb [nj, W, W]).
template <typename T, typename D, bool PLAN = false, int W = C>
__global__ void __launch_bounds__(NT)
band_t_kernel(const D* __restrict__ dtemp, const float* __restrict__ dy,
              const uint8_t* __restrict__ masks, const T* __restrict__ wb, T* __restrict__ dx,
              int n, int nj, Shifts sh, const T* __restrict__ pm,
              const long long* __restrict__ pseg, long slots) {
  extern __shared__ float4 smem4[];
  float* D_s = reinterpret_cast<float*>(smem4);  // [TM + 2*HALO][LDA]
  float* W_s = D_s + HALO_TILE;                  // [C][C] Wb_jᵀ
  const long tile0 = (long)blockIdx.x * TM;

  load_halo<D, W>(D_s, dtemp, tile0, n);
  float acc[4][8];
  band_t<T, W>(D_s, W_s, dy, masks, wb, tile0, n, nj, sh, acc);
  if constexpr (PLAN) {
    static_assert(std::is_same<T, float>::value, "bf16 runs band_t_tc_kernel");
    __shared__ int lo_s[TM], hi_s[TM];
    __shared__ long blk_s[2];
    seg::run_table<TM>(pseg, slots, tile0, (int)min((long)TM, n - tile0), lo_s, hi_s, blk_s);
    add_runs_mm<W>(acc, pm, blk_s[0], lo_s, hi_s);
  }
  store_rows<T, W>(dx, acc, tile0, n);
}

// The bf16 dx pass on tensor cores (its block shape, halo tile and weight
// buffers are lane_layer.cu's bf16 forward's too). A block of DX_WGS = 3 warpgroups owns
// DX_ROWS = 192 rows p (warpgroup g: rows 64g .. 64g+63) and holds the
// cotangent rows p − HALO .. p + DX_ROWS + HALO − 1 once, as a row-major
// bf16 halo tile. The shifts (±1 .. ±32) put the A operand of relation j
// at row offset HALO − s_j of that tile, which no shared-memory descriptor
// can address (its rows come in aligned 8-row core matrices), so A goes
// through registers: `ldmatrix` at any row offset from the padded tile
// (272-byte rows: 8 rows of one 16-byte column hit 8 distinct bank
// groups), the fragment's rows zeroed where band_j[p − s_j] is 0, then
// wgmma's register-A form against Wb_jᵀ, which is Wb_j K-major in core
// tiles. A warpgroup skips a relation none of its rows has. The Wb_j
// stream through two shared buffers by cp.async, j + 1 loading while j
// multiplies (one barrier per relation); three warpgroups share each
// weight load and each halo row. fp32 d_temp (lane_layer's) is split into
// bf16 hi and lo = rnd(d_temp − hi) and both go through the product into
// one fp32 accumulator: the operand then carries ~16 bits, where one
// rounding to bf16 would carry 8 and sit outside the fp32 plain backward's
// tolerance. A bf16 cotangent (band_conv's) is exact in hi alone.
//
// At a row width W below C (64: lane_layer's half-width model) the same
// 128-column halo tile and buffers: d_temp and d_y rows read W wide (zeros
// past W), the [W x W] Wb_j zero-padded into the [C x C] core tiles, K cut
// to W (the A fragments past W are zero), only W columns of dx stored.
constexpr int DX_WGS = 3;                      // warpgroups per block
constexpr int DX_THREADS = 128 * DX_WGS;
constexpr int DX_ROWS = 64 * DX_WGS;           // output rows per block
constexpr int DX_HROWS = DX_ROWS + 2 * HALO;   // halo tile rows
constexpr int DX_HLD = C + 8;                  // halo tile row stride (elements)

template <typename D>
inline int band_t_tc_smem() {
  const int halves = std::is_same<D, float>::value ? 2 : 1;
  return halves * DX_HROWS * DX_HLD * (int)sizeof(bf16) + 2 * tc::tiles_bytes(C) +
         MAXJ * DX_HROWS;
}

// Wb_j (row-major [C][C] bf16) into core tiles by cp.async, one commit group;
// a [W x W] one into the top-left of the [C x C] tiles, zeros elsewhere.
template <int W = C>
__device__ __forceinline__ void prefetch_weight(uint8_t* dst, const tc::Tiles& t,
                                                const bf16* src) {
  for (int i = threadIdx.x; i < C * C / 8; i += blockDim.x) {
    const int r = ((i >> 7) << 3) + (i & 7), cb = (i >> 3) & 15;
    if constexpr (W == C) {
      cp_async16(dst + tc::tile_off(t, r, cb * 8), src + r * C + cb * 8);
    } else {
      const bool in = r < W && cb * 8 < W;
      cp_async16_zfill(dst + tc::tile_off(t, r, cb * 8), in ? src + r * W + cb * 8 : src,
                       in ? 16 : 0);
    }
  }
  cp_async_commit();
}

// The bf16 band products of one DX_ROWS-row block on tensor cores, shared
// by lane_layer_tc_kernel (lane_layer.cu: acc from pre, W2 prefetched after
// the last relation) and band_conv_tc_kernel (band_conv.cu: acc from zero,
// no weight after):
//
//   acc = pre + Σ_j band_j[u] · feat[u + s_j] @ Wb_j    (pre null: 0)
//
// for warpgroup g's rows u = tile0 + 64g .. 64g + 63. The block's feat rows
// u − HALO .. u + DX_ROWS + HALO − 1 go into X_s once, as a row-major bf16
// halo tile (DX_HLD-element rows), by cp.async in one group with the first
// weight (Wb_0, or `after` without relations); M_s [MAXJ][DX_ROWS] takes
// band_j of the block's rows and act_s whether relation j has a row in
// warpgroup g's. The A operand of relation j sits at row offset HALO + s_j
// of the halo tile, which no shared-memory descriptor can address (8-row
// core matrices), so it goes through registers by `ldmatrix`, the
// fragment's rows zeroed where band_j[u] is 0; Wb_j is the B operand, read
// MN-major from core tiles in W_b (two buffers: j + 1, and `after` past the
// last relation, load while j multiplies). A warpgroup skips a relation
// none of its rows has. On return `after` (when given) is the one cp.async
// group in flight, into buffer nj & 1; without it no copy is.
//
// At a row width W below C (64: lane_layer's half-width model) the same
// 128-column halo tile, buffers and m64n128k16 products: feat rows read W
// wide (zeros past W), the [W x W] weights zero-padded into the [C x C]
// core tiles, pre zero past W, K cut to W (the A fragments past W would be
// zero); the accumulator's columns past W stay zero.
template <int W = C>
__device__ __forceinline__ void band_fwd_tc(float (&acc)[64], bf16* X_s, uint8_t* W_b,
                                            uint8_t* M_s, uint8_t (*act_s)[DX_WGS],
                                            const bf16* feat, const bf16* pre,
                                            const uint8_t* masks, const bf16* wb,
                                            const bf16* after, long tile0, int n, int nj,
                                            const Shifts& sh) {
  const tc::Tiles Wt = tc::tiles(W_b, C);  // the strides of both weight buffers
  constexpr int WB = tc::tiles_bytes(C);
  const int lane = threadIdx.x & 31, wg = threadIdx.x >> 7, wr = (threadIdx.x >> 5) & 3;

  // The halo tile by cp.async (zeros outside [0, n)) and the first weight
  // in one commit group.
  for (int i = threadIdx.x; i < DX_HROWS * (C / 8); i += DX_THREADS) {
    const int r = i >> 4, c = (i & 15) * 8;
    const long gr = tile0 - HALO + r;
    const bool in = gr >= 0 && gr < n && (W == C || c < W);
    cp_async16_zfill(X_s + r * DX_HLD + c, in ? feat + gr * W + c : feat, in ? 16 : 0);
  }
  const bf16* first = nj > 0 ? wb : after;
  if (first)
    prefetch_weight<W>(W_b, Wt, first);
  else
    cp_async_commit();
  for (int idx = threadIdx.x; idx < nj * DX_ROWS; idx += DX_THREADS) {
    const int j = idx / DX_ROWS, r = idx % DX_ROWS;
    M_s[idx] = tile0 + r < n ? masks[(long)j * n + tile0 + r] : 0;
  }
  // acc = pre at this thread's rows and columns (0 past n, or without pre).
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const long gr = tile0 + 64 * wg + tc::acc_row(i);
    float2 v = make_float2(0.f, 0.f);
    if (pre && gr < n && (W == C || tc::acc_col(i) < W))
      v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(pre + gr * W + tc::acc_col(i)));
    acc[i] = v.x;
    acc[i + 1] = v.y;
  }
  __syncthreads();
  for (int q = threadIdx.x >> 5; q < DX_WGS * nj; q += DX_THREADS / 32) {
    const int j = q / DX_WGS, w = q % DX_WGS;
    const uint8_t* m = M_s + j * DX_ROWS + 64 * w;
    const bool any = __any_sync(0xffffffffu, (m[lane] | m[lane + 32]) != 0);
    if (lane == 0) act_s[j][w] = any;
  }

  const int row0 = 64 * wg + 16 * wr;  // this warp's first row in the block
  const int g8 = lane >> 2;             // the fragment's rows row0 + g8, row0 + g8 + 8
  for (int j = 0; j < nj; ++j) {
    cp_async_wait<0>();  // weight j, the one group in flight
    tc::fence_smem();
    // Wb_j (and, at j = 0, the halo, masks and flags) in place for every
    // thread, and every warpgroup done with j − 1, whose buffer the next
    // weight (Wb_{j+1}, or `after` past the last relation) now takes.
    __syncthreads();
    const bf16* next = j + 1 < nj ? wb + (long)(j + 1) * W * W : after;
    if (next) prefetch_weight<W>(W_b + ((j + 1) & 1) * WB, Wt, next);
    if (act_s[j][wg]) {
      const int hr = HALO + row0 + sh.s[j];  // halo row of the warp's first A row
      const bool m0 = M_s[j * DX_ROWS + row0 + g8] != 0;
      const bool m1 = M_s[j * DX_ROWS + row0 + g8 + 8] != 0;
      uint32_t a[W / 16][4];
#pragma unroll
      for (int ks = 0; ks < W / 16; ++ks) {
        tc::ldm_a(a[ks], X_s, DX_HLD, hr, ks * 16);
        if (!m0) a[ks][0] = a[ks][2] = 0u;
        if (!m1) a[ks][1] = a[ks][3] = 0u;
      }
      const tc::Tiles Wj = tc::tiles(W_b + (j & 1) * WB, C);
      tc::fence_acc(acc);
      tc::fence();
#pragma unroll
      for (int ks = 0; ks < W / 16; ++ks) tc::mma_rs<1>(acc, a[ks], tc::desc(Wj, false, ks, 0));
      tc::commit();
      tc::wait_all();
      tc::fence_acc(acc);
    }
  }
  if (!after) cp_async_wait<0>();  // without relations: the halo's group
}

// The bf16 layer kernels' shared memory (lane_layer_tc_kernel,
// lane_plan_tc_kernel): the feat halo tile of band_t_tc_kernel's shape (rows
// u − HALO .. u + DX_ROWS + HALO − 1, stride DX_HLD), two weight buffers,
// the GN vectors and the band masks of the block's own rows (the forward
// masks by band_j[u]; the dx pass by band_j[p − s_j]).
inline int layer_tc_smem() {
  return DX_HROWS * DX_HLD * (int)sizeof(bf16) + 2 * tc::tiles_bytes(C) +
         4 * C * (int)sizeof(float) + MAXJ * DX_ROWS;
}

// gn_s = g1w, g1b, g2w, g2b (4 x C fp32; [W] vectors zero-padded to C).
template <int W = C>
__device__ __forceinline__ void load_gn(float* gn_s, const float* g1w, const float* g1b,
                                        const float* g2w, const float* g2b) {
  for (int i = threadIdx.x; i < 4 * C; i += blockDim.x) {
    const float* v = i < C ? g1w : i < 2 * C ? g1b : i < 3 * C ? g2w : g2b;
    gn_s[i] = W == C || (i & (C - 1)) < W ? v[i & (C - 1)] : 0.f;
  }
}

// acc (warpgroup rows r0 .. r0 + 63 of the block, the m64n128 accumulator
// layout) += the bf16 rows [blo + lo_s[r], blo + hi_s[r]) of msg [slots, W]
// of each of the thread's two rows r, in order: a quad of lanes reads a
// row's 16-byte column slices, each thread the two columns it holds
// (columns 8k + acc_col(0), k < W / 8). At a row width W below C the
// accumulators of the columns at W and past it (k ≥ W / 8) are not touched
// and stay exactly zero, as the tail's GN over W needs.
template <int W = C>
__device__ __forceinline__ void add_runs_tc(float (&acc)[64], const bf16* msg, long blo,
                                            const int* lo_s, const int* hi_s, int r0) {
  const int c0 = tc::acc_col(0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + tc::acc_row(2 * h);
    for (long p = blo + lo_s[r]; p < blo + hi_s[r]; ++p) {
      const __nv_bfloat162* m = reinterpret_cast<const __nv_bfloat162*>(msg + p * W + c0);
      float2 v[W / 8];
#pragma unroll
      for (int k = 0; k < W / 8; ++k) v[k] = __bfloat1622float2(m[4 * k]);
#pragma unroll
      for (int k = 0; k < W / 8; ++k) {
        acc[4 * k + 2 * h] += v[k].x;
        acc[4 * k + 2 * h + 1] += v[k].y;
      }
    }
  }
}

// The tail of the bf16 layer kernels on warpgroup wg's 64 rows, acc holding
// temp and W2 landed in weight buffer nj & 1 (band_fwd_tc's `after`):
// temp_out ← temp when given (fp32, bitwise what the tail consumes), then
// h = rnd(relu(GN1(temp))) as the A fragments of z = h @ W2 in the registers
// it was computed in, and out = relu(GN2(z) + feat), the residual from the
// halo tile (tail_fwd.cuh). At a row width W below C: temp's and out's
// first W columns stored (W-wide rows), GN statistics over W, gn_s zero
// past W (load_gn<W>), W2 zero-padded (band_fwd_tc<W>).
template <int W = C>
__device__ __forceinline__ void layer_tail_tc(float (&acc)[64], const bf16* X_s,
                                              const uint8_t* W_b, const float* gn_s,
                                              bf16* out, float* temp_out, long tile0, int n,
                                              int nj, float eps) {
  const int r0 = 64 * (threadIdx.x >> 7);
  if (temp_out) {
#pragma unroll
    for (int i = 0; i < W / 2; i += 2) {
      const long gr = tile0 + r0 + tc::acc_row(i);
      if (gr < n)
        *reinterpret_cast<float2*>(temp_out + gr * W + tc::acc_col(i)) =
            make_float2(acc[i], acc[i + 1]);
    }
  }
  uint32_t ha[C / 16][4];
  tail::gn_relu_frags<W>(acc, gn_s, gn_s + C, eps, ha);
  tail::frag_mm<W>(acc, ha, tc::tiles(W_b + (nj & 1) * tc::tiles_bytes(C), C));
  tail::gn_res_relu<W>(
      acc, gn_s + 2 * C, gn_s + 3 * C, eps,
      [&](int r, int c) {
        return __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(X_s + (HALO + r0 + r) * DX_HLD + c));
      },
      [&](int r, int c, float y0, float y1) {
        const long gr = tile0 + r0 + r;
        if (gr < n)
          *reinterpret_cast<__nv_bfloat162*>(out + gr * W + c) = __floats2bfloat162_rn(y0, y1);
      });
}

// PLAN (lane_plan.cu): dx[p] also adds p's run of the plan's transposed
// messages pm [slots, W] (bf16, each rounded as written), at the
// positions whose source key pseg is p, in position order, before the store.
template <typename D, bool PLAN = false, int W = C>
__global__ void __launch_bounds__(DX_THREADS, 1)
band_t_tc_kernel(const D* __restrict__ dtemp, const float* __restrict__ dy,
                 const uint8_t* __restrict__ masks, const bf16* __restrict__ wb,
                 bf16* __restrict__ dx, int n, int nj, Shifts sh, const bf16* __restrict__ pm,
                 const long long* __restrict__ pseg, long slots) {
  constexpr bool SPLIT = std::is_same<D, float>::value;
  extern __shared__ float4 smem4[];
  bf16* Hi_s = reinterpret_cast<bf16*>(smem4);        // [DX_HROWS][DX_HLD] hi
  bf16* Lo_s = Hi_s + DX_HROWS * DX_HLD;              // lo (SPLIT only)
  uint8_t* W_b = reinterpret_cast<uint8_t*>(Hi_s + (SPLIT ? 2 : 1) * DX_HROWS * DX_HLD);
  uint8_t* M_s = W_b + 2 * tc::tiles_bytes(C);        // [MAXJ][DX_HROWS] band masks
  __shared__ uint8_t act_s[MAXJ][DX_WGS];             // relation j in warpgroup g's rows
  const tc::Tiles Wt = tc::tiles(W_b, C);  // the strides of both weight buffers
  const long tile0 = (long)blockIdx.x * DX_ROWS;
  const int lane = threadIdx.x & 31, wg = threadIdx.x >> 7, wr = (threadIdx.x >> 5) & 3;

  if (nj > 0) prefetch_weight<W>(W_b, Wt, wb);
  // The halo tile: hi (and lo) of rows tile0 − HALO + r, zero outside [0, n),
  // HALO_BATCH loads in flight per thread.
  constexpr int HALO_BATCH = 8, HALO_ITEMS = DX_HROWS * (C / 4);
  for (int i0 = threadIdx.x; i0 < HALO_ITEMS; i0 += HALO_BATCH * DX_THREADS) {
    float4 v[HALO_BATCH];
#pragma unroll
    for (int k = 0; k < HALO_BATCH; ++k) {
      const int idx = i0 + k * DX_THREADS, r = idx / (C / 4), c4 = (idx % (C / 4)) * 4;
      const long gr = tile0 - HALO + r;
      v[k] = (idx < HALO_ITEMS && gr >= 0 && gr < n && (W == C || c4 < W))
                 ? load4<D>(dtemp + gr * W + c4)
                 : zero4();
    }
#pragma unroll
    for (int k = 0; k < HALO_BATCH; ++k) {
      const int idx = i0 + k * DX_THREADS, r = idx / (C / 4), c4 = (idx % (C / 4)) * 4;
      if (idx >= HALO_ITEMS) break;
      __nv_bfloat162* hp = reinterpret_cast<__nv_bfloat162*>(Hi_s + r * DX_HLD + c4);
      hp[0] = __floats2bfloat162_rn(v[k].x, v[k].y);
      hp[1] = __floats2bfloat162_rn(v[k].z, v[k].w);
      if (SPLIT) {
        const float2 h0 = __bfloat1622float2(hp[0]), h1 = __bfloat1622float2(hp[1]);
        __nv_bfloat162* lp = reinterpret_cast<__nv_bfloat162*>(Lo_s + r * DX_HLD + c4);
        lp[0] = __floats2bfloat162_rn(v[k].x - h0.x, v[k].y - h0.y);
        lp[1] = __floats2bfloat162_rn(v[k].z - h1.x, v[k].w - h1.y);
      }
    }
  }
  constexpr int MASK_PER = (MAXJ * DX_HROWS + DX_THREADS - 1) / DX_THREADS;
#pragma unroll
  for (int k = 0; k < MASK_PER; ++k) {
    const int idx = threadIdx.x + k * DX_THREADS;
    if (idx < nj * DX_HROWS) {
      const int j = idx / DX_HROWS, r = idx % DX_HROWS;
      const long gr = tile0 - HALO + r;
      M_s[idx] = (gr >= 0 && gr < n) ? masks[(long)j * n + gr] : 0;
    }
  }
  __syncthreads();
  for (int q = threadIdx.x >> 5; q < DX_WGS * nj; q += DX_THREADS / 32) {
    const int j = q / DX_WGS, w = q % DX_WGS;
    const uint8_t* m = M_s + j * DX_HROWS + HALO + 64 * w - sh.s[j];
    const bool any = __any_sync(0xffffffffu, (m[lane] | m[lane + 32]) != 0);
    if (lane == 0) act_s[j][w] = any;
  }

  // acc = d_y (or 0) at this thread's rows and columns.
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const long gr = tile0 + 64 * wg + tc::acc_row(i);
    float2 v = make_float2(0.f, 0.f);
    if (dy && gr < n && (W == C || tc::acc_col(i) < W))
      v = *reinterpret_cast<const float2*>(dy + gr * W + tc::acc_col(i));
    acc[i] = v.x;
    acc[i + 1] = v.y;
  }
  const int row0 = 64 * wg + 16 * wr;  // this warp's first output row in the tile
  const int g8 = (lane >> 2);           // the fragment's rows row0 + g8, row0 + g8 + 8
  for (int j = 0; j < nj; ++j) {
    cp_async_wait<0>();  // Wb_j, the one group in flight
    tc::fence_smem();
    // Wb_j (and, at j = 0, the halo, masks and flags) in place for every
    // thread, and every warpgroup done with j − 1, whose buffer Wb_{j+1}
    // now takes.
    __syncthreads();
    if (j + 1 < nj)
      prefetch_weight<W>(W_b + ((j + 1) & 1) * tc::tiles_bytes(C), Wt,
                         wb + (long)(j + 1) * W * W);
    if (act_s[j][wg]) {
      const int hr = HALO + row0 - sh.s[j];  // halo row of the warp's first A row
      const bool m0 = M_s[j * DX_HROWS + hr + g8] != 0;
      const bool m1 = M_s[j * DX_HROWS + hr + g8 + 8] != 0;
      uint32_t ahi[W / 16][4], alo[SPLIT ? W / 16 : 1][4];
#pragma unroll
      for (int ks = 0; ks < W / 16; ++ks) {
        tc::ldm_a(ahi[ks], Hi_s, DX_HLD, hr, ks * 16);
        if (!m0) ahi[ks][0] = ahi[ks][2] = 0u;
        if (!m1) ahi[ks][1] = ahi[ks][3] = 0u;
        if constexpr (SPLIT) {
          tc::ldm_a(alo[ks], Lo_s, DX_HLD, hr, ks * 16);
          if (!m0) alo[ks][0] = alo[ks][2] = 0u;
          if (!m1) alo[ks][1] = alo[ks][3] = 0u;
        }
      }
      const tc::Tiles Wj = tc::tiles(W_b + (j & 1) * tc::tiles_bytes(C), C);
      tc::fence_acc(acc);
      tc::fence();
#pragma unroll
      for (int ks = 0; ks < W / 16; ++ks) {
        const uint64_t db = tc::desc(Wj, true, ks, 0);
        tc::mma_rs<0>(acc, ahi[ks], db);
        if constexpr (SPLIT) tc::mma_rs<0>(acc, alo[ks], db);
      }
      tc::commit();
      tc::wait_all();
      tc::fence_acc(acc);
    }
  }
  if constexpr (PLAN) {
    __shared__ int lo_s[DX_ROWS], hi_s[DX_ROWS];
    __shared__ long blk_s[2];
    seg::run_table<DX_ROWS>(pseg, slots, tile0, (int)min((long)DX_ROWS, n - tile0), lo_s,
                            hi_s, blk_s);
    add_runs_tc<W>(acc, pm, blk_s[0], lo_s, hi_s, 64 * wg);
  }
#pragma unroll
  for (int i = 0; i < W / 2; i += 2) {
    const long gr = tile0 + 64 * wg + tc::acc_row(i);
    if (gr < n)
      *reinterpret_cast<__nv_bfloat162*>(dx + gr * W + tc::acc_col(i)) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
  }
}

// The dx pass; with PLAN, plus the plan's transposed messages pm at the
// positions of the sorted source keys pseg [slots]. W: the rows' width.
template <typename T, typename D, bool PLAN = false, int W = C>
int launch_band_t(const D* dtemp, const float* dy, const uint8_t* masks, const T* wb, T* dx,
                  int n, int nj, const Shifts& sh, cudaStream_t stream,
                  const T* pm = nullptr, const long long* pseg = nullptr, long slots = 0) {
  if constexpr (std::is_same<T, bf16>::value) {
    const int smem = band_t_tc_smem<D>();
    cudaError_t e = set_smem((const void*)band_t_tc_kernel<D, PLAN, W>, smem);
    if (e != cudaSuccess) return (int)e;
    const int ntiles = (n + DX_ROWS - 1) / DX_ROWS;
    if (ntiles > 0)
      band_t_tc_kernel<D, PLAN, W><<<ntiles, DX_THREADS, smem, stream>>>(
          dtemp, dy, masks, wb, dx, n, nj, sh, pm, pseg, slots);
  } else {
    const int ntiles = (n + TM - 1) / TM;
    const int smem = (HALO_TILE + C * C) * (int)sizeof(float);
    cudaError_t e = set_smem((const void*)band_t_kernel<T, D, PLAN, W>, smem);
    if (e != cudaSuccess) return (int)e;
    if (ntiles > 0)
      band_t_kernel<T, D, PLAN, W><<<ntiles, NT, smem, stream>>>(dtemp, dy, masks, wb, dx, n,
                                                                 nj, sh, pm, pseg, slots);
  }
  return (int)cudaGetLastError();
}

// The fp32 dWb pass: block (p, j) sums (band_j[u] · feat[u + s_j])ᵀ rnd(d_temp[u]) over
// the tiles p, p + splits, ... and writes its partial part[p][j] [W][W] (W-wide
// rows read with zeros past W).
template <typename T, typename D, int W = C>
__global__ void __launch_bounds__(NT)
band_dw_kernel(const T* __restrict__ feat, const D* __restrict__ dtemp,
               const uint8_t* __restrict__ masks, float* __restrict__ part, int n, int nj,
               Shifts sh) {
  extern __shared__ float4 smem4[];
  float* A_s = reinterpret_cast<float*>(smem4);  // [TM][LDA] band_j[u] · feat[u + s_j]
  float* B_s = A_s + TM * LDA;                   // [TM][LDA] rnd(d_temp[u])
  const int j = blockIdx.y, s = sh.s[j];
  const int ntiles = (n + TM - 1) / TM;
  float accW[8][8];
  zero_tn(accW);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    __syncthreads();  // the previous tile's product is done
    for (int idx = threadIdx.x; idx < TM * (C / 4); idx += NT) {
      const int r = idx / (C / 4), c4 = (idx % (C / 4)) * 4;
      const long u = (long)tile * TM + r;
      float4 a = zero4(), b = zero4();
      if (u < n && (W == C || c4 < W)) {
        b = rnd4<T>(load4<D>(dtemp + u * W + c4));
        const long v = u + s;
        if (v >= 0 && v < n && masks[(long)j * n + u]) a = load4<T>(feat + v * W + c4);
      }
      *reinterpret_cast<float4*>(A_s + r * LDA + c4) = a;
      *reinterpret_cast<float4*>(B_s + r * LDA + c4) = b;
    }
    __syncthreads();
    mm_tn(A_s, B_s, TM, accW);
  }
  store_tn<W>(part + ((long)blockIdx.x * nj + j) * W * W, accW, false);
}

// The bf16 dWb pass on tensor cores: the same (split, j) blocks and the
// same sum, dWb_j = Aᵀ B over node rows u, with K running over the rows.
// Per 64-row stage the block copies A = band_j[u] · feat[u + s_j] and
// B = rnd(d_temp[u]) (the row pass's dpre, already rounded to bf16) into
// shared core tiles (u along the rows, channels along the columns: both
// operands MN-major, which wgmma takes for 16-bit types); warpgroup g owns
// input channels 64g .. 64g+63 of dWb_j, 64 fp32 accumulators per thread
// across all of the block's stages. What bounds it is the loads (each of
// the 12 relations' blocks reads feat and dpre), so the copies are
// cp.async into a ring of DW_STAGES stages, two stages in flight while the
// tensor cores work on a third; a row whose band mask is 0 (or whose
// shifted source falls outside [0, n)) is a zero-filled copy, its mask
// byte loaded a stage before the copy is issued. At a row width W below C
// the operands' columns past W are zero-filled copies, warpgroup 1 (input
// channels 64 .. 127, all padding at W = 64) skips its products, and the
// partial is [W][W].
constexpr int DW_ROWS = 64;   // node rows per stage
constexpr int DW_STAGES = 3;  // stages in the ring

inline int band_dw_tc_smem() { return DW_STAGES * 2 * tc::tiles_bytes(DW_ROWS); }

template <int W = C>
__global__ void __launch_bounds__(NT)
band_dw_tc_kernel(const bf16* __restrict__ feat, const bf16* __restrict__ dt,
                  const uint8_t* __restrict__ masks, float* __restrict__ part, int n, int nj,
                  Shifts sh) {
  extern __shared__ float4 smem4[];
  uint8_t* buf = reinterpret_cast<uint8_t*>(smem4);  // [DW_STAGES][A, B] core tiles
  constexpr int TB = tc::tiles_bytes(DW_ROWS);
  constexpr int PER = DW_ROWS * C / 8 / NT;  // 16-byte chunks per thread per operand
  const int j = blockIdx.y, s = sh.s[j], wg = threadIdx.x >> 7;
  const int ntiles = (n + DW_ROWS - 1) / DW_ROWS, step = gridDim.x;
  const tc::Tiles t0 = tc::tiles(buf, DW_ROWS);  // offsets are the same in every stage

  // This thread's chunk k of a stage: chunk i = threadIdx.x + k*NT is row
  // ((i >> 7) << 3) + (i & 7), columns 8 * ((i >> 3) & 15) ...
  auto row_of = [](int k) {
    const int i = threadIdx.x + k * NT;
    return ((i >> 7) << 3) + (i & 7);
  };
  auto col_of = [](int k) { return (((threadIdx.x + k * NT) >> 3) & 15) * 8; };
  uint8_t mk[PER];  // band_j of the rows of the next stage to issue
  auto load_masks = [&](int tile) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const long u = (long)tile * DW_ROWS + row_of(k);
      mk[k] = (tile < ntiles && u < n) ? masks[(long)j * n + u] : 0;
    }
  };
  auto issue = [&](int tile, int stage) {  // one commit group, empty past the last tile
    uint8_t* A_b = buf + stage * 2 * TB;
    if (tile < ntiles) {
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int r = row_of(k), c = col_of(k);
        const uint32_t off = tc::tile_off(t0, r, c);
        const long u = (long)tile * DW_ROWS + r, v = u + s;
        const bool b_in = u < n && (W == C || c < W), a_in = b_in && mk[k] && v >= 0 && v < n;
        cp_async16_zfill(A_b + off, a_in ? feat + v * W + c : feat, a_in ? 16 : 0);
        cp_async16_zfill(A_b + TB + off, b_in ? dt + u * W + c : dt, b_in ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  float acc[64];
  tc::zero(acc);
  const int first = blockIdx.x;
  load_masks(first);
  issue(first, 0);
  load_masks(first + step);
  issue(first + step, 1);
  load_masks(first + 2 * step);
  for (int k = 0; first + k * step < ntiles; ++k) {
    cp_async_wait<1>();  // stage k landed (k + 1 may be in flight)
    tc::fence_smem();
    // stage k in place for every thread; every warpgroup done with k − 1,
    // whose buffer stage k + 2 now takes
    __syncthreads();
    issue(first + (k + 2) * step, (k + 2) % DW_STAGES);
    load_masks(first + (k + 3) * step);
    const int st = k % DW_STAGES;
    const tc::Tiles A = tc::tiles(buf + st * 2 * TB, DW_ROWS),
                    B = tc::tiles(buf + st * 2 * TB + TB, DW_ROWS);
    if (W == C || 64 * wg < W) {
      tc::fence_acc(acc);
      tc::fence();
      tc::mm<DW_ROWS / 16, false, false>(acc, A, 64 * wg, B);
      tc::commit();
      tc::wait_all();
      tc::fence_acc(acc);
    }
  }
  cp_async_wait<0>();  // no copy lands after the block is gone
  float* P = part + ((long)blockIdx.x * nj + j) * W * W;
  if (W == C || 64 * wg < W) {
#pragma unroll
    for (int i = 0; i < W / 2; i += 2)
      *reinterpret_cast<float2*>(P + (64 * wg + tc::acc_row(i)) * W + tc::acc_col(i)) =
          make_float2(acc[i], acc[i + 1]);
  }
}

// The dWb pass on `splits` x nj blocks, then its partials summed in split
// order into dwb [nj, W, W].
template <typename T, typename D, int W = C>
int launch_band_dw(const T* feat, const D* dtemp, const uint8_t* masks, float* part,
                   float* dwb, int n, int nj, const Shifts& sh, int splits, cudaStream_t stream) {
  cudaError_t e;
  if (nj > 0 && splits > 0) {
    if constexpr (std::is_same<T, bf16>::value) {
      static_assert(std::is_same<D, bf16>::value, "the bf16 dWb pass reads rnd(d_temp) in bf16");
      const int smem = band_dw_tc_smem();
      e = set_smem((const void*)band_dw_tc_kernel<W>, smem);
      if (e != cudaSuccess) return (int)e;
      band_dw_tc_kernel<W><<<dim3(splits, nj), NT, smem, stream>>>(feat, dtemp, masks, part, n,
                                                                    nj, sh);
    } else {
      const int smem = 2 * TM * LDA * (int)sizeof(float);
      e = set_smem((const void*)band_dw_kernel<T, D, W>, smem);
      if (e != cudaSuccess) return (int)e;
      band_dw_kernel<T, D, W><<<dim3(splits, nj), NT, smem, stream>>>(feat, dtemp, masks, part,
                                                                       n, nj, sh);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)reduce_partials(part, dwb, splits, (long)nj * W * W, stream);
}

}  // namespace lgk
