// Fused LaneConv residual layer, forward.
//
// Replaces lanegcn_tpu/ops/pallas_lane_layer.py `_fwd_kernel` / `_fwd_impl`
// (the Pallas kernel behind `fused_lane_layer`). Per node row u:
//
//   temp = pre + Σ_{j<J} band_j[u] · feat[u + s_j] @ Wb_j   (|s_j| ≤ 32, rows
//                                                           outside [0,N) read 0)
//   out  = relu(GN2(rnd(relu(GN1(temp))) @ W2) + feat)
//
// What bounds it: a [128 x 128] band product on every row its mask selects
// and the second product on every row (64 GFLOP at the 256-scenario bench
// pack, N = 208,896, ~8 masked band rows per row) against ~163 MB of
// traffic: at the bf16 tensor-core rate it is operation-bound (0.065 ms).
// For training the forward also writes temp (fp32, bitwise the value the
// tail consumed) when the caller passes `temp_out`; the eval path passes
// none. Two instantiations:
//   bf16 (lane_layer_tc_kernel, the path that serves and trains): every
//     product on wgmma (common.cuh `tc`), the layout of lane_band.cuh's
//     band_t_tc_kernel mirrored. A block of three warpgroups owns 192 rows
//     u (warpgroup g: rows 64g .. 64g+63) and holds feat rows u − 32 ..
//     u + 223 once, as a row-major bf16 halo tile (272-byte rows): the A
//     operand of relation j sits at row offset 32 + s_j, which no
//     shared-memory descriptor can address (8-row core matrices), so it goes
//     through registers by `ldmatrix`, the fragment's rows zeroed where
//     band_j[u] is 0; Wb_j is the B operand, read MN-major from core tiles.
//     A warpgroup skips a relation none of its rows has. The weights stream
//     through two shared buffers by cp.async, j + 1 (and W2 after the last
//     relation) loading while j multiplies (lane_band.cuh band_fwd_tc,
//     shared with band_conv.cu's bf16 forward). The accumulator starts from
//     pre and ends as temp, in registers; GN1 takes each row's statistics from
//     its quad of lanes (a row's 128 columns sit in 4 lanes), and
//     h = rnd(relu(GN1(temp))) becomes the A fragments of z = h @ W2 in the
//     registers it was computed in (one k16 slice of an m64n128 accumulator
//     is the register-A fragment's layout); GN2, the residual from the halo
//     tile and the ReLU follow in registers, stored in bf16 (tail_fwd.cuh,
//     shared with row_tail.cu's bf16 forward).
//   fp32 (lane_layer_kernel, the parity path): 64-row tiles with a ±32-row
//     fp32 halo, the band products and the tail on CUDA cores in fp32
//     (lane_band.cuh band_fwd, layer_tail; register-blocked 4 x 8 per
//     thread); wgmma has no fp32 operands, and this path is what the parity
//     checks hold to the CPU. lane_plan.cu runs the same band_fwd /
//     layer_tail in fp32, and in bf16 the band loop and the tail
//     (lane_band.cuh band_fwd_tc, layer_tail_tc) with the plan's messages
//     added between them; band_conv.cu runs band_fwd in fp32 and
//     band_fwd_tc in bf16.
// The band masks stay compact ([J, N] bytes) instead of padded planes.
//
// Width: the forward also runs on W = 64-wide rows (MapNet's and M2M's
// LaneConv layers where n_map = 64), both kernels templated on W by the
// padded route of common.cuh: feat and pre rows read W wide into the same
// 128-column tiles (the bf16 halo tile keeps its ±32-row layout, DX_HROWS x
// DX_HLD), the [W x W] Wb_j and W2 zero-padded to 128 x 128 in shared
// memory, the GN affines zero past W, GN1's and GN2's statistics over W
// columns (a quad of lanes holds a row's 128 accumulator columns, half of
// them padding at 64: tc::acc_row_stats<W> sums only the first W), only W
// columns of out and temp stored. The bf16 products keep m64n128k16 with K
// cut to W (half of N multiplies zero columns). At W = 128 each kernel
// compiles to the code it was before the width existed. The backward takes
// W = 64 the same way (below). Both also take W = 256, on kernels of their
// own (the forward lane_layer_wide_kernel and lane_layer_wide_tc_kernel,
// wide.cuh; the backward's passes band_t_wide_kernel,
// band_t_wide_tc_kernel and wide_bwd.cuh's; below).
//
// Backward (`lane_layer_bwd`): replaces pallas_lane_layer.py `_bwd_kernel` /
// `_bwd_impl`. It consumes the saved temp:
//
//   row pass   (tail_bwd.cuh)  d_y, d_temp = GN1ᵀ(rnd(GN2ᵀ(d_y)) @ W2ᵀ ⊙ relu'),
//                              dW2, dGN; writes dpre = d_temp, and d_temp, d_y in fp32
//   band pass  dx[p] = d_y[p] + Σ_j band_j[p − s_j] · d_temp[p − s_j] @ Wb_jᵀ
//   dWb pass   dWb_j = Σ_u (band_j[u] · feat[u + s_j])ᵀ rnd(d_temp[u])
//
// What bounds it: two band products on the masked band rows (2 x 56.7 GFLOP
// at the 256-scenario pack) and three [N x 128] x [128 x 128] products
// against ~323 MB: operation-bound at the bf16 matrix rate. The bf16
// instantiation runs all three passes on the tensor cores (wgmma:
// tail_bwd.cuh's tail_bwd_tc_kernel, lane_band.cuh's band_t_tc_kernel and
// band_dw_tc_kernel); the dx pass splits the fp32 d_temp into bf16 hi and
// lo so that its operand keeps ~16 bits. The fp32 instantiation keeps the
// CUDA-core products (mm_64x128, mm_tn), exact to fp32 reorder for the
// parity checks. The halo: the band transpose reads
// d_temp at ±32 rows, which the TPU kernel recomputed per 1024-row tile
// (+6 %); a 64-row tile here would recompute 2x the tail, so the row pass
// writes d_temp once (fp32, 107 MB) and the band pass reads it with its halo
// from L2/HBM. Parameter gradients: the row pass keeps dW2/dGN per block
// (one block per SM); dWb runs as (split, j) blocks, each summing its
// slice of tiles into registers (an 8 x 8 block per thread in fp32, a
// warpgroup's 64 wgmma accumulators in bf16), so the partial workspace is
// splits x 12 x 64 KB rather than one [12, 128, 128] per tile; a second
// pass sums the partials in split order (deterministic).
//
// Width: the backward's three passes also run on W = 64-wide rows, each
// templated on W by the padded route of common.cuh: the row pass is
// tail_bwd.cuh's at W (temp, feat, g read W wide; dW2 and dGN W x W and W);
// the dx pass keeps band_t_tc_kernel's 128-column halo tile, d_temp and d_y
// read W wide with zeros past W, the [W x W] Wb_j zero-padded in the core
// tiles, K cut to W, W columns of dx stored; the dWb pass zero-fills the
// operands past W, its second warpgroup (input channels 64 .. 127, all
// padding) skips its products, and each partial is W x W. The workspaces
// are W wide: d_temp, d_y [n, W], part_band splits x nj x W*W. At W = 128
// each kernel compiles to the code it was before the width existed;
// lane_plan.cu's PLAN instantiation of the dx pass stays at 128.
#include "lane_band.cuh"
#include "wide_bwd.cuh"

using namespace lgk;

namespace {

template <typename T, int W>
__global__ void __launch_bounds__(NT)
lane_layer_kernel(const T* __restrict__ feat, const T* __restrict__ pre,
                  const uint8_t* __restrict__ masks, const T* __restrict__ wb,
                  const T* __restrict__ w2, const float* __restrict__ g1w,
                  const float* __restrict__ g1b, const float* __restrict__ g2w,
                  const float* __restrict__ g2b, T* __restrict__ out,
                  float* __restrict__ temp_out, int n, int nj, Shifts sh, float eps) {
  extern __shared__ float4 smem4[];
  float* X_s = reinterpret_cast<float*>(smem4);   // [TM + 2*HALO][LDA]
  float* T_s = X_s + HALO_TILE;                   // [TM][LDA]
  float* W_s = T_s + TM * LDA;                    // [C][C]
  const long tile0 = (long)blockIdx.x * TM;

  load_halo<T, W>(X_s, feat, tile0, n);
  float acc[4][8];
  band_fwd<T, W>(X_s, W_s, pre, masks, wb, tile0, n, nj, sh, acc);
  store_acc(T_s, acc);
  __syncthreads();
  layer_tail<T, W>(X_s, T_s, W_s, w2, g1w, g1b, g2w, g2b, out, temp_out, tile0, n, eps);
}

// The bf16 forward on tensor cores: DX_WGS = 3 warpgroups, DX_ROWS = 192
// rows u a block, shared memory as lane_band.cuh `layer_tc_smem` lays it out.
template <int W>
__global__ void __launch_bounds__(DX_THREADS, 1)
lane_layer_tc_kernel(const bf16* __restrict__ feat, const bf16* __restrict__ pre,
                     const uint8_t* __restrict__ masks, const bf16* __restrict__ wb,
                     const bf16* __restrict__ w2, const float* __restrict__ g1w,
                     const float* __restrict__ g1b, const float* __restrict__ g2w,
                     const float* __restrict__ g2b, bf16* __restrict__ out,
                     float* __restrict__ temp_out, int n, int nj, Shifts sh, float eps) {
  extern __shared__ float4 smem4[];
  bf16* X_s = reinterpret_cast<bf16*>(smem4);                        // [DX_HROWS][DX_HLD] feat
  uint8_t* W_b = reinterpret_cast<uint8_t*>(X_s + DX_HROWS * DX_HLD);  // [2] weight core tiles
  float* gn_s = reinterpret_cast<float*>(W_b + 2 * tc::tiles_bytes(C));  // g1w, g1b, g2w, g2b
  uint8_t* M_s = reinterpret_cast<uint8_t*>(gn_s + 4 * C);          // [MAXJ][DX_ROWS] band_j[u]
  __shared__ uint8_t act_s[MAXJ][DX_WGS];  // relation j in warpgroup g's rows
  const long tile0 = (long)blockIdx.x * DX_ROWS;

  load_gn<W>(gn_s, g1w, g1b, g2w, g2b);
  // acc = temp = pre + the band products; W2 in flight after them.
  float acc[64];
  band_fwd_tc<W>(acc, X_s, W_b, M_s, act_s, feat, pre, masks, wb, w2, tile0, n, nj, sh);
  cp_async_wait<0>();  // W2
  tc::fence_smem();
  __syncthreads();  // W2 (and, without relations, the halo and vectors) in place
  layer_tail_tc<W>(acc, X_s, W_b, gn_s, out, temp_out, tile0, n, nj, eps);
}

template <typename T, int W>
int launch(const void* feat, const void* pre, const uint8_t* masks, const void* wb,
           const void* w2, const float* g1w, const float* g1b, const float* g2w,
           const float* g2b, void* out, float* temp_out, int n, int nj, const Shifts& sh,
           float eps, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    const int smem = layer_tc_smem();
    cudaError_t err = set_smem((const void*)lane_layer_tc_kernel<W>, smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (n + DX_ROWS - 1) / DX_ROWS;
    if (blocks > 0)
      lane_layer_tc_kernel<W><<<blocks, DX_THREADS, smem, stream>>>(
          (const bf16*)feat, (const bf16*)pre, masks, (const bf16*)wb, (const bf16*)w2, g1w, g1b,
          g2w, g2b, (bf16*)out, temp_out, n, nj, sh, eps);
  } else {
    const int smem = (HALO_TILE + TM * LDA + C * C) * (int)sizeof(float);
    cudaError_t err = set_smem((const void*)lane_layer_kernel<T, W>, smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (n + TM - 1) / TM;
    if (blocks > 0)
      lane_layer_kernel<T, W><<<blocks, NT, smem, stream>>>(
          (const T*)feat, (const T*)pre, masks, (const T*)wb, (const T*)w2, g1w, g1b, g2w, g2b,
          (T*)out, temp_out, n, nj, sh, eps);
  }
  return (int)cudaGetLastError();
}

// --- the forward at W = 256 (wide.cuh's tiling; the double-width model's
// LaneConv layers) ----------------------------------------------------------------
//
// fp32 (lane_layer_wide_kernel, the parity path): a block per 64-row tile
// holds the feat rows u − 32 .. u + 95 as a ±32-row fp32 halo tile; the
// band products run on CUDA cores (wide.cuh mm_rows, the A rows at the
// shifted halo rows, scaled by band_j[u]; each relation's product formed
// on its own, then added to temp, as the plain version adds them:
// wide_bwd.cuh add_rows; a relation none of the tile's rows has is
// skipped), temp goes back over the halo's first 64 rows (the
// residual is read from feat in device memory), then the tail: GN1 by
// warp-a-row, h @ W2, GN2, the residual and the ReLU. 162 KB of shared
// memory.
// bf16 (lane_layer_wide_tc_kernel): a block of two warpgroups owns 128 rows
// u and holds feat rows u − 32 .. u + 159 as a row-major bf16 halo tile
// (264-element rows, 99 KB): the A operand of relation j sits at row
// offset 32 + s_j, which no descriptor can address, so it goes through
// registers by ldmatrix (lane_layer_tc_kernel's route), one K half at a
// time, the fragment's rows zeroed where band_j[u] is 0. Each Wb_j is 128 KB
// at this width: the relations the block's rows have, then W2, stream
// through a ring of three quadrant slots (QuadRing), two quadrants ahead of
// the products; a warpgroup whose rows lack relation j skips its products.
// temp stays in two m64n128 accumulators from pre on. After a block
// barrier, h = rnd(relu(GN1(temp))) goes into each warpgroup's A operand
// over the halo tile (the residual is read from feat in device memory), z
// = h @ W2 on wgmma from shared memory, then GN2, the residual and the ReLU
// on the accumulators. What bounds it: 2·256² operations per masked band
// row and per row against 3·256 bf16 moved a row: operations.

__global__ void __launch_bounds__(NT)
lane_layer_wide_kernel(const float* __restrict__ feat, const float* __restrict__ pre,
                       const uint8_t* __restrict__ masks, const float* __restrict__ wb,
                       const float* __restrict__ w2, const float* __restrict__ g1w,
                       const float* __restrict__ g1b, const float* __restrict__ g2w,
                       const float* __restrict__ g2b, float* __restrict__ out,
                       float* __restrict__ temp_out, int n, int nj, Shifts sh, float eps) {
  constexpr int WW = wide::WW, LDW = wide::LDW;
  extern __shared__ float4 smem4[];
  float* X_s = reinterpret_cast<float*>(smem4);  // [TM + 2*HALO][LDW] feat, then temp
  float* W_s = X_s + (TM + 2 * HALO) * LDW;      // [KC][256]
  const long tile0 = (long)blockIdx.x * TM;
  const int warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < (TM + 2 * HALO) * (WW / 4); i += NT) {
    const int r = i / (WW / 4), c4 = (i % (WW / 4)) * 4;
    const long g = tile0 - HALO + r;
    *reinterpret_cast<float4*>(X_s + r * LDW + c4) =
        g >= 0 && g < n ? load4<float>(feat + g * WW + c4) : zero4();
  }
  float acc[8][8];  // temp = pre + the band products
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long g = tile0 + wide::wrow(i);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = pre && g < n ? pre[g * WW + wide::wcol(j)] : 0.f;
  }
  for (int j = 0; j < nj; ++j) {
    float m[8];
    bool any = false;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long g = tile0 + wide::wrow(i);
      m[i] = g < n && masks[(long)j * n + g] ? 1.f : 0.f;
      any |= m[i] != 0.f;
    }
    if (!__syncthreads_or(any)) continue;  // no row of the tile has relation j
    wide::add_rows(X_s, HALO + sh.s[j], m, wb + (long)j * WW * WW, W_s, acc, false);
  }
  __syncthreads();  // the band products are done with the halo tile
  float* T_s = X_s;
  wide::store_tile(T_s, acc);
  __syncthreads();
  if (temp_out) {
    for (int i = threadIdx.x; i < TM * (WW / 4); i += NT) {
      const int r = i / (WW / 4), c4 = (i % (WW / 4)) * 4;
      if (tile0 + r < n)
        *reinterpret_cast<float4*>(temp_out + (tile0 + r) * WW + c4) =
            *reinterpret_cast<const float4*>(T_s + r * LDW + c4);
    }
    __syncthreads();
  }
  wide::gn_relu_tile(T_s, g1w, g1b, eps);  // h = relu(GN1(temp))
  const float ones[8] = {1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f};
  wide::zero8(acc);
  wide::mm_rows(T_s, 0, ones, w2, W_s, acc);  // z = h @ W2
  __syncthreads();
  wide::store_tile(T_s, acc);
  __syncthreads();
  for (int r = warp; r < TM; r += NT / 32) {
    const long g = tile0 + r;
    if (g >= n) break;
    const wide::Row y = wide::gn_row(wide::ld_row(T_s + r * LDW), g2w, g2b, eps);
    const wide::Row res = wide::ld_row_g<float>(feat + g * WW);
    wide::st_row_g<float>(out + g * WW, wide::relu_row(wide::add_row(y, res)));
  }
}

constexpr int LW_WGS = 2;                      // warpgroups per block
constexpr int LW_THREADS = 128 * LW_WGS;
constexpr int LW_ROWS = 64 * LW_WGS;           // rows u per block
constexpr int LW_HROWS = LW_ROWS + 2 * HALO;   // halo tile rows
constexpr int LW_HLD = wide::WW + 8;           // halo tile row stride (elements)
constexpr int LW_RING = 3;                     // quadrant slots
static_assert(LW_WGS * 2 * wide::HB <= LW_HROWS * LW_HLD * (int)sizeof(bf16),
              "the A operands sit over the halo tile");

inline int lane_layer_wide_tc_smem() {
  return LW_HROWS * LW_HLD * (int)sizeof(bf16) + LW_RING * wide::QB +
         4 * wide::WW * (int)sizeof(float) + MAXJ * LW_ROWS;
}

// acc += band-masked halo rows @ Q for one quadrant (K half kh): the warp's
// 16 A rows from halo row hr on, by ldmatrix, rows g8 and g8 + 8 of the
// fragment zeroed where m0, m1 are false; Q read MN-major.
__device__ __forceinline__ void band_quadrant(float (&acc)[64], const bf16* X_s, int hr, int kh,
                                              bool m0, bool m1, const uint8_t* Q_b) {
  uint32_t f[C / 16][4];
#pragma unroll
  for (int ks = 0; ks < C / 16; ++ks) {
    tc::ldm_a(f[ks], X_s, LW_HLD, hr, kh * C + ks * 16);
    if (!m0) f[ks][0] = f[ks][2] = 0u;
    if (!m1) f[ks][1] = f[ks][3] = 0u;
  }
  const tc::Tiles B = tc::tiles(Q_b, C);
  tc::fence_acc(acc);
  tc::fence();
#pragma unroll
  for (int ks = 0; ks < C / 16; ++ks) tc::mma_rs<1>(acc, f[ks], tc::desc(B, false, ks, 0));
  tc::commit();
  tc::wait_all();
  tc::fence_acc(acc);
}

__global__ void __launch_bounds__(LW_THREADS, 1)
lane_layer_wide_tc_kernel(const bf16* __restrict__ feat, const bf16* __restrict__ pre,
                          const uint8_t* __restrict__ masks, const bf16* __restrict__ wb,
                          const bf16* __restrict__ w2, const float* __restrict__ g1w,
                          const float* __restrict__ g1b, const float* __restrict__ g2w,
                          const float* __restrict__ g2b, bf16* __restrict__ out,
                          float* __restrict__ temp_out, int n, int nj, Shifts sh, float eps) {
  constexpr int WW = wide::WW;
  extern __shared__ float4 smem4[];
  bf16* X_s = reinterpret_cast<bf16*>(smem4);                              // halo tile
  uint8_t* R_b = reinterpret_cast<uint8_t*>(X_s + LW_HROWS * LW_HLD);       // ring slots
  float* gn_s = reinterpret_cast<float*>(R_b + LW_RING * wide::QB);        // g1w, g1b, g2w, g2b
  uint8_t* M_s = reinterpret_cast<uint8_t*>(gn_s + 4 * WW);               // [MAXJ][LW_ROWS]
  __shared__ uint8_t act_s[MAXJ][LW_WGS];  // relation j in warpgroup g's rows
  __shared__ int jl_s[MAXJ + 1];           // the block's relations in order, then their count
  const long tile0 = (long)blockIdx.x * LW_ROWS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wg = threadIdx.x >> 7,
            wr = (threadIdx.x >> 5) & 3;

  for (int i = threadIdx.x; i < LW_HROWS * (WW / 8); i += LW_THREADS) {  // one group
    const int r = i >> 5, c = (i & 31) * 8;
    const long gr = tile0 - HALO + r;
    const bool in = gr >= 0 && gr < n;
    cp_async16_zfill(X_s + r * LW_HLD + c, in ? feat + gr * WW + c : feat, in ? 16 : 0);
  }
  cp_async_commit();
  for (int idx = threadIdx.x; idx < nj * LW_ROWS; idx += LW_THREADS) {
    const int j = idx / LW_ROWS, r = idx % LW_ROWS;
    M_s[idx] = tile0 + r < n ? masks[(long)j * n + tile0 + r] : 0;
  }
  for (int i = threadIdx.x; i < 4 * WW; i += LW_THREADS) {
    const float* v = i < WW ? g1w : i < 2 * WW ? g1b : i < 3 * WW ? g2w : g2b;
    gn_s[i] = v[i & (WW - 1)];
  }
  __syncthreads();
  for (int q = warp; q < LW_WGS * nj; q += LW_THREADS / 32) {
    const int j = q / LW_WGS, w = q % LW_WGS;
    const uint8_t* m = M_s + j * LW_ROWS + 64 * w;
    const bool any = __any_sync(0xffffffffu, (m[lane] | m[lane + 32]) != 0);
    if (lane == 0) act_s[j][w] = any;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int k = 0;
    for (int j = 0; j < nj; ++j)
      if (act_s[j][0] | act_s[j][1]) jl_s[k++] = j;
    jl_s[MAXJ] = k;
  }
  __syncthreads();
  const int nact = jl_s[MAXJ];
  const int* jl = jl_s;
  auto src = [=](int k) { return k < nact ? wb + (long)jl[k] * WW * WW : w2; };
  auto ring = wide::quad_ring<LW_RING>(R_b, src, 4 * (nact + 1));
  ring.start();

  float a[2][64];  // temp = pre + the band products, this warpgroup's 64 rows
#pragma unroll
  for (int n2 = 0; n2 < 2; ++n2) {
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const long gr = tile0 + 64 * wg + tc::acc_row(i);
      float2 v = make_float2(0.f, 0.f);
      if (pre && gr < n) v = wide::ld_pair(pre + gr * WW + wide::acc_col(n2, i));
      a[n2][i] = v.x;
      a[n2][i + 1] = v.y;
    }
  }
  const int row0 = 64 * wg + 16 * wr;  // this warp's first row in the block
  const int g8 = lane >> 2;             // the fragment's rows row0 + g8, row0 + g8 + 8
  for (int t = 0; t < nact; ++t) {
    const int j = jl[t];
    const bool on = act_s[j][wg];
    const bool m0 = M_s[j * LW_ROWS + row0 + g8] != 0, m1 = M_s[j * LW_ROWS + row0 + g8 + 8] != 0;
    const int hr = HALO + row0 + sh.s[j];  // halo row of the warp's first A row
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint8_t* Q_b = ring.take();
      if (on) band_quadrant(a[q >> 1], X_s, hr, q & 1, m0, m1, Q_b);
    }
  }
  const long r0 = tile0 + 64 * wg;
  if (temp_out) wide::store_rows<float>(temp_out, a, r0, n);
  __syncthreads();  // every warpgroup's band products are done with the halo tile
  uint8_t* H_b = reinterpret_cast<uint8_t*>(X_s) + wg * 2 * wide::HB;
  wide::gn_relu_to(H_b, a, gn_s, gn_s + WW, eps);  // h = rnd(relu(GN1(temp)))
  wide::zero2(a);
#pragma unroll
  for (int q = 0; q < 4; ++q) wide::mm_quadrant(a[q >> 1], H_b, q & 1, ring.take());  // z
  wide::gn_res_relu(
      a, gn_s + 2 * WW, gn_s + 3 * WW, eps,
      [&](int r, int c) {
        return r0 + r < n ? wide::ld_pair(feat + (r0 + r) * WW + c) : make_float2(0.f, 0.f);
      },
      [&](int r, int c, float y0, float y1) {
        if (r0 + r < n)
          *reinterpret_cast<__nv_bfloat162*>(out + (r0 + r) * WW + c) =
              __floats2bfloat162_rn(y0, y1);
      });
}

template <typename T>
int launch_wide(const void* feat, const void* pre, const uint8_t* masks, const void* wb,
                const void* w2, const float* g1w, const float* g1b, const float* g2w,
                const float* g2b, void* out, float* temp_out, int n, int nj, const Shifts& sh,
                float eps, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    const int smem = lane_layer_wide_tc_smem();
    cudaError_t err = set_smem((const void*)lane_layer_wide_tc_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (n + LW_ROWS - 1) / LW_ROWS;
    if (blocks > 0)
      lane_layer_wide_tc_kernel<<<blocks, LW_THREADS, smem, stream>>>(
          (const bf16*)feat, (const bf16*)pre, masks, (const bf16*)wb, (const bf16*)w2, g1w, g1b,
          g2w, g2b, (bf16*)out, temp_out, n, nj, sh, eps);
  } else {
    const int smem = (TM + 2 * HALO) * wide::LDW * (int)sizeof(float) + wide::CHUNK_BYTES;
    cudaError_t err = set_smem((const void*)lane_layer_wide_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (n + TM - 1) / TM;
    if (blocks > 0)
      lane_layer_wide_kernel<<<blocks, NT, smem, stream>>>(
          (const float*)feat, (const float*)pre, masks, (const float*)wb, (const float*)w2, g1w,
          g1b, g2w, g2b, (float*)out, temp_out, n, nj, sh, eps);
  }
  return (int)cudaGetLastError();
}

// --- the backward at W = 256 (wide_bwd.cuh; the double-width model trains) ----------
//
// The three passes of the 128-wide backward, each on the 256-wide tiling:
//   row pass  wide_bwd.cuh launch_tail_bwd on the saved fp32 temp (x = temp,
//             res = feat): dpre = rnd(d_temp), d_temp and d_y in fp32, and
//             dW2 and dGN by its own dW pass.
//   dx pass   dx[p] = d_y[p] + Σ_j band_j[p − s_j] · d_temp[p − s_j] @ Wb_jᵀ.
//     bf16 (band_t_wide_tc_kernel): 128-row blocks of two warpgroups, the
//     output in two m64n128 accumulators from d_y on. A [128 x 256] halo of
//     d_temp split into bf16 hi and lo does not fit beside the weights (202
//     KB), so the A operand of relation j, d_temp at rows p − s_j, goes
//     from device memory straight into the register-A fragments (hi and lo
//     of each fp32 pair, so that the operand keeps ~16 bits, as
//     band_t_tc_kernel's), four k-steps at a time, the rows zeroed where
//     band_j[p − s_j] is 0 or p − s_j lies outside [0, n); each Wb_j, four
//     128 KB quadrants, streams through a ring of BT_RING quadrant slots
//     (wide.cuh QuadRing) and is read K-major (quadrant (kh, nh) gives
//     output half kh from d_temp's columns nh·128..).
//     fp32 (band_t_wide_kernel): a block per 64-row tile with a ±32-row fp32
//     halo of d_temp, the products on CUDA cores (wide.cuh mm_rows, transposed).
//   dWb pass  dWb_j = Σ_u (band_j[u] · feat[u + s_j])ᵀ rnd(d_temp[u]) on
//     wide_bwd.cuh's weight-gradient pass: (splits, 4·nj) blocks, each one
//     [128 x 128] quadrant of one dWb_j, the partials splits x nj x 256²
//     fp32 summed in split order.
// What bounds it: the band transpose and dWb (2·2·256² operations per
// masked band row) and three 256-wide products per row, against 4·256 bf16
// and 256 fp32 moved a row: operations.

constexpr int BT_WGS = 2;
constexpr int BT_THREADS = 128 * BT_WGS;
constexpr int BT_ROWS = 64 * BT_WGS;
constexpr int BT_RING = 4;  // quadrant slots
constexpr int BT_KG = 4;    // k-steps whose fragments are loaded at once

__global__ void __launch_bounds__(BT_THREADS, 1)
band_t_wide_tc_kernel(const float* __restrict__ dtemp, const float* __restrict__ dy,
                      const uint8_t* __restrict__ masks, const bf16* __restrict__ wb,
                      bf16* __restrict__ dx, int n, int nj, Shifts sh) {
  constexpr int WW = wide::WW;
  extern __shared__ float4 smem4[];
  uint8_t* R_b = reinterpret_cast<uint8_t*>(smem4);  // the ring's quadrant slots
  const long tile0 = (long)blockIdx.x * BT_ROWS;
  const int lane = threadIdx.x & 31, wg = threadIdx.x >> 7, wr = (threadIdx.x >> 5) & 3;
  auto src = [=](int k) { return wb + (long)k * WW * WW; };
  auto ring = wide::quad_ring<BT_RING>(R_b, src, 4 * nj);
  ring.start();

  float a[2][64];  // dx = d_y + the band products, this warpgroup's 64 rows
  const long r0 = tile0 + 64 * wg;
  wide::load_acc<float>(a, dy, r0, n);
  // the fragment's rows: p0 = this warp's first row + lane / 4, and p0 + 8
  const long p0 = r0 + 16 * wr + (lane >> 2);
  const int cq = 2 * (lane & 3);  // the fragment's column pair within a k-step
  for (int j = 0; j < nj; ++j) {
    const long s0 = p0 - sh.s[j], s1 = s0 + 8;
    const bool m0 = s0 >= 0 && s0 < n && masks[(long)j * n + s0] != 0;
    const bool m1 = s1 >= 0 && s1 < n && masks[(long)j * n + s1] != 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const tc::Tiles B = tc::tiles(ring.take(), C);
      float(&acc)[64] = a[q & 1];
      const int kc = (q >> 1) * C;  // d_temp's columns: the quadrant's K half
#pragma unroll
      for (int kg = 0; kg < C / 16; kg += BT_KG) {
        uint32_t hi[BT_KG][4], lo[BT_KG][4];
#pragma unroll
        for (int kk = 0; kk < BT_KG; ++kk) {
          const int c = kc + 16 * (kg + kk) + cq;
          const float2 z = make_float2(0.f, 0.f);
          const float2 v[4] = {m0 ? wide::ld2<float>(dtemp, s0, c) : z,
                               m1 ? wide::ld2<float>(dtemp, s1, c) : z,
                               m0 ? wide::ld2<float>(dtemp, s0, c + 8) : z,
                               m1 ? wide::ld2<float>(dtemp, s1, c + 8) : z};
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            hi[kk][f] = tc::pack_bf2(v[f].x, v[f].y);
            const float2 h = unpack_bf2(hi[kk][f]);
            lo[kk][f] = tc::pack_bf2(v[f].x - h.x, v[f].y - h.y);
          }
        }
        tc::fence_acc(acc);
        tc::fence();
#pragma unroll
        for (int kk = 0; kk < BT_KG; ++kk) {
          const uint64_t db = tc::desc(B, true, kg + kk, 0);
          tc::mma_rs<0>(acc, hi[kk], db);
          tc::mma_rs<0>(acc, lo[kk], db);
        }
        tc::commit();
        tc::wait_all();
        tc::fence_acc(acc);
      }
    }
  }
  wide::store_rows<bf16>(dx, a, r0, n);
}

__global__ void __launch_bounds__(NT)
band_t_wide_kernel(const float* __restrict__ dtemp, const float* __restrict__ dy,
                   const uint8_t* __restrict__ masks, const float* __restrict__ wb,
                   float* __restrict__ dx, int n, int nj, Shifts sh) {
  constexpr int WW = wide::WW, LDW = wide::LDW;
  extern __shared__ float4 smem4[];
  float* D_s = reinterpret_cast<float*>(smem4);  // [TM + 2*HALO][LDW] d_temp
  float* W_s = D_s + (TM + 2 * HALO) * LDW;      // [KC][256]
  const long tile0 = (long)blockIdx.x * TM;
  for (int i = threadIdx.x; i < (TM + 2 * HALO) * (WW / 4); i += NT) {
    const int r = i / (WW / 4), c4 = (i % (WW / 4)) * 4;
    const long g = tile0 - HALO + r;
    *reinterpret_cast<float4*>(D_s + r * LDW + c4) =
        g >= 0 && g < n ? load4<float>(dtemp + g * WW + c4) : zero4();
  }
  float acc[8][8];  // dx = d_y + the band products
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long g = tile0 + wide::wrow(i);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = g < n ? dy[g * WW + wide::wcol(j)] : 0.f;
  }
  for (int j = 0; j < nj; ++j) {
    float m[8];
    bool any = false;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long src = tile0 + wide::wrow(i) - sh.s[j];
      m[i] = src >= 0 && src < n && masks[(long)j * n + src] ? 1.f : 0.f;
      any |= m[i] != 0.f;
    }
    if (!__syncthreads_or(any)) continue;  // no row of the tile has relation j
    wide::add_rows(D_s, HALO - sh.s[j], m, wb + (long)j * WW * WW, W_s, acc, true);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long g = tile0 + wide::wrow(i);
    if (g >= n) continue;
    *reinterpret_cast<float4*>(dx + g * WW + wide::wcol(0)) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(dx + g * WW + wide::wcol(4)) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// dWb's operands: A_j = band_j[u] · feat[u + s_j] (zero outside [0, n)),
// B_j = rnd(d_temp[u]), which the row pass wrote as dpre.
template <typename T>
struct BandSrc {
  const T* feat;
  const T* dt;
  const uint8_t* masks;
  Shifts sh;
  int n;
  const T* any;
  __device__ const T* a(int j, long u) const {
    const long v = u + sh.s[j];
    return masks[(long)j * n + u] && v >= 0 && v < n ? feat + v * wide::WW : nullptr;
  }
  __device__ const T* b(int, long u) const { return dt + u * wide::WW; }
};

template <typename T>
int launch_bwd_wide(const T* feat, const float* temp, const uint8_t* masks, const T* wb,
                    const T* w2, const float* g1w, const float* g1b, const float* g2w,
                    const float* g2b, const T* g, T* dx, T* dpre, float* dtemp, float* dy,
                    float* part_tail, float* part_band, float* grads_tail, float* dwb, int n,
                    int nj, const Shifts& sh, int tail_blocks, int splits, float eps,
                    cudaStream_t stream) {
  int err = wide::launch_tail_bwd<T, float>(temp, feat, g, w2, g1w, g1b, g2w, g2b, dpre, nullptr,
                                            dtemp, dy, part_tail, grads_tail, n, tail_blocks,
                                            eps, stream);
  if (err != 0) return err;
  cudaError_t e;
  if constexpr (std::is_same<T, bf16>::value) {
    const int smem = BT_RING * wide::QB;
    e = set_smem((const void*)band_t_wide_tc_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    const int blocks = (n + BT_ROWS - 1) / BT_ROWS;
    if (blocks > 0)
      band_t_wide_tc_kernel<<<blocks, BT_THREADS, smem, stream>>>(dtemp, dy, masks, wb, dx, n,
                                                                  nj, sh);
  } else {
    const int smem = (TM + 2 * HALO) * wide::LDW * (int)sizeof(float) + wide::CHUNK_BYTES;
    e = set_smem((const void*)band_t_wide_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    const int blocks = (n + TM - 1) / TM;
    if (blocks > 0)
      band_t_wide_kernel<<<blocks, NT, smem, stream>>>(dtemp, dy, masks, wb, dx, n, nj, sh);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return wide::launch_dw<T>(BandSrc<T>{feat, dpre, masks, sh, n, feat}, n, nj, splits, part_band,
                            dwb, stream);
}

template <typename T, int W>
int launch_bwd(const T* feat, const float* temp, const uint8_t* masks, const T* wb,
               const T* w2, const float* g1w, const float* g1b, const float* g2w,
               const float* g2b, const T* g, T* dx, T* dpre, float* dtemp, float* dy,
               float* part_tail, float* part_band, float* grads_tail, float* dwb, int n, int nj,
               const Shifts& sh, int tail_blocks, int splits, float eps, cudaStream_t stream) {
  int err = launch_tail_bwd<T, float, W>(temp, feat, g, w2, g1w, g1b, g2w, g2b, dpre, nullptr,
                                         dtemp, dy, part_tail, grads_tail, n, tail_blocks, eps,
                                         stream);
  if (err != 0) return err;
  err = launch_band_t<T, float, false, W>(dtemp, dy, masks, wb, dx, n, nj, sh, stream);
  if (err != 0) return err;
  // dWb's operand rnd(d_temp) is dpre, which the row pass wrote in T: half
  // the bytes of d_temp in bf16, each of the 12 relations' blocks reads it.
  return launch_band_dw<T, T, W>(feat, dpre, masks, part_band, dwb, n, nj, sh, splits, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (feat, pre, wb, w2, out); feat, pre, out
// [n, width], wb [nj, width, width], w2 [width, width], width 128, 64 or 256;
// masks [nj, n] bytes (0/1); GN vectors fp32 [width]; shifts: host array of
// nj ints; temp_out: fp32 [n, width] that receives temp, or null.
extern "C" int lane_layer_fwd(const void* feat, const void* pre, const void* masks,
                              const void* wb, const void* w2, const void* g1w,
                              const void* g1b, const void* g2w, const void* g2b, void* out,
                              void* temp_out, int n, int width, int nj, const void* shifts,
                              float eps, int dtype, void* stream) {
  Shifts sh;
  const int bad = make_shifts(nj, (const int*)shifts, &sh);
  if (bad) return bad;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* m = (const uint8_t*)masks;
  const float *a = (const float*)g1w, *b = (const float*)g1b, *c = (const float*)g2w,
              *d = (const float*)g2b;
  return with_width_dtype_256(width, dtype, [&](auto Wc, auto Tc) {
    using T = typename decltype(Tc)::type;
    if constexpr (decltype(Wc)::value == 2 * C)
      return launch_wide<T>(feat, pre, m, wb, w2, a, b, c, d, out, (float*)temp_out, n, nj, sh,
                            eps, st);
    else
      return launch<T, decltype(Wc)::value>(feat, pre, m, wb, w2, a, b, c, d, out,
                                             (float*)temp_out, n, nj, sh, eps, st);
  });
}

// Backward, at W = width (128, 64 or 256). temp: the forward's fp32 temp
// [n, W]; g: the output cotangent in feat's dtype; dx, dpre [n, W] in feat's
// dtype; dtemp, dy: fp32 [n, W] workspace; part_tail: tail_blocks * (W*W +
// 4*W) fp32 workspace (at 256: wide_bwd.cuh ops/row_tail.py `wide_part_floats`) and part_band: splits * nj * W*W; grads_tail: fp32 [W*W +
// 4*W] = dW2, dg1w, dg1b, dg2w, dg2b; dwb: fp32 [nj, W, W].
extern "C" int lane_layer_bwd(const void* feat, const void* temp, const void* masks,
                              const void* wb, const void* w2, const void* g1w,
                              const void* g1b, const void* g2w, const void* g2b, const void* g,
                              void* dx, void* dpre, void* dtemp, void* dy, void* part_tail,
                              void* part_band, void* grads_tail, void* dwb, int n, int width,
                              int nj, const void* shifts, int tail_blocks, int splits, float eps,
                              int dtype, void* stream) {
  Shifts sh;
  const int bad = make_shifts(nj, (const int*)shifts, &sh);
  if (bad) return bad;
  cudaStream_t st = (cudaStream_t)stream;
  const float *t = (const float*)temp, *a = (const float*)g1w, *b = (const float*)g1b,
              *c = (const float*)g2w, *d = (const float*)g2b;
  const uint8_t* m = (const uint8_t*)masks;
  float *dt = (float*)dtemp, *y = (float*)dy, *pt = (float*)part_tail, *pb = (float*)part_band,
        *gt = (float*)grads_tail, *gb = (float*)dwb;
  return with_width_dtype_256(width, dtype, [&](auto Wc, auto Tc) {
    using T = typename decltype(Tc)::type;
    if constexpr (decltype(Wc)::value == 2 * C)
      return launch_bwd_wide<T>((const T*)feat, t, m, (const T*)wb, (const T*)w2, a, b, c, d,
                                (const T*)g, (T*)dx, (T*)dpre, dt, y, pt, pb, gt, gb, n, nj, sh,
                                tail_blocks, splits, eps, st);
    else
      return launch_bwd<T, decltype(Wc)::value>((const T*)feat, t, m, (const T*)wb,
                                                 (const T*)w2, a, b, c, d, (const T*)g, (T*)dx,
                                                 (T*)dpre, dt, y, pt, pb, gt, gb, n, nj, sh,
                                                 tail_blocks, splits, eps, st);
  });
}
