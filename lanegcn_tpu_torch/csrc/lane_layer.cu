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
// W = 64 the same way (below).
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
// [n, width], wb [nj, width, width], w2 [width, width], width 128 or 64;
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
  return with_width_dtype(width, dtype, [&](auto Wc, auto Tc) {
    return launch<typename decltype(Tc)::type, decltype(Wc)::value>(
        feat, pre, m, wb, w2, a, b, c, d, out, (float*)temp_out, n, nj, sh, eps, st);
  });
}

// Backward, at W = width (128 or 64). temp: the forward's fp32 temp [n, W];
// g: the output cotangent in feat's dtype; dx, dpre [n, W] in feat's dtype;
// dtemp, dy: fp32 [n, W] workspace; part_tail: tail_blocks * (W*W + 4*W)
// and part_band: splits * nj * W*W fp32 workspace; grads_tail: fp32
// [W*W + 4*W] = dW2, dg1w, dg1b, dg2w, dg2b; dwb: fp32 [nj, W, W].
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
  return with_width_dtype(width, dtype, [&](auto Wc, auto Tc) {
    using T = typename decltype(Tc)::type;
    return launch_bwd<T, decltype(Wc)::value>((const T*)feat, t, m, (const T*)wb, (const T*)w2,
                                               a, b, c, d, (const T*)g, (T*)dx, (T*)dpre, dt, y,
                                               pt, pb, gt, gb, n, nj, sh, tail_blocks, splits,
                                               eps, st);
  });
}
