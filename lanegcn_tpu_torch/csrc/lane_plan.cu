// Fused LaneConv residual layer with the window plan's aggregate inside it,
// forward and backward.
//
// Replaces lanegcn_tpu/ops/pallas_lane_layer.py `_fwd_kernel_plan` /
// `_fwd_impl_plan` and `_bwd_kernel_plan` / `_bwd_impl_plan` (the Pallas
// kernels behind `fused_lane_layer_plan`). Per node row u, over the plan's
// applied edges (u ← v, relation r; global rows):
//
//   temp = pre + Σ_j band_j[u] · feat[u + s_j] @ Wb_j
//              + Σ_{applied edges (u ← v, r)} rnd(feat[v] @ W_rel[r])
//   out  = relu(GN2(rnd(relu(GN1(temp))) @ W2) + feat)
//
// Each plan message is rounded to the activation dtype before it is added
// into the fp32 temp, as the TPU kernel rounds its one-hot scatter's operand;
// temp itself is never rounded before the tail.
//
// The TPU kernel walked each window's 512-slot chunks inside the layer's
// tile and gathered and scattered through one-hot matmuls. Here the wrapper
// hands in the plan as ops/scenario_agg.py `prepare_plan` prepares it (once
// per LaneConv stack call, shared by the layers and their backwards): the
// applied edges in relation order, cut into 64-edge tiles of one relation
// each, and each edge's position in destination (and source) order, with
// the sorted destination (source) row of every position. Then, in both
// dtypes:
//
// Forward (`lane_plan_fwd`), two passes:
//   messages  rel_agg.cuh's pass 1 on the tiles (bf16: msg_tc_kernel on
//             wgmma; fp32: msg_kernel on CUDA cores): ws[dpos[e]] =
//             rnd(feat[v_e] @ W_r), one write per position, ws [slots, W]
//             in the activation dtype (the rounding is the plain version's,
//             so a bf16 workspace is exact and moves half the bytes of an
//             fp32 one).
//   layer     bf16: lane_plan_tc_kernel, lane_layer_tc_kernel's schedule
//             (192-row blocks of three warpgroups, band_fwd_tc from pre in
//             registers, layer_tail_tc); between the band products and GN1
//             each row adds its messages, the positions of its run in the
//             sorted dseg (segment_sum.cuh `run_table`: two warp searches
//             for the block's range, then one pass), in position order:
//             relation order, then slot order (prepare_plan's stable sort).
//             Each thread reads its two accumulator rows' messages at its
//             own columns (add_runs_tc). fp32: lane_plan_kernel, lane_layer's
//             64-row CUDA-core tile (band_fwd, layer_tail) with the same
//             runs added (add_runs_mm).
//
// Backward (`lane_plan_bwd`), from the forward's fp32 temp:
//   row pass  (tail_bwd.cuh)  d_y, d_temp; dpre = rnd(d_temp) in T, dW2, dGN
//   messages  ws[spos[e]] = rnd(dpre[u_e] @ W_rᵀ) (rel_agg.cuh pass 1 on the
//             same tiles, gathered by destination)
//   dx pass   dx[p] = d_y[p] + Σ_j band_j[p − s_j] · d_temp[p − s_j] @ Wb_jᵀ
//                    + Σ over p's run of the sorted sseg of ws, in order
//             (band_t_tc_kernel / band_t_kernel with PLAN; bf16 keeps the
//             hi + lo split of d_temp), summed in fp32 and rounded once,
//             where the TPU kernel rounds dx after every 512-slot chunk
//   dWb pass  as lane_layer_bwd, on dpre
//   dW_rel    Σ feat[v]ᵀ dpre[u] per relation: rel_agg.cuh's dw pass on the
//             tiles (bf16 dw_tc_kernel, fp32 dw_kernel), a partial per
//             (block, relation) run, then reduce_rel_kernel in block order
// Every sum runs in a fixed order and no pass uses float atomics, so a rerun
// is bitwise equal.
//
// What bounds it: the band and W2 products of lane_layer plus one [128 x
// 128] product per applied plan edge (forward), two per edge in the
// backward, against lane_layer's traffic plus the plan's indices, the
// gathered rows and the message workspace (written and read once, 256
// bytes an edge in bf16): operation-bound at the bf16 matrix rate. What the
// merge keeps out of device memory, against scenario_agg + lane_layer: the
// aggregate's read of temp and its write of the layer's pre (2 x 53 MB in
// bf16 at N = 208,896), and the backward's separate dfeat segment sum.
//
// Width: both directions also run on W = 64-wide rows (the half-width
// LaneGCN's merged layers), every pass templated on W by the padded route
// of common.cuh that lane_layer.cu takes: the same 192-row blocks, halo
// tile and 128-column m64n128k16 products with K cut to W, the [W x W]
// weights zero-padded in shared memory, GN statistics over W, only W
// columns stored. The message workspace is [slots, W] at row stride W; the
// layer adds a row's messages into its first W accumulator columns only
// (add_runs_tc<W>, add_runs_mm<W>), so the columns at W and past it stay
// exactly zero for the tail's GN over W. At W = 128 each kernel compiles to
// the code it was before the width existed.
#include "lane_band.cuh"
#include "rel_agg.cuh"

using namespace lgk;

namespace {

using agg::WindowPlan;

// The fp32 forward (the parity path): lane_layer_kernel's 64-row tile with
// the tile's runs of plan messages (fp32, msg [slots, W]) added after the
// band products.
template <int W>
__global__ void __launch_bounds__(NT)
lane_plan_kernel(const float* __restrict__ feat, const float* __restrict__ pre,
                 const uint8_t* __restrict__ masks, const float* __restrict__ wb,
                 const float* __restrict__ w2, const float* __restrict__ g1w,
                 const float* __restrict__ g1b, const float* __restrict__ g2w,
                 const float* __restrict__ g2b, const float* __restrict__ msg,
                 const long long* __restrict__ dseg, long slots, float* __restrict__ out,
                 float* __restrict__ temp_out, int n, int nj, Shifts sh, float eps) {
  extern __shared__ float4 smem4[];
  float* X_s = reinterpret_cast<float*>(smem4);  // [TM + 2*HALO][LDA]
  float* T_s = X_s + HALO_TILE;                  // [TM][LDA]
  float* W_s = T_s + TM * LDA;                   // [C][C]
  __shared__ int lo_s[TM], hi_s[TM];
  __shared__ long blk_s[2];
  const long tile0 = (long)blockIdx.x * TM;

  load_halo<float, W>(X_s, feat, tile0, n);
  float acc[4][8];
  band_fwd<float, W>(X_s, W_s, pre, masks, wb, tile0, n, nj, sh, acc);
  seg::run_table<TM>(dseg, slots, tile0, (int)min((long)TM, n - tile0), lo_s, hi_s, blk_s);
  add_runs_mm<W>(acc, msg, blk_s[0], lo_s, hi_s);
  store_acc(T_s, acc);
  __syncthreads();
  layer_tail<float, W>(X_s, T_s, W_s, w2, g1w, g1b, g2w, g2b, out, temp_out, tile0, n, eps);
}

// The bf16 forward on tensor cores: lane_layer_tc_kernel with the block's
// runs of plan messages (bf16, msg [slots, W]) added into the accumulators
// between the band products and the tail.
template <int W>
__global__ void __launch_bounds__(DX_THREADS, 1)
lane_plan_tc_kernel(const bf16* __restrict__ feat, const bf16* __restrict__ pre,
                    const uint8_t* __restrict__ masks, const bf16* __restrict__ wb,
                    const bf16* __restrict__ w2, const float* __restrict__ g1w,
                    const float* __restrict__ g1b, const float* __restrict__ g2w,
                    const float* __restrict__ g2b, const bf16* __restrict__ msg,
                    const long long* __restrict__ dseg, long slots, bf16* __restrict__ out,
                    float* __restrict__ temp_out, int n, int nj, Shifts sh, float eps) {
  extern __shared__ float4 smem4[];
  bf16* X_s = reinterpret_cast<bf16*>(smem4);                        // [DX_HROWS][DX_HLD] feat
  uint8_t* W_b = reinterpret_cast<uint8_t*>(X_s + DX_HROWS * DX_HLD);  // [2] weight core tiles
  float* gn_s = reinterpret_cast<float*>(W_b + 2 * tc::tiles_bytes(C));  // g1w, g1b, g2w, g2b
  uint8_t* M_s = reinterpret_cast<uint8_t*>(gn_s + 4 * C);          // [MAXJ][DX_ROWS] band_j[u]
  __shared__ uint8_t act_s[MAXJ][DX_WGS];  // relation j in warpgroup g's rows
  __shared__ int lo_s[DX_ROWS], hi_s[DX_ROWS];
  __shared__ long blk_s[2];
  const long tile0 = (long)blockIdx.x * DX_ROWS;

  load_gn<W>(gn_s, g1w, g1b, g2w, g2b);
  // acc = pre + the band products; W2 in flight after them.
  float acc[64];
  band_fwd_tc<W>(acc, X_s, W_b, M_s, act_s, feat, pre, masks, wb, w2, tile0, n, nj, sh);
  // acc = temp: each row's plan messages, in position order.
  seg::run_table<DX_ROWS>(dseg, slots, tile0, (int)min((long)DX_ROWS, n - tile0), lo_s, hi_s,
                          blk_s);
  add_runs_tc<W>(acc, msg, blk_s[0], lo_s, hi_s, 64 * (threadIdx.x >> 7));
  cp_async_wait<0>();  // W2
  tc::fence_smem();
  __syncthreads();  // W2 (and, without relations, the halo and vectors) in place
  layer_tail_tc<W>(acc, X_s, W_b, gn_s, out, temp_out, tile0, n, nj, eps);
}

// The prepared plan (ops/scenario_agg.py `PlanPrep`) as the passes take it.
struct Prep {
  const int *dst, *src, *tiles, *rel_tiles, *pos;
  const long long* seg;
  long slots;
  int num_rel, blocks;
};

template <typename T, int W>
int launch_fwd(const T* feat, const T* pre, const uint8_t* masks, const T* wb, const T* w2,
               const float* g1w, const float* g1b, const float* g2w, const float* g2b,
               const T* w_rel, const Prep& pp, T* ws, T* out, float* temp_out, int n, int nj,
               const Shifts& sh, float eps, cudaStream_t stream) {
  const int err = agg::launch_msg<WindowPlan, T, false, T, W>(feat, w_rel, pp.src, pp.tiles,
                                                              pp.rel_tiles, pp.pos, ws,
                                                              pp.num_rel, pp.blocks, stream);
  if (err != 0) return err;
  if constexpr (std::is_same<T, bf16>::value) {
    const int smem = layer_tc_smem();
    cudaError_t e = set_smem((const void*)lane_plan_tc_kernel<W>, smem);
    if (e != cudaSuccess) return (int)e;
    const int blocks = (n + DX_ROWS - 1) / DX_ROWS;
    if (blocks > 0)
      lane_plan_tc_kernel<W><<<blocks, DX_THREADS, smem, stream>>>(
          feat, pre, masks, wb, w2, g1w, g1b, g2w, g2b, ws, pp.seg, pp.slots, out, temp_out, n,
          nj, sh, eps);
  } else {
    const int smem = (HALO_TILE + TM * LDA + C * C) * (int)sizeof(float);
    cudaError_t e = set_smem((const void*)lane_plan_kernel<W>, smem);
    if (e != cudaSuccess) return (int)e;
    const int blocks = (n + TM - 1) / TM;
    if (blocks > 0)
      lane_plan_kernel<W><<<blocks, NT, smem, stream>>>(feat, pre, masks, wb, w2, g1w, g1b, g2w,
                                                        g2b, ws, pp.seg, pp.slots, out,
                                                        temp_out, n, nj, sh, eps);
  }
  return (int)cudaGetLastError();
}

template <typename T, int W>
int launch_bwd(const T* feat, const float* temp, const uint8_t* masks, const T* wb,
               const T* w2, const float* g1w, const float* g1b, const float* g2w,
               const float* g2b, const T* w_rel, const Prep& pp, const T* g, T* ws, T* dx,
               T* dpre, float* dtemp, float* dy, float* part_tail, float* part_band,
               float* part_rel, float* grads_tail, float* dwb, float* dwr, int n, int nj,
               const Shifts& sh, int tail_blocks, int splits, float eps, cudaStream_t stream) {
  int err = launch_tail_bwd<T, float, W>(temp, feat, g, w2, g1w, g1b, g2w, g2b, dpre, nullptr,
                                         dtemp, dy, part_tail, grads_tail, n, tail_blocks, eps,
                                         stream);
  if (err != 0) return err;
  // The plan's transposes from rnd(d_temp) (dpre), at the source positions.
  err = agg::launch_msg<WindowPlan, T, true, T, W>(dpre, w_rel, pp.dst, pp.tiles,
                                                   pp.rel_tiles, pp.pos, ws, pp.num_rel,
                                                   pp.blocks, stream);
  if (err != 0) return err;
  err = launch_band_t<T, float, true, W>(dtemp, dy, masks, wb, dx, n, nj, sh, stream, ws,
                                         pp.seg, pp.slots);
  if (err != 0) return err;
  // dWb and dW_rel read rnd(d_temp) as the row pass wrote it into dpre (in T).
  err = launch_band_dw<T, T, W>(feat, dpre, masks, part_band, dwb, n, nj, sh, splits, stream);
  if (err != 0) return err;
  return agg::launch_dw<WindowPlan, T, W>(feat, dpre, pp.dst, pp.src, pp.tiles, pp.rel_tiles,
                                       part_rel, dwr, pp.num_rel, pp.blocks, stream);
}

// The prepared plan's arguments, checked (n: the node rows).
int make_prep(const void* dst, const void* src, const void* tiles, const void* rel_tiles,
              const void* pos, const void* seg, long long slots, int num_rel, int blocks, int n,
              Prep* pp) {
  if (n < 0 || slots < 0 || num_rel < 1 || blocks < 1 || blocks > agg::MAX_BLOCKS)
    return (int)cudaErrorInvalidValue;
  *pp = Prep{(const int*)dst, (const int*)src, (const int*)tiles, (const int*)rel_tiles,
             (const int*)pos, (const long long*)seg, (long)slots, num_rel, blocks};
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (feat, pre, wb, w2, w_rel, ws, out);
// width: W = 128 or 64 (feat, pre, out [n, W]; wb [nj, W, W], w2 [W, W],
// w_rel [R, W, W] in (in, out) layout; GN vectors fp32 [W]); masks [nj, n]
// bytes (0/1); shifts: host array of nj ints. The prepared plan
// (ops/scenario_agg.py `prepare_plan`) over `slots` plan slots: src int32
// [slots], the applied edges' source rows in relation order; tiles int32
// [*, 3] (relation, first edge, edges) and rel_tiles int32 [R + 1]; dpos
// int32 [slots], each edge's position in destination order; dseg int64
// [slots], the destination row at each position (n past the applied edges).
// ws: [slots, W] workspace in feat's dtype; blocks: the message pass's
// persistent blocks; temp_out: fp32 [n, W] that receives temp, or null.
extern "C" int lane_plan_fwd(const void* feat, const void* pre, const void* masks,
                             const void* wb, const void* w2, const void* g1w, const void* g1b,
                             const void* g2w, const void* g2b, const void* w_rel,
                             const void* src, const void* tiles, const void* rel_tiles,
                             const void* dpos, const void* dseg, void* ws, void* out,
                             void* temp_out, int n, int width, int nj, const void* shifts,
                             long long slots, int num_rel, int blocks, float eps, int dtype,
                             void* stream) {
  Shifts sh;
  int bad = make_shifts(nj, (const int*)shifts, &sh);
  if (bad) return bad;
  Prep pp;
  bad = make_prep(nullptr, src, tiles, rel_tiles, dpos, dseg, slots, num_rel, blocks, n, &pp);
  if (bad) return bad;
  cudaStream_t st = (cudaStream_t)stream;
  const float *a = (const float*)g1w, *b = (const float*)g1b, *c = (const float*)g2w,
              *d = (const float*)g2b;
  const uint8_t* m = (const uint8_t*)masks;
  return with_width_dtype(width, dtype, [&](auto Wc, auto Tc) {
    using T = typename decltype(Tc)::type;
    return launch_fwd<T, decltype(Wc)::value>((const T*)feat, (const T*)pre, m, (const T*)wb,
                                              (const T*)w2, a, b, c, d, (const T*)w_rel, pp,
                                              (T*)ws, (T*)out, (float*)temp_out, n, nj, sh, eps,
                                              st);
  });
}

// Backward. temp: the forward's fp32 temp; g: the output cotangent in feat's
// dtype; the prepared plan as in the forward, with dst int32 [slots] (the
// applied edges' destination rows in relation order), spos / sseg (the
// positions in source order and the source row at each); ws: [slots, W] in
// feat's dtype; dx, dpre [n, W] in feat's dtype; dtemp, dy: fp32 [n, W]
// workspace; part_tail: tail_blocks * (W*W + 4*W), part_band: splits * nj *
// W*W and part_rel: (blocks + R) * W*W fp32 workspace; grads_tail: fp32
// [W*W + 4*W] = dW2, dg1w, dg1b, dg2w, dg2b; dwb: fp32 [nj, W, W]; dwr: fp32
// [R, W, W].
extern "C" int lane_plan_bwd(const void* feat, const void* temp, const void* masks,
                             const void* wb, const void* w2, const void* g1w, const void* g1b,
                             const void* g2w, const void* g2b, const void* w_rel,
                             const void* dst, const void* src, const void* tiles,
                             const void* rel_tiles, const void* spos, const void* sseg,
                             const void* g, void* ws, void* dx, void* dpre, void* dtemp,
                             void* dy, void* part_tail, void* part_band, void* part_rel,
                             void* grads_tail, void* dwb, void* dwr, int n, int width, int nj,
                             const void* shifts, long long slots, int num_rel, int tail_blocks,
                             int splits, int blocks, float eps, int dtype, void* stream) {
  Shifts sh;
  int bad = make_shifts(nj, (const int*)shifts, &sh);
  if (bad) return bad;
  Prep pp;
  bad = make_prep(dst, src, tiles, rel_tiles, spos, sseg, slots, num_rel, blocks, n, &pp);
  if (bad) return bad;
  cudaStream_t st = (cudaStream_t)stream;
  const float *t = (const float*)temp, *a = (const float*)g1w, *b = (const float*)g1b,
              *c = (const float*)g2w, *d = (const float*)g2b;
  const uint8_t* m = (const uint8_t*)masks;
  float *dt = (float*)dtemp, *y = (float*)dy, *pt = (float*)part_tail, *pb = (float*)part_band,
        *pr = (float*)part_rel, *gt = (float*)grads_tail, *gb = (float*)dwb, *gr = (float*)dwr;
  return with_width_dtype(width, dtype, [&](auto Wc, auto Tc) {
    using T = typename decltype(Tc)::type;
    return launch_bwd<T, decltype(Wc)::value>((const T*)feat, t, m, (const T*)wb, (const T*)w2,
                                              a, b, c, d, (const T*)w_rel, pp, (const T*)g,
                                              (T*)ws, (T*)dx, (T*)dpre, dt, y, pt, pb, pr, gt,
                                              gb, gr, n, nj, sh, tail_blocks, splits, eps, st);
  });
}
