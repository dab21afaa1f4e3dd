// Window-plan aggregation of the LaneConv overflow edges, forward and backward.
//
// Replaces lanegcn_tpu/ops/pallas_scenario_agg.py `_pallas_fwd` (:252, the
// Pallas kernel behind `scenario_aggregate`) and `_pallas_bwd` (:292, its
// VJP). Over the plan's applied edges (u ← v, relation r; global rows
// u = w*stride + lu, v = w*stride + lv):
//
//   forward   out[u] = temp[u] + Σ W_r · feat[v]
//   backward  dfeat[v] = Σ g[u] @ W_rᵀ;   dW_r = Σ feat[v]ᵀ g[u];   dtemp = g
//
// The TPU kernel walked each window's 512-slot chunks and gathered and
// scattered through one-hot matmuls on the MXU, which is how a TPU avoids a
// scatter. Here the wrapper prepares the plan once per LaneConv stack call
// (ops/scenario_agg.py `prepare_plan`, on the device, no host sync): the
// applied slots (`_applied_edges`: valid, inside a visited chunk of their
// relation group) sorted by relation, cut into 64-edge tiles that each
// hold one relation, and each edge's position in destination order (and, for
// the backward, in source order). The passes over those tiles (messages at
// their positions, the fixed-order segment sum, dW_r per relation run) are
// rel_agg.cuh's, shared with pair_agg.cu's backward of the spill plan. The
// backward's messages read the same core tiles of W_r K-major (W_rᵀ): no
// transposed copy.
//
// What bounds it: bytes. Per launch the products are 2·edges·128² operations
// (0.09 ms at the bf16 rate for 350k edges) against the gathered rows, temp
// and out: ~0.05 ms at the card's memory rate. This design also moves the
// fp32 workspace (written and read once, a 4·W-byte row an edge: 512 bytes
// at W = 128), which is the price of a scatter without atomics.
//
// Width: both directions also run on 64-wide rows (rel_agg.cuh, the padded
// route).
#include "rel_agg.cuh"

using namespace lgk;

// dtype: 0 = float32, 1 = bfloat16 (feat, temp, w_rel [R, W, W] (in, out) and
// out [n, W], W = width: 128 or 64). The prepared plan (ops/scenario_agg.py
// `prepare_plan`), over `slots` plan slots: src int32 [slots], the applied
// edges' source rows in relation order; tiles int32 [*, 3] (relation, first
// edge, edges) and rel_tiles int32 [R + 1], each relation's first tile
// (rel_tiles[R]: the live tiles); dpos int32 [slots], each edge's position
// in destination order; dseg int64 [slots], the destination row of each
// position (n past the applied edges). ws: fp32 [slots, W] workspace.
// blocks: the message pass's persistent blocks.
extern "C" int scenario_agg_fwd(const void* feat, const void* temp, const void* w_rel,
                                const void* src, const void* tiles, const void* rel_tiles,
                                const void* dpos, const void* dseg, void* ws, void* out, int n,
                                int width, long long slots, int num_rel, int blocks, int dtype,
                                void* stream) {
  if (n < 0 || slots < 0 || num_rel < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  const int *s = (const int*)src, *t = (const int*)tiles, *rt = (const int*)rel_tiles,
            *dp = (const int*)dpos;
  return agg::launch_fwd_width<agg::WindowPlan>(feat, temp, w_rel, s, t, rt, dp,
                                                (const long long*)dseg, (float*)ws, out, n,
                                                width, slots, num_rel, blocks, dtype,
                                                (cudaStream_t)stream);
}

// Backward. g: the output cotangent in feat's dtype; w_rel as in the forward
// (not transposed; [R, W, W], W = width: 128 or 64); dst int32 [slots], the
// applied edges' destination rows in relation order; spos / sseg: positions
// in source order and the source row of each; ws fp32 [slots, W]; dfeat
// [n, W] in feat's dtype; part: fp32 (blocks + R) * W*W workspace; dw:
// fp32 [R, W, W]. The cotangent of temp is g itself (the wrapper returns
// it).
extern "C" int scenario_agg_bwd(const void* feat, const void* g, const void* w_rel,
                                const void* dst, const void* src, const void* tiles,
                                const void* rel_tiles, const void* spos, const void* sseg,
                                void* ws, void* dfeat, void* part, void* dw, int n, int width,
                                long long slots, int num_rel, int blocks, int dtype,
                                void* stream) {
  if (n < 0 || slots < 0 || num_rel < 1 || blocks < 1 || blocks > agg::MAX_BLOCKS)
    return (int)cudaErrorInvalidValue;
  const int *d = (const int*)dst, *s = (const int*)src, *t = (const int*)tiles,
            *rt = (const int*)rel_tiles, *sp = (const int*)spos;
  return agg::launch_bwd_width<agg::WindowPlan>(feat, g, w_rel, d, s, t, rt, sp,
                                                (const long long*)sseg, (float*)ws, dfeat,
                                                (float*)part, (float*)dw, n, width, slots,
                                                num_rel, blocks, dtype, (cudaStream_t)stream);
}
