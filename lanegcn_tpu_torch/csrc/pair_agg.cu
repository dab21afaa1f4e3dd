// Window-pair aggregation of the LaneConv spill residue, forward and backward.
//
// Replaces lanegcn_tpu/ops/pallas_pair_agg.py `_fwd_kernel` / `_pallas_fwd`
// (forward) and `_bwd_d_kernel` / `_bwd_s_kernel` (`_pallas_bwd`). The
// packer's spill plan (data/packing.py build_pair_plan with a relation
// column) holds the window plan's residue in chunks of `chunk` slots; every
// chunk's edges share one (destination window, source window) pair. Per
// valid slot (lu, lv, rel):
//
//   out[dwin*sd + lu] = temp[..] + Σ W_rel[rel] · feat[swin*ss + lv]
//
// A slot is valid when lu, lv lie in their windows and in the pack and rel
// is a relation; padding slots (lu = -1), all-padding chunks, inactive tail
// chunks and the empty plan contribute nothing.
//
// The spill plan has the window plan's contract (out[u] += W_r · feat[v]
// over listed edges with global rows), so both directions run
// scenario_agg's passes (rel_agg.cuh) over the plan as ops/pair_agg.py
// `prepare_spill` lists it (once per LaneGCN forward, shared by MapNet's and
// M2M's stacks and their backwards; a stack called alone makes its own):
// the valid slots in relation order, cut into 64-edge tiles of one relation
// each, with each edge's position in destination (and, for the backward,
// source) order.
//   forward   out[u] = temp[u] + Σ W_r · feat[v]: the messages on wgmma
//     (bf16; CUDA cores in fp32) written as fp32 rows at their destination
//     positions, then the fixed-order segment sum into out from temp's
//     rows, rounded once; rows no edge reaches come out as temp;
//   backward  dfeat[v] = Σ g[u] @ W_rᵀ: the messages at their source
//     positions, then the segment sum from zero; dW_r = Σ feat[v]ᵀ g[u]:
//     per relation run on wgmma (bf16), one partial per (block, relation)
//     run, summed in block order.
// A row's edges are added in relation order, slot order within a relation.
// No window sits in shared memory, so any window stride is taken, and no
// float atomics: a rerun is bitwise equal. The entry points are pair_agg's
// own, so that launch counts (and the kernels' SpillPlan instantiation, in
// a profile) tell them from the window plan's.
//
// What bounds it: one (forward) or two (backward) [E x 128] x [128 x 128]
// products on the valid spill edges (29,784 at the 256-scenario bench pack:
// 1 GFLOP) against ~110 MB (temp read and out written whole, feat at the
// rows the edges read): memory-bound at the card's rates. The passes also
// move the fp32 message workspace (a 4·W-byte row an edge, written and
// read: 512 bytes at W = 128), the price of a scatter without atomics.
//
// Width: both directions also run on 64-wide rows (rel_agg.cuh, the padded
// route).
#include "rel_agg.cuh"

using namespace lgk;

// Forward, over the spill plan prepared by ops/pair_agg.py `prepare_spill`
// (a PlanPrep over `slots` = nc*chunk plan slots, as scenario_agg_fwd takes
// it). dtype: 0 = float32, 1 = bfloat16 (feat, temp, w_rel [R, W, W] (in,
// out) and out [n, W], W = width: 128 or 64); src int32 [slots], the valid
// edges' source rows in relation order; tiles / rel_tiles the relation-pure
// tile table; dpos / dseg each edge's position in destination order and the
// destination row of each (n past the valid edges); ws fp32 [slots, W];
// blocks: the message pass's persistent blocks.
extern "C" int pair_agg_fwd(const void* feat, const void* temp, const void* w_rel,
                            const void* src, const void* tiles, const void* rel_tiles,
                            const void* dpos, const void* dseg, void* ws, void* out, int n,
                            int width, long long slots, int num_rel, int blocks, int dtype,
                            void* stream) {
  if (n < 0 || slots < 0 || num_rel < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  const int *s = (const int*)src, *t = (const int*)tiles, *rt = (const int*)rel_tiles,
            *dp = (const int*)dpos;
  return agg::launch_fwd_width<agg::SpillPlan>(feat, temp, w_rel, s, t, rt, dp,
                                               (const long long*)dseg, (float*)ws, out, n,
                                               width, slots, num_rel, blocks, dtype,
                                               (cudaStream_t)stream);
}

// Backward, over the spill plan prepared by ops/pair_agg.py `prepare_spill`
// (a PlanPrep over `slots` = nc*chunk plan slots, as scenario_agg_bwd takes
// it): g the output cotangent in feat's dtype; w_rel [R, W, W] (in, out),
// not transposed, W = width: 128 or 64; dst / src int32 [slots], the valid
// edges' global rows in relation order; tiles / rel_tiles the relation-pure
// tile table; spos / sseg each edge's position in source order and the
// source row of each; ws fp32 [slots, W]; dfeat [n, W] in feat's dtype;
// part fp32 (blocks + R) * W*W; dw fp32 [R, W, W]. The cotangent of temp is
// g itself (the wrapper returns it).
extern "C" int pair_agg_bwd(const void* feat, const void* g, const void* w_rel, const void* dst,
                            const void* src, const void* tiles, const void* rel_tiles,
                            const void* spos, const void* sseg, void* ws, void* dfeat, void* part,
                            void* dw, int n, int width, long long slots, int num_rel, int blocks,
                            int dtype, void* stream) {
  if (n < 0 || slots < 0 || num_rel < 1 || blocks < 1 || blocks > agg::MAX_BLOCKS)
    return (int)cudaErrorInvalidValue;
  const int *d = (const int*)dst, *s = (const int*)src, *t = (const int*)tiles,
            *rt = (const int*)rel_tiles, *sp = (const int*)spos;
  return agg::launch_bwd_width<agg::SpillPlan>(feat, g, w_rel, d, s, t, rt, sp,
                                               (const long long*)sseg, (float*)ws, dfeat,
                                               (float*)part, (float*)dw, n, width, slots,
                                               num_rel, blocks, dtype, (cudaStream_t)stream);
}
