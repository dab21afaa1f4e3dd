// The passes of the plan aggregations over relation-pure edge tiles, shared
// by scenario_agg.cu (the window plan), pair_agg.cu (the spill plan) and
// lane_plan.cu (the window plan inside the LaneConv layer), forward and
// backward. The wrapper prepares the plan on the device
// (ops/scenario_agg.py `prepare_plan`, ops/pair_agg.py `prepare_spill`: a
// `PlanPrep`): its valid edges (u ← v, relation r; global rows) sorted by
// relation, cut into 64-edge tiles that each hold one relation, and each
// edge's position in destination and in source order. Then
//
//   forward   out[u] = temp[u] + Σ W_r · feat[v]
//   backward  dfeat[v] = Σ g[u] @ W_rᵀ;   dW_r = Σ feat[v]ᵀ g[u]
//
// run as:
//   1. messages: per tile, gather the 64 rows, multiply by W_r (or W_rᵀ)
//      (bf16: wgmma m64n128k16, common.cuh `tc`; fp32: CUDA cores,
//      mm_64x128) and write each fp32 message row at its edge's position in
//      the destination (source) order, in a workspace [slots, 128] (bf16
//      rows for lane_plan.cu, whose layer kernels add them in place of
//      pass 2). Every position is written once: no atomics, no races.
//   2. the fixed-order segment sum (segment_sum.cuh) of the workspace into
//      the destination (source) rows, from temp's rows (from zero), in fp32,
//      rounded once to T. A row's edges come in relation order (the stable
//      sorts keep it), the order of the plain versions' index_add_.
//   3. (backward) dW_r as Aᵀ·B over the same tiles with A = feat[v] and
//      B = g[u], both MN-major core tiles from a cp.async ring; a block keeps
//      one fp32 [128 x 128] partial per relation run it walks and writes it
//      on a change of relation; `reduce_rel_kernel` sums a relation's
//      partials in block order.
// No float atomics anywhere: a rerun is bitwise equal.
//
// Blocks are persistent: block b of B walks tiles [b*T/B, (b+1)*T/B) of the
// T live tiles (T read on the device; the table's spare entries are never
// visited), so a block reloads W_r only where the relation changes, and the
// dW blocks' (block, relation) runs are at most B + R, each a partial slot
// b + r (unique: a later block starts at or after an earlier one's last
// relation).
//
// Every kernel is templated on the plan kind (WindowPlan, SpillPlan) only so
// that a profile names the two callers' passes apart.
//
// Width: the forward's passes also run on W = 64-wide rows (the LaneConv
// layers where n_map = 64), the message kernels templated on W by the
// padded route of common.cuh: source rows gathered W wide into the same
// 128-column tiles (zeros past W), the [W x W] W_r zero-padded to 128 x 128
// in shared memory, K cut to W on wgmma, the workspace [slots, W] and only
// its W columns written, the segment sum over W columns. The backward's
// passes take W the same way: the transposed messages (msg_tc_kernel /
// msg_kernel with TRANS, K cut to W: g's columns past W are zero) into a
// [slots, W] workspace, the segment sum over W columns, and the dW pass on
// W-wide rows read with zeros past W, its second warpgroup (input channels
// 64 .. 127, all padding at W = 64) skipping its products, one [W x W]
// partial per (block, relation) run, reduce_rel_kernel over W*W. At W = 128
// each kernel compiles to the code it was before the width existed.
#pragma once

#include <type_traits>

#include "segment_sum.cuh"

namespace lgk {
namespace agg {

struct WindowPlan {};
struct SpillPlan {};

constexpr int TE = 64;   // edges per tile (one relation each)
constexpr int MT = 128;  // threads of the bf16 message pass: one warpgroup

struct Tile {
  int rel, first, count;  // relation, first edge (relation order), edges (≤ TE)
};

__device__ __forceinline__ Tile tile_at(const int* tiles, int t) {
  return Tile{tiles[3 * t], tiles[3 * t + 1], tiles[3 * t + 2]};
}

// This block's tiles [x, y): an equal share of the rel_tiles[num_rel] live
// tiles, in table order.
__device__ __forceinline__ int2 block_tiles(const int* rel_tiles, int num_rel) {
  const long total = rel_tiles[num_rel];
  return make_int2((int)(blockIdx.x * total / gridDim.x),
                   (int)((blockIdx.x + 1) * total / gridDim.x));
}

// Pass 1 in bf16 on tensor cores: ws[pos[e]] = x[rows[e]] @ W_r (TRANS:
// @ W_rᵀ) for every edge e of the block's tiles, one warpgroup per block,
// stored as M: fp32 (the aggregations' workspace) or bf16 (lane_plan.cu's,
// whose layer rounds every message to bf16 anyway).
// Tile t + 1's gather (and W_r, where the relation changes, into the other
// of two weight buffers) is in flight by cp.async while tile t multiplies;
// each thread's source rows of the next tile are loaded a tile ahead.
// W: the rows' width (x [., W], W_r [W, W], ws [slots, W]).
template <bool TRANS, class Plan, typename M = float, int W = C>
__global__ void __launch_bounds__(MT)
msg_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w_rel,
              const int* __restrict__ rows, const int* __restrict__ tiles,
              const int* __restrict__ rel_tiles, const int* __restrict__ pos,
              M* __restrict__ ws, int num_rel) {
  extern __shared__ float4 smem4[];
  constexpr int WB = tc::tiles_bytes(C), AB = tc::tiles_bytes(TE);
  uint8_t* W_b = reinterpret_cast<uint8_t*>(smem4);  // [2] W_r core tiles
  uint8_t* A_b = W_b + 2 * WB;                        // [2] gathered rows' core tiles
  const int2 range = block_tiles(rel_tiles, num_rel);
  if (range.x >= range.y) return;
  const tc::Tiles wt = tc::tiles(W_b, C), at = tc::tiles(A_b, TE);  // strides of every buffer
  // This thread's chunks of a gathered tile: rows rr + 8k, columns cb .. cb + 7.
  const int rr = threadIdx.x & 7, cb = (threadIdx.x >> 3) * 8;

  Tile nt = tile_at(tiles, range.x);  // the next tile to fetch
  int src[TE / 8];                    // its rows of this thread (-1: past its edges)
  auto load_rows = [&]() {
#pragma unroll
    for (int k = 0; k < TE / 8; ++k) {
      const int i = rr + 8 * k;
      src[k] = i < nt.count ? rows[nt.first + i] : -1;
    }
  };
  load_rows();
  int cur_rel = -1, wb = 1;  // relation and weight buffer of the last fetched tile
  int stage_wb = 0;          // bit s: the weight buffer of the tile in stage s
  auto fetch = [&](int t) {  // tile t's copies, one commit group
    const int s = (t - range.x) & 1;
    if (nt.rel != cur_rel) {
      wb ^= 1;
      cur_rel = nt.rel;
      const bf16* w = w_rel + (long)cur_rel * W * W;
      uint8_t* dst = W_b + wb * WB;
      for (int i = threadIdx.x; i < C * C / 8; i += MT) {
        const int r = ((i >> 7) << 3) + (i & 7), c = ((i >> 3) & 15) * 8;
        if constexpr (W == C) {
          cp_async16(dst + tc::tile_off(wt, r, c), w + r * C + c);
        } else {
          const bool in = r < W && c < W;
          cp_async16_zfill(dst + tc::tile_off(wt, r, c), in ? w + r * W + c : w, in ? 16 : 0);
        }
      }
    }
    stage_wb = (stage_wb & ~(1 << s)) | (wb << s);
    uint8_t* a = A_b + s * AB;
#pragma unroll
    for (int k = 0; k < TE / 8; ++k) {
      const bool in = src[k] >= 0 && (W == C || cb < W);
      cp_async16_zfill(a + tc::tile_off(at, rr + 8 * k, cb), in ? x + (long)src[k] * W + cb : x,
                       in ? 16 : 0);
    }
    cp_async_commit();
    if (t + 1 < range.y) {
      nt = tile_at(tiles, t + 1);
      load_rows();
    }
  };

  fetch(range.x);
  const int r0 = tc::acc_row(0);  // this thread's accumulator rows r0 and r0 + 8
  for (int t = range.x; t < range.y; ++t) {
    const int s = (t - range.x) & 1;
    const Tile ct = tile_at(tiles, t);
    const int p0 = r0 < ct.count ? pos[ct.first + r0] : -1;
    const int p1 = r0 + 8 < ct.count ? pos[ct.first + r0 + 8] : -1;
    cp_async_wait<0>();  // tile t, the one group in flight
    tc::fence_smem();
    // tile t in place for every thread; every thread done with tile t - 1,
    // whose stage (and weight buffer, where tile t + 1 needs a new one) the
    // next fetch takes
    __syncthreads();
    if (t + 1 < range.y) fetch(t + 1);
    const tc::Tiles A = tc::tiles(A_b + s * AB, TE);
    const tc::Tiles Wr = tc::tiles(W_b + ((stage_wb >> s) & 1) * WB, C);
    float acc[64];
    tc::zero(acc);
    tc::fence_acc(acc);
    tc::fence();
    tc::mm<W / 16, true, TRANS>(acc, A, 0, Wr);
    tc::commit();
    tc::wait_all();
    tc::fence_acc(acc);
#pragma unroll
    for (int i = 0; i < W / 2; i += 2) {
      const int p = (i & 2) ? p1 : p0;
      if (p < 0) continue;
      M* q = ws + (long)p * W + tc::acc_col(i);
      if constexpr (std::is_same<M, float>::value)
        *reinterpret_cast<float2*>(q) = make_float2(acc[i], acc[i + 1]);
      else
        *reinterpret_cast<__nv_bfloat162*>(q) = __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
  }
}

// Pass 1 in fp32 on CUDA cores (the parity path): the same tiles and
// positions, W_r (TRANS: W_rᵀ) in shared memory as fp32, reloaded where the
// relation changes; W as in msg_tc_kernel.
template <bool TRANS, class Plan, int W = C>
__global__ void __launch_bounds__(NT)
msg_kernel(const float* __restrict__ x, const float* __restrict__ w_rel,
           const int* __restrict__ rows, const int* __restrict__ tiles,
           const int* __restrict__ rel_tiles, const int* __restrict__ pos,
           float* __restrict__ ws, int num_rel) {
  extern __shared__ float4 smem4[];
  float* W_s = reinterpret_cast<float*>(smem4);  // [C][C]
  float* A_s = W_s + C * C;                      // [TE][LDA]
  const int2 range = block_tiles(rel_tiles, num_rel);
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  int cur_rel = -1;
  for (int t = range.x; t < range.y; ++t) {
    const Tile ct = tile_at(tiles, t);
    __syncthreads();  // the previous tile's product is done with A_s and W_s
    if (ct.rel != cur_rel) {
      cur_rel = ct.rel;
      if (TRANS) load_weight_t<float, W>(W_s, w_rel + (long)cur_rel * W * W);
      else load_weight<float, W>(W_s, w_rel + (long)cur_rel * W * W);
    }
    for (int idx = threadIdx.x; idx < TE * (C / 4); idx += NT) {
      const int i = idx / (C / 4), c4 = (idx % (C / 4)) * 4;
      float4 v = zero4();
      if (i < ct.count && (W == C || c4 < W))
        v = load4<float>(x + (long)rows[ct.first + i] * W + c4);
      *reinterpret_cast<float4*>(A_s + i * LDA + c4) = v;
    }
    __syncthreads();
    float acc[4][8];
    zero_acc(acc);
    mm_64x128(A_s, 0, one, W_s, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = mm_row(i);
      if (row < ct.count) {
        float* p = ws + (long)pos[ct.first + row] * W;
        *reinterpret_cast<float4*>(p + mm_col(0)) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        if (W == C)  // mm_col(4) ≥ 64
          *reinterpret_cast<float4*>(p + mm_col(4)) =
              make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      }
    }
  }
}

// dW_r in bf16 on tensor cores: Σ feat[src[e]]ᵀ g[dst[e]] over the block's
// tiles, K running over a tile's 64 edges (rows past its edges zero-filled).
// Warpgroup w owns input channels 64w .. 64w + 63; a DW_STAGES ring of
// (A, B) core tiles keeps two tiles' gathers in flight. On a change of
// relation, and at the end, the block writes its partial ([W x W]) to slot
// blockIdx.x + r of part.
constexpr int DW_STAGES = 3;

template <class Plan, int W = C>
__global__ void __launch_bounds__(NT)
dw_tc_kernel(const bf16* __restrict__ feat, const bf16* __restrict__ g,
             const int* __restrict__ dst, const int* __restrict__ src,
             const int* __restrict__ tiles, const int* __restrict__ rel_tiles,
             float* __restrict__ part, int num_rel) {
  extern __shared__ float4 smem4[];
  uint8_t* buf = reinterpret_cast<uint8_t*>(smem4);  // [DW_STAGES][A, B] core tiles
  constexpr int AB = tc::tiles_bytes(TE);
  const int2 range = block_tiles(rel_tiles, num_rel);
  if (range.x >= range.y) return;
  const tc::Tiles t0 = tc::tiles(buf, TE);  // offsets are the same in every stage
  const int wg = threadIdx.x >> 7;
  // This thread's chunk k of an operand: row 8(2k + wg) + rr, columns cb .. cb + 7.
  const int rr = threadIdx.x & 7, cb = ((threadIdx.x >> 3) & 15) * 8;
  auto fetch = [&](int t, int stage) {  // one commit group, empty past the last tile
    uint8_t* A = buf + stage * 2 * AB;
    if (t < range.y) {
      const Tile ct = tile_at(tiles, t);
#pragma unroll
      for (int k = 0; k < TE * C / 8 / NT; ++k) {
        const int r = 8 * (2 * k + wg) + rr;
        const bool in = r < ct.count && (W == C || cb < W);
        const uint32_t off = tc::tile_off(t0, r, cb);
        cp_async16_zfill(A + off, in ? feat + (long)src[ct.first + r] * W + cb : feat,
                         in ? 16 : 0);
        cp_async16_zfill(A + AB + off, in ? g + (long)dst[ct.first + r] * W + cb : g,
                         in ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  float acc[64];
  const bool live = W == C || 64 * wg < W;  // the warpgroup's input channels lie in the row
  auto flush = [&](int rel) {
    if (!live) return;
    float* P = part + (long)(blockIdx.x + rel) * W * W;
#pragma unroll
    for (int i = 0; i < W / 2; i += 2)
      *reinterpret_cast<float2*>(P + (64 * wg + tc::acc_row(i)) * W + tc::acc_col(i)) =
          make_float2(acc[i], acc[i + 1]);
  };

  tc::zero(acc);
  int cur_rel = tile_at(tiles, range.x).rel;
  fetch(range.x, 0);
  fetch(range.x + 1, 1);
  for (int k = 0; range.x + k < range.y; ++k) {
    const int t = range.x + k;
    cp_async_wait<1>();  // tile t landed (t + 1 may be in flight)
    tc::fence_smem();
    // tile t in place for every thread; every warpgroup done with t - 1,
    // whose stage tile t + 2 now takes
    __syncthreads();
    fetch(t + 2, (k + 2) % DW_STAGES);
    const int rel = tile_at(tiles, t).rel;
    if (rel != cur_rel) {
      flush(cur_rel);
      tc::zero(acc);
      cur_rel = rel;
    }
    const int st = k % DW_STAGES;
    const tc::Tiles A = tc::tiles(buf + st * 2 * AB, TE), B = tc::tiles(buf + st * 2 * AB + AB, TE);
    if (live) {
      tc::fence_acc(acc);
      tc::fence();
      tc::mm<TE / 16, false, false>(acc, A, 64 * wg, B);
      tc::commit();
      tc::wait_all();
      tc::fence_acc(acc);
    }
  }
  cp_async_wait<0>();  // no copy lands after the block is gone
  flush(cur_rel);
}

// dW_r in fp32 on CUDA cores (the parity path): the same tiles, partial
// slots and order of flushes; W as in dw_tc_kernel.
template <class Plan, int W = C>
__global__ void __launch_bounds__(NT)
dw_kernel(const float* __restrict__ feat, const float* __restrict__ g,
          const int* __restrict__ dst, const int* __restrict__ src,
          const int* __restrict__ tiles, const int* __restrict__ rel_tiles,
          float* __restrict__ part, int num_rel) {
  extern __shared__ float4 smem4[];
  float* A_s = reinterpret_cast<float*>(smem4);  // [TE][LDA] feat[src]
  float* B_s = A_s + TE * LDA;                   // [TE][LDA] g[dst]
  const int2 range = block_tiles(rel_tiles, num_rel);
  if (range.x >= range.y) return;
  float accW[8][8];
  zero_tn(accW);
  int cur_rel = tile_at(tiles, range.x).rel;
  for (int t = range.x; t < range.y; ++t) {
    const Tile ct = tile_at(tiles, t);
    if (ct.rel != cur_rel) {
      store_tn<W>(part + (long)(blockIdx.x + cur_rel) * W * W, accW, false);
      zero_tn(accW);
      cur_rel = ct.rel;
    }
    __syncthreads();  // the previous tile's product is done with A_s and B_s
    for (int idx = threadIdx.x; idx < TE * (C / 4); idx += NT) {
      const int i = idx / (C / 4), c4 = (idx % (C / 4)) * 4;
      float4 a = zero4(), b = zero4();
      if (i < ct.count && (W == C || c4 < W)) {
        a = load4<float>(feat + (long)src[ct.first + i] * W + c4);
        b = load4<float>(g + (long)dst[ct.first + i] * W + c4);
      }
      *reinterpret_cast<float4*>(A_s + i * LDA + c4) = a;
      *reinterpret_cast<float4*>(B_s + i * LDA + c4) = b;
    }
    __syncthreads();
    mm_tn(A_s, B_s, ct.count, accW);
  }
  store_tn<W>(part + (long)(blockIdx.x + cur_rel) * W * W, accW, false);
}

// dw[r] = Σ over the blocks b whose tiles meet relation r's (in b order) of
// part[b + r] ([W x W] each); zero for a relation without edges. The blocks
// that meet relation r are found once per CTA, into a shared bitmask.
constexpr int RED_THREADS = 1024;  // threads of the reduction's CTAs
constexpr int MAX_BLOCKS = RED_THREADS;  // dW blocks it takes: a thread tests one

template <class Plan, int W = C>
__global__ void reduce_rel_kernel(const float* __restrict__ part,
                                  const int* __restrict__ rel_tiles, float* __restrict__ dw,
                                  int num_rel, int blocks) {
  __shared__ unsigned hit_s[MAX_BLOCKS / 32];
  const int r = blockIdx.y;
  const long total = rel_tiles[num_rel];
  const int ts = rel_tiles[r], te = rel_tiles[r + 1];
  const int words = (blocks + 31) / 32;
  if (threadIdx.x < words * 32) {  // a warp per mask word: lane k tests block 32w + k
    const int b = threadIdx.x;
    const long lo = b * total / blocks, hi = (b + 1) * total / blocks;
    const bool hit = b < blocks && ts < te && lo < hi && lo < te && hi > ts;
    const unsigned bits = __ballot_sync(0xffffffffu, hit);
    if ((threadIdx.x & 31) == 0) hit_s[threadIdx.x >> 5] = bits;
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= W * W) return;
  float s = 0.f;
  for (int w = 0; w < words; ++w) {
    for (unsigned bits = hit_s[w]; bits; bits &= bits - 1u) {
      const int b = w * 32 + __ffs(bits) - 1;
      s += part[(long)(b + r) * W * W + i];
    }
  }
  dw[(long)r * W * W + i] = s;
}

// Pass 1 into a workspace of M: fp32, or (bf16 products only) bf16; rows W wide.
template <class Plan, typename T, bool TRANS, typename M = float, int W = C>
int launch_msg(const T* x, const T* w_rel, const int* rows, const int* tiles,
               const int* rel_tiles, const int* pos, M* ws, int num_rel, int blocks,
               cudaStream_t stream) {
  cudaError_t e;
  if constexpr (std::is_same<T, bf16>::value) {
    const int smem = 2 * tc::tiles_bytes(C) + 2 * tc::tiles_bytes(TE);
    e = set_smem((const void*)msg_tc_kernel<TRANS, Plan, M, W>, smem);
    if (e != cudaSuccess) return (int)e;
    msg_tc_kernel<TRANS, Plan, M, W><<<blocks, MT, smem, stream>>>(x, w_rel, rows, tiles,
                                                                   rel_tiles, pos, ws, num_rel);
  } else {
    static_assert(std::is_same<M, float>::value, "the fp32 pass writes an fp32 workspace");
    const int smem = (C * C + TE * LDA) * (int)sizeof(float);
    e = set_smem((const void*)msg_kernel<TRANS, Plan, W>, smem);
    if (e != cudaSuccess) return (int)e;
    msg_kernel<TRANS, Plan, W><<<blocks, NT, smem, stream>>>(x, w_rel, rows, tiles, rel_tiles,
                                                             pos, ws, num_rel);
  }
  return (int)cudaGetLastError();
}

// The dW pass on W-wide rows: partials [W x W], then dw [R, W, W].
template <class Plan, typename T, int W = C>
int launch_dw(const T* feat, const T* g, const int* dst, const int* src, const int* tiles,
              const int* rel_tiles, float* part, float* dw, int num_rel, int blocks,
              cudaStream_t stream) {
  cudaError_t e;
  if constexpr (std::is_same<T, bf16>::value) {
    const int smem = DW_STAGES * 2 * tc::tiles_bytes(TE);
    e = set_smem((const void*)dw_tc_kernel<Plan, W>, smem);
    if (e != cudaSuccess) return (int)e;
    dw_tc_kernel<Plan, W><<<blocks, NT, smem, stream>>>(feat, g, dst, src, tiles, rel_tiles,
                                                        part, num_rel);
  } else {
    const int smem = 2 * TE * LDA * (int)sizeof(float);
    e = set_smem((const void*)dw_kernel<Plan, W>, smem);
    if (e != cudaSuccess) return (int)e;
    dw_kernel<Plan, W><<<blocks, NT, smem, stream>>>(feat, g, dst, src, tiles, rel_tiles, part,
                                                     num_rel);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_rel_kernel<Plan, W><<<dim3(W * W / RED_THREADS, num_rel), RED_THREADS, 0, stream>>>(
      part, rel_tiles, dw, num_rel, blocks);
  return (int)cudaGetLastError();
}

template <class Plan, typename T, int W = C>
int launch_fwd(const void* feat, const void* temp, const void* w_rel, const int* src,
               const int* tiles, const int* rel_tiles, const int* dpos, const long long* dseg,
               float* ws, void* out, int n, long slots, int num_rel, int blocks,
               cudaStream_t stream) {
  const int err = launch_msg<Plan, T, false, float, W>((const T*)feat, (const T*)w_rel, src,
                                                       tiles, rel_tiles, dpos, ws, num_rel,
                                                       blocks, stream);
  if (err != 0) return err;
  return launch_segment_sum<float, T>(ws, dseg, (const T*)temp, (T*)out, slots, n, W, stream);
}

// The forward at the row width and activation dtype of `with_width_dtype`.
template <class Plan>
int launch_fwd_width(const void* feat, const void* temp, const void* w_rel, const int* src,
                     const int* tiles, const int* rel_tiles, const int* dpos,
                     const long long* dseg, float* ws, void* out, int n, int width, long slots,
                     int num_rel, int blocks, int dtype, cudaStream_t stream) {
  return with_width_dtype(width, dtype, [&](auto Wc, auto Tc) {
    return launch_fwd<Plan, typename decltype(Tc)::type, decltype(Wc)::value>(
        feat, temp, w_rel, src, tiles, rel_tiles, dpos, dseg, ws, out, n, slots, num_rel, blocks,
        stream);
  });
}

template <class Plan, typename T, int W = C>
int launch_bwd(const void* feat, const void* g, const void* w_rel, const int* dst,
               const int* src, const int* tiles, const int* rel_tiles, const int* spos,
               const long long* sseg, float* ws, void* dfeat, float* part, float* dw, int n,
               long slots, int num_rel, int blocks, cudaStream_t stream) {
  int err = launch_msg<Plan, T, true, float, W>((const T*)g, (const T*)w_rel, dst, tiles,
                                                rel_tiles, spos, ws, num_rel, blocks, stream);
  if (err != 0) return err;
  err = launch_segment_sum<float, T>(ws, sseg, nullptr, (T*)dfeat, slots, n, W, stream);
  if (err != 0) return err;
  return launch_dw<Plan, T, W>((const T*)feat, (const T*)g, dst, src, tiles, rel_tiles, part, dw,
                               num_rel, blocks, stream);
}

// The backward at the row width and activation dtype of `with_width_dtype`.
template <class Plan>
int launch_bwd_width(const void* feat, const void* g, const void* w_rel, const int* dst,
                     const int* src, const int* tiles, const int* rel_tiles, const int* spos,
                     const long long* sseg, float* ws, void* dfeat, float* part, float* dw, int n,
                     int width, long slots, int num_rel, int blocks, int dtype,
                     cudaStream_t stream) {
  return with_width_dtype(width, dtype, [&](auto Wc, auto Tc) {
    return launch_bwd<Plan, typename decltype(Tc)::type, decltype(Wc)::value>(
        feat, g, w_rel, dst, src, tiles, rel_tiles, spos, sseg, ws, dfeat, part, dw, n, slots,
        num_rel, blocks, stream);
  });
}

}  // namespace agg
}  // namespace lgk
