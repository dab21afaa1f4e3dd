// Window-pair aggregation of the LaneConv spill residue, forward and backward.
//
// Replaces lanegcn_tpu/ops/pallas_pair_agg.py `_fwd_kernel` / `_pallas_fwd`
// (forward) and `_bwd_d_kernel` / `_bwd_s_kernel` (`_pallas_bwd`). The
// packer's spill plan (data/packing.py build_pair_plan with a relation
// column) holds the window plan's residue in chunks of `chunk` slots; every
// chunk's edges share one (destination window, source window) pair, and the
// chunks are sorted by (dwin, swin), so each destination window's chunks form
// one run that starts where `first` is 1. Per valid slot (lu, lv, rel):
//
//   out[dwin*sd + lu] = temp[..] + Σ W_rel[rel] · feat[swin*ss + lv]
//
// A slot is valid when lu, lv lie in their windows and in the pack and rel
// is a relation; padding slots (lu = -1), all-padding chunks, inactive tail
// chunks and the empty plan contribute nothing.
//
// pair_agg_fwd: a block per (destination-window run, 32-channel slice) keeps
// the window's slice in shared memory in fp32, started from temp, and rounds
// it once at the end. It walks its run once per relation present in it and
// compacts that relation's slots 64 at a time (a ballot), so each
// [64 x 128] x [128 x 32] product runs against one relation's weight and
// (except the last of each relation) on 64 real edges, where the TPU kernel
// ran 14 masked products per chunk. Source rows are gathered with all 128
// channels (the product's K axis). The scatter into the window runs in slot
// order, each window row owned by one warp: no two threads add into one
// element, no float atomics, a fixed order, so reruns are bitwise equal.
// Windows no run targets keep temp: the wrapper hands in out = temp.clone().
//
// pair_agg_bwd: the spill plan has the window plan's contract (out[u] +=
// W_r · feat[v] over listed edges with global rows), so its backward is
// scenario_agg's, rel_agg.cuh's passes over the plan as ops/pair_agg.py
// `prepare_spill` lists it (once per LaneConv stack call, beside the window
// plan's preparation): the valid slots in relation order, cut into 64-edge
// tiles of one relation each, with each edge's position in source order.
//   dfeat[v] = Σ g[u] @ W_rᵀ: the messages on wgmma (bf16; CUDA cores in
//     fp32) written as fp32 rows at their source positions, then the
//     fixed-order segment sum into dfeat from zero, rounded once;
//   dW_r = Σ feat[v]ᵀ g[u]: per relation run on wgmma (bf16), one partial
//     per (block, relation) run, summed in block order.
// It holds no window in shared memory, so it takes any window stride. The
// entry point is pair_agg's own, so that launch counts (and the kernels'
// SpillPlan instantiation, in a profile) tell it from the window plan's.
//
// What bounds it: one (forward) or two (backward) [E x 128] x [128 x 128]
// products on the valid spill edges (29,784 at the 256-scenario bench pack:
// 1 GFLOP) against ~110 MB (temp read and out written whole, feat at the
// rows the edges read): memory-bound at the card's rates. The forward runs
// the products on CUDA cores in fp32.
#include "rel_agg.cuh"

using namespace lgk;

namespace {

constexpr int EB = 64;  // edges per product

// The relation of slot `slot` if it is a valid edge, else -1; sets the
// window-local destination row and the global source row.
__device__ __forceinline__ int slot_edge(const int* idx, long slot, long base_d, long base_s,
                                         int sd, int ss, int n, int num_rel, int* lu, int* v) {
  const int u = idx[slot * 3], lv = idx[slot * 3 + 1], r = idx[slot * 3 + 2];
  const bool ok = u >= 0 && u < sd && lv >= 0 && lv < ss && r >= 0 && r < num_rel &&
                  base_d + u < n && base_s + lv < n;
  *lu = u;
  *v = (int)(base_s + lv);
  return ok ? r : -1;
}

// Appends the selected values of threads 0..EB-1 (sel) to the pending lists
// p0/p1 (2*EB entries each) at `fill`, in thread order; returns the new
// fill. Every thread of the block calls it.
__device__ __forceinline__ int compact(bool sel, int a0, int a1, int* p0, int* p1, int* cnt_s,
                                       int fill) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned int ballot = __ballot_sync(0xffffffffu, sel);
  __syncthreads();  // the previous step is done with cnt_s and the pending lists
  if (warp < 2 && lane == 0) cnt_s[warp] = __popc(ballot);
  __syncthreads();
  if (sel) {
    const int pos = fill + (warp == 1 ? cnt_s[0] : 0) + __popc(ballot & ((1u << lane) - 1u));
    p0[pos] = a0;
    p1[pos] = a1;
  }
  return fill + cnt_s[0] + cnt_s[1];
}

// Moves pending entries [EB, fill) to [0, fill - EB) after a flush of EB.
__device__ __forceinline__ int drop_flushed(int* p0, int* p1, int fill) {
  __syncthreads();  // the flush is done reading the pending lists
  if (threadIdx.x < fill - EB) {
    p0[threadIdx.x] = p0[EB + threadIdx.x];
    p1[threadIdx.x] = p1[EB + threadIdx.x];
  }
  return fill - EB;
}

template <typename T>
__global__ void __launch_bounds__(NT)
pair_agg_fwd_kernel(const T* __restrict__ feat, const T* __restrict__ temp,
                    const T* __restrict__ w_rel, const int* __restrict__ idx,
                    const int* __restrict__ meta, T* __restrict__ out, int nc, int chunk, int sd,
                    int ss, int n, int num_rel) {
  const int* dwin = meta;
  const int* swin = meta + nc;
  const int* first = meta + 2 * nc;
  const int k = blockIdx.x;
  if (first[k] != 1) return;
  int k_end = k + 1;
  while (k_end < nc && first[k_end] != 1) ++k_end;

  extern __shared__ float4 smem4[];
  float* acc_s = reinterpret_cast<float*>(smem4);  // [sd][SLICE]
  float* G_s = acc_s + sd * SLICE;                 // [EB][LDA]
  float* W_s = G_s + EB * LDA;                     // [C][SLICE]
  float* M_s = W_s + C * SLICE;                    // [EB][MLD]
  int* pu_s = reinterpret_cast<int*>(M_s + EB * MLD);  // [2*EB] pending local dst rows
  int* pv_s = pu_s + 2 * EB;                            // [2*EB] pending global src rows
  int* cnt_s = pv_s + 2 * EB;                           // [2]
  unsigned int* present_s = reinterpret_cast<unsigned int*>(cnt_s + 2);

  const int cs = blockIdx.y * SLICE;
  const long base_d = (long)dwin[k] * sd;
  const int rows_d = (int)min((long)sd, (long)n - base_d);
  for (int i = threadIdx.x; i < sd * SLICE; i += NT) {
    const int r = i / SLICE, c = i % SLICE;
    acc_s[i] = r < rows_d ? to_f<T>(temp[(base_d + r) * C + cs + c]) : 0.f;
  }
  if (threadIdx.x == 0) *present_s = 0u;
  __syncthreads();
  for (long slot = (long)k * chunk + threadIdx.x; slot < (long)k_end * chunk; slot += NT) {
    int lu, v;
    const int r = slot_edge(idx, slot, base_d, (long)swin[slot / chunk] * ss, sd, ss, n,
                            num_rel, &lu, &v);
    if (r >= 0) atomicOr(present_s, 1u << r);
  }
  __syncthreads();
  const unsigned int present = *present_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float ones[2] = {1.f, 1.f};

  auto flush = [&](int count) {
    __syncthreads();  // pending rows (and W_s) written
    for (int i = threadIdx.x; i < EB * (C / 4); i += NT) {
      const int e = i / (C / 4), c4 = (i % (C / 4)) * 4;
      *reinterpret_cast<float4*>(G_s + e * LDA + c4) =
          e < count ? load4<T>(feat + (long)pv_s[e] * C + c4) : zero4();
    }
    __syncthreads();
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    mm_64x32(G_s, ones, W_s, acc);
    const int row0 = (threadIdx.x >> 3) * 2, col0 = (threadIdx.x & 7) * 4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) M_s[(row0 + i) * MLD + col0 + j] = acc[i][j];
    }
    __syncthreads();
    // Scatter in slot order: warp w owns the window rows ≡ w (mod 8), lane = channel.
    for (int e = 0; e < count; ++e) {
      const int u = pu_s[e];
      if (u % (NT / 32) == warp) acc_s[u * SLICE + lane] += M_s[e * MLD + lane];
    }
  };

  for (int r = 0; r < num_rel; ++r) {
    if (!((present >> r) & 1u)) continue;
    __syncthreads();  // the previous relation's products are done with W_s
    for (int i = threadIdx.x * 4; i < C * SLICE; i += NT * 4) {
      const int kk = i / SLICE, c = i % SLICE;
      *reinterpret_cast<float4*>(W_s + i) = load4<T>(w_rel + ((long)r * C + kk) * C + cs + c);
    }
    int fill = 0;
    for (int kk = k; kk < k_end; ++kk) {
      const long base_s = (long)swin[kk] * ss;
      for (int h = 0; h < chunk; h += EB) {
        bool sel = false;
        int lu = -1, v = -1;
        if (threadIdx.x < EB && h + threadIdx.x < chunk)
          sel = slot_edge(idx, (long)kk * chunk + h + threadIdx.x, base_d, base_s, sd, ss, n,
                          num_rel, &lu, &v) == r;
        fill = compact(sel, lu, v, pu_s, pv_s, cnt_s, fill);
        if (fill >= EB) {
          flush(EB);
          fill = drop_flushed(pu_s, pv_s, fill);
        }
      }
    }
    if (fill > 0) flush(fill);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows_d * SLICE; i += NT) {
    const int r = i / SLICE, c = i % SLICE;
    out[(base_d + r) * C + cs + c] = from_f<T>(acc_s[i]);
  }
}

inline int fwd_smem(int sd) {
  return (sd * SLICE + EB * LDA + C * SLICE + EB * MLD) * (int)sizeof(float) +
         (4 * EB + 3) * (int)sizeof(int);
}

template <typename T>
int launch_fwd(const void* feat, const void* temp, const void* w_rel, const int* idx,
               const int* meta, void* out, int nc, int chunk, int sd, int ss, int n, int num_rel,
               cudaStream_t stream) {
  const int smem = fwd_smem(sd);
  cudaError_t err = set_smem((const void*)pair_agg_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  if (nc > 0) {
    pair_agg_fwd_kernel<T><<<dim3(nc, C / SLICE), NT, smem, stream>>>(
        (const T*)feat, (const T*)temp, (const T*)w_rel, idx, meta, (T*)out, nc, chunk, sd, ss,
        n, num_rel);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (feat, temp, w_rel [R, C, C] (in, out),
// out); idx int32 [nc*chunk, 3] (lu, lv, rel; -1 padding); meta int32
// [6, nc] (dwin, swin, first, sperm, sswin, sfirst); feat/temp/out [n, 128]
// with sd = ss (the node stride); out holds temp on entry (untouched windows
// keep it).
extern "C" int pair_agg_fwd(const void* feat, const void* temp, const void* w_rel,
                            const void* idx, const void* meta, void* out, int nc, int chunk,
                            int sd, int ss, int n, int num_rel, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int *ix = (const int*)idx, *mt = (const int*)meta;
  if (num_rel > 32) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_fwd<float>(feat, temp, w_rel, ix, mt, out, nc, chunk, sd, ss, n, num_rel, st);
  if (dtype == 1)
    return launch_fwd<bf16>(feat, temp, w_rel, ix, mt, out, nc, chunk, sd, ss, n, num_rel, st);
  return (int)cudaErrorInvalidValue;
}

// Backward, over the spill plan prepared by ops/pair_agg.py `prepare_spill`
// (a PlanPrep over `slots` = nc*chunk plan slots, as scenario_agg_bwd takes
// it): g the output cotangent in feat's dtype; w_rel [R, C, C] (in, out), not
// transposed; dst / src int32 [slots], the valid edges' global rows in
// relation order; tiles / rel_tiles the relation-pure tile table; spos /
// sseg each edge's position in source order and the source row of each;
// ws fp32 [slots, C]; dfeat [n, C] in feat's dtype; part fp32 (blocks + R) *
// C*C; dw fp32 [R, C, C]. The cotangent of temp is g itself (the wrapper
// returns it).
extern "C" int pair_agg_bwd(const void* feat, const void* g, const void* w_rel, const void* dst,
                            const void* src, const void* tiles, const void* rel_tiles,
                            const void* spos, const void* sseg, void* ws, void* dfeat, void* part,
                            void* dw, int n, long long slots, int num_rel, int blocks, int dtype,
                            void* stream) {
  if (n < 0 || slots < 0 || num_rel < 1 || blocks < 1 || blocks > agg::MAX_BLOCKS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int *d = (const int*)dst, *s = (const int*)src, *t = (const int*)tiles,
            *rt = (const int*)rel_tiles, *sp = (const int*)spos;
  const long long* ss = (const long long*)sseg;
  if (dtype == 0)
    return agg::launch_bwd<agg::SpillPlan, float>(feat, g, w_rel, d, s, t, rt, sp, ss,
                                                  (float*)ws, dfeat, (float*)part, (float*)dw, n,
                                                  slots, num_rel, blocks, st);
  if (dtype == 1)
    return agg::launch_bwd<agg::SpillPlan, bf16>(feat, g, w_rel, d, s, t, rt, sp, ss, (float*)ws,
                                                 dfeat, (float*)part, (float*)dw, n, slots,
                                                 num_rel, blocks, st);
  return (int)cudaErrorInvalidValue;
}
