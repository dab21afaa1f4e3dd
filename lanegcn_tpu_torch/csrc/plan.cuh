// The window edge plan as lane_plan.cu (the plan inside the LaneConv layer)
// walks it. (scenario_agg.cu, the plan's aggregate as its own kernel, takes
// the plan prepared by ops/scenario_agg.py `prepare_plan`, which applies the
// same rule on the device before the kernels run.)
//
// Per window w (node rows [w*stride, (w+1)*stride)) the plan holds ecap slots
// (lu, lv, rel: window-local destination and source rows and the relation;
// lu = -1 is padding), prefix-dense and, with relation groups, chunk-aligned
// per group: group g owns the 512-slot chunks [ends[w][g-1], ends[w][g]) and a
// chunk applies only its group's relations. Chunks past the last group's end
// are skipped. `applied_rel` is that rule for one slot (the plain versions'
// `_applied_edges`), so every kernel applies the same edges.
#pragma once

#include "common.cuh"

namespace lgk {

constexpr int EB = 64;       // plan slots / compacted edges per step
constexpr int PCHUNK = 512;  // slot chunk of the plan layout
constexpr int MAXG = 4;

struct Groups {
  unsigned int mask[MAXG];
};

inline int make_groups(int num_groups, int num_rel, const void* group_masks, Groups* g) {
  if (num_groups < 1 || num_groups > MAXG || num_rel > 32) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < MAXG; ++i)
    g->mask[i] = i < num_groups ? ((const unsigned int*)group_masks)[i] : 0u;
  return 0;
}

// Whether plan slot `slot` of window w is applied: inside a visited chunk, both rows in the window, its relation in
// the chunk's group. Returns the relation, or -1.
__device__ __forceinline__ int applied_rel(const int* lu, const int* lv, const int* rel,
                                           const int* ends_w, const Groups& groups, long w,
                                           int slot, int ecap, int stride, int num_rel,
                                           int num_groups, int* u, int* v) {
  if (slot >= ecap) return -1;
  const int ck = slot / PCHUNK;
  int gi = 0;
  while (gi < num_groups - 1 && ck >= ends_w[gi]) ++gi;
  const long e = w * ecap + slot;
  *u = lu[e];
  *v = lv[e];
  const int r = rel[e];
  const bool ok = *u >= 0 && *u < stride && *v >= 0 && *v < stride && r >= 0 && r < num_rel &&
                  ((groups.mask[gi] >> r) & 1u);
  return ok ? r : -1;
}

// Four elements of a row held in G, as T-valued floats: a T row is read as it
// is; an fp32 row is rounded to T (the Pallas backward rounds d_temp before
// its products).
template <typename T, typename G>
__device__ __forceinline__ float4 load_rnd4(const G* p) {
  return rnd4<T>(load4<G>(p));
}

// Visited plan steps of a window (64 slots each).
__device__ __forceinline__ int plan_steps(const int* ends_w, int num_groups, int ecap) {
  return min(ends_w[num_groups - 1] * (PCHUNK / EB), (ecap + EB - 1) / EB);
}

// dW_rel pass: block (p, r) sums feat[v]ᵀ rnd(g[u]) over the applied edges of
// relation r in windows p, p + splits, ..., 64 compacted edges per product,
// and writes its partial part[p][r] [C][C]. g is lane_plan's fp32 d_temp,
// rounded to T as it is read.
template <typename T, typename G>
__global__ void __launch_bounds__(NT)
plan_dw_kernel(const T* __restrict__ feat, const G* __restrict__ g,
               const int* __restrict__ lu, const int* __restrict__ lv,
               const int* __restrict__ rel, const int* __restrict__ ends, Groups groups,
               float* __restrict__ part, int num_win, int stride, int ecap, int num_rel,
               int num_groups) {
  extern __shared__ float4 smem4[];
  float* A_s = reinterpret_cast<float*>(smem4);  // [EB][LDA] feat[v]
  float* B_s = A_s + EB * LDA;                   // [EB][LDA] g[u]
  int* pu_s = reinterpret_cast<int*>(B_s + EB * LDA);  // [2*EB] pending dst rows (global)
  int* pv_s = pu_s + 2 * EB;                            // [2*EB] pending src rows (global)
  int* cnt_s = pv_s + 2 * EB;                           // [2] per-warp selected counts
  const int r = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float accW[8][8];
  zero_tn(accW);
  int fill = 0;  // pending edges (the same value in every thread)

  auto flush = [&](int count) {
    __syncthreads();  // pending rows written
    for (int idx = threadIdx.x; idx < EB * (C / 4); idx += NT) {
      const int e = idx / (C / 4), c4 = (idx % (C / 4)) * 4;
      float4 a = zero4(), b = zero4();
      if (e < count) {
        a = load4<T>(feat + (long)pv_s[e] * C + c4);
        b = load_rnd4<T, G>(g + (long)pu_s[e] * C + c4);
      }
      *reinterpret_cast<float4*>(A_s + e * LDA + c4) = a;
      *reinterpret_cast<float4*>(B_s + e * LDA + c4) = b;
    }
    __syncthreads();
    mm_tn(A_s, B_s, EB, accW);
  };

  for (int w = blockIdx.x; w < num_win; w += gridDim.x) {
    const int* ends_w = ends + (long)w * num_groups;
    const int nsteps = plan_steps(ends_w, num_groups, ecap);
    const long base = (long)w * stride;
    for (int step = 0; step < nsteps; ++step) {
      bool sel = false;
      int u = -1, v = -1;
      if (threadIdx.x < EB)
        sel = applied_rel(lu, lv, rel, ends_w, groups, w, step * EB + threadIdx.x, ecap, stride,
                          num_rel, num_groups, &u, &v) == r;
      const unsigned int ballot = __ballot_sync(0xffffffffu, sel);
      __syncthreads();  // the previous step is done with cnt_s and the pending rows
      if (warp < 2 && lane == 0) cnt_s[warp] = __popc(ballot);
      __syncthreads();
      const int total = cnt_s[0] + cnt_s[1];
      if (sel) {
        const int pos = fill + (warp == 1 ? cnt_s[0] : 0) + __popc(ballot & ((1u << lane) - 1u));
        pu_s[pos] = (int)(base + u);
        pv_s[pos] = (int)(base + v);
      }
      fill += total;
      if (fill >= EB) {
        flush(EB);
        __syncthreads();  // the product is done reading the pending rows' data
        if (threadIdx.x < fill - EB) {
          pu_s[threadIdx.x] = pu_s[EB + threadIdx.x];
          pv_s[threadIdx.x] = pv_s[EB + threadIdx.x];
        }
        fill -= EB;
      }
    }
  }
  if (fill > 0) flush(fill);
  store_tn(part + ((long)blockIdx.x * num_rel + r) * C * C, accW, false);
}

inline int plan_dw_smem() { return 2 * EB * LDA * (int)sizeof(float) + (4 * EB + 2) * (int)sizeof(int); }

// The dW_rel pass on splits x num_rel blocks, then its partials summed in
// split order into dw [num_rel, C, C].
template <typename T, typename G>
int launch_plan_dw(const T* feat, const G* g, const int* lu, const int* lv, const int* rel,
                   const int* ends, const Groups& groups, float* part, float* dw, int num_win,
                   int stride, int ecap, int num_rel, int num_groups, int splits,
                   cudaStream_t stream) {
  const int smem = plan_dw_smem();
  cudaError_t e = set_smem((const void*)plan_dw_kernel<T, G>, smem);
  if (e != cudaSuccess) return (int)e;
  if (splits > 0 && num_rel > 0) {
    plan_dw_kernel<T, G><<<dim3(splits, num_rel), NT, smem, stream>>>(
        feat, g, lu, lv, rel, ends, groups, part, num_win, stride, ecap, num_rel, num_groups);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)reduce_partials(part, dw, splits, (long)num_rel * C * C, stream);
}

}  // namespace lgk
