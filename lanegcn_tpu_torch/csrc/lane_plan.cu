// Fused LaneConv residual layer with the window plan's aggregate inside it,
// forward and backward.
//
// Replaces lanegcn_tpu/ops/pallas_lane_layer.py `_fwd_kernel_plan` /
// `_fwd_impl_plan` and `_bwd_kernel_plan` / `_bwd_impl_plan` (the Pallas
// kernels behind `fused_lane_layer_plan`). The node rows are windows of
// `stride` rows (stride % 128 == 0) and the plan's slots are window-local
// (plan.cuh). Per node row u of window w:
//
//   temp = pre + Σ_j band_j[u] · feat[u + s_j] @ Wb_j
//              + Σ_{applied slots (u ← v, r)} rnd(feat[w·stride + v] @ W_rel[r])
//   out  = relu(GN2(relu(GN1(temp)) @ W2) + feat)
//
// Each plan message is rounded to the activation dtype before it is added
// into the fp32 temp, as the TPU kernel rounds its one-hot scatter's operand.
//
// Forward (`lane_plan_fwd`): lane_layer's tile block (lane_band.cuh), with
// the plan between the band products and the tail. A 64-row tile lies in one
// window; after its band products it walks that window's plan slots in slot
// order, 64 at a time, keeps the applied slots whose lu falls in its rows
// (compacted with a ballot), and for every 64 kept edges gathers their
// source rows, runs one masked [64 x 128] x [128 x 128] product per relation
// present, rounds the messages and adds them into its temp rows in slot
// order (one thread per channel): no atomics, a fixed order, so a rerun is
// bitwise equal. Then the tail, as in lane_layer.
//
// Backward (`lane_plan_bwd`), from the forward's fp32 temp:
//
//   row pass  (tail_bwd.cuh)  d_y, d_temp, dW2, dGN; dpre = d_temp
//   band pass dx[p] = d_y[p] + Σ_j band transposes (lane_band.cuh)
//                   + Σ_{applied slots with lv = p} rnd(rnd(d_temp[u]) @ W_rᵀ)
//   dWb pass  as lane_layer_bwd
//   dW_rel    Σ feat[v]ᵀ rnd(d_temp[u]) per relation: (split, relation)
//             blocks (plan.cuh), partials summed in split order
//
// The band pass's tile owns its rows as plan sources: the forward's plan
// walk with lu and lv swapped, rnd(d_temp) rows gathered and W_rᵀ as the
// weights. dx is summed in fp32 and rounded once, where the TPU kernel
// rounds it after every 512-slot chunk. No float atomics anywhere.
//
// What bounds it: the band and W2 products of lane_layer plus one [128 x
// 128] product per applied plan edge (forward), two per edge in the
// backward, against lane_layer's traffic plus the plan and the gathered rows:
// operation-bound at the bf16 matrix rate, and far from it on the CUDA cores
// this version uses. What the merge keeps out of device memory: the separate
// plan kernel's read of temp and write of its output (2 x 53 MB in bf16 at
// N = 208,896), and its dfeat pass's read of g and write of dfeat. What it
// costs: every tile of a window reads the window's whole plan (12 tiles of
// a 768-row window), and a kept batch of 64 edges runs one full product for
// each relation present in it.
#include "lane_band.cuh"
#include "plan.cuh"

using namespace lgk;

namespace {

struct PlanArgs {
  const int* ldst;  // window-local destination (lu forward, lv backward)
  const int* lsrc;  // window-local source (lv forward, lu backward)
  const int* rel;
  const int* ends;  // [num_win, num_groups] cumulative chunk ends
  Groups groups;
  int stride, ecap, num_rel, num_groups;
};

// Shared memory the plan walk adds to a tile block: A_s [EB][LDA] and the
// pending edges.
constexpr int PLAN_SMEM_FLOATS = EB * LDA;
constexpr int PLAN_SMEM_INTS = 3 * 2 * EB + 3;

// T_s[d − t0] += rnd(src[base + s] @ W_r) over the applied slots
// (d ← s, r) of window w with d in [t0, t0 + TM), in slot order. src rows
// are G (T: feat; fp32: d_temp, rounded to T as read); with TRANSPOSE the
// product is by W_rᵀ. T_s must be complete and visible to every thread; on return it
// holds the sums (a barrier follows the last add).
template <typename T, typename G, bool TRANSPOSE>
__device__ void plan_tile(float* T_s, float* A_s, float* W_s, int* ints, const G* __restrict__ src,
                          const T* __restrict__ w_rel, const PlanArgs& pa, long w, int t0) {
  int* pd_s = ints;            // [2*EB] pending destination rows (tile-local)
  int* ps_s = pd_s + 2 * EB;   // [2*EB] pending source rows (window-local)
  int* pr_s = ps_s + 2 * EB;   // [2*EB] pending relations
  int* cnt_s = pr_s + 2 * EB;  // [2] per-warp selected counts
  unsigned int* present_s = reinterpret_cast<unsigned int*>(cnt_s + 2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* ends_w = pa.ends + w * pa.num_groups;
  const long base = w * pa.stride;
  const int nsteps = plan_steps(ends_w, pa.num_groups, pa.ecap);
  int fill = 0;  // pending edges (the same value in every thread)

  auto flush = [&](int count) {
    __syncthreads();  // pending edges written; the previous flush's adds are done
    if (threadIdx.x == 0) *present_s = 0u;
    for (int idx = threadIdx.x; idx < EB * (C / 4); idx += NT) {
      const int e = idx / (C / 4), c4 = (idx % (C / 4)) * 4;
      float4 a = zero4();
      if (e < count) a = load_rnd4<T, G>(src + (base + ps_s[e]) * C + c4);
      *reinterpret_cast<float4*>(A_s + e * LDA + c4) = a;
    }
    __syncthreads();
    if (threadIdx.x < count) atomicOr(present_s, 1u << pr_s[threadIdx.x]);
    __syncthreads();
    const unsigned int present = *present_s;
    float acc[4][8];
    zero_acc(acc);
    for (int r = 0; r < pa.num_rel; ++r) {
      if (!((present >> r) & 1u)) continue;
      __syncthreads();  // the previous relation's product is done with W_s
      if (TRANSPOSE)
        load_weight_t<T>(W_s, w_rel + (long)r * C * C);
      else
        load_weight<T>(W_s, w_rel + (long)r * C * C);
      float m[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) m[i] = (mm_row(i) < count && pr_s[mm_row(i)] == r) ? 1.f : 0.f;
      __syncthreads();
      mm_64x128(A_s, 0, m, W_s, acc);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = rnd<T>(acc[i][j]);
    }
    __syncthreads();  // every product is done reading A_s
    store_acc(A_s, acc);
    __syncthreads();
    if (threadIdx.x < C) {  // one thread per channel, the edges in slot order
      const int c = threadIdx.x;
      for (int e = 0; e < count; ++e) T_s[pd_s[e] * LDA + c] += A_s[e * LDA + c];
    }
  };

  for (int step = 0; step < nsteps; ++step) {
    bool sel = false;
    int d = -1, s = -1, r = -1;
    if (threadIdx.x < EB) {
      r = applied_rel(pa.ldst, pa.lsrc, pa.rel, ends_w, pa.groups, w, step * EB + threadIdx.x,
                      pa.ecap, pa.stride, pa.num_rel, pa.num_groups, &d, &s);
      sel = r >= 0 && d >= t0 && d < t0 + TM;
    }
    const unsigned int ballot = __ballot_sync(0xffffffffu, sel);
    __syncthreads();  // the previous step is done with cnt_s and the pending edges
    if (warp < 2 && lane == 0) cnt_s[warp] = __popc(ballot);
    __syncthreads();
    const int total = cnt_s[0] + cnt_s[1];
    if (sel) {
      const int pos = fill + (warp == 1 ? cnt_s[0] : 0) + __popc(ballot & ((1u << lane) - 1u));
      pd_s[pos] = d - t0;
      ps_s[pos] = s;
      pr_s[pos] = r;
    }
    fill += total;
    if (fill >= EB) {
      flush(EB);
      __syncthreads();  // the adds are done reading the pending edges
      if (threadIdx.x < fill - EB) {
        pd_s[threadIdx.x] = pd_s[EB + threadIdx.x];
        ps_s[threadIdx.x] = ps_s[EB + threadIdx.x];
        pr_s[threadIdx.x] = pr_s[EB + threadIdx.x];
      }
      fill -= EB;
    }
  }
  if (fill > 0) flush(fill);
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(NT)
lane_plan_kernel(const T* __restrict__ feat, const T* __restrict__ pre,
                 const uint8_t* __restrict__ masks, const T* __restrict__ wb,
                 const T* __restrict__ w2, const float* __restrict__ g1w,
                 const float* __restrict__ g1b, const float* __restrict__ g2w,
                 const float* __restrict__ g2b, const T* __restrict__ w_rel, PlanArgs pa,
                 T* __restrict__ out, float* __restrict__ temp_out, int n, int nj, Shifts sh,
                 float eps) {
  extern __shared__ float4 smem4[];
  float* X_s = reinterpret_cast<float*>(smem4);  // [TM + 2*HALO][LDA]
  float* T_s = X_s + HALO_TILE;                  // [TM][LDA]
  float* W_s = T_s + TM * LDA;                   // [C][C]
  float* A_s = W_s + C * C;                      // [EB][LDA]
  int* ints = reinterpret_cast<int*>(A_s + PLAN_SMEM_FLOATS);
  const long tile0 = (long)blockIdx.x * TM;
  const long w = tile0 / pa.stride;

  load_halo<T>(X_s, feat, tile0, n);
  float acc[4][8];
  band_fwd<T>(X_s, W_s, pre, masks, wb, tile0, n, nj, sh, acc);
  store_acc(T_s, acc);
  __syncthreads();
  plan_tile<T, T, false>(T_s, A_s, W_s, ints, feat, w_rel, pa, w, (int)(tile0 - w * pa.stride));
  layer_tail<T>(X_s, T_s, W_s, w2, g1w, g1b, g2w, g2b, out, temp_out, tile0, n, eps);
}

inline int tile_plan_smem() {
  return (HALO_TILE + TM * LDA + C * C + PLAN_SMEM_FLOATS) * (int)sizeof(float) +
         PLAN_SMEM_INTS * (int)sizeof(int);
}

template <typename T>
int launch(const void* feat, const void* pre, const uint8_t* masks, const void* wb,
           const void* w2, const float* g1w, const float* g1b, const float* g2w,
           const float* g2b, const void* w_rel, const PlanArgs& pa, void* out, float* temp_out,
           int n, int nj, const Shifts& sh, float eps, cudaStream_t stream) {
  const int smem = tile_plan_smem();
  cudaError_t err = set_smem((const void*)lane_plan_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = n / TM;
  if (blocks > 0) {
    lane_plan_kernel<T><<<blocks, NT, smem, stream>>>(
        (const T*)feat, (const T*)pre, masks, (const T*)wb, (const T*)w2, g1w, g1b, g2w, g2b,
        (const T*)w_rel, pa, (T*)out, temp_out, n, nj, sh, eps);
  }
  return (int)cudaGetLastError();
}

// Band pass with the plan transpose: dx[p] = d_y[p] + the band transposes +
// Σ_{applied slots with lv = p} rnd(rnd(d_temp[u]) @ W_rᵀ), summed in fp32 in
// T_s and rounded once.
template <typename T>
__global__ void __launch_bounds__(NT)
band_t_plan_kernel(const float* __restrict__ dtemp, const float* __restrict__ dy,
                   const uint8_t* __restrict__ masks, const T* __restrict__ wb,
                   const T* __restrict__ w_rel, PlanArgs pa, T* __restrict__ dx, int n, int nj,
                   Shifts sh) {
  extern __shared__ float4 smem4[];
  float* D_s = reinterpret_cast<float*>(smem4);  // [TM + 2*HALO][LDA]
  float* T_s = D_s + HALO_TILE;                  // [TM][LDA]
  float* W_s = T_s + TM * LDA;                   // [C][C]
  float* A_s = W_s + C * C;                      // [EB][LDA]
  int* ints = reinterpret_cast<int*>(A_s + PLAN_SMEM_FLOATS);
  const long tile0 = (long)blockIdx.x * TM;
  const long w = tile0 / pa.stride;

  load_halo<float>(D_s, dtemp, tile0, n);
  float acc[4][8];
  band_t<T>(D_s, W_s, dy, masks, wb, tile0, n, nj, sh, acc);
  store_acc(T_s, acc);
  __syncthreads();
  plan_tile<T, float, true>(T_s, A_s, W_s, ints, dtemp, w_rel, pa, w,
                            (int)(tile0 - w * pa.stride));
  for (int idx = threadIdx.x; idx < TM * (C / 4); idx += NT) {
    const int r = idx / (C / 4), c4 = (idx % (C / 4)) * 4;
    const long g = tile0 + r;
    if (g < n)
      store4<T>(dx + g * C + c4, *reinterpret_cast<const float4*>(T_s + r * LDA + c4));
  }
}

template <typename T>
int launch_bwd(const T* feat, const float* temp, const uint8_t* masks, const T* wb,
               const T* w2, const float* g1w, const float* g1b, const float* g2w,
               const float* g2b, const T* w_rel, const PlanArgs& pa, int num_win, const T* g,
               T* dx, T* dpre, float* dtemp, float* dy, float* part_tail, float* part_band,
               float* part_rel, float* grads_tail, float* dwb, float* dwr, int n, int nj,
               const Shifts& sh, int tail_blocks, int splits, int splits_rel, float eps,
               cudaStream_t stream) {
  int err = launch_tail_bwd<T, float>(temp, feat, g, w2, g1w, g1b, g2w, g2b, dpre, nullptr,
                                      dtemp, dy, part_tail, grads_tail, n, tail_blocks, eps,
                                      stream);
  if (err != 0) return err;
  const int smem = tile_plan_smem();
  cudaError_t e = set_smem((const void*)band_t_plan_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  // The band pass reads the plan with lu and lv swapped: its tile owns the
  // sources.
  PlanArgs pt = pa;
  pt.ldst = pa.lsrc;
  pt.lsrc = pa.ldst;
  if (n / TM > 0) {
    band_t_plan_kernel<T><<<n / TM, NT, smem, stream>>>(dtemp, dy, masks, wb, w_rel, pt, dx, n,
                                                         nj, sh);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  // dWb reads rnd(d_temp) as the row pass wrote it into dpre (in T).
  err = launch_band_dw<T, T>(feat, dpre, masks, part_band, dwb, n, nj, sh, splits, stream);
  if (err != 0) return err;
  return launch_plan_dw<T, float>(feat, dtemp, pa.ldst, pa.lsrc, pa.rel, pa.ends, pa.groups,
                                  part_rel, dwr, num_win, pa.stride, pa.ecap, pa.num_rel,
                                  pa.num_groups, splits_rel, stream);
}

// The plan's arguments, checked: n = num_win · stride with stride a multiple
// of 128, ecap a multiple of the 512-slot chunk.
int make_plan(const void* lu, const void* lv, const void* rel, const void* ends,
              const void* group_masks, int n, int num_win, int ecap, int num_rel,
              int num_groups, PlanArgs* pa) {
  if (num_win <= 0 || n % num_win || (n / num_win) % 128 || ecap % PCHUNK)
    return (int)cudaErrorInvalidValue;
  const int bad = make_groups(num_groups, num_rel, group_masks, &pa->groups);
  if (bad) return bad;
  pa->ldst = (const int*)lu;
  pa->lsrc = (const int*)lv;
  pa->rel = (const int*)rel;
  pa->ends = (const int*)ends;
  pa->stride = n / num_win;
  pa->ecap = ecap;
  pa->num_rel = num_rel;
  pa->num_groups = num_groups;
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (feat, pre, wb, w2, w_rel [R, C, C] (in,
// out), out); masks [nj, n] bytes (0/1); GN vectors fp32 [128]; shifts: host
// array of nj ints; lu/lv/rel: int32 [num_win*ecap]; ends: int32 [num_win,
// num_groups] cumulative 512-slot chunk ends per group; group_masks: host
// array of num_groups relation bitmasks; temp_out: fp32 [n, 128] that
// receives temp, or null.
extern "C" int lane_plan_fwd(const void* feat, const void* pre, const void* masks,
                             const void* wb, const void* w2, const void* g1w, const void* g1b,
                             const void* g2w, const void* g2b, const void* w_rel, const void* lu,
                             const void* lv, const void* rel, const void* ends,
                             const void* group_masks, void* out, void* temp_out, int n, int nj,
                             const void* shifts, int num_win, int ecap, int num_rel,
                             int num_groups, float eps, int dtype, void* stream) {
  Shifts sh;
  int bad = make_shifts(nj, (const int*)shifts, &sh);
  if (bad) return bad;
  PlanArgs pa;
  bad = make_plan(lu, lv, rel, ends, group_masks, n, num_win, ecap, num_rel, num_groups, &pa);
  if (bad) return bad;
  cudaStream_t st = (cudaStream_t)stream;
  const float *a = (const float*)g1w, *b = (const float*)g1b, *c = (const float*)g2w,
              *d = (const float*)g2b;
  const uint8_t* m = (const uint8_t*)masks;
  if (dtype == 0)
    return launch<float>(feat, pre, m, wb, w2, a, b, c, d, w_rel, pa, out, (float*)temp_out, n,
                         nj, sh, eps, st);
  if (dtype == 1)
    return launch<bf16>(feat, pre, m, wb, w2, a, b, c, d, w_rel, pa, out, (float*)temp_out, n,
                        nj, sh, eps, st);
  return (int)cudaErrorInvalidValue;
}

// Backward. temp: the forward's fp32 temp; g: the output cotangent in feat's
// dtype; dx, dpre [n, 128] in feat's dtype; dtemp, dy: fp32 [n, 128]
// workspace; part_tail: tail_blocks * (C*C + 4*C), part_band: splits * nj *
// C*C and part_rel: splits_rel * num_rel * C*C fp32 workspace; grads_tail:
// fp32 [C*C + 4*C] = dW2, dg1w, dg1b, dg2w, dg2b; dwb: fp32 [nj, C, C]; dwr:
// fp32 [num_rel, C, C].
extern "C" int lane_plan_bwd(const void* feat, const void* temp, const void* masks,
                             const void* wb, const void* w2, const void* g1w, const void* g1b,
                             const void* g2w, const void* g2b, const void* w_rel, const void* lu,
                             const void* lv, const void* rel, const void* ends,
                             const void* group_masks, const void* g, void* dx, void* dpre,
                             void* dtemp, void* dy, void* part_tail, void* part_band,
                             void* part_rel, void* grads_tail, void* dwb, void* dwr, int n,
                             int nj, const void* shifts, int num_win, int ecap, int num_rel,
                             int num_groups, int tail_blocks, int splits, int splits_rel,
                             float eps, int dtype, void* stream) {
  Shifts sh;
  int bad = make_shifts(nj, (const int*)shifts, &sh);
  if (bad) return bad;
  PlanArgs pa;
  bad = make_plan(lu, lv, rel, ends, group_masks, n, num_win, ecap, num_rel, num_groups, &pa);
  if (bad) return bad;
  cudaStream_t st = (cudaStream_t)stream;
  const float *t = (const float*)temp, *a = (const float*)g1w, *b = (const float*)g1b,
              *c = (const float*)g2w, *d = (const float*)g2b;
  const uint8_t* m = (const uint8_t*)masks;
  float *dt = (float*)dtemp, *y = (float*)dy, *pt = (float*)part_tail, *pb = (float*)part_band,
        *pr = (float*)part_rel, *gt = (float*)grads_tail, *gb = (float*)dwb, *gr = (float*)dwr;
  if (dtype == 0)
    return launch_bwd<float>((const float*)feat, t, m, (const float*)wb, (const float*)w2, a, b,
                             c, d, (const float*)w_rel, pa, num_win, (const float*)g, (float*)dx,
                             (float*)dpre, dt, y, pt, pb, pr, gt, gb, gr, n, nj, sh, tail_blocks,
                             splits, splits_rel, eps, st);
  if (dtype == 1)
    return launch_bwd<bf16>((const bf16*)feat, t, m, (const bf16*)wb, (const bf16*)w2, a, b, c,
                            d, (const bf16*)w_rel, pa, num_win, (const bf16*)g, (bf16*)dx,
                            (bf16*)dpre, dt, y, pt, pb, pr, gt, gb, gr, n, nj, sh, tail_blocks,
                            splits, splits_rel, eps, st);
  return (int)cudaErrorInvalidValue;
}
