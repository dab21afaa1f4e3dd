// Window-plan aggregation of the LaneConv overflow edges, forward.
//
// Replaces lanegcn_tpu/ops/pallas_scenario_agg.py `_fwd_kernel` /
// `_pallas_fwd` (the Pallas kernel behind `scenario_aggregate`). With the
// windowed node layout (window w owns rows [w*stride, (w+1)*stride)) every
// planned edge is window-local:
//
//   out[w*stride + lu] = temp[..] + Σ_planned W_rel[rel] · feat[w*stride + lv]
//
// Slots are prefix-dense per window and chunk-aligned per relation group
// (512-slot chunks, the packer's layout); a chunk in group g applies only
// group g's relations, and chunks past the last group's end are skipped,
// exactly as on the TPU.
//
// What bounds it: the useful work is (valid planned edges) x 128 x 128 MACs
// (a few GFLOP per launch at the bench geometry) against ~155 MB of
// traffic (temp and out whole, feat at the rows the edges read), so at the
// card's rates it is memory-bound. The TPU
// kernel used one-hot matmuls to gather and scatter; here the gather is an
// indexed row load and the scatter an indexed add in shared memory. A block
// owns one window and a 32-channel slice of it, so no two blocks write the
// same element and the window's accumulator stays in shared memory in fp32
// (no float atomics anywhere; the sum order is fixed, so the result is
// deterministic). The port rounds the output once, where the TPU kernel
// rounded after every chunk. Edges are taken 64 at a time; within a window
// the packer orders them by relation, so a 64-edge group touches few
// relations and each present relation costs one masked [64 x 128] x
// [128 x 32] product.
//
// Backward (`scenario_agg_bwd`): replaces pallas_scenario_agg.py
// `_bwd_kernel` / `_pallas_bwd`. Per applied edge (u ← v, relation r):
//
//   d_msg = g[u];  dfeat[v] += d_msg @ W_rᵀ;  dW_r += feat[v]ᵀ d_msg;  dtemp = g
//
// dfeat is the forward kernel run backwards: the same block-owned window x
// channel slice, gathering g at lu and scattering to lv through W_rᵀ (the
// wrapper hands in the transposed weights), zero-initialised. dW_rel is
// [14, 128, 128]: a (split, relation) grid of blocks walks its slice of the
// windows in order, gathers the slots of its relation 64 at a time
// (compacted with a ballot, so a block runs products only on its own
// relation's edges) and sums feat[v]ᵀ g[u] into an 8 x 8 register block per
// thread; a second pass sums the split partials in order (deterministic).
// Groups and chunk ends are honoured exactly as in the forward. What bounds
// it: two products on the applied edges (22.9 GFLOP at the 256-scenario
// pack) against ~150 MB: memory-bound at the bf16 matrix rate.
#include "plan.cuh"

using namespace lgk;

namespace {

template <typename T>
__global__ void __launch_bounds__(NT)
scenario_agg_kernel(const T* __restrict__ feat, const T* __restrict__ temp,
                    const T* __restrict__ w_rel, const int* __restrict__ lu,
                    const int* __restrict__ lv, const int* __restrict__ rel,
                    const int* __restrict__ ends, Groups groups, T* __restrict__ out,
                    int stride, int ecap, int num_rel, int num_groups) {
  extern __shared__ float4 smem4[];
  float* acc_s = reinterpret_cast<float*>(smem4);  // [stride][SLICE]
  float* G_s = acc_s + stride * SLICE;             // [EB][LDA]
  float* W_s = G_s + EB * LDA;                     // [C][SLICE]
  float* M_s = W_s + C * SLICE;                    // [EB][MLD]
  int* lu_s = reinterpret_cast<int*>(M_s + EB * MLD);
  int* lv_s = lu_s + EB;
  int* rel_s = lv_s + EB;
  unsigned int* present_s = reinterpret_cast<unsigned int*>(rel_s + EB);

  const int w = blockIdx.x;
  const int cs = blockIdx.y * SLICE;
  const long base = (long)w * stride;

  for (int idx = threadIdx.x; idx < stride * SLICE; idx += NT) {
    const int r = idx / SLICE, c = idx % SLICE;
    acc_s[idx] = temp ? to_f<T>(temp[(base + r) * C + cs + c]) : 0.f;
  }

  const int* ends_w = ends + (long)w * num_groups;
  const int nchunks = ends_w[num_groups - 1];
  const int nsteps = min(nchunks * (PCHUNK / EB), (ecap + EB - 1) / EB);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int step = 0; step < nsteps; ++step) {
    const int ck = (step * EB) / PCHUNK;
    int gi = 0;
    while (gi < num_groups - 1 && ck >= ends_w[gi]) ++gi;
    const unsigned int allowed = groups.mask[gi];

    __syncthreads();  // previous step done with lu_s / G_s / M_s
    if (threadIdx.x == 0) *present_s = 0u;
    __syncthreads();
    if (threadIdx.x < EB) {
      const int slot = step * EB + threadIdx.x;
      int u = -1, v = -1, r = -1;
      if (slot < ecap) {
        const long e = (long)w * ecap + slot;
        u = lu[e];
        v = lv[e];
        r = rel[e];
      }
      const bool ok = u >= 0 && u < stride && v >= 0 && v < stride && r >= 0 &&
                      r < num_rel && ((allowed >> r) & 1u);
      lu_s[threadIdx.x] = ok ? u : -1;
      lv_s[threadIdx.x] = ok ? v : -1;
      rel_s[threadIdx.x] = ok ? r : -1;
      if (ok) atomicOr(present_s, 1u << r);
    }
    __syncthreads();
    const unsigned int present = *present_s;
    if (present == 0u) continue;

    // Gather the source rows (all channels: they are the product's K axis).
    for (int idx = threadIdx.x; idx < EB * (C / 4); idx += NT) {
      const int i = idx / (C / 4), c4 = (idx % (C / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (lu_s[i] >= 0) v = load4<T>(feat + (base + lv_s[i]) * C + c4);
      *reinterpret_cast<float4*>(G_s + i * LDA + c4) = v;
    }

    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const int row0 = (threadIdx.x >> 3) * 2;
    for (int r = 0; r < num_rel; ++r) {
      if (!((present >> r) & 1u)) continue;
      __syncthreads();  // G_s written / previous relation done with W_s
      for (int idx = threadIdx.x * 4; idx < C * SLICE; idx += NT * 4) {
        const int k = idx / SLICE, c = idx % SLICE;
        *reinterpret_cast<float4*>(W_s + idx) =
            load4<T>(w_rel + ((long)r * C + k) * C + cs + c);
      }
      __syncthreads();
      const float scale[2] = {rel_s[row0] == r ? 1.f : 0.f, rel_s[row0 + 1] == r ? 1.f : 0.f};
      mm_64x32(G_s, scale, W_s, acc);
    }
    const int col0 = (threadIdx.x & 7) * 4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) M_s[(row0 + i) * MLD + col0 + j] = acc[i][j];
    }
    __syncthreads();
    // Scatter in edge order by one warp (lane = channel): fixed order, no races.
    if (warp == 0) {
      for (int e = 0; e < EB; ++e) {
        const int u = lu_s[e];
        if (u >= 0) acc_s[u * SLICE + lane] += M_s[e * MLD + lane];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < stride * SLICE; idx += NT) {
    const int r = idx / SLICE, c = idx % SLICE;
    out[(base + r) * C + cs + c] = from_f<T>(acc_s[idx]);
  }
}

template <typename T>
int launch(const void* feat, const void* temp, const void* w_rel, const int* lu, const int* lv,
           const int* rel, const int* ends, const Groups& groups, void* out, int num_win,
           int stride, int ecap, int num_rel, int num_groups, cudaStream_t stream) {
  const int smem = (stride * SLICE + EB * LDA + C * SLICE + EB * MLD) * (int)sizeof(float) +
                   (3 * EB + 4) * (int)sizeof(int);
  cudaError_t err = set_smem((const void*)scenario_agg_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  if (num_win > 0) {
    dim3 grid(num_win, C / SLICE);
    scenario_agg_kernel<T><<<grid, NT, smem, stream>>>(
        (const T*)feat, (const T*)temp, (const T*)w_rel, lu, lv, rel, ends, groups, (T*)out,
        stride, ecap, num_rel, num_groups);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* feat, const void* g, const void* w_rel_t, const int* lu,
               const int* lv, const int* rel, const int* ends, const Groups& groups,
               void* dfeat, float* part, float* dw, int num_win, int stride, int ecap,
               int num_rel, int num_groups, int splits, cudaStream_t stream) {
  // dfeat: the forward kernel with lu and lv swapped, g as the gathered rows,
  // W_relᵀ as the weights and no temp.
  int err = launch<T>(g, nullptr, w_rel_t, lv, lu, rel, ends, groups, dfeat, num_win, stride,
                      ecap, num_rel, num_groups, stream);
  if (err != 0) return err;
  return launch_plan_dw<T, T>((const T*)feat, (const T*)g, lu, lv, rel, ends, groups, part, dw,
                              num_win, stride, ecap, num_rel, num_groups, splits, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (feat, temp, w_rel [R, C, C] (in, out), out);
// lu/lv/rel: int32 [num_win*ecap]; ends: int32 [num_win, num_groups] cumulative
// 512-slot chunk ends per group; group_masks: host array of num_groups
// relation bitmasks.
extern "C" int scenario_agg_fwd(const void* feat, const void* temp, const void* w_rel,
                                const void* lu, const void* lv, const void* rel,
                                const void* ends, const void* group_masks, void* out,
                                int num_win, int stride, int ecap, int num_rel,
                                int num_groups, int dtype, void* stream) {
  Groups g;
  const int bad = make_groups(num_groups, num_rel, group_masks, &g);
  if (bad) return bad;
  cudaStream_t st = (cudaStream_t)stream;
  const int *a = (const int*)lu, *b = (const int*)lv, *c = (const int*)rel,
            *d = (const int*)ends;
  if (dtype == 0)
    return launch<float>(feat, temp, w_rel, a, b, c, d, g, out, num_win, stride, ecap,
                         num_rel, num_groups, st);
  if (dtype == 1)
    return launch<bf16>(feat, temp, w_rel, a, b, c, d, g, out, num_win, stride, ecap,
                        num_rel, num_groups, st);
  return (int)cudaErrorInvalidValue;
}

// Backward. g: the output cotangent in feat's dtype; w_rel_t: [R, C, C] with
// each relation's weight transposed, in feat's dtype; dfeat [n, 128] in
// feat's dtype; part: splits * R * C*C fp32 workspace; dw: fp32 [R, C, C].
// The cotangent of temp is g itself (the wrapper returns it).
extern "C" int scenario_agg_bwd(const void* feat, const void* g, const void* w_rel_t,
                                const void* lu, const void* lv, const void* rel,
                                const void* ends, const void* group_masks, void* dfeat,
                                void* part, void* dw, int num_win, int stride, int ecap,
                                int num_rel, int num_groups, int splits, int dtype,
                                void* stream) {
  Groups gr;
  const int bad = make_groups(num_groups, num_rel, group_masks, &gr);
  if (bad) return bad;
  cudaStream_t st = (cudaStream_t)stream;
  const int *a = (const int*)lu, *b = (const int*)lv, *c = (const int*)rel,
            *d = (const int*)ends;
  if (dtype == 0)
    return launch_bwd<float>(feat, g, w_rel_t, a, b, c, d, gr, dfeat, (float*)part, (float*)dw,
                             num_win, stride, ecap, num_rel, num_groups, splits, st);
  if (dtype == 1)
    return launch_bwd<bf16>(feat, g, w_rel_t, a, b, c, d, gr, dfeat, (float*)part, (float*)dw,
                            num_win, stride, ecap, num_rel, num_groups, splits, st);
  return (int)cudaErrorInvalidValue;
}
