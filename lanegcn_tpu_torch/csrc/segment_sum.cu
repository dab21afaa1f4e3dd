// Segment sum over destination-sorted edges.
//
// Replaces lanegcn_tpu/ops/pallas_scatter.py `sorted_segment_sum` (the Pallas
// kernel behind `scatter_add_sorted`):
//
//   out[s] = base[s] + Σ_{e : seg[e] = s} data[e]     seg non-decreasing; seg ≥ n dropped
//
// The port's scatter_add and the backward of its row gathers run on it: the
// caller lists the edges in destination order (the pack's sorted layout or
// inverse, or one stable sort on the device), so each destination row's
// edges form one run.
//
// The kernel and its design are in segment_sum.cuh, shared with
// scenario_agg.cu (which sums fp32 messages into T rows); here data, base
// and out share one dtype. The TPU kernel contracted each block's edge
// window with a one-hot [rows x window] matrix on the MXU, which is how a
// TPU avoids a scatter; here a row's run is contiguous and read directly.
#include "segment_sum.cuh"

using namespace lgk;

// dtype: 0 = float32, 1 = bfloat16 (data [num_edges, cols], base and out
// [num_segments, cols]); seg: int64 [num_edges], non-decreasing; base: the
// rows the sums are added to, or null.
extern "C" int segment_sum(const void* data, const void* seg, const void* base, void* out,
                           long long num_edges, int num_segments, int cols, int dtype,
                           void* stream) {
  if (num_edges < 0 || num_segments < 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long* sg = (const long long*)seg;
  if (dtype == 0)
    return launch_segment_sum<float, float>((const float*)data, sg, (const float*)base,
                                            (float*)out, num_edges, num_segments, cols, st);
  if (dtype == 1)
    return launch_segment_sum<bf16, bf16>((const bf16*)data, sg, (const bf16*)base, (bf16*)out,
                                          num_edges, num_segments, cols, st);
  return (int)cudaErrorInvalidValue;
}
