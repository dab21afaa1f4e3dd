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
// edges form one run. A block owns 32 destination rows and finds its edges
// by binary search in seg (what torch.searchsorted computes, on the device,
// without a host sync); each warp then takes one row at a time, finds the
// row's run [lo, hi) within the block's edges, sums it in edge order in fp32
// starting from base's row (zero without base), rounds once and writes the
// row once. No atomics: the order is fixed, so a rerun is bitwise equal,
// where index_add_'s atomics sum in whatever order they land.
//
// What bounds it: bytes (each edge row read once, each output row written
// once, base read once; no products). The TPU kernel contracted each block's
// edge window with a one-hot [rows x window] matrix on the MXU, which is how
// a TPU avoids a scatter; here a row's run is contiguous and read directly.
// Lanes stride the channels, so a warp reads 32 consecutive elements of an
// edge row at a time.
#include "common.cuh"

using namespace lgk;

namespace {

__device__ __forceinline__ long first_at_least(const long long* seg, long e, long long key) {
  long lo = 0, hi = e;
  while (lo < hi) {
    const long mid = (lo + hi) >> 1;
    if (seg[mid] < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

constexpr int ROWS = 32;  // destination rows per block (4 per warp)

template <typename T>
__global__ void __launch_bounds__(NT)
segment_sum_kernel(const T* __restrict__ data, const long long* __restrict__ seg,
                   const T* __restrict__ base, T* __restrict__ out, long num_edges,
                   int num_segments, int cols) {
  __shared__ long run_s[2];
  const long s0 = (long)blockIdx.x * ROWS;
  // The block's edges [run_s[0], run_s[1]): two searches over all edges per
  // block, then each row's search only within them.
  if (threadIdx.x < 2)
    run_s[threadIdx.x] = first_at_least(seg, num_edges, s0 + (long)threadIdx.x * ROWS);
  __syncthreads();
  const long blo = run_s[0], bhi = run_s[1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < ROWS; r += NT / 32) {
    const long s = s0 + r;
    if (s >= num_segments) break;
    const long lo = blo + first_at_least(seg + blo, bhi - blo, s);
    const long hi = blo + first_at_least(seg + blo, bhi - blo, s + 1);
    for (int c = lane; c < cols; c += 32) {
      float acc = base ? to_f<T>(base[s * cols + c]) : 0.f;
      for (long e = lo; e < hi; ++e) acc += to_f<T>(data[e * cols + c]);
      out[s * cols + c] = from_f<T>(acc);
    }
  }
}

template <typename T>
int launch(const void* data, const long long* seg, const void* base, void* out, long num_edges,
           int num_segments, int cols, cudaStream_t stream) {
  const long blocks = ((long)num_segments + ROWS - 1) / ROWS;
  if (blocks > 0) {
    segment_sum_kernel<T><<<(unsigned)blocks, NT, 0, stream>>>(
        (const T*)data, seg, (const T*)base, (T*)out, num_edges, num_segments, cols);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (data [num_edges, cols], base and out
// [num_segments, cols]); seg: int64 [num_edges], non-decreasing; base: the
// rows the sums are added to, or null.
extern "C" int segment_sum(const void* data, const void* seg, const void* base, void* out,
                           long long num_edges, int num_segments, int cols, int dtype,
                           void* stream) {
  if (num_edges < 0 || num_segments < 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long* sg = (const long long*)seg;
  if (dtype == 0) return launch<float>(data, sg, base, out, num_edges, num_segments, cols, st);
  if (dtype == 1) return launch<bf16>(data, sg, base, out, num_edges, num_segments, cols, st);
  return (int)cudaErrorInvalidValue;
}
