// Window-chunked scatter-add of LanePooling's per-edge messages, forward
// and backward.
//
// Replaces lanegcn_tpu/ops/pallas_window_scatter.py `_fwd_kernel` /
// `_pallas_fwd` (the Pallas kernel behind `window_scatter_add`):
//
//   out = temp;  out[wchunk[e / 512] * stride + lu[e]] += msg[e]   (lu[e] >= 0)
//
// The TPU kernel ran one one-hot [stride x 512] x [512 x 128] matmul per
// 512-edge chunk into a VMEM block of the destination window, rounding the
// block after every chunk. Here the layout the packer emits does the work
// instead: each destination window's edges fill whole chunks, sorted by
// destination row, and `wchunk` is non-decreasing, so every destination
// row's messages are one contiguous run of edges. A warp owns 8 consecutive
// rows of one window: it finds the window's chunk range and the first edge
// of its first row by binary search (every lane reads the same addresses),
// then walks the runs in edge order, each lane summing its 4 channels in
// fp32, adds temp and rounds once. No atomics and no shared memory; the sum
// order is fixed, so reruns are bitwise equal. Rows no edge reaches copy
// temp (the output is a new tensor).
//
// What bounds it: one add per message element, so it moves bytes only: the
// valid messages and temp read once, the output written once (about 0.35 GB
// at 935,627 live r2g edges into 208,896 rows in bf16, ~0.1 ms at the card's
// 3.35 TB/s). Each lane loads 8 (bf16) or 16 (fp32) consecutive bytes, so a
// warp reads a message row as one 256- or 512-byte transaction.
//
// Backward (`window_scatter_bwd`): replaces pallas_window_scatter.py
// `_bwd_kernel` / `_pallas_bwd`, the one-hot [512 x stride] x [stride x 128]
// matmul per chunk. The cotangent of temp is the output cotangent g itself
// (the wrapper passes it on); the messages' is a row gather,
//
//   d_msg[e] = g[wchunk[e / 512] * stride + lu[e]]   (lu[e] >= 0),  0 on padding,
//
// a warp per edge row, each lane copying its 4 channels (no arithmetic, no
// rounding: d_msg is bitwise g's row). What bounds it: bytes only, the
// valid edges' rows of g read and every d_msg row written (0.51 GB at
// 935,627 live of 1,048,576 r2g edges in bf16, ~0.15 ms at 3.35 TB/s).
#include "common.cuh"

using namespace lgk;

namespace {

constexpr int WCH = 512;                  // edges per chunk (the packer's alignment)
constexpr int ROWS_PER_WARP = 8;
constexpr int ROWS_PER_BLOCK = ROWS_PER_WARP * (NT / 32);

template <typename T>
__global__ void __launch_bounds__(NT)
window_scatter_kernel(const T* __restrict__ msg, const T* __restrict__ temp,
                      const int* __restrict__ lu, const int* __restrict__ wchunk,
                      T* __restrict__ out, int stride, int nch) {
  const int w = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * ROWS_PER_BLOCK + warp * ROWS_PER_WARP;
  if (r0 >= stride) return;

  // This window's chunks [c0, c1): wchunk is non-decreasing.
  int lo = 0, hi = nch;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (wchunk[mid] < w) lo = mid + 1; else hi = mid;
  }
  const int c0 = lo;
  hi = nch;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (wchunk[mid] <= w) lo = mid + 1; else hi = mid;
  }
  const long e_end = (long)lo * WCH;

  // First edge of row r0 or later: the window's valid edges are sorted by
  // lu and its padding (lu = -1) follows them.
  long a = (long)c0 * WCH, b = e_end;
  while (a < b) {
    const long mid = (a + b) >> 1;
    const int v = lu[mid];
    if (v >= 0 && v < r0) a = mid + 1; else b = mid;
  }
  long e = a;

  const int r_end = min(r0 + ROWS_PER_WARP, stride);
  for (int r = r0; r < r_end; ++r) {
    float4 acc = zero4();
    while (e < e_end && lu[e] == r) {
      acc = add4(acc, load4<T>(msg + e * C + lane * 4));
      ++e;
    }
    const long row = (long)w * stride + r;
    store4<T>(out + row * C + lane * 4, add4(load4<T>(temp + row * C + lane * 4), acc));
  }
}

// d_msg row e = g row dst(e), or zeros on padding; a warp per row.
template <typename T>
__global__ void __launch_bounds__(NT)
window_scatter_bwd_kernel(const T* __restrict__ g, const int* __restrict__ lu,
                          const int* __restrict__ wchunk, T* __restrict__ dmsg, int stride,
                          long e) {
  const long row = (long)blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  if (row >= e) return;
  const int c = (threadIdx.x & 31) * 4;
  const int l = lu[row];
  float4 v = zero4();
  if (l >= 0) v = load4<T>(g + ((long)wchunk[row / WCH] * stride + l) * C + c);
  store4<T>(dmsg + row * C + c, v);
}

template <typename T>
int launch(const void* msg, const void* temp, const int* lu, const int* wchunk, void* out,
           int num_win, int stride, int nch, cudaStream_t stream) {
  if (num_win > 0 && stride > 0) {
    const dim3 grid((stride + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, num_win);
    window_scatter_kernel<T><<<grid, NT, 0, stream>>>((const T*)msg, (const T*)temp, lu,
                                                      wchunk, (T*)out, stride, nch);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* g, const int* lu, const int* wchunk, void* dmsg, int stride, int nch,
               cudaStream_t stream) {
  const long e = (long)nch * WCH;
  const long blocks = (e + NT / 32 - 1) / (NT / 32);
  if (blocks > 0) {
    window_scatter_bwd_kernel<T><<<(unsigned)blocks, NT, 0, stream>>>((const T*)g, lu, wchunk,
                                                                      (T*)dmsg, stride, e);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (msg [nch*512, 128], temp and out
// [num_win*stride, 128]); lu int32 [nch*512] window-local destination (-1
// padding); wchunk int32 [nch] destination window per chunk, non-decreasing.
extern "C" int window_scatter_fwd(const void* msg, const void* temp, const void* lu,
                                  const void* wchunk, void* out, int num_win, int stride,
                                  int nch, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int *l = (const int*)lu, *wc = (const int*)wchunk;
  if (dtype == 0) return launch<float>(msg, temp, l, wc, out, num_win, stride, nch, st);
  if (dtype == 1) return launch<bf16>(msg, temp, l, wc, out, num_win, stride, nch, st);
  return (int)cudaErrorInvalidValue;
}

// Backward: dmsg [nch*512, 128] = the rows of g [num_win*stride, 128] at each
// edge's destination, zeros on padding; dtype as window_scatter_fwd (g, dmsg).
extern "C" int window_scatter_bwd(const void* g, const void* lu, const void* wchunk, void* dmsg,
                                  int stride, int nch, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int *l = (const int*)lu, *wc = (const int*)wchunk;
  if (dtype == 0) return launch_bwd<float>(g, l, wc, dmsg, stride, nch, st);
  if (dtype == 1) return launch_bwd<bf16>(g, l, wc, dmsg, stride, nch, st);
  return (int)cudaErrorInvalidValue;
}
