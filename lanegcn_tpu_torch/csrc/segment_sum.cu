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
// What bounds it: bytes. Every output row is written once, base's rows are
// read once, and each kept edge row is read once; there are no products. At
// the LaneConv stack's residue scatter a few thousand kept edges land in
// 208,896 rows, so nearly all of the work is copying base (or writing
// zeros), and the kernel has to run that copy at the card's memory rate.
// The TPU kernel contracted each block's edge window with a one-hot
// [rows x window] matrix on the MXU, which is how a TPU avoids a scatter;
// here a row's run is contiguous and read directly.
//
// Design. A block owns 128 destination rows (32 where the rows are too few
// to give every SM several 128-row blocks) and finds its edges [blo, bhi)
// with one pair of searches in seg (what torch.searchsorted computes, on the
// device, without a host sync), a warp each, 32 probes a step; the dropped
// tail (seg ≥ n) never enters a block. One pass over the block's
// edges writes each row's run [lo, hi) into a shared-memory table: an edge
// starts a run where its seg differs from its left neighbour's and ends one
// where it differs from its right neighbour's. Then
//   - rows without edges are a straight copy of base (or zeros), moved by
//     all threads in 16-byte chunks, 8 in flight per thread, the first
//     batch loaded before the searches: neighbouring threads take
//     neighbouring chunks, and neighbouring rows are neighbours in memory;
//   - in rows with edges each thread sums its 16-byte chunk of the row: it
//     starts from base's chunk (zero without base) and adds the run's
//     edges in edge order in fp32, loading 4 edges ahead of the additions,
//     and rounds once. That is the order of the first version of this
//     kernel (32-row blocks, a binary search per row, a warp per row), so
//     the output is bitwise equal to it and a rerun is bitwise equal to
//     itself: no atomics, where index_add_'s atomics sum in whatever order
//     they land.
// Rows or pointers that do not allow 16-byte chunks (cols·sizeof(T) not a
// multiple of 16) take the same plan one element at a time.
#include <type_traits>

#include "common.cuh"

using namespace lgk;

namespace {

// The first e in [0, n) with seg[e] ≥ key (n if none), found by one warp:
// 32 probes a step, so ~log32(n) dependent loads where a binary search takes
// log2(n) (4 steps instead of 19 at 274,432 edges). Every lane returns it.
__device__ __forceinline__ long warp_lower_bound(const long long* seg, long n, long long key) {
  const int lane = threadIdx.x & 31;
  long lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const long step = (hi - lo + 31) / 32;
    const long p = lo + lane * step;
    const unsigned less = __ballot_sync(0xffffffffu, p < hi && seg[p] < key);
    const int c = __popc(less);  // probes below key: the first c (seg is sorted)
    if (c == 0) return lo;
    const long below = lo + (long)(c - 1) * step, above = below + step;
    lo = below + 1;
    if (c < 32 && above < hi) hi = above;
  }
  const unsigned less = __ballot_sync(0xffffffffu, lo + lane < hi && seg[lo + lane] < key);
  return lo + __popc(less);
}

constexpr int AHEAD = 4;   // edge rows loaded ahead of the additions
constexpr int UNROLL = 8;  // chunks a thread loads at once: 128 bf16 rows in one batch

// One 16-byte chunk (8 bf16 or 4 floats) or one element of a row, as floats.
template <typename T, int CHUNK> struct Chunk;
template <typename T> struct Element {
  static constexpr int N = 1;
  typedef T Raw;
  static __device__ __forceinline__ void unpack(Raw x, float (&v)[N]) { v[0] = to_f<T>(x); }
  static __device__ __forceinline__ Raw pack(const float (&v)[N]) { return from_f<T>(v[0]); }
};
template <> struct Chunk<float, 4> : Element<float> {};
template <> struct Chunk<bf16, 2> : Element<bf16> {};
template <> struct Chunk<float, 16> {
  static constexpr int N = 4;
  typedef uint4 Raw;
  static __device__ __forceinline__ void unpack(Raw x, float (&v)[N]) {
    v[0] = __uint_as_float(x.x), v[1] = __uint_as_float(x.y);
    v[2] = __uint_as_float(x.z), v[3] = __uint_as_float(x.w);
  }
  static __device__ __forceinline__ Raw pack(const float (&v)[N]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};
template <> struct Chunk<bf16, 16> {
  static constexpr int N = 8;
  typedef uint4 Raw;
  static __device__ __forceinline__ void unpack(Raw x, float (&v)[N]) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h;
      memcpy(&h, &w[i], 4);
      const float2 f = __bfloat1622float2(h);
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ Raw pack(const float (&v)[N]) {
    return tc::pack8(make_float4(v[0], v[1], v[2], v[3]), make_float4(v[4], v[5], v[6], v[7]));
  }
};

// One chunk of one destination row from the row's run of ne edges: d
// points at the chunk in the run's first edge row (edge rows cpr chunks
// apart); the sum starts from base's chunk (init: base's, or zeros) and
// adds the edges in edge order in fp32, AHEAD loads in flight.
template <typename T, int CHUNK>
__device__ __forceinline__ typename Chunk<T, CHUNK>::Raw sum_chunk(
    const typename Chunk<T, CHUNK>::Raw* __restrict__ d, int ne, int cpr,
    typename Chunk<T, CHUNK>::Raw init) {
  typedef Chunk<T, CHUNK> K;
  float acc[K::N];
  K::unpack(init, acc);
  int e = 0;
  for (; e + AHEAD <= ne; e += AHEAD) {
    typename K::Raw x[AHEAD];
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) x[k] = d[(long)(e + k) * cpr];
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
      float v[K::N];
      K::unpack(x[k], v);
#pragma unroll
      for (int i = 0; i < K::N; ++i) acc[i] += v[i];
    }
  }
  for (; e < ne; ++e) {
    float v[K::N];
    K::unpack(d[(long)e * cpr], v);
#pragma unroll
    for (int i = 0; i < K::N; ++i) acc[i] += v[i];
  }
  return K::pack(acc);
}

// ROWS destination rows per block. CHUNK: 16 (rows move and sum in
// 16-byte chunks) or the element size (one element a thread).
template <typename T, int ROWS, int CHUNK>
__global__ void __launch_bounds__(NT)
segment_sum_kernel(const T* __restrict__ data, const long long* __restrict__ seg,
                   const T* __restrict__ base, T* __restrict__ out, long num_edges,
                   int num_segments, int cols) {
  __shared__ int lo_s[ROWS], hi_s[ROWS];
  __shared__ long blk_s[2];
  typedef Chunk<T, CHUNK> K;
  typedef typename K::Raw Raw;
  const long s0 = (long)blockIdx.x * ROWS;
  const int rows = (int)min((long)ROWS, (long)num_segments - s0);
  const int cpr = cols * (int)sizeof(T) / CHUNK;  // chunks per row
  const int total = rows * cpr;
  const Raw* bc = base ? reinterpret_cast<const Raw*>(base + s0 * cols) : nullptr;
  Raw* oc = reinterpret_cast<Raw*>(out + s0 * cols);
  Raw zero;
  memset(&zero, 0, sizeof(zero));
  // base's chunks of the first batch (a whole 128-row block of bf16 rows),
  // loaded before the searches so that their latency hides the searches'.
  Raw v[UNROLL];
#pragma unroll
  for (int k = 0; k < UNROLL; ++k) {
    const int i = threadIdx.x + k * NT;
    v[k] = (base && i < total) ? bc[i] : zero;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 2) {  // the block's edges [blk_s[0], blk_s[1]), a warp each
    const long e = warp_lower_bound(seg, num_edges, warp ? s0 + rows : s0);
    if (lane == 0) blk_s[warp] = e;
  }
  for (int r = threadIdx.x; r < ROWS; r += NT) lo_s[r] = hi_s[r] = 0;
  __syncthreads();
  const long blo = blk_s[0], bhi = blk_s[1];

  // The run table: [lo, hi) of each row's edges, relative to blo.
  for (long e = blo + threadIdx.x; e < bhi; e += NT) {
    const long long s = seg[e];
    const int r = (int)(s - s0);
    if (e == blo || seg[e - 1] != s) lo_s[r] = (int)(e - blo);
    if (e + 1 == bhi || seg[e + 1] != s) hi_s[r] = (int)(e + 1 - blo);
  }
  __syncthreads();

  // Every chunk of the block's rows, UNROLL a batch per thread: a row
  // without edges is base's row (or zeros); a row with edges sums its run,
  // each thread its chunk (neighbouring threads take neighbouring chunks of
  // a row, and neighbouring rows are neighbours in memory).
  const Raw* dc = reinterpret_cast<const Raw*>(data + blo * cols);
  for (int i0 = threadIdx.x; i0 < total; i0 += UNROLL * NT) {
    if (i0 != threadIdx.x) {  // later batches load here
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const int i = i0 + k * NT;
        v[k] = (base && i < total) ? bc[i] : zero;
      }
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int i = i0 + k * NT;
      if (i >= total) break;
      const int r = i / cpr, c = i - r * cpr;
      const int lo = lo_s[r], hi = hi_s[r];
      oc[i] = lo == hi ? v[k] : sum_chunk<T, CHUNK>(dc + (long)lo * cpr + c, hi - lo, cpr, v[k]);
    }
  }
}

// Rows per block: 128 where that still gives every SM several blocks, else
// 32 (small row counts with many edges a row, such as LanePooling's and the
// flat pack's gathers' backwards, need the blocks).
constexpr int ROWS_BIG = 128, ROWS_SMALL = 32;
constexpr long BIG_FROM = 32768;  // rows: 256 blocks of ROWS_BIG

template <typename T, int CHUNK>
void launch_rows(const T* data, const long long* seg, const T* base, T* out, long num_edges,
                 int num_segments, int cols, cudaStream_t stream) {
  if (num_segments >= BIG_FROM) {
    const long blocks = ((long)num_segments + ROWS_BIG - 1) / ROWS_BIG;
    segment_sum_kernel<T, ROWS_BIG, CHUNK><<<(unsigned)blocks, NT, 0, stream>>>(
        data, seg, base, out, num_edges, num_segments, cols);
  } else {
    const long blocks = ((long)num_segments + ROWS_SMALL - 1) / ROWS_SMALL;
    segment_sum_kernel<T, ROWS_SMALL, CHUNK><<<(unsigned)blocks, NT, 0, stream>>>(
        data, seg, base, out, num_edges, num_segments, cols);
  }
}

template <typename T>
int launch(const void* data, const long long* seg, const void* base, void* out, long num_edges,
           int num_segments, int cols, cudaStream_t stream) {
  if (num_segments <= 0) return (int)cudaGetLastError();
  const bool chunks = (cols * sizeof(T)) % 16 == 0 &&
                      (((uintptr_t)data | (uintptr_t)base | (uintptr_t)out) & 15) == 0;
  if (chunks)
    launch_rows<T, 16>((const T*)data, seg, (const T*)base, (T*)out, num_edges, num_segments,
                       cols, stream);
  else
    launch_rows<T, (int)sizeof(T)>((const T*)data, seg, (const T*)base, (T*)out, num_edges,
                                   num_segments, cols, stream);
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
