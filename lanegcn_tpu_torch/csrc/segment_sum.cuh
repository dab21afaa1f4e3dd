// Segment sum over destination-sorted edges, shared by segment_sum.cu (the
// port's scatters and gathers' backward) and scenario_agg.cu (the window
// plan's messages, summed into their destination rows):
//
//   out[s] = base[s] + Σ_{e : seg[e] = s} data[e]     seg non-decreasing; seg ≥ n dropped
//
// data is D (float or bf16), base and out T; the sums run in fp32 and round
// once to T.
//
// What bounds it: bytes. Every output row is written once, base's rows are
// read once, and each kept edge row is read once; there are no products. At
// the LaneConv stack's residue scatter a few thousand kept edges land in
// 208,896 rows, so nearly all of the work is copying base (or writing
// zeros), and the kernel has to run that copy at the card's memory rate.
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
//     all threads in 16-byte chunks of T, 8 in flight per thread, the first
//     batch loaded before the searches: neighbouring threads take
//     neighbouring chunks, and neighbouring rows are neighbours in memory;
//   - in rows with edges each thread sums its chunk of the row: it starts
//     from base's chunk (zero without base) and adds the run's edges in
//     edge order in fp32, loading 4 edges ahead of the additions (the
//     run's last 1-3 edges together), and rounds once. No atomics, where
//     index_add_'s atomics sum in whatever order they land: the output is
//     bitwise equal on a rerun.
// Rows or pointers that do not allow 16-byte chunks (cols·sizeof(T) not a
// multiple of 16) take the same plan one element at a time.
//
// The keys are read through an accessor (`Keys`: a plain array of row
// indices), so that window_scatter.cu runs the same blocks on a key it
// derives from its window-chunked layout, with padding slots inside the
// sorted order that belong to no row; and the sum may take base last
// (`BASE_LAST`: the edges summed from zero in edge order, then base added),
// which is window_scatter's order.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace lgk {
namespace seg {

// Sorted keys read through an accessor: keys(e) is entry e's key
// (non-decreasing in e), first(s) the least key of row s, live(k) whether an
// entry of key k belongs to a row, and row(k) that row. Keys<K> is a plain
// array of row indices, every entry live.
template <typename K>
struct Keys {
  const K* p;
  __device__ __forceinline__ long long operator()(long e) const { return p[e]; }
  __device__ __forceinline__ long long first(long s) const { return s; }
  __device__ __forceinline__ bool live(long long) const { return true; }
  __device__ __forceinline__ long row(long long k) const { return (long)k; }
};

// The first e in [0, n) with keys(e) ≥ key (n if none; keys non-decreasing),
// found by one warp: 32 probes a step, so ~log32(n) dependent loads where a
// binary search takes log2(n) (4 steps instead of 19 at 274,432 edges).
// Every lane returns it.
template <typename KS, typename = std::enable_if_t<!std::is_pointer_v<KS>>>
__device__ __forceinline__ long warp_lower_bound(const KS keys, long n, long long key) {
  const int lane = threadIdx.x & 31;
  long lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const long step = (hi - lo + 31) / 32;
    const long p = lo + lane * step;
    const unsigned less = __ballot_sync(0xffffffffu, p < hi && keys(p) < key);
    const int c = __popc(less);  // probes below key: the first c (keys are sorted)
    if (c == 0) return lo;
    const long below = lo + (long)(c - 1) * step, above = below + step;
    lo = below + 1;
    if (c < 32 && above < hi) hi = above;
  }
  const unsigned less = __ballot_sync(0xffffffffu, lo + lane < hi && keys(lo + lane) < key);
  return lo + __popc(less);
}
template <typename K>
__device__ __forceinline__ long warp_lower_bound(const K* seg, long n, long long key) {
  return warp_lower_bound(Keys<K>{seg}, n, key);
}

// The run table of a block's rows [s0, s0 + rows) (rows ≤ ROWS) over the
// sorted keys [num_keys]: blk_s = the block's entries [blo, bhi), and row
// s0 + r's entries are [blo + lo_s[r], blo + hi_s[r]) (lo = hi = 0 for a row
// without entries and for r ≥ rows). Warps 0 and 1 find blo and bhi
// (warp_lower_bound); then one pass over the block's entries: an entry starts
// a run where its key differs from its left neighbour's and ends one where it
// differs from its right neighbour's; entries that belong to no row (not
// live) are passed over. Every thread of the block calls it; on return the
// table is visible to every thread.
template <int ROWS, typename KS, typename = std::enable_if_t<!std::is_pointer_v<KS>>>
__device__ __forceinline__ void run_table(const KS keys, long num_keys, long s0, int rows,
                                          int* lo_s, int* hi_s, long* blk_s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 2) {
    const long e = warp_lower_bound(keys, num_keys, keys.first(warp ? s0 + rows : s0));
    if (lane == 0) blk_s[warp] = e;
  }
  for (int r = threadIdx.x; r < ROWS; r += blockDim.x) lo_s[r] = hi_s[r] = 0;
  __syncthreads();
  const long blo = blk_s[0], bhi = blk_s[1];
  for (long e = blo + threadIdx.x; e < bhi; e += blockDim.x) {
    const long long s = keys(e);
    if (!keys.live(s)) continue;
    const int r = (int)(keys.row(s) - s0);
    if (e == blo || keys(e - 1) != s) lo_s[r] = (int)(e - blo);
    if (e + 1 == bhi || keys(e + 1) != s) hi_s[r] = (int)(e + 1 - blo);
  }
  __syncthreads();
}
template <int ROWS, typename K>
__device__ __forceinline__ void run_table(const K* seg, long num_keys, long s0, int rows,
                                          int* lo_s, int* hi_s, long* blk_s) {
  run_table<ROWS>(Keys<K>{seg}, num_keys, s0, rows, lo_s, hi_s, blk_s);
}

constexpr int AHEAD = 4;   // edge rows loaded ahead of the additions
constexpr int UNROLL = 8;  // chunks a thread loads at once: 128 bf16 rows in one batch

// N consecutive elements of X as floats: one element (N = 1), or whole
// 16-byte words (N·sizeof(X) a multiple of 16, the pointer 16-byte aligned).
template <typename X, int N, bool ONE = (N == 1)>
struct Vec {
  static constexpr int W = N * (int)sizeof(X) / 16;
  uint4 w[W];
  __device__ __forceinline__ void load(const X* p) {
#pragma unroll
    for (int k = 0; k < W; ++k) w[k] = reinterpret_cast<const uint4*>(p)[k];
  }
  __device__ __forceinline__ void store(X* p) const {
#pragma unroll
    for (int k = 0; k < W; ++k) reinterpret_cast<uint4*>(p)[k] = w[k];
  }
  __device__ __forceinline__ void zero() { memset(w, 0, sizeof(w)); }
  __device__ __forceinline__ void unpack(float (&v)[N]) const {
    const uint32_t* u = reinterpret_cast<const uint32_t*>(w);
    if constexpr (sizeof(X) == 4) {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = __uint_as_float(u[i]);
    } else {
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        __nv_bfloat162 h;
        memcpy(&h, &u[i], 4);
        const float2 f = __bfloat1622float2(h);
        v[2 * i] = f.x, v[2 * i + 1] = f.y;
      }
    }
  }
  __device__ __forceinline__ void pack(const float (&v)[N]) {
    uint32_t* u = reinterpret_cast<uint32_t*>(w);
    if constexpr (sizeof(X) == 4) {
#pragma unroll
      for (int i = 0; i < N; ++i) u[i] = __float_as_uint(v[i]);
    } else {
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        memcpy(&u[i], &h, 4);
      }
    }
  }
};
template <typename X, int N>
struct Vec<X, N, true> {
  X x;
  __device__ __forceinline__ void load(const X* p) { x = *p; }
  __device__ __forceinline__ void store(X* p) const { *p = x; }
  __device__ __forceinline__ void zero() { x = from_f<X>(0.f); }
  __device__ __forceinline__ void unpack(float (&v)[1]) const { v[0] = to_f<X>(x); }
  __device__ __forceinline__ void pack(const float (&v)[1]) { x = from_f<X>(v[0]); }
};

// One chunk (N elements) of one destination row from the row's run of ne
// edges: d points at the chunk in the run's first edge row (edge rows cols
// elements apart); the sum starts from init (base's chunk, or zeros) and
// adds the edges in edge order in fp32, AHEAD loads in flight (the run's
// last ne % AHEAD edges loaded together too). BASE_LAST: the sum starts
// from zero and init is added after the edges.
template <typename D, typename T, int N, bool BASE_LAST = false>
__device__ __forceinline__ Vec<T, N> sum_chunk(const D* __restrict__ d, int ne, int cols,
                                               const Vec<T, N>& init) {
  float acc[N];
  if constexpr (BASE_LAST) {
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.f;
  } else {
    init.unpack(acc);
  }
  int e = 0;
  for (; e + AHEAD <= ne; e += AHEAD) {
    Vec<D, N> x[AHEAD];
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) x[k].load(d + (long)(e + k) * cols);
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
      float v[N];
      x[k].unpack(v);
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] += v[i];
    }
  }
  if (e < ne) {  // the last ne - e < AHEAD edges, loaded together
    Vec<D, N> x[AHEAD - 1];
#pragma unroll
    for (int k = 0; k < AHEAD - 1; ++k)
      if (e + k < ne) x[k].load(d + (long)(e + k) * cols);
#pragma unroll
    for (int k = 0; k < AHEAD - 1; ++k) {
      if (e + k < ne) {
        float v[N];
        x[k].unpack(v);
#pragma unroll
        for (int i = 0; i < N; ++i) acc[i] += v[i];
      }
    }
  }
  if constexpr (BASE_LAST) {
    float b[N];
    init.unpack(b);
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = b[i] + acc[i];
  }
  Vec<T, N> o;
  o.pack(acc);
  return o;
}

// ROWS destination rows per block; a thread moves N elements of T at a time
// (16 bytes of T, or one element); keys as run_table reads them.
template <typename D, typename T, int ROWS, int N, typename KS, bool BASE_LAST>
__global__ void __launch_bounds__(NT)
segment_sum_kernel(const D* __restrict__ data, const KS keys, const T* __restrict__ base,
                   T* __restrict__ out, long num_edges, int num_segments, int cols) {
  __shared__ int lo_s[ROWS], hi_s[ROWS];
  __shared__ long blk_s[2];
  const long s0 = (long)blockIdx.x * ROWS;
  const int rows = (int)min((long)ROWS, (long)num_segments - s0);
  const int cpr = cols / N;  // chunks per row
  const int total = rows * cpr;
  const T* bp = base ? base + s0 * cols : nullptr;
  T* op = out + s0 * cols;
  // base's chunks of the first batch (a whole 128-row block of bf16 rows),
  // loaded before the searches so that their latency hides the searches'.
  Vec<T, N> v[UNROLL];
#pragma unroll
  for (int k = 0; k < UNROLL; ++k) {
    const int i = threadIdx.x + k * NT;
    if (base && i < total) v[k].load(bp + (long)i * N);
    else v[k].zero();
  }

  // The block's edges [blo, bhi) and each row's run [lo, hi) relative to blo.
  run_table<ROWS>(keys, num_edges, s0, rows, lo_s, hi_s, blk_s);
  const long blo = blk_s[0];

  // Every chunk of the block's rows, UNROLL a batch per thread: a row
  // without edges is base's row (or zeros); a row with edges sums its run,
  // each thread its chunk (neighbouring threads take neighbouring chunks of
  // a row, and neighbouring rows are neighbours in memory).
  const D* dp = data + blo * cols;
  for (int i0 = threadIdx.x; i0 < total; i0 += UNROLL * NT) {
    if (i0 != threadIdx.x) {  // later batches load here
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const int i = i0 + k * NT;
        if (base && i < total) v[k].load(bp + (long)i * N);
        else v[k].zero();
      }
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int i = i0 + k * NT;
      if (i >= total) break;
      const int r = i / cpr, c = i - r * cpr;
      const int lo = lo_s[r], hi = hi_s[r];
      if (lo == hi)
        v[k].store(op + (long)i * N);
      else
        sum_chunk<D, T, N, BASE_LAST>(dp + (long)lo * cols + c * N, hi - lo, cols, v[k])
            .store(op + (long)i * N);
    }
  }
}

// Rows per block: 128 where that still gives every SM several blocks, else
// 32 (small row counts with many edges a row, such as LanePooling's and the
// flat pack's gathers' backwards, need the blocks).
constexpr int ROWS_BIG = 128, ROWS_SMALL = 32;
constexpr long BIG_FROM = 32768;  // rows: 256 blocks of ROWS_BIG

template <typename D, typename T, int N, bool BASE_LAST, typename KS>
void launch_rows(const D* data, const KS& keys, const T* base, T* out, long num_edges,
                 int num_segments, int cols, cudaStream_t stream) {
  if (num_segments >= BIG_FROM) {
    const long blocks = ((long)num_segments + ROWS_BIG - 1) / ROWS_BIG;
    segment_sum_kernel<D, T, ROWS_BIG, N, KS, BASE_LAST><<<(unsigned)blocks, NT, 0, stream>>>(
        data, keys, base, out, num_edges, num_segments, cols);
  } else {
    const long blocks = ((long)num_segments + ROWS_SMALL - 1) / ROWS_SMALL;
    segment_sum_kernel<D, T, ROWS_SMALL, N, KS, BASE_LAST><<<(unsigned)blocks, NT, 0, stream>>>(
        data, keys, base, out, num_edges, num_segments, cols);
  }
}

// The segment sum of data [num_edges, cols] (D) by the sorted keys into out
// [num_segments, cols] (T), from base's rows (T) or zeros (BASE_LAST: base
// added after the edges); returns cudaGetLastError().
template <typename D, typename T, bool BASE_LAST, typename KS>
int launch_keys(const D* data, const KS& keys, const T* base, T* out, long num_edges,
                int num_segments, int cols, cudaStream_t stream) {
  if (num_segments <= 0) return (int)cudaGetLastError();
  constexpr int N = 16 / (int)sizeof(T);  // elements of T in a 16-byte chunk
  const bool chunks = (cols * sizeof(T)) % 16 == 0 &&
                      (((uintptr_t)data | (uintptr_t)base | (uintptr_t)out) & 15) == 0;
  if (chunks)
    launch_rows<D, T, N, BASE_LAST>(data, keys, base, out, num_edges, num_segments, cols,
                                    stream);
  else
    launch_rows<D, T, 1, BASE_LAST>(data, keys, base, out, num_edges, num_segments, cols,
                                    stream);
  return (int)cudaGetLastError();
}

}  // namespace seg

// The segment sum of data [num_edges, cols] (D) by seg into out
// [num_segments, cols] (T), from base's rows (T) or zeros; returns
// cudaGetLastError().
template <typename D, typename T>
int launch_segment_sum(const D* data, const long long* sg, const T* base, T* out,
                       long num_edges, int num_segments, int cols, cudaStream_t stream) {
  return seg::launch_keys<D, T, false>(data, seg::Keys<long long>{sg}, base, out, num_edges,
                                       num_segments, cols, stream);
}

}  // namespace lgk
