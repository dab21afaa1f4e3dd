// Window-chunked scatter-add of LanePooling's per-edge messages, forward
// and backward.
//
// Forward (`window_scatter_fwd`): replaces lanegcn_tpu/ops/
// pallas_window_scatter.py `_fwd_kernel` (:44) / `_pallas_fwd` (:82), the
// Pallas kernel behind `window_scatter_add`:
//
//   out = temp;  out[wchunk[e / 512] * stride + lu[e]] += msg[e]   (lu[e] >= 0)
//
// The TPU kernel ran one one-hot [stride x 512] x [512 x 128] matmul per
// 512-edge chunk into a VMEM block of the destination window, rounding the
// block after every chunk. Here the layout the packer emits does the work
// instead: each destination window's edges fill whole chunks, sorted by
// destination row, its padding (lu = -1) after them, and `wchunk` is
// non-decreasing (tail chunks repeat the last window). So the forward is a
// sorted segment sum over the flat rows w * stride + lu, and it runs
// segment_sum.cuh's kernel on a key derived from (wchunk, lu) (`WinKeys`):
//
//   key(e) = 2 (w * stride + lu[e])   a valid edge (row w * stride + lu[e])
//          = 2 (w + 1) * stride - 1   padding: after its window's last row,
//                                     before the next window's first
//
// (w = wchunk[e / 512]), non-decreasing over the edge slots; odd keys belong
// to no row. A block owns 128 flat output rows of the num_win x stride rows
// (32 below 32,768 rows; blocks straddle windows), finds its slots by two
// warp searches of 32 probes a step, writes each row's run of slots into a
// shared table (passing over padding), then moves every 16-byte chunk of
// its rows, 8 batched per thread: a row no edge reaches copies temp; a row
// with edges sums its run in fp32 from zero in edge order, 4 message loads
// in flight (the run's last ones together), adds temp and rounds once
// (`BASE_LAST`: the order of the kernel it replaces and of
// `window_scatter_plain`, so its output is bitwise theirs). No atomics;
// reruns are bitwise equal.
//
// What bounds it: one add per message element, so bytes: the valid messages
// and temp read once, the output written once (0.35 GB at 935,627 live r2g
// edges into 208,896 rows in bf16: 0.105 ms at the card's 3.35 TB/s). The
// kernel it replaces here ran three serial binary searches per warp of 8
// rows, then walked each row's edges one 256-byte message row at a time.
// On an H100 80GB HBM3 at 700 W (chip_ab.py, device time, bf16) this kernel
// takes 0.207 ms at r2g (the replaced one 0.355) and 0.132 at g2r (0.194;
// bound 0.088). Without the message loads it takes 0.040 ms, so the sums
// hold it: r2g's runs are skewed (most of its rows take no edge and some
// take many; ops/window_scatter.py `work` counts both), and a block lasts
// as long as its longest thread's runs.
//
// Backward (`window_scatter_bwd`): replaces pallas_window_scatter.py
// `_bwd_kernel` (:64) / `_pallas_bwd` (:111), the one-hot [512 x stride] x
// [stride x 128] matmul per chunk. The cotangent of temp is the output
// cotangent g itself (the wrapper passes it on); the messages' is a row
// gather,
//
//   d_msg[e] = g[wchunk[e / 512] * stride + lu[e]]   (lu[e] >= 0),  0 on padding,
//
// bitwise g's rows. What bounds it: bytes, the valid edges' rows of g read
// once and every d_msg row written (0.29 GB at r2g in bf16, 0.089 ms). The
// design: a grid of 8 blocks an SM walks 64-slot tiles of one chunk
// (wchunk read once a tile, lu as one load a slot); each thread moves one
// 16-byte chunk of several slots' rows, all of their g loads in flight
// before the stores, and padding rows store zeros without reading g. The
// replaced kernel ran a warp per row, 8 bytes a lane, in 131,072 blocks:
// 0.175 ms at r2g, this one 0.109 (H100 80GB HBM3, 700 W, device time).
//
// Width: both directions also take W = 64-wide rows (LaneRCNN at n_map =
// 64). The forward hands the width to segment_sum.cuh as its column count
// (a 64-wide bf16 row is 128 bytes: still whole 16-byte chunks); the
// backward is templated on W, a row 8 (bf16) or 16 (fp32) chunks, so a
// pass of the block moves 32 or 16 rows. At W = 128 both compile to the
// code they were before the width existed.
#include "segment_sum.cuh"

using namespace lgk;

namespace {

constexpr int WCH = 512;  // edges per chunk (the packer's alignment)

// The forward's sorted key over the window-chunked edge slots (see above).
struct WinKeys {
  const int* lu;
  const int* wchunk;
  long stride;
  __device__ __forceinline__ long long operator()(long e) const {
    const long w = wchunk[e / WCH];
    const int l = lu[e];
    return l >= 0 ? 2 * (w * stride + l) : 2 * (w + 1) * stride - 1;
  }
  __device__ __forceinline__ long long first(long s) const { return 2 * s; }
  __device__ __forceinline__ bool live(long long k) const { return !(k & 1); }
  __device__ __forceinline__ long row(long long k) const { return (long)(k >> 1); }
};

constexpr int BWD_TILE = 64;       // edge slots a tile (divides WCH)
constexpr int BWD_BLOCKS_SM = 8;   // blocks an SM in the grid

// d_msg row e = g row dst(e), or zeros on padding, rows W wide. A thread
// moves chunk c (16 bytes) of R rows of each tile, rows r0, r0 + RPP, ...
template <typename T, int W>
__global__ void __launch_bounds__(NT)
window_scatter_bwd_kernel(const T* __restrict__ g, const int* __restrict__ lu,
                          const int* __restrict__ wchunk, T* __restrict__ dmsg, int stride,
                          long tiles) {
  // 16-byte chunks a row: bf16 16 (W = 64: 8), fp32 32 (16)
  constexpr int CPR = W * (int)sizeof(T) / 16;
  constexpr int RPP = NT / CPR;                 // rows a pass
  constexpr int R = BWD_TILE / RPP;             // rows a thread a tile
  constexpr int EL = 16 / (int)sizeof(T);       // elements a chunk
  static_assert(NT % CPR == 0 && BWD_TILE % RPP == 0, "a tile's rows split evenly");
  const int c = threadIdx.x % CPR, r0 = threadIdx.x / CPR;
  for (long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long e0 = t * BWD_TILE;
    const long wrow = (long)wchunk[e0 / WCH] * stride;
    int l[R];
#pragma unroll
    for (int k = 0; k < R; ++k) l[k] = lu[e0 + r0 + k * RPP];
    uint4 v[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      v[k] = make_uint4(0, 0, 0, 0);
      if (l[k] >= 0)
        v[k] = *reinterpret_cast<const uint4*>(g + (wrow + l[k]) * W + c * EL);
    }
#pragma unroll
    for (int k = 0; k < R; ++k)
      *reinterpret_cast<uint4*>(dmsg + (e0 + r0 + k * RPP) * W + c * EL) = v[k];
  }
}

template <typename T, int W>
int launch(const void* msg, const void* temp, const int* lu, const int* wchunk, void* out,
           int num_win, int stride, int nch, cudaStream_t stream) {
  if (num_win <= 0 || stride <= 0) return (int)cudaGetLastError();
  const WinKeys keys{lu, wchunk, stride};
  return seg::launch_keys<T, T, true>((const T*)msg, keys, (const T*)temp, (T*)out,
                                      (long)nch * WCH, num_win * stride, W, stream);
}

template <typename T, int W>
int launch_bwd(const void* g, const int* lu, const int* wchunk, void* dmsg, int stride, int nch,
               cudaStream_t stream) {
  if ((((uintptr_t)g | (uintptr_t)dmsg) & 15) != 0) return (int)cudaErrorMisalignedAddress;
  const long tiles = (long)nch * (WCH / BWD_TILE);
  if (tiles > 0) {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return (int)cudaGetLastError();
    const long blocks = tiles < (long)sms * BWD_BLOCKS_SM ? tiles : (long)sms * BWD_BLOCKS_SM;
    window_scatter_bwd_kernel<T, W><<<(unsigned)blocks, NT, 0, stream>>>(
        (const T*)g, lu, wchunk, (T*)dmsg, stride, tiles);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (msg [nch*512, width], temp and out
// [num_win*stride, width], width 128 or 64); lu int32 [nch*512]
// window-local destination (-1 padding, after the window's valid edges,
// which are sorted by lu); wchunk int32 [nch] destination window per
// chunk, non-decreasing.
extern "C" int window_scatter_fwd(const void* msg, const void* temp, const void* lu,
                                  const void* wchunk, void* out, int num_win, int stride,
                                  int nch, int width, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int *l = (const int*)lu, *wc = (const int*)wchunk;
  return with_width_dtype(width, dtype, [&](auto Wc, auto Tc) {
    return launch<typename decltype(Tc)::type, decltype(Wc)::value>(msg, temp, l, wc, out,
                                                                    num_win, stride, nch, st);
  });
}

// Backward: dmsg [nch*512, width] = the rows of g [num_win*stride, width] at
// each edge's destination, zeros on padding; width and dtype as
// window_scatter_fwd (g, dmsg); g and dmsg 16-byte aligned.
extern "C" int window_scatter_bwd(const void* g, const void* lu, const void* wchunk, void* dmsg,
                                  int stride, int nch, int width, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int *l = (const int*)lu, *wc = (const int*)wchunk;
  return with_width_dtype(width, dtype, [&](auto Wc, auto Tc) {
    return launch_bwd<typename decltype(Tc)::type, decltype(Wc)::value>(g, l, wc, dmsg, stride,
                                                                        nch, st);
  });
}
