// The W = 256 route: the helpers of the three forwards that serve the
// double-width LaneGCN (n_map = n_actor = 256) on the CLI's contiguous
// layout, lane_layer_fwd (lane_layer.cu), row_tail_fwd at K = 1
// (row_tail.cu) and Att's edge_mlp_fwd (edge_mlp.cu). Their 128- and
// 64-wide kernels keep every tile, weight and product at 128 columns
// (common.cuh); a 256-wide row is a new tiling, so these kernels are their
// own and the 128/64 instantiations compile to the code they were.
//
// The tiling: a 256-wide row is two 128-column halves; a [256 x 256]
// weight (in, out) is four [128 x 128] quadrants (kh, nh): rows (K)
// kh·128.., columns (N) nh·128... A product out = A @ W sums, for each
// output half nh, the two K halves in order, in fp32, and its result is
// rounded once where the plain version rounds it.
//
// fp32 (the parity path, CUDA cores): 64-row tiles of fp32 rows in shared
// memory (stride LDW), 256 threads. A thread owns an 8 x 8 output block,
// rows wrow(i) (its warp's 8 rows) and columns wcol(j) (its lane's four
// columns of each half, 4·lane .. +3 and 128 + 4·lane .. +3), so a product's
// result goes back to the tile in the warp-a-row layout that GroupNorm
// reads: one warp per row, a lane holding those eight columns (Row),
// statistics by warp sums. The weight streams through a [KC x 256] fp32
// chunk of shared memory.
//
// bf16 (the path that serves, tensor cores): a warpgroup owns 64 rows as a
// pair of m64n128 wgmma accumulators (a[0]: columns 0 .. 127, a[1]: 128 ..
// 255; 128 fp32 registers a thread). GroupNorm takes a row's statistics
// from its quad of lanes in both accumulators, a[0]'s elements then a[1]'s
// (a fixed order: a rerun is bitwise). Where the 128-wide kernels feed h to
// the next product as register-A fragments, 64 more registers beside the
// next product's 128 do not fit: h goes to shared memory instead, as the
// product's A operand in core tiles (two K halves of [64 x 128] bf16, 33 KB
// a warpgroup), read through descriptors. The weights are read MN-major
// from [128 x 128] quadrant core tiles: held whole where one weight fits
// (row_tail), else streamed through a ring of quadrant slots by cp.async,
// one quadrant ahead of the products or more (QuadRing).
#pragma once

#include "common.cuh"

namespace lgk {
namespace wide {

constexpr int WW = 2 * C;                   // the row width of this route
constexpr int LDW = WW + 4;                 // fp32 row stride of a 256-wide tile
constexpr int KC = 32;                      // weight rows per fp32 chunk
constexpr int QB = tc::tiles_bytes(C);      // a [128 x 128] bf16 quadrant in core tiles
constexpr int HB = tc::tiles_bytes(64);     // one K half of a warpgroup's A operand
constexpr int TILE_BYTES = TM * LDW * 4;    // a 64-row fp32 tile
constexpr int CHUNK_BYTES = KC * WW * 4;    // the fp32 weight chunk

// --- fp32: CUDA cores --------------------------------------------------------

__device__ __forceinline__ int wrow(int i) { return (threadIdx.x >> 5) * 8 + i; }
__device__ __forceinline__ int wcol(int j) {
  const int l = (threadIdx.x & 31) * 4;
  return j < 4 ? l + j : C + l + (j - 4);
}

__device__ __forceinline__ void zero8(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
}

// acc[i][j] += Σ_k scale[i]·A_s[(row_off + wrow(i))·LDW + k]·w[k][wcol(j)]
// over K = 256; w: an fp32 [256 x 256] weight (in, out) in device memory,
// staged in KC-row chunks through W_s. TRANS: A @ wᵀ (w[wcol(j)][k]), the
// chunk staged transposed (W_s[k][n] = w[n][k0 + k]: a thread reads 4
// consecutive k of one row n, neighbouring threads write neighbouring n).
// Starts with a barrier (rows of A_s written before the call are then
// complete); ends after the last chunk's products, without one.
template <bool TRANS = false>
__device__ __forceinline__ void mm_rows(const float* A_s, int row_off, const float (&scale)[8],
                                        const float* w, float* W_s, float (&acc)[8][8]) {
  const int l4 = (threadIdx.x & 31) * 4;
  const float* a0 = A_s + (row_off + (threadIdx.x >> 5) * 8) * LDW;
  for (int k0 = 0; k0 < WW; k0 += KC) {
    __syncthreads();  // the previous chunk's products are done with W_s
    if constexpr (TRANS) {
      for (int i = threadIdx.x; i < KC * WW / 4; i += NT) {
        const int n = i % WW, k4 = (i / WW) * 4;
        const float4 v = *reinterpret_cast<const float4*>(w + (long)n * WW + k0 + k4);
        W_s[(k4 + 0) * WW + n] = v.x;
        W_s[(k4 + 1) * WW + n] = v.y;
        W_s[(k4 + 2) * WW + n] = v.z;
        W_s[(k4 + 3) * WW + n] = v.w;
      }
    } else {
      for (int i = threadIdx.x * 4; i < KC * WW; i += NT * 4)
        *reinterpret_cast<float4*>(W_s + i) = *reinterpret_cast<const float4*>(w + k0 * WW + i);
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KC; ++k) {
      float a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = a0[i * LDW + k0 + k] * scale[i];
      const float4 w0 = *reinterpret_cast<const float4*>(W_s + k * WW + l4);
      const float4 w1 = *reinterpret_cast<const float4*>(W_s + k * WW + C + l4);
      const float b[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }
}

// T_s[wrow(i)·LDW + wcol(j)] = acc[i][j].
__device__ __forceinline__ void store_tile(float* T_s, const float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = T_s + wrow(i) * LDW;
    *reinterpret_cast<float4*>(row + wcol(0)) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + wcol(4)) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// One 256-wide row in the warp-a-row layout: lo = columns 4·lane .. +3, hi =
// 128 + 4·lane .. +3.
struct Row {
  float4 lo, hi;
};

__device__ __forceinline__ Row ld_row(const float* p) {
  const int l4 = (threadIdx.x & 31) * 4;
  return Row{*reinterpret_cast<const float4*>(p + l4),
             *reinterpret_cast<const float4*>(p + C + l4)};
}
__device__ __forceinline__ void st_row(float* p, const Row& v) {
  const int l4 = (threadIdx.x & 31) * 4;
  *reinterpret_cast<float4*>(p + l4) = v.lo;
  *reinterpret_cast<float4*>(p + C + l4) = v.hi;
}
template <typename T> __device__ __forceinline__ Row ld_row_g(const T* p) {
  const int l4 = (threadIdx.x & 31) * 4;
  return Row{load4<T>(p + l4), load4<T>(p + C + l4)};
}
template <typename T> __device__ __forceinline__ void st_row_g(T* p, const Row& v) {
  const int l4 = (threadIdx.x & 31) * 4;
  store4<T>(p + l4, v.lo);
  store4<T>(p + C + l4, v.hi);
}
__device__ __forceinline__ Row add_row(const Row& a, const Row& b) {
  return Row{add4(a.lo, b.lo), add4(a.hi, b.hi)};
}
__device__ __forceinline__ Row relu_row(const Row& a) { return Row{relu4(a.lo), relu4(a.hi)}; }

__device__ __forceinline__ double warp_sum_d(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Single-group GroupNorm statistics of one 256-wide row, the plain
// version's arithmetic (ops/norm.py group_norm): mean = Σx / 256, var =
// Σ rnd(rnd(x − mean)²) / 256, inv = 1 / sqrt(var + eps), each operation
// rounded to fp32 on its own (no contraction, IEEE sqrt and division); the
// two sums in float64 (the lane's eight values, then the warp), rounded
// once. The fp32 path is what the parity checks hold to the CPU: its
// k-ordered fmaf chains gave lane_layer's temp bit for bit as the CPU's
// products do, and at 256 an fp32 train step is sensitive to the last bit
// of every normalisation (PERF.md §6).
__device__ __forceinline__ float2 row_stats(const Row& v, float eps) {
  const float e[8] = {v.lo.x, v.lo.y, v.lo.z, v.lo.w, v.hi.x, v.hi.y, v.hi.z, v.hi.w};
  double s = 0.0;
#pragma unroll
  for (int k = 0; k < 8; ++k) s += e[k];
  const float mu = (float)(warp_sum_d(s) / WW);
  double q = 0.0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float d = __fsub_rn(e[k], mu);
    q += (double)__fmul_rn(d, d);
  }
  const float var = (float)(warp_sum_d(q) / WW);
  return make_float2(mu, __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps))));
}

// rnd(rnd(rnd(x − mu)·inv)·w) + b, rounded op by op as the plain version's
// (x − mean)·rsqrt(var + eps), then ·weight + bias.
__device__ __forceinline__ float gn_el(float x, float mu, float inv, float w, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mu), inv), w), b);
}

// Single-group GroupNorm of one 256-wide row (row_stats, gn_el).
__device__ __forceinline__ Row gn_row(const Row& v, const float* w, const float* b, float eps) {
  const int l4 = (threadIdx.x & 31) * 4, h = C + l4;
  const float2 st = row_stats(v, eps);
  const float mu = st.x, inv = st.y;
  return Row{make_float4(gn_el(v.lo.x, mu, inv, w[l4], b[l4]),
                         gn_el(v.lo.y, mu, inv, w[l4 + 1], b[l4 + 1]),
                         gn_el(v.lo.z, mu, inv, w[l4 + 2], b[l4 + 2]),
                         gn_el(v.lo.w, mu, inv, w[l4 + 3], b[l4 + 3])),
             make_float4(gn_el(v.hi.x, mu, inv, w[h], b[h]),
                         gn_el(v.hi.y, mu, inv, w[h + 1], b[h + 1]),
                         gn_el(v.hi.z, mu, inv, w[h + 2], b[h + 2]),
                         gn_el(v.hi.w, mu, inv, w[h + 3], b[h + 3]))};
}

// Rows [0, TM) of the tile: relu(GN(row)) in place (fp32: no rounding).
__device__ __forceinline__ void gn_relu_tile(float* T_s, const float* w, const float* b,
                                             float eps) {
  for (int r = threadIdx.x >> 5; r < TM; r += NT / 32) {
    float* p = T_s + r * LDW;
    st_row(p, relu_row(gn_row(ld_row(p), w, b, eps)));
  }
}

// --- bf16: tensor cores -------------------------------------------------------

// Quadrant (kh, nh) of a row-major [256 x 256] bf16 weight into core tiles
// at dst by cp.async (thread t of `threads`, 16 bytes a copy); the caller
// commits.
__device__ __forceinline__ void fetch_quadrant(uint8_t* dst, const bf16* w, int kh, int nh,
                                               int t, int threads) {
  const tc::Tiles q = tc::tiles(dst, C);
  const bf16* src = w + (long)kh * C * WW + nh * C;
  for (int i = t; i < C * C / 8; i += threads) {
    const int r = ((i >> 7) << 3) + (i & 7), cb = (i >> 3) & 15;
    cp_async16(dst + tc::tile_off(q, r, cb * 8), src + r * WW + cb * 8);
  }
}

// A stream of [256 x 256] weights through R quadrant slots of shared memory
// (R·QB bytes at base), one cp.async commit group per quadrant, quadrants
// taken in the order the products use them: weight q / 4, then (kh, nh) =
// (q & 1, q >> 1 & 1). src(k) gives the stream's k-th weight. Every thread
// of the block takes part in every step, in the same order.
template <int R, class Src>
struct QuadRing {
  uint8_t* base;
  Src src;
  int total;  // quadrants in the stream
  int q;      // the next quadrant to take

  __device__ __forceinline__ void issue(int p) {
    if (p < total)
      fetch_quadrant(base + (p % R) * QB, src(p >> 2), p & 1, (p >> 1) & 1, threadIdx.x,
                     blockDim.x);
    cp_async_commit();  // an empty group past the end keeps the count
  }
  // The first R − 1 quadrants in flight.
  __device__ __forceinline__ void start() {
#pragma unroll
    for (int p = 0; p < R - 1; ++p) issue(p);
  }
  // Waits for quadrant q (and any group committed before it), then a block
  // barrier: q's slot complete for every thread, shared-memory writes made
  // before the call visible to wgmma, and every product on quadrant q − 1
  // done, so quadrant q + R − 1 now loads into its slot. Returns q's slot.
  __device__ __forceinline__ const uint8_t* take() {
    cp_async_wait<R - 2>();
    tc::fence_smem();
    __syncthreads();
    issue(q + R - 1);
    return base + (q++ % R) * QB;
  }
};

template <int R, class Src>
__device__ __forceinline__ QuadRing<R, Src> quad_ring(uint8_t* base, Src src, int total) {
  return QuadRing<R, Src>{base, src, total, 0};
}

__device__ __forceinline__ void zero2(float (&a)[2][64]) {
  tc::zero(a[0]);
  tc::zero(a[1]);
}

// acc += H[kh] @ Q: the warpgroup's A operand's K half kh (core tiles of 64
// rows at H_b + kh·HB, K-major) against one quadrant Q (MN-major); issued,
// committed and waited for.
__device__ __forceinline__ void mm_quadrant(float (&acc)[64], const uint8_t* H_b, int kh,
                                            const uint8_t* Q_b) {
  const tc::Tiles A = tc::tiles(H_b + kh * HB, 64), B = tc::tiles(Q_b, C);
  tc::fence_acc(acc);
  tc::fence();
#pragma unroll
  for (int ks = 0; ks < C / 16; ++ks)
    tc::mma_ss<0, 1>(acc, tc::desc(A, true, ks, 0), tc::desc(B, false, ks, 0));
  tc::commit();
  tc::wait_all();
  tc::fence_acc(acc);
}

// a[nh] = Σ_kh H[kh] @ W(kh, nh) for a weight held whole: quadrant (kh, nh)
// at W_b + (2·nh + kh)·QB (QuadRing's order); issued, committed, waited for.
__device__ __forceinline__ void mm_weight(float (&a)[2][64], const uint8_t* H_b,
                                          const uint8_t* W_b) {
  tc::fence_acc(a[0]);
  tc::fence_acc(a[1]);
  tc::fence();
#pragma unroll
  for (int kh = 0; kh < 2; ++kh) {
    const tc::Tiles A = tc::tiles(H_b + kh * HB, 64);
#pragma unroll
    for (int ks = 0; ks < C / 16; ++ks) {
      const uint64_t da = tc::desc(A, true, ks, 0);
      tc::mma_ss<0, 1>(a[0], da, tc::desc(tc::tiles(W_b + kh * QB, C), false, ks, 0));
      tc::mma_ss<0, 1>(a[1], da, tc::desc(tc::tiles(W_b + (2 + kh) * QB, C), false, ks, 0));
    }
  }
  tc::commit();
  tc::wait_all();
  tc::fence_acc(a[0]);
  tc::fence_acc(a[1]);
}

// Two consecutive bf16 values as floats.
__device__ __forceinline__ float2 ld_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Column (0 .. 255) of element i of accumulator n (its row: tc::acc_row(i)).
__device__ __forceinline__ int acc_col(int n, int i) { return n * C + tc::acc_col(i); }

// Mean and 1/sqrt(biased var + eps) of the thread's two rows over 256
// columns: a[0]'s elements then a[1]'s, then the quad.
__device__ __forceinline__ void row_stats(const float (&a)[2][64], float eps, float (&mu)[2],
                                          float (&inv)[2]) {
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int i = 0; i < 64; ++i) s[tc::acc_half(i)] += a[n][i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mu[h] = tc::quad_sum(s[h]) * (1.f / WW);
    s[h] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const float x = a[n][i] - mu[tc::acc_half(i)];
      s[tc::acc_half(i)] += x * x;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) inv[h] = rsqrtf(tc::quad_sum(s[h]) * (1.f / WW) + eps);
}

// Columns c, c + 1 of row r (of 64) of the warpgroup's A operand.
__device__ __forceinline__ uint32_t* a_pair(uint8_t* H_b, int r, int c) {
  const int kh = c >> 7;
  return reinterpret_cast<uint32_t*>(H_b + kh * HB +
                                     tc::tile_off(tc::tiles(H_b + kh * HB, 64), r, c & (C - 1)));
}

// rnd(relu((a − μ)·inv·gw + gb)) of the thread's two rows into the
// warpgroup's A operand at H_b (the next product's K halves).
__device__ __forceinline__ void gn_relu_to(uint8_t* H_b, const float (&a)[2][64],
                                           const float* gw, const float* gb, float eps) {
  float mu[2], inv[2];
  row_stats(a, eps, mu, inv);
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int h = tc::acc_half(i), c = acc_col(n, i);
      const float x0 = (a[n][i] - mu[h]) * inv[h] * gw[c] + gb[c];
      const float x1 = (a[n][i + 1] - mu[h]) * inv[h] * gw[c + 1] + gb[c + 1];
      *a_pair(H_b, tc::acc_row(i), c) = tc::pack_bf2(fmaxf(x0, 0.f), fmaxf(x1, 0.f));
    }
  }
}

// out = relu((a − μ)·inv·gw + gb + res) of the thread's two rows: res(r, c)
// gives the residual's float2 at row r (of 64) and columns c, c + 1;
// store(r, c, y0, y1) takes the outputs.
template <class Res, class Store>
__device__ __forceinline__ void gn_res_relu(const float (&a)[2][64], const float* gw,
                                            const float* gb, float eps, Res res, Store store) {
  float mu[2], inv[2];
  row_stats(a, eps, mu, inv);
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int r = tc::acc_row(i), c = acc_col(n, i), h = tc::acc_half(i);
      const float2 rv = res(r, c);
      const float y0 = (a[n][i] - mu[h]) * inv[h] * gw[c] + gb[c] + rv.x;
      const float y1 = (a[n][i + 1] - mu[h]) * inv[h] * gw[c + 1] + gb[c + 1] + rv.y;
      store(r, c, fmaxf(y0, 0.f), fmaxf(y1, 0.f));
    }
  }
}

// a ← rows row0 + tc::acc_row(i) of a [n, 256] bf16 matrix (zero past n), in
// the accumulator layout.
__device__ __forceinline__ void load_rows(float (&a)[2][64], const bf16* src, long row0, int n) {
#pragma unroll
  for (int n2 = 0; n2 < 2; ++n2) {
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const long gr = row0 + tc::acc_row(i);
      float2 v = make_float2(0.f, 0.f);
      if (gr < n)
        v = ld_pair(src + gr * WW + acc_col(n2, i));
      a[n2][i] = v.x;
      a[n2][i + 1] = v.y;
    }
  }
}

// Rows row0 + tc::acc_row(i) (those below n) of a [n, 256] matrix ← a, rounded
// to T (fp32: float2 stores).
template <typename T>
__device__ __forceinline__ void store_rows(T* dst, const float (&a)[2][64], long row0, int n) {
#pragma unroll
  for (int n2 = 0; n2 < 2; ++n2) {
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const long gr = row0 + tc::acc_row(i);
      if (gr >= n) continue;
      T* p = dst + gr * WW + acc_col(n2, i);
      if constexpr (std::is_same<T, float>::value)
        *reinterpret_cast<float2*>(p) = make_float2(a[n2][i], a[n2][i + 1]);
      else
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a[n2][i], a[n2][i + 1]);
    }
  }
}

// The card's SMs (the persistent grids' block count), or -1.
inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  return sms;
}

}  // namespace wide
}  // namespace lgk
