// Fused residual row tails, K = 1 and K = 2, forward and backward.
//
// Replaces lanegcn_tpu/ops/pallas_row_tail.py `_fwd_kernel` / `_fwd_impl`
// (the Pallas kernel behind `fused_row_tail`), the tail every Att stage runs
// after its edge aggregation:
//
//   out = relu(GN2(relu(GN1(x)) @ W) + res)      (single-group GroupNorms)
//
// What bounds it: x, res and out are each read or written once (160 MB at
// N = 208,896 in bf16) against 6.8 GFLOP: memory-bound at the card's bf16
// matrix rate. Two instantiations, each one pass over the rows:
//   bf16 (row_tail_tc_kernel<K>, K = 1 and 2, the path that serves and
//     trains): a persistent grid of RT_WGS warpgroups a block; each
//     warpgroup walks 64-row tiles of its own and keeps the next tile's x
//     and res in flight by cp.async (two stages of bf16 tiles) while the
//     current one multiplies. The weight(s) sit once per block as bf16 core
//     tiles (both of K = 2 side by side). x goes from its staged tile to the
//     m64n128 accumulator layout; the chain runs in registers on
//     tail_fwd.cuh's helpers (GN statistics per quad of lanes, h as the
//     register-A fragments of h @ W on wgmma, GN, the residual, ReLU); the
//     output goes back over res's staged tile and leaves in 16-byte rows.
//     Rows past n load as zero and are not stored.
//   fp32 (row_tail_kernel, row_tail2_kernel, the parity path: wgmma has no
//     fp32 operands): a block owns 64 rows, takes both GN statistics with
//     one warp per row, and the normalized rows and the product stay in
//     shared memory in fp32; the product runs on CUDA cores.
// The rounding points are the plain version's: h (and, K = 2, h2) rounded
// to x's dtype before their products, fp32 statistics, one rounding of the
// output.
//
// Width: K = 1 and K = 2, forward and backward, also run on W = 64-wide
// rows (Att's tail where n_agt = 64, the actor side of a model with
// n_actor = 64; LanePooling's tail where n_map = 64), every kernel here
// templated on W. The padded route (common.cuh): rows
// read W wide into the same 128-column tiles with zeros past W, W x W
// weights zero-padded to 128 x 128 in shared memory, GN statistics over W
// columns, the GN affines zero past W, only W columns stored, dW and the
// GN vector gradients W x W and W. The bf16 products keep the m64n128k16
// shape with K cut to W (half of N multiplies zero columns); K = 2's
// weight-gradient pass skips the second warpgroup's products at 64 (its
// input channels are padding), and its d_t workspace is [2, N, W]. At W =
// 128 every kernel compiles to the code it was before the width existed.
// K = 1 also takes W = 256 both ways, on kernels of their own (the forward
// row_tail_wide_kernel and row_tail_wide_tc_kernel, below, on wide.cuh; the
// backward wide_bwd.cuh's row pass and weight-gradient pass).
//
// Backward (`row_tail_bwd`): replaces pallas_row_tail.py `_bwd_kernel` /
// `_bwd_impl`. It recomputes the chain per row (nothing but the inputs is
// saved) and emits dx, dres (= the masked output cotangent), dW and the four
// GN vectors; the kernel is tail_bwd.cuh's. What bounds it: x, res and g
// read and dx, dres written (267 MB at N = 208,896 in bf16) against three
// [N x 128] x [128 x 128] products (20.5 GFLOP): memory-bound at the card's
// bf16 matrix rate, product-bound on the CUDA cores this version uses. The
// TPU kernel summed dW and dGN across its sequential grid; here one block
// per SM walks the tiles with its dW in registers and a second pass sums
// the per-block partials in a fixed order (deterministic, no atomics).
//
// K = 2 (`row_tail2_fwd`): replaces the same `_fwd_kernel` / `_fwd_impl` at
// K = 2, the tail of LaneRCNN's LanePooling (`fused_row_tail2`):
//
//   out = relu(GN3(relu(GN2(relu(GN1(x)) @ W1)) @ W2) + res)
//
// bf16: row_tail_tc_kernel<2>, h2 = rnd(relu(GN2(t1))) made on t1's
// accumulators and fed to t2 = h2 @ W2 as register-A fragments. fp32: the
// same block of 64 rows keeps the whole chain in shared memory, the tile,
// then each product's result, in place, with one fp32 weight slot (64 KB)
// that W2 overwrites once W1's product is done. What bounds it: x, res and
// out cross device memory once (160 MB at N = 208,896 in bf16) against
// 13.7 GFLOP: memory-bound at the card's bf16 matrix rate.
//
// K = 2 backward (`row_tail2_bwd`): replaces `_bwd_kernel` / `_bwd_impl` at
// K = 2. Per row it recomputes the chain and runs back through GN3 → W2 →
// GN2 → W1 → GN1:
//
//   d_y = g ⊙ [y + res > 0] (= dres);  d_t2 = rnd(GN3ᵀ(d_y));  dW2 = Σ h2ᵀ d_t2
//   d_h2 = d_t2 @ W2ᵀ ⊙ [h2_pre > 0]; d_t1 = rnd(GN2ᵀ(d_h2));  dW1 = Σ h1ᵀ d_t1
//   d_h1 = d_t1 @ W1ᵀ ⊙ [h1_pre > 0]; dx = GN1ᵀ(d_h1)
//
// with h1, h2 and each d_t rounded to x's dtype before its products, as the
// Pallas backward rounds them, fp32 statistics and fp32 dW. What bounds it:
// x, res and g read and dx, dres written (267 MB at N = 208,896 in bf16)
// against six [N x 128] x [128 x 128] products (41.1 GFLOP): memory-bound
// at the card's bf16 matrix rate. Two instantiations:
//   bf16 (the path that trains), two passes on wgmma:
//   1. row_tail2_bwd_tc_kernel, the chain: row_tail_tc_kernel's persistent
//      grid of 2-warpgroup blocks, W1 and W2 once per block as bf16 core
//      tiles (read MN-major for the chain, K-major for d_t @ Wᵀ), each
//      warpgroup on 64-row tiles of its own with the next tile's x in
//      flight by cp.async from the start of the current one and the next
//      g and res from the moment d_y is made. The chain runs on the
//      accumulators: h1, t1, h2, t2 made again (tail_fwd.cuh), the three
//      GroupNorm backwards on the accumulators (edge_tc.cuh gn_bwd_acc),
//      d_t2 and d_t1 fed to d_t @ Wᵀ as register-A fragments, t1 made again
//      from x for GN2's backward (the registers hold one chain: 255 a
//      thread), the six GN vector sums as column sums kept per lane across
//      the tiles. dx, dres, rnd(d_t1) and rnd(d_t2) leave from the
//      registers; no fp32 tile in shared memory.
//   2. row_tail2_dw_tc_kernel, the weight gradients: dW1 = h1ᵀ rnd(d_t1)
//      and dW2 = h2ᵀ rnd(d_t2) as split-K wgmma over 128-row tiles of x and
//      d_t streamed through a cp.async ring, h1 (and h2 through W1) made
//      again from x; grid (splits, 2), one fp32 partial per split. Beside
//      the chain's registers the two [128 x 128] fp32 accumulators do not
//      fit (128 more a thread), so the chain pass writes rnd(d_t1) and
//      rnd(d_t2) in bf16 (a [2, N, 128] workspace, 107 MB at N = 208,896)
//      and this pass reads them beside x: 321 MB more traffic, not the
//      428 MB that writing h1 and h2 too would cost.
//   The partials are summed in block and split order (reduce_partials): no
//   float atomics, bitwise reruns.
//   fp32 (row_tail2_bwd_kernel, the parity path: wgmma has no fp32
//   operands): one block per SM walks 64-row tiles with dW1 and dW2 in
//   registers (an 8 x 8 block of each per thread); four fp32 tiles and one
//   64 KB weight slot loaded with W1, W2, W2ᵀ and W1ᵀ in turn (220 KB, one
//   block per SM); the products on CUDA cores.
#include "edge_tc.cuh"
#include "tail_bwd.cuh"
#include "tail_fwd.cuh"
#include "wide_bwd.cuh"

using namespace lgk;

namespace {

template <typename T, int W>
__global__ void __launch_bounds__(NT)
row_tail_kernel(const T* __restrict__ x, const T* __restrict__ res, const T* __restrict__ w,
                const float* __restrict__ g1w, const float* __restrict__ g1b,
                const float* __restrict__ g2w, const float* __restrict__ g2b,
                T* __restrict__ out, int n, float eps) {
  extern __shared__ float4 smem4[];
  float* X_s = reinterpret_cast<float*>(smem4);  // [TM][LDA]
  float* W_s = X_s + TM * LDA;                   // [C][C]
  const long row0 = (long)blockIdx.x * TM;

  for (int idx = threadIdx.x; idx < TM * (C / 4); idx += NT) {
    const int r = idx / (C / 4), c4 = (idx % (C / 4)) * 4;
    const long g = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g < n && (W == C || c4 < W)) v = load4<T>(x + g * W + c4);
    *reinterpret_cast<float4*>(X_s + r * LDA + c4) = v;
  }
  load_weight<T, W>(W_s, w);
  __syncthreads();
  gn_relu_rows<T, W>(X_s, TM, g1w, g1b, eps);  // h = relu(GN1(x)), rounded to T
  __syncthreads();

  float acc[4][8];
  zero_acc(acc);
  const float ones[4] = {1.f, 1.f, 1.f, 1.f};
  mm_64x128(X_s, 0, ones, W_s, acc);        // z = h @ W
  __syncthreads();
  store_acc(X_s, acc);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < TM; r += NT / 32) {
    const long g = row0 + r;
    if (g >= n) break;
    const float4 z = *reinterpret_cast<const float4*>(X_s + r * LDA + lane * 4);
    const float4 y = gn_row<W>(z, g2w, g2b, eps);
    if (!lane_in<W>()) continue;
    const float4 rv = load4<T>(res + g * W + lane * 4);
    store4<T>(out + g * W + lane * 4, relu4(add4(y, rv)));
  }
}

// K = 2 (LanePooling's tail): the same block and tile, with the second
// product's weight loaded over the first's once the first product is done.
template <typename T, int W>
__global__ void __launch_bounds__(NT)
row_tail2_kernel(const T* __restrict__ x, const T* __restrict__ res, const T* __restrict__ w1,
                 const T* __restrict__ w2, const float* __restrict__ gn, T* __restrict__ out,
                 int n, float eps) {
  extern __shared__ float4 smem4[];
  float* X_s = reinterpret_cast<float*>(smem4);  // [TM][LDA]
  float* W_s = X_s + TM * LDA;                   // [C][C]
  const long row0 = (long)blockIdx.x * TM;

  for (int idx = threadIdx.x; idx < TM * (C / 4); idx += NT) {
    const int r = idx / (C / 4), c4 = (idx % (C / 4)) * 4;
    const long g = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g < n && (W == C || c4 < W)) v = load4<T>(x + g * W + c4);
    *reinterpret_cast<float4*>(X_s + r * LDA + c4) = v;
  }
  load_weight<T, W>(W_s, w1);
  __syncthreads();
  gn_relu_rows<T, W>(X_s, TM, gn, gn + W, eps);  // h1 = relu(GN1(x)), rounded to T
  __syncthreads();

  float acc[4][8];
  const float ones[4] = {1.f, 1.f, 1.f, 1.f};
  zero_acc(acc);
  mm_64x128(X_s, 0, ones, W_s, acc);  // t1 = h1 @ W1
  __syncthreads();
  store_acc(X_s, acc);
  load_weight<T, W>(W_s, w2);
  __syncthreads();
  gn_relu_rows<T, W>(X_s, TM, gn + 2 * W, gn + 3 * W, eps);  // h2 = relu(GN2(t1)), rounded
  __syncthreads();
  zero_acc(acc);
  mm_64x128(X_s, 0, ones, W_s, acc);  // t2 = h2 @ W2
  __syncthreads();
  store_acc(X_s, acc);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < TM; r += NT / 32) {
    const long g = row0 + r;
    if (g >= n) break;
    const float4 t = *reinterpret_cast<const float4*>(X_s + r * LDA + lane * 4);
    const float4 y = gn_row<W>(t, gn + 4 * W, gn + 5 * W, eps);
    if (!lane_in<W>()) continue;
    const float4 rv = load4<T>(res + g * W + lane * 4);
    store4<T>(out + g * W + lane * 4, relu4(add4(y, rv)));
  }
}

// The bf16 forward on tensor cores, K products (K = 1: x → W → out; K = 2:
// x → W1 → W2 → out). RT_WGS warpgroups a block, each on 64-row tiles of
// its own (tile wg + RT_WGS·(block + grid·k)), synchronised by a named
// barrier of its 128 threads; per warpgroup two stages of staged x and res
// tiles (bf16 rows of RT_LD elements: a quad's 4-byte reads in the
// accumulator layout hit 32 banks). vecs: the 2K + 2 GN weight and bias
// vectors, GN1 first.
constexpr int RT_WGS = 2;
constexpr int RT_THREADS = 128 * RT_WGS;
constexpr int RT_ROWS = 64;
constexpr int RT_LD = C + 8;
constexpr int RT_TILE = RT_ROWS * RT_LD;  // bf16 elements of one staged tile
static_assert(RT_THREADS == NT, "tc::load_tiles_128 strides by NT threads");

struct TailVecs {
  const float* v[6];
};

template <int K>
inline int row_tail_tc_smem() {
  return K * tc::tiles_bytes(C) + (2 * K + 2) * C * (int)sizeof(float) +
         RT_WGS * 2 * 2 * RT_TILE * (int)sizeof(bf16);
}

template <int K, int W>
__global__ void __launch_bounds__(RT_THREADS, 1)
row_tail_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ res,
                   const bf16* __restrict__ w1, const bf16* __restrict__ w2, TailVecs vecs,
                   bf16* __restrict__ out, int n, float eps) {
  extern __shared__ float4 smem4[];
  uint8_t* W_b = reinterpret_cast<uint8_t*>(smem4);                     // [K] weight core tiles
  float* gn_s = reinterpret_cast<float*>(W_b + K * tc::tiles_bytes(C));  // [2K + 2][C]
  bf16* S_s = reinterpret_cast<bf16*>(gn_s + (2 * K + 2) * C);          // [RT_WGS][2][x, res]
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;

  tc::load_tiles_128<W>(W_b, tc::tiles(W_b, C), w1);
  if (K == 2) tc::load_tiles_128<W>(W_b + tc::tiles_bytes(C), tc::tiles(W_b, C), w2);
  for (int i = threadIdx.x; i < (2 * K + 2) * C; i += RT_THREADS)
    gn_s[i] = W == C || i % C < W ? vecs.v[i / C][i % C] : 0.f;
  tc::fence_smem();
  __syncthreads();  // the weights (for wgmma) and the vectors in place

  const int ntiles = (n + RT_ROWS - 1) / RT_ROWS, step = gridDim.x * RT_WGS;
  bf16* stage0 = S_s + wg * 4 * RT_TILE;  // stage s: x at 2s·RT_TILE, res after it
  auto bar = [&]() { asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory"); };
  auto fetch = [&](int tile, int s) {  // one commit group: the tile's x and res rows
    bf16* X = stage0 + 2 * s * RT_TILE;
    const long row0 = (long)tile * RT_ROWS;
    for (int i = t; i < RT_ROWS * (C / 8); i += 128) {
      const int r = i >> 4, c = (i & 15) * 8;
      const long gr = row0 + r;
      const bool in = gr < n && (W == C || c < W);
      cp_async16_zfill(X + r * RT_LD + c, in ? x + gr * W + c : x, in ? 16 : 0);
      cp_async16_zfill(X + RT_TILE + r * RT_LD + c, in ? res + gr * W + c : res, in ? 16 : 0);
    }
    cp_async_commit();
  };

  int tile = blockIdx.x * RT_WGS + wg;
  if (tile < ntiles) fetch(tile, 0);
  for (int k = 0; tile < ntiles; ++k, tile += step) {
    const int s = k & 1;
    cp_async_wait<0>();  // this tile, the one group in flight
    // the tile in place for the warpgroup, which is done with the other
    // stage (the previous tile's output copy), where the next tile goes
    bar();
    if (tile + step < ntiles) fetch(tile + step, s ^ 1);
    const bf16* X = stage0 + 2 * s * RT_TILE;
    bf16* R = stage0 + (2 * s + 1) * RT_TILE;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          X + tc::acc_row(i) * RT_LD + tc::acc_col(i)));
      acc[i] = v.x;
      acc[i + 1] = v.y;
    }
    uint32_t ha[C / 16][4];
#pragma unroll
    for (int j = 0; j < K; ++j) {  // h_j = rnd(relu(GN_j(·))), then h_j @ W_j
      tail::gn_relu_frags<W>(acc, gn_s + 2 * j * C, gn_s + (2 * j + 1) * C, eps, ha);
      tail::frag_mm<W>(acc, ha, tc::tiles(W_b + j * tc::tiles_bytes(C), C));
    }
    // out = relu(GN(·) + res), over res in its staged tile
    tail::gn_res_relu<W>(
        acc, gn_s + 2 * K * C, gn_s + (2 * K + 1) * C, eps,
        [&](int r, int c) {
          return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(R + r * RT_LD + c));
        },
        [&](int r, int c, float y0, float y1) {
          *reinterpret_cast<__nv_bfloat162*>(R + r * RT_LD + c) = __floats2bfloat162_rn(y0, y1);
        });
    bar();  // the output tile complete
    const long row0 = (long)tile * RT_ROWS;
    for (int i = t; i < RT_ROWS * (C / 8); i += 128) {
      const int r = i >> 4, c = (i & 15) * 8;
      if (row0 + r < n && (W == C || c < W))
        *reinterpret_cast<uint4*>(out + (row0 + r) * W + c) =
            *reinterpret_cast<const uint4*>(R + r * RT_LD + c);
    }
  }
}

// The bf16 forward's grid: one block per SM, or fewer where the tiles are
// fewer than the SMs' warpgroups.
inline int row_tail_tc_blocks(int n) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  const int tiles = (n + RT_ROWS - 1) / RT_ROWS;
  return min(sms, (tiles + RT_WGS - 1) / RT_WGS);
}

template <int K, int W = C>
int launch_tc(const void* x, const void* res, const void* w1, const void* w2,
              const TailVecs& vecs, void* out, int n, float eps, cudaStream_t stream) {
  const int smem = row_tail_tc_smem<K>();
  cudaError_t err = set_smem((const void*)row_tail_tc_kernel<K, W>, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = row_tail_tc_blocks(n);
  if (blocks < 0) return (int)cudaGetLastError();
  if (blocks > 0)
    row_tail_tc_kernel<K, W><<<blocks, RT_THREADS, smem, stream>>>(
        (const bf16*)x, (const bf16*)res, (const bf16*)w1, (const bf16*)w2, vecs, (bf16*)out, n,
        eps);
  return (int)cudaGetLastError();
}

template <typename T, int W>
int launch2(const void* x, const void* res, const void* w1, const void* w2, const float* gn,
            void* out, int n, float eps, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    const TailVecs vecs{{gn, gn + W, gn + 2 * W, gn + 3 * W, gn + 4 * W, gn + 5 * W}};
    return launch_tc<2, W>(x, res, w1, w2, vecs, out, n, eps, stream);
  } else {
    const int smem = (TM * LDA + C * C) * (int)sizeof(float);
    cudaError_t err = set_smem((const void*)row_tail2_kernel<T, W>, smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (n + TM - 1) / TM;
    if (blocks > 0)
      row_tail2_kernel<T, W><<<blocks, NT, smem, stream>>>(
          (const T*)x, (const T*)res, (const T*)w1, (const T*)w2, gn, (T*)out, n, eps);
    return (int)cudaGetLastError();
  }
}

template <typename T, int W>
int launch(const void* x, const void* res, const void* w, const float* g1w, const float* g1b,
           const float* g2w, const float* g2b, void* out, int n, float eps,
           cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    const TailVecs vecs{{g1w, g1b, g2w, g2b, nullptr, nullptr}};
    return launch_tc<1, W>(x, res, w, nullptr, vecs, out, n, eps, stream);
  } else {
    const int smem = (TM * LDA + C * C) * (int)sizeof(float);
    cudaError_t err = set_smem((const void*)row_tail_kernel<T, W>, smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (n + TM - 1) / TM;
    if (blocks > 0)
      row_tail_kernel<T, W><<<blocks, NT, smem, stream>>>(
          (const T*)x, (const T*)res, (const T*)w, g1w, g1b, g2w, g2b, (T*)out, n, eps);
    return (int)cudaGetLastError();
  }
}

// A block's K = 2 backward partial at width W: dW1, dW2, dg1w, dg1b, dg2w,
// dg2b, dg3w, dg3b.
template <int W = C>
__host__ __device__ constexpr int tail2_part() { return 2 * W * W + 6 * W; }

inline int tail2_bwd_smem() {
  return (4 * TM * LDA + C * C + 2 * TM + NT / 32 * 6 * C) * (int)sizeof(float);
}

template <typename T, int W>
__global__ void __launch_bounds__(NT, 1)
row_tail2_bwd_kernel(const T* __restrict__ x, const T* __restrict__ res, const T* __restrict__ g,
                     const T* __restrict__ w1, const T* __restrict__ w2,
                     const float* __restrict__ gn, T* __restrict__ dx, T* __restrict__ dres,
                     float* __restrict__ part, int n, float eps) {
  extern __shared__ float4 smem4[];
  float* A_s = reinterpret_cast<float*>(smem4);  // [TM][LDA] x, then h1
  float* B_s = A_s + TM * LDA;                   // t1, then rnd(d_t1), then d_h1
  float* C_s = B_s + TM * LDA;                   // h2
  float* D_s = C_s + TM * LDA;                   // t2, then rnd(d_t2), then d_h2
  float* W_s = D_s + TM * LDA;                   // [C][C] W1, W2, W2ᵀ, W1ᵀ in turn
  float* st_s = W_s + C * C;                     // [TM][2] GN1 mean, inv
  float* vec_s = st_s + 2 * TM;                  // [NT/32][6][C] GN vector sums
  const float *g1w = gn, *g1b = gn + W, *g2w = gn + 2 * W, *g2b = gn + 3 * W,
              *g3w = gn + 4 * W, *g3b = gn + 5 * W;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool in_w = lane_in<W>();  // the lane's columns lie in the row
  float accW1[8][8], accW2[8][8];
  zero_tn(accW1);
  zero_tn(accW2);
  zero_warp_vecs<6>(vec_s);
  const float ones[4] = {1.f, 1.f, 1.f, 1.f};
  const int ntiles = (n + TM - 1) / TM;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long row0 = (long)tile * TM;
    __syncthreads();  // the previous tile is done with the tiles and W_s
    for (int idx = threadIdx.x; idx < TM * (C / 4); idx += NT) {
      const int r = idx / (C / 4), c4 = (idx % (C / 4)) * 4;
      const long gr = row0 + r;
      *reinterpret_cast<float4*>(A_s + r * LDA + c4) =
          gr < n && (W == C || c4 < W) ? load4<T>(x + gr * W + c4) : zero4();
    }
    load_weight<T, W>(W_s, w1);
    __syncthreads();
    // h1 = rnd(relu(GN1(x))) in place; rows past n hold 0.
    for (int r = warp; r < TM; r += NT / 32) {
      float4* p = reinterpret_cast<float4*>(A_s + r * LDA + lane * 4);
      const float2 st = gn_stats<W>(*p, eps);
      const float4 h = rnd4<T>(relu4(gn_affine<W>(gn_nrm(*p, st), g1w, g1b)));
      *p = (row0 + r < n) ? h : zero4();
      if (lane == 0) {
        st_s[2 * r] = st.x;
        st_s[2 * r + 1] = st.y;
      }
    }
    __syncthreads();
    float acc[4][8];
    zero_acc(acc);
    mm_64x128(A_s, 0, ones, W_s, acc);  // t1 = h1 @ W1
    store_acc(B_s, acc);
    __syncthreads();
    // h2 = rnd(relu(GN2(t1))); rows past n hold 0.
    for (int r = warp; r < TM; r += NT / 32) {
      const float4 t1 = *reinterpret_cast<const float4*>(B_s + r * LDA + lane * 4);
      const float4 h = rnd4<T>(relu4(gn_row<W>(t1, g2w, g2b, eps)));
      *reinterpret_cast<float4*>(C_s + r * LDA + lane * 4) = (row0 + r < n) ? h : zero4();
    }
    load_weight<T, W>(W_s, w2);
    __syncthreads();
    zero_acc(acc);
    mm_64x128(C_s, 0, ones, W_s, acc);  // t2 = h2 @ W2
    store_acc(D_s, acc);
    __syncthreads();
    // d_y = g ⊙ [y + res > 0] → dres; GN3 backward → rnd(d_t2) in place of t2.
    for (int r = warp; r < TM; r += NT / 32) {
      float4* p = reinterpret_cast<float4*>(D_s + r * LDA + lane * 4);
      const long gr = row0 + r;
      float4 dt = zero4();
      if (gr < n) {
        const float2 st = gn_stats<W>(*p, eps);
        const float4 nrm = gn_nrm(*p, st);
        const float4 y = gn_affine<W>(nrm, g3w, g3b);
        const float4 rv = in_w ? load4<T>(res + gr * W + lane * 4) : zero4();
        const float4 d_y = pos_mask4(in_w ? load4<T>(g + gr * W + lane * 4) : zero4(), add4(y, rv));
        add_warp_vec<6>(vec_s, 4, mul4(d_y, nrm));
        add_warp_vec<6>(vec_s, 5, d_y);
        dt = rnd4<T>(gn_bwd_row<W>(d_y, nrm, st.y, g3w));
        if (in_w) store4<T>(dres + gr * W + lane * 4, d_y);
      }
      *p = dt;
    }
    load_weight_t<T, W>(W_s, w2);
    __syncthreads();
    zero_acc(acc);
    mm_64x128(D_s, 0, ones, W_s, acc);  // rnd(d_t2) @ W2ᵀ
    mm_tn(C_s, D_s, TM, accW2);         // dW2 += h2ᵀ rnd(d_t2)
    __syncthreads();
    store_acc(D_s, acc);
    __syncthreads();
    // d_h2 = (rnd(d_t2) @ W2ᵀ) ⊙ [h2_pre > 0], GN2 backward → rnd(d_t1) in place of t1.
    for (int r = warp; r < TM; r += NT / 32) {
      float4* p = reinterpret_cast<float4*>(B_s + r * LDA + lane * 4);
      float4 dt = zero4();
      if (row0 + r < n) {
        const float2 st = gn_stats<W>(*p, eps);
        const float4 nrm = gn_nrm(*p, st);
        const float4 d_h = pos_mask4(*reinterpret_cast<const float4*>(D_s + r * LDA + lane * 4),
                                     gn_affine<W>(nrm, g2w, g2b));
        add_warp_vec<6>(vec_s, 2, mul4(d_h, nrm));
        add_warp_vec<6>(vec_s, 3, d_h);
        dt = rnd4<T>(gn_bwd_row<W>(d_h, nrm, st.y, g2w));
      }
      *p = dt;
    }
    load_weight_t<T, W>(W_s, w1);
    __syncthreads();
    zero_acc(acc);
    mm_64x128(B_s, 0, ones, W_s, acc);  // rnd(d_t1) @ W1ᵀ
    mm_tn(A_s, B_s, TM, accW1);         // dW1 += h1ᵀ rnd(d_t1)
    __syncthreads();
    store_acc(B_s, acc);
    __syncthreads();
    // d_h1 = (rnd(d_t1) @ W1ᵀ) ⊙ [h1_pre > 0], GN1 backward → dx.
    for (int r = warp; r < TM; r += NT / 32) {
      const long gr = row0 + r;
      if (gr >= n) break;
      const float2 st = make_float2(st_s[2 * r], st_s[2 * r + 1]);
      const float4 nrm = gn_nrm(in_w ? load4<T>(x + gr * W + lane * 4) : zero4(), st);
      const float4 d_h = pos_mask4(*reinterpret_cast<const float4*>(B_s + r * LDA + lane * 4),
                                   gn_affine<W>(nrm, g1w, g1b));
      add_warp_vec<6>(vec_s, 0, mul4(d_h, nrm));
      add_warp_vec<6>(vec_s, 1, d_h);
      const float4 d_x = gn_bwd_row<W>(d_h, nrm, st.y, g1w);
      if (in_w) store4<T>(dx + gr * W + lane * 4, d_x);
    }
  }
  float* P = part + (long)blockIdx.x * tail2_part<W>();
  store_tn<W>(P, accW1, false);
  store_tn<W>(P + W * W, accW2, false);
  sum_warp_vecs<6, W>(vec_s, P + 2 * W * W);
}

// The bf16 backward on tensor cores, two passes (see the header). The
// chain pass: the forward's persistent grid of RT_WGS warpgroups a block,
// W1 and W2 once per block as bf16 core tiles; warpgroup g of block b walks
// 64-row tiles b·RT_WGS + g, then every RT_WGS·B-th one. Per warpgroup four staged
// tiles: x in two stages (the next tile's x in flight from the start of
// the current one), g and res in one (the next tile's in flight once d_y
// is made, the last read of the current ones). part_v: [blocks][6][C], the
// block's GN vector sums; dt: [2][n][C], rnd(d_t1) then rnd(d_t2).
constexpr int RB_TB = tc::tiles_bytes(RT_ROWS);  // a staged [64 x 128] bf16 tile
constexpr int RB_WB = tc::tiles_bytes(C);        // a [128 x 128] weight in core tiles
constexpr int RB_DT = 128;                       // rows of a weight-gradient tile
constexpr int RB_DTB = tc::tiles_bytes(RB_DT);
constexpr int RB_DW_STAGES = 2;                  // the weight-gradient pass's ring

constexpr int tail2_bwd_tc_smem() {
  return 2 * RB_WB + 6 * C * (int)sizeof(float) + RT_WGS * 4 * RB_TB;
}
constexpr int tail2_dw_tc_smem() {
  return RB_WB + 4 * C * (int)sizeof(float) + RB_DTB + RB_DW_STAGES * 2 * RB_DTB;
}

// v ← (v − μ)·inv per row, the single-group GN's normalised rows (inv: the
// rows' 1/sqrt(var + eps)).
template <int W = C>
__device__ __forceinline__ void gn_normalise(float (&v)[64], float eps, float (&inv)[2]) {
  float mu[2];
  tc::acc_row_stats<W>(v, eps, mu, inv);
#pragma unroll
  for (int i = 0; i < 64; ++i) v[i] = (v[i] - mu[tc::acc_half(i)]) * inv[tc::acc_half(i)];
}

// d ← d ⊙ [nrm·w + b > 0] (the ReLU's mask at its pre-activation), 0 in
// rows past n (ok).
__device__ __forceinline__ void relu_mask(float (&d)[64], const float (&nrm)[64], const float* w,
                                          const float* b, const bool (&ok)[2]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int c = tc::acc_col(i);
    d[i] = ok[tc::acc_half(i)] && nrm[i] * w[c] + b[c] > 0.f ? d[i] : 0.f;
  }
}

// bf16 pairs in the accumulator layout to the thread's rows r0, r0 + 8 of
// dst [n, W] that lie below n (the columns below W).
template <int W = C>
__device__ __forceinline__ void store_pairs(bf16* dst, long row0, int r0, const bool (&ok)[2],
                                            const uint32_t (&a)[32]) {
#pragma unroll
  for (int i = 0; i < W / 2; i += 2) {
    const int h = tc::acc_half(i);
    if (ok[h])
      *reinterpret_cast<uint32_t*>(dst + (row0 + r0 + 8 * h) * W + tc::acc_col(i)) = a[i / 2];
  }
}

template <int W>
__global__ void __launch_bounds__(RT_THREADS, 1)
row_tail2_bwd_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ res,
                        const bf16* __restrict__ g, const bf16* __restrict__ w1,
                        const bf16* __restrict__ w2, const float* __restrict__ gn,
                        bf16* __restrict__ dx, bf16* __restrict__ dres, bf16* __restrict__ dt,
                        float* __restrict__ part_v, int n, float eps) {
  extern __shared__ float4 smem4[];
  uint8_t* W_b = reinterpret_cast<uint8_t*>(smem4);            // W1 | W2
  float* gn_s = reinterpret_cast<float*>(W_b + 2 * RB_WB);      // [6][C] GN1, GN2, GN3 w, b
  uint8_t* S_b = reinterpret_cast<uint8_t*>(gn_s + 6 * C);      // [RT_WGS][x0 | x1 | g | res]
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const tc::Tiles W1 = tc::tiles(W_b, C), W2 = tc::tiles(W_b + RB_WB, C);
  tc::load_tiles_128<W>(W_b, W1, w1);
  tc::load_tiles_128<W>(W_b + RB_WB, W2, w2);
  for (int i = threadIdx.x; i < 6 * C; i += RT_THREADS)  // [6][C], zero past W
    gn_s[i] = W == C || i % C < W ? gn[i / C * W + i % C] : 0.f;
  tc::fence_smem();
  __syncthreads();  // the weights (for wgmma) and the vectors in place
  const float *g1w = gn_s, *g1b = gn_s + C, *g2w = gn_s + 2 * C, *g2b = gn_s + 3 * C,
              *g3w = gn_s + 4 * C, *g3b = gn_s + 5 * C;
  bf16 *dt1 = dt, *dt2 = dt + (long)n * W;

  const int ntiles = (n + RT_ROWS - 1) / RT_ROWS, step = gridDim.x * RT_WGS, r0 = tc::acc_row(0);
  uint8_t* own = S_b + wg * 4 * RB_TB;
  uint8_t *G_b = own + 2 * RB_TB, *R_b = own + 3 * RB_TB;
  const tc::Tiles T = tc::tiles(own, RT_ROWS);  // the strides of every staged tile
  auto fetch_x = [&](int tile, int s) {  // one commit group
    fetch_rows<W>(own + s * RB_TB, x, (long)tile * RT_ROWS, RT_ROWS, n, t, 128);
    cp_async_commit();
  };
  auto fetch_gr = [&](int tile) {  // one commit group
    fetch_rows<W>(G_b, g, (long)tile * RT_ROWS, RT_ROWS, n, t, 128);
    fetch_rows<W>(R_b, res, (long)tile * RT_ROWS, RT_ROWS, n, t, 128);
    cp_async_commit();
  };
  float va[6][4];  // column sums (this lane's 4 columns): dg1w, dg1b, dg2w, dg2b, dg3w, dg3b
#pragma unroll
  for (int k = 0; k < 6; ++k) va[k][0] = va[k][1] = va[k][2] = va[k][3] = 0.f;
  int tile = blockIdx.x * RT_WGS + wg;
  if (tile < ntiles) {
    fetch_x(tile, 0);
    fetch_gr(tile);
  }
  for (int k = 0; tile < ntiles; ++k, tile += step) {
    const int s = k & 1;
    cp_async_wait<0>();  // this tile's x, g and res
    // in place for the warpgroup, which is done with the other x stage
    wg_sync();
    if (tile + step < ntiles) fetch_x(tile + step, s ^ 1);
    const uint8_t* X_b = own + s * RB_TB;
    const long row0 = (long)tile * RT_ROWS;
    const bool ok[2] = {row0 + r0 < n, row0 + r0 + 8 < n};
    float acc[64], acc2[64], inv[2];
    uint32_t a[32];
    auto& ha = *reinterpret_cast<uint32_t(*)[C / 16][4]>(a);

    // The chain again: h1 → t1 = h1 @ W1 → h2 → t2 = h2 @ W2; acc ← nrm3.
    load_pairs(acc, X_b, T, r0);
    tail::gn_relu_frags<W>(acc, g1w, g1b, eps, ha);
    tail::frag_mm<W>(acc, ha, W1);
    tail::gn_relu_frags<W>(acc, g2w, g2b, eps, ha);
    tail::frag_mm<W>(acc, ha, W2);
    gn_normalise<W>(acc, eps, inv);
    // d_y = g ⊙ [nrm3·w + b + res > 0] (0 past n) = dres.
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int h = tc::acc_half(i), c = tc::acc_col(i), r = r0 + 8 * h;
      const float2 rv = staged_pair(R_b, T, r, c), gv = staged_pair(G_b, T, r, c);
      acc2[i] = ok[h] && acc[i] * g3w[c] + g3b[c] + rv.x > 0.f ? gv.x : 0.f;
      acc2[i + 1] = ok[h] && acc[i + 1] * g3w[c + 1] + g3b[c + 1] + rv.y > 0.f ? gv.y : 0.f;
    }
    wg_sync();  // every thread done with g's and res's tiles: the next tile's go there
    if (tile + step < ntiles) fetch_gr(tile + step);
#pragma unroll
    for (int i = 0; i < 64; i += 2) a[i / 2] = tc::pack_bf2(acc2[i], acc2[i + 1]);
    store_pairs<W>(dres, row0, r0, ok, a);
    col_sums<true>(va[4], acc2, acc);     // dg3w
    col_sums<false>(va[5], acc2, acc2);   // dg3b
    gn_bwd_acc<W>(acc2, acc, inv, g3w, a);  // a ← rnd(d_t2)
    store_pairs<W>(dt2, row0, r0, ok, a);

    // d_h2 = rnd(d_t2) @ W2ᵀ ⊙ [h2_pre > 0], h2_pre from t1 made again.
    tc::zero(acc);
    mm_frag<true, W>(acc, a, W2);
    load_pairs(acc2, X_b, T, r0);
    tail::gn_relu_frags<W>(acc2, g1w, g1b, eps, ha);
    tail::frag_mm<W>(acc2, ha, W1);
    gn_normalise<W>(acc2, eps, inv);  // nrm2
    relu_mask(acc, acc2, g2w, g2b, ok);
    col_sums<true>(va[2], acc, acc2);  // dg2w
    col_sums<false>(va[3], acc, acc);  // dg2b
    gn_bwd_acc<W>(acc, acc2, inv, g2w, a);  // a ← rnd(d_t1)
    store_pairs<W>(dt1, row0, r0, ok, a);

    // d_h1 = rnd(d_t1) @ W1ᵀ ⊙ [h1_pre > 0]; dx = GN1ᵀ(d_h1).
    tc::zero(acc);
    mm_frag<true, W>(acc, a, W1);
    load_pairs(acc2, X_b, T, r0);
    gn_normalise<W>(acc2, eps, inv);  // nrm1
    relu_mask(acc, acc2, g1w, g1b, ok);
    col_sums<true>(va[0], acc, acc2);  // dg1w
    col_sums<false>(va[1], acc, acc);  // dg1b
    gn_bwd_acc<W>(acc, acc2, inv, g1w, a);
    store_pairs<W>(dx, row0, r0, ok, a);
  }

  // The block's vectors: each warp's columns, summed over the warps in order.
  __syncthreads();
  float* red_s = reinterpret_cast<float*>(S_b);  // [RT_THREADS / 32][6][C]
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
#pragma unroll
    for (int j = 0; j < 4; ++j) red_s[(warp * 6 + k) * C + col_sum_col(j)] = va[k][j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 6 * W; i += RT_THREADS) {  // [6][W]: the row's columns
    const int at = W == C ? i : (i / W) * C + i % W;
    float sum = 0.f;
    for (int w = 0; w < RT_THREADS / 32; ++w) sum += red_s[w * 6 * C + at];
    part_v[(long)blockIdx.x * 6 * W + i] = sum;
  }
}

// The weight-gradient pass: block (split, y) sums Aᵀ B over the RB_DT-row
// tiles split, split + splits, ..., y = 0: dW1 (A = h1, B = rnd(d_t1)),
// y = 1: dW2 (A = h2, B = rnd(d_t2)), K running over a tile's rows (rows
// past n zero-filled in B), both operands MN-major from core tiles;
// warpgroup w owns input channels 64w .. 64w + 63. The tiles [x | d_t]
// stream through a ring of RB_DW_STAGES stages by cp.async; A is made in
// place from x, each warpgroup on its 64 rows of the tile: h1 =
// rnd(relu(GN1(x))), or (y = 1) h2 = rnd(relu(GN2(h1 @ W1))) by the chain
// pass's own arithmetic. part: [splits][dW1, dW2].
template <int W>
__global__ void __launch_bounds__(RT_THREADS, 1)
row_tail2_dw_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                       const float* __restrict__ gn, const bf16* __restrict__ dt,
                       float* __restrict__ part, int n, float eps) {
  extern __shared__ float4 smem4[];
  uint8_t* W_b = reinterpret_cast<uint8_t*>(smem4);           // W1 (y = 1)
  float* gn_s = reinterpret_cast<float*>(W_b + RB_WB);         // [4][C] GN1, GN2 w, b
  uint8_t* A_b = reinterpret_cast<uint8_t*>(gn_s + 4 * C);     // [RB_DT x C]: h1 or h2
  uint8_t* S_b = A_b + RB_DTB;                                 // the ring
  const int y = blockIdx.y, wg = threadIdx.x >> 7;
  const tc::Tiles W1 = tc::tiles(W_b, C), A = tc::tiles(A_b, RB_DT);
  if (y == 1) tc::load_tiles_128<W>(W_b, W1, w1);
  for (int i = threadIdx.x; i < 4 * C; i += RT_THREADS)  // [4][C], zero past W
    gn_s[i] = W == C || i % C < W ? gn[i / C * W + i % C] : 0.f;
  tc::fence_smem();
  __syncthreads();  // W1 (for wgmma) and the vectors in place
  const bf16* B_src = dt + (long)y * n * W;
  const int ntiles = (n + RB_DT - 1) / RB_DT, step = gridDim.x, r0 = tc::acc_row(0);
  constexpr int S = RB_DW_STAGES;
  auto issue = [&](int tile, int st) {  // one commit group, empty past the last tile
    uint8_t* p = S_b + st * 2 * RB_DTB;
    if (tile < ntiles) {
      const long row0 = (long)tile * RB_DT;
      fetch_rows<W>(p, x, row0, RB_DT, n, threadIdx.x, RT_THREADS);
      fetch_rows<W>(p + RB_DTB, B_src, row0, RB_DT, n, threadIdx.x, RT_THREADS);
    }
    cp_async_commit();
  };
  float accw[64];
  tc::zero(accw);
#pragma unroll
  for (int j = 0; j < S - 1; ++j) issue(blockIdx.x + j * step, j);
  for (int k = 0, tile = blockIdx.x; tile < ntiles; ++k, tile += step) {
    cp_async_wait<S - 2>();  // tile k landed (the S − 2 after it may be in flight)
    tc::fence_smem();
    // tile k in place for every thread; both warpgroups done with tile
    // k − 1's A and stage, where tile k + S − 1 goes
    __syncthreads();
    issue(tile + (S - 1) * step, (k + S - 1) % S);
    const uint8_t* p = S_b + (k % S) * 2 * RB_DTB;
    const int rw = 64 * wg + r0;
    float acc[64];
    uint32_t a[32];
    auto& ha = *reinterpret_cast<uint32_t(*)[C / 16][4]>(a);
    load_pairs(acc, p, tc::tiles(p, RB_DT), rw);
    tail::gn_relu_frags<W>(acc, gn_s, gn_s + C, eps, ha);  // h1
    if (y == 1) {
      tail::frag_mm<W>(acc, ha, W1);
      tail::gn_relu_frags<W>(acc, gn_s + 2 * C, gn_s + 3 * C, eps, ha);  // h2
    }
    put_pairs(A_b, A, rw, a);
    tc::fence_smem();
    __syncthreads();  // A in place
    if (W == C || 64 * wg < W) {  // at W = 64 the second warpgroup's channels are padding
      tc::fence_acc(accw);
      tc::fence();
      tc::mm<RB_DT / 16, false, false>(accw, A, 64 * wg, tc::tiles(p + RB_DTB, RB_DT));
      tc::commit();
      tc::wait_all();
      tc::fence_acc(accw);
    }
  }
  cp_async_wait<0>();  // the empty groups past the last tile
  float* P = part + ((long)blockIdx.x * 2 + y) * W * W;
  if (W == C || 64 * wg < W) {
#pragma unroll
    for (int i = 0; i < W / 2; i += 2)
      *reinterpret_cast<float2*>(P + (64 * wg + tc::acc_row(i)) * W + tc::acc_col(i)) =
          make_float2(accw[i], accw[i + 1]);
  }
}

// part: blocks * tail2_part<W>() floats. bf16: the weight-gradient pass's
// partials [splits][dW1, dW2] from the start, the chain pass's vector sums
// [chain blocks][6*W] from blocks*2*W*W; dt: [2, n, W] bf16 workspace.
// fp32: one partial per block (dt unused).
template <typename T, int W>
int launch2_bwd(const void* x, const void* res, const void* g, const void* w1, const void* w2,
                const float* gn, void* dx, void* dres, float* part, float* grads, void* dt,
                int n, int blocks, float eps, cudaStream_t stream) {
  cudaError_t err;
  if constexpr (std::is_same<T, bf16>::value) {
    const int nb = min(blocks, ((n + RT_ROWS - 1) / RT_ROWS + RT_WGS - 1) / RT_WGS);
    const int splits = min(blocks, (n + RB_DT - 1) / RB_DT);
    float* part_v = part + (long)blocks * 2 * W * W;
    if (nb > 0) {
      int smem = tail2_bwd_tc_smem();
      err = set_smem((const void*)row_tail2_bwd_tc_kernel<W>, smem);
      if (err != cudaSuccess) return (int)err;
      row_tail2_bwd_tc_kernel<W><<<nb, RT_THREADS, smem, stream>>>(
          (const bf16*)x, (const bf16*)res, (const bf16*)g, (const bf16*)w1, (const bf16*)w2, gn,
          (bf16*)dx, (bf16*)dres, (bf16*)dt, part_v, n, eps);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      smem = tail2_dw_tc_smem();
      err = set_smem((const void*)row_tail2_dw_tc_kernel<W>, smem);
      if (err != cudaSuccess) return (int)err;
      row_tail2_dw_tc_kernel<W><<<dim3(splits, 2), RT_THREADS, smem, stream>>>(
          (const bf16*)x, (const bf16*)w1, gn, (const bf16*)dt, part, n, eps);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    err = reduce_partials(part, grads, splits, 2 * W * W, stream);
    if (err != cudaSuccess) return (int)err;
    return (int)reduce_partials(part_v, grads + 2 * W * W, nb, 6 * W, stream);
  } else {
    const int smem = tail2_bwd_smem();
    err = set_smem((const void*)row_tail2_bwd_kernel<T, W>, smem);
    if (err != cudaSuccess) return (int)err;
    const int ntiles = (n + TM - 1) / TM;
    if (blocks > ntiles) blocks = ntiles;
    if (blocks > 0) {
      row_tail2_bwd_kernel<T, W><<<blocks, NT, smem, stream>>>(
          (const T*)x, (const T*)res, (const T*)g, (const T*)w1, (const T*)w2, gn, (T*)dx,
          (T*)dres, part, n, eps);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    return (int)reduce_partials(part, grads, blocks, tail2_part<W>(), stream);
  }
}

// --- K = 1 at W = 256 (wide.cuh's tiling; the double-width model's Att
// tails) -----------------------------------------------------------------------
//
// fp32 (row_tail_wide_kernel, the parity path): a block per 64-row tile,
// the rows in one fp32 [64 x 256] tile, GN by warp-a-row, the product on
// CUDA cores with W streamed in KC-row chunks; 97 KB of shared memory.
// bf16 (row_tail_wide_tc_kernel): a persistent grid of two-warpgroup
// blocks, W held once per block as four quadrants (129 KB), each warpgroup
// on 64-row tiles of its own: x read into the accumulator layout, h =
// rnd(relu(GN1(x))) into the warpgroup's A operand in shared memory, z = h
// @ W on wgmma into two m64n128 accumulators, then GN2, the residual and
// the ReLU on them. What bounds it: x and res read and out written (3·256
// bf16 a row) against 2·256² operations a row: 85 operations a byte, below
// the card's ~295, so bytes.

__global__ void __launch_bounds__(NT)
row_tail_wide_kernel(const float* __restrict__ x, const float* __restrict__ res,
                     const float* __restrict__ w, const float* __restrict__ g1w,
                     const float* __restrict__ g1b, const float* __restrict__ g2w,
                     const float* __restrict__ g2b, float* __restrict__ out, int n, float eps) {
  extern __shared__ float4 smem4[];
  float* X_s = reinterpret_cast<float*>(smem4);  // [TM][LDW]
  float* W_s = X_s + TM * wide::LDW;             // [KC][256]
  const long row0 = (long)blockIdx.x * TM;
  const int warp = threadIdx.x >> 5;

  for (int r = warp; r < TM; r += NT / 32) {  // h = relu(GN1(x)) (0 past n)
    const long g = row0 + r;
    wide::Row v = g < n ? wide::ld_row_g<float>(x + g * wide::WW) : wide::Row{zero4(), zero4()};
    wide::st_row(X_s + r * wide::LDW, wide::relu_row(wide::gn_row(v, g1w, g1b, eps)));
  }
  float acc[8][8];
  wide::zero8(acc);
  const float ones[8] = {1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f};
  wide::mm_rows(X_s, 0, ones, w, W_s, acc);  // z = h @ W
  __syncthreads();
  wide::store_tile(X_s, acc);
  __syncthreads();
  for (int r = warp; r < TM; r += NT / 32) {
    const long g = row0 + r;
    if (g >= n) break;
    const wide::Row y = wide::gn_row(wide::ld_row(X_s + r * wide::LDW), g2w, g2b, eps);
    const wide::Row rv = wide::ld_row_g<float>(res + g * wide::WW);
    wide::st_row_g<float>(out + g * wide::WW, wide::relu_row(wide::add_row(y, rv)));
  }
}

constexpr int RW_WGS = 2;
constexpr int RW_THREADS = 128 * RW_WGS;

inline int row_tail_wide_tc_smem() {
  return 4 * wide::QB + RW_WGS * 2 * wide::HB + 4 * wide::WW * (int)sizeof(float);
}

__global__ void __launch_bounds__(RW_THREADS, 1)
row_tail_wide_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ res,
                        const bf16* __restrict__ w, const float* __restrict__ g1w,
                        const float* __restrict__ g1b, const float* __restrict__ g2w,
                        const float* __restrict__ g2b, bf16* __restrict__ out, int n,
                        float eps) {
  extern __shared__ float4 smem4[];
  uint8_t* W_b = reinterpret_cast<uint8_t*>(smem4);                        // 4 quadrants
  float* gn_s = reinterpret_cast<float*>(W_b + 4 * wide::QB + RW_WGS * 2 * wide::HB);  // [4][256]
  const int wg = threadIdx.x >> 7;
  uint8_t* H_b = W_b + 4 * wide::QB + wg * 2 * wide::HB;  // the warpgroup's A operand

#pragma unroll
  for (int q = 0; q < 4; ++q)
    wide::fetch_quadrant(W_b + q * wide::QB, w, q & 1, q >> 1, threadIdx.x, RW_THREADS);
  cp_async_commit();
  for (int i = threadIdx.x; i < 4 * wide::WW; i += RW_THREADS) {
    const float* v = i < wide::WW ? g1w : i < 2 * wide::WW ? g1b : i < 3 * wide::WW ? g2w : g2b;
    gn_s[i] = v[i & (wide::WW - 1)];
  }
  cp_async_wait<0>();
  tc::fence_smem();
  __syncthreads();  // W and the vectors in place

  const int ntiles = (n + TM - 1) / TM;
  for (int tile = blockIdx.x * RW_WGS + wg; tile < ntiles; tile += gridDim.x * RW_WGS) {
    const long row0 = (long)tile * TM;
    float a[2][64];
    wide::load_rows(a, x, row0, n);
    wg_sync();  // the warpgroup's previous products are done with H
    wide::gn_relu_to(H_b, a, gn_s, gn_s + wide::WW, eps);  // h = rnd(relu(GN1(x)))
    tc::fence_smem();
    wg_sync();
    wide::zero2(a);
    wide::mm_weight(a, H_b, W_b);  // z = h @ W
    wide::gn_res_relu(
        a, gn_s + 2 * wide::WW, gn_s + 3 * wide::WW, eps,
        [&](int r, int c) {
          const long gr = row0 + r;
          return gr < n ? wide::ld_pair(res + gr * wide::WW + c) : make_float2(0.f, 0.f);
        },
        [&](int r, int c, float y0, float y1) {
          const long gr = row0 + r;
          if (gr < n)
            *reinterpret_cast<__nv_bfloat162*>(out + gr * wide::WW + c) =
                __floats2bfloat162_rn(y0, y1);
        });
  }
}

template <typename T>
int launch_wide(const void* x, const void* res, const void* w, const float* g1w,
                const float* g1b, const float* g2w, const float* g2b, void* out, int n,
                float eps, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    const int smem = row_tail_wide_tc_smem();
    cudaError_t err = set_smem((const void*)row_tail_wide_tc_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const int sms = wide::sm_count();
    if (sms < 0) return (int)cudaGetLastError();
    const int tiles = (n + TM - 1) / TM, blocks = min(sms, (tiles + RW_WGS - 1) / RW_WGS);
    if (blocks > 0)
      row_tail_wide_tc_kernel<<<blocks, RW_THREADS, smem, stream>>>(
          (const bf16*)x, (const bf16*)res, (const bf16*)w, g1w, g1b, g2w, g2b, (bf16*)out, n,
          eps);
  } else {
    const int smem = wide::TILE_BYTES + wide::CHUNK_BYTES;
    cudaError_t err = set_smem((const void*)row_tail_wide_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (n + TM - 1) / TM;
    if (blocks > 0)
      row_tail_wide_kernel<<<blocks, NT, smem, stream>>>(
          (const float*)x, (const float*)res, (const float*)w, g1w, g1b, g2w, g2b, (float*)out,
          n, eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, res, w, out); x, res, out [n, width],
// w [width, width], GN vectors fp32 [width]; width 128, 64 or 256.
extern "C" int row_tail_fwd(const void* x, const void* res, const void* w, const void* g1w,
                            const void* g1b, const void* g2w, const void* g2b, void* out,
                            int n, int width, float eps, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float *a = (const float*)g1w, *b = (const float*)g1b, *c = (const float*)g2w,
              *d = (const float*)g2b;
  return with_width_dtype_256(width, dtype, [&](auto Wc, auto Tc) {
    using T = typename decltype(Tc)::type;
    if constexpr (decltype(Wc)::value == 2 * C)
      return launch_wide<T>(x, res, w, a, b, c, d, out, n, eps, st);
    else
      return launch<T, decltype(Wc)::value>(x, res, w, a, b, c, d, out, n, eps, st);
  });
}

// K = 2: out = relu(GN3(relu(GN2(relu(GN1(x)) @ W1)) @ W2) + res).
// dtype and width as row_tail_fwd (x, res, w1, w2, out; x, res, out [n,
// width], w1, w2 [width, width]); gn: fp32 [6, width] = GN1 weight, GN1
// bias, GN2 weight, GN2 bias, GN3 weight, GN3 bias.
extern "C" int row_tail2_fwd(const void* x, const void* res, const void* w1, const void* w2,
                             const void* gn, void* out, int n, int width, float eps, int dtype,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* g = (const float*)gn;
  return with_width_dtype(width, dtype, [&](auto Wc, auto Tc) {
    return launch2<typename decltype(Tc)::type, decltype(Wc)::value>(x, res, w1, w2, g, out, n,
                                                                     eps, st);
  });
}

namespace {

template <int W>
int launch_row_tail_bwd(const void* x, const void* res, const void* g, const void* w,
                        const float* g1w, const float* g1b, const float* g2w, const float* g2b,
                        void* dx, void* dres, float* part, float* grads, int n, int blocks,
                        float eps, int dtype, cudaStream_t st) {
  if (dtype == 0)
    return launch_tail_bwd<float, float, W>((const float*)x, (const float*)res, (const float*)g,
                                            (const float*)w, g1w, g1b, g2w, g2b, (float*)dx,
                                            (float*)dres, nullptr, nullptr, part, grads, n,
                                            blocks, eps, st);
  if (dtype == 1)
    return launch_tail_bwd<bf16, bf16, W>((const bf16*)x, (const bf16*)res, (const bf16*)g,
                                          (const bf16*)w, g1w, g1b, g2w, g2b, (bf16*)dx,
                                          (bf16*)dres, nullptr, nullptr, part, grads, n, blocks,
                                          eps, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Backward. g: the output cotangent in x's dtype; dx, dres [n, width] in x's
// dtype; part: blocks * (W*W + 4*W) fp32 workspace (W = width, 128 or 64;
// at 256, wide_bwd.cuh's kernels: ops/row_tail.py `wide_part_floats`);
// grads: fp32 [W*W + 4*W] = dW (in, out), dg1w, dg1b, dg2w, dg2b.
extern "C" int row_tail_bwd(const void* x, const void* res, const void* g, const void* w,
                            const void* g1w, const void* g1b, const void* g2w, const void* g2b,
                            void* dx, void* dres, void* part, void* grads, int n, int width,
                            int blocks, float eps, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float *a = (const float*)g1w, *b = (const float*)g1b, *c = (const float*)g2w,
              *d = (const float*)g2b;
  float *p = (float*)part, *gr = (float*)grads;
  if (width == 2 * C) {
    if (dtype == 0)
      return wide::launch_tail_bwd<float, float>((const float*)x, (const float*)res,
                                                 (const float*)g, (const float*)w, a, b, c, d,
                                                 (float*)dx, (float*)dres, nullptr, nullptr, p,
                                                 gr, n, blocks, eps, st);
    if (dtype == 1)
      return wide::launch_tail_bwd<bf16, bf16>((const bf16*)x, (const bf16*)res, (const bf16*)g,
                                               (const bf16*)w, a, b, c, d, (bf16*)dx,
                                               (bf16*)dres, nullptr, nullptr, p, gr, n, blocks,
                                               eps, st);
    return (int)cudaErrorInvalidValue;
  }
  return with_width(width, [&](auto Wc) {
    return launch_row_tail_bwd<decltype(Wc)::value>(x, res, g, w, a, b, c, d, dx, dres, p, gr, n,
                                                    blocks, eps, dtype, st);
  });
}

// K = 2 backward. g: the output cotangent in x's dtype; dx, dres [n, W] in
// x's dtype (W = width, 128 or 64); gn as row_tail2_fwd; part: blocks *
// (2*W*W + 6*W) fp32 workspace; grads: fp32 [2*W*W + 6*W] = dW1, dW2 (in,
// out), then the GN1, GN2 and GN3 weight and bias gradients, the
// partials' sums in block (split) order; dt: bf16 [2, n, W] workspace
// (rnd(d_t1), rnd(d_t2)), null for float32. blocks: the card's SMs. bf16:
// x, res, g, dx, dres and dt 16-byte aligned.
extern "C" int row_tail2_bwd(const void* x, const void* res, const void* g, const void* w1,
                             const void* w2, const void* gn, void* dx, void* dres, void* part,
                             void* grads, void* dt, int n, int width, int blocks, float eps,
                             int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* gv = (const float*)gn;
  float *p = (float*)part, *gr = (float*)grads;
  return with_width_dtype(width, dtype, [&](auto Wc, auto Tc) {
    return launch2_bwd<typename decltype(Tc)::type, decltype(Wc)::value>(
        x, res, g, w1, w2, gv, dx, dres, p, gr, dt, n, blocks, eps, st);
  });
}
