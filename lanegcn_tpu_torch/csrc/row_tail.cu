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
// K = 2. Per 64-row tile it recomputes the chain and runs back through
// GN3 → W2 → GN2 → W1 → GN1:
//
//   d_y = g ⊙ [y + res > 0] (= dres);  d_t2 = rnd(GN3ᵀ(d_y));  dW2 += h2ᵀ d_t2
//   d_h2 = d_t2 @ W2ᵀ ⊙ [h2_pre > 0]; d_t1 = rnd(GN2ᵀ(d_h2));  dW1 += h1ᵀ d_t1
//   d_h1 = d_t1 @ W1ᵀ ⊙ [h1_pre > 0]; dx = GN1ᵀ(d_h1)
//
// with h1, h2 and each d_t rounded to x's dtype before its products, as the
// Pallas backward rounds them. Shared memory: four fp32 tiles (x/h1, t1 then
// d_t1 then d_h1, h2, t2 then d_t2 then d_h2), one 64 KB weight slot loaded
// with W1, W2, W2ᵀ and W1ᵀ in turn (all four at once would take 256 KB),
// and the six GN vector sums per warp: 220 KB, one block per SM. One block
// per SM walks the tiles with dW1 and dW2 in registers (an 8 x 8 block of
// each per thread) and writes one partial per block; reduce_partials sums
// the partials in block order (no float atomics, bitwise reruns). What
// bounds it: x, res and g read and dx, dres written (267 MB at N = 208,896
// in bf16) against six [N x 128] x [128 x 128] products (41.1 GFLOP):
// memory-bound at the card's bf16 matrix rate, product-bound on the CUDA
// cores this version uses.
#include "tail_bwd.cuh"
#include "tail_fwd.cuh"

using namespace lgk;

namespace {

template <typename T>
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
    if (g < n) v = load4<T>(x + g * C + c4);
    *reinterpret_cast<float4*>(X_s + r * LDA + c4) = v;
  }
  load_weight<T>(W_s, w);
  __syncthreads();
  gn_relu_rows<T>(X_s, TM, g1w, g1b, eps);  // h = relu(GN1(x)), rounded to T
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
    const float4 y = gn_row(z, g2w, g2b, eps);
    const float4 rv = load4<T>(res + g * C + lane * 4);
    store4<T>(out + g * C + lane * 4, relu4(add4(y, rv)));
  }
}

// K = 2 (LanePooling's tail): the same block and tile, with the second
// product's weight loaded over the first's once the first product is done.
template <typename T>
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
    if (g < n) v = load4<T>(x + g * C + c4);
    *reinterpret_cast<float4*>(X_s + r * LDA + c4) = v;
  }
  load_weight<T>(W_s, w1);
  __syncthreads();
  gn_relu_rows<T>(X_s, TM, gn, gn + C, eps);  // h1 = relu(GN1(x)), rounded to T
  __syncthreads();

  float acc[4][8];
  const float ones[4] = {1.f, 1.f, 1.f, 1.f};
  zero_acc(acc);
  mm_64x128(X_s, 0, ones, W_s, acc);  // t1 = h1 @ W1
  __syncthreads();
  store_acc(X_s, acc);
  load_weight<T>(W_s, w2);
  __syncthreads();
  gn_relu_rows<T>(X_s, TM, gn + 2 * C, gn + 3 * C, eps);  // h2 = relu(GN2(t1)), rounded
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
    const float4 y = gn_row(t, gn + 4 * C, gn + 5 * C, eps);
    const float4 rv = load4<T>(res + g * C + lane * 4);
    store4<T>(out + g * C + lane * 4, relu4(add4(y, rv)));
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

template <int K>
__global__ void __launch_bounds__(RT_THREADS, 1)
row_tail_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ res,
                   const bf16* __restrict__ w1, const bf16* __restrict__ w2, TailVecs vecs,
                   bf16* __restrict__ out, int n, float eps) {
  extern __shared__ float4 smem4[];
  uint8_t* W_b = reinterpret_cast<uint8_t*>(smem4);                     // [K] weight core tiles
  float* gn_s = reinterpret_cast<float*>(W_b + K * tc::tiles_bytes(C));  // [2K + 2][C]
  bf16* S_s = reinterpret_cast<bf16*>(gn_s + (2 * K + 2) * C);          // [RT_WGS][2][x, res]
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;

  tc::load_tiles_128(W_b, tc::tiles(W_b, C), w1);
  if (K == 2) tc::load_tiles_128(W_b + tc::tiles_bytes(C), tc::tiles(W_b, C), w2);
  for (int i = threadIdx.x; i < (2 * K + 2) * C; i += RT_THREADS) gn_s[i] = vecs.v[i / C][i % C];
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
      const bool in = gr < n;
      cp_async16_zfill(X + r * RT_LD + c, in ? x + gr * C + c : x, in ? 16 : 0);
      cp_async16_zfill(X + RT_TILE + r * RT_LD + c, in ? res + gr * C + c : res, in ? 16 : 0);
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
      tail::gn_relu_frags(acc, gn_s + 2 * j * C, gn_s + (2 * j + 1) * C, eps, ha);
      tail::frag_mm(acc, ha, tc::tiles(W_b + j * tc::tiles_bytes(C), C));
    }
    // out = relu(GN(·) + res), over res in its staged tile
    tail::gn_res_relu(
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
      if (row0 + r < n)
        *reinterpret_cast<uint4*>(out + (row0 + r) * C + c) =
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

template <int K>
int launch_tc(const void* x, const void* res, const void* w1, const void* w2,
              const TailVecs& vecs, void* out, int n, float eps, cudaStream_t stream) {
  const int smem = row_tail_tc_smem<K>();
  cudaError_t err = set_smem((const void*)row_tail_tc_kernel<K>, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = row_tail_tc_blocks(n);
  if (blocks < 0) return (int)cudaGetLastError();
  if (blocks > 0)
    row_tail_tc_kernel<K><<<blocks, RT_THREADS, smem, stream>>>(
        (const bf16*)x, (const bf16*)res, (const bf16*)w1, (const bf16*)w2, vecs, (bf16*)out, n,
        eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch2(const void* x, const void* res, const void* w1, const void* w2, const float* gn,
            void* out, int n, float eps, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    const TailVecs vecs{{gn, gn + C, gn + 2 * C, gn + 3 * C, gn + 4 * C, gn + 5 * C}};
    return launch_tc<2>(x, res, w1, w2, vecs, out, n, eps, stream);
  } else {
    const int smem = (TM * LDA + C * C) * (int)sizeof(float);
    cudaError_t err = set_smem((const void*)row_tail2_kernel<T>, smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (n + TM - 1) / TM;
    if (blocks > 0)
      row_tail2_kernel<T><<<blocks, NT, smem, stream>>>((const T*)x, (const T*)res,
                                                        (const T*)w1, (const T*)w2, gn, (T*)out,
                                                        n, eps);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int launch(const void* x, const void* res, const void* w, const float* g1w, const float* g1b,
           const float* g2w, const float* g2b, void* out, int n, float eps,
           cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    const TailVecs vecs{{g1w, g1b, g2w, g2b, nullptr, nullptr}};
    return launch_tc<1>(x, res, w, nullptr, vecs, out, n, eps, stream);
  } else {
    const int smem = (TM * LDA + C * C) * (int)sizeof(float);
    cudaError_t err = set_smem((const void*)row_tail_kernel<T>, smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (n + TM - 1) / TM;
    if (blocks > 0)
      row_tail_kernel<T><<<blocks, NT, smem, stream>>>((const T*)x, (const T*)res, (const T*)w,
                                                       g1w, g1b, g2w, g2b, (T*)out, n, eps);
    return (int)cudaGetLastError();
  }
}

constexpr int TAIL2_PART = 2 * C * C + 6 * C;  // dW1, dW2, dg1w, dg1b, dg2w, dg2b, dg3w, dg3b

inline int tail2_bwd_smem() {
  return (4 * TM * LDA + C * C + 2 * TM + NT / 32 * 6 * C) * (int)sizeof(float);
}

template <typename T>
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
  const float *g1w = gn, *g1b = gn + C, *g2w = gn + 2 * C, *g2b = gn + 3 * C,
              *g3w = gn + 4 * C, *g3b = gn + 5 * C;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
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
      *reinterpret_cast<float4*>(A_s + r * LDA + c4) = gr < n ? load4<T>(x + gr * C + c4) : zero4();
    }
    load_weight<T>(W_s, w1);
    __syncthreads();
    // h1 = rnd(relu(GN1(x))) in place; rows past n hold 0.
    for (int r = warp; r < TM; r += NT / 32) {
      float4* p = reinterpret_cast<float4*>(A_s + r * LDA + lane * 4);
      const float2 st = gn_stats(*p, eps);
      const float4 h = rnd4<T>(relu4(gn_affine(gn_nrm(*p, st), g1w, g1b)));
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
      const float4 h = rnd4<T>(relu4(gn_row(t1, g2w, g2b, eps)));
      *reinterpret_cast<float4*>(C_s + r * LDA + lane * 4) = (row0 + r < n) ? h : zero4();
    }
    load_weight<T>(W_s, w2);
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
        const float2 st = gn_stats(*p, eps);
        const float4 nrm = gn_nrm(*p, st);
        const float4 y = gn_affine(nrm, g3w, g3b);
        const float4 rv = load4<T>(res + gr * C + lane * 4);
        const float4 d_y = pos_mask4(load4<T>(g + gr * C + lane * 4), add4(y, rv));
        add_warp_vec<6>(vec_s, 4, mul4(d_y, nrm));
        add_warp_vec<6>(vec_s, 5, d_y);
        dt = rnd4<T>(gn_bwd_row(d_y, nrm, st.y, g3w));
        store4<T>(dres + gr * C + lane * 4, d_y);
      }
      *p = dt;
    }
    load_weight_t<T>(W_s, w2);
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
        const float2 st = gn_stats(*p, eps);
        const float4 nrm = gn_nrm(*p, st);
        const float4 d_h = pos_mask4(*reinterpret_cast<const float4*>(D_s + r * LDA + lane * 4),
                                     gn_affine(nrm, g2w, g2b));
        add_warp_vec<6>(vec_s, 2, mul4(d_h, nrm));
        add_warp_vec<6>(vec_s, 3, d_h);
        dt = rnd4<T>(gn_bwd_row(d_h, nrm, st.y, g2w));
      }
      *p = dt;
    }
    load_weight_t<T>(W_s, w1);
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
      const float4 nrm = gn_nrm(load4<T>(x + gr * C + lane * 4), st);
      const float4 d_h = pos_mask4(*reinterpret_cast<const float4*>(B_s + r * LDA + lane * 4),
                                   gn_affine(nrm, g1w, g1b));
      add_warp_vec<6>(vec_s, 0, mul4(d_h, nrm));
      add_warp_vec<6>(vec_s, 1, d_h);
      store4<T>(dx + gr * C + lane * 4, gn_bwd_row(d_h, nrm, st.y, g1w));
    }
  }
  float* P = part + (long)blockIdx.x * TAIL2_PART;
  store_tn(P, accW1, false);
  store_tn(P + C * C, accW2, false);
  sum_warp_vecs<6>(vec_s, P + 2 * C * C);
}

template <typename T>
int launch2_bwd(const void* x, const void* res, const void* g, const void* w1, const void* w2,
                const float* gn, void* dx, void* dres, float* part, float* grads, int n,
                int blocks, float eps, cudaStream_t stream) {
  const int smem = tail2_bwd_smem();
  cudaError_t err = set_smem((const void*)row_tail2_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (n + TM - 1) / TM;
  if (blocks > ntiles) blocks = ntiles;
  if (blocks > 0) {
    row_tail2_bwd_kernel<T><<<blocks, NT, smem, stream>>>(
        (const T*)x, (const T*)res, (const T*)g, (const T*)w1, (const T*)w2, gn, (T*)dx,
        (T*)dres, part, n, eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)reduce_partials(part, grads, blocks, TAIL2_PART, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, res, w, out); GN vectors fp32 [128].
extern "C" int row_tail_fwd(const void* x, const void* res, const void* w, const void* g1w,
                            const void* g1b, const void* g2w, const void* g2b, void* out,
                            int n, float eps, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float *a = (const float*)g1w, *b = (const float*)g1b, *c = (const float*)g2w,
              *d = (const float*)g2b;
  if (dtype == 0) return launch<float>(x, res, w, a, b, c, d, out, n, eps, st);
  if (dtype == 1) return launch<bf16>(x, res, w, a, b, c, d, out, n, eps, st);
  return (int)cudaErrorInvalidValue;
}

// K = 2: out = relu(GN3(relu(GN2(relu(GN1(x)) @ W1)) @ W2) + res).
// dtype as row_tail_fwd (x, res, w1, w2, out); gn: fp32 [6, 128] = GN1
// weight, GN1 bias, GN2 weight, GN2 bias, GN3 weight, GN3 bias.
extern "C" int row_tail2_fwd(const void* x, const void* res, const void* w1, const void* w2,
                             const void* gn, void* out, int n, float eps, int dtype,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* g = (const float*)gn;
  if (dtype == 0) return launch2<float>(x, res, w1, w2, g, out, n, eps, st);
  if (dtype == 1) return launch2<bf16>(x, res, w1, w2, g, out, n, eps, st);
  return (int)cudaErrorInvalidValue;
}

// Backward. g: the output cotangent in x's dtype; dx, dres [n, 128] in x's
// dtype; part: blocks * (C*C + 4*C) fp32 workspace; grads: fp32
// [C*C + 4*C] = dW (in, out), dg1w, dg1b, dg2w, dg2b.
extern "C" int row_tail_bwd(const void* x, const void* res, const void* g, const void* w,
                            const void* g1w, const void* g1b, const void* g2w, const void* g2b,
                            void* dx, void* dres, void* part, void* grads, int n, int blocks,
                            float eps, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float *a = (const float*)g1w, *b = (const float*)g1b, *c = (const float*)g2w,
              *d = (const float*)g2b;
  float *p = (float*)part, *gr = (float*)grads;
  if (dtype == 0)
    return launch_tail_bwd<float, float>((const float*)x, (const float*)res, (const float*)g,
                                         (const float*)w, a, b, c, d, (float*)dx,
                                         (float*)dres, nullptr, nullptr, p, gr, n, blocks,
                                         eps, st);
  if (dtype == 1)
    return launch_tail_bwd<bf16, bf16>((const bf16*)x, (const bf16*)res, (const bf16*)g,
                                       (const bf16*)w, a, b, c, d, (bf16*)dx, (bf16*)dres,
                                       nullptr, nullptr, p, gr, n, blocks, eps, st);
  return (int)cudaErrorInvalidValue;
}

// K = 2 backward. g: the output cotangent in x's dtype; dx, dres [n, 128] in
// x's dtype; gn as row_tail2_fwd; part: blocks * (2*C*C + 6*C) fp32
// workspace; grads: fp32 [2*C*C + 6*C] = dW1, dW2 (in, out), then the GN1,
// GN2 and GN3 weight and bias gradients.
extern "C" int row_tail2_bwd(const void* x, const void* res, const void* g, const void* w1,
                             const void* w2, const void* gn, void* dx, void* dres, void* part,
                             void* grads, int n, int blocks, float eps, int dtype,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* gv = (const float*)gn;
  float *p = (float*)part, *gr = (float*)grads;
  if (dtype == 0)
    return launch2_bwd<float>(x, res, g, w1, w2, gv, dx, dres, p, gr, n, blocks, eps, st);
  if (dtype == 1)
    return launch2_bwd<bf16>(x, res, g, w1, w2, gv, dx, dres, p, gr, n, blocks, eps, st);
  return (int)cudaErrorInvalidValue;
}
