// Fused residual row tails, K = 1 (forward and backward) and K = 2 (forward).
//
// Replaces lanegcn_tpu/ops/pallas_row_tail.py `_fwd_kernel` / `_fwd_impl`
// (the Pallas kernel behind `fused_row_tail`), the tail every Att stage runs
// after its edge aggregation:
//
//   out = relu(GN2(relu(GN1(x)) @ W) + res)      (single-group GroupNorms)
//
// What bounds it: x, res and out are each read or written once (160 MB at
// N = 208,896 in bf16) against 6.8 GFLOP, so at the card's bf16 matrix rate
// it is memory-bound; this first version runs the product on CUDA cores in
// fp32, whose rate is close enough to the memory time that the product, not
// the traffic, may dominate. The design keeps the chain in one pass: a block
// owns 64 rows, takes both GN statistics with one warp per row, and the
// normalized rows, the product and its statistics stay in shared memory, so
// each byte of x, res and out crosses device memory once.
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
// The same block of 64 rows keeps the whole chain in shared memory: the
// tile, then each product's result, in place, with one fp32 weight slot
// (64 KB) that W2 overwrites once W1's product is done, so a block needs
// 97 KB and two fit on an SM (both weights at once would take 162 KB and
// one block per SM). h1 and h2 are rounded to x's dtype before their
// products, as on the TPU. What bounds it: x, res and out cross device
// memory once (160 MB at N = 208,896 in bf16) against 13.7 GFLOP, so at
// the card's bf16 matrix rate it is memory-bound; on the CUDA cores in fp32
// that this version uses, the two products dominate.
#include "tail_bwd.cuh"

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

template <typename T>
int launch2(const void* x, const void* res, const void* w1, const void* w2, const float* gn,
            void* out, int n, float eps, cudaStream_t stream) {
  const int smem = (TM * LDA + C * C) * (int)sizeof(float);
  cudaError_t err = set_smem((const void*)row_tail2_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + TM - 1) / TM;
  if (blocks > 0) {
    row_tail2_kernel<T><<<blocks, NT, smem, stream>>>((const T*)x, (const T*)res, (const T*)w1,
                                                      (const T*)w2, gn, (T*)out, n, eps);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* res, const void* w, const float* g1w, const float* g1b,
           const float* g2w, const float* g2b, void* out, int n, float eps,
           cudaStream_t stream) {
  const int smem = (TM * LDA + C * C) * (int)sizeof(float);
  cudaError_t err = set_smem((const void*)row_tail_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + TM - 1) / TM;
  if (blocks > 0) {
    row_tail_kernel<T><<<blocks, NT, smem, stream>>>((const T*)x, (const T*)res, (const T*)w,
                                                     g1w, g1b, g2w, g2b, (T*)out, n, eps);
  }
  return (int)cudaGetLastError();
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
