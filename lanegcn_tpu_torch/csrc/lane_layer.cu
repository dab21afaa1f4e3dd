// Fused LaneConv residual layer, forward.
//
// Replaces lanegcn_tpu/ops/pallas_lane_layer.py `_fwd_kernel` / `_fwd_impl`
// (the Pallas kernel behind `fused_lane_layer`). Per node row u:
//
//   temp = pre + Σ_{j<J} band_j[u] · feat[u + s_j] @ Wb_j   (|s_j| ≤ 32, rows
//                                                           outside [0,N) read 0)
//   out  = relu(GN2(relu(GN1(temp)) @ W2) + feat)
//
// What bounds it: a [128 x 128] band product on every row its mask selects
// and the second product on every row (64 GFLOP at the 256-scenario bench
// pack, N = 208,896, ~8 masked band rows per row) against ~163 MB of
// traffic, so it is compute-bound on the card's matrix rate. This first version runs the
// products on CUDA cores in fp32 (register-blocked 4 x 8 per thread), so it
// sits far below the bf16 tensor-core bound; moving the products to wgmma is
// later work. What the design keeps out of device memory: each block loads
// its 64-row tile plus a ±32-row halo of feat ONCE into shared memory and
// reuses it for all 12 shifted products and the residual; temp, the GN
// statistics, h and z never leave shared memory / registers. The band masks
// stay compact ([J, N] bytes) instead of padded planes.
#include "common.cuh"

using namespace lgk;

namespace {

constexpr int HALO = 32;
constexpr int MAXJ = 16;

struct Shifts {
  int s[MAXJ];
};

template <typename T>
__global__ void __launch_bounds__(NT)
lane_layer_kernel(const T* __restrict__ feat, const T* __restrict__ pre,
                  const uint8_t* __restrict__ masks, const T* __restrict__ wb,
                  const T* __restrict__ w2, const float* __restrict__ g1w,
                  const float* __restrict__ g1b, const float* __restrict__ g2w,
                  const float* __restrict__ g2b, T* __restrict__ out, int n, int nj,
                  Shifts sh, float eps) {
  extern __shared__ float4 smem4[];
  float* X_s = reinterpret_cast<float*>(smem4);   // [TM + 2*HALO][LDA]
  float* T_s = X_s + (TM + 2 * HALO) * LDA;       // [TM][LDA]
  float* W_s = T_s + TM * LDA;                    // [C][C]
  const long tile0 = (long)blockIdx.x * TM;

  // feat rows tile0-HALO .. tile0+TM+HALO-1, zero outside [0, n).
  for (int idx = threadIdx.x; idx < (TM + 2 * HALO) * (C / 4); idx += NT) {
    const int r = idx / (C / 4), c4 = (idx % (C / 4)) * 4;
    const long g = tile0 - HALO + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g >= 0 && g < n) v = load4<T>(feat + g * C + c4);
    *reinterpret_cast<float4*>(X_s + r * LDA + c4) = v;
  }

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long g = tile0 + mm_row(i);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = (g < n) ? to_f<T>(pre[g * C + mm_col(j)]) : 0.f;
  }

  for (int j = 0; j < nj; ++j) {
    __syncthreads();  // previous product done with W_s (and X_s loaded)
    load_weight<T>(W_s, wb + (long)j * C * C);
    float m[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long g = tile0 + mm_row(i);
      m[i] = (g < n && masks[(long)j * n + g]) ? 1.f : 0.f;
    }
    __syncthreads();
    mm_64x128(X_s, HALO + sh.s[j], m, W_s, acc);
  }

  store_acc(T_s, acc);
  __syncthreads();
  gn_relu_rows<T>(T_s, TM, g1w, g1b, eps);  // h = relu(GN1(temp)), rounded to T
  load_weight<T>(W_s, w2);
  __syncthreads();
  const float ones[4] = {1.f, 1.f, 1.f, 1.f};
  zero_acc(acc);
  mm_64x128(T_s, 0, ones, W_s, acc);          // z = h @ W2
  __syncthreads();
  store_acc(T_s, acc);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < TM; r += NT / 32) {
    const long g = tile0 + r;
    if (g >= n) break;
    const float4 z = *reinterpret_cast<const float4*>(T_s + r * LDA + lane * 4);
    const float4 res = *reinterpret_cast<const float4*>(X_s + (HALO + r) * LDA + lane * 4);
    const float4 y = gn_row(z, g2w, g2b, eps);
    store4<T>(out + g * C + lane * 4, relu4(add4(y, res)));
  }
}

template <typename T>
int launch(const void* feat, const void* pre, const uint8_t* masks, const void* wb,
           const void* w2, const float* g1w, const float* g1b, const float* g2w,
           const float* g2b, void* out, int n, int nj, const int* shifts, float eps,
           cudaStream_t stream) {
  if (nj > MAXJ) return (int)cudaErrorInvalidValue;
  Shifts sh;
  for (int j = 0; j < MAXJ; ++j) sh.s[j] = 0;
  for (int j = 0; j < nj; ++j) {
    if (shifts[j] < -HALO || shifts[j] > HALO) return (int)cudaErrorInvalidValue;
    sh.s[j] = shifts[j];
  }
  const int smem = ((TM + 2 * HALO) * LDA + TM * LDA + C * C) * (int)sizeof(float);
  cudaError_t err = set_smem((const void*)lane_layer_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + TM - 1) / TM;
  if (blocks > 0) {
    lane_layer_kernel<T><<<blocks, NT, smem, stream>>>(
        (const T*)feat, (const T*)pre, masks, (const T*)wb, (const T*)w2, g1w, g1b, g2w,
        g2b, (T*)out, n, nj, sh, eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (feat, pre, wb, w2, out); masks [nj, n]
// bytes (0/1); GN vectors fp32 [128]; shifts: host array of nj ints.
extern "C" int lane_layer_fwd(const void* feat, const void* pre, const void* masks,
                              const void* wb, const void* w2, const void* g1w,
                              const void* g1b, const void* g2w, const void* g2b, void* out,
                              int n, int nj, const void* shifts, float eps, int dtype,
                              void* stream) {
  const int* sh = (const int*)shifts;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(feat, pre, (const uint8_t*)masks, wb, w2, (const float*)g1w,
                         (const float*)g1b, (const float*)g2w, (const float*)g2b, out, n,
                         nj, sh, eps, st);
  if (dtype == 1)
    return launch<bf16>(feat, pre, (const uint8_t*)masks, wb, w2, (const float*)g1w,
                        (const float*)g1b, (const float*)g2w, (const float*)g2b, out, n,
                        nj, sh, eps, st);
  return (int)cudaErrorInvalidValue;
}
