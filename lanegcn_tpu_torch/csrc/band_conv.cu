// Banded LaneConv aggregation, forward and backward: the band sum of the
// LaneConv layer's unfused branch, with no layer tail.
//
// Replaces lanegcn_tpu/ops/pallas_band_conv.py `_fwd_kernel` / `_fwd_impl`
// and `_bwd_kernel` / `_bwd_impl` (the Pallas kernels behind `band_conv`).
// Per node row u:
//
//   forward   out[u] = Σ_{j<J} band_j[u] · feat[u + s_j] @ W_j   (|s_j| ≤ 32, rows
//                                                                outside [0,N) read 0)
//   backward  dx[p]  = Σ_j band_j[p − s_j] · g[p − s_j] @ W_jᵀ
//             dW_j   = Σ_u (band_j[u] · feat[u + s_j])ᵀ g[u]    (fp32)
//
// with g the output cotangent in feat's dtype. What bounds it: one
// [128 x 128] product per row each mask selects (forward), two (backward),
// ~8.3 masked band rows per row at the 256-scenario pack (N = 208,896):
// 56.7 GFLOP forward against ~110 MB of traffic, so it is compute-bound on the
// card's matrix rate. This first version runs the products on CUDA cores in
// fp32, as lane_layer does, far below the bf16 tensor-core bound; wgmma is
// later work. What the design keeps out of device memory, against the TPU
// kernel: the TPU kernel DMAs a 128-lane mask plane and a ±32-row halo per
// grid step and accumulates dW into one [J, C, C] block that its sequential
// grid revisits. Here the masks stay compact ([J, N] bytes); a block loads
// its 64-row tile with its ±32-row halo of feat (forward) or of g (the dx
// pass) once into shared memory and reuses it for all J shifted products
// (lane_band.cuh: load_halo, band_fwd, band_t); dW runs as (split, j)
// blocks that each keep an 8 x 8 register block per thread over their
// tiles and write one partial, summed in split order by reduce_partials
// (band_dw_kernel): no float atomics, so a rerun is bitwise equal.
#include "lane_band.cuh"

using namespace lgk;

namespace {

template <typename T>
__global__ void __launch_bounds__(NT)
band_conv_kernel(const T* __restrict__ feat, const uint8_t* __restrict__ masks,
                 const T* __restrict__ w, T* __restrict__ out, int n, int nj, Shifts sh) {
  extern __shared__ float4 smem4[];
  float* X_s = reinterpret_cast<float*>(smem4);  // [TM + 2*HALO][LDA]
  float* W_s = X_s + HALO_TILE;                  // [C][C]
  const long tile0 = (long)blockIdx.x * TM;

  load_halo<T>(X_s, feat, tile0, n);
  float acc[4][8];
  band_fwd<T>(X_s, W_s, nullptr, masks, w, tile0, n, nj, sh, acc);
  store_rows<T>(out, acc, tile0, n);
}

template <typename T>
int launch(const T* feat, const uint8_t* masks, const T* w, T* out, int n, int nj,
           const Shifts& sh, cudaStream_t stream) {
  const int smem = (HALO_TILE + C * C) * (int)sizeof(float);
  cudaError_t e = set_smem((const void*)band_conv_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n + TM - 1) / TM;
  if (blocks > 0)
    band_conv_kernel<T><<<blocks, NT, smem, stream>>>(feat, masks, w, out, n, nj, sh);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const T* feat, const uint8_t* masks, const T* w, const T* g, T* dx, float* part,
               float* dw, int n, int nj, const Shifts& sh, int splits, cudaStream_t stream) {
  const int err = launch_band_t<T, T>(g, nullptr, masks, w, dx, n, nj, sh, stream);
  if (err != 0) return err;
  return launch_band_dw<T, T>(feat, g, masks, part, dw, n, nj, sh, splits, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (feat, w, out); masks [nj, n] bytes
// (0/1); w [nj, 128, 128] in (in, out) layout; shifts: host array of nj ints.
extern "C" int band_conv_fwd(const void* feat, const void* masks, const void* w, void* out,
                             int n, int nj, const void* shifts, int dtype, void* stream) {
  Shifts sh;
  const int bad = make_shifts(nj, (const int*)shifts, &sh);
  if (bad) return bad;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* m = (const uint8_t*)masks;
  if (dtype == 0)
    return launch<float>((const float*)feat, m, (const float*)w, (float*)out, n, nj, sh, st);
  if (dtype == 1)
    return launch<bf16>((const bf16*)feat, m, (const bf16*)w, (bf16*)out, n, nj, sh, st);
  return (int)cudaErrorInvalidValue;
}

// Backward. g: the output cotangent in feat's dtype; dx [n, 128] in feat's
// dtype; part: splits * nj * C*C fp32 workspace; dw: fp32 [nj, C, C].
extern "C" int band_conv_bwd(const void* feat, const void* masks, const void* w, const void* g,
                             void* dx, void* part, void* dw, int n, int nj, const void* shifts,
                             int splits, int dtype, void* stream) {
  Shifts sh;
  const int bad = make_shifts(nj, (const int*)shifts, &sh);
  if (bad) return bad;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* m = (const uint8_t*)masks;
  float *p = (float*)part, *d = (float*)dw;
  if (dtype == 0)
    return launch_bwd<float>((const float*)feat, m, (const float*)w, (const float*)g, (float*)dx,
                             p, d, n, nj, sh, splits, st);
  if (dtype == 1)
    return launch_bwd<bf16>((const bf16*)feat, m, (const bf16*)w, (const bf16*)g, (bf16*)dx, p,
                            d, n, nj, sh, splits, st);
  return (int)cudaErrorInvalidValue;
}
