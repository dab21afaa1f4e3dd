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
// 56.7 GFLOP forward against ~110 MB of traffic, so it is compute-bound on
// the card's bf16 matrix rate (0.057 ms). What the design keeps out of
// device memory, against the TPU kernel: the TPU kernel DMAs a 128-lane
// mask plane and a ±32-row halo per grid step and accumulates dW into one
// [J, C, C] block that its sequential grid revisits. Here the masks stay
// compact ([J, N] bytes) and a block loads its rows' halo of feat (forward)
// or of g (the dx pass) once into shared memory for all J shifted products.
//   bf16 (the path that serves and trains): the forward is
//     band_conv_tc_kernel, lane_layer.cu's bf16 forward without `pre` and
//     without the tail: 192-row blocks of three warpgroups, a bf16 halo
//     tile by cp.async, A by `ldmatrix` at the shifted rows with the rows
//     whose band_j[u] is 0 zeroed, Wb_j read MN-major from two cp.async
//     buffers, a relation skipped by a warpgroup none of whose rows has it
//     (lane_band.cuh band_fwd_tc, shared with lane_layer_tc_kernel); the
//     accumulator starts at zero and is rounded once to bf16. The backward
//     runs band_t_tc_kernel (dx) and band_dw_tc_kernel (dW: (split, j)
//     blocks, 64 wgmma accumulators a thread over their tiles).
//   fp32 (the parity path: wgmma has no fp32 operands): 64-row tiles with
//     an fp32 ±32-row halo and the products on CUDA cores (lane_band.cuh
//     band_fwd, band_t, band_dw_kernel).
// dW's partials are summed in split order by reduce_partials: no float
// atomics, so a rerun is bitwise equal.
// Width: both directions also run on W = 64-wide rows (the half-width
// LaneGCN's unfused layers) by the padded route of common.cuh: feat and g
// rows read W wide into the same 128-column tiles, the [W x W] W_j
// zero-padded, K cut to W on wgmma, only W columns of out and dx stored,
// dW's partials [splits, J, W, W]. At W = 128 each kernel compiles to the
// code it was before the width existed.
#include "lane_band.cuh"

using namespace lgk;

namespace {

template <typename T, int W>
__global__ void __launch_bounds__(NT)
band_conv_kernel(const T* __restrict__ feat, const uint8_t* __restrict__ masks,
                 const T* __restrict__ w, T* __restrict__ out, int n, int nj, Shifts sh) {
  extern __shared__ float4 smem4[];
  float* X_s = reinterpret_cast<float*>(smem4);  // [TM + 2*HALO][LDA]
  float* W_s = X_s + HALO_TILE;                  // [C][C]
  const long tile0 = (long)blockIdx.x * TM;

  load_halo<T, W>(X_s, feat, tile0, n);
  float acc[4][8];
  band_fwd<T, W>(X_s, W_s, nullptr, masks, w, tile0, n, nj, sh, acc);
  store_rows<T, W>(out, acc, tile0, n);
}

// The bf16 forward on tensor cores: lane_layer_tc_kernel's block, halo
// tile, masks and weight buffers, its band loop (lane_band.cuh band_fwd_tc)
// from a zero accumulator, and the accumulator rounded once to bf16.
inline int band_conv_tc_smem() {
  return DX_HROWS * DX_HLD * (int)sizeof(bf16) + 2 * tc::tiles_bytes(C) + MAXJ * DX_ROWS;
}

template <int W>
__global__ void __launch_bounds__(DX_THREADS, 1)
band_conv_tc_kernel(const bf16* __restrict__ feat, const uint8_t* __restrict__ masks,
                    const bf16* __restrict__ w, bf16* __restrict__ out, int n, int nj,
                    Shifts sh) {
  extern __shared__ float4 smem4[];
  bf16* X_s = reinterpret_cast<bf16*>(smem4);                          // [DX_HROWS][DX_HLD] feat
  uint8_t* W_b = reinterpret_cast<uint8_t*>(X_s + DX_HROWS * DX_HLD);  // [2] weight core tiles
  uint8_t* M_s = W_b + 2 * tc::tiles_bytes(C);                         // [MAXJ][DX_ROWS] band_j[u]
  __shared__ uint8_t act_s[MAXJ][DX_WGS];  // relation j in warpgroup g's rows
  const long tile0 = (long)blockIdx.x * DX_ROWS;

  float acc[64];
  band_fwd_tc<W>(acc, X_s, W_b, M_s, act_s, feat, nullptr, masks, w, nullptr, tile0, n, nj,
                 sh);
  const long row0 = tile0 + 64 * (threadIdx.x >> 7);  // the warpgroup's first row
#pragma unroll
  for (int i = 0; i < W / 2; i += 2) {
    const long gr = row0 + tc::acc_row(i);
    if (gr < n)
      *reinterpret_cast<__nv_bfloat162*>(out + gr * W + tc::acc_col(i)) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
  }
}

template <typename T, int W>
int launch(const T* feat, const uint8_t* masks, const T* w, T* out, int n, int nj,
           const Shifts& sh, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    const int smem = band_conv_tc_smem();
    cudaError_t e = set_smem((const void*)band_conv_tc_kernel<W>, smem);
    if (e != cudaSuccess) return (int)e;
    const int blocks = (n + DX_ROWS - 1) / DX_ROWS;
    if (blocks > 0)
      band_conv_tc_kernel<W><<<blocks, DX_THREADS, smem, stream>>>(feat, masks, w, out, n, nj,
                                                                    sh);
  } else {
    const int smem = (HALO_TILE + C * C) * (int)sizeof(float);
    cudaError_t e = set_smem((const void*)band_conv_kernel<T, W>, smem);
    if (e != cudaSuccess) return (int)e;
    const int blocks = (n + TM - 1) / TM;
    if (blocks > 0)
      band_conv_kernel<T, W><<<blocks, NT, smem, stream>>>(feat, masks, w, out, n, nj, sh);
  }
  return (int)cudaGetLastError();
}

template <typename T, int W>
int launch_bwd(const T* feat, const uint8_t* masks, const T* w, const T* g, T* dx, float* part,
               float* dw, int n, int nj, const Shifts& sh, int splits, cudaStream_t stream) {
  const int err = launch_band_t<T, T, false, W>(g, nullptr, masks, w, dx, n, nj, sh, stream);
  if (err != 0) return err;
  return launch_band_dw<T, T, W>(feat, g, masks, part, dw, n, nj, sh, splits, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (feat, w, out); width: W = 128 or 64
// (feat, out [n, W]; w [nj, W, W] in (in, out) layout); masks [nj, n] bytes
// (0/1); shifts: host array of nj ints.
extern "C" int band_conv_fwd(const void* feat, const void* masks, const void* w, void* out,
                             int n, int width, int nj, const void* shifts, int dtype,
                             void* stream) {
  Shifts sh;
  const int bad = make_shifts(nj, (const int*)shifts, &sh);
  if (bad) return bad;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* m = (const uint8_t*)masks;
  return with_width_dtype(width, dtype, [&](auto Wc, auto Tc) {
    using T = typename decltype(Tc)::type;
    return launch<T, decltype(Wc)::value>((const T*)feat, m, (const T*)w, (T*)out, n, nj, sh,
                                          st);
  });
}

// Backward. g: the output cotangent in feat's dtype; dx [n, W] in feat's
// dtype; part: splits * nj * W*W fp32 workspace; dw: fp32 [nj, W, W].
extern "C" int band_conv_bwd(const void* feat, const void* masks, const void* w, const void* g,
                             void* dx, void* part, void* dw, int n, int width, int nj,
                             const void* shifts, int splits, int dtype, void* stream) {
  Shifts sh;
  const int bad = make_shifts(nj, (const int*)shifts, &sh);
  if (bad) return bad;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* m = (const uint8_t*)masks;
  float *p = (float*)part, *d = (float*)dw;
  return with_width_dtype(width, dtype, [&](auto Wc, auto Tc) {
    using T = typename decltype(Tc)::type;
    return launch_bwd<T, decltype(Wc)::value>((const T*)feat, m, (const T*)w, (const T*)g,
                                              (T*)dx, p, d, n, nj, sh, splits, st);
  });
}
