// The band part and the row tail of the fused LaneConv layer, shared by
// lane_layer.cu (the layer alone), lane_plan.cu (the layer with the window
// plan's aggregate inside it) and band_conv.cu (the band sum alone, the
// unfused layer's). Per 64-row tile of node rows u:
//
//   forward   acc  = pre + Σ_{j<J} band_j[u] · feat[u + s_j] @ Wb_j   (|s_j| ≤ 32, rows
//                                                                      outside [0,N) read 0;
//                                                                      no pre: 0)
//             out  = relu(GN2(relu(GN1(temp)) @ W2) + feat)            (layer_tail, from T_s)
//   backward  acc  = d_y[p] + Σ_j band_j[p − s_j] · d_temp[p − s_j] @ Wb_jᵀ   (no d_y: 0)
//             dWb_j = Σ_u (band_j[u] · feat[u + s_j])ᵀ rnd(d_temp[u])   (band_dw_kernel)
//
// d_temp is the fp32 d_temp of the layer kernels' row pass, or band_conv's
// cotangent in the activation dtype (the template parameter D).
//
// A tile block holds its 64 rows plus a ±32-row halo of feat (forward) or of
// d_temp (backward) in shared memory once, and reuses it for all J
// shifted products; the products run on CUDA cores in fp32 (mm_64x128).
#pragma once

#include "tail_bwd.cuh"

namespace lgk {

constexpr int HALO = 32;
constexpr int MAXJ = 16;

struct Shifts {
  int s[MAXJ];
};

inline int make_shifts(int nj, const int* shifts, Shifts* sh) {
  if (nj < 0 || nj > MAXJ) return (int)cudaErrorInvalidValue;
  for (int j = 0; j < MAXJ; ++j) sh->s[j] = 0;
  for (int j = 0; j < nj; ++j) {
    if (shifts[j] < -HALO || shifts[j] > HALO) return (int)cudaErrorInvalidValue;
    sh->s[j] = shifts[j];
  }
  return 0;
}

// Shared memory of a [TM + 2*HALO] halo tile.
constexpr int HALO_TILE = (TM + 2 * HALO) * LDA;

// S_s[r] = src rows tile0 − HALO + r (r < TM + 2*HALO), zero outside [0, n).
template <typename S>
__device__ __forceinline__ void load_halo(float* S_s, const S* src, long tile0, int n) {
  for (int idx = threadIdx.x; idx < (TM + 2 * HALO) * (C / 4); idx += NT) {
    const int r = idx / (C / 4), c4 = (idx % (C / 4)) * 4;
    const long g = tile0 - HALO + r;
    float4 v = zero4();
    if (g >= 0 && g < n) v = load4<S>(src + g * C + c4);
    *reinterpret_cast<float4*>(S_s + r * LDA + c4) = v;
  }
}

// dst rows tile0 + mm_row(i) (those below n) = acc, rounded to T.
template <typename T>
__device__ __forceinline__ void store_rows(T* dst, const float acc[4][8], long tile0, int n) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long g = tile0 + mm_row(i);
    if (g < n) {
      store4<T>(dst + g * C + mm_col(0), make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      store4<T>(dst + g * C + mm_col(4), make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
    }
  }
}

// acc = pre + Σ_j band_j[u] · X_s[u + s_j] @ Wb_j over the tile's rows (X_s:
// the feat halo tile, loaded; W_s: [C][C] scratch; pre may be null).
template <typename T>
__device__ __forceinline__ void band_fwd(const float* X_s, float* W_s, const T* pre,
                                         const uint8_t* masks, const T* wb, long tile0, int n,
                                         int nj, const Shifts& sh, float acc[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long g = tile0 + mm_row(i);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[i][j] = (pre && g < n) ? to_f<T>(pre[g * C + mm_col(j)]) : 0.f;
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
}

// The layer tail from the tile's fp32 temp in T_s (complete, and visible to
// every thread): temp_out ← T_s when given, then
// out = relu(GN2(relu(GN1(temp)) @ W2) + feat) with h rounded to T before the
// product. X_s: the feat halo tile (the residual); W_s: [C][C] scratch.
template <typename T>
__device__ __forceinline__ void layer_tail(const float* X_s, float* T_s, float* W_s, const T* w2,
                                           const float* g1w, const float* g1b, const float* g2w,
                                           const float* g2b, T* out, float* temp_out, long tile0,
                                           int n, float eps) {
  if (temp_out) {
    for (int idx = threadIdx.x; idx < TM * (C / 4); idx += NT) {
      const int r = idx / (C / 4), c4 = (idx % (C / 4)) * 4;
      const long g = tile0 + r;
      if (g < n)
        *reinterpret_cast<float4*>(temp_out + g * C + c4) =
            *reinterpret_cast<const float4*>(T_s + r * LDA + c4);
    }
    __syncthreads();
  }
  gn_relu_rows<T>(T_s, TM, g1w, g1b, eps);  // h = relu(GN1(temp)), rounded to T
  load_weight<T>(W_s, w2);
  __syncthreads();
  const float ones[4] = {1.f, 1.f, 1.f, 1.f};
  float acc[4][8];
  zero_acc(acc);
  mm_64x128(T_s, 0, ones, W_s, acc);  // z = h @ W2
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

// acc = d_y[p] + Σ_j band_j[p − s_j] · d_temp[p − s_j] @ Wb_jᵀ over the tile's
// rows p (D_s: the d_temp halo tile in fp32, loaded; W_s: [C][C] scratch; dy
// may be null).
template <typename T>
__device__ __forceinline__ void band_t(const float* D_s, float* W_s, const float* dy,
                                       const uint8_t* masks, const T* wb, long tile0, int n,
                                       int nj, const Shifts& sh, float acc[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long g = tile0 + mm_row(i);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = (dy && g < n) ? dy[g * C + mm_col(j)] : 0.f;
  }
  for (int j = 0; j < nj; ++j) {
    __syncthreads();  // the previous product is done with W_s (and D_s is loaded)
    load_weight_t<T>(W_s, wb + (long)j * C * C);
    float m[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long src = tile0 + mm_row(i) - sh.s[j];
      m[i] = (src >= 0 && src < n && masks[(long)j * n + src]) ? 1.f : 0.f;
    }
    __syncthreads();
    mm_64x128(D_s, HALO - sh.s[j], m, W_s, acc);
  }
}

// Band pass: dx[p] = d_y[p] + Σ_j band_j[p − s_j] · d_temp[p − s_j] @ Wb_jᵀ
// (rows p − s_j outside [0, n) give 0), stored in T. A block owns 64 rows p
// and loads the d_temp rows p − HALO .. p + TM + HALO − 1 once for all J
// products.
template <typename T, typename D>
__global__ void __launch_bounds__(NT)
band_t_kernel(const D* __restrict__ dtemp, const float* __restrict__ dy,
              const uint8_t* __restrict__ masks, const T* __restrict__ wb, T* __restrict__ dx,
              int n, int nj, Shifts sh) {
  extern __shared__ float4 smem4[];
  float* D_s = reinterpret_cast<float*>(smem4);  // [TM + 2*HALO][LDA]
  float* W_s = D_s + HALO_TILE;                  // [C][C] Wb_jᵀ
  const long tile0 = (long)blockIdx.x * TM;

  load_halo<D>(D_s, dtemp, tile0, n);
  float acc[4][8];
  band_t<T>(D_s, W_s, dy, masks, wb, tile0, n, nj, sh, acc);
  store_rows<T>(dx, acc, tile0, n);
}

template <typename T, typename D>
int launch_band_t(const D* dtemp, const float* dy, const uint8_t* masks, const T* wb, T* dx,
                  int n, int nj, const Shifts& sh, cudaStream_t stream) {
  const int ntiles = (n + TM - 1) / TM;
  const int smem = (HALO_TILE + C * C) * (int)sizeof(float);
  cudaError_t e = set_smem((const void*)band_t_kernel<T, D>, smem);
  if (e != cudaSuccess) return (int)e;
  if (ntiles > 0)
    band_t_kernel<T, D><<<ntiles, NT, smem, stream>>>(dtemp, dy, masks, wb, dx, n, nj, sh);
  return (int)cudaGetLastError();
}

// dWb pass: block (p, j) sums (band_j[u] · feat[u + s_j])ᵀ rnd(d_temp[u]) over
// the tiles p, p + splits, ... and writes its partial part[p][j] [C][C].
template <typename T, typename D>
__global__ void __launch_bounds__(NT)
band_dw_kernel(const T* __restrict__ feat, const D* __restrict__ dtemp,
               const uint8_t* __restrict__ masks, float* __restrict__ part, int n, int nj,
               Shifts sh) {
  extern __shared__ float4 smem4[];
  float* A_s = reinterpret_cast<float*>(smem4);  // [TM][LDA] band_j[u] · feat[u + s_j]
  float* B_s = A_s + TM * LDA;                   // [TM][LDA] rnd(d_temp[u])
  const int j = blockIdx.y, s = sh.s[j];
  const int ntiles = (n + TM - 1) / TM;
  float accW[8][8];
  zero_tn(accW);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    __syncthreads();  // the previous tile's product is done
    for (int idx = threadIdx.x; idx < TM * (C / 4); idx += NT) {
      const int r = idx / (C / 4), c4 = (idx % (C / 4)) * 4;
      const long u = (long)tile * TM + r;
      float4 a = zero4(), b = zero4();
      if (u < n) {
        b = rnd4<T>(load4<D>(dtemp + u * C + c4));
        const long v = u + s;
        if (v >= 0 && v < n && masks[(long)j * n + u]) a = load4<T>(feat + v * C + c4);
      }
      *reinterpret_cast<float4*>(A_s + r * LDA + c4) = a;
      *reinterpret_cast<float4*>(B_s + r * LDA + c4) = b;
    }
    __syncthreads();
    mm_tn(A_s, B_s, TM, accW);
  }
  store_tn(part + ((long)blockIdx.x * nj + j) * C * C, accW, false);
}

// The dWb pass on `splits` x nj blocks, then its partials summed in split
// order into dwb [nj, C, C].
template <typename T, typename D>
int launch_band_dw(const T* feat, const D* dtemp, const uint8_t* masks, float* part,
                   float* dwb, int n, int nj, const Shifts& sh, int splits, cudaStream_t stream) {
  const int smem = 2 * TM * LDA * (int)sizeof(float);
  cudaError_t e = set_smem((const void*)band_dw_kernel<T, D>, smem);
  if (e != cudaSuccess) return (int)e;
  if (nj > 0 && splits > 0) {
    band_dw_kernel<T, D><<<dim3(splits, nj), NT, smem, stream>>>(feat, dtemp, masks, part, n,
                                                                  nj, sh);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)reduce_partials(part, dwb, splits, (long)nj * C * C, stream);
}

}  // namespace lgk
