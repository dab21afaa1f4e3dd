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
// stay compact ([J, N] bytes) instead of padded planes. For training the
// forward also writes temp (fp32, bitwise its own value) when the caller
// passes `temp_out`; the eval path passes none.
//
// Backward (`lane_layer_bwd`): replaces pallas_lane_layer.py `_bwd_kernel` /
// `_bwd_impl`. It consumes the saved temp:
//
//   row pass   (tail_bwd.cuh)  d_y, d_temp = GN1ᵀ(rnd(GN2ᵀ(d_y)) @ W2ᵀ ⊙ relu'),
//                              dW2, dGN; writes dpre = d_temp, and d_temp, d_y in fp32
//   band pass  dx[p] = d_y[p] + Σ_j band_j[p − s_j] · d_temp[p − s_j] @ Wb_jᵀ
//   dWb pass   dWb_j = Σ_u (band_j[u] · feat[u + s_j])ᵀ rnd(d_temp[u])
//
// What bounds it: two band products on the masked band rows (2 x 56.7 GFLOP
// at the 256-scenario pack) and three [N x 128] x [128 x 128] products
// against ~323 MB: operation-bound at the bf16 matrix rate, and far from it
// on the CUDA cores this version uses. The halo: the band transpose reads
// d_temp at ±32 rows, which the TPU kernel recomputed per 1024-row tile
// (+6 %); a 64-row tile here would recompute 2x the tail, so the row pass
// writes d_temp once (fp32, 107 MB) and the band pass reads it with its halo
// from L2/HBM. Parameter gradients: the row pass keeps dW2/dGN per block
// (one block per SM); dWb runs as (split, j) blocks, each summing its
// slice of tiles into an 8 x 8 register block per thread, so the partial
// workspace is splits x 12 x 64 KB rather than one [12, 128, 128] per tile;
// a second pass sums the partials in split order (deterministic).
#include "tail_bwd.cuh"

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
                  const float* __restrict__ g2b, T* __restrict__ out,
                  float* __restrict__ temp_out, int n, int nj, Shifts sh, float eps) {
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
           const float* g2b, void* out, float* temp_out, int n, int nj, const Shifts& sh,
           float eps, cudaStream_t stream) {
  const int smem = ((TM + 2 * HALO) * LDA + TM * LDA + C * C) * (int)sizeof(float);
  cudaError_t err = set_smem((const void*)lane_layer_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + TM - 1) / TM;
  if (blocks > 0) {
    lane_layer_kernel<T><<<blocks, NT, smem, stream>>>(
        (const T*)feat, (const T*)pre, masks, (const T*)wb, (const T*)w2, g1w, g1b, g2w,
        g2b, (T*)out, temp_out, n, nj, sh, eps);
  }
  return (int)cudaGetLastError();
}

// Band pass: dx[p] = d_y[p] + Σ_j band_j[p − s_j] · d_temp[p − s_j] @ Wb_jᵀ
// (rows p − s_j outside [0, n) give 0). A block owns 64 rows p and loads the
// fp32 d_temp rows p − HALO .. p + TM + HALO − 1 once for all J products.
template <typename T>
__global__ void __launch_bounds__(NT)
band_t_kernel(const float* __restrict__ dtemp, const float* __restrict__ dy,
              const uint8_t* __restrict__ masks, const T* __restrict__ wb, T* __restrict__ dx,
              int n, int nj, Shifts sh) {
  extern __shared__ float4 smem4[];
  float* D_s = reinterpret_cast<float*>(smem4);  // [TM + 2*HALO][LDA]
  float* W_s = D_s + (TM + 2 * HALO) * LDA;      // [C][C] Wb_jᵀ
  const long tile0 = (long)blockIdx.x * TM;

  for (int idx = threadIdx.x; idx < (TM + 2 * HALO) * (C / 4); idx += NT) {
    const int r = idx / (C / 4), c4 = (idx % (C / 4)) * 4;
    const long g = tile0 - HALO + r;
    *reinterpret_cast<float4*>(D_s + r * LDA + c4) =
        (g >= 0 && g < n) ? *reinterpret_cast<const float4*>(dtemp + g * C + c4) : zero4();
  }
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long g = tile0 + mm_row(i);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = (g < n) ? dy[g * C + mm_col(j)] : 0.f;
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
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long g = tile0 + mm_row(i);
    if (g < n) {
      store4<T>(dx + g * C + mm_col(0), make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      store4<T>(dx + g * C + mm_col(4), make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
    }
  }
}

// dWb pass: block (p, j) sums (band_j[u] · feat[u + s_j])ᵀ rnd(d_temp[u]) over
// the tiles p, p + splits, ... and writes its partial part[p][j] [C][C].
template <typename T>
__global__ void __launch_bounds__(NT)
band_dw_kernel(const T* __restrict__ feat, const float* __restrict__ dtemp,
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
        b = rnd4<T>(*reinterpret_cast<const float4*>(dtemp + u * C + c4));
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

template <typename T>
int launch_bwd(const T* feat, const float* temp, const uint8_t* masks, const T* wb,
               const T* w2, const float* g1w, const float* g1b, const float* g2w,
               const float* g2b, const T* g, T* dx, T* dpre, float* dtemp, float* dy,
               float* part_tail, float* part_band, float* grads_tail, float* dwb, int n, int nj,
               const Shifts& sh, int tail_blocks, int splits, float eps, cudaStream_t stream) {
  int err = launch_tail_bwd<T, float>(temp, feat, g, w2, g1w, g1b, g2w, g2b, dpre, nullptr,
                                      dtemp, dy, part_tail, grads_tail, n, tail_blocks, eps,
                                      stream);
  if (err != 0) return err;
  const int ntiles = (n + TM - 1) / TM;
  const int smem_t = ((TM + 2 * HALO) * LDA + C * C) * (int)sizeof(float);
  cudaError_t e = set_smem((const void*)band_t_kernel<T>, smem_t);
  if (e != cudaSuccess) return (int)e;
  const int smem_w = 2 * TM * LDA * (int)sizeof(float);
  e = set_smem((const void*)band_dw_kernel<T>, smem_w);
  if (e != cudaSuccess) return (int)e;
  if (ntiles > 0) {
    band_t_kernel<T><<<ntiles, NT, smem_t, stream>>>(dtemp, dy, masks, wb, dx, n, nj, sh);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (nj > 0 && splits > 0) {
    band_dw_kernel<T><<<dim3(splits, nj), NT, smem_w, stream>>>(feat, dtemp, masks, part_band,
                                                                 n, nj, sh);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)reduce_partials(part_band, dwb, splits, (long)nj * C * C, stream);
}

int make_shifts(int nj, const int* shifts, Shifts* sh) {
  if (nj < 0 || nj > MAXJ) return (int)cudaErrorInvalidValue;
  for (int j = 0; j < MAXJ; ++j) sh->s[j] = 0;
  for (int j = 0; j < nj; ++j) {
    if (shifts[j] < -HALO || shifts[j] > HALO) return (int)cudaErrorInvalidValue;
    sh->s[j] = shifts[j];
  }
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (feat, pre, wb, w2, out); masks [nj, n]
// bytes (0/1); GN vectors fp32 [128]; shifts: host array of nj ints;
// temp_out: fp32 [n, 128] that receives temp, or null.
extern "C" int lane_layer_fwd(const void* feat, const void* pre, const void* masks,
                              const void* wb, const void* w2, const void* g1w,
                              const void* g1b, const void* g2w, const void* g2b, void* out,
                              void* temp_out, int n, int nj, const void* shifts, float eps,
                              int dtype, void* stream) {
  Shifts sh;
  const int bad = make_shifts(nj, (const int*)shifts, &sh);
  if (bad) return bad;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(feat, pre, (const uint8_t*)masks, wb, w2, (const float*)g1w,
                         (const float*)g1b, (const float*)g2w, (const float*)g2b, out,
                         (float*)temp_out, n, nj, sh, eps, st);
  if (dtype == 1)
    return launch<bf16>(feat, pre, (const uint8_t*)masks, wb, w2, (const float*)g1w,
                        (const float*)g1b, (const float*)g2w, (const float*)g2b, out,
                        (float*)temp_out, n, nj, sh, eps, st);
  return (int)cudaErrorInvalidValue;
}

// Backward. temp: the forward's fp32 temp; g: the output cotangent in feat's
// dtype; dx, dpre [n, 128] in feat's dtype; dtemp, dy: fp32 [n, 128]
// workspace; part_tail: tail_blocks * (C*C + 4*C) and part_band:
// splits * nj * C*C fp32 workspace; grads_tail: fp32 [C*C + 4*C] = dW2,
// dg1w, dg1b, dg2w, dg2b; dwb: fp32 [nj, C, C].
extern "C" int lane_layer_bwd(const void* feat, const void* temp, const void* masks,
                              const void* wb, const void* w2, const void* g1w,
                              const void* g1b, const void* g2w, const void* g2b, const void* g,
                              void* dx, void* dpre, void* dtemp, void* dy, void* part_tail,
                              void* part_band, void* grads_tail, void* dwb, int n, int nj,
                              const void* shifts, int tail_blocks, int splits, float eps,
                              int dtype, void* stream) {
  Shifts sh;
  const int bad = make_shifts(nj, (const int*)shifts, &sh);
  if (bad) return bad;
  cudaStream_t st = (cudaStream_t)stream;
  const float *t = (const float*)temp, *a = (const float*)g1w, *b = (const float*)g1b,
              *c = (const float*)g2w, *d = (const float*)g2b;
  const uint8_t* m = (const uint8_t*)masks;
  float *dt = (float*)dtemp, *y = (float*)dy, *pt = (float*)part_tail, *pb = (float*)part_band,
        *gt = (float*)grads_tail, *gb = (float*)dwb;
  if (dtype == 0)
    return launch_bwd<float>((const float*)feat, t, m, (const float*)wb, (const float*)w2, a, b,
                             c, d, (const float*)g, (float*)dx, (float*)dpre, dt, y, pt, pb, gt,
                             gb, n, nj, sh, tail_blocks, splits, eps, st);
  if (dtype == 1)
    return launch_bwd<bf16>((const bf16*)feat, t, m, (const bf16*)wb, (const bf16*)w2, a, b, c,
                            d, (const bf16*)g, (bf16*)dx, (bf16*)dpre, dt, y, pt, pb, gt, gb, n,
                            nj, sh, tail_blocks, splits, eps, st);
  return (int)cudaErrorInvalidValue;
}
