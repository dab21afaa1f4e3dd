// Shared device helpers for the port's kernels (C = 128 channels).
//
// Every kernel also runs at a narrower width W (64: the half-width
// models, n_map = n_actor = 64, and Att's row tail and edge chain on the
// actor side of a model with n_actor = 64). The kernels keep every
// tile, weight and product at 128 columns, zero-padded: rows are read W
// wide (columns ≥ W load as zero), W x W weights sit in the top-left of a
// zeroed 128 x 128, GroupNorm statistics are taken over the first W
// columns only and the GN affines read as zero past W, so every padded
// column stays exactly zero through the chain and adds exactly nothing to
// a product; only W columns are stored. The helpers below take W as a
// template parameter with default C, and at W = C compile to the code
// they were before W existed. Three forwards also run 256-wide rows, on a
// tiling of their own (wide.cuh).
//
// The kernels keep activations in shared memory as fp32 rows, run their
// [rows x 128] x [128 x 128] products on CUDA cores with fp32 accumulation
// (register-blocked: each of 256 threads owns a 4 x 8, 8 x 8 or 2 x 4
// output block), and take GroupNorm statistics with one warp per row. Operands
// that the TPU kernels round to the activation dtype before a product are
// rounded at the same points here (`rnd<T>`), so fp32 runs round nowhere
// and bf16 runs round exactly where the plain PyTorch versions do.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace lgk {

constexpr int C = 128;       // channel width the kernels are written for
constexpr int LDA = C + 4;   // padded fp32 row stride of activation tiles
constexpr int NT = 256;      // threads per block
constexpr int TM = 64;       // rows per product tile

typedef __nv_bfloat16 bf16;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

// Round an fp32 value to T's precision and back (identity for float).
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f<T>(from_f<T>(x));
}

// Four consecutive elements (16-byte aligned for float, 8-byte for bf16).
template <typename T> __device__ __forceinline__ float4 load4(const T* p);
template <> __device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <> __device__ __forceinline__ float4 load4<bf16>(const bf16* p) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  float2 a = __bfloat1622float2(q[0]);
  float2 b = __bfloat1622float2(q[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T> __device__ __forceinline__ void store4(T* p, float4 v);
template <> __device__ __forceinline__ void store4<float>(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
template <> __device__ __forceinline__ void store4<bf16>(bf16* p, float4 v) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v.x, v.y);
  q[1] = __floats2bfloat162_rn(v.z, v.w);
}

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// Whether the lane's 4 columns (lane*4 .. +3 of a warp-per-row layout) lie
// in a W-wide row.
template <int W>
__device__ __forceinline__ bool lane_in() {
  if constexpr (W == C) return true;
  else return (threadIdx.x & 31) * 4 < W;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// W_s[k*C + n] = W[k*C + n] for a [C x C] weight in (in, out) layout; a
// [W x W] one zero-padded to [C x C].
template <typename T, int WD = C>
__device__ __forceinline__ void load_weight(float* W_s, const T* W) {
  for (int i = threadIdx.x * 4; i < C * C; i += NT * 4) {
    if constexpr (WD == C) {
      *reinterpret_cast<float4*>(W_s + i) = load4<T>(W + i);
    } else {
      const int k = i / C, n = i % C;
      *reinterpret_cast<float4*>(W_s + i) = k < WD && n < WD ? load4<T>(W + k * WD + n) : zero4();
    }
  }
}

// Output column of acc[.][j] in the 64 x 128 product layout.
__device__ __forceinline__ int mm_col(int j) {
  const int tc = threadIdx.x & 15;
  return (j < 4) ? (tc * 4 + j) : (64 + tc * 4 + (j - 4));
}
// Output row of acc[i][.] in the 64 x 128 product layout.
__device__ __forceinline__ int mm_row(int i) { return (threadIdx.x >> 4) * 4 + i; }

// acc[i][j] += Σ_k scale[i] * A_s[(row_off + mm_row(i)) * LDA + k] * W_s[k*C + mm_col(j)]
// over a TM x C tile. scale is 0 or 1 (band masks) or 1.
__device__ __forceinline__ void mm_64x128(const float* A_s, int row_off, const float scale[4],
                                          const float* W_s, float acc[4][8]) {
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const float* a0 = A_s + (row_off + tr * 4) * LDA;
#pragma unroll 4
  for (int k = 0; k < C; ++k) {
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = a0[i * LDA + k] * scale[i];
    const float4 w0 = *reinterpret_cast<const float4*>(W_s + k * C + tc * 4);
    const float4 w1 = *reinterpret_cast<const float4*>(W_s + k * C + 64 + tc * 4);
    const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ void zero_acc(float acc[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
}

// T_s[mm_row(i)][mm_col(j)] = acc[i][j]
__device__ __forceinline__ void store_acc(float* T_s, const float acc[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* row = T_s + mm_row(i) * LDA;
    *reinterpret_cast<float4*>(row + mm_col(0)) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + mm_col(4)) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// Single-group GroupNorm of one W-wide row held as 4 values per lane of a
// warp (columns lane*4 .. lane*4+3): biased variance, eps inside rsqrt.
// Lanes past W take no part in the statistics and return zeros (w and b
// are not read there).
template <int W = C>
__device__ __forceinline__ float4 gn_row(float4 v, const float* w, const float* b, float eps) {
  const int c = (threadIdx.x & 31) * 4;
  if (!lane_in<W>()) v = zero4();
  const float mu = warp_sum(v.x + v.y + v.z + v.w) * (1.f / W);
  float d0 = v.x - mu, d1 = v.y - mu, d2 = v.z - mu, d3 = v.w - mu;
  if (!lane_in<W>()) d0 = d1 = d2 = d3 = 0.f;
  const float var = warp_sum(d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3) * (1.f / W);
  const float inv = rsqrtf(var + eps);
  if (!lane_in<W>()) return zero4();
  return make_float4(d0 * inv * w[c] + b[c], d1 * inv * w[c + 1] + b[c + 1],
                     d2 * inv * w[c + 2] + b[c + 2], d3 * inv * w[c + 3] + b[c + 3]);
}

__device__ __forceinline__ float4 relu4(float4 v) {
  return make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f), fmaxf(v.w, 0.f));
}

template <typename T> __device__ __forceinline__ float4 rnd4(float4 v) {
  return make_float4(rnd<T>(v.x), rnd<T>(v.y), rnd<T>(v.z), rnd<T>(v.w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Rows [0, rows) of T_s: relu(GN(row)) rounded to T, in place (warp per
// row; W-wide rows, zeros past W).
template <typename T, int W = C>
__device__ __forceinline__ void gn_relu_rows(float* T_s, int rows, const float* w,
                                             const float* b, float eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += NT / 32) {
    float* p = T_s + r * LDA + lane * 4;
    const float4 v = gn_row<W>(*reinterpret_cast<float4*>(p), w, b, eps);
    *reinterpret_cast<float4*>(p) = rnd4<T>(relu4(v));
  }
}

inline cudaError_t set_smem(const void* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// ---------------------------------------------------------------------------
// Backward helpers.
//
// Parameter gradients are sums over every row of a launch. Blocks run in no
// order, so no block adds into another's sum: each block keeps its own
// partial (in registers, or in a slice of device memory only it touches),
// writes it to a workspace, and `reduce_partials` sums the partials in
// block order. No float atomic touches a gradient, and a rerun is bitwise
// equal.

// W_s[k*C + n] = W[n*C + k]: the transpose of a [C x C] weight, so that
// mm_64x128 with W_s computes A @ Wᵀ (a [WD x WD] one zero-padded). Reads 4
// consecutive k of one row n per thread; neighbouring threads write
// neighbouring n (no bank conflicts).
template <typename T, int WD = C>
__device__ __forceinline__ void load_weight_t(float* W_s, const T* W) {
  for (int i = threadIdx.x; i < C * C / 4; i += NT) {
    const int n = i % C, k4 = (i / C) * 4;
    float4 v;
    if constexpr (WD == C) v = load4<T>(W + n * C + k4);
    else v = n < WD && k4 < WD ? load4<T>(W + n * WD + k4) : zero4();
    W_s[(k4 + 0) * C + n] = v.x;
    W_s[(k4 + 1) * C + n] = v.y;
    W_s[(k4 + 2) * C + n] = v.z;
    W_s[(k4 + 3) * C + n] = v.w;
  }
}

// Output row of acc[i][.] in the 128 x 128 Aᵀ·B layout (8 rows per thread).
__device__ __forceinline__ int tn_row(int i) {
  const int tr = threadIdx.x >> 4;
  return (i < 4) ? (tr * 4 + i) : (64 + tr * 4 + (i - 4));
}

__device__ __forceinline__ void zero_tn(float acc[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
}

// acc[i][j] += Σ_{r < rows} A_s[r*LDA + tn_row(i)] * B_s[r*LDA + mm_col(j)]:
// the [C x C] product Aᵀ B over `rows` rows of two row tiles, in row order.
__device__ __forceinline__ void mm_tn(const float* A_s, const float* B_s, int rows,
                                      float acc[8][8]) {
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
#pragma unroll 2
  for (int r = 0; r < rows; ++r) {
    const float4 a0 = *reinterpret_cast<const float4*>(A_s + r * LDA + tr * 4);
    const float4 a1 = *reinterpret_cast<const float4*>(A_s + r * LDA + 64 + tr * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(B_s + r * LDA + tc * 4);
    const float4 b1 = *reinterpret_cast<const float4*>(B_s + r * LDA + 64 + tc * 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// P[tn_row(i)*W + mm_col(j)] = acc[i][j] (add = false) or += (add = true):
// a thread's 64 elements of a [C x C] gradient in device memory, or those
// inside a [W x W] one.
template <int W = C>
__device__ __forceinline__ void store_tn(float* P, const float acc[8][8], bool add) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (W < C && tn_row(i) >= W) continue;
    float* row = P + tn_row(i) * W;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (W < C && mm_col(4 * h) >= W) continue;
      float4* p = reinterpret_cast<float4*>(row + mm_col(4 * h));
      float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                             acc[i][4 * h + 3]);
      if (add) v = add4(*p, v);
      *p = v;
    }
  }
}

// Mean and 1/sqrt(var + eps) of one W-wide row held as 4 values per lane
// (the statistics of gn_row).
template <int W = C>
__device__ __forceinline__ float2 gn_stats(float4 v, float eps) {
  if (!lane_in<W>()) v = zero4();
  const float mu = warp_sum(v.x + v.y + v.z + v.w) * (1.f / W);
  float d0 = v.x - mu, d1 = v.y - mu, d2 = v.z - mu, d3 = v.w - mu;
  if (!lane_in<W>()) d0 = d1 = d2 = d3 = 0.f;
  const float var = warp_sum(d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3) * (1.f / W);
  return make_float2(mu, rsqrtf(var + eps));
}

__device__ __forceinline__ float4 gn_nrm(float4 v, float2 st) {
  return make_float4((v.x - st.x) * st.y, (v.y - st.x) * st.y, (v.z - st.x) * st.y,
                     (v.w - st.x) * st.y);
}

// nrm ⊙ w + b for the lane's 4 columns (zeros past W).
template <int W = C>
__device__ __forceinline__ float4 gn_affine(float4 nrm, const float* w, const float* b) {
  const int c = (threadIdx.x & 31) * 4;
  if (!lane_in<W>()) return zero4();
  return make_float4(nrm.x * w[c] + b[c], nrm.y * w[c + 1] + b[c + 1],
                     nrm.z * w[c + 2] + b[c + 2], nrm.w * w[c + 3] + b[c + 3]);
}

// GroupNorm backward of one W-wide row (torch semantics, single group):
//   d_x = inv · (d_nrm − mean(d_nrm) − nrm · mean(d_nrm · nrm)),  d_nrm = d_y ⊙ w;
// zeros past W.
template <int W = C>
__device__ __forceinline__ float4 gn_bwd_row(float4 dy, float4 nrm, float inv, const float* w) {
  const int c = (threadIdx.x & 31) * 4;
  const float4 dn = lane_in<W>() ? make_float4(dy.x * w[c], dy.y * w[c + 1], dy.z * w[c + 2],
                                               dy.w * w[c + 3])
                                 : zero4();
  const float c1 = warp_sum(dn.x + dn.y + dn.z + dn.w) * (1.f / W);
  const float c2 =
      warp_sum(dn.x * nrm.x + dn.y * nrm.y + dn.z * nrm.z + dn.w * nrm.w) * (1.f / W);
  if (!lane_in<W>()) return zero4();
  return make_float4(inv * (dn.x - c1 - nrm.x * c2), inv * (dn.y - c1 - nrm.y * c2),
                     inv * (dn.z - c1 - nrm.z * c2), inv * (dn.w - c1 - nrm.w * c2));
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

// v where m > 0, else 0 (the ReLU's backward mask), per element.
__device__ __forceinline__ float4 pos_mask4(float4 v, float4 m) {
  return make_float4(m.x > 0.f ? v.x : 0.f, m.y > 0.f ? v.y : 0.f, m.z > 0.f ? v.z : 0.f,
                     m.w > 0.f ? v.w : 0.f);
}

// Column sums kept per warp (lane owns columns lane*4..+3) → their sum over
// the 8 warps, in warp order, written to out[q*W + c] (c < W) for the NV
// vectors. red_s: NT/32 * NV * C floats of shared memory that no thread is
// using.
template <int NV, int W = C>
__device__ __forceinline__ void reduce_warp_vecs(const float4 (&v)[NV], float* red_s,
                                                 float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
#pragma unroll
  for (int q = 0; q < NV; ++q)
    *reinterpret_cast<float4*>(red_s + (warp * NV + q) * C + lane * 4) = v[q];
  __syncthreads();
  for (int i = threadIdx.x; i < NV * W; i += NT) {
    const int at = W == C ? i : (i / W) * C + i % W;
    float s = 0.f;
    for (int w = 0; w < NT / 32; ++w) s += red_s[w * NV * C + at];
    out[i] = s;
  }
  __syncthreads();
}

// The same per-warp column sums kept in shared memory instead of registers,
// for kernels whose registers hold two [C x C] gradients: vec_s [NT/32][NV][C],
// each lane adding into its own warp's columns lane*4..+3 (no barrier needed).
template <int NV>
__device__ __forceinline__ void zero_warp_vecs(float* vec_s) {
  for (int i = threadIdx.x; i < NT / 32 * NV * C; i += NT) vec_s[i] = 0.f;
}
template <int NV>
__device__ __forceinline__ void add_warp_vec(float* vec_s, int q, float4 v) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float4* p = reinterpret_cast<float4*>(vec_s + (warp * NV + q) * C + lane * 4);
  *p = add4(*p, v);
}
// out[q*W + c] = Σ over the warps, in warp order (as reduce_warp_vecs), for
// the columns c < W.
template <int NV, int W = C>
__device__ __forceinline__ void sum_warp_vecs(const float* vec_s, float* out) {
  __syncthreads();
  for (int i = threadIdx.x; i < NV * W; i += NT) {
    const int at = W == C ? i : (i / W) * C + i % W;
    float s = 0.f;
    for (int w = 0; w < NT / 32; ++w) s += vec_s[w * NV * C + at];
    out[i] = s;
  }
}

// out[i] = Σ_{p < np} part[p*m + i], summed in p order.
__global__ void reduce_partials_kernel(const float* __restrict__ part, float* __restrict__ out,
                                       int np, long m) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  float s = 0.f;
  for (int p = 0; p < np; ++p) s += part[(long)p * m + i];
  out[i] = s;
}

inline cudaError_t reduce_partials(const float* part, float* out, int np, long m,
                                   cudaStream_t stream) {
  if (m <= 0) return cudaSuccess;
  if (np <= 0) return cudaMemsetAsync(out, 0, m * sizeof(float), stream);
  const int threads = 256;
  const long blocks = (m + threads - 1) / threads;
  reduce_partials_kernel<<<(unsigned)blocks, threads, 0, stream>>>(part, out, np, m);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// Tensor-core products (bf16 operands, fp32 accumulators), for the bf16
// instantiations of the backward passes. A warpgroup (4 warps, 128 threads)
// issues `wgmma.mma_async` m64n128k16: a 64-row tile of A against a
// [16 x 128] slice of B, summed into 64 fp32 registers per thread. B, and A
// where it is not in registers, is read from shared memory through a
// descriptor, in wgmma's layout without swizzle: the matrix is cut into 8 x 8
// core matrices, each 8 rows of 16 bytes (8 consecutive columns) held in 128
// contiguous bytes; `Tiles` names where each core matrix sits. The same
// copy of a matrix serves as a K-major operand (K along its columns) and as
// an MN-major one (K along its rows): only the descriptor differs. The fp32
// instantiations keep the CUDA-core products above: wgmma has no fp32
// operands (TF32 would round them), and the fp32 path is what the parity
// checks hold to the CPU.
namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// A bf16 matrix of 8 x 8 core matrices in shared memory: core matrix
// (rb, cb) (rows 8rb.., columns 8cb..) at addr + rb*rs + cb*cs bytes.
struct Tiles {
  uint32_t addr, rs, cs;
};

// Core-tiled [rows x 128] bf16 matrix: row blocks 128 bytes apart, column
// blocks one column of row blocks plus 16 bytes apart (so that a warp
// storing one row's 128 columns, 8 bytes a lane, hits every bank once per
// 128 bytes).
__host__ __device__ constexpr uint32_t tiles_cs(int rows) { return rows / 8 * 128 + 16; }
__host__ __device__ constexpr int tiles_bytes(int rows) { return 16 * (int)tiles_cs(rows); }
__device__ __forceinline__ Tiles tiles(const void* p, int rows) {
  return Tiles{smem_u32(p), 128u, tiles_cs(rows)};
}
// Byte offset of element (r, c) within its Tiles.
__device__ __forceinline__ uint32_t tile_off(const Tiles& t, int r, int c) {
  return (r >> 3) * t.rs + (c >> 3) * t.cs + (r & 7) * 16 + (c & 7) * 2;
}

// Descriptor of the operand slice for k step ks (K = 16ks .. 16ks+15) and
// the 64 (A) or 128 (B) rows of M/N from mn0. k_cols: K runs along the
// matrix's columns (K-major); else along its rows (MN-major). Without
// swizzle, LBO is the byte stride between core matrices along K and SBO
// along M/N.
__device__ __forceinline__ uint64_t desc(const Tiles& t, bool k_cols, int ks, int mn0) {
  uint32_t addr, lbo, sbo;
  if (k_cols) {
    addr = t.addr + (mn0 >> 3) * t.rs + 2 * ks * t.cs;
    lbo = t.cs;
    sbo = t.rs;
  } else {
    addr = t.addr + (mn0 >> 3) * t.cs + 2 * ks * t.rs;
    lbo = t.rs;
    sbo = t.cs;
  }
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// Shared-memory writes made by the threads visible to wgmma's reads (the
// async proxy); every writer calls it before the barrier that precedes the
// products.
__device__ __forceinline__ void fence_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator registers across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A B for one k step, A and B from shared memory; TA/TB: 1 where the
// operand is MN-major.
template <int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d += A B for one k step, A in registers (the m16n8k16 A fragment of the
// warp's 16 rows), B from shared memory.
template <int TB>
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

// acc (this warpgroup's 64 rows of M from m0) += A B over K = 16*KS, both
// operands from shared memory (a_kcols / b_kcols: K along the columns);
// issued and committed, not waited for.
template <int KS, bool A_KCOLS, bool B_KCOLS>
__device__ __forceinline__ void mm(float (&acc)[64], const Tiles& a, int m0, const Tiles& b) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    mma_ss<A_KCOLS ? 0 : 1, B_KCOLS ? 0 : 1>(acc, desc(a, A_KCOLS, ks, m0),
                                             desc(b, B_KCOLS, ks, 0));
}

// Row (0..63 of the warpgroup's tile) and column of accumulator element i.
__device__ __forceinline__ int acc_row(int i) {
  return ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2) + ((i & 2) << 2);
}
__device__ __forceinline__ int acc_col(int i) { return (i >> 2) * 8 + (threadIdx.x & 3) * 2 + (i & 1); }

__device__ __forceinline__ void zero(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
}

// Which of the thread's two accumulator rows (acc_row(i): 0 for the row
// g, 1 for the row g + 8) element i lies in.
__device__ __forceinline__ int acc_half(int i) { return (i >> 1) & 1; }

// x summed over the 4 lanes of the thread's quad (one accumulator row's 128 columns).
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Single-group GroupNorm statistics of the thread's two accumulator rows
// (mean and 1/sqrt(biased var + eps), two passes as gn_row): a row's 128
// columns sit in the 4 lanes of a quad, 32 in each, so two xor shuffles
// finish each sum. A W-wide row's columns are elements i < W/2 (acc_col(i)
// < W exactly there): only those are summed.
template <int W = C>
__device__ __forceinline__ void acc_row_stats(const float (&d)[64], float eps, float (&mu)[2],
                                              float (&inv)[2]) {
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < W / 2; ++i) s[acc_half(i)] += d[i];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mu[h] = quad_sum(s[h]) * (1.f / W);
    s[h] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < W / 2; ++i) {
    const float x = d[i] - mu[acc_half(i)];
    s[acc_half(i)] += x * x;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) inv[h] = rsqrtf(quad_sum(s[h]) * (1.f / W) + eps);
}

// Two fp32 values as one register of bf16x2 (the register-A fragment's element pair).
__device__ __forceinline__ uint32_t pack_bf2(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  uint32_t u;
  memcpy(&u, &h, 4);
  return u;
}

// The A fragment (rows row0 .. row0+15, K = k0 .. k0+15) of a row-major bf16
// tile with row stride ld elements (16-byte aligned rows), at any row offset.
__device__ __forceinline__ void ldm_a(uint32_t (&a)[4], const bf16* tile, int ld, int row0,
                                      int k0) {
  const int lane = threadIdx.x & 31;
  const uint32_t p = smem_u32(tile + (row0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(p));
}

// Four floats as 4 bf16 (8 bytes) at byte offset off of a shared matrix.
__device__ __forceinline__ void st_bf4(uint8_t* base, uint32_t off, float4 v) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(base + off);
  q[0] = __floats2bfloat162_rn(v.x, v.y);
  q[1] = __floats2bfloat162_rn(v.z, v.w);
}

// A [128 x 128] bf16 matrix (row-major in device memory) into core tiles
// `t` at shared pointer dst: 8 neighbouring threads fill one core matrix.
// A [W x W] one goes to the top-left of a zeroed [128 x 128].
template <int W = C>
__device__ __forceinline__ void load_tiles_128(uint8_t* dst, const Tiles& t, const bf16* src) {
  for (int i = threadIdx.x; i < C * C / 8; i += NT) {
    const int r = ((i >> 7) << 3) + (i & 7), cb = (i >> 3) & 15;
    if constexpr (W == C) {
      *reinterpret_cast<uint4*>(dst + tile_off(t, r, cb * 8)) =
          *reinterpret_cast<const uint4*>(src + r * C + cb * 8);
    } else {
      *reinterpret_cast<uint4*>(dst + tile_off(t, r, cb * 8)) =
          r < W && cb * 8 < W ? *reinterpret_cast<const uint4*>(src + r * W + cb * 8)
                              : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

}  // namespace tc

// Asynchronous 16-byte copies from device to shared memory (cp.async), in
// commit groups that a thread waits for; the copies feed the tensor-core
// passes' operand tiles.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(tc::smem_u32(dst)), "l"(src)
               : "memory");
}
// 16 bytes from src, or zeros where bytes is 0 (src then unread).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(tc::smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// --- Warpgroup helpers of the wgmma passes (edge_tc.cuh's chains and the
// W = 256 backwards, wide_bwd.cuh) -------------------------------------------

// The warpgroup's 128 threads (named barrier 1 + warpgroup).
__device__ __forceinline__ void wg_sync() {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + (threadIdx.x >> 7)) : "memory");
}

// Two bf16 values packed in one register (tc::pack_bf2's inverse) as floats.
__device__ __forceinline__ float2 unpack_bf2(uint32_t u) {
  __nv_bfloat162 h;
  memcpy(&h, &u, 4);
  return __bfloat1622float2(h);
}

// One stage of col_sums' butterfly: slots 0 .. M−1 keep the lane's half of
// slots 0 .. 2M−1 (the low half where lane bit M is clear) plus its
// partner's (lane ^ M) sum of the same columns. A template, so that every
// index is a constant and x stays in registers.
template <int M>
__device__ __forceinline__ void col_stage(float (&x)[32], int lane) {
  const bool hi = (lane & M) != 0;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const float send = hi ? x[j] : x[j + M];
    const float keep = hi ? x[j + M] : x[j];
    x[j] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
}

// v[k] += the sum over the tile's 64 rows of a[i]·b[i] (MUL) or a[i], for
// this lane's 4 columns (2g·8 + 2q + {0, 1} and (2g + 1)·8 + 2q + {0, 1},
// g = lane / 4, q = lane % 4). The thread's two rows are added first, then
// a halving butterfly over the 8 lanes of one q: each stage keeps half of
// the columns and sends the other half to its partner (28 shuffles).
template <bool MUL>
__device__ __forceinline__ void col_sums(float (&v)[4], const float (&a)[64],
                                         const float (&b)[64]) {
  const int lane = threadIdx.x & 31;
  float x[32];  // slot j: columns of accumulator elements 4(j >> 1) + (j & 1) (+2)
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int i0 = 4 * (j >> 1) + (j & 1), i1 = i0 + 2;
    x[j] = MUL ? a[i0] * b[i0] + a[i1] * b[i1] : a[i0] + a[i1];
  }
  col_stage<16>(x, lane);
  col_stage<8>(x, lane);
  col_stage<4>(x, lane);
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] += x[k];
}

// The column of the lane's column sum j (0..3) in col_sums' layout.
__device__ __forceinline__ int col_sum_col(int j) {
  const int lane = threadIdx.x & 31;
  return (2 * (lane >> 2) + (j >> 1)) * 8 + 2 * (lane & 3) + (j & 1);
}

// Host dispatch onto the widths the W-templated kernels are built at (the
// wrappers' ops/cuda.py WIDTHS). with_width calls f(width_c<W>{}) for
// width W = 128 or 64; with_width_dtype calls f(width_c<W>{},
// dtype_c<T>{}) with T = float (dtype 0) or bf16 (dtype 1). Any other
// width or dtype returns cudaErrorInvalidValue and launches nothing.
template <int W> using width_c = std::integral_constant<int, W>;
template <typename T> struct dtype_c { using type = T; };

template <typename F> int with_width(int width, F&& f) {
  if (width == C) return f(width_c<C>{});
  if (width == 64) return f(width_c<64>{});
  return (int)cudaErrorInvalidValue;
}

template <typename F> int with_width_dtype(int width, int dtype, F&& f) {
  return with_width(width, [&](auto Wc) {
    if (dtype == 0) return f(Wc, dtype_c<float>{});
    if (dtype == 1) return f(Wc, dtype_c<bf16>{});
    return (int)cudaErrorInvalidValue;
  });
}

// The entries also built at W = 256 (lane_layer_fwd, row_tail_fwd and
// edge_mlp_fwd, on wide.cuh's kernels of their own, and lane_layer_bwd and
// edge_mlp_bwd, on wide_bwd.cuh's; row_tail_bwd takes 256 by a branch of its
// own): f(width_c<256>{}, dtype_c<T>{}) at width 256, else
// with_width_dtype. Every other entry dispatches through with_width or
// with_width_dtype and refuses 256.
template <typename F> int with_width_dtype_256(int width, int dtype, F&& f) {
  if (width != 2 * C) return with_width_dtype(width, dtype, f);
  if (dtype == 0) return f(width_c<2 * C>{}, dtype_c<float>{});
  if (dtype == 1) return f(width_c<2 * C>{}, dtype_c<bf16>{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace lgk
