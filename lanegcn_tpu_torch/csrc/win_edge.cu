// Window-pair fused edge MLP + destination scatter (Att), forward and backward.
//
// Replaces lanegcn_tpu/ops/pallas_win_edge.py `_fwd_kernel` / `_pallas_fwd`
// (the Pallas kernel behind `win_edge_mlp`). Per planned edge (u ← v) of a
// chunk with destination window dw and source window sw:
//
//   t1 = relu(Pd[u] + Ps[v] + bd)          (rounded to the activation dtype)
//   t2 = relu(GN(t1 @ Wdo))                (rounded)
//   s  = t2 @ K1 + Cs[v] + Qd[u]
//   e1 = relu(GN(s))                       (rounded)
//   out[u] += e1 @ Wout                    (fp32 accumulation, rounded once)
//
// with u = dw*sd + lu, v = sw*ss + lv. Destination windows that no chunk
// touches keep temp: the wrapper hands in out = temp.clone(), and a block
// rewrites only its own window.
//
// What bounds it: three [E x 128] x [128 x 128] products per valid edge
// (2.1 GFLOP for A2M at 256 scenarios) against ~118 MB of traffic (temp
// read and out written whole, Pd/Qd/Ps/Cs at the rows the edges gather),
// so at the card's bf16 matrix rate it is memory-bound; this first
// version runs the products on CUDA cores in fp32, which makes the products
// the larger cost. The design keeps every per-edge intermediate on chip:
// the gathers are indexed row loads straight into shared memory, the chain
// runs 64 edges at a time in shared memory, and the destination scatter
// accumulates into an fp32 window buffer. Chunks are sorted by (dwin, swin)
// and `first` marks each destination window's run: one block owns one run,
// so no two blocks write the same window and the sum needs no atomics (a
// fixed order: deterministic). Padding edges (lu = -1) and empty halves
// contribute nothing.
//
// Backward (`win_edge_bwd`): replaces pallas_win_edge.py `_bwd_d_kernel` /
// `_bwd_s_kernel` (`_pallas_bwd`). Per valid edge, recompute t1, z, t2, s,
// e1 (three products), then
//   d_e2 = g[u];  d_e1 = d_e2 @ Woutᵀ;  dWout += e1ᵀ d_e2
//   d_s  = GN_chᵀ(d_e1 ⊙ [e1 > 0]);     dK1 += t2ᵀ rnd(d_s);  d_t2 = rnd(d_s) @ K1ᵀ
//   d_z  = GN_doᵀ(d_t2 ⊙ [t2 > 0]);     dWdo += t1ᵀ rnd(d_z); d_t1 = rnd(d_z) @ Wdoᵀ
//   d_t1p = d_t1 ⊙ [t1 > 0];  dbd += Σ d_t1p
// and dPd[u] += rnd(d_t1p), dQd[u] += rnd(d_s), dPs[v] += rnd(d_t1p),
// dCs[v] += rnd(d_s). The TPU kernel walked one destination window's chunks
// in order and carried dW in scratch across its sequential grid steps;
// ported that way (one block per destination-window run) M2A and A2A gave
// 32 of the card's 132 SMs work. Here the wrapper first lists the plan's
// valid edges in destination order, with each one's position in source
// order (ops/win_edge.py `prepare_pair`, on the device, once per plan and
// step), and the passes walk contiguous 64-edge tiles of that list, so that
// every SM works whatever the window count:
//   1. the chain (bf16: win_edge_bwd_tc_kernel, the six activation products
//      on wgmma; fp32: win_edge_bwd_kernel, edge_chain.cuh's chain_bwd on
//      CUDA cores, the parity path) writes rnd(d_t1p) | rnd(d_s) of each
//      edge at its destination and at its source position (and, in bf16,
//      the weight-gradient operands), and each block's vector sums once;
//   2. (bf16) win_edge_dw_tc_kernel: dWdo, dK1, dWout as split-K wgmma
//      products over those operands, one fp32 partial per split;
//   3. the partials summed in block / split order (reduce_partials);
//   4. the four scatters as two fixed-order segment sums (segment_sum.cuh):
//      dPd | dQd over the destination order, dPs | dCs over the source
//      order, rows no edge touches zero.
// No float atomics: a rerun is bitwise equal. What bounds it: nine
// [E x 128] x [128 x 128] products per valid edge (6.3 GFLOP at A2M's
// ~21k edges) against dPd/dQd/dPs/dCs written whole (~110 MB at 208,896
// rows): bytes, at the card's rates. The chain itself, forward and
// backward, is edge_chain.cuh's in fp32, shared with edge_mlp.cu.
#include <type_traits>

#include "edge_chain.cuh"
#include "segment_sum.cuh"

using namespace lgk;

namespace {

constexpr int EB = 64;  // edges per step

// Reads slot lu/lv of one 64-edge step into lu_s/lv_s (-1 where invalid);
// returns whether any edge of the step is valid. Ends with a barrier.
__device__ __forceinline__ bool load_step(const int* idx, int* lu_s, int* lv_s, int* any_s,
                                          int kk, int h, int chunk, int icol, int sd, int ss,
                                          long base_d, long base_s, int nd, int ns) {
  __syncthreads();  // the previous step is done with lu_s / the tiles
  if (threadIdx.x == 0) *any_s = 0;
  __syncthreads();
  if (threadIdx.x < EB) {
    int u = -1, v = -1;
    if (h * EB + threadIdx.x < chunk) {
      const long e = (long)kk * chunk + h * EB + threadIdx.x;
      u = idx[e * icol];
      v = idx[e * icol + 1];
    }
    const bool ok =
        u >= 0 && u < sd && v >= 0 && v < ss && base_d + u < nd && base_s + v < ns;
    lu_s[threadIdx.x] = ok ? u : -1;
    lv_s[threadIdx.x] = ok ? v : -1;
    if (ok) *any_s = 1;
  }
  __syncthreads();
  return *any_s != 0;
}

// t1 = rnd(relu(Pd[u] + Ps[v] + bd)) for the step's edges into A_s (0 where invalid).
template <typename T>
__device__ __forceinline__ void gather_t1(float* A_s, const int* lu_s, const int* lv_s,
                                          const T* pd, const T* ps, const float* bd,
                                          long base_d, long base_s) {
  for (int i = threadIdx.x; i < EB * (C / 4); i += NT) {
    const int r = i / (C / 4), c4 = (i % (C / 4)) * 4;
    float4 t = zero4();
    if (lu_s[r] >= 0) {
      const float4 a = load4<T>(pd + (base_d + lu_s[r]) * C + c4);
      const float4 b = load4<T>(ps + (base_s + lv_s[r]) * C + c4);
      t = rnd4<T>(relu4(add4(add4(a, b), *reinterpret_cast<const float4*>(bd + c4))));
    }
    *reinterpret_cast<float4*>(A_s + r * LDA + c4) = t;
  }
}

// acc_out[(base_d + lu) * C + c] += X_s[e][c] over the step's valid edges in
// edge order (one thread per channel of the first C threads).
__device__ __forceinline__ void scatter_rows(float* acc_out, const float* X_s, const int* lu_s,
                                             long base_d) {
  if (threadIdx.x < C) {
    for (int e = 0; e < EB; ++e) {
      const int u = lu_s[e];
      if (u >= 0) acc_out[(base_d + u) * C + threadIdx.x] += X_s[e * LDA + threadIdx.x];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
win_edge_kernel(const T* __restrict__ pd, const T* __restrict__ qd, const T* __restrict__ ps,
                const T* __restrict__ cs, const T* __restrict__ temp,
                const float* __restrict__ bd, const T* __restrict__ kdo,
                const float* __restrict__ gdow, const float* __restrict__ gdob,
                const T* __restrict__ k1, const float* __restrict__ gchw,
                const float* __restrict__ gchb, const T* __restrict__ kout,
                const int* __restrict__ idx, const int* __restrict__ meta, float* acc,
                T* out, int write_out, int nc, int chunk, int sd, int ss, int icol, int nd,
                int ns, float eps) {
  const int* dwin = meta;
  const int* swin = meta + nc;
  const int* first = meta + 2 * nc;
  const int k = blockIdx.x;
  if (first[k] != 1) return;
  int k_end = k + 1;
  while (k_end < nc && first[k_end] != 1) ++k_end;

  extern __shared__ float4 smem4[];
  float* A_s = reinterpret_cast<float*>(smem4);  // [EB][LDA]
  float* W_s = A_s + EB * LDA;                   // [C][C]
  int* lu_s = reinterpret_cast<int*>(W_s + C * C);
  int* lv_s = lu_s + EB;
  int* any_s = lv_s + EB;

  const long base_d = (long)dwin[k] * sd;
  const int rows_d = (int)min((long)sd, (long)nd - base_d);
  for (int i = threadIdx.x; i < rows_d * (C / 4); i += NT) {
    const long o = (base_d + i / (C / 4)) * C + (i % (C / 4)) * 4;
    *reinterpret_cast<float4*>(acc + o) = load4<T>(temp + o);
  }

  const Chain<T> w{kdo, gdow, gdob, k1, gchw, gchb, kout, eps};
  const int lane = threadIdx.x & 31;
  float mm[4][8];

  for (int kk = k; kk < k_end; ++kk) {
    const long base_s = (long)swin[kk] * ss;
    // s += Cs[v] + Qd[u]
    auto qc = [&](int r, float4 s) {
      if (lu_s[r] >= 0) {
        s = add4(s, load4<T>(cs + (base_s + lv_s[r]) * C + lane * 4));
        s = add4(s, load4<T>(qd + (base_d + lu_s[r]) * C + lane * 4));
      }
      return s;
    };
    for (int h = 0; h * EB < chunk; ++h) {
      // (the first barrier also makes the acc init visible)
      if (!load_step(idx, lu_s, lv_s, any_s, kk, h, chunk, icol, sd, ss, base_d, base_s, nd, ns))
        continue;
      gather_t1<T>(A_s, lu_s, lv_s, pd, ps, bd, base_d, base_s);  // t1
      chain_fwd<T>(A_s, W_s, w, qc, mm);                          // e2 = e1 @ Wout
      __syncthreads();
      store_acc(A_s, mm);
      __syncthreads();
      scatter_rows(acc, A_s, lu_s, base_d);  // out[u] += e2, in edge order
    }
  }
  __syncthreads();
  if (write_out) {
    for (int i = threadIdx.x; i < rows_d * (C / 4); i += NT) {
      const long o = (base_d + i / (C / 4)) * C + (i % (C / 4)) * 4;
      store4<T>(out + o, *reinterpret_cast<const float4*>(acc + o));
    }
  }
}

template <typename T>
int launch(const void* pd, const void* qd, const void* ps, const void* cs, const void* temp,
           const float* bd, const void* kdo, const float* gdow, const float* gdob,
           const void* k1, const float* gchw, const float* gchb, const void* kout,
           const int* idx, const int* meta, float* acc, void* out, int write_out, int nc,
           int chunk, int sd, int ss, int icol, int nd, int ns, float eps,
           cudaStream_t stream) {
  const int smem = (EB * LDA + C * C) * (int)sizeof(float) + (2 * EB + 4) * (int)sizeof(int);
  cudaError_t err = set_smem((const void*)win_edge_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  if (nc > 0) {
    win_edge_kernel<T><<<nc, NT, smem, stream>>>(
        (const T*)pd, (const T*)qd, (const T*)ps, (const T*)cs, (const T*)temp, bd,
        (const T*)kdo, gdow, gdob, (const T*)k1, gchw, gchb, (const T*)kout, idx, meta, acc,
        (T*)out, write_out, nc, chunk, sd, ss, icol, nd, ns, eps);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward.

constexpr int WE_PART = 3 * C * C + 5 * C;  // dWdo, dK1, dWout, dbd, dgdow, dgdob, dgchw, dgchb
constexpr int TE = 64;                       // edges per tile

// This block's tiles [x, y): an equal share of the ⌈e / TE⌉ tiles over the
// destination-ordered edges, in order.
__device__ __forceinline__ int2 block_tiles(int e) {
  const long total = (e + TE - 1) / TE;
  return make_int2((int)(blockIdx.x * total / gridDim.x),
                   (int)((blockIdx.x + 1) * total / gridDim.x));
}

// fp32 (the parity path): edge_chain.cuh's chain_bwd on CUDA cores over the
// block's tiles, the weight gradients added into the block's own slice of
// `part` (zeroed here, then a read-modify-write per tile, by this block
// only), the vectors kept per warp and written once. rows_d / rows_s get
// rnd(d_t1p) | rnd(d_s) at each edge's destination / source position.
__global__ void __launch_bounds__(NT)
win_edge_bwd_kernel(const float* __restrict__ pd, const float* __restrict__ qd,
                    const float* __restrict__ ps, const float* __restrict__ cs,
                    const float* __restrict__ g, const float* __restrict__ bd,
                    const float* __restrict__ kdo, const float* __restrict__ gdow,
                    const float* __restrict__ gdob, const float* __restrict__ k1,
                    const float* __restrict__ gchw, const float* __restrict__ gchb,
                    const float* __restrict__ kout, const int* __restrict__ eu,
                    const int* __restrict__ ev, const int* __restrict__ spos,
                    const int* __restrict__ count, float* __restrict__ rows_d,
                    float* __restrict__ rows_s, float* __restrict__ part, float eps) {
  extern __shared__ float4 smem4[];
  float* A_s = reinterpret_cast<float*>(smem4);  // [TE][LDA] four edge tiles
  float* B_s = A_s + TE * LDA;
  float* C_s = B_s + TE * LDA;
  float* D_s = C_s + TE * LDA;
  float* W_s = D_s + TE * LDA;  // [C][C]
  float* st_s = W_s + C * C;    // [TE][2] inv of GN(do), GN(ch)
  int* lu_s = reinterpret_cast<int*>(st_s + 2 * TE);  // the tile's rows (-1 past the edges)
  int* lv_s = lu_s + TE;
  int* sp_s = lv_s + TE;

  const int e = *count;
  const int2 range = block_tiles(e);
  float* P = part + (long)blockIdx.x * WE_PART;
  for (int i = threadIdx.x; i < 3 * C * C; i += NT) P[i] = 0.f;
  const Chain<float> w{kdo, gdow, gdob, k1, gchw, gchb, kout, eps};
  const int lane = threadIdx.x & 31;
  float4 vecs[5] = {zero4(), zero4(), zero4(), zero4(), zero4()};
  for (int t = range.x; t < range.y; ++t) {
    const long p0 = (long)t * TE;
    __syncthreads();  // the previous tile is done with the rows (and P is zeroed)
    if (threadIdx.x < TE) {
      const long p = p0 + threadIdx.x;
      const bool ok = p < e;
      lu_s[threadIdx.x] = ok ? eu[p] : -1;
      lv_s[threadIdx.x] = ok ? ev[p] : -1;
      sp_s[threadIdx.x] = ok ? spos[p] : -1;
    }
    auto store = [&](int r, int col, float4 x) {
      store4<float>(rows_d + (p0 + r) * 2 * C + col + lane * 4, x);
      store4<float>(rows_s + (long)sp_s[r] * 2 * C + col + lane * 4, x);
    };
    chain_bwd<float>(
        A_s, B_s, C_s, D_s, W_s, st_s, P, vecs, w,
        [&](float* X_s) { gather_t1<float>(X_s, lu_s, lv_s, pd, ps, bd, 0, 0); },
        [&](int r, float4 sv) {  // s += Cs[v] + Qd[u]
          if (lu_s[r] >= 0) {
            sv = add4(sv, load4<float>(cs + (long)lv_s[r] * C + lane * 4));
            sv = add4(sv, load4<float>(qd + (long)lu_s[r] * C + lane * 4));
          }
          return sv;
        },
        [&](int r) {  // d_e2 = g[u]
          return lu_s[r] >= 0 ? load4<float>(g + (long)lu_s[r] * C + lane * 4) : zero4();
        },
        [&](int r) { return lu_s[r] >= 0; }, [&](int r, float4 ds) { store(r, C, ds); }, []() {},
        [&](int r, float4 d1) { store(r, 0, d1); }, []() {});
  }
  reduce_warp_vecs<5>(vecs, B_s, P + 3 * C * C);
}

// bf16 (the path that trains): the chain on tensor cores. A block of
// WE_WGS = 2 warpgroups holds the three weights once, as core tiles that
// serve both as K1 / Wdo (MN-major, the forward products) and as their
// transposes (K-major, the backward ones); each warpgroup walks every other
// tile of the block's range with three [TE x 128] bf16 edge tiles of its
// own (t1; t2, then rnd(d_s); g[u], then rnd(d_z)) and its own barrier, so
// the two are never in step. Per tile, on wgmma m64n128k16: z = t1 @ Wdo,
// s = t2 @ K1 beside d_e1 = g[u] @ Woutᵀ, d_t2 = rnd(d_s) @ K1ᵀ beside z
// again (recomputed rather than kept: the registers hold s's normalised
// rows instead), d_t1 = rnd(d_z) @ Wdoᵀ; each GroupNorm forward and
// backward runs on the accumulators in registers, a row's statistics from
// its quad of lanes. The vectors' column sums reduce over a tile's rows by
// a halving butterfly of shuffles into 4 columns a lane, kept across the
// tiles and summed over the warps once. The weight gradients are left to
// win_edge_dw_tc_kernel: three [128 x 128] fp32 accumulators do not fit
// beside the chain, so each edge's operands (t1 | t2 | e1 | rnd(d_z)) go to
// `act` at its destination position.
constexpr int WE_WGS = 2;
constexpr int WE_THREADS = 128 * WE_WGS;
constexpr int WB = tc::tiles_bytes(C);   // a [128 x 128] weight's core tiles
constexpr int TB = tc::tiles_bytes(TE);  // a [TE x 128] edge tile's

inline int bwd_tc_smem() {
  return 3 * WB + WE_WGS * 3 * TB + 5 * C * (int)sizeof(float) +
         WE_WGS * 3 * TE * (int)sizeof(int);
}

// The warpgroup's 128 threads (named barrier 1 + warpgroup).
__device__ __forceinline__ void wg_sync() {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + (threadIdx.x >> 7)) : "memory");
}

__device__ __forceinline__ float2 ld_bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 unpack_bf2(uint32_t u) {
  __nv_bfloat162 h;
  memcpy(&h, &u, 4);
  return __bfloat1622float2(h);
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
#pragma unroll
  for (int m = 16, half = 16; m >= 4; m >>= 1, half >>= 1) {
    const bool hi = (lane & m) != 0;
#pragma unroll
    for (int j = 0; j < half; ++j) {
      const float send = hi ? x[j] : x[j + half];
      const float keep = hi ? x[j + half] : x[j];
      x[j] = keep + __shfl_xor_sync(0xffffffffu, send, m);
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] += x[k];
}

// GroupNorm backward on the accumulators: d[i] = inv·(d_nrm − mean(d_nrm) −
// nrm·mean(d_nrm·nrm)), d_nrm = dy[i]·w[col], per row (as common.cuh
// gn_bwd_row), returned as bf16 pairs in `out` (element pair i/2).
__device__ __forceinline__ void gn_bwd_acc(const float (&dy)[64], const float (&nrm)[64],
                                           const float (&inv)[2], const float* w,
                                           uint32_t (&out)[32]) {
  float c1[2] = {0.f, 0.f}, c2[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float dn = dy[i] * w[tc::acc_col(i)];
    c1[tc::acc_half(i)] += dn;
    c2[tc::acc_half(i)] += dn * nrm[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    c1[h] = tc::quad_sum(c1[h]) * (1.f / C);
    c2[h] = tc::quad_sum(c2[h]) * (1.f / C);
  }
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int h = tc::acc_half(i), c = tc::acc_col(i);
    out[i / 2] = tc::pack_bf2(inv[h] * (dy[i] * w[c] - c1[h] - nrm[i] * c2[h]),
                              inv[h] * (dy[i + 1] * w[c + 1] - c1[h] - nrm[i + 1] * c2[h]));
  }
}

__global__ void __launch_bounds__(WE_THREADS, 1)
win_edge_bwd_tc_kernel(const bf16* __restrict__ pd, const bf16* __restrict__ qd,
                       const bf16* __restrict__ ps, const bf16* __restrict__ cs,
                       const bf16* __restrict__ g, const float* __restrict__ bd,
                       const bf16* __restrict__ kdo, const float* __restrict__ gdow,
                       const float* __restrict__ gdob, const bf16* __restrict__ k1,
                       const float* __restrict__ gchw, const float* __restrict__ gchb,
                       const bf16* __restrict__ kout, const int* __restrict__ eu,
                       const int* __restrict__ ev, const int* __restrict__ spos,
                       const int* __restrict__ count, bf16* __restrict__ rows_d,
                       bf16* __restrict__ rows_s, bf16* __restrict__ act,
                       float* __restrict__ part_v, float eps) {
  extern __shared__ float4 smem4[];
  uint8_t* W_b = reinterpret_cast<uint8_t*>(smem4);                // Wdo | K1 | Wout
  uint8_t* E_b = W_b + 3 * WB;                                     // [WE_WGS][t1, X, Y]
  float* vec_s = reinterpret_cast<float*>(E_b + WE_WGS * 3 * TB);  // bd, gdow, gdob, gchw, gchb
  int* row_s = reinterpret_cast<int*>(vec_s + 5 * C);              // [WE_WGS][u, v, spos][TE]
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127, lane = threadIdx.x & 31;
  const tc::Tiles Wdo = tc::tiles(W_b, C), K1 = tc::tiles(W_b + WB, C),
                  Wout = tc::tiles(W_b + 2 * WB, C);
  uint8_t* T1_b = E_b + wg * 3 * TB;
  uint8_t* X_b = T1_b + TB;
  uint8_t* Y_b = X_b + TB;
  const tc::Tiles T1 = tc::tiles(T1_b, TE), X = tc::tiles(X_b, TE), Y = tc::tiles(Y_b, TE);
  int* U_s = row_s + wg * 3 * TE;
  int* V_s = U_s + TE;
  int* S_s = V_s + TE;
  const float* bd_s = vec_s;
  const float* gdow_s = vec_s + C;
  const float* gdob_s = vec_s + 2 * C;
  const float* gchw_s = vec_s + 3 * C;
  const float* gchb_s = vec_s + 4 * C;

  for (int i = threadIdx.x; i < 3 * C * C / 8; i += WE_THREADS) {
    const int m = i / (C * C / 8), j = i % (C * C / 8);
    const int r = ((j >> 7) << 3) + (j & 7), c = ((j >> 3) & 15) * 8;
    const bf16* src = m == 0 ? kdo : m == 1 ? k1 : kout;
    cp_async16(W_b + m * WB + tc::tile_off(Wdo, r, c), src + r * C + c);
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < 5 * C; i += WE_THREADS) {
    const float* v = i < C ? bd : i < 2 * C ? gdow : i < 3 * C ? gdob : i < 4 * C ? gchw : gchb;
    vec_s[i] = v[i & (C - 1)];
  }
  const int e = *count;
  const int2 range = block_tiles(e);
  cp_async_wait<0>();
  tc::fence_smem();
  __syncthreads();  // the weights and vectors in place

  float va[5][4];  // column sums: dbd, dgdow, dgdob, dgchw, dgchb (this lane's 4 columns)
#pragma unroll
  for (int k = 0; k < 5; ++k) va[k][0] = va[k][1] = va[k][2] = va[k][3] = 0.f;
  const int r0 = tc::acc_row(0);  // this thread's rows of a tile: r0 and r0 + 8
  for (int t = range.x + wg; t < range.y; t += WE_WGS) {
    const long p0 = (long)t * TE;
    wg_sync();  // the warpgroup is done with the previous tile's buffers and rows
    if (tid < TE) {
      const long p = p0 + tid;
      const bool ok = p < e;
      U_s[tid] = ok ? eu[p] : -1;
      V_s[tid] = ok ? ev[p] : -1;
      S_s[tid] = ok ? spos[p] : -1;
    }
    wg_sync();
    // g[u] into Y by cp.async; t1 = rnd(relu(Pd[u] + Ps[v] + bd)) into T1 and
    // act. 8 neighbouring threads fill one core matrix (8 rows, 16 bytes).
#pragma unroll
    for (int k = 0; k < TE * C / 8 / 128; ++k) {
      const int r = 8 * k + (tid & 7), c = (tid >> 3) * 8;
      const int u = U_s[r], v = V_s[r];
      const uint32_t off = tc::tile_off(T1, r, c);  // the same in every edge tile
      cp_async16_zfill(Y_b + off, u >= 0 ? g + (long)u * C + c : g, u >= 0 ? 16 : 0);
      uint4 o = make_uint4(0u, 0u, 0u, 0u);
      if (u >= 0) {
        const uint4 a = *reinterpret_cast<const uint4*>(pd + (long)u * C + c);
        const uint4 b = *reinterpret_cast<const uint4*>(ps + (long)v * C + c);
        const uint32_t* ap = &a.x;
        const uint32_t* bp = &b.x;
        uint32_t* op = &o.x;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 x = unpack_bf2(ap[q]), y = unpack_bf2(bp[q]);
          op[q] = tc::pack_bf2(fmaxf(x.x + y.x + bd_s[c + 2 * q], 0.f),
                               fmaxf(x.y + y.y + bd_s[c + 2 * q + 1], 0.f));
        }
        *reinterpret_cast<uint4*>(act + (p0 + r) * 4 * C + c) = o;
      }
      *reinterpret_cast<uint4*>(T1_b + off) = o;
    }
    cp_async_commit();
    cp_async_wait<0>();
    tc::fence_smem();
    wg_sync();  // t1 and g[u] in place

    const int ua = U_s[r0], ub = U_s[r0 + 8], sa = S_s[r0], sb = S_s[r0 + 8];
    const bool ok[2] = {ua >= 0, ub >= 0};
    const int uu[2] = {ua, ub}, vv[2] = {V_s[r0], V_s[r0 + 8]};
    bf16* act_r[2] = {act + (p0 + r0) * 4 * C, act + (p0 + r0 + 8) * 4 * C};
    bf16* rd_r[2] = {rows_d + (p0 + r0) * 2 * C, rows_d + (p0 + r0 + 8) * 2 * C};
    bf16* rs_r[2] = {rows_s + (long)sa * 2 * C, rows_s + (long)sb * 2 * C};

    // z = t1 @ Wdo; t2 = rnd(relu(GN_do(z))) into X and act.
    float acc[64], acc2[64];
    tc::zero(acc);
    tc::fence_acc(acc);
    tc::fence();
    tc::mm<C / 16, true, false>(acc, T1, 0, Wdo);
    tc::commit();
    tc::wait_all();
    tc::fence_acc(acc);
    float muz[2], invz[2];
    tc::acc_row_stats(acc, eps, muz, invz);
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int h = tc::acc_half(i), c = tc::acc_col(i);
      const uint32_t t2 =
          tc::pack_bf2(fmaxf((acc[i] - muz[h]) * invz[h] * gdow_s[c] + gdob_s[c], 0.f),
                       fmaxf((acc[i + 1] - muz[h]) * invz[h] * gdow_s[c + 1] + gdob_s[c + 1], 0.f));
      *reinterpret_cast<uint32_t*>(X_b + tc::tile_off(X, r0 + 8 * h, c)) = t2;
      if (ok[h]) *reinterpret_cast<uint32_t*>(act_r[h] + C + c) = t2;
    }
    tc::fence_smem();
    wg_sync();  // t2 in place

    // s = t2 @ K1 beside d_e1 = g[u] @ Woutᵀ.
    tc::zero(acc);
    tc::zero(acc2);
    tc::fence_acc(acc);
    tc::fence_acc(acc2);
    tc::fence();
    tc::mm<C / 16, true, false>(acc, X, 0, K1);
    tc::mm<C / 16, true, true>(acc2, Y, 0, Wout);
    tc::commit();
    tc::wait_all();
    tc::fence_acc(acc);
    tc::fence_acc(acc2);
    // s += Cs[v] + Qd[u]; acc ← nrm_s; e1 = rnd(relu(nrm_s ⊙ gchw + gchb)) to
    // act; acc2 ← d_gn_s = d_e1 ⊙ [e1 > 0] (0 past the edges).
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int h = tc::acc_half(i), c = tc::acc_col(i);
      if (ok[h]) {
        const float2 cv = ld_bf2(cs + (long)vv[h] * C + c), qv = ld_bf2(qd + (long)uu[h] * C + c);
        acc[i] = acc[i] + cv.x + qv.x;
        acc[i + 1] = acc[i + 1] + cv.y + qv.y;
      }
    }
    float mus[2], invs[2];
    tc::acc_row_stats(acc, eps, mus, invs);
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int h = tc::acc_half(i), c = tc::acc_col(i);
      acc[i] = (acc[i] - mus[h]) * invs[h];
      acc[i + 1] = (acc[i + 1] - mus[h]) * invs[h];
      const uint32_t e1 = tc::pack_bf2(fmaxf(acc[i] * gchw_s[c] + gchb_s[c], 0.f),
                                       fmaxf(acc[i + 1] * gchw_s[c + 1] + gchb_s[c + 1], 0.f));
      if (ok[h]) *reinterpret_cast<uint32_t*>(act_r[h] + 2 * C + c) = e1;
      const float2 ef = unpack_bf2(e1);
      acc2[i] = ok[h] && ef.x > 0.f ? acc2[i] : 0.f;
      acc2[i + 1] = ok[h] && ef.y > 0.f ? acc2[i + 1] : 0.f;
    }
    col_sums<true>(va[3], acc2, acc);
    col_sums<false>(va[4], acc2, acc2);
    uint32_t d2[32];
    gn_bwd_acc(acc2, acc, invs, gchw_s, d2);  // rnd(d_s)
    wg_sync();  // every warp's products are done with X (t2)
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int h = tc::acc_half(i), c = tc::acc_col(i);
      *reinterpret_cast<uint32_t*>(X_b + tc::tile_off(X, r0 + 8 * h, c)) = d2[i / 2];
      if (ok[h]) {
        *reinterpret_cast<uint32_t*>(rd_r[h] + C + c) = d2[i / 2];
        *reinterpret_cast<uint32_t*>(rs_r[h] + C + c) = d2[i / 2];
      }
    }
    tc::fence_smem();
    wg_sync();  // rnd(d_s) in place

    // d_t2 = rnd(d_s) @ K1ᵀ beside z = t1 @ Wdo again.
    tc::zero(acc);
    tc::zero(acc2);
    tc::fence_acc(acc);
    tc::fence_acc(acc2);
    tc::fence();
    tc::mm<C / 16, true, true>(acc, X, 0, K1);
    tc::mm<C / 16, true, false>(acc2, T1, 0, Wdo);
    tc::commit();
    tc::wait_all();
    tc::fence_acc(acc);
    tc::fence_acc(acc2);
    // acc2 ← nrm_z; acc ← d_gn_z = d_t2 ⊙ [t2 > 0].
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int h = tc::acc_half(i), c = tc::acc_col(i);
      acc2[i] = (acc2[i] - muz[h]) * invz[h];
      acc2[i + 1] = (acc2[i + 1] - muz[h]) * invz[h];
      const float2 t2 = unpack_bf2(
          tc::pack_bf2(fmaxf(acc2[i] * gdow_s[c] + gdob_s[c], 0.f),
                       fmaxf(acc2[i + 1] * gdow_s[c + 1] + gdob_s[c + 1], 0.f)));
      acc[i] = ok[h] && t2.x > 0.f ? acc[i] : 0.f;
      acc[i + 1] = ok[h] && t2.y > 0.f ? acc[i + 1] : 0.f;
    }
    col_sums<true>(va[1], acc, acc2);
    col_sums<false>(va[2], acc, acc);
    gn_bwd_acc(acc, acc2, invz, gdow_s, d2);  // rnd(d_z)
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int h = tc::acc_half(i), c = tc::acc_col(i);
      *reinterpret_cast<uint32_t*>(Y_b + tc::tile_off(Y, r0 + 8 * h, c)) = d2[i / 2];
      if (ok[h]) *reinterpret_cast<uint32_t*>(act_r[h] + 3 * C + c) = d2[i / 2];
    }
    tc::fence_smem();
    wg_sync();  // rnd(d_z) in place (g[u]'s product finished before the last barrier)

    // d_t1 = rnd(d_z) @ Wdoᵀ; d_t1p = d_t1 ⊙ [t1 > 0].
    tc::zero(acc);
    tc::fence_acc(acc);
    tc::fence();
    tc::mm<C / 16, true, true>(acc, Y, 0, Wdo);
    tc::commit();
    tc::wait_all();
    tc::fence_acc(acc);
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int h = tc::acc_half(i), c = tc::acc_col(i);
      const float2 t1 =
          unpack_bf2(*reinterpret_cast<const uint32_t*>(T1_b + tc::tile_off(T1, r0 + 8 * h, c)));
      acc[i] = ok[h] && t1.x > 0.f ? acc[i] : 0.f;
      acc[i + 1] = ok[h] && t1.y > 0.f ? acc[i + 1] : 0.f;
      if (ok[h]) {
        const uint32_t d1 = tc::pack_bf2(acc[i], acc[i + 1]);
        *reinterpret_cast<uint32_t*>(rd_r[h] + c) = d1;
        *reinterpret_cast<uint32_t*>(rs_r[h] + c) = d1;
      }
    }
    col_sums<false>(va[0], acc, acc);
  }

  // The block's vectors: each warp's columns, summed over the warps in order.
  __syncthreads();
  float* red_s = reinterpret_cast<float*>(E_b);  // [WE_THREADS / 32][5][C]
  const int warp = threadIdx.x >> 5, g8 = lane >> 2, q = lane & 3;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      red_s[(warp * 5 + k) * C + (2 * g8 + (j >> 1)) * 8 + 2 * q + (j & 1)] = va[k][j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 5 * C; i += WE_THREADS) {
    float s = 0.f;
    for (int w = 0; w < WE_THREADS / 32; ++w) s += red_s[w * 5 * C + i];
    part_v[(long)blockIdx.x * 5 * C + i] = s;
  }
}

// The bf16 weight gradients: block (split, k) sums A[p]ᵀ B[p] over the
// tiles split, split + splits, ... of the destination-ordered edges, for
// k = 0: dWdo (t1, rnd(d_z)), 1: dK1 (t2, rnd(d_s)), 2: dWout (e1, g[u]),
// K running over a tile's 64 edges (rows past the edges zero-filled). Both
// operands MN-major from a DW_STAGES ring of core tiles by cp.async, as
// lane_band.cuh's band_dw_tc_kernel; warpgroup w owns input channels
// 64w .. 64w + 63.
constexpr int DW_STAGES = 3;

__global__ void __launch_bounds__(NT)
win_edge_dw_tc_kernel(const bf16* __restrict__ act, const bf16* __restrict__ rows_d,
                      const bf16* __restrict__ g, const int* __restrict__ eu,
                      const int* __restrict__ count, float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  uint8_t* buf = reinterpret_cast<uint8_t*>(smem4);  // [DW_STAGES][A, B] core tiles
  constexpr int PER = TE * C / 8 / NT;  // 16-byte chunks per thread per operand
  const int k = blockIdx.y, wg = threadIdx.x >> 7;
  const int e = *count, ntiles = (e + TE - 1) / TE, step = gridDim.x;
  const tc::Tiles t0 = tc::tiles(buf, TE);  // offsets are the same in every stage
  const bf16* a_src = act + k * C;
  const bf16* b_src = k == 0 ? act + 3 * C : k == 1 ? rows_d + C : g;
  const int b_ld = k == 0 ? 4 * C : k == 1 ? 2 * C : C;

  auto issue = [&](int tile, int stage) {  // one commit group, empty past the last tile
    uint8_t* A_b = buf + stage * 2 * TB;
    if (tile < ntiles) {
#pragma unroll
      for (int kk = 0; kk < PER; ++kk) {
        const int i = threadIdx.x + kk * NT;
        const int r = ((i >> 7) << 3) + (i & 7), c = ((i >> 3) & 15) * 8;
        const uint32_t off = tc::tile_off(t0, r, c);
        const long p = (long)tile * TE + r;
        const bool in = p < e;
        const long brow = !in ? 0 : k == 2 ? (long)eu[p] : p;
        cp_async16_zfill(A_b + off, in ? a_src + p * 4 * C + c : act, in ? 16 : 0);
        cp_async16_zfill(A_b + TB + off, in ? b_src + brow * b_ld + c : g, in ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  float acc[64];
  tc::zero(acc);
  const int first = blockIdx.x;
  issue(first, 0);
  issue(first + step, 1);
  for (int kk = 0; first + kk * step < ntiles; ++kk) {
    cp_async_wait<1>();  // stage kk landed (kk + 1 may be in flight)
    tc::fence_smem();
    // stage kk in place for every thread; every warpgroup done with kk − 1,
    // whose buffer stage kk + 2 now takes
    __syncthreads();
    issue(first + (kk + 2) * step, (kk + 2) % DW_STAGES);
    const int st = kk % DW_STAGES;
    const tc::Tiles A = tc::tiles(buf + st * 2 * TB, TE), B = tc::tiles(buf + st * 2 * TB + TB, TE);
    tc::fence_acc(acc);
    tc::fence();
    tc::mm<TE / 16, false, false>(acc, A, 64 * wg, B);
    tc::commit();
    tc::wait_all();
    tc::fence_acc(acc);
  }
  cp_async_wait<0>();  // no copy lands after the block is gone
  float* P = part + ((long)blockIdx.x * 3 + k) * C * C;
#pragma unroll
  for (int i = 0; i < 64; i += 2)
    *reinterpret_cast<float2*>(P + (64 * wg + tc::acc_row(i)) * C + tc::acc_col(i)) =
        make_float2(acc[i], acc[i + 1]);
}

template <typename T>
int launch_bwd(const T* pd, const T* qd, const T* ps, const T* cs, const T* g, const float* bd,
               const T* kdo, const float* gdow, const float* gdob, const T* k1, const float* gchw,
               const float* gchb, const T* kout, const int* eu, const int* ev, const int* spos,
               const long long* dseg, const long long* sseg, const int* count, T* rows, T* act,
               float* part, float* grads, T* out_d, T* out_s, long slots, int nd, int ns,
               int blocks, int splits, float eps, cudaStream_t stream) {
  T* rows_d = rows;
  T* rows_s = rows + slots * 2 * C;
  cudaError_t e;
  if constexpr (std::is_same<T, bf16>::value) {
    int smem = bwd_tc_smem();
    e = set_smem((const void*)win_edge_bwd_tc_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    win_edge_bwd_tc_kernel<<<blocks, WE_THREADS, smem, stream>>>(
        pd, qd, ps, cs, g, bd, kdo, gdow, gdob, k1, gchw, gchb, kout, eu, ev, spos, count, rows_d,
        rows_s, act, part, eps);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    float* part_w = part + (long)blocks * 5 * C;
    smem = DW_STAGES * 2 * TB;
    e = set_smem((const void*)win_edge_dw_tc_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    win_edge_dw_tc_kernel<<<dim3(splits, 3), NT, smem, stream>>>(act, rows_d, g, eu, count,
                                                                  part_w);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    e = reduce_partials(part_w, grads, splits, 3 * C * C, stream);
    if (e != cudaSuccess) return (int)e;
    e = reduce_partials(part, grads + 3 * C * C, blocks, 5 * C, stream);
  } else {
    const int smem = (4 * TE * LDA + C * C + 2 * TE) * (int)sizeof(float) +
                     3 * TE * (int)sizeof(int);
    e = set_smem((const void*)win_edge_bwd_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    win_edge_bwd_kernel<<<blocks, NT, smem, stream>>>(pd, qd, ps, cs, g, bd, kdo, gdow, gdob, k1,
                                                      gchw, gchb, kout, eu, ev, spos, count,
                                                      rows_d, rows_s, part, eps);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    e = reduce_partials(part, grads, blocks, WE_PART, stream);
  }
  if (e != cudaSuccess) return (int)e;
  // dPd | dQd and dPs | dCs: each row's edges in destination / source order.
  const int err = launch_segment_sum<T, T>(rows_d, dseg, nullptr, out_d, slots, nd, 2 * C, stream);
  if (err != 0) return err;
  return launch_segment_sum<T, T>(rows_s, sseg, nullptr, out_s, slots, ns, 2 * C, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (pd, qd, ps, cs, temp, kdo, k1, kout, out);
// bd and the GN vectors fp32 [128]; idx int32 [nc*chunk, icol] (lu, lv, ...);
// meta int32 [6, nc] (dwin, swin, first, ...); acc fp32 [nd, 128], holding
// temp for every window a run touches on exit; out is written from acc when
// write_out is 1 (pass acc itself as out with write_out 0 for float32).
extern "C" int win_edge_fwd(const void* pd, const void* qd, const void* ps, const void* cs,
                            const void* temp, const void* bd, const void* kdo,
                            const void* gdow, const void* gdob, const void* k1,
                            const void* gchw, const void* gchb, const void* kout,
                            const void* idx, const void* meta, void* acc, void* out,
                            int write_out, int nc, int chunk, int sd, int ss, int icol, int nd,
                            int ns, float eps, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float *b = (const float*)bd, *g0 = (const float*)gdow, *g1 = (const float*)gdob,
              *g2 = (const float*)gchw, *g3 = (const float*)gchb;
  if (dtype == 0)
    return launch<float>(pd, qd, ps, cs, temp, b, kdo, g0, g1, k1, g2, g3, kout,
                         (const int*)idx, (const int*)meta, (float*)acc, out, write_out, nc,
                         chunk, sd, ss, icol, nd, ns, eps, st);
  if (dtype == 1)
    return launch<bf16>(pd, qd, ps, cs, temp, b, kdo, g0, g1, k1, g2, g3, kout,
                        (const int*)idx, (const int*)meta, (float*)acc, out, write_out, nc,
                        chunk, sd, ss, icol, nd, ns, eps, st);
  return (int)cudaErrorInvalidValue;
}

// Backward. g: the output cotangent in pd's dtype. The plan prepared by
// ops/win_edge.py `prepare_pair` over its `slots` slots: eu, ev int32, the
// valid edges' destination and source rows in destination order; spos int32,
// each one's position in source order; dseg / sseg int64, the destination
// rows in destination order and the source rows in source order (nd / ns
// past the edges); count int32 [1], the edges E. Workspaces: rows [2, slots,
// 2C] in pd's dtype; act [slots, 4C] (bf16 only); part fp32: bf16
// blocks*5C + splits*3*C*C, fp32 blocks*(3*C*C + 5*C). grads fp32
// [3*C*C + 5*C] = dWdo, dK1, dWout (in, out), dbd, dgdow, dgdob, dgchw,
// dgchb. out_d [nd, 2C] = dPd | dQd and out_s [ns, 2C] = dPs | dCs, in pd's
// dtype (zero on rows no edge touches). blocks: the chain pass's blocks
// (one per SM); splits: the bf16 weight-gradient pass's splits.
extern "C" int win_edge_bwd(const void* pd, const void* qd, const void* ps, const void* cs,
                            const void* g, const void* bd, const void* kdo, const void* gdow,
                            const void* gdob, const void* k1, const void* gchw,
                            const void* gchb, const void* kout, const void* eu, const void* ev,
                            const void* spos, const void* dseg, const void* sseg,
                            const void* count, void* rows, void* act, void* part, void* grads,
                            void* out_d, void* out_s, long long slots, int nd, int ns,
                            int blocks, int splits, float eps, int dtype, void* stream) {
  if (slots < 0 || nd < 0 || ns < 0 || blocks < 1 || splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float *b = (const float*)bd, *g0 = (const float*)gdow, *g1 = (const float*)gdob,
              *g2 = (const float*)gchw, *g3 = (const float*)gchb;
  const int *u = (const int*)eu, *v = (const int*)ev, *sp = (const int*)spos,
            *n = (const int*)count;
  const long long *ds = (const long long*)dseg, *ss = (const long long*)sseg;
  float *pt = (float*)part, *gr = (float*)grads;
  if (dtype == 0)
    return launch_bwd<float>((const float*)pd, (const float*)qd, (const float*)ps,
                             (const float*)cs, (const float*)g, b, (const float*)kdo, g0, g1,
                             (const float*)k1, g2, g3, (const float*)kout, u, v, sp, ds, ss, n,
                             (float*)rows, nullptr, pt, gr, (float*)out_d, (float*)out_s, slots,
                             nd, ns, blocks, splits, eps, st);
  if (dtype == 1)
    return launch_bwd<bf16>((const bf16*)pd, (const bf16*)qd, (const bf16*)ps, (const bf16*)cs,
                            (const bf16*)g, b, (const bf16*)kdo, g0, g1, (const bf16*)k1, g2, g3,
                            (const bf16*)kout, u, v, sp, ds, ss, n, (bf16*)rows, (bf16*)act, pt,
                            gr, (bf16*)out_d, (bf16*)out_s, slots, nd, ns, blocks, splits, eps,
                            st);
  return (int)cudaErrorInvalidValue;
}
