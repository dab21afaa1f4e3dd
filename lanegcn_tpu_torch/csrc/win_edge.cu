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
//   out[u] = temp[u] + Σ e1 @ Wout         (fp32 sum, rounded once)
//
// with u = dw*sd + lu, v = sw*ss + lv; a slot is an edge when lu and lv lie
// in their windows and u, v in the arrays (padding slots, lu = -1, do not).
//
// What bounds it: three [E x 128] x [128 x 128] products per valid edge
// (0.8 GFLOP at A2M's ~21k edges of the 256-scenario pack) against temp read
// and out written whole (~107 MB at A2M's 208,896 rows, bf16) and Pd/Qd/
// Ps/Cs at the rows the edges gather: bytes, at the card's rates. The TPU
// kernel walked one destination window's chunks in order and kept the
// window in VMEM; ported that way (one block per destination-window run,
// the chain on CUDA cores) M2A and A2A gave 32 of the card's 132 SMs work.
// Here the forward takes no preparation (serving makes none) and runs two
// passes over the plan as the packer lays it out:
//   1. the chain over the plan's own 64-slot tiles, the tiles dealt out in
//      turn to every warpgroup of a persistent grid (whatever the window
//      count) and tiles without an edge skipped: t1 gathered into shared
//      memory, z = t1 @ Wdo on wgmma, t2 and e1 made on the accumulators
//      in registers and fed back as register-A fragments of s = t2 @ K1
//      and e2 = e1 @ Wout (bf16: win_edge_fwd_tc_kernel, sharing the
//      chain's helpers with the backward's recompute; fp32, the parity
//      path: edge_chain.cuh's chain_fwd on CUDA cores). Each edge's fp32 e2
//      row goes to its slot of a workspace [slots, 128]: written once, no
//      atomics.
//   2. win_edge_sum_kernel: a block per 32 destination rows of a window
//      (items of a persistent grid) finds the window's chunks by a search
//      in dwin (non-decreasing: the packer sorts chunks by (dwin, swin) and
//      parks its idle tail chunks on the last window), walks their slots
//      in slot order, and adds each edge's row into its destination row,
//      from temp, in fp32; each row is written once, rounded once. Rows no
//      edge reaches come out as temp. A row's edges add in slot order, the
//      order of the plain version's index_add_: reruns are bitwise equal.
//
// Width: the forward also runs on W = 64-wide rows (the fusion stages where
// n_map = n_actor = 64), its three kernels templated on W by the padded
// route of common.cuh: Pd/Qd/Ps/Cs/temp rows read W wide (zeros past W), bd
// and the GN affines zero past W, Wdo, K1 and Wout zero-padded to 128 x 128
// in shared memory (edge_tc.cuh's chain helpers at W, as edge_mlp.cu's Att
// chain), GN statistics over W, the e2 workspace [slots, W], the sum pass's
// lanes past W idle, only W columns stored. The wgmma products keep
// m64n128k16 with K cut to W. At W = 128 each kernel compiles to the code
// it was before the width existed. The backward's passes take W = 64 the
// same way (below).
//
#include <type_traits>

#include "edge_chain.cuh"
#include "edge_tc.cuh"
#include "segment_sum.cuh"

using namespace lgk;

namespace {

constexpr int TE = 64;                   // edges (plan slots) per tile
constexpr int WB = tc::tiles_bytes(C);   // a [128 x 128] weight's core tiles
constexpr int TB = tc::tiles_bytes(TE);  // a [TE x 128] edge tile's

// Plan slot `slot`: whether it is an edge, and its global rows (meta: dwin,
// swin, ... over the nc chunks).
__device__ __forceinline__ bool slot_rows(const int* idx, const int* meta, long slot, int nc,
                                          int chunk, int icol, int sd, int ss, int nd, int ns,
                                          int* u, int* v) {
  const long k = slot / chunk;
  const int lu = idx[slot * icol], lv = idx[slot * icol + 1];
  const long gu = (long)meta[k] * sd + lu, gv = (long)meta[nc + k] * ss + lv;
  *u = (int)gu;
  *v = (int)gv;
  return lu >= 0 && lu < sd && lv >= 0 && lv < ss && gu < nd && gv < ns;
}

// t1 = rnd(relu(Pd[u] + Ps[v] + bd)) for the tile's edges into A_s (0 where
// lu_s is -1, and past a row width W below C); lu_s / lv_s hold rows
// relative to base_d / base_s.
template <typename T, int W = C>
__device__ __forceinline__ void gather_t1(float* A_s, const int* lu_s, const int* lv_s,
                                          const T* pd, const T* ps, const float* bd,
                                          long base_d, long base_s) {
  for (int i = threadIdx.x; i < TE * (C / 4); i += NT) {
    const int r = i / (C / 4), c4 = (i % (C / 4)) * 4;
    float4 t = zero4();
    if (lu_s[r] >= 0 && (W == C || c4 < W)) {
      const float4 a = load4<T>(pd + (base_d + lu_s[r]) * W + c4);
      const float4 b = load4<T>(ps + (base_s + lv_s[r]) * W + c4);
      t = rnd4<T>(relu4(add4(add4(a, b), *reinterpret_cast<const float4*>(bd + c4))));
    }
    *reinterpret_cast<float4*>(A_s + r * LDA + c4) = t;
  }
}

// --- the bf16 chain's t1, shared by the forward and the backward (the
// chain's other pieces: edge_tc.cuh) --------------------------------------

// rnd(relu(Pd[u] + Ps[v] + bd)) of 8 channels: 16 bytes of a Pd row and of a
// Ps row, bd at the same channels.
__device__ __forceinline__ uint4 t1_pack8(const bf16* pd_row, const bf16* ps_row,
                                          const float* bd) {
  const uint4 a = *reinterpret_cast<const uint4*>(pd_row);
  const uint4 b = *reinterpret_cast<const uint4*>(ps_row);
  const uint32_t* ap = &a.x;
  const uint32_t* bp = &b.x;
  uint4 o;
  uint32_t* op = &o.x;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 x = unpack_bf2(ap[q]), y = unpack_bf2(bp[q]);
    op[q] = tc::pack_bf2(fmaxf(x.x + y.x + bd[2 * q], 0.f), fmaxf(x.y + y.y + bd[2 * q + 1], 0.f));
  }
  return o;
}

// --- the forward's chain pass --------------------------------------------

// fp32 (the parity path): edge_chain.cuh's chain_fwd on CUDA cores. Block b
// takes the plan's 64-slot tiles b, b + B, ..., skips a tile without an
// edge, and writes each edge's e2 row at its slot of ws ([slots, W]).
template <int W>
__global__ void __launch_bounds__(NT)
win_edge_fwd_kernel(const float* __restrict__ pd, const float* __restrict__ qd,
                    const float* __restrict__ ps, const float* __restrict__ cs,
                    const float* __restrict__ bd, const float* __restrict__ kdo,
                    const float* __restrict__ gdow, const float* __restrict__ gdob,
                    const float* __restrict__ k1, const float* __restrict__ gchw,
                    const float* __restrict__ gchb, const float* __restrict__ kout,
                    const int* __restrict__ idx, const int* __restrict__ meta,
                    float* __restrict__ ws, int nc, int chunk, int icol, int sd, int ss, int nd,
                    int ns, float eps) {
  extern __shared__ float4 smem4[];
  float* A_s = reinterpret_cast<float*>(smem4);       // [TE][LDA]
  float* W_s = A_s + TE * LDA;                        // [C][C]
  int* lu_s = reinterpret_cast<int*>(W_s + C * C);    // the tile's global rows (-1: no edge)
  int* lv_s = lu_s + TE;
  const long slots = (long)nc * chunk, ntiles = (slots + TE - 1) / TE;
  const Chain<float> w{kdo, gdow, gdob, k1, gchw, gchb, kout, eps};
  const int lane = threadIdx.x & 31;
  float mm[4][8];
  for (long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    __syncthreads();  // the previous tile is done with the rows and the tiles
    int ok = 0;
    if (threadIdx.x < TE) {
      const long p = t * TE + threadIdx.x;
      int u = -1, v = -1;
      ok = p < slots && slot_rows(idx, meta, p, nc, chunk, icol, sd, ss, nd, ns, &u, &v);
      lu_s[threadIdx.x] = ok ? u : -1;
      lv_s[threadIdx.x] = ok ? v : -1;
    }
    if (!__syncthreads_or(ok)) continue;
    gather_t1<float, W>(A_s, lu_s, lv_s, pd, ps, bd, 0, 0);
    chain_fwd<float, true, W>(A_s, W_s, w,
                              [&](int r, float4 s) {  // s += Cs[v] + Qd[u]
                                if (lu_s[r] >= 0 && lane_in<W>()) {
                                  s = add4(s, load4<float>(cs + (long)lv_s[r] * W + lane * 4));
                                  s = add4(s, load4<float>(qd + (long)lu_s[r] * W + lane * 4));
                                }
                                return s;
                              },
                              mm);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = mm_row(i);
      if (lu_s[r] >= 0) {
        float* row = ws + (t * TE + r) * W;
        *reinterpret_cast<float4*>(row + mm_col(0)) =
            make_float4(mm[i][0], mm[i][1], mm[i][2], mm[i][3]);
        if (W == C)  // mm_col(4) ≥ 64
          *reinterpret_cast<float4*>(row + mm_col(4)) =
              make_float4(mm[i][4], mm[i][5], mm[i][6], mm[i][7]);
      }
    }
  }
}

// bf16 (the path that serves and trains): the chain on wgmma. A block of
// FW_WGS warpgroups holds the three weights once as core tiles; warpgroup g
// of block b takes tiles b·FW_WGS + g, then every FW_WGS·B-th one, each with
// its own t1 tile and barrier, so the warpgroups never wait for each other.
// Per tile: the slots' rows (a ballot skips a tile without an edge), t1
// gathered by 16-byte loads into core tiles, z = t1 @ Wdo from shared
// memory, then t2 and e1 straight from the accumulators as register-A
// fragments of t2 @ K1 and e1 @ Wout; e2's fp32 rows to ws.
constexpr int FW_WGS = 3;
constexpr int FW_THREADS = 128 * FW_WGS;

inline int fwd_tc_smem() {
  return 3 * WB + FW_WGS * TB + 5 * C * (int)sizeof(float) +
         FW_WGS * (2 * TE + 2) * (int)sizeof(int);
}

template <int W>
__global__ void __launch_bounds__(FW_THREADS, 1)
win_edge_fwd_tc_kernel(const bf16* __restrict__ pd, const bf16* __restrict__ qd,
                       const bf16* __restrict__ ps, const bf16* __restrict__ cs,
                       const float* __restrict__ bd, const bf16* __restrict__ kdo,
                       const float* __restrict__ gdow, const float* __restrict__ gdob,
                       const bf16* __restrict__ k1, const float* __restrict__ gchw,
                       const float* __restrict__ gchb, const bf16* __restrict__ kout,
                       const int* __restrict__ idx, const int* __restrict__ meta,
                       float* __restrict__ ws, int nc, int chunk, int icol, int sd, int ss,
                       int nd, int ns, float eps) {
  extern __shared__ float4 smem4[];
  uint8_t* W_b = reinterpret_cast<uint8_t*>(smem4);                 // Wdo | K1 | Wout
  uint8_t* T_b = W_b + 3 * WB;                                      // [FW_WGS] t1 tiles
  float* vec_s = reinterpret_cast<float*>(T_b + FW_WGS * TB);       // bd, gdow, gdob, gchw, gchb
  int* row_s = reinterpret_cast<int*>(vec_s + 5 * C);               // [FW_WGS][u, v][TE]
  int* any_s = row_s + FW_WGS * 2 * TE;                             // [FW_WGS][2]
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const tc::Tiles Wdo = tc::tiles(W_b, C), K1 = tc::tiles(W_b + WB, C),
                  Wout = tc::tiles(W_b + 2 * WB, C);
  uint8_t* T1_b = T_b + wg * TB;
  const tc::Tiles T1 = tc::tiles(T1_b, TE);
  int* U_s = row_s + wg * 2 * TE;
  int* V_s = U_s + TE;
  int* F_s = any_s + 2 * wg;  // whether each half of the tile holds an edge
  const float* bd_s = vec_s;
  const float* gdow_s = vec_s + C;
  const float* gdob_s = vec_s + 2 * C;
  const float* gchw_s = vec_s + 3 * C;
  const float* gchb_s = vec_s + 4 * C;

  load_chain_weights<W>(W_b, kdo, k1, kout, FW_THREADS);
  for (int i = threadIdx.x; i < 5 * C; i += FW_THREADS) {
    const float* v = i < C ? bd : i < 2 * C ? gdow : i < 3 * C ? gdob : i < 4 * C ? gchw : gchb;
    vec_s[i] = W == C || (i & (C - 1)) < W ? v[i & (C - 1)] : 0.f;
  }
  cp_async_wait<0>();
  tc::fence_smem();
  __syncthreads();  // the weights and vectors in place

  const long slots = (long)nc * chunk, ntiles = (slots + TE - 1) / TE;
  const int r0 = tc::acc_row(0);  // this thread's rows of a tile: r0 and r0 + 8
  for (long t = (long)blockIdx.x * FW_WGS + wg; t < ntiles; t += (long)gridDim.x * FW_WGS) {
    wg_sync();  // the warpgroup is done with the previous tile's rows, flags and t1
    if (tid < TE) {
      const long p = t * TE + tid;
      int u = -1, v = -1;
      const bool ok = p < slots && slot_rows(idx, meta, p, nc, chunk, icol, sd, ss, nd, ns, &u, &v);
      U_s[tid] = ok ? u : -1;
      V_s[tid] = ok ? v : -1;
      const unsigned any = __ballot_sync(0xffffffffu, ok);
      if ((tid & 31) == 0) F_s[tid >> 5] = any != 0u;
    }
    wg_sync();
    if (!(F_s[0] | F_s[1])) continue;  // no edge in the tile (the same for the warpgroup)
    // t1 into T1: 8 neighbouring threads fill one core matrix (8 rows, 16 bytes).
#pragma unroll
    for (int k = 0; k < TE * C / 8 / 128; ++k) {
      const int r = 8 * k + (tid & 7), c = (tid >> 3) * 8;
      const int u = U_s[r];
      const uint4 o = u >= 0 && (W == C || c < W)
                          ? t1_pack8(pd + (long)u * W + c, ps + (long)V_s[r] * W + c, bd_s + c)
                          : make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(T1_b + tc::tile_off(T1, r, c)) = o;
    }
    tc::fence_smem();
    wg_sync();  // t1 in place

    const int ua = U_s[r0], ub = U_s[r0 + 8];
    const bool ok[2] = {ua >= 0, ub >= 0};
    const int uu[2] = {ua, ub}, vv[2] = {V_s[r0], V_s[r0 + 8]};
    float acc[64], mu[2], inv[2];
    uint32_t a[32];
    tc::zero(acc);  // z = t1 @ Wdo
    tc::fence_acc(acc);
    tc::fence();
    tc::mm<W / 16, true, false>(acc, T1, 0, Wdo);
    tc::commit();
    tc::wait_all();
    tc::fence_acc(acc);
    t2_from_z<W>(acc, gdow_s, gdob_s, eps, mu, inv, a);
    tc::zero(acc);  // s = t2 @ K1
    mm_frag<false, W>(acc, a, K1);
    e1_from_s<W>(acc, add_cq<W>(ok, uu, vv, cs, qd), gchw_s, gchb_s, eps, inv, a);
    tc::zero(acc);  // e2 = e1 @ Wout
    mm_frag<false, W>(acc, a, Wout);
    float* row[2] = {ws + (t * TE + r0) * W, ws + (t * TE + r0 + 8) * W};
#pragma unroll
    for (int i = 0; i < W / 2; i += 2) {
      const int h = tc::acc_half(i);
      if (ok[h])
        *reinterpret_cast<float2*>(row[h] + tc::acc_col(i)) = make_float2(acc[i], acc[i + 1]);
    }
  }
}

// --- the forward's sum pass -----------------------------------------------

constexpr int SUM_ROWS = 32;     // destination rows of an item: 4 a warp
constexpr int SUM_STAGE = 1024;  // plan slots staged at a time: 4 a thread

// out[u] = rnd(temp[u] + Σ ws[slot] over u's edges in slot order). Item i of
// the ⌈nd / sd⌉·⌈sd / SUM_ROWS⌉ items is rows 32j .. 32j + 31 of window w
// (i = w·⌈sd / SUM_ROWS⌉ + j); block b takes items b, b + B, .... The window's
// chunks [k0, k1) are found by two warp searches in dwin, and their slots
// are staged SUM_STAGE at a time as each slot's row within the item (-1: no
// edge, or an edge into another item's rows). Warp w owns the item's rows
// 4w .. 4w + 3 (lane: 4 channels, kept in registers), scans the staged rows
// 32 at a time by ballot and adds its hits in slot order, loading up to
// four hits' rows before adding them. Rows W wide: lanes past W carry no
// channel (they still vote in the ballots).
template <typename T, int W>
__global__ void __launch_bounds__(NT)
win_edge_sum_kernel(const float* __restrict__ ws, const T* __restrict__ temp,
                    const int* __restrict__ idx, const int* __restrict__ meta,
                    T* __restrict__ out, int nc, int chunk, int icol, int sd, int ss, int nd,
                    int ns) {
  __shared__ signed char row_s[SUM_STAGE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_win = (sd + SUM_ROWS - 1) / SUM_ROWS;
  const long items = (long)((nd + sd - 1) / sd) * per_win;
  for (long it = blockIdx.x; it < items; it += gridDim.x) {
    const int w = (int)(it / per_win), r_lo = (int)(it % per_win) * SUM_ROWS;
    const long g0 = (long)w * sd + r_lo;  // the item's first row
    const int rows = (int)min((long)min(SUM_ROWS, sd - r_lo), (long)nd - g0);
    if (rows <= 0) continue;  // past the last row (the same for the block)
    float4 acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 4 * warp + j;
      acc[j] = r < rows && lane_in<W>() ? load4<T>(temp + (g0 + r) * W + lane * 4) : zero4();
    }
    const long s_lo = seg::warp_lower_bound(meta, nc, w) * chunk;
    const long s_hi = seg::warp_lower_bound(meta, nc, w + 1) * chunk;
    for (long s0 = s_lo; s0 < s_hi; s0 += SUM_STAGE) {
      __syncthreads();  // every warp is done with the previous stage
      for (int q = threadIdx.x; q < SUM_STAGE; q += NT) {
        const long p = s0 + q;
        int u, v, r = -1;
        if (p < s_hi && slot_rows(idx, meta, p, nc, chunk, icol, sd, ss, nd, ns, &u, &v) &&
            u >= g0 && u < g0 + rows)
          r = (int)(u - g0);
        row_s[q] = (signed char)r;
      }
      __syncthreads();
      const int staged = (int)min((long)SUM_STAGE, s_hi - s0);
      for (int q0 = 0; q0 < staged; q0 += 32) {
        const int r = row_s[q0 + lane];
        unsigned hits = __ballot_sync(0xffffffffu, r >= 0 && (r >> 2) == warp);
        while (hits) {
          int b[4];
          float4 x[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            b[j] = hits ? __ffs(hits) - 1 : -1;
            hits &= hits - 1u;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (b[j] >= 0 && lane_in<W>())
              x[j] = *reinterpret_cast<const float4*>(ws + (s0 + q0 + b[j]) * W + lane * 4);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (b[j] < 0 || !lane_in<W>()) continue;
            const int rr = row_s[q0 + b[j]] & 3;
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if (k == rr) acc[k] = add4(acc[k], x[j]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 4 * warp + j;
      if (r < rows && lane_in<W>()) store4<T>(out + (g0 + r) * W + lane * 4, acc[j]);
    }
  }
}

template <typename T, int W>
int launch_fwd(const T* pd, const T* qd, const T* ps, const T* cs, const T* temp,
               const float* bd, const T* kdo, const float* gdow, const float* gdob, const T* k1,
               const float* gchw, const float* gchb, const T* kout, const int* idx,
               const int* meta, float* ws, T* out, int nc, int chunk, int sd, int ss, int icol,
               int nd, int ns, int blocks, float eps, cudaStream_t stream) {
  cudaError_t e;
  if (nc > 0) {
    if constexpr (std::is_same<T, bf16>::value) {
      const int smem = fwd_tc_smem();
      e = set_smem((const void*)win_edge_fwd_tc_kernel<W>, smem);
      if (e != cudaSuccess) return (int)e;
      win_edge_fwd_tc_kernel<W><<<blocks, FW_THREADS, smem, stream>>>(
          pd, qd, ps, cs, bd, kdo, gdow, gdob, k1, gchw, gchb, kout, idx, meta, ws, nc, chunk,
          icol, sd, ss, nd, ns, eps);
    } else {
      const int smem = (TE * LDA + C * C) * (int)sizeof(float) + 2 * TE * (int)sizeof(int);
      e = set_smem((const void*)win_edge_fwd_kernel<W>, smem);
      if (e != cudaSuccess) return (int)e;
      win_edge_fwd_kernel<W><<<2 * blocks, NT, smem, stream>>>(
          pd, qd, ps, cs, bd, kdo, gdow, gdob, k1, gchw, gchb, kout, idx, meta, ws, nc, chunk,
          icol, sd, ss, nd, ns, eps);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const long items = (long)((nd + sd - 1) / sd) * ((sd + SUM_ROWS - 1) / SUM_ROWS);
  const long grid = items < 8L * blocks ? items : 8L * blocks;  // 8 blocks an SM
  if (grid > 0)
    win_edge_sum_kernel<T, W><<<(unsigned)grid, NT, 0, stream>>>(ws, temp, idx, meta, out, nc,
                                                                 chunk, icol, sd, ss, nd, ns);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
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
//
// Width: every pass also runs on W = 64-wide rows (the fusion stages where
// n_map = n_actor = 64), templated on W by the padded route of common.cuh
// as the forward: Pd/Qd/Ps/Cs/g rows read W wide into the same 128-column
// tiles (zeros past W), Wdo, K1 and Wout zero-padded to 128 x 128 in shared
// memory, bd and the GN affines zero past W, GN statistics over W, K cut to
// W on wgmma (N kept at 128: the padded columns come out zero); the per-edge
// rows [slots, 2W] and act [slots, 4W] hold W columns a part, the weight
// gradients are W x W (edge_tc.cuh dw_tc<W>, edge_chain.cuh chain_bwd<., W>)
// and the vectors W wide. At W = 128 each kernel compiles to the code it
// was before the width existed.

// A block's fp32 partial at width W (the fp32 pass): dWdo, dK1, dWout, dbd,
// dgdow, dgdob, dgchw, dgchb.
template <int W = C>
__host__ __device__ constexpr int we_part() { return 3 * W * W + 5 * W; }

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
// rnd(d_t1p) | rnd(d_s) at each edge's destination / source position
// ([slots, 2W] rows; lanes past W store nothing).
template <int W>
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
  float* P = part + (long)blockIdx.x * we_part<W>();
  for (int i = threadIdx.x; i < 3 * W * W; i += NT) P[i] = 0.f;
  const Chain<float> w{kdo, gdow, gdob, k1, gchw, gchb, kout, eps};
  const int lane = threadIdx.x & 31;
  const bool in_w = lane_in<W>();  // the lane's columns lie in the row
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
      if (!in_w) return;
      store4<float>(rows_d + (p0 + r) * 2 * W + col + lane * 4, x);
      store4<float>(rows_s + (long)sp_s[r] * 2 * W + col + lane * 4, x);
    };
    chain_bwd<float, W>(
        A_s, B_s, C_s, D_s, W_s, st_s, P, vecs, w,
        [&](float* X_s) { gather_t1<float, W>(X_s, lu_s, lv_s, pd, ps, bd, 0, 0); },
        [&](int r, float4 sv) {  // s += Cs[v] + Qd[u]
          if (lu_s[r] >= 0 && in_w) {
            sv = add4(sv, load4<float>(cs + (long)lv_s[r] * W + lane * 4));
            sv = add4(sv, load4<float>(qd + (long)lu_s[r] * W + lane * 4));
          }
          return sv;
        },
        [&](int r) {  // d_e2 = g[u]
          return lu_s[r] >= 0 && in_w ? load4<float>(g + (long)lu_s[r] * W + lane * 4) : zero4();
        },
        [&](int r) { return lu_s[r] >= 0; }, [&](int r, float4 ds) { store(r, W, ds); }, []() {},
        [&](int r, float4 d1) { store(r, 0, d1); }, []() {});
  }
  reduce_warp_vecs<5, W>(vecs, B_s, P + 3 * W * W);
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
// `act` at its destination position. At W = 64 the tiles keep 128 columns
// (zeros past W) and only W columns of each row are stored.
constexpr int WE_WGS = 2;
constexpr int WE_THREADS = 128 * WE_WGS;

inline int bwd_tc_smem() {
  return 3 * WB + WE_WGS * 3 * TB + 5 * C * (int)sizeof(float) +
         WE_WGS * 3 * TE * (int)sizeof(int);
}

template <int W>
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
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
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

  load_chain_weights<W>(W_b, kdo, k1, kout, WE_THREADS);
  for (int i = threadIdx.x; i < 5 * C; i += WE_THREADS) {
    const float* v = i < C ? bd : i < 2 * C ? gdow : i < 3 * C ? gdob : i < 4 * C ? gchw : gchb;
    vec_s[i] = W == C || (i & (C - 1)) < W ? v[i & (C - 1)] : 0.f;
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
      const bool in = u >= 0 && (W == C || c < W);
      const uint32_t off = tc::tile_off(T1, r, c);  // the same in every edge tile
      cp_async16_zfill(Y_b + off, in ? g + (long)u * W + c : g, in ? 16 : 0);
      uint4 o = make_uint4(0u, 0u, 0u, 0u);
      if (in) {
        o = t1_pack8(pd + (long)u * W + c, ps + (long)v * W + c, bd_s + c);
        *reinterpret_cast<uint4*>(act + (p0 + r) * 4 * W + c) = o;
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
    bf16* act_r[2] = {act + (p0 + r0) * 4 * W, act + (p0 + r0 + 8) * 4 * W};
    bf16* rd_r[2] = {rows_d + (p0 + r0) * 2 * W, rows_d + (p0 + r0 + 8) * 2 * W};
    bf16* rs_r[2] = {rows_s + (long)sa * 2 * W, rows_s + (long)sb * 2 * W};
    // Accumulator element pairs i < W / 2 hold the row's W columns.
    auto in_row = [](int i) { return W == C || i < W / 2; };

    // z = t1 @ Wdo; t2 = rnd(relu(GN_do(z))) into X and act.
    float acc[64], acc2[64];
    tc::zero(acc);
    tc::fence_acc(acc);
    tc::fence();
    tc::mm<W / 16, true, false>(acc, T1, 0, Wdo);
    tc::commit();
    tc::wait_all();
    tc::fence_acc(acc);
    float muz[2], invz[2];
    uint32_t d2[32];
    t2_from_z<W>(acc, gdow_s, gdob_s, eps, muz, invz, d2);  // t2
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int h = tc::acc_half(i), c = tc::acc_col(i);
      *reinterpret_cast<uint32_t*>(X_b + tc::tile_off(X, r0 + 8 * h, c)) = d2[i / 2];
      if (ok[h] && in_row(i)) *reinterpret_cast<uint32_t*>(act_r[h] + W + c) = d2[i / 2];
    }
    tc::fence_smem();
    wg_sync();  // t2 in place

    // s = t2 @ K1 beside d_e1 = g[u] @ Woutᵀ.
    tc::zero(acc);
    tc::zero(acc2);
    tc::fence_acc(acc);
    tc::fence_acc(acc2);
    tc::fence();
    tc::mm<W / 16, true, false>(acc, X, 0, K1);
    tc::mm<W / 16, true, true>(acc2, Y, 0, Wout);
    tc::commit();
    tc::wait_all();
    tc::fence_acc(acc);
    tc::fence_acc(acc2);
    // s += Cs[v] + Qd[u]; acc ← nrm_s; e1 = rnd(relu(nrm_s ⊙ gchw + gchb)) to
    // act; acc2 ← d_gn_s = d_e1 ⊙ [e1 > 0] (0 past the edges).
    float invs[2];
    e1_from_s<W>(acc, add_cq<W>(ok, uu, vv, cs, qd), gchw_s, gchb_s, eps, invs, d2);
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int h = tc::acc_half(i), c = tc::acc_col(i);
      if (ok[h] && in_row(i)) *reinterpret_cast<uint32_t*>(act_r[h] + 2 * W + c) = d2[i / 2];
      const float2 ef = unpack_bf2(d2[i / 2]);
      acc2[i] = ok[h] && ef.x > 0.f ? acc2[i] : 0.f;
      acc2[i + 1] = ok[h] && ef.y > 0.f ? acc2[i + 1] : 0.f;
    }
    col_sums<true>(va[3], acc2, acc);
    col_sums<false>(va[4], acc2, acc2);
    gn_bwd_acc<W>(acc2, acc, invs, gchw_s, d2);  // rnd(d_s)
    wg_sync();  // every warp's products are done with X (t2)
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int h = tc::acc_half(i), c = tc::acc_col(i);
      *reinterpret_cast<uint32_t*>(X_b + tc::tile_off(X, r0 + 8 * h, c)) = d2[i / 2];
      if (ok[h] && in_row(i)) {
        *reinterpret_cast<uint32_t*>(rd_r[h] + W + c) = d2[i / 2];
        *reinterpret_cast<uint32_t*>(rs_r[h] + W + c) = d2[i / 2];
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
    tc::mm<W / 16, true, true>(acc, X, 0, K1);
    tc::mm<W / 16, true, false>(acc2, T1, 0, Wdo);
    tc::commit();
    tc::wait_all();
    tc::fence_acc(acc);
    tc::fence_acc(acc2);
    // acc2 ← nrm_z; acc ← d_gn_z = d_t2 ⊙ [t2 > 0]; d2 ← rnd(d_z).
    gn_do_bwd<W>(acc, acc2, muz, invz, ok, gdow_s, gdob_s, va[1], va[2], d2);
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int h = tc::acc_half(i), c = tc::acc_col(i);
      *reinterpret_cast<uint32_t*>(Y_b + tc::tile_off(Y, r0 + 8 * h, c)) = d2[i / 2];
      if (ok[h] && in_row(i)) *reinterpret_cast<uint32_t*>(act_r[h] + 3 * W + c) = d2[i / 2];
    }
    tc::fence_smem();
    wg_sync();  // rnd(d_z) in place (g[u]'s product finished before the last barrier)

    // d_t1 = rnd(d_z) @ Wdoᵀ; d_t1p = d_t1 ⊙ [t1 > 0].
    tc::zero(acc);
    tc::fence_acc(acc);
    tc::fence();
    tc::mm<W / 16, true, true>(acc, Y, 0, Wdo);
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
      if (ok[h] && in_row(i)) {
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
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      red_s[(warp * 5 + k) * C + col_sum_col(j)] = va[k][j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 5 * W; i += WE_THREADS) {  // [5][W]: the row's columns
    const int at = W == C ? i : (i / W) * C + i % W;
    float s = 0.f;
    for (int w = 0; w < WE_THREADS / 32; ++w) s += red_s[w * 5 * C + at];
    part_v[(long)blockIdx.x * 5 * W + i] = s;
  }
}

// The bf16 weight gradients (edge_tc.cuh dw_tc): the operands at each
// edge's destination position, rnd(d_s) in the second half of rows_d's,
// the cotangent at the edge's destination row; W-wide rows, W x W partials.
template <int W>
__global__ void __launch_bounds__(NT)
win_edge_dw_tc_kernel(const bf16* __restrict__ act, const bf16* __restrict__ rows_d,
                      const bf16* __restrict__ g, const int* __restrict__ eu,
                      const int* __restrict__ count, float* __restrict__ part) {
  dw_tc<W>(act, rows_d + W, 2 * W, g, eu, *count, part);
}

template <typename T, int W>
int launch_bwd(const T* pd, const T* qd, const T* ps, const T* cs, const T* g, const float* bd,
               const T* kdo, const float* gdow, const float* gdob, const T* k1, const float* gchw,
               const float* gchb, const T* kout, const int* eu, const int* ev, const int* spos,
               const long long* dseg, const long long* sseg, const int* count, T* rows, T* act,
               float* part, float* grads, T* out_d, T* out_s, long slots, int nd, int ns,
               int blocks, int splits, float eps, cudaStream_t stream) {
  T* rows_d = rows;
  T* rows_s = rows + slots * 2 * W;
  cudaError_t e;
  if constexpr (std::is_same<T, bf16>::value) {
    int smem = bwd_tc_smem();
    e = set_smem((const void*)win_edge_bwd_tc_kernel<W>, smem);
    if (e != cudaSuccess) return (int)e;
    win_edge_bwd_tc_kernel<W><<<blocks, WE_THREADS, smem, stream>>>(
        pd, qd, ps, cs, g, bd, kdo, gdow, gdob, k1, gchw, gchb, kout, eu, ev, spos, count, rows_d,
        rows_s, act, part, eps);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    float* part_w = part + (long)blocks * 5 * W;
    smem = dw_tc_smem();
    e = set_smem((const void*)win_edge_dw_tc_kernel<W>, smem);
    if (e != cudaSuccess) return (int)e;
    win_edge_dw_tc_kernel<W><<<dim3(splits, 3), NT, smem, stream>>>(act, rows_d, g, eu, count,
                                                                     part_w);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    e = reduce_partials(part_w, grads, splits, 3 * W * W, stream);
    if (e != cudaSuccess) return (int)e;
    e = reduce_partials(part, grads + 3 * W * W, blocks, 5 * W, stream);
  } else {
    const int smem = (4 * TE * LDA + C * C + 2 * TE) * (int)sizeof(float) +
                     3 * TE * (int)sizeof(int);
    e = set_smem((const void*)win_edge_bwd_kernel<W>, smem);
    if (e != cudaSuccess) return (int)e;
    win_edge_bwd_kernel<W><<<blocks, NT, smem, stream>>>(pd, qd, ps, cs, g, bd, kdo, gdow, gdob,
                                                         k1, gchw, gchb, kout, eu, ev, spos,
                                                         count, rows_d, rows_s, part, eps);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    e = reduce_partials(part, grads, blocks, we_part<W>(), stream);
  }
  if (e != cudaSuccess) return (int)e;
  // dPd | dQd and dPs | dCs: each row's edges in destination / source order.
  const int err = launch_segment_sum<T, T>(rows_d, dseg, nullptr, out_d, slots, nd, 2 * W, stream);
  if (err != 0) return err;
  return launch_segment_sum<T, T>(rows_s, sseg, nullptr, out_s, slots, ns, 2 * W, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (pd, qd, ps, cs, temp, kdo, k1, kout, out);
// rows and vectors W = width wide (128 or 64): pd, qd, temp, out [nd, W],
// ps, cs [ns, W], kdo, k1, kout [W, W], bd and the GN vectors fp32 [W];
// idx int32 [nc*chunk, icol] (lu, lv, ...); meta int32 [6, nc] (dwin, swin,
// ...; dwin non-decreasing, as the packer emits it); ws fp32 [nc*chunk, W]
// workspace; out every row written (temp's where no edge lands). blocks:
// the card's SMs (the chain pass's persistent blocks: one per SM in bf16,
// two in fp32).
extern "C" int win_edge_fwd(const void* pd, const void* qd, const void* ps, const void* cs,
                            const void* temp, const void* bd, const void* kdo,
                            const void* gdow, const void* gdob, const void* k1,
                            const void* gchw, const void* gchb, const void* kout,
                            const void* idx, const void* meta, void* ws, void* out, int nc,
                            int chunk, int sd, int ss, int icol, int nd, int ns, int width,
                            int blocks, float eps, int dtype, void* stream) {
  if (nc < 0 || chunk < 1 || sd < 1 || ss < 1 || icol < 2 || nd < 0 || ns < 0 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float *b = (const float*)bd, *g0 = (const float*)gdow, *g1 = (const float*)gdob,
              *g2 = (const float*)gchw, *g3 = (const float*)gchb;
  const int *ix = (const int*)idx, *mt = (const int*)meta;
  return with_width_dtype(width, dtype, [&](auto Wc, auto Tc) {
    using T = typename decltype(Tc)::type;
    return launch_fwd<T, decltype(Wc)::value>(
        (const T*)pd, (const T*)qd, (const T*)ps, (const T*)cs, (const T*)temp, b,
        (const T*)kdo, g0, g1, (const T*)k1, g2, g3, (const T*)kout, ix, mt, (float*)ws, (T*)out,
        nc, chunk, sd, ss, icol, nd, ns, blocks, eps, st);
  });
}

// Backward. g: the output cotangent in pd's dtype; rows and vectors W =
// width wide (128 or 64), as the forward's. The plan prepared by
// ops/win_edge.py `prepare_pair` over its `slots` slots: eu, ev int32, the
// valid edges' destination and source rows in destination order; spos int32,
// each one's position in source order; dseg / sseg int64, the destination
// rows in destination order and the source rows in source order (nd / ns
// past the edges); count int32 [1], the edges E. Workspaces: rows [2, slots,
// 2W] in pd's dtype; act [slots, 4W] (bf16 only); part fp32: bf16
// blocks*5W + splits*3*W*W, fp32 blocks*(3*W*W + 5*W). grads fp32
// [3*W*W + 5*W] = dWdo, dK1, dWout (in, out), dbd, dgdow, dgdob, dgchw,
// dgchb. out_d [nd, 2W] = dPd | dQd and out_s [ns, 2W] = dPs | dCs, in pd's
// dtype (zero on rows no edge touches). blocks: the chain pass's blocks
// (one per SM); splits: the bf16 weight-gradient pass's splits.
extern "C" int win_edge_bwd(const void* pd, const void* qd, const void* ps, const void* cs,
                            const void* g, const void* bd, const void* kdo, const void* gdow,
                            const void* gdob, const void* k1, const void* gchw,
                            const void* gchb, const void* kout, const void* eu, const void* ev,
                            const void* spos, const void* dseg, const void* sseg,
                            const void* count, void* rows, void* act, void* part, void* grads,
                            void* out_d, void* out_s, long long slots, int nd, int ns, int width,
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
  return with_width_dtype(width, dtype, [&](auto Wc, auto Tc) {
    using T = typename decltype(Tc)::type;
    return launch_bwd<T, decltype(Wc)::value>(
        (const T*)pd, (const T*)qd, (const T*)ps, (const T*)cs, (const T*)g, b, (const T*)kdo, g0,
        g1, (const T*)k1, g2, g3, (const T*)kout, u, v, sp, ds, ss, n, (T*)rows, (T*)act, pt, gr,
        (T*)out_d, (T*)out_s, slots, nd, ns, blocks, splits, eps, st);
  });
}
