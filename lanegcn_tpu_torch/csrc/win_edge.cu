// Window-pair fused edge MLP + destination scatter (Att), forward.
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
// Backward: replaces pallas_win_edge.py `_bwd_d_kernel` / `_bwd_s_kernel`
// (`_pallas_bwd`), as two launches.
//   win_edge_bwd_d  one block per destination-window run, as the forward:
//     recompute t1, z, t2, s, e1 (three products), then
//       d_e2 = g[u];  d_e1 = d_e2 @ Woutᵀ;  dWout += e1ᵀ d_e2
//       d_s  = GN_chᵀ(d_e1 ⊙ [e1 > 0]);     dK1 += t2ᵀ rnd(d_s);  d_t2 = rnd(d_s) @ K1ᵀ
//       d_z  = GN_doᵀ(d_t2 ⊙ [t2 > 0]);     dWdo += t1ᵀ rnd(d_z); d_t1 = rnd(d_z) @ Wdoᵀ
//       d_t1p = d_t1 ⊙ [t1 > 0];  dbd += Σ d_t1p
//     dPd[u] += rnd(d_t1p) and dQd[u] += rnd(d_s) in an fp32 window buffer
//     (block-owned, fixed order), and rnd(d_s), rnd(d_t1p) saved per edge slot.
//   win_edge_bwd_s  one block per source-window run of the chunks in `sperm`
//     order × a 32-channel slice: dPs[v] += d_t1p, dCs[v] += d_s from the
//     saved slots, summed in shared memory in edge order.
// Windows no chunk touches keep the zeros the wrapper allocates.
// Parameter gradients: the destination window of a run is unique, so each
// run adds its products into its own slice of a [windows, 3*C*C + 5*C]
// workspace (zeroed by the wrapper; a read-modify-write per 64-edge step,
// by the block that owns it), and a second pass sums the slices in window
// order: deterministic, no float atomics. What bounds it: nine
// [E x 128] x [128 x 128] products per valid edge against the gathered rows
// and the whole dPd/dQd/dPs/dCs: memory-bound at the bf16 matrix rate for
// A2M and M2A, operation-bound for A2A (the saved slots are traffic of this
// two-pass design, on top of that bound); on the CUDA cores used here the
// products dominate. M2A has only 32 destination windows, so only 32 blocks
// run its destination pass. The chain itself, forward and backward, is
// edge_chain.cuh's, shared with edge_mlp.cu.
#include "edge_chain.cuh"

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

constexpr int WE_PART = 3 * C * C + 5 * C;  // dWdo, dK1, dWout, dbd, dgdow, dgdob, dgchw, dgchb
constexpr int SL = 32;                       // channels per source-pass block

template <typename T>
__global__ void __launch_bounds__(NT)
win_edge_bwd_d_kernel(const T* __restrict__ pd, const T* __restrict__ qd,
                      const T* __restrict__ ps, const T* __restrict__ cs,
                      const T* __restrict__ g, const float* __restrict__ bd,
                      const T* __restrict__ kdo, const float* __restrict__ gdow,
                      const float* __restrict__ gdob, const T* __restrict__ k1,
                      const float* __restrict__ gchw, const float* __restrict__ gchb,
                      const T* __restrict__ kout, const int* __restrict__ idx,
                      const int* __restrict__ meta, float* acc_pd, float* acc_qd, T* dpd, T* dqd,
                      int write_out, T* __restrict__ ds_save, T* __restrict__ dt1_save,
                      float* __restrict__ part, int nc, int chunk, int sd, int ss, int icol,
                      int nd, int ns, float eps) {
  const int* dwin = meta;
  const int* swin = meta + nc;
  const int* first = meta + 2 * nc;
  const int k = blockIdx.x;
  if (first[k] != 1) return;
  int k_end = k + 1;
  while (k_end < nc && first[k_end] != 1) ++k_end;

  extern __shared__ float4 smem4[];
  float* A_s = reinterpret_cast<float*>(smem4);  // [EB][LDA] four edge tiles
  float* B_s = A_s + EB * LDA;
  float* C_s = B_s + EB * LDA;
  float* D_s = C_s + EB * LDA;
  float* W_s = D_s + EB * LDA;  // [C][C]
  float* st_s = W_s + C * C;    // [EB][2] inv of GN(do), GN(ch)
  int* lu_s = reinterpret_cast<int*>(st_s + 2 * EB);
  int* lv_s = lu_s + EB;
  int* any_s = lv_s + EB;

  const long base_d = (long)dwin[k] * sd;
  float* P = part + (long)dwin[k] * WE_PART;  // this run's own slice (zeroed)
  const Chain<T> w{kdo, gdow, gdob, k1, gchw, gchb, kout, eps};
  const int lane = threadIdx.x & 31;
  float4 vecs[5] = {zero4(), zero4(), zero4(), zero4(), zero4()};  // dbd, dgdow, dgdob, dgchw, dgchb

  for (int kk = k; kk < k_end; ++kk) {
    const long base_s = (long)swin[kk] * ss;
    for (int h = 0; h * EB < chunk; ++h) {
      if (!load_step(idx, lu_s, lv_s, any_s, kk, h, chunk, icol, sd, ss, base_d, base_s, nd, ns))
        continue;
      const long slot0 = (long)kk * chunk + h * EB;
      chain_bwd<T>(
          A_s, B_s, C_s, D_s, W_s, st_s, P, vecs, w,
          [&](float* X_s) { gather_t1<T>(X_s, lu_s, lv_s, pd, ps, bd, base_d, base_s); },
          [&](int r, float4 sv) {  // s += Cs[v] + Qd[u]
            if (lu_s[r] >= 0) {
              sv = add4(sv, load4<T>(cs + (base_s + lv_s[r]) * C + lane * 4));
              sv = add4(sv, load4<T>(qd + (base_d + lu_s[r]) * C + lane * 4));
            }
            return sv;
          },
          [&](int r) {  // d_e2 = g[u]
            return lu_s[r] >= 0 ? load4<T>(g + (base_d + lu_s[r]) * C + lane * 4) : zero4();
          },
          [&](int r) { return lu_s[r] >= 0; },
          [&](int r, float4 ds) { store4<T>(ds_save + (slot0 + r) * C + lane * 4, ds); },
          [&]() { scatter_rows(acc_qd, C_s, lu_s, base_d); },  // dQd[u] += rnd(d_s)
          [&](int r, float4 d1) { store4<T>(dt1_save + (slot0 + r) * C + lane * 4, d1); },
          [&]() { scatter_rows(acc_pd, A_s, lu_s, base_d); });  // dPd[u] += rnd(d_t1p)
    }
  }
  __syncthreads();
  const int rows_d = (int)min((long)sd, (long)nd - base_d);
  if (write_out) {
    for (int i = threadIdx.x; i < rows_d * (C / 4); i += NT) {
      const long o = (base_d + i / (C / 4)) * C + (i % (C / 4)) * 4;
      store4<T>(dpd + o, *reinterpret_cast<const float4*>(acc_pd + o));
      store4<T>(dqd + o, *reinterpret_cast<const float4*>(acc_qd + o));
    }
  }
  reduce_warp_vecs<5>(vecs, B_s, P + 3 * C * C);
}

// Source pass: block (i, slice) owns the source-window run that starts at
// position i of the sperm order and a 32-channel slice of it.
template <typename T>
__global__ void __launch_bounds__(NT)
win_edge_bwd_s_kernel(const T* __restrict__ ds_save, const T* __restrict__ dt1_save,
                      const int* __restrict__ idx, const int* __restrict__ meta,
                      T* __restrict__ dps, T* __restrict__ dcs, int nc, int chunk, int sd,
                      int ss, int icol, int nd, int ns) {
  const int* dwin = meta;
  const int* sperm = meta + 3 * nc;
  const int* sswin = meta + 4 * nc;
  const int* sfirst = meta + 5 * nc;
  const int i0 = blockIdx.x;
  if (sfirst[i0] != 1) return;
  int i_end = i0 + 1;
  while (i_end < nc && sfirst[i_end] != 1) ++i_end;

  extern __shared__ float4 smem4[];
  float* P_s = reinterpret_cast<float*>(smem4);  // [ss][SL] dPs slice
  float* Q_s = P_s + ss * SL;                    // [ss][SL] dCs slice
  for (int i = threadIdx.x; i < 2 * ss * SL; i += NT) P_s[i] = 0.f;
  __syncthreads();
  const long base_s = (long)sswin[i0] * ss;
  const int cs0 = blockIdx.y * SL;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp < 2) {  // warp 0: dPs from d_t1p, warp 1: dCs from d_s; lane = channel
    const T* src = warp == 0 ? dt1_save : ds_save;
    float* acc = warp == 0 ? P_s : Q_s;
    for (int i = i0; i < i_end; ++i) {
      const int kk = sperm[i];
      const long base_d = (long)dwin[kk] * sd;
      for (int e0 = 0; e0 < chunk; e0 += 8) {
        int vv[8];
        float val[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          vv[q] = -1;
          val[q] = 0.f;
          if (e0 + q < chunk) {
            const long slot = (long)kk * chunk + e0 + q;
            const int u = idx[slot * icol], v = idx[slot * icol + 1];
            if (u >= 0 && u < sd && v >= 0 && v < ss && base_d + u < nd && base_s + v < ns) {
              vv[q] = v;
              val[q] = to_f<T>(src[slot * C + cs0 + lane]);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (vv[q] >= 0) acc[vv[q] * SL + lane] += val[q];
      }
    }
  }
  __syncthreads();
  const int rows_s = (int)min((long)ss, (long)ns - base_s);
  for (int i = threadIdx.x; i < rows_s * SL; i += NT) {
    const long o = (base_s + i / SL) * C + cs0 + i % SL;
    dps[o] = from_f<T>(P_s[i]);
    dcs[o] = from_f<T>(Q_s[i]);
  }
}

template <typename T>
int launch_bwd(const void* pd, const void* qd, const void* ps, const void* cs, const void* g,
               const float* bd, const void* kdo, const float* gdow, const float* gdob,
               const void* k1, const float* gchw, const float* gchb, const void* kout,
               const int* idx, const int* meta, float* acc_pd, float* acc_qd, void* dpd,
               void* dqd, int write_out, void* ds_save, void* dt1_save, float* part,
               float* grads, int windows, int nc, int chunk, int sd, int ss, int icol, int nd,
               int ns, float eps, cudaStream_t stream) {
  const int smem = (4 * EB * LDA + C * C + 2 * EB) * (int)sizeof(float) +
                   (2 * EB + 4) * (int)sizeof(int);
  cudaError_t err = set_smem((const void*)win_edge_bwd_d_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  if (nc > 0) {
    win_edge_bwd_d_kernel<T><<<nc, NT, smem, stream>>>(
        (const T*)pd, (const T*)qd, (const T*)ps, (const T*)cs, (const T*)g, bd, (const T*)kdo,
        gdow, gdob, (const T*)k1, gchw, gchb, (const T*)kout, idx, meta, acc_pd, acc_qd,
        (T*)dpd, (T*)dqd, write_out, (T*)ds_save, (T*)dt1_save, part, nc, chunk, sd, ss, icol,
        nd, ns, eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)reduce_partials(part, grads, windows, WE_PART, stream);
}

template <typename T>
int launch_bwd_s(const void* ds_save, const void* dt1_save, const int* idx, const int* meta,
                 void* dps, void* dcs, int nc, int chunk, int sd, int ss, int icol, int nd,
                 int ns, cudaStream_t stream) {
  const int smem = 2 * ss * SL * (int)sizeof(float);
  cudaError_t err = set_smem((const void*)win_edge_bwd_s_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  if (nc > 0) {
    win_edge_bwd_s_kernel<T><<<dim3(nc, C / SL), NT, smem, stream>>>(
        (const T*)ds_save, (const T*)dt1_save, idx, meta, (T*)dps, (T*)dcs, nc, chunk, sd, ss,
        icol, nd, ns);
  }
  return (int)cudaGetLastError();
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

// Destination pass of the backward. g: the output cotangent in pd's dtype;
// acc_pd/acc_qd: fp32 [nd, 128], zero on entry (dPd/dQd themselves for
// float32, with write_out 0); dpd/dqd: zero [nd, 128] outputs written from
// the accumulators when write_out is 1; ds_save/dt1_save [nc*chunk, 128] in
// pd's dtype; part: fp32 [windows, 3*C*C + 5*C], zero on entry, one slice
// per destination window (windows = nd / sd); grads: fp32 [3*C*C + 5*C] =
// dWdo, dK1, dWout (in, out), dbd, dgdow, dgdob, dgchw, dgchb, the slices'
// sum in window order.
extern "C" int win_edge_bwd_d(const void* pd, const void* qd, const void* ps, const void* cs,
                              const void* g, const void* bd, const void* kdo, const void* gdow,
                              const void* gdob, const void* k1, const void* gchw,
                              const void* gchb, const void* kout, const void* idx,
                              const void* meta, void* acc_pd, void* acc_qd, void* dpd,
                              void* dqd, int write_out, void* ds_save, void* dt1_save,
                              void* part, void* grads, int windows, int nc, int chunk, int sd,
                              int ss, int icol, int nd, int ns, float eps, int dtype,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float *b = (const float*)bd, *g0 = (const float*)gdow, *g1 = (const float*)gdob,
              *g2 = (const float*)gchw, *g3 = (const float*)gchb;
  const int *ix = (const int*)idx, *mt = (const int*)meta;
  float *ap = (float*)acc_pd, *aq = (float*)acc_qd, *pt = (float*)part, *gr = (float*)grads;
  if (dtype == 0)
    return launch_bwd<float>(pd, qd, ps, cs, g, b, kdo, g0, g1, k1, g2, g3, kout, ix, mt, ap,
                             aq, dpd, dqd, write_out, ds_save, dt1_save, pt, gr, windows, nc,
                             chunk, sd, ss, icol, nd, ns, eps, st);
  if (dtype == 1)
    return launch_bwd<bf16>(pd, qd, ps, cs, g, b, kdo, g0, g1, k1, g2, g3, kout, ix, mt, ap,
                            aq, dpd, dqd, write_out, ds_save, dt1_save, pt, gr, windows, nc,
                            chunk, sd, ss, icol, nd, ns, eps, st);
  return (int)cudaErrorInvalidValue;
}

// Source pass of the backward: dps/dcs [ns, 128] in ps's dtype, zero on
// entry; windows of ss rows (at most 908, for 2 fp32 slices in 227 KB).
extern "C" int win_edge_bwd_s(const void* ds_save, const void* dt1_save, const void* idx,
                              const void* meta, void* dps, void* dcs, int nc, int chunk, int sd,
                              int ss, int icol, int nd, int ns, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int *ix = (const int*)idx, *mt = (const int*)meta;
  if (dtype == 0)
    return launch_bwd_s<float>(ds_save, dt1_save, ix, mt, dps, dcs, nc, chunk, sd, ss, icol, nd,
                               ns, st);
  if (dtype == 1)
    return launch_bwd_s<bf16>(ds_save, dt1_save, ix, mt, dps, dcs, nc, chunk, sd, ss, icol, nd,
                              ns, st);
  return (int)cudaErrorInvalidValue;
}
