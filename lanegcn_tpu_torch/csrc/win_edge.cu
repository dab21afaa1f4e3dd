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
#include "common.cuh"

using namespace lgk;

namespace {

constexpr int EB = 64;  // edges per step

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

  const float ones[4] = {1.f, 1.f, 1.f, 1.f};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float mm[4][8];

  for (int kk = k; kk < k_end; ++kk) {
    const long base_s = (long)swin[kk] * ss;
    for (int h = 0; h * EB < chunk; ++h) {
      __syncthreads();  // previous step done with lu_s / A_s / W_s (and acc init visible)
      if (threadIdx.x == 0) *any_s = 0;
      __syncthreads();
      if (threadIdx.x < EB) {
        int u = -1, v = -1;
        if (h * EB + threadIdx.x < chunk) {
          const long e = (long)kk * chunk + h * EB + threadIdx.x;
          u = idx[e * icol];
          v = idx[e * icol + 1];
        }
        const bool ok = u >= 0 && u < sd && v >= 0 && v < ss && base_d + u < nd &&
                        base_s + v < ns;
        lu_s[threadIdx.x] = ok ? u : -1;
        lv_s[threadIdx.x] = ok ? v : -1;
        if (ok) *any_s = 1;
      }
      __syncthreads();
      if (*any_s == 0) continue;

      // t1 = relu(Pd[u] + Ps[v] + bd), rounded.
      for (int i = threadIdx.x; i < EB * (C / 4); i += NT) {
        const int r = i / (C / 4), c4 = (i % (C / 4)) * 4;
        float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
        if (lu_s[r] >= 0) {
          const float4 a = load4<T>(pd + (base_d + lu_s[r]) * C + c4);
          const float4 b = load4<T>(ps + (base_s + lv_s[r]) * C + c4);
          const float4 bb = *reinterpret_cast<const float4*>(bd + c4);
          t = rnd4<T>(relu4(add4(add4(a, b), bb)));
        }
        *reinterpret_cast<float4*>(A_s + r * LDA + c4) = t;
      }
      load_weight<T>(W_s, kdo);
      __syncthreads();
      zero_acc(mm);
      mm_64x128(A_s, 0, ones, W_s, mm);
      __syncthreads();
      store_acc(A_s, mm);
      __syncthreads();
      gn_relu_rows<T>(A_s, EB, gdow, gdob, eps);  // t2
      load_weight<T>(W_s, k1);
      __syncthreads();
      zero_acc(mm);
      mm_64x128(A_s, 0, ones, W_s, mm);
      __syncthreads();
      store_acc(A_s, mm);
      __syncthreads();
      // s = t2 @ K1 + Cs[v] + Qd[u];  e1 = relu(GN(s)), rounded.
      for (int r = warp; r < EB; r += NT / 32) {
        float* p = A_s + r * LDA + lane * 4;
        float4 s = *reinterpret_cast<float4*>(p);
        if (lu_s[r] >= 0) {
          s = add4(s, load4<T>(cs + (base_s + lv_s[r]) * C + lane * 4));
          s = add4(s, load4<T>(qd + (base_d + lu_s[r]) * C + lane * 4));
        }
        *reinterpret_cast<float4*>(p) = rnd4<T>(relu4(gn_row(s, gchw, gchb, eps)));
      }
      load_weight<T>(W_s, kout);
      __syncthreads();
      zero_acc(mm);
      mm_64x128(A_s, 0, ones, W_s, mm);  // e2 = e1 @ Wout
      __syncthreads();
      store_acc(A_s, mm);
      __syncthreads();
      // Destination scatter in edge order, one thread per channel.
      if (threadIdx.x < C) {
        for (int r = 0; r < EB; ++r) {
          const int u = lu_s[r];
          if (u >= 0) acc[(base_d + u) * C + threadIdx.x] += A_s[r * LDA + threadIdx.x];
        }
      }
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
