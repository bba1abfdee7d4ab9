// Variants of K3 (csrc/swiglu.cu) that the shipped kernel chose against,
// built beside it by tools/ab_rope_swiglu_variants.py to measure each
// choice on the card; nothing else builds or calls them. The file includes
// the shipped source, so every variant shares its helpers, arguments and
// launch plan, and computes the same bits:
// - k3_fwd_any, k3_bwd_any: the kernels with every dtype code read at run
//   time (SwAny), in place of the bf16 and fp32 instantiations;
// - k3_bwd_div: the backward's 1 / e as __fdiv_rn(1, e) and its bf16
//   stores one conversion an element (the former kernel's arithmetic), in
//   place of __frcp_rn and the packed pair conversions;
// - k3_fwd_k2, k3_fwd_k4, k3_bwd_k2, k3_bwd_k4: the shipped kernels with 2
//   or 4 vectors a thread (each k a coalesced pass, all loads issued
//   before any compute), in place of 1.
// Each entry takes swiglu_fwd()'s or swiglu_bwd()'s arguments (the grid
// is its own: the vectors over K threads).

#include "swiglu.cu"

namespace {

template <int V, int K, class Dt>
__global__ void __launch_bounds__(MAX_THREADS)
    swiglu_bwd_div_kernel(Args args) {
  const Args a = fixed<Dt>(args);
  const unsigned v0 = blockIdx.x * (K * blockDim.x) + threadIdx.x;
  float g[K][V], u[K][V], dy[K][V];
  unsigned go[K], uo[K], yo[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const unsigned v = v0 + k * blockDim.x;
    if (v < a.vecs) {
      unsigned row, col;
      offsets(a, v, V, go[k], uo[k], yo[k], row, col);
      if (a.strided) {
        go[k] = row * a.dg_rs + col;
        uo[k] = row * a.du_rs + col;
        ldv<V>(a.g, row * a.g_rs + col, a.g_dt, g[k]);
        ldv<V>(a.u, row * a.u_rs + col, a.u_dt, u[k]);
      } else {
        ldv<V>(a.g, go[k], a.g_dt, g[k]);
        ldv<V>(a.u, uo[k], a.u_dt, u[k]);
      }
      ldv<V>(a.dy, yo[k], a.y_dt, dy[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (v0 + k * blockDim.x >= a.vecs) continue;
    float dg[V], du[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float gj = g[k][j];
      const float e = __fadd_rn(1.f, expf(-gj));
      const float s = rnd(__fdiv_rn(gj, e), a.g_dt);
      du[j] = rnd(rnd(__fmul_rn(dy[k][j], s), a.y_dt), a.u_dt);
      const float ds = rnd(rnd(__fmul_rn(dy[k][j], u[k][j]), a.y_dt), a.g_dt);
      const float sg = __fdiv_rn(1.f, e);
      const float kk = __fmaf_rn(gj, __fsub_rn(1.f, sg), 1.f);
      dg[j] = rnd(__fmul_rn(__fmul_rn(ds, sg), kk), a.g_dt);
    }
    stv<V>(a.dg, go[k], a.g_dt, dg);
    stv<V>(a.du, uo[k], a.u_dt, du);
  }
}

enum { SHIPPED = 0, DIV = 1, ANY = 2 };

// the shipped kernels with K vectors a thread, the division variant, or the
// shipped kernels reading every code at run time, over vecs / (K threads)
// CTAs
template <int KIND, int K, class Dt>
cudaError_t go(bool bwd, const Args& a, int threads, cudaStream_t st) {
  const unsigned grid = (a.vecs + K * threads - 1) / (K * threads);
  if constexpr (KIND == DIV) {
    swiglu_bwd_div_kernel<8, K, Dt><<<grid, threads, 0, st>>>(a);
    return cudaGetLastError();
  } else if constexpr (KIND == ANY) {
    return launch<8, K, SwAny>(bwd, a, grid, threads, st);
  } else {
    return launch<8, K, Dt>(bwd, a, grid, threads, st);
  }
}

template <int KIND, int K>
int pick_dt(bool bwd, const Args& a, int vec, int threads, void* stream) {
  if (a.vecs == 0) return cudaSuccess;
  if (vec != 8) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fits<SwBf16>(a)) return go<KIND, K, SwBf16>(bwd, a, threads, st);
  if (fits<SwF32>(a)) return go<KIND, K, SwF32>(bwd, a, threads, st);
  return go<KIND, K, SwAny>(bwd, a, threads, st);
}

}  // namespace

#define K3_FWD(NAME, KIND, K)                                               \
  extern "C" int NAME(const void* g, const void* u, void* y, int vecs,      \
                      int d, int g_rs, int u_rs, int g_dt, int u_dt,        \
                      int y_dt, int vec, int grid, int threads, int strided, \
                      int magic, int shift, void* stream) {                 \
    (void)grid;                                                             \
    Args a{g, u, nullptr, y, nullptr, nullptr, (unsigned)vecs,              \
           (unsigned)d, (unsigned)g_rs, (unsigned)u_rs, 0, 0,               \
           (unsigned)magic, shift, strided, g_dt, u_dt, y_dt};              \
    return pick_dt<KIND, K>(false, a, vec, threads, stream);                \
  }

#define K3_BWD(NAME, KIND, K)                                               \
  extern "C" int NAME(const void* g, const void* u, const void* dy,         \
                      void* dg, void* du, int vecs, int d, int g_rs,        \
                      int u_rs, int dg_rs, int du_rs, int g_dt, int u_dt,   \
                      int y_dt, int vec, int grid, int threads, int strided, \
                      int magic, int shift, void* stream) {                 \
    (void)grid;                                                             \
    Args a{g, u, dy, nullptr, dg, du, (unsigned)vecs, (unsigned)d,          \
           (unsigned)g_rs, (unsigned)u_rs, (unsigned)dg_rs,                 \
           (unsigned)du_rs, (unsigned)magic, shift, strided, g_dt, u_dt,    \
           y_dt};                                                           \
    return pick_dt<KIND, K>(true, a, vec, threads, stream);                 \
  }

K3_FWD(k3_fwd_any, ANY, 1)
K3_BWD(k3_bwd_any, ANY, 1)
K3_BWD(k3_bwd_div, DIV, 1)
K3_FWD(k3_fwd_k2, SHIPPED, 2)
K3_FWD(k3_fwd_k4, SHIPPED, 4)
K3_BWD(k3_bwd_k2, SHIPPED, 2)
K3_BWD(k3_bwd_k4, SHIPPED, 4)
