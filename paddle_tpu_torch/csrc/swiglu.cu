// SwiGLU, y = silu(g) * u, forward and backward, for Hopper (sm_90a). The
// port's own kernel: the JAX package computes it with XLA-fused jnp
// (paddle_tpu/models/llama.py LlamaMLP, paddle_tpu/incubate/
// nn_functional.py swiglu, :170-178), no pallas_call.
//
// What it computes, per element, in the plain version's order and
// roundings (rnd(v, t): v rounded to dtype t):
//   s  = rnd(g / (1 + exp(-g)), g's dtype)          (torch's silu)
//   y  = rnd(s u, y's dtype)
// and the backward, recomputing s from g (nothing else is saved):
//   du = rnd(rnd(dy s, y's dtype), u's dtype)
//   ds = rnd(rnd(dy u, y's dtype), g's dtype)
//   dg = rnd(ds sg (1 + g (1 - sg)), g's dtype), sg = 1 / (1 + exp(-g))
// (torch's silu_backward, the inner product and sum as one FMA). g and u
// are rows of d elements at their own row strides, so the one-argument form
// (x split in half on its last axis) is read where it lies; y and dy are
// contiguous (rows, d).
//
// Bound: bytes (forward reads g and u and writes y; backward reads g, u and
// dy and writes dg and du). Design: one pass, 8 elements a thread with
// 16-byte loads when the rows allow it, else 1.

#include <cuda_runtime.h>

#include <cstdint>

#include "fused_io.cuh"

namespace {

struct Args {
  const void *g, *u, *dy;
  void *y, *dg, *du;
  long long rows, g_rs, u_rs, dg_rs, du_rs;
  int d, g_dt, u_dt, y_dt;
};

template <int V>
__global__ void __launch_bounds__(256) swiglu_fwd_kernel(Args a) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int per_row = a.d / V;
  const long long row = t / per_row;
  if (row >= a.rows) return;
  const int c = (int)(t % per_row) * V;
  float g[V], u[V], y[V];
  ldv<V>(a.g, row * a.g_rs + c, a.g_dt, g);
  ldv<V>(a.u, row * a.u_rs + c, a.u_dt, u);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float s = rnd(__fdiv_rn(g[j], __fadd_rn(1.f, expf(-g[j]))), a.g_dt);
    y[j] = rnd(__fmul_rn(s, u[j]), a.y_dt);
  }
  stv<V>(a.y, row * a.d + c, a.y_dt, y);
}

template <int V>
__global__ void __launch_bounds__(256) swiglu_bwd_kernel(Args a) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int per_row = a.d / V;
  const long long row = t / per_row;
  if (row >= a.rows) return;
  const int c = (int)(t % per_row) * V;
  float g[V], u[V], dy[V], dg[V], du[V];
  ldv<V>(a.g, row * a.g_rs + c, a.g_dt, g);
  ldv<V>(a.u, row * a.u_rs + c, a.u_dt, u);
  ldv<V>(a.dy, row * a.d + c, a.y_dt, dy);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float e = __fadd_rn(1.f, expf(-g[j]));
    const float s = rnd(__fdiv_rn(g[j], e), a.g_dt);
    du[j] = rnd(rnd(__fmul_rn(dy[j], s), a.y_dt), a.u_dt);
    const float ds = rnd(rnd(__fmul_rn(dy[j], u[j]), a.y_dt), a.g_dt);
    const float sg = __fdiv_rn(1.f, e);
    const float k = __fmaf_rn(g[j], __fsub_rn(1.f, sg), 1.f);
    dg[j] = rnd(__fmul_rn(__fmul_rn(ds, sg), k), a.g_dt);
  }
  stv<V>(a.dg, row * a.dg_rs + c, a.g_dt, dg);
  stv<V>(a.du, row * a.du_rs + c, a.u_dt, du);
}

}  // namespace

extern "C" int swiglu_fwd(const void* g, const void* u, void* y,
                          long long rows, int d, long long g_rs,
                          long long u_rs, int g_dt, int u_dt, int y_dt,
                          int vec, void* stream) {
  Args a{g, u, nullptr, y, nullptr, nullptr, rows, g_rs, u_rs, 0, 0,
         d, g_dt, u_dt, y_dt};
  const long long threads = rows * (d / vec);
  if (threads == 0) return cudaSuccess;
  const unsigned grid = (unsigned)((threads + 255) / 256);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 8)
    swiglu_fwd_kernel<8><<<grid, 256, 0, st>>>(a);
  else
    swiglu_fwd_kernel<1><<<grid, 256, 0, st>>>(a);
  return cudaGetLastError();
}

extern "C" int swiglu_bwd(const void* g, const void* u, const void* dy,
                          void* dg, void* du, long long rows, int d,
                          long long g_rs, long long u_rs, long long dg_rs,
                          long long du_rs, int g_dt, int u_dt, int y_dt,
                          int vec, void* stream) {
  Args a{g, u, dy, nullptr, dg, du, rows, g_rs, u_rs, dg_rs, du_rs,
         d, g_dt, u_dt, y_dt};
  const long long threads = rows * (d / vec);
  if (threads == 0) return cudaSuccess;
  const unsigned grid = (unsigned)((threads + 255) / 256);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 8)
    swiglu_bwd_kernel<8><<<grid, 256, 0, st>>>(a);
  else
    swiglu_bwd_kernel<1><<<grid, 256, 0, st>>>(a);
  return cudaGetLastError();
}
