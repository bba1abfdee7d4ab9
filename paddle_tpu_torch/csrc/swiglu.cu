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
// dy and writes dg and du). Design (ops/swiglu.py's launch_plan sizes every
// launch):
// - A thread takes one vector of V elements (V = 8: 16-byte accesses) of
//   each input, all its loads issued before it computes (two 16-byte loads
//   in flight forward, three backward), in CTAs of 256 threads (128 where
//   there are fewer vectors than 256 an SM). The kernels are templated on
//   K vectors a thread (vector k at k x threads past the first); on an H100
//   K = 2 and 4 took 54-122 registers, fewer warps an SM, and were 13-16%
//   slower forward and 0-28% backward at Llama's shapes than K = 1
//   (tools/ab_rope_swiglu_variants.py), so K = 1 is built.
// - Indices are 32-bit (the wrapper raises at 2^31 elements). Contiguous
//   rows (Llama's g and u) are one flat run: vector v at element v V. Rows
//   at a stride (the packed form) find their row by a multiply-high with a
//   magic number from the plan, no division.
// - The dtype sets of the paths (bf16, fp32) are instantiations with their
//   codes fixed (SwDt: straight-line loads, stores and roundings; a
//   rounding that a store to the same dtype repeats is left out); any
//   other set reads its codes at run time.
// - The backward's instructions an element are cut without changing a bit:
//   sg = 1 / e by __frcp_rn, which rounds the same quotient as
//   __fdiv_rn(1, e) (both correctly rounded); bf16 pairs are packed by one
//   conversion each.

#include <cuda_runtime.h>

#include <cstdint>

#include "fused_io.cuh"

namespace {

constexpr int MAX_THREADS = 256;

struct Args {
  const void *g, *u, *dy;
  void *y, *dg, *du;
  unsigned vecs, d, g_rs, u_rs, dg_rs, du_rs;
  // vector v (of V elements) is in row (v * magic) >> (31 + shift), where
  // the rows are at a stride (strided != 0)
  unsigned magic;
  int shift, strided, g_dt, u_dt, y_dt;
};

template <int G, int U, int Y>
struct SwDt {
  static constexpr int g = G, u = U, y = Y;
};
using SwBf16 = SwDt<BF16, BF16, BF16>;
using SwF32 = SwDt<F32, F32, F32>;
using SwAny = SwDt<-1, -1, -1>;

__host__ __device__ __forceinline__ int pick(int fixed, int arg) {
  return fixed >= 0 ? fixed : arg;
}

template <class Dt>
__device__ __forceinline__ Args fixed(Args a) {
  a.g_dt = pick(Dt::g, a.g_dt);
  a.u_dt = pick(Dt::u, a.u_dt);
  a.y_dt = pick(Dt::y, a.y_dt);
  return a;
}

template <class Dt>
bool fits(const Args& a) {
  return pick(Dt::g, a.g_dt) == a.g_dt && pick(Dt::u, a.u_dt) == a.u_dt &&
         pick(Dt::y, a.y_dt) == a.y_dt;
}

// rnd(v, to), left out where the next rounding is to the same fixed dtype
template <int TO, int NEXT>
__device__ __forceinline__ float rnd_before(float v, int to) {
  if constexpr (TO >= 0 && TO == NEXT) return v;
  return rnd(v, to);
}

// 8 values stored as dt; a fixed bf16 packs each pair by one conversion
template <int V, int DT>
__device__ __forceinline__ void store(void* p, unsigned i, int dt,
                                      const float (&x)[V]) {
  if constexpr (V == 8 && DT == BF16) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
      w[j] = *reinterpret_cast<const uint32_t*>(&b);
    }
    *reinterpret_cast<uint4*>(static_cast<uint16_t*>(p) + i) =
        make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    stv<V>(p, i, dt, x);
  }
}

// the element offsets of vector v in g and u (a row stride each) and in the
// contiguous rows of y / dy
__device__ __forceinline__ void offsets(const Args& a, unsigned v, int V,
                                        unsigned& go, unsigned& uo,
                                        unsigned& yo, unsigned& row,
                                        unsigned& col) {
  yo = v * V;
  if (a.strided) {
    row = (unsigned)(((unsigned long long)v * a.magic) >> (31 + a.shift));
    col = yo - row * a.d;
    go = row * a.g_rs + col;
    uo = row * a.u_rs + col;
  } else {
    row = col = 0;
    go = uo = yo;
  }
}

template <int V, int K, class Dt>
__global__ void __launch_bounds__(MAX_THREADS) swiglu_fwd_kernel(Args args) {
  const Args a = fixed<Dt>(args);
  const unsigned v0 = blockIdx.x * (K * blockDim.x) + threadIdx.x;
  float g[K][V], u[K][V];
  unsigned yo[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const unsigned v = v0 + k * blockDim.x;
    if (v < a.vecs) {
      unsigned go, uo, row, col;
      offsets(a, v, V, go, uo, yo[k], row, col);
      ldv<V>(a.g, go, a.g_dt, g[k]);
      ldv<V>(a.u, uo, a.u_dt, u[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (v0 + k * blockDim.x >= a.vecs) continue;
    float y[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float s = rnd(__fdiv_rn(g[k][j], __fadd_rn(1.f, expf(-g[k][j]))),
                          a.g_dt);
      y[j] = __fmul_rn(s, u[k][j]);
    }
    store<V, Dt::y>(a.y, yo[k], a.y_dt, y);
  }
}

template <int V, int K, class Dt>
__global__ void __launch_bounds__(MAX_THREADS) swiglu_bwd_kernel(Args args) {
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
      if (a.strided) {  // the gradients at their own row strides
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
      du[j] = rnd_before<Dt::u, Dt::u>(
          rnd_before<Dt::y, Dt::u>(__fmul_rn(dy[k][j], s), a.y_dt), a.u_dt);
      const float ds = rnd(
          rnd_before<Dt::y, Dt::g>(__fmul_rn(dy[k][j], u[k][j]), a.y_dt),
          a.g_dt);
      const float sg = __frcp_rn(e);
      const float kk = __fmaf_rn(gj, __fsub_rn(1.f, sg), 1.f);
      dg[j] = __fmul_rn(__fmul_rn(ds, sg), kk);
    }
    store<V, Dt::g>(a.dg, go[k], a.g_dt, dg);
    store<V, Dt::u>(a.du, uo[k], a.u_dt, du);
  }
}

template <int V, int K, class Dt>
cudaError_t launch(bool bwd, const Args& a, unsigned grid, int threads,
                   cudaStream_t st) {
  if (bwd)
    swiglu_bwd_kernel<V, K, Dt><<<grid, threads, 0, st>>>(a);
  else
    swiglu_fwd_kernel<V, K, Dt><<<grid, threads, 0, st>>>(a);
  return cudaGetLastError();
}

cudaError_t run(bool bwd, const Args& a, int vec, int grid, int threads,
                cudaStream_t st) {
  if (a.vecs == 0) return cudaSuccess;
  if (threads > MAX_THREADS || threads % 32) return cudaErrorInvalidValue;
  const unsigned g = (unsigned)grid;
  if (vec == 1) return launch<1, 1, SwAny>(bwd, a, g, threads, st);
  if (fits<SwBf16>(a)) return launch<8, 1, SwBf16>(bwd, a, g, threads, st);
  if (fits<SwF32>(a)) return launch<8, 1, SwF32>(bwd, a, g, threads, st);
  return launch<8, 1, SwAny>(bwd, a, g, threads, st);
}

}  // namespace

// vecs: rows * d / vec; grid, threads, magic, shift: ops/swiglu.py's
// launch plan (a vector a thread); strided: the rows are not one flat run
extern "C" int swiglu_fwd(const void* g, const void* u, void* y, int vecs,
                          int d, int g_rs, int u_rs, int g_dt, int u_dt,
                          int y_dt, int vec, int grid, int threads,
                          int strided, int magic, int shift, void* stream) {
  Args a{g, u, nullptr, y, nullptr, nullptr, (unsigned)vecs, (unsigned)d,
         (unsigned)g_rs, (unsigned)u_rs, 0, 0, (unsigned)magic, shift,
         strided, g_dt, u_dt, y_dt};
  return run(false, a, vec, grid, threads, static_cast<cudaStream_t>(stream));
}

extern "C" int swiglu_bwd(const void* g, const void* u, const void* dy,
                          void* dg, void* du, int vecs, int d, int g_rs,
                          int u_rs, int dg_rs, int du_rs, int g_dt, int u_dt,
                          int y_dt, int vec, int grid, int threads,
                          int strided, int magic, int shift, void* stream) {
  Args a{g, u, dy, nullptr, dg, du, (unsigned)vecs, (unsigned)d,
         (unsigned)g_rs, (unsigned)u_rs, (unsigned)dg_rs, (unsigned)du_rs,
         (unsigned)magic, shift, strided, g_dt, u_dt, y_dt};
  return run(true, a, vec, grid, threads, static_cast<cudaStream_t>(stream));
}
