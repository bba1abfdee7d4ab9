// act(y + b), the bias add and activation of a linear layer's epilogue
// (act: identity, ReLU, GELU erf form, GELU tanh form), forward and
// backward, for Hopper (sm_90a). The port's own kernel: the JAX package
// leaves matmul + bias + activation to XLA's fusion (paddle_tpu/incubate/
// nn_functional.py fused_linear_activation :212, nn/transformer.py's
// linear1 -> activation), no pallas_call.
//
// What it computes, per element, in the plain version's order and roundings
// (rnd(v, t): v rounded to dtype t; torch's op-math is fp32):
//   h = rnd(y + b, h's dtype)            (no bias: h = y)
//   a = rnd(h, a's dtype)                (the activation's input cast)
//   out = rnd(act(a), a's dtype)
// with act written as torch's CUDA kernels write it (ActivationGeluKernel.cu,
// relu), and the backward, recomputing a from the saved y and b (no
// activation is saved):
//   gh = rnd(rnd(dy act'(a), a's dtype), h's dtype)
//   dy_y = rnd(gh, y's dtype)
//   db   = rnd(sum over rows of gh, b's dtype)
//
// With a bias row period P (the expert-choice MoE's per-expert bias, b of
// shape (E, 1, I) over E x C rows: P = C), row r takes bias row r / P; P =
// rows is one bias row for all rows.
//
// Bound: bytes (forward reads y and writes out; backward reads y and dy and
// writes dy_y). Design (ops/bias_act.py's launch_plan sizes every launch):
// - A CTA is a column strip of 32 threads (V = 8 columns each, 16-byte
//   accesses, where the rows allow it; else V = 1) by TY warps, and owns a
//   run of RB = TY x RT rows that never crosses a bias period: each warp
//   takes RT consecutive rows of the run. A thread's columns are fixed, so
//   its bias is read once, into registers, and the bias row is found by one
//   division a thread.
// - A thread issues the loads of U rows (y, and dy in the backward) before
//   the arithmetic of the first, then computes and stores them in order.
// - bf16 GELU (erf or tanh form) is issue-bound as written: erff, expf and
//   tanhf cost about 118 instructions an element backward and 54 forward
//   on an H100 (PERF.md section 6, K6). Where the pre-activation a is
//   bf16, the activation and its derivative depend on a's 16 bits alone,
//   so those launches look them up: bias_act_tables_kernel evaluates
//   act_fwd(a) (rounded to bf16) and act_bwd(1, a) (fp32: act_bwd(dy, a)
//   is dy times it, one rounding) with the functions below for every bf16 a of
//   magnitude in [2^-16, 16), once a card; each CTA copies the table it
//   needs into shared memory and looks a up by its bits, one branch a
//   vector of 8 (each element of a vector with an a outside that range, 0,
//   tiny, huge, inf or NaN, takes the functions themselves, out of line).
//   The bits are the functions' bits. A lookup launch streams its rows
//   through a cp.async ring in shared memory (STAGES - 1 rows of y, and
//   dy, in flight while a thread computes one: on an H100 24-61% faster
//   than four rows held in registers, which leave the loads idle between
//   groups of rows), with no more CTAs than fit an SM at once: its runs in
//   one wave, or its CTAs walking several runs each (grid_x below the
//   runs).
// - The backward sums gh in fp32 over a thread's rows in order, the TY
//   warps' sums in order through shared memory, and writes one column
//   partial a run; bias_act_fold_kernel adds a bias row's partials in a
//   fixed order (8 strided sums of its run of partials, then those 8 in
//   order), so every launch gives the same bits.
// - The (activation, dtype set) pairs of the paths are instantiations with
//   both fixed (bf16 y, b, h and a; fp32 throughout: straight-line loads,
//   stores and roundings, a rounding that the next one repeats left out,
//   bf16 pairs packed by one conversion); any other set reads its codes
//   and activation at run time.
// - Indices are 32-bit (the wrapper raises at 2^31 elements).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "fused_io.cuh"

namespace {

enum { IDENTITY = 0, RELU = 1, GELU = 2, GELU_TANH = 3 };
constexpr int TX = 32;            // threads of a CTA along the columns
constexpr int MAX_TY = 8;         // warps of a CTA along the rows
// rows a thread has in flight: four, but one in a forward of fixed fp32
// rows (32 bytes a vector), so that more warps fit (on an H100 four made
// ERNIE's fp32 forward 9% slower than the one vector a thread before them:
// PERF.md section 6, K6)
constexpr int U = 4;
// the tables' bf16 magnitudes: [2^-16, 16) (biased exponents 111 to 130)
constexpr unsigned TAB_LO = 111u << 7, TAB_HI = 131u << 7;
constexpr int TAB_HALF = TAB_HI - TAB_LO;   // entries a sign
constexpr int TAB = 2 * TAB_HALF;

struct Args {
  const void *y, *b, *dy;
  void *out, *dyy;
  float* part;
  const void* table;              // bias_act_tables' fwd or bwd table
  unsigned rows, period, n;       // period: rows a bias row serves
  unsigned bpp, rt, runs;         // runs a period, rows a warp, all runs
  unsigned strips;                // column strips
  int act, y_dt, b_dt, h_dt, a_dt;
};

// ACT, the dtype codes: fixed, or -1 read at run time
template <int ACT, int Y, int B, int H, int A>
struct BaDt {
  static constexpr int act = ACT, y = Y, b = B, h = H, a = A;
};
template <int ACT>
using BaBf16 = BaDt<ACT, BF16, BF16, BF16, BF16>;
template <int ACT>
using BaF32 = BaDt<ACT, F32, F32, F32, F32>;
using BaAny = BaDt<-1, -1, -1, -1, -1>;

__host__ __device__ __forceinline__ int pick(int fixed, int arg) {
  return fixed >= 0 ? fixed : arg;
}

template <class Dt>
__device__ __forceinline__ Args fixed(Args a) {
  a.act = pick(Dt::act, a.act);
  a.y_dt = pick(Dt::y, a.y_dt);
  a.b_dt = pick(Dt::b, a.b_dt);
  a.h_dt = pick(Dt::h, a.h_dt);
  a.a_dt = pick(Dt::a, a.a_dt);
  return a;
}

// a set fits where its fixed codes are the call's (a call without a bias
// fits any bias code)
template <class Dt>
bool fits(const Args& a) {
  return pick(Dt::act, a.act) == a.act && pick(Dt::y, a.y_dt) == a.y_dt &&
         (a.b == nullptr || pick(Dt::b, a.b_dt) == a.b_dt) &&
         pick(Dt::h, a.h_dt) == a.h_dt && pick(Dt::a, a.a_dt) == a.a_dt;
}

// rnd(v, to), left out where the next rounding is to the same fixed dtype
template <int TO, int NEXT>
__device__ __forceinline__ float rnd_before(float v, int to) {
  if constexpr (TO >= 0 && TO == NEXT) return v;
  return rnd(v, to);
}

// V values stored as dt; a fixed bf16 packs each pair by one conversion
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

__device__ __forceinline__ float act_fwd(float x, int act) {
  if (act == RELU) return x > 0.f ? x : 0.f;
  if (act == GELU) {
    const float alpha = (float)M_SQRT1_2;
    return x * 0.5f * (1.f + erff(x * alpha));
  }
  if (act == GELU_TANH) {
    const float beta = (float)(M_SQRT2 * M_2_SQRTPI * 0.5);
    const float kappa = 0.044715f;
    const float x_cube = x * x * x;
    const float inner = beta * (x + kappa * x_cube);
    return 0.5f * x * (1.f + tanhf(inner));
  }
  return x;
}

__device__ __forceinline__ float act_bwd(float dy, float x, int act) {
  if (act == RELU) return x > 0.f ? dy : 0.f;
  if (act == GELU) {
    const float beta = (float)(M_2_SQRTPI * M_SQRT1_2 * 0.5);
    const float alpha = (float)M_SQRT1_2;
    const float cdf = 0.5f * (1.f + erff(x * alpha));
    const float pdf = expf(-0.5f * x * x) * beta;
    return dy * (cdf + x * pdf);
  }
  if (act == GELU_TANH) {
    const float beta = (float)(M_SQRT2 * M_2_SQRTPI * 0.5);
    const float kappa = 0.044715f;
    const float x_sq = x * x;
    const float x_cube = x_sq * x;
    const float inner = beta * (x + kappa * x_cube);
    const float tanh_inner = tanhf(inner);
    const float left = 0.5f * x;
    const float right = 1.f + tanh_inner;
    const float left_derivative = 0.5f * right;
    const float tanh_derivative = 1.f - tanh_inner * tanh_inner;
    const float inner_derivative = beta * (1.f + 3.f * kappa * x_sq);
    const float right_derivative = left * tanh_derivative * inner_derivative;
    return dy * (left_derivative + right_derivative);
  }
  return dy;
}

// the functions themselves for a pre-activation outside the tables, out of
// line: a call is not evaluated ahead of its branch, so the looked-up
// elements do not pay for it
__device__ __noinline__ float act_fwd_far(float x, int act) {
  return act_fwd(x, act);
}

__device__ __noinline__ float act_bwd_far(float dy, float x, int act) {
  return act_bwd(dy, x, act);
}

// a = rnd(rnd(y + b, h_dt), a_dt) of V loaded values, b in registers
template <int V, class Dt>
__device__ __forceinline__ void pre_act(const Args& a, const float (&bias)[V],
                                        float (&v)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (a.b != nullptr)
      v[j] = rnd_before<Dt::h, Dt::a>(__fadd_rn(v[j], bias[j]), a.h_dt);
    v[j] = rnd(v[j], a.a_dt);
  }
}

// a run's place: this thread's first column c, the run's bias row and
// this warp's rows [r0, r1) of it
struct Run {
  unsigned c, e, r0, r1;
};

template <int V>
__device__ __forceinline__ Run run_of(const Args& a, unsigned run,
                                     unsigned strip) {
  Run r;
  r.c = (strip * TX + (threadIdx.x & (TX - 1))) * V;
  r.e = run / a.bpp;
  const unsigned p0 = r.e * a.period;
  const unsigned start = p0 + (run - r.e * a.bpp) * (blockDim.x / TX)
                         * a.rt;
  r.r0 = start + (threadIdx.x / TX) * a.rt;
  r.r1 = min(min(r.r0 + a.rt, p0 + a.period), a.rows);
  return r;
}

template <int V, class Dt>
__device__ __forceinline__ void load_bias(const Args& a, const Run& r,
                                          float (&bias)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) bias[j] = 0.f;
  if (a.b != nullptr) ldv<V>(a.b, r.e * a.n + r.c, a.b_dt, bias);
}

// the table's index of bf16 bits, or -1 outside its magnitudes
__device__ __forceinline__ int tab_index(uint32_t bits) {
  const uint32_t m = (bits & 0x7fffu) - TAB_LO;
  return m < (uint32_t)TAB_HALF ? (int)((bits >> 15) * TAB_HALF + m) : -1;
}

// the forward and backward table of act for every bf16 a in range: the
// activation rounded to bf16, and act_bwd(1, a)
template <int ACT>
__global__ void __launch_bounds__(256)
    bias_act_tables_kernel(uint16_t* fwd, float* bwd) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= TAB) return;
  const uint32_t bits = (i < TAB_HALF ? 0u : 0x8000u) + TAB_LO +
                        (uint32_t)(i % TAB_HALF);
  const float x = __uint_as_float(bits << 16);
  fwd[i] = (uint16_t)to16(act_fwd(x, ACT), BF16);
  bwd[i] = act_bwd(1.f, x, ACT);
}

// a CTA's copy of a table of `bytes` into shared memory
__device__ __forceinline__ void copy_table(void* dst, const void* src,
                                           int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x)
    static_cast<uint4*>(dst)[i] = static_cast<const uint4*>(src)[i];
  __syncthreads();
}

// the activation of V bf16 values looked up: one branch a vector (all in
// the table, else each element in turn, out of line where it is not)
template <int V>
__device__ __forceinline__ void lookup_fwd(const uint16_t* tab,
                                           const float (&v)[V], int act,
                                           float (&o)[V]) {
  int t[V];
  bool in = true;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    t[j] = tab_index(__float_as_uint(v[j]) >> 16);
    in &= t[j] >= 0;
  }
  if (in) {
#pragma unroll
    for (int j = 0; j < V; ++j)
      o[j] = __uint_as_float((uint32_t)tab[t[j]] << 16);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      o[j] = t[j] >= 0 ? __uint_as_float((uint32_t)tab[t[j]] << 16)
                       : act_fwd_far(v[j], act);
  }
}

// dy act'(a) of V bf16 values a, act'(a) looked up as lookup_fwd does
template <int V>
__device__ __forceinline__ void lookup_bwd(const float* tab,
                                           const float (&v)[V],
                                           const float (&g)[V], int act,
                                           float (&d)[V]) {
  int t[V];
  bool in = true;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    t[j] = tab_index(__float_as_uint(v[j]) >> 16);
    in &= t[j] >= 0;
  }
  if (in) {
#pragma unroll
    for (int j = 0; j < V; ++j) d[j] = __fmul_rn(g[j], tab[t[j]]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      d[j] = t[j] >= 0 ? __fmul_rn(g[j], tab[t[j]])
                       : act_bwd_far(g[j], v[j], act);
  }
}

// a CTA a run and column strip, the strips of a run consecutive (1-D
// grid): the CTAs resident together cover whole rows, as the rows lie in
// memory
template <int V, class Dt>
__global__ void __launch_bounds__(TX * MAX_TY)
    bias_act_fwd_kernel(Args args) {
  constexpr int UF = Dt::y == F32 ? 1 : U;
  const Args a = fixed<Dt>(args);
  const unsigned run = blockIdx.x / a.strips;
  const Run r = run_of<V>(a, run, blockIdx.x - run * a.strips);
  if (r.c >= a.n) return;
  float bias[V];
  load_bias<V, Dt>(a, r, bias);
  for (unsigned row = r.r0; row < r.r1; row += UF) {
    float v[UF][V];
#pragma unroll
    for (int u = 0; u < UF; ++u)
      if (row + u < r.r1) ldv<V>(a.y, (row + u) * a.n + r.c, a.y_dt, v[u]);
#pragma unroll
    for (int u = 0; u < UF; ++u) {
      if (row + u >= r.r1) break;
      float o[V];
      pre_act<V, Dt>(a, bias, v[u]);
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = act_fwd(v[u][j], a.act);
      store<V, Dt::a>(a.out, (row + u) * a.n + r.c, a.a_dt, o);
    }
  }
}

// dy_y, and the run's fp32 column sums of gh into part[run][column]; a CTA
// a run and column strip as bias_act_fwd_kernel
template <int V, class Dt>
__global__ void __launch_bounds__(TX * MAX_TY)
    bias_act_bwd_kernel(Args args) {
  __shared__ float sums[MAX_TY][TX * V];
  const Args a = fixed<Dt>(args);
  const int tx = threadIdx.x & (TX - 1), ty = threadIdx.x / TX;
  const unsigned run = blockIdx.x / a.strips;
  const unsigned strip = blockIdx.x - run * a.strips;
  const Run r = run_of<V>(a, run, strip);
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  if (r.c < a.n) {
    float bias[V];
    load_bias<V, Dt>(a, r, bias);
    for (unsigned row = r.r0; row < r.r1; row += U) {
      float v[U][V], g[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (row + u < r.r1) {
          ldv<V>(a.y, (row + u) * a.n + r.c, a.y_dt, v[u]);
          ldv<V>(a.dy, (row + u) * a.n + r.c, a.a_dt, g[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (row + u >= r.r1) break;
        pre_act<V, Dt>(a, bias, v[u]);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float gh = rnd(rnd_before<Dt::a, Dt::h>(
              act_bwd(g[u][j], v[u][j], a.act), a.a_dt), a.h_dt);
          acc[j] = __fadd_rn(acc[j], gh);
          g[u][j] = rnd_before<Dt::y, Dt::y>(gh, a.y_dt);
        }
        store<V, Dt::y>(a.dyy, (row + u) * a.n + r.c, a.y_dt, g[u]);
      }
    }
  }
  if (a.part == nullptr) return;
#pragma unroll
  for (int j = 0; j < V; ++j) sums[ty][tx * V + j] = acc[j];
  __syncthreads();
  // the run's partial: column i's TY sums added in warp order
  const unsigned c0 = strip * TX * V;
  for (int i = threadIdx.x; i < TX * V; i += blockDim.x) {
    if (c0 + i >= a.n) break;
    float t = 0.f;
    for (int w = 0; w < (int)(blockDim.x / TX); ++w)
      t = __fadd_rn(t, sums[w][i]);
    a.part[run * a.n + c0 + i] = t;
  }
}

// the ring of a lookup launch: STAGES rows of y (and dy) a thread
constexpr int STAGES = 4;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// a lookup launch's dynamic shared memory: the table, the ring of its NT
// tensors (y; y and dy), the backward's warps' column sums
__host__ __device__ constexpr int staged_smem(bool bwd, int threads) {
  return (bwd ? TAB * 4 + STAGES * 2 * threads * 16 + threads * 8 * 4
              : TAB * 2 + STAGES * threads * 16);
}

// the lookup launches (bf16 throughout, vectors of 8), forward and
// backward: as bias_act_fwd_kernel / bias_act_bwd_kernel, the activation
// looked up, a thread's rows of y (and dy) streamed through a cp.async ring
// of STAGES rows in shared memory; as many CTAs as fit an SM (four forward,
// three backward)
template <bool BWD, class Dt>
__global__ void __launch_bounds__(TX * MAX_TY, BWD ? 3 : 4)
    bias_act_staged_kernel(Args args) {
  constexpr int V = 8, NT = BWD ? 2 : 1;
  using Tab = typename std::conditional<BWD, float, uint16_t>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  Tab* tab = reinterpret_cast<Tab*>(smem);
  uint4* ring = reinterpret_cast<uint4*>(smem + TAB * sizeof(Tab));
  float* sums = reinterpret_cast<float*>(ring + STAGES * NT * blockDim.x);
  const Args a = fixed<Dt>(args);
  copy_table(tab, a.table, TAB * sizeof(Tab));
  const int tx = threadIdx.x & (TX - 1), ty = threadIdx.x / TX;
  // stage s of tensor t (y, dy) of this thread
  auto slot = [&](int s, int t) {
    return ring + (NT * s + t) * blockDim.x + threadIdx.x;
  };
  for (unsigned run = blockIdx.x; run < a.runs; run += gridDim.x) {
    const Run r = run_of<V>(a, run, blockIdx.y);
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
    if (r.c < a.n) {
      float bias[V];
      load_bias<V, Dt>(a, r, bias);
      const int nr = r.r1 > r.r0 ? (int)(r.r1 - r.r0) : 0;
      auto issue = [&](int i) {
        if (i < nr) {
          const unsigned o = (r.r0 + i) * a.n + r.c;
          cp_async16(slot(i % STAGES, 0),
                     static_cast<const uint16_t*>(a.y) + o);
          if constexpr (BWD)
            cp_async16(slot(i % STAGES, 1),
                       static_cast<const uint16_t*>(a.dy) + o);
        }
        cp_commit();
      };
#pragma unroll
      for (int i = 0; i < STAGES - 1; ++i) issue(i);
      for (int i = 0; i < nr; ++i) {
        cp_wait<STAGES - 2>();
        const uint4 ry = *slot(i % STAGES, 0);
        uint4 rg = ry;
        if constexpr (BWD) rg = *slot(i % STAGES, 1);
        issue(i + STAGES - 1);
        float v[V], g[V];
        const uint32_t wy[4] = {ry.x, ry.y, ry.z, ry.w};
        const uint32_t wg[4] = {rg.x, rg.y, rg.z, rg.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[2 * j] = from16(wy[j] & 0xffffu, BF16);
          v[2 * j + 1] = from16(wy[j] >> 16, BF16);
          g[2 * j] = from16(wg[j] & 0xffffu, BF16);
          g[2 * j + 1] = from16(wg[j] >> 16, BF16);
        }
        pre_act<V, Dt>(a, bias, v);
        const unsigned o = (r.r0 + i) * a.n + r.c;
        if constexpr (BWD) {
          float d[V];
          lookup_bwd<V>(tab, v, g, a.act, d);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float gh = rnd(d[j], a.h_dt);   // a, h: bf16
            acc[j] = __fadd_rn(acc[j], gh);
            g[j] = gh;
          }
          store<V, BF16>(a.dyy, o, a.y_dt, g);
        } else {
          float out[V];
          lookup_fwd<V>(tab, v, a.act, out);
          store<V, BF16>(a.out, o, a.a_dt, out);
        }
      }
      cp_wait<0>();
    }
    if (!BWD || a.part == nullptr) continue;
#pragma unroll
    for (int j = 0; j < V; ++j) sums[ty * TX * V + tx * V + j] = acc[j];
    __syncthreads();
    // the run's partial: column i's TY sums added in warp order
    const unsigned c0 = blockIdx.y * TX * V;
    for (int i = threadIdx.x; i < TX * V; i += blockDim.x) {
      if (c0 + i >= a.n) break;
      float t = 0.f;
      for (int w = 0; w < (int)(blockDim.x / TX); ++w)
        t = __fadd_rn(t, sums[w * TX * V + i]);
      a.part[run * a.n + c0 + i] = t;
    }
    __syncthreads();
  }
}

// db[e, c] = rnd(sum of bias row e's CTAs' partials, b's dtype): a block of
// 256 threads takes 32 columns of one bias row (grid.y); its 8 warps each
// sum the partials i = w, w + 8, ... of their column in order, and warp 0
// adds the 8 sums in order
__global__ void __launch_bounds__(256) bias_act_fold_kernel(
    const float* __restrict__ part, void* db, int blocks, int n, int b_dt) {
  __shared__ float sums[8][32];
  const int tx = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + tx;
  part += (long long)blockIdx.y * blocks * n;
  db = static_cast<char*>(db) +
       (long long)blockIdx.y * n * (b_dt == F32 ? 4 : 2);
  float s = 0.f;
  if (c < n)
    for (int i = w; i < blocks; i += 8)
      s = __fadd_rn(s, part[(long long)i * n + c]);
  sums[w][tx] = s;
  __syncthreads();
  if (w != 0 || c >= n) return;
  float t = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) t = __fadd_rn(t, sums[j][tx]);
  float o[1] = {t};
  stv<1>(db, c, b_dt, o);
}

// a direct launch: grid.x runs (all of them) by grid.y strips, as one 1-D
// grid of runs x strips CTAs
template <bool BWD, int V, class Dt>
cudaError_t launch(const Args& a, dim3 grid, int threads, cudaStream_t st) {
  if (grid.x != a.runs) return cudaErrorInvalidValue;
  const unsigned ctas = grid.x * grid.y;
  if constexpr (BWD)
    bias_act_bwd_kernel<V, Dt><<<ctas, threads, 0, st>>>(a);
  else
    bias_act_fwd_kernel<V, Dt><<<ctas, threads, 0, st>>>(a);
  return cudaGetLastError();
}

template <bool BWD, class Dt>
cudaError_t launch_staged(const Args& a, dim3 grid, int threads,
                          cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      bias_act_staged_kernel<BWD, Dt>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      staged_smem(BWD, TX * MAX_TY));
  if (attr != cudaSuccess) return attr;
  bias_act_staged_kernel<BWD, Dt><<<grid, threads,
                                    staged_smem(BWD, threads), st>>>(a);
  return cudaGetLastError();
}

template <bool BWD, int ACT>
bool try_fixed(const Args& a, dim3 grid, int threads, cudaStream_t st,
               cudaError_t& err) {
  if (fits<BaBf16<ACT>>(a)) {
    if constexpr (ACT == GELU || ACT == GELU_TANH) {
      if (a.table != nullptr) {
        err = launch_staged<BWD, BaBf16<ACT>>(a, grid, threads, st);
        return true;
      }
    }
    err = launch<BWD, 8, BaBf16<ACT>>(a, grid, threads, st);
    return true;
  }
  if (fits<BaF32<ACT>>(a)) {
    err = launch<BWD, 8, BaF32<ACT>>(a, grid, threads, st);
    return true;
  }
  return false;
}

template <bool BWD>
cudaError_t run(const Args& a, int vec, dim3 grid, int threads,
                cudaStream_t st) {
  if (threads % TX || threads > TX * MAX_TY || a.rt == 0 || a.bpp == 0 ||
      grid.x > a.runs)
    return cudaErrorInvalidValue;
  // a table only for the bf16 GELU forms in vectors of 8
  const bool tab_ok = vec == 8 && (a.act == GELU || a.act == GELU_TANH) &&
                      a.y_dt == BF16 && (a.b == nullptr || a.b_dt == BF16) &&
                      a.h_dt == BF16 && a.a_dt == BF16;
  if (a.table != nullptr && !tab_ok) return cudaErrorInvalidValue;
  if (vec == 1) return launch<BWD, 1, BaAny>(a, grid, threads, st);
  cudaError_t err;
  if (try_fixed<BWD, GELU>(a, grid, threads, st, err) ||
      try_fixed<BWD, GELU_TANH>(a, grid, threads, st, err) ||
      try_fixed<BWD, IDENTITY>(a, grid, threads, st, err) ||
      try_fixed<BWD, RELU>(a, grid, threads, st, err))
    return err;
  return launch<BWD, 8, BaAny>(a, grid, threads, st);
}

}  // namespace

// the forward (TAB bf16 bits) and backward (TAB fp32) tables of act (GELU
// or GELU_TANH), computed on the card; TAB: bias_act_table_size()
extern "C" int bias_act_table_size() { return TAB; }

extern "C" int bias_act_tables(int act, void* fwd, void* bwd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = (TAB + 255) / 256;
  if (act == GELU)
    bias_act_tables_kernel<GELU><<<grid, 256, 0, st>>>(
        static_cast<uint16_t*>(fwd), static_cast<float*>(bwd));
  else if (act == GELU_TANH)
    bias_act_tables_kernel<GELU_TANH><<<grid, 256, 0, st>>>(
        static_cast<uint16_t*>(fwd), static_cast<float*>(bwd));
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// period: rows a bias row serves (b holds rows / period bias rows; the
// plan passes rows for one bias row); runs (bias rows x bpp runs of rows),
// grid_x (CTAs along the runs, each taking runs grid_x apart), grid_y
// (column strips), threads (32 x TY), bpp, rt: ops/bias_act.py's launch
// plan; table: bias_act_tables' forward table (the launch looks its
// activation up, staged), or null
extern "C" int bias_act_fwd(const void* y, const void* b, void* out,
                            const void* table, int rows, int period, int n,
                            int act, int y_dt, int b_dt, int h_dt, int a_dt,
                            int vec, int runs, int grid_x, int grid_y,
                            int threads, int bpp, int rt, void* stream) {
  if (rows == 0 || n == 0) return cudaSuccess;
  Args a{y, b, nullptr, out, nullptr, nullptr, table, (unsigned)rows,
         (unsigned)period, (unsigned)n, (unsigned)bpp, (unsigned)rt,
         (unsigned)runs, (unsigned)grid_y, act, y_dt, b_dt, h_dt, a_dt};
  return run<false>(a, vec, dim3(grid_x, grid_y), threads,
                    static_cast<cudaStream_t>(stream));
}

// part: fp32 scratch of runs x n (unused without b); db (rows / period, n);
// table: bias_act_tables' backward table (a staged lookup), or null
extern "C" int bias_act_bwd(const void* y, const void* b, const void* dy,
                            void* dyy, float* part, void* db,
                            const void* table, int rows, int period, int n,
                            int act, int y_dt, int b_dt, int h_dt, int a_dt,
                            int vec, int runs, int grid_x, int grid_y,
                            int threads, int bpp, int rt, void* stream) {
  if (rows == 0 || n == 0) return cudaSuccess;
  Args a{y, b, dy, nullptr, dyy, b != nullptr ? part : nullptr, table,
         (unsigned)rows, (unsigned)period, (unsigned)n, (unsigned)bpp,
         (unsigned)rt, (unsigned)runs, (unsigned)grid_y, act, y_dt, b_dt,
         h_dt, a_dt};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = run<true>(a, vec, dim3(grid_x, grid_y), threads, st);
  if (err != cudaSuccess || b == nullptr) return err;
  bias_act_fold_kernel<<<dim3((n + 31) / 32, runs / bpp), 256, 0, st>>>(
      part, db, bpp, n, b_dt);
  return cudaGetLastError();
}
