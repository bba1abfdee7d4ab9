// K10: batch norm, forward and backward, for Hopper (sm_90a), with the
// ResNet blocks' tails fused into the apply: bn + ReLU, and bn + the
// residual add + ReLU; and PP-YOLOE's: bn + swish, and bn + the residual
// add + swish (a RepVGG block's two branches). The port's own kernel: the
// JAX package computes batch_norm_stats and batch_norm
// (paddle_tpu/ops/nn_ops.py:210-264) as XLA-fused jnp, no pallas_call.
//
// What it computes (rnd(v, t): v rounded to dtype t; arithmetic in fp32):
//   (a) stats: per channel, the mean and the biased variance of x (Chan's
//       merges of counts, means and sums of squared deviations, never
//       E[x^2] - E[x]^2), and the running buffers as the reference updates
//       them (m r + (1 - m) batch, the variance made unbiased by n / (n -
//       1)).
//   (b) apply: t = (x - mean) rsqrt(var + eps), rounded to norm_dt, then
//       rnd(t w, wmul_dt), then rnd(t + b, badd_dt) (the reference's order
//       and rounding points), with the batch's or the running statistics;
//       tail 1: relu(rnd(t, act_dt)); tail 2: relu(rnd(rnd(t, act_dt) +
//       rnd(residual, act_dt), act_dt)); tail 3: swish(z) for z = rnd(t,
//       act_dt); tail 4: swish(z) for z = rnd(rnd(t, act_dt) +
//       rnd(residual, act_dt), act_dt). Stored in out_dt.
//   (c) bwd reduce: g = dy where the tail's input z is > 0 (tail 1: z
//       recomputed from x, the statistics, w and b by the apply's own
//       arithmetic, so the mask is the output's bit for bit; tail 2: the
//       saved output's sign); for the swish tails g = rnd(dy (s + z s (1 -
//       s)), act_dt) with s the sigmoid of z, recomputed (with the saved
//       residual for tail 4); per channel sum(g) and sum(g xhat), dw =
//       rnd(sum(g xhat)), db = rnd(sum(g)).
//   (d) bwd apply: dx = w r (g - sum(g) / n - xhat sum(g xhat) / n) with
//       batch statistics, w r g with the running ones; the residual's
//       gradient g (tails 2 and 4), each rounded to its tensor's dtype.
// Launches on the same inputs agree bit for bit: every sum has a fixed
// order whatever the blocks' timing, and no float is added atomically.
//
// What bounds it: bytes, at 3.35 TB/s; (a) reads x, (b) x and writes the
// output, (c) and (d) read x and dy. So the design is about how many bytes
// a load moves and how many loads are in flight:
//   * 16-byte accesses: a thread holds a vector of V consecutive elements
//     (4 fp32 or 8 bf16), neighbouring threads on neighbouring vectors, in
//     two routes that the wrapper's planner (ops/batch_norm.py, bn_plan)
//     chooses from the shape, the dtypes and the pointers' alignment:
//     col, the (rows, C S) view of channels last (S = 1, every NHWC / NLC
//     call) or of a group of k channels first with a small S (k S
//     elements of each image contiguous: ResNet's 14 x 14 and 7 x 7):
//     thread (tx, ty) of a block holds the columns tx V .. tx V + V of a
//     group of W = tx V and walks the rows ty, ty + ty_n, ..., so a warp
//     reads whole rows of the group and each column keeps its own sums in
//     registers; run, one channel first with a large S (S % V == 0): a
//     block takes chunks of 8192 elements of the channel's N runs, a
//     vector's image and offset advanced by addition (no divide an
//     element). A channel-last stem read one element a load at stride C
//     ran at 3% of the bound.
//   * Three modes, each its own instantiation with the tail fixed: fp32
//     throughout (V = 4), O2's bf16 (V = 8: the norm's rounding points
//     fp32, the tail's bf16), and a generic one element a load for any
//     other dtypes or shapes; per-element dtype switches kept the loads
//     from being issued together (and the compiler from finishing).
//   * Each launch's grid is as many blocks as the card holds at once (the
//     occupancy of that kernel), in the fewest rounds of chunks, each block
//     walking the chunks x, x + gridDim.x, ...: no second wave, no idle SM
//     in the tail, and one partial a block and channel. A second small
//     launch folds a channel's partials (a few hundred) with a block's
//     threads in a fixed tree; a last-block fold in one SM took longer than
//     the statistics on the detector's shapes.
//   * Reads only what is needed: a ReLU backward recomputes its mask from
//     x (no saved output); with the residual's tails the reduce writes g
//     into the residual's gradient (exact: it has the tail's dtype) and the
//     apply reads it back instead of dy and the output or the residual.
//     The swish and sigmoid use the card's fast exponential and division
//     (a few ulps; the fp32 forms stay within 1e-5 of F.silu).
// Two passes over x remain (the statistics, then the apply): a two-pass
// forward's ceiling is 67% of the bound (75% with the residual), the
// backward's 60% (62.5%). A pure read (the statistics, the reduce) streams
// at about 2.1-2.5 TB/s on the card where a read-and-write apply reaches
// about 3.0 (PERF.md).

#include <cuda_runtime.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

#include "fused_io.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// values a thread holds in a pass of the statistics (two passes over them
// in registers), and in a pass of the other launches
constexpr int STATS_ELEMS = 32;
constexpr int APPLY_ELEMS = 16;
// vectors a thread holds in a pass of the apply and backward launches: one
// in the generic mode (one element a vector: a small body to compile)
__host__ __device__ constexpr int apply_vectors(int V) {
  return V == 1 ? 1 : APPLY_ELEMS / V;
}
// elements of one channel a block of the run route
constexpr int RUN_CHUNK = THREADS * STATS_ELEMS;
// most values a block of the col route keeps a column in shared memory
constexpr int COL_SMEM = THREADS * 8;

struct Geo {
  long long n;        // elements of a channel (N S)
  long long S;        // inner extent (1: channels last)
  long long rows;     // col: rows of the (rows, C S) view
  long long rstride;  // col: elements between two rows (C S)
  long long rpc;      // col: rows a chunk
  int C;
  int chunks;         // blocks a channel (run) or a channel group (col)
  int W;              // col: a group's columns (tx V = k S)
  int k;              // col: channels a group
  int tx, ty;         // col: vectors across the group, rows down
  int parts;          // a reducing launch's blocks a channel (its grid's x)
  int fold_ph;        // the fold's threads a channel
};

// dtype codes of a launch's tensors and rounding points, and the tail
struct Codes {
  int x, w, b, r, out, dy, dx, dres, dw, db;
  int norm, wmul, badd, act, tail;
};

// the kernels' three modes (ops/batch_norm.py, _mode): every tensor and
// rounding point fp32 (V = 4); x bf16 under O2 (the norm, the weight's
// multiply and the bias's add in fp32, the tail in bf16, the other tensors
// bf16 or fp32; V = 8); anything else, one element a load
enum { MF32 = 0, MBF16 = 1, MGEN = 2 };

// a rounding point of the affine part (norm_dt, wmul_dt, badd_dt): fp32
// but in the generic mode
template <int M>
__device__ __forceinline__ float r_aff(float v, int dt) {
  if constexpr (M == MGEN) return rnd(v, dt);
  return v;
}

// the tail's rounding point (act_dt)
template <int M>
__device__ __forceinline__ float r_act(float v, int dt) {
  if constexpr (M == MF32) return v;
  if constexpr (M == MBF16) return __bfloat162float(__float2bfloat16_rn(v));
  return rnd(v, dt);
}

// V elements at p[i..i+V) into fp32 with one access: V = 4 (mode MF32)
// one 16-byte fp32 load; V = 8 (MBF16) one 16-byte bf16 load or two of
// fp32 (dt says which); V = 1 (MGEN) any dtype. The planner makes sure of
// the alignment.
template <int V, int M>
__device__ __forceinline__ void ld(const void* p, long long i, int dt,
                                   float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = dt == F32 ? static_cast<const float*>(p)[i]
                     : from16(static_cast<const uint16_t*>(p)[i], dt);
  } else {
    if (M == MF32 || dt == F32) {
      const float* q = static_cast<const float*>(p) + i;
#pragma unroll
      for (int h = 0; h < V; h += 4) {
        const float4 a = *reinterpret_cast<const float4*>(q + h);
        v[h] = a.x; v[h + 1] = a.y; v[h + 2] = a.z; v[h + 3] = a.w;
      }
    } else if constexpr (V == 8) {
      const uint4 r = *reinterpret_cast<const uint4*>(
          static_cast<const uint16_t*>(p) + i);
      const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        v[2 * h] = __uint_as_float(w[h] << 16);
        v[2 * h + 1] = __uint_as_float(w[h] & 0xffff0000u);
      }
    }
  }
}

template <int V, int M>
__device__ __forceinline__ void st(void* p, long long i, int dt,
                                   const float (&v)[V]) {
  if constexpr (V == 1) {
    if (dt == F32)
      static_cast<float*>(p)[i] = v[0];
    else
      static_cast<uint16_t*>(p)[i] = (uint16_t)to16(v[0], dt);
  } else {
    if (M == MF32 || dt == F32) {
      float* q = static_cast<float*>(p) + i;
#pragma unroll
      for (int h = 0; h < V; h += 4)
        *reinterpret_cast<float4*>(q + h) =
            make_float4(v[h], v[h + 1], v[h + 2], v[h + 3]);
    } else if constexpr (V == 8) {
      uint4 r;
      r.x = to16(v[0], BF16) | (to16(v[1], BF16) << 16);
      r.y = to16(v[2], BF16) | (to16(v[3], BF16) << 16);
      r.z = to16(v[4], BF16) | (to16(v[5], BF16) << 16);
      r.w = to16(v[6], BF16) | (to16(v[7], BF16) << 16);
      *reinterpret_cast<uint4*>(static_cast<uint16_t*>(p) + i) = r;
    }
  }
}

template <int V>
__device__ __forceinline__ void zero(float (&v)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = 0.f;
}

// the sum of V values in a fixed pairwise tree
template <int V>
__device__ __forceinline__ float tree_sum(const float (&a)[V]) {
  if constexpr (V == 1) {
    return a[0];
  } else {
    float h[V / 2];
#pragma unroll
    for (int j = 0; j < V / 2; ++j) h[j] = __fadd_rn(a[2 * j], a[2 * j + 1]);
    return tree_sum<V / 2>(h);
  }
}

// one element of any dtype (the per-channel weight, bias and their
// gradients)
__device__ __forceinline__ float ld1(const void* p, long long i, int dt) {
  float v[1];
  ld<1, MGEN>(p, i, dt, v);
  return v[0];
}

__device__ __forceinline__ void st1(void* p, long long i, int dt, float x) {
  const float v[1] = {x};
  st<1, MGEN>(p, i, dt, v);
}

__device__ __forceinline__ float relu(float z) {
  return (z > 0.f || z != z) ? z : 0.f;
}

// the tail of a kernel instantiated for tail T, or (T = -1, the generic
// mode) the launch's code: a fixed tail leaves no branch in the element
// loops
template <int T>
__device__ __forceinline__ int tail_of(const Codes& d) {
  if constexpr (T >= 0) return T;
  return d.tail;
}

// the swish tails: codes 3 and 4; 2 and 4 add the residual
__device__ __forceinline__ bool swish_tail(int tail) { return tail >= 3; }
__device__ __forceinline__ bool add_tail(int tail) {
  return tail == 2 || tail == 4;
}

// the sigmoid and the swish on the card's fast exponential and division
// (a few ulps: the fp32 forms stay within 1e-5 of the plain version's
// F.silu)
__device__ __forceinline__ float sigm(float z) {
  return __fdividef(1.f, __fadd_rn(1.f, __expf(-z)));
}

__device__ __forceinline__ float swish(float z) {
  return __fdividef(z, __fadd_rn(1.f, __expf(-z)));
}

// the affine part of the apply, at the reference's rounding points
template <int M>
__device__ __forceinline__ float affine(float x, float mu, float rs, float w,
                                        float b, const Codes& d, bool hw,
                                        bool hb) {
  float y = r_aff<M>(__fmul_rn(__fsub_rn(x, mu), rs), d.norm);
  if (hw) y = r_aff<M>(__fmul_rn(y, w), d.wmul);
  if (hb) y = r_aff<M>(__fadd_rn(y, b), d.badd);
  return y;
}

// the tail's input z from the affine output y: the residual r added
// (tails 2 and 4), rounded to act_dt
template <int M, int T>
__device__ __forceinline__ float tail_in(float y, float r, const Codes& d) {
  if (add_tail(tail_of<T>(d)))
    y = r_act<M>(__fadd_rn(r_act<M>(y, d.act), r_act<M>(r, d.act)), d.act);
  return r_act<M>(y, d.act);
}

template <int M, int T>
__device__ __forceinline__ float apply1(float x, float r, float mu, float rs,
                                        float w, float b, const Codes& d,
                                        bool hw, bool hb) {
  float y = affine<M>(x, mu, rs, w, b, d, hw, hb);
  const int tail = tail_of<T>(d);
  if (tail != 0) {
    y = tail_in<M, T>(y, r, d);
    y = swish_tail(tail) ? swish(y) : relu(y);
  }
  return y;
}

// the gradient at the tail's input from dy = g: o is the saved output
// (tail 2), r the residual (tail 4)
template <int M, int T>
__device__ __forceinline__ float grad_in(float g, float x, float o, float r,
                                         float mu, float rs, float w, float b,
                                         const Codes& d, bool hw, bool hb) {
  const int tail = tail_of<T>(d);
  if (tail == 0) return g;
  if (tail == 2) return o > 0.f ? g : 0.f;
  const float z = tail_in<M, T>(affine<M>(x, mu, rs, w, b, d, hw, hb), r, d);
  if (tail == 1) return z > 0.f ? g : 0.f;
  const float s = sigm(z);
  const float dd = __fadd_rn(s, __fmul_rn(__fmul_rn(z, s), __fsub_rn(1.f, s)));
  return r_act<M>(__fmul_rn(g, dd), d.act);
}

// Chan's merge of (nb, mb, Mb) into (n, m, M): counts, means and sums of
// squared deviations
__device__ __forceinline__ void chan(float& n, float& m, float& M, float nb,
                                     float mb, float Mb) {
  if (nb == 0.f) return;
  if (n == 0.f) {
    n = nb;
    m = mb;
    M = Mb;
    return;
  }
  const float nn = __fadd_rn(n, nb);
  const float d = __fsub_rn(mb, m);
  const float f = __fdiv_rn(nb, nn);
  m = __fadd_rn(m, __fmul_rn(d, f));
  M = __fadd_rn(__fadd_rn(M, Mb), __fmul_rn(__fmul_rn(__fmul_rn(d, d), n), f));
  n = nn;
}

// Chan's merge of V columns that share their counts n and nb
template <int V>
__device__ __forceinline__ void chan_cols(float& n, float (&m)[V],
                                          float (&M)[V], float nb,
                                          const float* mb, const float* Mb) {
  if (nb == 0.f) return;
  if (n == 0.f) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      m[j] = mb[j];
      M[j] = Mb[j];
    }
    n = nb;
    return;
  }
  const float nn = __fadd_rn(n, nb);
  const float f = __fdiv_rn(nb, nn);
  const float nf = __fmul_rn(n, f);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float d = __fsub_rn(mb[j], m[j]);
    m[j] = __fadd_rn(m[j], __fmul_rn(d, f));
    M[j] = __fadd_rn(__fadd_rn(M[j], Mb[j]), __fmul_rn(__fmul_rn(d, d), nf));
  }
  n = nn;
}

// the run route's block sums of two values, in thread 0, in a fixed tree
__device__ void block_sum2(float& a, float& b) {
  __shared__ float sh[2][WARPS];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a = __fadd_rn(a, __shfl_down_sync(0xffffffffu, a, o));
    b = __fadd_rn(b, __shfl_down_sync(0xffffffffu, b, o));
  }
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) {
    sh[0][w] = a;
    sh[1][w] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < WARPS; ++i) {
      a = __fadd_rn(a, sh[0][i]);
      b = __fadd_rn(b, sh[1][i]);
    }
  }
}

// block_sum2's sums in every thread
__device__ void block_sum2_all(float& a, float& b) {
  __shared__ float sh[2];
  block_sum2(a, b);
  if (threadIdx.x == 0) {
    sh[0] = a;
    sh[1] = b;
  }
  __syncthreads();
  a = sh[0];
  b = sh[1];
}

// the merge of a channel's S columns, each over the same rows: count n
// each, means cm[0, S) and sums of squared deviations cM[0, S), as sums in
// order (equal counts: the mean of the means, then
// the deviations' sums plus n (m_i - mean)^2)
__device__ __forceinline__ void merge_cols(float n, const float* cm,
                                           const float* cM, int S,
                                           float& tn, float& tm, float& tM) {
  float s = 0.f;
  for (int i = 0; i < S; ++i) s = __fadd_rn(s, cm[i]);
  tm = __fdiv_rn(s, (float)S);
  float q = 0.f;
  for (int i = 0; i < S; ++i) {
    const float d = __fsub_rn(cm[i], tm);
    q = __fadd_rn(q, __fadd_rn(cM[i], __fmul_rn(__fmul_rn(d, d), n)));
  }
  tn = __fmul_rn(n, (float)S);
  tM = q;
}

// a vector's place in a run-route chunk: element j of the channel, image
// nn, offset s in the image's run of S
struct Walk {
  long long j, nn, s;
  __device__ Walk(const Geo& g, int chunk, int V) {
    j = (long long)chunk * RUN_CHUNK + (long long)threadIdx.x * V;
    const unsigned q = (unsigned)j / (unsigned)g.S;
    nn = q;
    s = j - (long long)q * g.S;
  }
  __device__ long long at(const Geo& g, int c) const {
    return (nn * g.C + c) * g.S + s;
  }
  __device__ void next(const Geo& g, int step) {
    j += step;
    s += step;
    while (s >= g.S) {
      s -= g.S;
      ++nn;
    }
  }
};

// a col-route thread's place: its group's first channel, its columns and
// its rows
struct ColPos {
  int tx, ty, grp, o;
  long long col;
  bool live;
  __device__ ColPos(const Geo& g, int V) {
    tx = threadIdx.x % g.tx;
    ty = threadIdx.x / g.tx;
    grp = blockIdx.y;
    o = tx * V;
    col = (long long)grp * g.W + o;
    live = col < (long long)g.C * g.S;
  }
  // the end of chunk q's rows [q rpc, end)
  __device__ long long end(const Geo& g, int q) const {
    const long long e = (long long)(q + 1) * g.rpc;
    return e < g.rows ? e : g.rows;
  }
  // the channel of the thread's column o + j (a dead column: the last)
  __device__ int channel(const Geo& g, int j) const {
    return min(grp * g.k + (int)((o + j) / g.S), g.C - 1);
  }
};

// the per-channel constants of the apply: mean, rsqrt(var + eps), w, b
__device__ __forceinline__ void consts(int c, const float* mean,
                                       const float* var, float eps,
                                       const void* w, const void* b,
                                       const Codes& d, float& mu, float& rs,
                                       float& wc, float& bc) {
  mu = mean[c];
  rs = __frsqrt_rn(__fadd_rn(var[c], eps));
  wc = w != nullptr ? ld1(w, c, d.w) : 1.f;
  bc = b != nullptr ? ld1(b, c, d.b) : 0.f;
}

// ---------------------------------------------------------------------------
// (a) statistics
// ---------------------------------------------------------------------------
struct StatsArgs {
  const void* x;
  float* part;       // [blocks][3][C]: count, mean, sum of squared deviations
  float *mean, *var;
  float *run_mean, *run_var;  // or null
  float mom, one_minus_mom, unbias;
  Geo g;
  Codes d;
};

__device__ __forceinline__ void stats_out(const StatsArgs& a, int c, float n,
                                          float m, float M) {
  const float var = __fdiv_rn(M, n);
  a.mean[c] = m;
  a.var[c] = var;
  if (a.run_mean != nullptr) {
    a.run_mean[c] = __fadd_rn(__fmul_rn(a.mom, a.run_mean[c]),
                              __fmul_rn(a.one_minus_mom, m));
    a.run_var[c] =
        __fadd_rn(__fmul_rn(a.mom, a.run_var[c]),
                  __fmul_rn(a.one_minus_mom, __fmul_rn(var, a.unbias)));
  }
}

template <int V, int M>
__global__ void __launch_bounds__(THREADS) bn_col_stats(StatsArgs a) {
  constexpr int U = STATS_ELEMS / V;
  __shared__ float sm[2][COL_SMEM];
  __shared__ float sn[THREADS];
  const Geo& g = a.g;
  const ColPos p(g, V);
  const int t = threadIdx.x;
  // the thread's count, and a column's mean and sum of squared deviations:
  // each pass's two passes over the registers, merged by Chan's formula
  float n = 0.f, m[V], M2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) m[j] = M2[j] = 0.f;
  if (p.live) {
    for (int q = blockIdx.x; q < g.chunks; q += gridDim.x) {
      const long long r1 = p.end(g, q);
      for (long long r = (long long)q * g.rpc + p.ty; r < r1;
           r += (long long)U * g.ty) {
        float v[U][V];
        int cnt = 0;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const long long rr = r + (long long)u * g.ty;
          if (rr < r1) {
            ld<V, M>(a.x, rr * g.rstride + p.col, a.d.x, v[u]);
            cnt = u + 1;
          }
        }
        const float inv = __frcp_rn((float)cnt);
        float mb[V], Mb[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float sj = 0.f;
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (u < cnt) sj = __fadd_rn(sj, v[u][j]);
          mb[j] = __fmul_rn(sj, inv);
          float sq = 0.f;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (u < cnt) {
              const float e = __fsub_rn(v[u][j], mb[j]);
              sq = __fadd_rn(sq, __fmul_rn(e, e));
            }
          }
          Mb[j] = sq;
        }
        chan_cols<V>(n, m, M2, (float)cnt, mb, Mb);
      }
    }
  }
  // the block's row slices, merged in a fixed tree over ty
  const int base = p.ty * g.W + p.o;
  if (p.tx == 0) sn[p.ty] = n;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sm[0][base + j] = m[j];
    sm[1][base + j] = M2[j];
  }
  __syncthreads();
  for (int s = 1; s < g.ty; s <<= 1) {
    if (p.ty % (2 * s) == 0 && p.ty + s < g.ty) {
      const int pb = (p.ty + s) * g.W + p.o;
      chan_cols<V>(n, m, M2, sn[p.ty + s], &sm[0][pb], &sm[1][pb]);
      if (p.tx == 0) sn[p.ty] = n;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        sm[0][base + j] = m[j];
        sm[1][base + j] = M2[j];
      }
    }
    __syncthreads();
  }
  // a channel's S columns, one partial a channel: [chunk][3][C]
  const int c0 = p.grp * g.k, chs = min(g.k, g.C - c0);
  const int S = (int)g.S;
  if (t < chs) {
    float cn, cm, cM;
    merge_cols(sn[0], &sm[0][t * S], &sm[1][t * S], S, cn, cm, cM);
    float* q = a.part + (long long)blockIdx.x * 3 * g.C + c0 + t;
    q[0] = cn;
    q[g.C] = cm;
    q[2 * g.C] = cM;
  }
}

template <int V, int M>
__global__ void __launch_bounds__(THREADS) bn_run_stats(StatsArgs a) {
  constexpr int U = STATS_ELEMS / V;
  const Geo& g = a.g;
  const int c = blockIdx.y;
  // the thread's count, mean and sum of squared deviations over the
  // block's chunks: each chunk's two passes over the registers (a lane's
  // sums, then a tree over the lanes), merged by Chan's formula
  float n = 0.f, m = 0.f, M2 = 0.f;
  for (int k = blockIdx.x; k < g.chunks; k += gridDim.x) {
    Walk w(g, k, V);
    float v[U][V];
    int cnt = 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (w.j < g.n) {
        ld<V, M>(a.x, w.at(g, c), a.d.x, v[u]);
        cnt = u + 1;
      }
      w.next(g, THREADS * V);
    }
    if (cnt == 0) continue;
    float sj[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      sj[j] = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (u < cnt) sj[j] = __fadd_rn(sj[j], v[u][j]);
    }
    const float nb = (float)(cnt * V);
    const float mb = __fdiv_rn(tree_sum<V>(sj), nb);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      sj[j] = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (u < cnt) {
          const float d = __fsub_rn(v[u][j], mb);
          sj[j] = __fadd_rn(sj[j], __fmul_rn(d, d));
        }
    }
    chan(n, m, M2, nb, mb, tree_sum<V>(sj));
  }
  // the block's: the count and the mean as sums of n and n m, then the sum
  // of M + n (m - mean)^2
  float N = n, nm = __fmul_rn(n, m);
  block_sum2_all(N, nm);
  const float mean = N > 0.f ? __fdiv_rn(nm, N) : 0.f;
  const float d = __fsub_rn(m, mean);
  float Q = __fadd_rn(M2, __fmul_rn(__fmul_rn(d, d), n)), unused = 0.f;
  block_sum2(Q, unused);
  if (threadIdx.x == 0) {
    float* p = a.part + (long long)blockIdx.x * 3 * g.C + c;
    p[0] = N;
    p[g.C] = mean;
    p[2 * g.C] = Q;
  }
}

// ---------------------------------------------------------------------------
// (b) apply
// ---------------------------------------------------------------------------
struct ApplyArgs {
  const void *x, *w, *b, *r;
  void* out;
  const float *mean, *var;
  float eps;
  Geo g;
  Codes d;
};

template <int V, int M, int T>
__global__ void __launch_bounds__(THREADS) bn_col_apply(ApplyArgs a) {
  constexpr int U = apply_vectors(V);
  const Geo& g = a.g;
  const ColPos p(g, V);
  if (!p.live) return;
  float mu[V], rs[V], w[V], b[V];
#pragma unroll
  for (int j = 0; j < V; ++j)
    consts(p.channel(g, j), a.mean, a.var, a.eps, a.w, a.b, a.d, mu[j],
           rs[j], w[j], b[j]);
  const bool hw = a.w != nullptr, hb = a.b != nullptr;
  const bool hr = add_tail(tail_of<T>(a.d));
  for (int q = blockIdx.x; q < g.chunks; q += gridDim.x) {
    const long long r1 = p.end(g, q);
    for (long long r = (long long)q * g.rpc + p.ty; r < r1;
         r += (long long)U * g.ty) {
      float v[U][V], res[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long rr = r + (long long)u * g.ty;
        if (rr < r1) {
          ld<V, M>(a.x, rr * g.rstride + p.col, a.d.x, v[u]);
          if (hr) ld<V, M>(a.r, rr * g.rstride + p.col, a.d.r, res[u]);
          else zero<V>(res[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long rr = r + (long long)u * g.ty;
        if (rr < r1) {
          float y[V];
#pragma unroll
          for (int j = 0; j < V; ++j)
            y[j] = apply1<M, T>(v[u][j], res[u][j], mu[j], rs[j], w[j],
                                b[j], a.d, hw, hb);
          st<V, M>(a.out, rr * g.rstride + p.col, a.d.out, y);
        }
      }
    }
  }
}

template <int V, int M, int T>
__global__ void __launch_bounds__(THREADS) bn_run_apply(ApplyArgs a) {
  constexpr int NV = STATS_ELEMS / V, U = apply_vectors(V);
  const Geo& g = a.g;
  const int c = blockIdx.y;
  float mu, rs, w, b;
  consts(c, a.mean, a.var, a.eps, a.w, a.b, a.d, mu, rs, w, b);
  const bool hw = a.w != nullptr, hb = a.b != nullptr;
  const bool hr = add_tail(tail_of<T>(a.d));
  for (int k = blockIdx.x; k < g.chunks; k += gridDim.x) {
    Walk wk(g, k, V);
#pragma unroll 1
    for (int i0 = 0; i0 < NV; i0 += U) {
      float v[U][V], res[U][V];
      long long e[U];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        ok[u] = wk.j < g.n;
        e[u] = wk.at(g, c);
        if (ok[u]) {
          ld<V, M>(a.x, e[u], a.d.x, v[u]);
          if (hr) ld<V, M>(a.r, e[u], a.d.r, res[u]);
          else zero<V>(res[u]);
        }
        wk.next(g, THREADS * V);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (ok[u]) {
          float y[V];
#pragma unroll
          for (int j = 0; j < V; ++j)
            y[j] = apply1<M, T>(v[u][j], res[u][j], mu, rs, w, b, a.d,
                                hw, hb);
          st<V, M>(a.out, e[u], a.d.out, y);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// (c), (d) backward
// ---------------------------------------------------------------------------
struct BwdArgs {
  const void *x, *dy, *out, *w, *b, *r;
  const float *mean, *var;
  float* part;       // [blocks][2][C]: sum(g), sum(g xhat)
  float* sums;       // [C][2]: sum(g), sum(g xhat)
  void *dw, *db, *dx, *dres;
  float eps;
  int batch_stats;
  // the reduce writes g into dres (the residual's gradient, in the tail's
  // dtype) and the apply reads it back for dx, instead of x's tail again
  int gres;
  Geo g;
  Codes d;
};

// the tensors the backward reads at element e: x, dy and the saved output
// (tail 2) or the residual (tail 4)
template <int V, int M, int T>
__device__ __forceinline__ void bwd_load(const BwdArgs& a, long long e,
                                         float (&x)[V], float (&dy)[V],
                                         float (&o)[V]) {
  ld<V, M>(a.x, e, a.d.x, x);
  ld<V, M>(a.dy, e, a.d.dy, dy);
  if (tail_of<T>(a.d) == 2) {
    ld<V, M>(a.out, e, a.d.out, o);
  } else if (tail_of<T>(a.d) == 4) {
    ld<V, M>(a.r, e, a.d.r, o);
  } else {
    zero<V>(o);
  }
}

// the saved output (tail 2) or the residual (tail 4) as grad_in takes them
template <int T>
__device__ __forceinline__ float out_of(const Codes& d, float o) {
  return tail_of<T>(d) == 2 ? o : 0.f;
}
template <int T>
__device__ __forceinline__ float res_of(const Codes& d, float o) {
  return tail_of<T>(d) == 4 ? o : 0.f;
}

__device__ __forceinline__ void bwd_out(const BwdArgs& a, int c, float sg,
                                        float sgx) {
  a.sums[2 * c] = sg;
  a.sums[2 * c + 1] = sgx;
  if (a.dw != nullptr) st1(a.dw, c, a.d.dw, sgx);
  if (a.db != nullptr) st1(a.db, c, a.d.db, sg);
}

template <int V, int M, int T>
__global__ void __launch_bounds__(THREADS) bn_col_bwd_reduce(BwdArgs a) {
  constexpr int U = apply_vectors(V);
  __shared__ float sm[2][COL_SMEM];
  const Geo& g = a.g;
  const ColPos p(g, V);
  const int t = threadIdx.x;
  float sg[V], sgx[V];
#pragma unroll
  for (int j = 0; j < V; ++j) sg[j] = sgx[j] = 0.f;
  if (p.live) {
    float mu[V], rs[V], w[V], b[V];
#pragma unroll
    for (int j = 0; j < V; ++j)
      consts(p.channel(g, j), a.mean, a.var, a.eps, a.w, a.b, a.d, mu[j],
             rs[j], w[j], b[j]);
    const bool hw = a.w != nullptr, hb = a.b != nullptr;
    for (int q = blockIdx.x; q < g.chunks; q += gridDim.x) {
      const long long r1 = p.end(g, q);
      for (long long r = (long long)q * g.rpc + p.ty; r < r1;
           r += (long long)U * g.ty) {
        float x[U][V], dy[U][V], o[U][V];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const long long rr = r + (long long)u * g.ty;
          if (rr < r1)
            bwd_load<V, M, T>(a, rr * g.rstride + p.col, x[u], dy[u], o[u]);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const long long rr = r + (long long)u * g.ty;
          if (rr < r1) {
            float gi[V];
#pragma unroll
            for (int j = 0; j < V; ++j) {
              gi[j] = grad_in<M, T>(dy[u][j], x[u][j],
                                    out_of<T>(a.d, o[u][j]),
                                    res_of<T>(a.d, o[u][j]), mu[j], rs[j],
                                    w[j], b[j], a.d, hw, hb);
              const float xh = __fmul_rn(__fsub_rn(x[u][j], mu[j]), rs[j]);
              sg[j] = __fadd_rn(sg[j], gi[j]);
              sgx[j] = __fadd_rn(sgx[j], __fmul_rn(gi[j], xh));
            }
            if (a.gres)
              st<V, M>(a.dres, rr * g.rstride + p.col, a.d.dres, gi);
          }
        }
      }
    }
  }
  const int base = p.ty * g.W + p.o;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sm[0][base + j] = sg[j];
    sm[1][base + j] = sgx[j];
  }
  __syncthreads();
  for (int s = 1; s < g.ty; s <<= 1) {
    if (p.ty % (2 * s) == 0 && p.ty + s < g.ty) {
      const int pb = (p.ty + s) * g.W + p.o;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        sg[j] = __fadd_rn(sg[j], sm[0][pb + j]);
        sgx[j] = __fadd_rn(sgx[j], sm[1][pb + j]);
        sm[0][base + j] = sg[j];
        sm[1][base + j] = sgx[j];
      }
    }
    __syncthreads();
  }
  const int c0 = p.grp * g.k, chs = min(g.k, g.C - c0);
  const int S = (int)g.S;
  if (t < chs) {
    float a0 = 0.f, a1 = 0.f;
    for (int i = 0; i < S; ++i) {
      a0 = __fadd_rn(a0, sm[0][t * S + i]);
      a1 = __fadd_rn(a1, sm[1][t * S + i]);
    }
    float* q = a.part + (long long)blockIdx.x * 2 * g.C + c0 + t;
    q[0] = a0;
    q[g.C] = a1;
  }
}

template <int V, int M, int T>
__global__ void __launch_bounds__(THREADS) bn_run_bwd_reduce(BwdArgs a) {
  constexpr int NV = STATS_ELEMS / V, U = apply_vectors(V);
  const Geo& g = a.g;
  const int c = blockIdx.y;
  float mu, rs, w, b;
  consts(c, a.mean, a.var, a.eps, a.w, a.b, a.d, mu, rs, w, b);
  const bool hw = a.w != nullptr, hb = a.b != nullptr;
  float sgj[V], sgxj[V];
#pragma unroll
  for (int j = 0; j < V; ++j) sgj[j] = sgxj[j] = 0.f;
  for (int k = blockIdx.x; k < g.chunks; k += gridDim.x) {
    Walk wk(g, k, V);
#pragma unroll 1
    for (int i0 = 0; i0 < NV; i0 += U) {
      float x[U][V], dy[U][V], o[U][V];
      long long e[U];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        ok[u] = wk.j < g.n;
        e[u] = wk.at(g, c);
        if (ok[u]) bwd_load<V, M, T>(a, e[u], x[u], dy[u], o[u]);
        wk.next(g, THREADS * V);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (ok[u]) {
          float gi[V];
#pragma unroll
          for (int j = 0; j < V; ++j) {
            gi[j] = grad_in<M, T>(dy[u][j], x[u][j], out_of<T>(a.d, o[u][j]),
                                  res_of<T>(a.d, o[u][j]), mu, rs, w, b, a.d,
                                  hw, hb);
            const float xh = __fmul_rn(__fsub_rn(x[u][j], mu), rs);
            sgj[j] = __fadd_rn(sgj[j], gi[j]);
            sgxj[j] = __fadd_rn(sgxj[j], __fmul_rn(gi[j], xh));
          }
          if (a.gres) st<V, M>(a.dres, e[u], a.d.dres, gi);
        }
      }
    }
  }
  float sg = tree_sum<V>(sgj), sgx = tree_sum<V>(sgxj);
  block_sum2(sg, sgx);
  if (threadIdx.x == 0) {
    float* p = a.part + (long long)blockIdx.x * 2 * g.C + c;
    p[0] = sg;
    p[g.C] = sgx;
  }
}

// the backward apply's per-channel constants besides consts': w r, and
// sum(g) / n, sum(g xhat) / n
__device__ __forceinline__ void bwd_consts(const BwdArgs& a, int c, float w,
                                           float rs, float& wr, float& k1,
                                           float& k2) {
  wr = __fmul_rn(w, rs);
  const float inv_n = __fdiv_rn(1.f, (float)a.g.n);
  k1 = a.batch_stats ? __fmul_rn(a.sums[2 * c], inv_n) : 0.f;
  k2 = a.batch_stats ? __fmul_rn(a.sums[2 * c + 1], inv_n) : 0.f;
}

__device__ __forceinline__ float dx1(const BwdArgs& a, float gi, float x,
                                     float mu, float rs, float wr, float k1,
                                     float k2) {
  if (!a.batch_stats) return __fmul_rn(wr, gi);
  const float xh = __fmul_rn(__fsub_rn(x, mu), rs);
  return __fmul_rn(wr, __fsub_rn(__fsub_rn(gi, k1), __fmul_rn(xh, k2)));
}

template <int V, int M, int T>
__global__ void __launch_bounds__(THREADS) bn_col_bwd_apply(BwdArgs a) {
  constexpr int U = apply_vectors(V);
  const Geo& g = a.g;
  const ColPos p(g, V);
  if (!p.live) return;
  float mu[V], rs[V], w[V], b[V], wr[V], k1[V], k2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = p.channel(g, j);
    consts(c, a.mean, a.var, a.eps, a.w, a.b, a.d, mu[j], rs[j], w[j],
              b[j]);
    bwd_consts(a, c, w[j], rs[j], wr[j], k1[j], k2[j]);
  }
  const bool hw = a.w != nullptr, hb = a.b != nullptr;
  for (int q = blockIdx.x; q < g.chunks; q += gridDim.x) {
    const long long r1 = p.end(g, q);
    for (long long r = (long long)q * g.rpc + p.ty; r < r1;
         r += (long long)U * g.ty) {
      float x[U][V], dy[U][V], o[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long rr = r + (long long)u * g.ty;
        if (rr >= r1) continue;
        if (a.gres) {
          ld<V, M>(a.x, rr * g.rstride + p.col, a.d.x, x[u]);
          ld<V, M>(a.dres, rr * g.rstride + p.col, a.d.dres, dy[u]);
          zero<V>(o[u]);
        } else {
          bwd_load<V, M, T>(a, rr * g.rstride + p.col, x[u], dy[u], o[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long rr = r + (long long)u * g.ty;
        if (rr < r1) {
          float gi[V], d[V];
#pragma unroll
          for (int j = 0; j < V; ++j) {
            gi[j] = a.gres ? dy[u][j]
                           : grad_in<M, T>(dy[u][j], x[u][j],
                                           out_of<T>(a.d, o[u][j]),
                                           res_of<T>(a.d, o[u][j]), mu[j],
                                           rs[j], w[j], b[j], a.d, hw, hb);
            d[j] = dx1(a, gi[j], x[u][j], mu[j], rs[j], wr[j], k1[j], k2[j]);
          }
          const long long e = rr * g.rstride + p.col;
          if (a.dres != nullptr && !a.gres) st<V, M>(a.dres, e, a.d.dres, gi);
          if (a.dx != nullptr) st<V, M>(a.dx, e, a.d.dx, d);
        }
      }
    }
  }
}

template <int V, int M, int T>
__global__ void __launch_bounds__(THREADS) bn_run_bwd_apply(BwdArgs a) {
  constexpr int NV = STATS_ELEMS / V, U = apply_vectors(V);
  const Geo& g = a.g;
  const int c = blockIdx.y;
  float mu, rs, w, b, wr, k1, k2;
  consts(c, a.mean, a.var, a.eps, a.w, a.b, a.d, mu, rs, w, b);
  bwd_consts(a, c, w, rs, wr, k1, k2);
  const bool hw = a.w != nullptr, hb = a.b != nullptr;
  for (int k = blockIdx.x; k < g.chunks; k += gridDim.x) {
    Walk wk(g, k, V);
#pragma unroll 1
    for (int i0 = 0; i0 < NV; i0 += U) {
      float x[U][V], dy[U][V], o[U][V];
      long long e[U];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        ok[u] = wk.j < g.n;
        e[u] = wk.at(g, c);
        if (ok[u]) {
          if (a.gres) {
            ld<V, M>(a.x, e[u], a.d.x, x[u]);
            ld<V, M>(a.dres, e[u], a.d.dres, dy[u]);
            zero<V>(o[u]);
          } else {
            bwd_load<V, M, T>(a, e[u], x[u], dy[u], o[u]);
          }
        }
        wk.next(g, THREADS * V);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (ok[u]) {
          float gi[V], d[V];
#pragma unroll
          for (int j = 0; j < V; ++j) {
            gi[j] = a.gres ? dy[u][j]
                           : grad_in<M, T>(dy[u][j], x[u][j],
                                           out_of<T>(a.d, o[u][j]),
                                           res_of<T>(a.d, o[u][j]), mu, rs,
                                           w, b, a.d, hw, hb);
            d[j] = dx1(a, gi[j], x[u][j], mu, rs, wr, k1, k2);
          }
          if (a.dres != nullptr && !a.gres)
            st<V, M>(a.dres, e[u], a.d.dres, gi);
          if (a.dx != nullptr) st<V, M>(a.dx, e[u], a.d.dx, d);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the folds: a channel's partials (one a block of the reducing launch) by
// fold_ph threads (the partials' power of two, at most a block; THREADS /
// fold_ph channels a block), thread ph taking the partials ph, ph + fold_ph,
// ... in order, then a fixed tree over the channel's threads in shared
// memory
// ---------------------------------------------------------------------------
// the statistics, by Chan's formula throughout
__global__ void __launch_bounds__(THREADS) bn_fold_stats(StatsArgs a) {
  __shared__ float sh[3][THREADS];
  const Geo& g = a.g;
  const int PH = g.fold_ph, cpb = THREADS / PH, t = threadIdx.x;
  const int ph = t / cpb;
  const int c = blockIdx.x * cpb + t % cpb;
  const bool on = c < g.C;
  float n = 0.f, m = 0.f, M2 = 0.f;
  if (on) {
    for (int q = ph; q < g.parts; q += PH) {
      const float* pq = a.part + (long long)q * 3 * g.C + c;
      chan(n, m, M2, __ldcg(pq), __ldcg(pq + g.C), __ldcg(pq + 2 * g.C));
    }
  }
  sh[0][t] = n;
  sh[1][t] = m;
  sh[2][t] = M2;
  for (int st = PH / 2; st > 0; st >>= 1) {
    __syncthreads();
    if (ph < st) {
      const int b = t + st * cpb;
      chan(n, m, M2, sh[0][b], sh[1][b], sh[2][b]);
      sh[0][t] = n;
      sh[1][t] = m;
      sh[2][t] = M2;
    }
  }
  if (on && ph == 0) stats_out(a, c, n, m, M2);
}

// the backward's sums of g and g xhat
__global__ void __launch_bounds__(THREADS) bn_fold_sums(BwdArgs a) {
  __shared__ float sh[2][THREADS];
  const Geo& g = a.g;
  const int PH = g.fold_ph, cpb = THREADS / PH, t = threadIdx.x;
  const int ph = t / cpb;
  const int c = blockIdx.x * cpb + t % cpb;
  const bool on = c < g.C;
  float sg = 0.f, sgx = 0.f;
  if (on) {
    for (int q = ph; q < g.parts; q += PH) {
      const float* pq = a.part + (long long)q * 2 * g.C + c;
      sg = __fadd_rn(sg, __ldcg(pq));
      sgx = __fadd_rn(sgx, __ldcg(pq + g.C));
    }
  }
  sh[0][t] = sg;
  sh[1][t] = sgx;
  for (int st = PH / 2; st > 0; st >>= 1) {
    __syncthreads();
    if (ph < st) {
      sg = __fadd_rn(sg, sh[0][t + st * cpb]);
      sgx = __fadd_rn(sgx, sh[1][t + st * cpb]);
      sh[0][t] = sg;
      sh[1][t] = sgx;
    }
  }
  if (on && ph == 0) bwd_out(a, c, sg, sgx);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
enum { ROUTE_COL = 0, ROUTE_RUN = 1 };

// the planner's packed plan (ops/batch_norm.py, BNPlan.packed): route, V,
// n, S, C, chunks, rows, rstride, rpc, W, k, tx, ty, groups, mode
struct Plan {
  int route, V, groups, mode;
  Geo g;
};

Plan plan_of(const long long* p) {
  Plan pl;
  pl.route = (int)p[0];
  pl.V = (int)p[1];
  pl.g.n = p[2];
  pl.g.S = p[3];
  pl.g.C = (int)p[4];
  pl.g.chunks = (int)p[5];
  pl.g.rows = p[6];
  pl.g.rstride = p[7];
  pl.g.rpc = p[8];
  pl.g.W = (int)p[9];
  pl.g.k = (int)p[10];
  pl.g.tx = (int)p[11];
  pl.g.ty = (int)p[12];
  pl.groups = (int)p[13];
  pl.mode = (int)p[14];
  return pl;
}

// the codes' order: ops/batch_norm.py, _CODE_ORDER, then the tail
Codes codes_of(const int* c) {
  return Codes{c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7],
               c[8], c[9], c[10], c[11], c[12], c[13], c[14]};
}

// the blocks of `kern` at `threads` each that the card holds at once (its
// SMs times the blocks an SM holds), once a kernel, block size and device
int resident(const void* kern, int threads) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int>, int> seen;
  int dev = 0;
  cudaGetDevice(&dev);
  const auto key = std::make_tuple(kern, threads, dev);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = seen.find(key);
  if (it != seen.end()) return it->second;
  int per_sm = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, 0);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int n = (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  seen.emplace(key, n);
  return n;
}

// a launch's grid: (blocks a channel or group, channels or groups), each
// block walking the chunks x, x + gridDim.x, ...: as few rounds of chunks
// as the card's resident blocks allow, and the fewest blocks that take the
// chunks in that many rounds (so that no block takes a round more)
dim3 grid_of(const Plan& p, const void* kern) {
  const int y = p.route == ROUTE_RUN ? p.g.C : p.groups;
  int fit = resident(kern, p.route == ROUTE_RUN ? THREADS
                                                : p.g.tx * p.g.ty) / y;
  fit = fit < 1 ? 1 : fit;
  const int rounds = (p.g.chunks + fit - 1) / fit;
  return dim3((p.g.chunks + rounds - 1) / rounds, y);
}



dim3 block_of(const Plan& p) {
  return dim3(p.route == ROUTE_RUN ? THREADS : p.g.tx * p.g.ty);
}

// the fold's threads a channel: the partials' power of two, at most a block
int fold_ph(int parts) {
  int ph = 1;
  while (ph < parts && ph < THREADS) ph <<= 1;
  return ph;
}

// the fold's grid: THREADS / fold_ph channels a block
dim3 fold_grid(const Geo& g) {
  const int cpb = THREADS / g.fold_ph;
  return dim3((g.C + cpb - 1) / cpb);
}

template <int V_, int M_, int T_>
struct Tag {
  static constexpr int V = V_;
  static constexpr int M = M_;
  static constexpr int T = T_;
};

template <int V, int M, class Fn>
int with_tail(int tail, Fn fn) {
  switch (tail) {
    case 0: fn(Tag<V, M, 0>{}); break;
    case 1: fn(Tag<V, M, 1>{}); break;
    case 2: fn(Tag<V, M, 2>{}); break;
    case 3: fn(Tag<V, M, 3>{}); break;
    case 4: fn(Tag<V, M, 4>{}); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// fn(Tag<V, M, T>{}) for the plan's mode and the launch's tail: fp32 at 4
// elements a load, O2's bf16 at 8, each with the tail fixed; anything else
// one element a load, the tail read at run time
template <class Fn>
int dispatch(int mode, int tail, Fn fn) {
  switch (mode) {
    case MF32:
      return with_tail<4, MF32>(tail, fn);
    case MBF16:
      return with_tail<8, MBF16>(tail, fn);
    case MGEN:
      fn(Tag<1, MGEN, -1>{});
      return (int)cudaGetLastError();
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int bn_stats(const void* x, float* part, float* mean, float* var,
                        float* run_mean, float* run_var, float mom,
                        float one_minus_mom, float unbias,
                        const long long* plan, const int* codes,
                        void* stream) {
  const Plan pl = plan_of(plan);
  StatsArgs a{x, part, mean, var, run_mean, run_var,
              mom, one_minus_mom, unbias, pl.g, codes_of(codes)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = dispatch(pl.mode, codes[14], [&](auto tag) {
    constexpr int V = decltype(tag)::V;
    constexpr int M = decltype(tag)::M;
    const auto kern = pl.route == ROUTE_RUN ? bn_run_stats<V, M>
                                            : bn_col_stats<V, M>;
    const dim3 gr = grid_of(pl, (const void*)kern);
    a.g.parts = gr.x;
    a.g.fold_ph = fold_ph(gr.x);
    kern<<<gr, block_of(pl), 0, st>>>(a);
  });
  if (err != 0) return err;
  bn_fold_stats<<<fold_grid(a.g), THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int bn_apply(const void* x, const void* w, const void* b,
                        const void* r, void* out, const float* mean,
                        const float* var, float eps, const long long* plan,
                        const int* codes, void* stream) {
  const Plan pl = plan_of(plan);
  ApplyArgs a{x, w, b, r, out, mean, var, eps, pl.g, codes_of(codes)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(pl.mode, codes[14], [&](auto tag) {
    constexpr int V = decltype(tag)::V;
    constexpr int M = decltype(tag)::M;
    constexpr int T = decltype(tag)::T;
    const auto kern = pl.route == ROUTE_RUN ? bn_run_apply<V, M, T>
                                            : bn_col_apply<V, M, T>;
    kern<<<grid_of(pl, (const void*)kern), block_of(pl), 0, st>>>(a);
  });
}

extern "C" int bn_bwd(int phase, const void* x, const void* dy,
                      const void* out, const void* w, const void* b,
                      const void* r, const float* mean, const float* var,
                      float* part, float* sums, void* dw, void* db, void* dx,
                      void* dres, float eps, int batch_stats, int gres,
                      const long long* plan, const int* codes, void* stream) {
  const Plan pl = plan_of(plan);
  BwdArgs a{x, dy, out, w, b, r, mean, var, part, sums, dw, db, dx,
            dres, eps, batch_stats, gres, pl.g, codes_of(codes)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = dispatch(pl.mode, codes[14], [&](auto tag) {
    constexpr int V = decltype(tag)::V;
    constexpr int M = decltype(tag)::M;
    constexpr int T = decltype(tag)::T;
    const auto run = phase == 0 ? bn_run_bwd_reduce<V, M, T>
                                : bn_run_bwd_apply<V, M, T>;
    const auto col = phase == 0 ? bn_col_bwd_reduce<V, M, T>
                                : bn_col_bwd_apply<V, M, T>;
    const auto kern = pl.route == ROUTE_RUN ? run : col;
    const dim3 gr = grid_of(pl, (const void*)kern);
    a.g.parts = gr.x;
    a.g.fold_ph = fold_ph(gr.x);
    kern<<<gr, block_of(pl), 0, st>>>(a);
  });
  if (err != 0 || phase != 0) return err;
  bn_fold_sums<<<fold_grid(a.g), THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}
