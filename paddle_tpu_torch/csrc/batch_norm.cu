// K10: batch norm, forward and backward, for Hopper (sm_90a), with the
// ResNet blocks' tails fused into the apply: bn + ReLU, and bn + the
// residual add + ReLU; and PP-YOLOE's: bn + swish, and bn + the residual
// add + swish (a RepVGG block's two branches). The port's own kernel: the JAX package computes
// batch_norm_stats and batch_norm (paddle_tpu/ops/nn_ops.py:210-264) as
// XLA-fused jnp, no pallas_call.
//
// Every launch works on an (N, C, S) view of a contiguous tensor: element
// (n, c, s) lies at (n C + c) S + s. NCHW, NCL and NCDHW are (N, C, H W ...);
// NHWC-like layouts are (N H W ..., C, 1). A block takes one chunk of one
// channel: CHUNK = 4096 consecutive elements of the channel's N S (the
// block's 256 threads hold 16 each, thread t the elements t + 256 i), so the
// grid is (chunks, C) and every per-channel constant sits in registers.
//
// Four launches (rnd(v, t): v rounded to dtype t; all arithmetic fp32):
//   (a) bn_stats: per channel, the mean and the biased variance of x. Each
//       thread takes its 16 values' mean and sum of squared deviations
//       (two passes over registers, never E[x^2] - E[x]^2), the block
//       merges them by Chan's formula in a fixed tree, and writes its
//       partial. The block that finds itself last of its channel (an
//       integer ticket; no floating-point atomics) folds the channel's
//       partials in chunk order, writes mean and var, updates the running
//       buffers as the reference does (m r + (1 - m) batch, the variance
//       made unbiased by n / (n - 1)) and puts the ticket back to 0.
//   (b) bn_apply: t = (x - mean) rsqrt(var + eps), rounded to norm_dt, then
//       rnd(t w, wmul_dt), then rnd(t + b, badd_dt) (the reference's order
//       and rounding points), with the batch's or the running statistics;
//       tail 1: relu(rnd(t, act_dt)); tail 2: relu(rnd(rnd(t, act_dt) +
//       rnd(residual, act_dt), act_dt)); tail 3: swish(z) for z = rnd(t,
//       act_dt); tail 4: swish(z) for z = rnd(rnd(t, act_dt) +
//       rnd(residual, act_dt), act_dt), swish(z) = z / (1 + expf(-z)).
//       Stored in out_dt.
//   (c) bn_bwd_reduce: g = dy, masked where the block output is not > 0
//       (tails 1 and 2); for the swish tails (3 and 4), which cannot be
//       inverted from the output, g = rnd(dy (s + z s (1 - s)), act_dt)
//       with s = 1 / (1 + expf(-z)), z recomputed as the apply computes it
//       from x, the statistics, w, b (and the residual); per channel
//       sum(g) and sum(g xhat), as (a), the
//       last block writing the sums and dw = rnd(sum(g xhat), w's dtype),
//       db = rnd(sum(g), b's dtype).
//   (d) bn_bwd_apply: dx = w r (g - sum(g) / n - xhat sum(g xhat) / n) with
//       batch statistics, w r g with the running ones; the residual's
//       gradient g (tails 2 and 4), each rounded to its tensor's dtype.
// Launches on the same inputs agree bit for bit: every sum has a fixed
// order whatever the blocks' timing.
//
// Bound: bytes. (a) reads x; (b) reads x (and the residual) and writes the
// output; (c) reads x, dy (and the output, or for the swish tails the
// bias and the residual); (d) reads them again and writes
// dx (and the residual's gradient). The design is the simple one: one
// element a load, 16 a thread; a chunk per block fills the card for every
// ResNet-50 shape at batch 64 (2048 to 12544 blocks).

#include <cuda_runtime.h>

#include <cstdint>

#include "fused_io.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PER = 16;
constexpr int CHUNK = THREADS * PER;
constexpr int WARPS = THREADS / 32;

struct Geo {
  long long n;     // elements of a channel (N S)
  long long S;     // inner extent
  int C;
  int chunks;      // blocks a channel
  unsigned magic;  // j / S == (j magic) >> (31 + shift) for j < 2^31
  int shift;
};

__device__ __forceinline__ float ld1(const void* p, long long i, int dt) {
  float v[1];
  ldv<1>(p, i, dt, v);
  return v[0];
}

__device__ __forceinline__ void st1(void* p, long long i, int dt, float v) {
  const float a[1] = {v};
  stv<1>(p, i, dt, a);
}

// the address of element j of channel c
__device__ __forceinline__ long long addr(const Geo& g, int c, long long j) {
  const long long r =
      (long long)(((unsigned long long)j * g.magic) >> (31 + g.shift));
  return (r * g.C + c) * g.S + (j - r * g.S);
}

__device__ __forceinline__ float relu(float z) {
  return (z > 0.f || z != z) ? z : 0.f;
}

// the swish tails: codes 3 and 4; 2 and 4 add the residual
__device__ __forceinline__ bool swish_tail(int tail) { return tail >= 3; }
__device__ __forceinline__ bool add_tail(int tail) {
  return tail == 2 || tail == 4;
}

__device__ __forceinline__ float sigm(float z) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-z)));
}

__device__ __forceinline__ float swish(float z) {
  return __fdiv_rn(z, __fadd_rn(1.f, expf(-z)));
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

// the block's merge of every thread's (n, m, M), the result in thread 0: a
// fixed tree (shuffles down within warps, then warp 0 in order)
__device__ void block_chan(float& n, float& m, float& M) {
  __shared__ float sh[3][WARPS];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float nb = __shfl_down_sync(0xffffffffu, n, o);
    const float mb = __shfl_down_sync(0xffffffffu, m, o);
    const float Mb = __shfl_down_sync(0xffffffffu, M, o);
    chan(n, m, M, nb, mb, Mb);
  }
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) {
    sh[0][w] = n;
    sh[1][w] = m;
    sh[2][w] = M;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < WARPS; ++i) chan(n, m, M, sh[0][i], sh[1][i], sh[2][i]);
  }
}

// the block's sums of two values, in thread 0, in a fixed tree
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

// thread 0 writes the block's partial and takes a ticket; true in every
// thread of the channel's last block (which then sees every partial)
__device__ bool last_of_channel(unsigned* ticket, int c, int chunks) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket + c, 1u) == (unsigned)(chunks - 1);
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

struct StatsArgs {
  const void* x;
  int x_dt;
  Geo g;
  float* part;      // [C][chunks][3]: count, mean, M2
  unsigned* ticket; // [C], 0 between launches
  float *mean, *var;
  float *run_mean, *run_var;  // or null
  float mom, one_minus_mom, unbias;
};

__global__ void __launch_bounds__(THREADS) bn_stats_kernel(StatsArgs a) {
  const int c = blockIdx.y, k = blockIdx.x, t = threadIdx.x;
  const long long j0 = (long long)k * CHUNK + t;
  float v[PER];
  float cnt = 0.f, s = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const long long j = j0 + (long long)i * THREADS;
    v[i] = j < a.g.n ? ld1(a.x, addr(a.g, c, j), a.x_dt) : 0.f;
    if (j < a.g.n) {
      cnt = __fadd_rn(cnt, 1.f);
      s = __fadd_rn(s, v[i]);
    }
  }
  float m = cnt > 0.f ? __fdiv_rn(s, cnt) : 0.f, M = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    if (j0 + (long long)i * THREADS < a.g.n) {
      const float d = __fsub_rn(v[i], m);
      M = __fadd_rn(M, __fmul_rn(d, d));
    }
  }
  block_chan(cnt, m, M);
  float* p = a.part + ((long long)c * a.g.chunks + k) * 3;
  if (t == 0) {
    p[0] = cnt;
    p[1] = m;
    p[2] = M;
  }
  if (!last_of_channel(a.ticket, c, a.g.chunks)) return;
  cnt = 0.f;
  m = 0.f;
  M = 0.f;
  for (int q = t; q < a.g.chunks; q += THREADS) {
    const float* pq = a.part + ((long long)c * a.g.chunks + q) * 3;
    chan(cnt, m, M, __ldcg(pq), __ldcg(pq + 1), __ldcg(pq + 2));
  }
  block_chan(cnt, m, M);
  if (t == 0) {
    const float var = __fdiv_rn(M, cnt);
    a.mean[c] = m;
    a.var[c] = var;
    if (a.run_mean != nullptr) {
      a.run_mean[c] = __fadd_rn(__fmul_rn(a.mom, a.run_mean[c]),
                                __fmul_rn(a.one_minus_mom, m));
      a.run_var[c] =
          __fadd_rn(__fmul_rn(a.mom, a.run_var[c]),
                    __fmul_rn(a.one_minus_mom, __fmul_rn(var, a.unbias)));
    }
    a.ticket[c] = 0u;
  }
}

struct ApplyArgs {
  const void *x, *w, *b, *r;
  void* out;
  const float *mean, *var;
  Geo g;
  float eps;
  int x_dt, w_dt, b_dt, r_dt, out_dt;
  int norm_dt, wmul_dt, badd_dt, act_dt;
  int tail;  // 0 none, 1 relu, 2 add then relu, 3 swish, 4 add then swish
};

// the tail's input z from the affine output y: the residual added (tails
// 2 and 4), rounded to act_dt
__device__ __forceinline__ float tail_in(float y, int tail, const void* r,
                                         long long e, int r_dt, int act_dt) {
  if (add_tail(tail))
    y = rnd(__fadd_rn(rnd(y, act_dt), rnd(ld1(r, e, r_dt), act_dt)), act_dt);
  return rnd(y, act_dt);
}

__global__ void __launch_bounds__(THREADS) bn_apply_kernel(ApplyArgs a) {
  const int c = blockIdx.y, k = blockIdx.x, t = threadIdx.x;
  const float mu = a.mean[c];
  const float rs = __frsqrt_rn(__fadd_rn(a.var[c], a.eps));
  const float w = a.w != nullptr ? ld1(a.w, c, a.w_dt) : 1.f;
  const float b = a.b != nullptr ? ld1(a.b, c, a.b_dt) : 0.f;
  const long long j0 = (long long)k * CHUNK + t;
#pragma unroll 4
  for (int i = 0; i < PER; ++i) {
    const long long j = j0 + (long long)i * THREADS;
    if (j >= a.g.n) break;
    const long long e = addr(a.g, c, j);
    float y = rnd(__fmul_rn(__fsub_rn(ld1(a.x, e, a.x_dt), mu), rs),
                  a.norm_dt);
    if (a.w != nullptr) y = rnd(__fmul_rn(y, w), a.wmul_dt);
    if (a.b != nullptr) y = rnd(__fadd_rn(y, b), a.badd_dt);
    if (a.tail != 0) {
      y = tail_in(y, a.tail, a.r, e, a.r_dt, a.act_dt);
      y = swish_tail(a.tail) ? swish(y) : relu(y);
    }
    st1(a.out, e, a.out_dt, y);
  }
}

struct BwdArgs {
  const void *x, *dy, *out, *w;
  const float *mean, *var;
  Geo g;
  float eps;
  int x_dt, dy_dt, out_dt, w_dt;
  int tail;
  // the swish tails' recompute of z: the bias, the residual, the apply's
  // rounding points
  const void *b, *r;
  int b_dt, r_dt, norm_dt, wmul_dt, badd_dt, act_dt;
  // reduce
  float* part;       // [C][chunks][2]
  unsigned* ticket;
  float* sums;       // [C][2]: sum(g), sum(g xhat)
  void *dw, *db;
  int dw_dt, db_dt;
  // apply
  void *dx, *dres;
  int dx_dt, dres_dt, batch_stats;
};

// the gradient at the tail's input; w and b are the channel's weight and
// bias (1 and 0 where absent), xs = x - mean, rs = rsqrt(var + eps)
__device__ __forceinline__ float grad_in(const BwdArgs& a, long long e,
                                         float xs, float rs, float w,
                                         float b) {
  const float g = ld1(a.dy, e, a.dy_dt);
  if (a.tail == 0) return g;
  if (!swish_tail(a.tail)) return ld1(a.out, e, a.out_dt) > 0.f ? g : 0.f;
  float y = rnd(__fmul_rn(xs, rs), a.norm_dt);
  if (a.w != nullptr) y = rnd(__fmul_rn(y, w), a.wmul_dt);
  if (a.b != nullptr) y = rnd(__fadd_rn(y, b), a.badd_dt);
  const float z = tail_in(y, a.tail, a.r, e, a.r_dt, a.act_dt);
  const float s = sigm(z);
  const float d =
      __fadd_rn(s, __fmul_rn(__fmul_rn(z, s), __fsub_rn(1.f, s)));
  return rnd(__fmul_rn(g, d), a.act_dt);
}

__global__ void __launch_bounds__(THREADS) bn_bwd_reduce_kernel(BwdArgs a) {
  const int c = blockIdx.y, k = blockIdx.x, t = threadIdx.x;
  const float mu = a.mean[c];
  const float rs = __frsqrt_rn(__fadd_rn(a.var[c], a.eps));
  const float w = a.w != nullptr ? ld1(a.w, c, a.w_dt) : 1.f;
  const float b = a.b != nullptr ? ld1(a.b, c, a.b_dt) : 0.f;
  const long long j0 = (long long)k * CHUNK + t;
  float sg = 0.f, sgx = 0.f;
#pragma unroll 4
  for (int i = 0; i < PER; ++i) {
    const long long j = j0 + (long long)i * THREADS;
    if (j >= a.g.n) break;
    const long long e = addr(a.g, c, j);
    const float xs = __fsub_rn(ld1(a.x, e, a.x_dt), mu);
    const float g = grad_in(a, e, xs, rs, w, b);
    const float xh = __fmul_rn(xs, rs);
    sg = __fadd_rn(sg, g);
    sgx = __fadd_rn(sgx, __fmul_rn(g, xh));
  }
  block_sum2(sg, sgx);
  float* p = a.part + ((long long)c * a.g.chunks + k) * 2;
  if (t == 0) {
    p[0] = sg;
    p[1] = sgx;
  }
  if (!last_of_channel(a.ticket, c, a.g.chunks)) return;
  sg = 0.f;
  sgx = 0.f;
  for (int q = t; q < a.g.chunks; q += THREADS) {
    const float* pq = a.part + ((long long)c * a.g.chunks + q) * 2;
    sg = __fadd_rn(sg, __ldcg(pq));
    sgx = __fadd_rn(sgx, __ldcg(pq + 1));
  }
  block_sum2(sg, sgx);
  if (t == 0) {
    a.sums[2 * c] = sg;
    a.sums[2 * c + 1] = sgx;
    if (a.dw != nullptr) st1(a.dw, c, a.dw_dt, sgx);
    if (a.db != nullptr) st1(a.db, c, a.db_dt, sg);
    a.ticket[c] = 0u;
  }
}

__global__ void __launch_bounds__(THREADS) bn_bwd_apply_kernel(BwdArgs a) {
  const int c = blockIdx.y, k = blockIdx.x, t = threadIdx.x;
  const float mu = a.mean[c];
  const float rs = __frsqrt_rn(__fadd_rn(a.var[c], a.eps));
  const float w = a.w != nullptr ? ld1(a.w, c, a.w_dt) : 1.f;
  const float b = a.b != nullptr ? ld1(a.b, c, a.b_dt) : 0.f;
  const float wr = __fmul_rn(w, rs);
  const float inv_n = __fdiv_rn(1.f, (float)a.g.n);
  const float k1 = __fmul_rn(a.sums[2 * c], inv_n);
  const float k2 = __fmul_rn(a.sums[2 * c + 1], inv_n);
  const long long j0 = (long long)k * CHUNK + t;
#pragma unroll 4
  for (int i = 0; i < PER; ++i) {
    const long long j = j0 + (long long)i * THREADS;
    if (j >= a.g.n) break;
    const long long e = addr(a.g, c, j);
    const float xs = __fsub_rn(ld1(a.x, e, a.x_dt), mu);
    const float g = grad_in(a, e, xs, rs, w, b);
    if (a.dres != nullptr) st1(a.dres, e, a.dres_dt, g);
    if (a.dx == nullptr) continue;
    float d;
    if (a.batch_stats) {
      const float xh = __fmul_rn(xs, rs);
      d = __fmul_rn(wr, __fsub_rn(__fsub_rn(g, k1), __fmul_rn(xh, k2)));
    } else {
      d = __fmul_rn(wr, g);
    }
    st1(a.dx, e, a.dx_dt, d);
  }
}

Geo geo(long long n, long long S, int C, int chunks, unsigned magic,
        int shift) {
  return Geo{n, S, C, chunks, magic, shift};
}

}  // namespace

extern "C" int bn_stats(const void* x, int x_dt, long long n, long long S,
                        int C, int chunks, unsigned magic, int shift,
                        float* part, unsigned* ticket, float* mean, float* var,
                        float* run_mean, float* run_var, float mom,
                        float one_minus_mom, float unbias, void* stream) {
  StatsArgs a{x, x_dt, geo(n, S, C, chunks, magic, shift), part, ticket,
              mean, var, run_mean, run_var, mom, one_minus_mom, unbias};
  bn_stats_kernel<<<dim3(chunks, C), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

extern "C" int bn_apply(const void* x, const void* w, const void* b,
                        const void* r, void* out, const float* mean,
                        const float* var, long long n, long long S, int C,
                        int chunks, unsigned magic, int shift, float eps,
                        int x_dt, int w_dt, int b_dt, int r_dt, int out_dt,
                        int norm_dt, int wmul_dt, int badd_dt, int act_dt,
                        int tail, void* stream) {
  ApplyArgs a{x, w, b, r, out, mean, var,
              geo(n, S, C, chunks, magic, shift), eps, x_dt, w_dt, b_dt,
              r_dt, out_dt, norm_dt, wmul_dt, badd_dt, act_dt, tail};
  bn_apply_kernel<<<dim3(chunks, C), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

extern "C" int bn_bwd(int phase, const void* x, const void* dy,
                      const void* out, const void* w, const float* mean,
                      const float* var, long long n, long long S, int C,
                      int chunks, unsigned magic, int shift, float eps,
                      int x_dt, int dy_dt, int out_dt, int w_dt, int tail,
                      const void* b, const void* r, int b_dt, int r_dt,
                      int norm_dt, int wmul_dt, int badd_dt, int act_dt,
                      float* part, unsigned* ticket, float* sums, void* dw,
                      void* db, int dw_dt, int db_dt, void* dx, void* dres,
                      int dx_dt, int dres_dt, int batch_stats, void* stream) {
  BwdArgs a{x, dy, out, w, mean, var, geo(n, S, C, chunks, magic, shift),
            eps, x_dt, dy_dt, out_dt, w_dt, tail, b, r, b_dt, r_dt,
            norm_dt, wmul_dt, badd_dt, act_dt, part, ticket, sums, dw,
            db, dw_dt, db_dt, dx, dres, dx_dt, dres_dt, batch_stats};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (phase == 0)
    bn_bwd_reduce_kernel<<<dim3(chunks, C), THREADS, 0, st>>>(a);
  else
    bn_bwd_apply_kernel<<<dim3(chunks, C), THREADS, 0, st>>>(a);
  return cudaGetLastError();
}
