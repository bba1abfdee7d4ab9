// Hard-label softmax cross-entropy over the last axis, forward and backward,
// for Hopper (sm_90a). The port's own kernel: the JAX package computes it
// with XLA-fused jnp (paddle_tpu/ops/loss_ops.py cross_entropy), no
// pallas_call.
//
// The logits are (B, L, V) at row strides (sb, sl), the last axis
// contiguous, in bf16, fp16 or fp32, read where they lie: the causal LM
// loss reads rows l < L_used of the model's logits (logits[:, :-1, :]) with
// no copy. Labels are (B, L_used) int32 or int64 at strides (lb, ll). Per
// used row, in fp32 (each logit rounded first to the dtype the op casts it
// to), with label smoothing eps and an optional fp32 class weight w:
//   m = max x, logs = log(sum exp(x - m)), sx = sum x     (one online pass)
//   nll = -((x[y] - m) - logs), 0 for a label outside [0, V)
//   loss = nll                                  (eps == 0)
//        = (1 - eps) nll + eps (logs - (sx / V - m))     (eps > 0)
//   loss *= w[y]  (JAX's take: y in [-V, 0) wraps, else NaN)
// 0 where label == ignore_index (when ignore_index >= 0; the row then does
// not count). This is -sum(target * log_softmax(x)) * w[y] with the JAX
// package's target: one_hot(y) (zero outside [0, V)) * (1 - eps) + eps / V.
// A second kernel folds the rows in a fixed order (reduction "mean" or
// "sum"; "none" keeps the per-row losses):
//   out = [sum(loss) / max(count, 1) or sum(loss), count]
// The backward reads the loss's gradient g from device memory (a scalar, or
// one a row for "none") and writes, for every row of the (B, L, V) logits
// (rows l >= L_used and rows that do not count get 0, or NaN where w[y] is
// NaN, as 0 * w[y] is in JAX's gradient):
//   dx = c S p - c eps / V - c (1 - eps) [at the label],
//   p = exp((x - m) - logs), S = sum(target) = (1 - eps) [y in range] + eps,
//   c = w[y] g / max(count, 1) ("mean"), w[y] g ("sum", "none")
// rounded to the logits' dtype: what the fp32 cast's backward rounds to.
// At eps == 0 with no weight the operations are those of the unsmoothed
// kernel, bit for bit. Nothing is atomic, so every launch gives the same
// bits.
//
// Bound: bytes (forward: one read of the logits; backward: one read and one
// write). Design: one block per row, 16-byte vector loads when the rows
// allow it, a running (max, sum) per thread folded over the block.

#include <cuda_runtime.h>

#include <cstdint>

#include "fused_io.cuh"

namespace {

constexpr int THREADS = 256;

// (m, s) += (m2, s2): the running max and the sum of exp(x - max)
__device__ __forceinline__ void fold(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;
  s = __fadd_rn(__fmul_rn(s, expf(m - mx)), __fmul_rn(s2, expf(m2 - mx)));
  m = mx;
}

struct Args {
  const void *x, *lab;
  const float* w;  // class weights (V,), or null
  float *m, *logs, *loss, *valid, *out;
  const float* g;
  void* dx;
  long long nb, sb, sl, lb, ll, ignore;
  int L, L_used, V, x_dt, x_cast, lab_dt;
  float eps;
  int red;  // 0 none, 1 sum, 2 mean
};

__device__ __forceinline__ long long label_at(const Args& a, long long b,
                                              long long l) {
  const long long i = b * a.lb + l * a.ll;
  return a.lab_dt == 0 ? (long long)static_cast<const int*>(a.lab)[i]
                       : static_cast<const long long*>(a.lab)[i];
}

// w[y] as jnp.take reads it: negative labels from -V wrap, others outside
// the table read NaN; 1 without a weight
__device__ __forceinline__ float weight_at(const Args& a, long long lab) {
  if (a.w == nullptr) return 1.f;
  if (lab < -(long long)a.V || lab >= a.V) return __int_as_float(0x7fc00000);
  return a.w[lab < 0 ? lab + a.V : lab];
}

template <int V>
__global__ void __launch_bounds__(THREADS) ce_fwd_kernel(Args a) {
  __shared__ float red_m[THREADS / 32], red_s[THREADS / 32],
      red_x[THREADS / 32];
  const long long r = blockIdx.x;
  const long long b = r / a.L_used, l = r % a.L_used;
  const long long xo = b * a.sb + l * a.sl;
  float m = -INFINITY, s = 0.f, sx = 0.f;
  for (int c = threadIdx.x * V; c < a.V; c += THREADS * V) {
    float v[V];
    ldv<V>(a.x, xo + c, a.x_dt, v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float t = rnd(v[j], a.x_cast);
      sx = __fadd_rn(sx, t);
      if (t > m) {
        s = __fadd_rn(__fmul_rn(s, expf(m - t)), 1.f);
        m = t;
      } else if (m > -INFINITY) {
        s = __fadd_rn(s, expf(t - m));
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    sx = __fadd_rn(sx, __shfl_xor_sync(0xffffffffu, sx, o));
    fold(m, s, m2, s2);
  }
  if ((threadIdx.x & 31) == 0) {
    red_m[threadIdx.x >> 5] = m;
    red_s[threadIdx.x >> 5] = s;
    red_x[threadIdx.x >> 5] = sx;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  m = red_m[0];
  s = red_s[0];
  sx = red_x[0];
  for (int w = 1; w < THREADS / 32; ++w) {
    fold(m, s, red_m[w], red_s[w]);
    sx = __fadd_rn(sx, red_x[w]);
  }
  const float logs = logf(s);
  const long long lab = label_at(a, b, l);
  const bool valid = a.ignore < 0 || lab != a.ignore;
  float loss = 0.f;
  if (valid) {
    // a label outside the vocabulary one-hots to a zero target: nll 0
    if (lab >= 0 && lab < a.V) {
      float xl[1];
      ldv<1>(a.x, xo + lab, a.x_dt, xl);
      loss = -__fsub_rn(__fsub_rn(rnd(xl[0], a.x_cast), m), logs);
    }
    if (a.eps != 0.f) {
      const float smooth =
          __fsub_rn(logs, __fsub_rn(__fdiv_rn(sx, (float)a.V), m));
      loss = __fadd_rn(__fmul_rn(__fsub_rn(1.f, a.eps), loss),
                       __fmul_rn(a.eps, smooth));
    }
    if (a.w != nullptr) loss = __fmul_rn(loss, weight_at(a, lab));
  }
  a.m[r] = m;
  a.logs[r] = logs;
  a.loss[r] = loss;
  a.valid[r] = valid ? 1.f : 0.f;
}

__global__ void __launch_bounds__(1024) ce_mean_kernel(Args a) {
  __shared__ float red_l[32], red_c[32];
  const long long n = a.nb * a.L_used;
  float sl = 0.f, sc = 0.f;
  for (long long r = threadIdx.x; r < n; r += blockDim.x) {
    sl = __fadd_rn(sl, a.loss[r]);
    sc = __fadd_rn(sc, a.valid[r]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sl += __shfl_xor_sync(0xffffffffu, sl, o);
    sc += __shfl_xor_sync(0xffffffffu, sc, o);
  }
  if ((threadIdx.x & 31) == 0) {
    red_l[threadIdx.x >> 5] = sl;
    red_c[threadIdx.x >> 5] = sc;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  sl = 0.f;
  sc = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    sl = __fadd_rn(sl, red_l[w]);
    sc = __fadd_rn(sc, red_c[w]);
  }
  a.out[0] = a.red == 1 ? sl : __fdiv_rn(sl, fmaxf(sc, 1.f));
  a.out[1] = sc;
}

template <int V>
__global__ void __launch_bounds__(THREADS) ce_bwd_kernel(Args a) {
  const long long r = blockIdx.x;  // a row of the (B, L, V) logits
  const long long b = r / a.L, l = r % a.L;
  const long long ru = b * a.L_used + l;
  bool live = false;
  float w = 0.f, ws = 0.f, we = 0.f, wl = 0.f, m = 0.f, logs = 0.f;
  long long lab = -1;
  if (l < a.L_used) {
    lab = label_at(a, b, l);
    const bool valid = a.valid[ru] != 0.f;
    if (valid) {
      w = a.red == 2 ? __fdiv_rn(*a.g, fmaxf(a.out[1], 1.f))
          : a.red == 1 ? *a.g : a.g[ru];
    }
    if (a.w != nullptr) w = __fmul_rn(w, weight_at(a, lab));
    live = valid || w != w;  // an ignored row's 0 * NaN weight is NaN
  }
  if (live) {
    m = a.m[ru];
    logs = a.logs[ru];
    // c S, c eps / V and c (1 - eps): S is 1 for a label in range at eps 0
    const bool in = lab >= 0 && lab < a.V;
    ws = __fmul_rn(w, __fadd_rn(in ? __fsub_rn(1.f, a.eps) : 0.f, a.eps));
    we = __fmul_rn(w, __fdiv_rn(a.eps, (float)a.V));
    wl = __fmul_rn(w, __fsub_rn(1.f, a.eps));
  }
  const long long xo = b * a.sb + l * a.sl;
  for (int c = threadIdx.x * V; c < a.V; c += THREADS * V) {
    float v[V];
    if (live) {
      ldv<V>(a.x, xo + c, a.x_dt, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float p = expf(__fsub_rn(__fsub_rn(rnd(v[j], a.x_cast), m), logs));
        float d = __fmul_rn(p, ws);
        if (a.eps != 0.f) d = __fsub_rn(d, we);
        if (c + j == lab) d = __fsub_rn(d, wl);
        v[j] = rnd(d, a.x_cast);
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = 0.f;
    }
    stv<V>(a.dx, r * a.V + c, a.x_dt, v);
  }
}

}  // namespace

// x_cast: the dtype the op casts the logits to (fp32 under AMP's black
// list); lab_dt: 0 int32, 1 int64; ignore: ignore_index, honoured when >= 0;
// w: fp32 class weights (V,) or null; eps: label smoothing; red: 0 none
// (no fold: the per-row losses are the result), 1 sum, 2 mean.
// m, logs, loss, valid: fp32 scratch of B * L_used; out: fp32 [2].
extern "C" int ce_fwd(const void* x, const void* lab, const void* w, void* m,
                      void* logs, void* loss, void* valid, void* out,
                      long long nb, int L_used, int V, long long sb,
                      long long sl, long long lb, long long ll,
                      long long ignore, int x_dt, int x_cast, int lab_dt,
                      int vec, float eps, int red, void* stream) {
  Args a{x, lab, static_cast<const float*>(w), static_cast<float*>(m),
         static_cast<float*>(logs), static_cast<float*>(loss),
         static_cast<float*>(valid), static_cast<float*>(out), nullptr,
         nullptr, nb, sb, sl, lb, ll, ignore, L_used, L_used, V, x_dt,
         x_cast, lab_dt, eps, red};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned rows = (unsigned)(nb * L_used);
  if (rows > 0) {
    if (vec == 8)
      ce_fwd_kernel<8><<<rows, THREADS, 0, st>>>(a);
    else
      ce_fwd_kernel<1><<<rows, THREADS, 0, st>>>(a);
  }
  if (red != 0) ce_mean_kernel<<<1, 1024, 0, st>>>(a);
  return cudaGetLastError();
}

// g: the fp32 gradient of the result (device; one a row for red 0); dx:
// (B, L, V) contiguous in the logits' dtype.
extern "C" int ce_bwd(const void* x, const void* lab, const void* w,
                      const void* m, const void* logs, const void* valid,
                      const void* out, const void* g, void* dx, long long nb,
                      int L, int L_used, int V, long long sb, long long sl,
                      long long lb, long long ll, long long ignore, int x_dt,
                      int x_cast, int lab_dt, int vec, float eps, int red,
                      void* stream) {
  Args a{x, lab, static_cast<const float*>(w),
         const_cast<float*>(static_cast<const float*>(m)),
         const_cast<float*>(static_cast<const float*>(logs)), nullptr,
         const_cast<float*>(static_cast<const float*>(valid)),
         const_cast<float*>(static_cast<const float*>(out)),
         static_cast<const float*>(g), dx, nb, sb, sl, lb, ll, ignore, L,
         L_used, V, x_dt, x_cast, lab_dt, eps, red};
  const unsigned rows = (unsigned)(nb * L);
  if (rows == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 8)
    ce_bwd_kernel<8><<<rows, THREADS, 0, st>>>(a);
  else
    ce_bwd_kernel<1><<<rows, THREADS, 0, st>>>(a);
  return cudaGetLastError();
}
