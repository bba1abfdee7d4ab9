// The multi-tensor AdamW update for Hopper (sm_90a): one launch updates
// every parameter of a model (or one run of them), laid out as one flat
// buffer each for the storage (the fp32 master, or the bf16 parameters
// themselves where there is no master), the moments m and v (fp32, bf16 or
// fp16), the gradient and the (fp32, bf16 or fp16) parameter. The port's
// own kernel: the JAX package gets this fusion from XLA
// (paddle_tpu/optimizer/__init__.py, Adam._fused_step), so it replaces no
// Pallas function.
//
// What it computes, in place, for each element of the flat buffers:
//   g = grad (fp32), clipped to [lo, hi] (ClipGradByValue) or times the
//       global-norm scale (ClipGradByGlobalNorm), when asked
//   m' = b1 m + (1 - b1) g,  v' = b2 v + ((1 - b2) g) g     (fp32)
//   w' = w (1 - lr wd) - (lr (m' / c1)) / (sqrt(v' / c2) + eps)
//   m, v <- m', v' rounded to nearest in the moments' dtype (the update
//           itself uses the unrounded m' and v', as _fused_step does)
//   w <- w' in the storage's dtype: fp32 as is; bf16 (the master-free
//        layout) rounded stochastically when asked, else to nearest
//   param <- w' rounded to nearest in the parameter's dtype (when there is
//            a parameter buffer besides an fp32 master)
// in Adam._fused_step's order. lr, decay = 1 - lr wd, c1 = 1 - b1^t,
// c2 = 1 - b2^t, the NaN gate and the global-norm scale are read from
// device memory, a block of fp32 the optimizer fills on the device each
// step (ops/q8_adam.py SCALARS), and so is the rounding seed: a captured
// CUDA graph then reads each replay's own. Where the gate is 0 (a
// non-finite loss under the NaN gate) the kernel writes nothing.
//
// Stochastic rounding is the rule of paddle_tpu.optimizer.
// _stochastic_round_bf16 (16 random bits added below the bf16 mantissa,
// then truncated; inf kept, NaN the sign-keeping quiet NaN), with the bits
// of csrc/q8_adam.cu's sr_bits hash taken over the element's flat index
// base + i, a 64-bit integer (ops/q8_adam.py: sr_bits with base): an
// element draws the same bits whatever run or launch geometry updates it.
//
// With per-tensor tables (parameter groups' LR scales, AdamW's lr_ratio
// and apply_decay_param_fun), each tensor's slice has its own lr = lr_t *
// scale[j] and decay = 1 - lr * wd where its flag is set (else none): the
// thread finds its tensor j by a binary search of the slices' ends (every
// slice starts on a 64-element boundary, so a thread's 8 elements share
// one), the same operations as the optimizer's per-parameter scalars.
//
// Every product, quotient, sum and square root is written with the
// round-to-nearest intrinsics, which nvcc never contracts into an FMA: the
// kernel does its plain version's exact fp32 operations in its order, so
// storage, m, v and the parameter agree bit for bit.
//
// Design: a thread takes 8 consecutive elements (one 16-byte vector of
// bf16 or fp16, two of fp32 per buffer), 256 threads a block, one pass;
// every load is issued before the arithmetic. Bytes an element with a
// 16-bit gradient and parameter and fp32 master and moments: 14 read, 14
// written; in the master-free layout with bf16 moments: 8 read, 6 written.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int PER = 8;

// the block of device scalars (ops/q8_adam.py SCALARS), in this order
enum { SC_LR, SC_DECAY, SC_C1, SC_C2, SC_GATE, SC_GSCALE };

struct Consts {
  float eps, b1, b2, omb1, omb2, lo, hi, wd;
  int has_wd, clip_value, grad_scale;
};

// the per-tensor tables, or seg_end null: every tensor takes the block's
// lr and decay
struct Tables {
  const long long* seg_end;  // (n_seg) end of each slice in the flat buffers
  const float* scale;        // (n_seg) lr scale
  const float* decays;       // (n_seg) 1: decays, 0: does not
  int n_seg;
  long long base;            // flat index of element 0 of this launch
};

struct NoParam {};  // the parameter is the storage itself

__device__ __forceinline__ void load8(const float* __restrict__ p, long i,
                                      float (&x)[PER]) {
  const float4 a = *reinterpret_cast<const float4*>(p + i);
  const float4 b = *reinterpret_cast<const float4*>(p + i + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ p,
                                      long i, float (&x)[PER]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p + i);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x[2 * j] = __uint_as_float(w[j] << 16);
    x[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load8(const __half* __restrict__ p, long i,
                                      float (&x)[PER]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p + i);
  const __half2* h = reinterpret_cast<const __half2*>(&r);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __half22float2(h[j]);
    x[2 * j] = f.x;
    x[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* __restrict__ p, long i,
                                       const float (&x)[PER]) {
  *reinterpret_cast<float4*>(p + i) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(p + i + 4) = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* __restrict__ p, long i,
                                       const float (&x)[PER]) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
    w[j] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p + i) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store8(__half* __restrict__ p, long i,
                                       const float (&x)[PER]) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __half2 h = __floats2half2_rn(x[2 * j], x[2 * j + 1]);
    w[j] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p + i) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store8(NoParam*, long, const float (&)[PER]) {}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void put(float* p, long i, float x) { p[i] = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, long i, float x) {
  p[i] = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void put(__half* p, long i, float x) { p[i] = __float2half_rn(x); }
__device__ __forceinline__ void put(NoParam*, long, float) {}

// 16 rounding bits of flat element gi under seed: csrc/q8_adam.cu's sr_bits
// with the index's high word mixed in (ops/q8_adam.py: sr_bits); for
// gi < 2^32 the same bits as sr_bits(seed, gi)
__device__ __forceinline__ uint32_t flat_sr_bits(uint32_t seed, long long gi) {
  const uint32_t lo = static_cast<uint32_t>(gi);
  const uint32_t hi = static_cast<uint32_t>(static_cast<unsigned long long>(gi) >> 32);
  uint32_t h = (lo * 0x9E3779B1u) ^ (hi * 0x85EBCA77u) ^ (seed * 0xC2B2AE3Du);
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h >> 16;
}

// inf stays inf; NaN becomes the quiet NaN 0x7FC0 with x's sign
// (ops/q8_adam.py: stochastic_round_bf16)
__device__ __forceinline__ uint32_t round_bf16_stochastic(float x, uint32_t rnd) {
  const uint32_t b = __float_as_uint(x);
  uint32_t hi = (b + rnd) >> 16;
  if (isinf(x)) hi = b >> 16;
  if (isnan(x)) hi = ((b >> 16) & 0x8000u) | 0x7FC0u;
  return hi & 0xffffu;
}

// the storage's write: to nearest (SR false) or stochastically from the
// flat index gi0 + e
template <bool SR>
__device__ __forceinline__ void store_w(float* __restrict__ p, long i,
                                        const float (&x)[PER], uint32_t,
                                        long long) {
  store8(p, i, x);
}

template <bool SR>
__device__ __forceinline__ void store_w(__nv_bfloat16* __restrict__ p, long i,
                                        const float (&x)[PER], uint32_t seed,
                                        long long gi0) {
  if (!SR) {
    store8(p, i, x);
    return;
  }
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    w[j] = round_bf16_stochastic(x[2 * j], flat_sr_bits(seed, gi0 + 2 * j)) |
           (round_bf16_stochastic(x[2 * j + 1], flat_sr_bits(seed, gi0 + 2 * j + 1))
            << 16);
  *reinterpret_cast<uint4*>(p + i) = make_uint4(w[0], w[1], w[2], w[3]);
}

template <bool SR>
__device__ __forceinline__ void put_w(float* p, long i, float x, uint32_t,
                                      long long) {
  p[i] = x;
}

template <bool SR>
__device__ __forceinline__ void put_w(__nv_bfloat16* p, long i, float x,
                                      uint32_t seed, long long gi) {
  if (SR)
    p[i] = __ushort_as_bfloat16(static_cast<unsigned short>(
        round_bf16_stochastic(x, flat_sr_bits(seed, gi))));
  else
    p[i] = __float2bfloat16_rn(x);
}

struct Step {
  float lr, decay, c1, c2, gs;
};

__device__ __forceinline__ Step step_scalars(const float* __restrict__ dsc) {
  return Step{dsc[SC_LR], dsc[SC_DECAY], dsc[SC_C1], dsc[SC_C2], dsc[SC_GSCALE]};
}

// the step's scalars for flat element i: the tensor's own lr and decay
// where there are tables (has_wd false: the tensor does not decay)
__device__ __forceinline__ Step tensor_scalars(Step st, const Tables& tb,
                                               long i, const Consts& k,
                                               int& has_wd) {
  if (tb.seg_end == nullptr) return st;
  const long long gi = tb.base + i;
  int lo = 0, hi = tb.n_seg - 1;
  while (lo < hi) {  // first slice whose end lies past gi
    const int mid = (lo + hi) >> 1;
    if (tb.seg_end[mid] > gi) hi = mid; else lo = mid + 1;
  }
  st.lr = __fmul_rn(st.lr, tb.scale[lo]);
  has_wd = has_wd && tb.decays[lo] != 0.f;
  if (has_wd) st.decay = __fsub_rn(1.f, __fmul_rn(st.lr, k.wd));
  return st;
}

// one element: m and v become m' and v' (fp32), the new weight returned
__device__ __forceinline__ float adam_elem(float g, float& m, float& v,
                                           float w, const Step& st,
                                           const Consts& k, int has_wd) {
  if (k.clip_value) g = g < k.lo ? k.lo : (g > k.hi ? k.hi : g);
  if (k.grad_scale) g = __fmul_rn(g, st.gs);
  m = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.omb1, g));
  v = __fadd_rn(__fmul_rn(k.b2, v), __fmul_rn(__fmul_rn(k.omb2, g), g));
  const float mh = __fdiv_rn(m, st.c1);
  const float vh = __fdiv_rn(v, st.c2);
  const float u = has_wd ? __fmul_rn(w, st.decay) : w;
  return __fsub_rn(u, __fdiv_rn(__fmul_rn(st.lr, mh),
                                __fadd_rn(__fsqrt_rn(vh), k.eps)));
}

// TW: the storage (float: the fp32 master; bf16: the master-free flat
// parameters), TM: the moments, TP: the parameter buffer beside an fp32
// master (NoParam: none), TG: the gradient, SR: a bf16 storage rounds
// stochastically
template <typename TW, typename TM, typename TP, typename TG, bool SR>
__global__ void __launch_bounds__(THREADS)
multi_tensor_adam_kernel(TW* __restrict__ w, TM* __restrict__ m,
                         TM* __restrict__ v, TP* __restrict__ param,
                         const TG* __restrict__ grad, long n,
                         const float* __restrict__ dsc,
                         const uint32_t* __restrict__ seedp, Consts k,
                         Tables tb) {
  const long i0 = ((long)blockIdx.x * THREADS + threadIdx.x) * PER;
  if (i0 >= n) return;
  if (i0 + PER <= n) {
    float g[PER], p[PER], mm[PER], vv[PER];
    load8(grad, i0, g);
    load8(w, i0, p);
    load8(m, i0, mm);
    load8(v, i0, vv);
    // the step's scalars, read while the data loads are in flight
    if (dsc[SC_GATE] == 0.f) return;  // the step is withheld: write nothing
    const uint32_t seed = SR ? *seedp : 0u;
    int has_wd = k.has_wd;
    const Step st = tensor_scalars(step_scalars(dsc), tb, i0, k, has_wd);
#pragma unroll
    for (int e = 0; e < PER; ++e)
      p[e] = adam_elem(g[e], mm[e], vv[e], p[e], st, k, has_wd);
    store8(m, i0, mm);
    store8(v, i0, vv);
    store_w<SR>(w, i0, p, seed, tb.base + i0);
    store8(param, i0, p);
    return;
  }
  if (dsc[SC_GATE] == 0.f) return;
  const uint32_t seed = SR ? *seedp : 0u;
  for (long i = i0; i < n; ++i) {  // the ragged tail
    int has_wd = k.has_wd;
    const Step st = tensor_scalars(step_scalars(dsc), tb, i, k, has_wd);
    float mm = to_f32(m[i]), vv = to_f32(v[i]);
    const float p = adam_elem(to_f32(grad[i]), mm, vv, to_f32(w[i]), st, k,
                              has_wd);
    put(m, i, mm);
    put(v, i, vv);
    put_w<SR>(w, i, p, seed, tb.base + i);
    put(param, i, p);
  }
}

struct Args {
  void *w, *m, *v, *param;
  const void* grad;
  long n;
  const float* dsc;
  const uint32_t* seed;
  Consts k;
  Tables tb;
  cudaStream_t s;
};

template <typename TW, typename TM, typename TP, typename TG, bool SR>
cudaError_t launch(const Args& a) {
  const long per_block = (long)THREADS * PER;
  const long blocks = (a.n + per_block - 1) / per_block;
  multi_tensor_adam_kernel<TW, TM, TP, TG, SR><<<(unsigned)blocks, THREADS, 0, a.s>>>(
      static_cast<TW*>(a.w), static_cast<TM*>(a.m), static_cast<TM*>(a.v),
      static_cast<TP*>(a.param), static_cast<const TG*>(a.grad), a.n, a.dsc,
      a.seed, a.k, a.tb);
  return cudaGetLastError();
}

// the fp32-master forms: any moments, parameter and gradient dtype
template <typename TM, typename TP>
cudaError_t launch_grad(int grad_dtype, const Args& a) {
  if (grad_dtype == 0) return launch<float, TM, TP, float, false>(a);
  if (grad_dtype == 1) return launch<float, TM, TP, __nv_bfloat16, false>(a);
  return launch<float, TM, TP, __half, false>(a);
}

template <typename TM>
cudaError_t launch_master(int param_dtype, int grad_dtype, const Args& a) {
  if (param_dtype == -1) return launch_grad<TM, NoParam>(grad_dtype, a);
  if (param_dtype == 0) return launch_grad<TM, float>(grad_dtype, a);
  if (param_dtype == 1) return launch_grad<TM, __nv_bfloat16>(grad_dtype, a);
  return launch_grad<TM, __half>(grad_dtype, a);
}

// the master-free form: bf16 storage and gradient, no parameter buffer
template <typename TM>
cudaError_t launch_free(int use_sr, const Args& a) {
  if (use_sr) return launch<__nv_bfloat16, TM, NoParam, __nv_bfloat16, true>(a);
  return launch<__nv_bfloat16, TM, NoParam, __nv_bfloat16, false>(a);
}

template <typename TM>
cudaError_t launch_moments(int w_dtype, int param_dtype, int grad_dtype,
                           int use_sr, const Args& a) {
  if (w_dtype == 1) return launch_free<TM>(use_sr, a);
  return launch_master<TM>(param_dtype, grad_dtype, a);
}

}  // namespace

// w (n,): the storage, fp32 (w_dtype 0: the master) or bf16 (1: the
// master-free flat parameters); m, v (n,) fp32 (moment_dtype 0), bf16 (1)
// or fp16 (2); grad (n,) fp32 (grad_dtype 0), bf16 (1) or fp16 (2); param
// (n,) fp32 (param_dtype 0), bf16 (1) or fp16 (2), or none (-1: the
// parameters are views of the storage). A bf16 storage takes a bf16
// gradient and no parameter, and with use_sr rounds stochastically by the
// seed at `seed` (the low 32 bits of an integer on the device). scalars
// points to 6 fp32 on the device: lr, decay = 1 - lr * wd (used if has_wd),
// c1, c2, the gate (0: write nothing) and the global-norm scale (used if
// grad_scale). clip_value clips g to [lo, hi] first. omb1 = 1 - b1, omb2 =
// 1 - b2, rounded to fp32 by the caller. seg_end (n_seg int64, the flat end
// of each tensor's slice), scale and decays (n_seg fp32) are the per-tensor
// tables, or seg_end null; base is the flat index of this launch's element
// 0 (the rounding bits' index too) and wd the decay coefficient the tables'
// decay uses. Every pointer 16-byte aligned. Returns a cudaError_t (0 on
// success).
extern "C" int multi_tensor_adam(void* w, void* m, void* v, void* param,
                                 const void* grad, long long n, int w_dtype,
                                 int moment_dtype, int param_dtype,
                                 int grad_dtype, const void* scalars,
                                 const void* seed, int use_sr, float eps,
                                 float b1, float b2, float omb1, float omb2,
                                 int has_wd, int grad_scale, int clip_value,
                                 float lo, float hi, const void* seg_end,
                                 const void* scale, const void* decays,
                                 int n_seg, long long base, float wd,
                                 void* stream) {
  if (n <= 0 || w_dtype < 0 || w_dtype > 1 || moment_dtype < 0 ||
      moment_dtype > 2 || param_dtype < -1 || param_dtype > 2 ||
      grad_dtype < 0 || grad_dtype > 2 || (seg_end != nullptr && n_seg <= 0) ||
      (w_dtype == 1 && (param_dtype != -1 || grad_dtype != 1)) ||
      (use_sr && (w_dtype != 1 || seed == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args a{w, m, v, param, grad, (long)n,
               static_cast<const float*>(scalars),
               static_cast<const uint32_t*>(seed),
               Consts{eps, b1, b2, omb1, omb2, lo, hi, wd, has_wd, clip_value,
                      grad_scale},
               Tables{static_cast<const long long*>(seg_end),
                      static_cast<const float*>(scale),
                      static_cast<const float*>(decays), n_seg, base},
               static_cast<cudaStream_t>(stream)};
  if (moment_dtype == 0)
    return (int)launch_moments<float>(w_dtype, param_dtype, grad_dtype, use_sr, a);
  if (moment_dtype == 1)
    return (int)launch_moments<__nv_bfloat16>(w_dtype, param_dtype, grad_dtype, use_sr, a);
  return (int)launch_moments<__half>(w_dtype, param_dtype, grad_dtype, use_sr, a);
}
