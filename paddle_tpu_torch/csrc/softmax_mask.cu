// softmax(x + mask) over the last axis, and its upper-triangle variant,
// forward and backward, for Hopper (sm_90a): paddle.incubate's
// softmax_mask_fuse and softmax_mask_fuse_upper_triangle. The port's own
// kernel: the JAX package computes both with XLA-fused jnp
// (paddle_tpu/incubate/nn_functional.py :283, :411-430), no pallas_call.
// CUDA rather than Triton, so that every kernel of the port builds one way.
//
// What it computes, per row of Lk values, in fp32 (x and mask in any float
// dtype, the output in x's):
//   l_j = x_j + m_j                     (softmax_mask_fuse)
//   l_j = j > i + (Lk - Lq) ? -1e30 : x_j  (upper triangle: query row i,
//                                        bottom-right causal, as the JAX
//                                        package's jnp.tril(.., k - q))
//   y_j = rnd(exp(l_j - max l) / sum_k exp(l_k - max l), x's dtype)
// and the backward from the saved output y and dy:
//   dx_j = rnd(y_j (dy_j - sum_k dy_k y_k), x's dtype)
// The mask is read at its own strides over (batch, head, query row): a mask
// of shape (B, 1, Lq, Lk) serves every head without being expanded.
//
// Both sums are taken in one order, the one torch's own softmax takes: lane
// L of a row's warp adds its keys j = L, L + 32, ... in increasing j, then
// the 32 lanes combine by the xor butterfly 16 -> 1. With expf and a
// correctly rounded division that gives the plain version's bits.
//
// Bound: bytes (forward reads x and the mask and writes y; backward reads y
// and dy and writes dx). Design (ops/softmax_mask.py's launch_plan sizes
// every launch):
// - A warp owns R rows; lane L holds keys L + 32 k (k < E) of each in
//   registers, so x and the mask are read once and expf runs once an
//   element. E (4, 8, 16 or 32: Lk up to 1024) and R are template
//   arguments; all of a warp's loads are issued before its arithmetic.
//   Rows over 1024 keys take a looping kernel that recomputes the logits in
//   its three passes.
// - Where the mask is broadcast over heads, a warp's R rows are one (b, q)
//   over R heads (head_major), so that their mask row is read once.
// - The dtype sets of the callers (bf16 x and mask, fp32 x and mask, the
//   upper triangle in bf16 and fp32) are instantiations with their codes
//   fixed; any other set reads its codes at run time.
// - Indices are 32-bit (the wrapper raises at 2^31 elements); a warp finds
//   its first row's (b, h, q) by multiply-high divisions (magic numbers
//   from the wrapper) and steps to the others.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "fused_io.cuh"

namespace {

constexpr int MAX_THREADS = 256;

struct Args {
  const void *x, *m, *y, *dy;
  void *out, *dx;
  unsigned rows, items;         // items: a warp's R rows each
  int lk, lq, heads, causal, x_dt, m_dt, head_major;
  unsigned m_sb, m_sh, m_sq;    // mask strides (elements) of b, h, q
  // v / lq and v / heads as (v * magic) >> (31 + shift), v < 2^31
  unsigned lq_magic, h_magic;
  int lq_shift, h_shift;
};

__device__ __forceinline__ unsigned divide(unsigned v, unsigned magic,
                                           int shift) {
  return (unsigned)(((unsigned long long)v * magic) >> (31 + shift));
}

// X, M: x's and the mask's dtype codes, C: causal (0, 1); -1 read at run
// time
template <int X, int M, int C>
struct SmDt {
  static constexpr int x = X, m = M, causal = C;
};
using SmBf16 = SmDt<BF16, BF16, 0>;
using SmF32 = SmDt<F32, F32, 0>;
using SmCausalBf16 = SmDt<BF16, F32, 1>;
using SmCausalF32 = SmDt<F32, F32, 1>;
using SmAny = SmDt<-1, -1, -1>;

__host__ __device__ __forceinline__ int pick(int fixed, int arg) {
  return fixed >= 0 ? fixed : arg;
}

template <class Dt>
__device__ __forceinline__ Args fixed(Args a) {
  a.x_dt = pick(Dt::x, a.x_dt);
  a.m_dt = pick(Dt::m, a.m_dt);
  a.causal = pick(Dt::causal, a.causal);
  return a;
}

template <class Dt>
bool fits(const Args& a, bool bwd) {
  if (bwd) return pick(Dt::x, a.x_dt) == a.x_dt && Dt::causal <= 0;
  return pick(Dt::x, a.x_dt) == a.x_dt &&
         pick(Dt::causal, a.causal) == a.causal &&
         (a.causal || pick(Dt::m, a.m_dt) == a.m_dt);
}

__device__ __forceinline__ float ld1(const void* p, unsigned i, int dt) {
  return dt == F32 ? static_cast<const float*>(p)[i]
                   : from16(static_cast<const uint16_t*>(p)[i], dt);
}

__device__ __forceinline__ void st1(void* p, unsigned i, int dt, float v) {
  if (dt == F32)
    static_cast<float*>(p)[i] = v;
  else
    static_cast<uint16_t*>(p)[i] = (uint16_t)to16(v, dt);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

// key j's logit in a row of query index q: x + m, or the upper triangle
__device__ __forceinline__ float logit(const Args& a, float x, float m, int q,
                                       int j) {
  if (a.causal) return j > q + (a.lk - a.lq) ? -1e30f : x;
  return __fadd_rn(x, m);
}

// a row's place: its index, its (b, h, q) and its mask row's offset
struct Row {
  unsigned row, mo;
  int b, h, q;
  bool live;
};

__device__ __forceinline__ unsigned mask_row(const Args& a, const Row& r) {
  return r.b * a.m_sb + r.h * a.m_sh + r.q * a.m_sq;
}

// the R rows of warp item `item`: R consecutive rows, or (head_major) one
// (b, q) over R consecutive heads (heads % R == 0)
template <int R>
__device__ __forceinline__ void item_rows(const Args& a, unsigned item,
                                          Row (&rs)[R]) {
  Row r;
  if (a.head_major) {
    // g: b x heads / R + the head group
    const unsigned g = divide(item, a.lq_magic, a.lq_shift);
    r.q = (int)(item - g * a.lq);
    r.b = (int)divide(g * R, a.h_magic, a.h_shift);
    r.h = (int)(g * R - r.b * a.heads);
  } else {
    const unsigned row = item * R;
    const unsigned bh = divide(row, a.lq_magic, a.lq_shift);
    r.q = (int)(row - bh * a.lq);
    r.b = (int)divide(bh, a.h_magic, a.h_shift);
    r.h = (int)(bh - r.b * a.heads);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    r.row = ((unsigned)r.b * a.heads + r.h) * a.lq + r.q;
    r.live = r.row < a.rows;
    r.mo = mask_row(a, r);
    rs[i] = r;
    if (a.head_major) {
      ++r.h;
    } else if (++r.q == a.lq) {
      r.q = 0;
      if (++r.h == a.heads) {
        r.h = 0;
        ++r.b;
      }
    }
  }
}

// E keys a lane, R rows a warp, the row in registers
template <int E, int R, class Dt>
__global__ void __launch_bounds__(MAX_THREADS)
    softmax_mask_fwd_kernel(Args args) {
  const Args a = fixed<Dt>(args);
  const unsigned item = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (item >= a.items) return;
  Row rs[R];
  item_rows<R>(a, item, rs);
  // one mask row for the warp's R rows: heads share it
  const bool share = a.head_major && a.m_sh == 0;
  float l[R][E], m[R][E];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int j = lane + 32 * k;
      const bool in = rs[i].live && j < a.lk;
      l[i][k] = in ? ld1(a.x, rs[i].row * a.lk + j, a.x_dt) : 0.f;
      m[i][k] = in && !a.causal && (!share || i == 0)
                    ? ld1(a.m, rs[i].mo + j, a.m_dt) : 0.f;
    }
  }
  float mx[R], s[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    mx[i] = -INFINITY;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int j = lane + 32 * k;
      if (j < a.lk) {
        l[i][k] = logit(a, l[i][k], m[share ? 0 : i][k], rs[i].q, j);
        mx[i] = fmaxf(mx[i], l[i][k]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) mx[i] = warp_max(mx[i]);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    s[i] = 0.f;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      if (lane + 32 * k < a.lk) {
        l[i][k] = expf(__fsub_rn(l[i][k], mx[i]));
        s[i] = __fadd_rn(s[i], l[i][k]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) s[i] = warp_sum(s[i]);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (!rs[i].live) continue;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int j = lane + 32 * k;
      if (j < a.lk)
        st1(a.out, rs[i].row * a.lk + j, a.x_dt, __fdiv_rn(l[i][k], s[i]));
    }
  }
}

template <int E, int R, class Dt>
__global__ void __launch_bounds__(MAX_THREADS)
    softmax_mask_bwd_kernel(Args args) {
  const Args a = fixed<Dt>(args);
  const unsigned item = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (item >= a.items) return;
  float y[R][E], g[R][E], s[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const unsigned row = item * R + i;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int j = lane + 32 * k;
      const bool in = row < a.rows && j < a.lk;
      y[i][k] = in ? ld1(a.y, row * a.lk + j, a.x_dt) : 0.f;
      g[i][k] = in ? ld1(a.dy, row * a.lk + j, a.x_dt) : 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    s[i] = 0.f;
#pragma unroll
    for (int k = 0; k < E; ++k)
      if (lane + 32 * k < a.lk)
        s[i] = __fadd_rn(s[i], __fmul_rn(y[i][k], g[i][k]));
  }
#pragma unroll
  for (int i = 0; i < R; ++i) s[i] = warp_sum(s[i]);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const unsigned row = item * R + i;
    if (row >= a.rows) continue;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int j = lane + 32 * k;
      if (j < a.lk)
        st1(a.dx, row * a.lk + j, a.x_dt,
            __fmul_rn(y[i][k], __fsub_rn(g[i][k], s[i])));
    }
  }
}

// rows over 32 E_MAX keys: a warp a row, three passes over it (max, sum,
// write), the later two from L1; codes read at run time
__global__ void __launch_bounds__(MAX_THREADS)
    softmax_mask_fwd_loop_kernel(Args a) {
  const unsigned item = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (item >= a.items) return;
  Row rs[1];
  item_rows<1>(a, item, rs);
  const Row& r = rs[0];
  const unsigned xo = r.row * a.lk;
  auto lg = [&](int j) {
    return logit(a, ld1(a.x, xo + j, a.x_dt),
                 a.causal ? 0.f : ld1(a.m, r.mo + j, a.m_dt), r.q, j);
  };
  float mx = -INFINITY;
  for (int j = lane; j < a.lk; j += 32) mx = fmaxf(mx, lg(j));
  mx = warp_max(mx);
  float s = 0.f;
  for (int j = lane; j < a.lk; j += 32)
    s = __fadd_rn(s, expf(__fsub_rn(lg(j), mx)));
  s = warp_sum(s);
  for (int j = lane; j < a.lk; j += 32)
    st1(a.out, xo + j, a.x_dt, __fdiv_rn(expf(__fsub_rn(lg(j), mx)), s));
}

__global__ void __launch_bounds__(MAX_THREADS)
    softmax_mask_bwd_loop_kernel(Args a) {
  const unsigned row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= a.rows) return;
  const unsigned o = row * a.lk;
  float s = 0.f;
  for (int j = lane; j < a.lk; j += 32)
    s = __fadd_rn(s, __fmul_rn(ld1(a.y, o + j, a.x_dt),
                               ld1(a.dy, o + j, a.x_dt)));
  s = warp_sum(s);
  for (int j = lane; j < a.lk; j += 32) {
    const float y = ld1(a.y, o + j, a.x_dt);
    st1(a.dx, o + j, a.x_dt,
        __fmul_rn(y, __fsub_rn(ld1(a.dy, o + j, a.x_dt), s)));
  }
}

template <bool BWD, int E, int R, class Dt>
cudaError_t launch(const Args& a, unsigned grid, int threads,
                   cudaStream_t st) {
  if constexpr (BWD)
    softmax_mask_bwd_kernel<E, R, Dt><<<grid, threads, 0, st>>>(a);
  else
    softmax_mask_fwd_kernel<E, R, Dt><<<grid, threads, 0, st>>>(a);
  return cudaGetLastError();
}

// the (E, R) pairs built: ops/softmax_mask.py's ELEMS and RPW_CHOICES
template <bool BWD, class Dt>
cudaError_t by_shape(const Args& a, int elems, int rpw, unsigned grid,
                     int threads, cudaStream_t st) {
  switch (elems * 8 + rpw) {
    case 4 * 8 + 1: return launch<BWD, 4, 1, Dt>(a, grid, threads, st);
    case 4 * 8 + 2: return launch<BWD, 4, 2, Dt>(a, grid, threads, st);
    case 4 * 8 + 4: return launch<BWD, 4, 4, Dt>(a, grid, threads, st);
    case 8 * 8 + 1: return launch<BWD, 8, 1, Dt>(a, grid, threads, st);
    case 8 * 8 + 2: return launch<BWD, 8, 2, Dt>(a, grid, threads, st);
    case 16 * 8 + 1: return launch<BWD, 16, 1, Dt>(a, grid, threads, st);
    case 32 * 8 + 1: return launch<BWD, 32, 1, Dt>(a, grid, threads, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t run(bool bwd, const Args& a, int elems, int rpw, int grid,
                int threads, cudaStream_t st) {
  if (a.items == 0 || a.lk == 0) return cudaSuccess;
  if (threads > MAX_THREADS || threads % 32 || grid <= 0)
    return cudaErrorInvalidValue;
  const unsigned g = (unsigned)grid;
  if (elems == 0) {   // the looping kernels, a row a warp
    if (rpw != 1 || a.head_major) return cudaErrorInvalidValue;
    if (bwd)
      softmax_mask_bwd_loop_kernel<<<g, threads, 0, st>>>(a);
    else
      softmax_mask_fwd_loop_kernel<<<g, threads, 0, st>>>(a);
    return cudaGetLastError();
  }
  if (a.lk > 32 * elems || (a.head_major && (bwd || a.heads % rpw)))
    return cudaErrorInvalidValue;
  if (bwd) {
    if (fits<SmBf16>(a, true))
      return by_shape<true, SmBf16>(a, elems, rpw, g, threads, st);
    if (fits<SmF32>(a, true))
      return by_shape<true, SmF32>(a, elems, rpw, g, threads, st);
    return by_shape<true, SmAny>(a, elems, rpw, g, threads, st);
  }
  if (fits<SmBf16>(a, false))
    return by_shape<false, SmBf16>(a, elems, rpw, g, threads, st);
  if (fits<SmF32>(a, false))
    return by_shape<false, SmF32>(a, elems, rpw, g, threads, st);
  if (fits<SmCausalBf16>(a, false))
    return by_shape<false, SmCausalBf16>(a, elems, rpw, g, threads, st);
  if (fits<SmCausalF32>(a, false))
    return by_shape<false, SmCausalF32>(a, elems, rpw, g, threads, st);
  return by_shape<false, SmAny>(a, elems, rpw, g, threads, st);
}

}  // namespace

// x, out: (rows, lk) contiguous, rows = B heads lq; the mask (causal = 0)
// at element strides m_sb, m_sh, m_sq over (b, h, q) and 1 over keys;
// lq_magic, lq_shift, h_magic, h_shift: the dividers of lq and heads
// (ops/_fused_io.py divider); items, elems, rpw, head_major, grid,
// threads: ops/softmax_mask.py's launch plan
extern "C" int softmax_mask_fwd(const void* x, const void* m, void* out,
                                int rows, int lk, int lq, int heads,
                                int m_sb, int m_sh, int m_sq, int causal,
                                int x_dt, int m_dt, int lq_magic,
                                int lq_shift, int h_magic, int h_shift,
                                int items, int elems, int rpw,
                                int head_major, int grid, int threads,
                                void* stream) {
  Args a{x, m, nullptr, nullptr, out, nullptr, (unsigned)rows,
         (unsigned)items, lk, lq, heads, causal, x_dt, m_dt, head_major,
         (unsigned)m_sb, (unsigned)m_sh, (unsigned)m_sq, (unsigned)lq_magic,
         (unsigned)h_magic, lq_shift, h_shift};
  return run(false, a, elems, rpw, grid, threads,
             static_cast<cudaStream_t>(stream));
}

extern "C" int softmax_mask_bwd(const void* y, const void* dy, void* dx,
                                int rows, int lk, int x_dt, int items,
                                int elems, int rpw, int grid, int threads,
                                void* stream) {
  Args a{nullptr, nullptr, y, dy, nullptr, dx, (unsigned)rows,
         (unsigned)items, lk, 1, 1, 0, x_dt, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  return run(true, a, elems, rpw, grid, threads,
             static_cast<cudaStream_t>(stream));
}
