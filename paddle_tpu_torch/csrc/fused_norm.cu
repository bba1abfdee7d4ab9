// RMSNorm and LayerNorm over the last axis, with the pre-norm residual (and
// bias) add, forward and backward, for Hopper (sm_90a). The port's own
// kernel: the JAX package computes these with XLA-fused jnp
// (paddle_tpu/ops/nn_ops.py rms_norm and layer_norm, and
// paddle_tpu/incubate/nn_functional.py fused_rms_norm and fused_layer_norm,
// :23-91), no pallas_call; upstream Paddle backs the fused ones with CUDA
// kernels (paddle/phi/kernels/fusion/).
//
// What it computes, per row of `cols` elements (every value held in fp32,
// rnd(v, t) rounding v to the dtype t and back):
//   h  = x, or with an add: rnd(rnd(x, A) + rnd(pre_bias, A), A), then
//        rnd(h + rnd(residual, A), A); h is written to res_out (dtype A)
//   hn = rnd(h, T)                           the norm's input (fp32 math)
//   RMS: r = rsqrt(mean(hn^2) + eps), n = hn r
//   LN:  mu = mean(hn), r = rsqrt(mean((hn - mu)^2) + eps), n = (hn - mu) r
//   plain order (the port's rms_norm / layer_norm, the weight after the
//   cast): y = rnd(rnd(rnd(n, T) w, P) + b, P)
//   fused order (incubate's fused_*_norm, the weight before the cast):
//   y = rnd(n w + b, P)
// with w and b rounded to their cast dtypes first. mean (LN) and r are kept
// per row for the backward, which gives
//   gn = the gradient of n (plain: rnd(rnd(g w, P), T); fused: g w)
//   dh = r (gn - mean(gn) [LN] - n mean(gn n)), rounded to T, then with an
//        add to A, plus the gradient of res_out, rounded to A
// and the weight, bias and pre-bias gradients as per-CTA partial sums (fp32,
// rows in the CTA's fixed order) that partial_fold_kernel folds in a fixed
// order: no atomics, so every launch on the same inputs gives the same bits.
//
// Bound: bytes (about 10 flops a byte). Forward one read of x (and
// residual), one write of y (and res_out); backward one read of dy, h (and
// d res_out), one write of dx. Design (ops/fused_norm.py's launch_plan
// sizes every launch from rows, cols and the card's SM count):
// - Row groups (norm_*_ring_kernel, rows of 16-byte-aligned 8-column
//   chunks): a persistent grid of CTAs of 256 threads at most, each taking
//   a contiguous chunk of rows; inside a CTA, row groups of 1-8 warps take
//   every groups-th row. A thread owns the same NC (1-2) 8-column chunks of
//   every row, so the weight, bias and pre-bias (rounded to their casts)
//   are read into shared memory once per CTA, and the row's values stay in
//   registers between its passes. The rows ahead are copied into a
//   shared-memory ring (`stages` rows deep) while a group reduces: in the
//   forward, one cp.async.bulk copy of each row's x (and residual) by the
//   group's first thread, counted on the stage's mbarrier (on an H100, 4-7%
//   faster than per-thread copies at Llama's and ERNIE's shapes:
//   tools/ab_norm_variants.py); in the backward, each thread's own 16-byte
//   chunks of dy, h and d res_out by cp.async, so a thread waits only for
//   its own copies (cp.async.wait_group). Statistics: each warp's xor
//   tree, then one exchange between the group's warps through shared
//   memory under the group's named barrier; no block-wide barrier per
//   row.
// - The work a byte is small but not nothing (conversions and roundings of
//   up to three dtypes), and a persistent grid holds fewer warps an SM than
//   a block per row would, so the instructions an element count: the
//   common dtype sets (AMP O2, all bf16) have instantiations with their
//   codes fixed (FwdDt, BwdDt: straight-line loads, stores and roundings;
//   on an H100 23-137% faster than the same kernels reading the codes at
//   run time, as any other set does: tools/ab_norm_variants.py; the block
//   a row only for all bf16, decode's), an absent weight, bias or
//   pre-bias is staged as 1, -0 and -0 (no branch an element), and the
//   forward is built for 4 CTAs an SM (64 registers), the backward for 2
//   (128: gn and n in registers).
// - The backward keeps gn and n in registers and adds its weight, bias and
//   pre-bias contributions into per-group fp32 columns in shared memory; at
//   the end the CTA adds its groups in order into one partial row, so the
//   partials number the CTAs (1-3 an SM), not one a row block.
// - partial_fold_kernel folds the partials of all three gradients in one
//   launch, parallel over columns (32 a block, coalesced) and over the
//   partials (8 lanes, each a strided run in order, then the lanes in
//   order).
// - A row's layout (its warps, its chunks a thread) is a function of cols
//   alone in every kernel, so a row's bits never depend on the call's row
//   count. Decode-sized forwards (fewer rows than SMs: nothing for a
//   persistent grid to overlap) take norm_fwd_row_kernel, a row a block in
//   registers; rows too wide for the ring (fp32 rows near MAX_COLS, more
//   than 8 warps of 2 chunks) and rows of unaligned or odd widths
//   (8-element vectors impossible) take the looping block-per-row kernels
//   (norm_fwd_kernel, norm_bwd_kernel), hn and the backward's gn, n and
//   partials in shared memory.

#include <cuda_runtime.h>

#include <cstdint>

#include "fused_io.cuh"

namespace {

constexpr int FOLD_LANES = 8;   // partials folded in parallel per column
constexpr int RED_FLOATS = 64;  // a group's exchange: 2 slots x 2 x 16

// Sum over the block, the same value in every thread: lane 0 of each warp
// folds its warp's xor tree, warp 0 folds the warps in order and lane 0's
// result is broadcast. blockDim.x is a multiple of 32.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  __syncthreads();  // red may still be read by the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < nw; ++i) t += red[i];
  return t;
}

__device__ __forceinline__ int esize(int dt) { return dt == F32 ? 4 : 2; }

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n (0-3) of this thread's newest copy groups are pending
__device__ __forceinline__ void cp_wait(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else if (n == 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 3;\n" ::: "memory");
}

// the 8 elements at column c of a row (element size sz) into the stage
__device__ __forceinline__ void copy_chunk(unsigned char* dst,
                                           const unsigned char* row, int c,
                                           int sz) {
  cp16(dst + (size_t)c * sz, row + (size_t)c * sz);
  if (sz == 4) cp16(dst + (size_t)c * sz + 16, row + (size_t)c * sz + 16);
}

__device__ __forceinline__ void group_bar(int grp, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(grp + 1), "r"(threads) : "memory");
}

// Sums over a row group of gw warps, the same bits in every thread: each
// warp's xor tree, then (gw > 1) the warps' sums in order through one of
// two alternating slots of `red` (a slot is rewritten only after every warp
// has passed the barrier of the exchange in between).
__device__ __forceinline__ void group_sum2(float& u, float& v, bool two,
                                           float* red, int& slot, int gw,
                                           int grp, int wig, int lane) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    u += __shfl_xor_sync(0xffffffffu, u, o);
    if (two) v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  if (gw == 1) {  // as block_sum's one warp: 0 + the warp's sum
    u = __fadd_rn(0.f, u);
    v = __fadd_rn(0.f, v);
    return;
  }
  float* r = red + slot * 32;
  slot ^= 1;
  if (lane == 0) {
    r[wig] = u;
    r[16 + wig] = v;
  }
  group_bar(grp, gw * 32);
  float a = 0.f, b = 0.f;
  for (int i = 0; i < gw; ++i) {
    a += r[i];
    if (two) b += r[16 + i];
  }
  u = a;
  v = b;
}

__device__ __forceinline__ float group_sum(float u, float* red, int& slot,
                                           int gw, int grp, int wig,
                                           int lane) {
  float v = 0.f;
  group_sum2(u, v, false, red, slot, gw, grp, wig, lane);
  return u;
}

// a[c..c+8) += v, in fp32, 16-byte accesses (c is a multiple of 8)
__device__ __forceinline__ void acc8(float* a, int c, const float (&v)[8]) {
  float4* p = reinterpret_cast<float4*>(a + c);
  float4 x = p[0], y = p[1];
  x.x = __fadd_rn(x.x, v[0]);
  x.y = __fadd_rn(x.y, v[1]);
  x.z = __fadd_rn(x.z, v[2]);
  x.w = __fadd_rn(x.w, v[3]);
  y.x = __fadd_rn(y.x, v[4]);
  y.y = __fadd_rn(y.y, v[5]);
  y.z = __fadd_rn(y.z, v[6]);
  y.w = __fadd_rn(y.w, v[7]);
  p[0] = x;
  p[1] = y;
}

struct FwdArgs {
  const void *x, *res, *pb, *w, *b;
  void *out, *res_out;
  float *mean, *rstd;
  long long rows;
  int cols;
  int x_dt, res_dt, pb_dt, w_dt, w_cast, b_dt, b_cast, out_dt, add_dt,
      norm_dt, ln, fused;
  float eps;
};

struct BwdArgs {
  const void *dy, *dres, *h, *w;
  const float *mean, *rstd;
  void* dx;
  float *pw, *pb, *ppb;  // [gridDim.x][cols] partial sums, or null
  long long rows;
  int cols;
  int dy_dt, dres_dt, h_dt, w_dt, w_cast, dx_dt, out_dt, add_dt, norm_dt,
      has_add, ln, fused;
};

// The row-group kernels' launch plan (ops/fused_norm.py launch_plan):
// gridDim.x CTAs of `groups` row groups of `gwarps` warps; CTA i takes rows
// [i rows_per_cta, (i + 1) rows_per_cta), group g of them g, g + groups,
// ...; each group's ring holds `stages` rows of stage_bytes.
struct Ring {
  long long rows_per_cta;
  int gwarps, groups, stages, stage_bytes;
};

// a row-group CTA's threads at most, and the CTAs an SM must hold (so the
// registers a thread may take: 64 forward, 128 backward; launch_plan's
// REGS_FWD, REGS_BWD)
constexpr int RING_THREADS = 256, RING_FWD_CTAS = 4, RING_BWD_CTAS = 2;

// Dtype codes a row-group kernel is built for (-1: the argument's), so that
// the common cases' loads, stores and roundings compile to straight code;
// the kernels overwrite their arguments' codes with them (fixed()).
template <int X, int R, int W, int WC, int O, int A, int N>
struct FwdDt {
  static constexpr int x = X, res = R, w = W, wc = WC, out = O, add = A,
                       norm = N;
};
template <int G, int DR, int H, int W, int WC, int DX, int O, int A, int N>
struct BwdDt {
  static constexpr int dy = G, dres = DR, h = H, w = W, wc = WC, dx = DX,
                       out = O, add = A, norm = N;
};
// AMP O2: bf16 x (and residual), fp32 norm and output (Llama, ERNIE)
using FwdO2 = FwdDt<BF16, BF16, BF16, F32, F32, BF16, F32>;
using FwdO2F32Res = FwdDt<BF16, F32, BF16, F32, F32, BF16, F32>;
// bf16 throughout (serving)
using FwdBf16 = FwdDt<BF16, BF16, BF16, BF16, BF16, BF16, BF16>;
using FwdAny = FwdDt<-1, -1, -1, -1, -1, -1, -1>;
using BwdO2 = BwdDt<F32, BF16, BF16, BF16, F32, BF16, F32, BF16, F32>;
using BwdAny = BwdDt<-1, -1, -1, -1, -1, -1, -1, -1, -1>;

__host__ __device__ __forceinline__ int pick(int fixed, int arg) {
  return fixed >= 0 ? fixed : arg;
}

template <class D>
__device__ __forceinline__ FwdArgs fixed(FwdArgs a) {
  a.x_dt = pick(D::x, a.x_dt);
  a.res_dt = pick(D::res, a.res_dt);
  a.w_dt = pick(D::w, a.w_dt);
  a.w_cast = pick(D::wc, a.w_cast);
  a.out_dt = pick(D::out, a.out_dt);
  a.add_dt = pick(D::add, a.add_dt);
  a.norm_dt = pick(D::norm, a.norm_dt);
  return a;
}

template <class D>
__device__ __forceinline__ BwdArgs fixed(BwdArgs a) {
  a.dy_dt = pick(D::dy, a.dy_dt);
  a.dres_dt = pick(D::dres, a.dres_dt);
  a.h_dt = pick(D::h, a.h_dt);
  a.w_dt = pick(D::w, a.w_dt);
  a.w_cast = pick(D::wc, a.w_cast);
  a.dx_dt = pick(D::dx, a.dx_dt);
  a.out_dt = pick(D::out, a.out_dt);
  a.add_dt = pick(D::add, a.add_dt);
  a.norm_dt = pick(D::norm, a.norm_dt);
  return a;
}

// whether a launch's dtypes are those D was built for (an absent input's
// code does not matter)
inline bool fits(int fixed, int arg, bool present) {
  return fixed < 0 || !present || fixed == arg;
}

template <class D>
bool fits(const FwdArgs& a) {
  return fits(D::x, a.x_dt, true) && fits(D::res, a.res_dt, a.res) &&
         fits(D::w, a.w_dt, a.w) && fits(D::wc, a.w_cast, a.w) &&
         fits(D::out, a.out_dt, true) &&
         fits(D::add, a.add_dt, a.res != nullptr || a.pb != nullptr) &&
         fits(D::norm, a.norm_dt, true);
}

template <class D>
bool fits(const BwdArgs& a) {
  return fits(D::dy, a.dy_dt, true) && fits(D::dres, a.dres_dt, a.dres) &&
         fits(D::h, a.h_dt, true) && fits(D::w, a.w_dt, a.w) &&
         fits(D::wc, a.w_cast, a.w) && fits(D::dx, a.dx_dt, true) &&
         fits(D::out, a.out_dt, true) && fits(D::add, a.add_dt, a.has_add) &&
         fits(D::norm, a.norm_dt, true);
}

// 8 fp32 values at c of shared memory (c a multiple of 8)
__device__ __forceinline__ void lds8(const float* p, int c, float (&v)[8]) {
  const float4 x = *reinterpret_cast<const float4*>(p + c);
  const float4 y = *reinterpret_cast<const float4*>(p + c + 4);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
}

// 8 columns at c of a vector, rounded to dt, into fp32 shared memory; an
// absent vector stages `none` (1 for a weight, -0 for a bias: the product
// and the sum then leave every value, -0 included, as it was)
__device__ __forceinline__ void stage8(float* dst, const void* src, int c,
                                       int src_dt, int dt, float none) {
  float v[8];
  if (src != nullptr) {
    ldv<8>(src, c, src_dt, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = rnd(v[j], dt);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = none;
  }
  stv<8>(dst, c, F32, v);
}

// The weight, bias and pre-bias of the CTA's columns, rounded to their casts
// (pre-bias: to the add's dtype), into fp32 shared memory at ws, bs, ps
// (cols each); returns the first float after them.
__device__ __forceinline__ float* stage_vectors(const FwdArgs& a, float* ws) {
  float* bs = ws + a.cols;
  float* ps = bs + a.cols;
  for (int c = threadIdx.x * 8; c < a.cols; c += blockDim.x * 8) {
    stage8(ws, a.w, c, a.w_dt, a.w_cast, 1.f);
    stage8(bs, a.b, c, a.b_dt, a.b_cast, -0.f);
    stage8(ps, a.pb, c, a.pb_dt, a.add_dt, -0.f);
  }
  return ps + a.cols;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// wait until the phase of parity `phase` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(phase)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory into shared memory, counted on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// row r of x (and the residual) into a stage: one thread's one
// cp.async.bulk copy each, counted in bytes on the stage's mbarrier
__device__ __forceinline__ void fwd_copy_row(const FwdArgs& a,
                                             unsigned char* st, long long r,
                                             uint32_t bar) {
  const uint32_t xb = (uint32_t)a.cols * esize(a.x_dt);
  const uint32_t rb =
      a.res != nullptr ? (uint32_t)a.cols * esize(a.res_dt) : 0;
  mbar_expect_tx(bar, xb + rb);
  bulk_copy(smem_u32(st), static_cast<const unsigned char*>(a.x) + r * xb, xb,
            bar);
  if (rb)
    bulk_copy(smem_u32(st + xb),
              static_cast<const unsigned char*>(a.res) + r * rb, rb, bar);
}

// The row-group forward. Thread 0 of each group fetches the group's rows
// `stages - 1` ahead (fwd_copy_row) into its ring; the group waits on the
// stage's mbarrier (parity: the ring's laps), and a stage is refilled only
// after every thread of the group has read it (its exchange barrier; one
// warp: __syncwarp). The mbarriers follow the exchange slots.
template <int NC, class D>
__global__ void __launch_bounds__(RING_THREADS, RING_FWD_CTAS)
    norm_fwd_ring_kernel(FwdArgs args, Ring p) {
  const FwdArgs a = fixed<D>(args);
  extern __shared__ float4 ring_sh[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(ring_sh);
  const int gthreads = p.gwarps * 32;
  const int grp = threadIdx.x / gthreads, t = threadIdx.x - grp * gthreads;
  const int lane = threadIdx.x & 31, wig = t >> 5;
  unsigned char* ring = sm + (size_t)grp * p.stages * p.stage_bytes;
  const long long first = (long long)blockIdx.x * p.rows_per_cta;
  const long long end =
      first + p.rows_per_cta < a.rows ? first + p.rows_per_cta : a.rows;
  const long long r0 = first + grp;
  const bool has_add = a.res != nullptr || a.pb != nullptr;
  const bool has_w = a.w != nullptr;
  const int xs = esize(a.x_dt);
  float* ws = reinterpret_cast<float*>(sm + (size_t)p.groups * p.stages *
                                                p.stage_bytes);
  const float* bs = ws + a.cols;
  const float* ps = bs + a.cols;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ws + 3 * (size_t)a.cols +
                                               p.groups * RED_FLOATS);
  const uint32_t bar0 = smem_u32(bars + grp * p.stages);
  if (threadIdx.x == 0) {
    for (int i = 0; i < p.groups * p.stages; ++i)
      mbar_init(smem_u32(bars + i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0) {
    for (int s = 0; s < p.stages - 1; ++s) {
      const long long r = r0 + (long long)s * p.groups;
      if (r < end)
        fwd_copy_row(a, ring + (size_t)s * p.stage_bytes, r, bar0 + 8 * s);
    }
  }
  // the vectors while the first rows are on their way
  float* red = stage_vectors(a, ws) + grp * RED_FLOATS;
  __syncthreads();
  int cur = 0, slot = 0;
  uint32_t phase = 0;
  for (long long r = r0; r < end; r += p.groups) {
    const long long ahead = r + (long long)(p.stages - 1) * p.groups;
    const int nxt = cur == 0 ? p.stages - 1 : cur - 1;
    // stage nxt held the previous row, which every thread of the group has
    // read before the group's exchange (one warp: before this)
    if (p.gwarps == 1) __syncwarp();
    if (t == 0 && ahead < end)
      fwd_copy_row(a, ring + (size_t)nxt * p.stage_bytes, ahead,
                   bar0 + 8 * nxt);
    mbar_wait(bar0 + 8 * cur, phase);
    const unsigned char* st = ring + (size_t)cur * p.stage_bytes;
    const unsigned char* rst = st + (size_t)a.cols * xs;
    float hv[NC][8];
    float s1 = 0.f, sq = 0.f;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = (t + k * gthreads) * 8;
      if (c < a.cols) {
        float h[8];
        ldv<8>(st, c, a.x_dt, h);
        if (has_add) {
          float pv[8];
          lds8(ps, c, pv);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            h[j] = rnd(__fadd_rn(rnd(h[j], a.add_dt), pv[j]), a.add_dt);
          if (a.res != nullptr) {
            float u[8];
            ldv<8>(rst, c, a.res_dt, u);
#pragma unroll
            for (int j = 0; j < 8; ++j)
              h[j] = rnd(__fadd_rn(h[j], rnd(u[j], a.add_dt)), a.add_dt);
          }
          stv<8>(a.res_out, r * a.cols + c, a.add_dt, h);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float v = rnd(h[j], a.norm_dt);
          hv[k][j] = v;
          s1 += v;
          sq = __fmaf_rn(v, v, sq);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) hv[k][j] = 0.f;
      }
    }
    float mu = 0.f, var;
    if (a.ln) {
      mu = __fdiv_rn(group_sum(s1, red, slot, p.gwarps, grp, wig, lane),
                     (float)a.cols);
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        if ((t + k * gthreads) * 8 < a.cols) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float d = __fsub_rn(hv[k][j], mu);
            s = __fmaf_rn(d, d, s);
          }
        }
      }
      var = __fdiv_rn(group_sum(s, red, slot, p.gwarps, grp, wig, lane),
                      (float)a.cols);
    } else {
      var = __fdiv_rn(group_sum(sq, red, slot, p.gwarps, grp, wig, lane),
                      (float)a.cols);
    }
    const float rs = __frsqrt_rn(__fadd_rn(var, a.eps));
    if (t == 0) {
      if (a.ln) a.mean[r] = mu;
      a.rstd[r] = rs;
    }
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = (t + k * gthreads) * 8;
      if (c < a.cols) {
        float y[8], wv[8], bv[8];
        lds8(ws, c, wv);
        lds8(bs, c, bv);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float n =
              __fmul_rn(a.ln ? __fsub_rn(hv[k][j], mu) : hv[k][j], rs);
          float v;
          if (a.fused) {
            v = __fadd_rn(__fmul_rn(n, wv[j]), bv[j]);
          } else {
            v = rnd(n, a.norm_dt);
            const float vw = rnd(__fmul_rn(v, wv[j]), a.out_dt);
            v = rnd(__fadd_rn(has_w ? vw : v, bv[j]), a.out_dt);
          }
          y[j] = rnd(v, a.out_dt);
        }
        stv<8>(a.out, r * a.cols + c, a.out_dt, y);
      }
    }
    if (++cur == p.stages) {
      cur = 0;
      phase ^= 1;
    }
  }
}

// this thread's chunks of row r of dy, h (and d res_out) into a stage
template <int NC>
__device__ __forceinline__ void bwd_copy_row(const BwdArgs& a, unsigned char* st,
                                          long long r, int t, int gthreads) {
  const int gs = esize(a.dy_dt), hs = esize(a.h_dt), ds = esize(a.dres_dt);
  const unsigned char* gr =
      static_cast<const unsigned char*>(a.dy) + r * a.cols * gs;
  const unsigned char* hr =
      static_cast<const unsigned char*>(a.h) + r * a.cols * hs;
  const unsigned char* dr =
      a.dres != nullptr
          ? static_cast<const unsigned char*>(a.dres) + r * a.cols * ds
          : nullptr;
  unsigned char* hst = st + (size_t)a.cols * gs;
  unsigned char* dst = hst + (size_t)a.cols * hs;
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = (t + k * gthreads) * 8;
    if (c < a.cols) {
      copy_chunk(st, gr, c, gs);
      copy_chunk(hst, hr, c, hs);
      if (dr != nullptr) copy_chunk(dst, dr, c, ds);
    }
  }
}

template <int NC, class D>
__global__ void __launch_bounds__(RING_THREADS, RING_BWD_CTAS)
    norm_bwd_ring_kernel(BwdArgs args, Ring p) {
  const BwdArgs a = fixed<D>(args);
  extern __shared__ float4 ring_sh[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(ring_sh);
  const int gthreads = p.gwarps * 32;
  const int grp = threadIdx.x / gthreads, t = threadIdx.x - grp * gthreads;
  const int lane = threadIdx.x & 31, wig = t >> 5;
  unsigned char* ring = sm + (size_t)grp * p.stages * p.stage_bytes;
  float* vec =
      reinterpret_cast<float*>(sm + (size_t)p.groups * p.stages * p.stage_bytes);
  const long long first = (long long)blockIdx.x * p.rows_per_cta;
  const long long end =
      first + p.rows_per_cta < a.rows ? first + p.rows_per_cta : a.rows;
  const long long r0 = first + grp;
  const int gs = esize(a.dy_dt), hs = esize(a.h_dt);
  const float inv_cols = 1.f / (float)a.cols;
  for (int s = 0; s < p.stages - 1; ++s) {
    const long long r = r0 + (long long)s * p.groups;
    if (r < end) bwd_copy_row<NC>(a, ring + (size_t)s * p.stage_bytes, r, t,
                               gthreads);
    cp_commit();
  }
  // the weight and the zeroed sums while the first rows are on their way
  float* ws = nullptr;
  if (a.w != nullptr) {
    ws = vec;
    vec += a.cols;
    for (int c = threadIdx.x * 8; c < a.cols; c += blockDim.x * 8)
      stage8(ws, a.w, c, a.w_dt, a.w_cast, 1.f);
  }
  const int nacc =
      (a.pw != nullptr) + (a.pb != nullptr) + (a.ppb != nullptr);
  float* acc = vec;  // [groups][nacc][cols]
  float* red = vec + (size_t)p.groups * nacc * a.cols + grp * RED_FLOATS;
  float* mine = acc + (size_t)grp * nacc * a.cols;
  float* aw = a.pw != nullptr ? mine : nullptr;
  mine += a.pw != nullptr ? a.cols : 0;
  float* ab = a.pb != nullptr ? mine : nullptr;
  mine += a.pb != nullptr ? a.cols : 0;
  float* apb = a.ppb != nullptr ? mine : nullptr;
  for (int i = threadIdx.x; i < p.groups * nacc * a.cols; i += blockDim.x)
    acc[i] = 0.f;
  __syncthreads();
  // the row statistics one row ahead, in registers
  float mu_next = 0.f, r_next = 0.f;
  if (r0 < end) {
    mu_next = a.ln ? a.mean[r0] : 0.f;
    r_next = a.rstd[r0];
  }
  int cur = 0, slot = 0;
  for (long long r = r0; r < end; r += p.groups) {
    const float mu = mu_next, rs = r_next;
    if (r + p.groups < end) {
      mu_next = a.ln ? a.mean[r + p.groups] : 0.f;
      r_next = a.rstd[r + p.groups];
    }
    const long long ahead = r + (long long)(p.stages - 1) * p.groups;
    const int nxt = cur == 0 ? p.stages - 1 : cur - 1;
    if (ahead < end) bwd_copy_row<NC>(a, ring + (size_t)nxt * p.stage_bytes,
                                   ahead, t, gthreads);
    cp_commit();
    cp_wait(p.stages - 1);
    const unsigned char* st = ring + (size_t)cur * p.stage_bytes;
    const unsigned char* hst = st + (size_t)a.cols * gs;
    const unsigned char* dst = hst + (size_t)a.cols * hs;
    float gv[NC][8], nv[NC][8];
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = (t + k * gthreads) * 8;
      if (c < a.cols) {
        float g[8], hh[8], wt[8], wv[8];
        ldv<8>(st, c, a.dy_dt, g);
        ldv<8>(hst, c, a.h_dt, hh);
        if (ws != nullptr) lds8(ws, c, wt);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float hn = rnd(hh[j], a.norm_dt);
          const float n = __fmul_rn(a.ln ? __fsub_rn(hn, mu) : hn, rs);
          float gn;
          if (a.fused) {
            gn = ws != nullptr ? __fmul_rn(g[j], wt[j]) : g[j];
            wv[j] = __fmul_rn(g[j], n);
          } else {
            gn = ws != nullptr
                     ? rnd(rnd(__fmul_rn(g[j], wt[j]), a.out_dt), a.norm_dt)
                     : rnd(g[j], a.norm_dt);
            wv[j] = rnd(__fmul_rn(g[j], rnd(n, a.norm_dt)), a.out_dt);
          }
          gv[k][j] = gn;
          nv[k][j] = n;
          sa = __fmaf_rn(gn, n, sa);
          sb += gn;
        }
        if (aw != nullptr) acc8(aw, c, wv);
        if (ab != nullptr) acc8(ab, c, g);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) gv[k][j] = nv[k][j] = 0.f;
      }
    }
    group_sum2(sa, sb, a.ln != 0, red, slot, p.gwarps, grp, wig, lane);
    const float ma = sa * inv_cols;
    const float mb = a.ln ? sb * inv_cols : 0.f;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = (t + k * gthreads) * 8;
      if (c < a.cols) {
        float d[8], v[8];
        if (a.dres != nullptr) ldv<8>(dst, c, a.dres_dt, d);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float tt =
              __fsub_rn(__fsub_rn(gv[k][j], mb), __fmul_rn(nv[k][j], ma));
          float x = rnd(__fmul_rn(rs, tt), a.norm_dt);
          if (a.has_add) {
            x = rnd(x, a.add_dt);
            if (a.dres != nullptr) x = rnd(__fadd_rn(x, d[j]), a.add_dt);
          }
          v[j] = x;
        }
        if (apb != nullptr) acc8(apb, c, v);
        stv<8>(a.dx, r * a.cols + c, a.dx_dt, v);
      }
    }
    cur = cur + 1 == p.stages ? 0 : cur + 1;
  }
  cp_wait(0);
  __syncthreads();
  // the CTA's partial row: its groups' columns added in group order
  const long long base = (long long)blockIdx.x * a.cols;
  float* const parts[3] = {a.pw, a.pb, a.ppb};
  int q = 0;
  for (int i = 0; i < 3; ++i) {
    if (parts[i] == nullptr) continue;
    for (int c = threadIdx.x; c < a.cols; c += blockDim.x) {
      float s = acc[(size_t)q * a.cols + c];
      for (int g = 1; g < p.groups; ++g)
        s = __fadd_rn(s, acc[((size_t)g * nacc + q) * a.cols + c]);
      parts[i][base + c] = s;
    }
    ++q;
  }
}

// Block-per-row forward with 8-element vectors, for calls with fewer rows
// than SMs (decode): one row a block of a row group's threads
// (launch_plan's group_warps for cols, at most 16 warps), so that its sums
// run in the row-group kernels' order and a row's bits do not depend on the
// rows beside it in the call (a tail prefill's rows equal the full
// prompt's). Each thread loads all its NC chunks of x and the residual
// before it uses one, and all its weight and bias chunks before the output
// pass: two load latencies a call; dtype codes fixed as the row groups'.
template <int NC, class D>
__global__ void __launch_bounds__(512) norm_fwd_row_kernel(FwdArgs args) {
  const FwdArgs a = fixed<D>(args);
  extern __shared__ float red[];
  const long long row = blockIdx.x;
  const int t = threadIdx.x, T = blockDim.x;
  const bool has_add = a.res != nullptr || a.pb != nullptr;
  float hv[NC][8];
  float s1 = 0.f, sq = 0.f;
  {
    float rv[NC][8];
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = (t + k * T) * 8;
      if (c < a.cols) {
        ldv<8>(a.x, row * a.cols + c, a.x_dt, hv[k]);
        if (a.res != nullptr) ldv<8>(a.res, row * a.cols + c, a.res_dt, rv[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = (t + k * T) * 8;
      if (c >= a.cols) {
#pragma unroll
        for (int j = 0; j < 8; ++j) hv[k][j] = 0.f;
        continue;
      }
      float (&h)[8] = hv[k];
      if (has_add) {
#pragma unroll
        for (int j = 0; j < 8; ++j) h[j] = rnd(h[j], a.add_dt);
        if (a.pb != nullptr) {
          float u[8];
          ldv<8>(a.pb, c, a.pb_dt, u);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            h[j] = rnd(__fadd_rn(h[j], rnd(u[j], a.add_dt)), a.add_dt);
        }
        if (a.res != nullptr) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            h[j] = rnd(__fadd_rn(h[j], rnd(rv[k][j], a.add_dt)), a.add_dt);
        }
        stv<8>(a.res_out, row * a.cols + c, a.add_dt, h);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v = rnd(h[j], a.norm_dt);
        h[j] = v;
        s1 += v;
        sq = __fmaf_rn(v, v, sq);
      }
    }
  }
  float mu = 0.f, var;
  if (a.ln) {
    mu = __fdiv_rn(block_sum(s1, red), (float)a.cols);
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      if ((t + k * T) * 8 < a.cols) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float d = __fsub_rn(hv[k][j], mu);
          s = __fmaf_rn(d, d, s);
        }
      }
    }
    var = __fdiv_rn(block_sum(s, red), (float)a.cols);
  } else {
    var = __fdiv_rn(block_sum(sq, red), (float)a.cols);
  }
  const float rs = __frsqrt_rn(__fadd_rn(var, a.eps));
  if (t == 0) {
    if (a.ln) a.mean[row] = mu;
    a.rstd[row] = rs;
  }
  const bool has_w = a.w != nullptr;
  float wv[NC][8], bv[NC][8];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = (t + k * T) * 8;
    if (c < a.cols) {
      if (has_w) ldv<8>(a.w, c, a.w_dt, wv[k]);
      if (a.b != nullptr) ldv<8>(a.b, c, a.b_dt, bv[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = (t + k * T) * 8;
    if (c >= a.cols) continue;
    float y[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // the row-group kernels' formula: an absent weight 1, bias -0
      const float w = has_w ? rnd(wv[k][j], a.w_cast) : 1.f;
      const float b = a.b != nullptr ? rnd(bv[k][j], a.b_cast) : -0.f;
      const float n =
          __fmul_rn(a.ln ? __fsub_rn(hv[k][j], mu) : hv[k][j], rs);
      float v;
      if (a.fused) {
        v = __fadd_rn(__fmul_rn(n, w), b);
      } else {
        v = rnd(n, a.norm_dt);
        const float vw = rnd(__fmul_rn(v, w), a.out_dt);
        v = rnd(__fadd_rn(has_w ? vw : v, b), a.out_dt);
      }
      y[j] = rnd(v, a.out_dt);
    }
    stv<8>(a.out, row * a.cols + c, a.out_dt, y);
  }
}

// Block-per-row forward, looping: rows without 8-element vectors (V 1, one
// element a thread) and rows wider than 16 warps of 2 chunks (V 8, a row
// group's threads: the row groups' order), hn in shared memory between the
// statistics and the output pass.
template <int V>
__global__ void __launch_bounds__(1024) norm_fwd_kernel(FwdArgs a) {
  extern __shared__ float sh[];  // hn of this row, then the reduction slots
  float* red = sh + a.cols;
  const long long row = blockIdx.x;
  const bool has_add = a.res != nullptr || a.pb != nullptr;
  float s1 = 0.f, s2 = 0.f;
  for (int c = threadIdx.x * V; c < a.cols; c += blockDim.x * V) {
    float h[V];
    ldv<V>(a.x, row * a.cols + c, a.x_dt, h);
    if (has_add) {
#pragma unroll
      for (int j = 0; j < V; ++j) h[j] = rnd(h[j], a.add_dt);
      if (a.pb != nullptr) {
        float t[V];
        ldv<V>(a.pb, c, a.pb_dt, t);
#pragma unroll
        for (int j = 0; j < V; ++j)
          h[j] = rnd(__fadd_rn(h[j], rnd(t[j], a.add_dt)), a.add_dt);
      }
      if (a.res != nullptr) {
        float t[V];
        ldv<V>(a.res, row * a.cols + c, a.res_dt, t);
#pragma unroll
        for (int j = 0; j < V; ++j)
          h[j] = rnd(__fadd_rn(h[j], rnd(t[j], a.add_dt)), a.add_dt);
      }
      stv<V>(a.res_out, row * a.cols + c, a.add_dt, h);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float v = rnd(h[j], a.norm_dt);
      sh[c + j] = v;
      s1 += v;
      s2 = __fmaf_rn(v, v, s2);
    }
  }
  float mu = 0.f, var;
  if (a.ln) {
    mu = __fdiv_rn(block_sum(s1, red), (float)a.cols);
    float s = 0.f;
    for (int c = threadIdx.x * V; c < a.cols; c += blockDim.x * V) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = __fsub_rn(sh[c + j], mu);
        s = __fmaf_rn(d, d, s);
      }
    }
    var = __fdiv_rn(block_sum(s, red), (float)a.cols);
  } else {
    var = __fdiv_rn(block_sum(s2, red), (float)a.cols);
  }
  const float r = __frsqrt_rn(__fadd_rn(var, a.eps));
  if (threadIdx.x == 0) {
    if (a.ln) a.mean[row] = mu;
    a.rstd[row] = r;
  }
  for (int c = threadIdx.x * V; c < a.cols; c += blockDim.x * V) {
    float w[V], b[V], y[V];
    if (a.w != nullptr) ldv<V>(a.w, c, a.w_dt, w);
    if (a.b != nullptr) ldv<V>(a.b, c, a.b_dt, b);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float n = __fmul_rn(a.ln ? __fsub_rn(sh[c + j], mu) : sh[c + j], r);
      float v;
      if (a.fused) {
        v = n;
        if (a.w != nullptr) v = __fmul_rn(v, rnd(w[j], a.w_cast));
        if (a.b != nullptr) v = __fadd_rn(v, rnd(b[j], a.b_cast));
      } else {
        v = rnd(n, a.norm_dt);
        if (a.w != nullptr) v = rnd(__fmul_rn(v, rnd(w[j], a.w_cast)), a.out_dt);
        if (a.b != nullptr) v = rnd(__fadd_rn(v, rnd(b[j], a.b_cast)), a.out_dt);
      }
      y[j] = rnd(v, a.out_dt);
    }
    stv<V>(a.out, row * a.cols + c, a.out_dt, y);
  }
}

// Block-per-row backward: block i walks rows [i rpc, (i + 1) rpc) in order,
// gn and n of the row and its partial sums in shared memory; a row's sums
// in the row-group kernel's order, as the forward's.
template <int V>
__global__ void __launch_bounds__(1024)
    norm_bwd_kernel(BwdArgs a, long long rpc) {
  extern __shared__ float sh[];
  float* gn_s = sh;              // gn of this row
  float* n_s = sh + a.cols;      // n of this row
  float* acc = sh + 2 * a.cols;  // dw, db, dpb partials, then red
  float* aw = a.pw != nullptr ? acc : nullptr;
  float* ab = a.pb != nullptr ? acc + a.cols : nullptr;
  float* apb = a.ppb != nullptr ? acc + 2 * a.cols : nullptr;
  float* red = acc + 3 * a.cols;
  for (int c = threadIdx.x * V; c < a.cols; c += blockDim.x * V)
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (aw) aw[c + j] = 0.f;
      if (ab) ab[c + j] = 0.f;
      if (apb) apb[c + j] = 0.f;
    }
  const float inv_cols = 1.f / (float)a.cols;
  const long long first = (long long)blockIdx.x * rpc;
  const long long end = first + rpc < a.rows ? first + rpc : a.rows;
  for (long long row = first; row < end; ++row) {
    const float mu = a.ln ? a.mean[row] : 0.f;
    const float r = a.rstd[row];
    float sa = 0.f, sb = 0.f;
    for (int c = threadIdx.x * V; c < a.cols; c += blockDim.x * V) {
      float g[V], hv[V], w[V];
      ldv<V>(a.dy, row * a.cols + c, a.dy_dt, g);
      ldv<V>(a.h, row * a.cols + c, a.h_dt, hv);
      if (a.w != nullptr) ldv<V>(a.w, c, a.w_dt, w);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float hn = rnd(hv[j], a.norm_dt);
        const float n = __fmul_rn(a.ln ? __fsub_rn(hn, mu) : hn, r);
        float gn;
        if (a.fused) {
          gn = a.w != nullptr ? __fmul_rn(g[j], rnd(w[j], a.w_cast)) : g[j];
          if (aw) aw[c + j] += __fmul_rn(g[j], n);
        } else {
          gn = a.w != nullptr
                   ? rnd(rnd(__fmul_rn(g[j], rnd(w[j], a.w_cast)), a.out_dt),
                         a.norm_dt)
                   : rnd(g[j], a.norm_dt);
          if (aw) aw[c + j] += rnd(__fmul_rn(g[j], rnd(n, a.norm_dt)), a.out_dt);
        }
        if (ab) ab[c + j] += g[j];
        gn_s[c + j] = gn;
        n_s[c + j] = n;
        sa = __fmaf_rn(gn, n, sa);
        sb += gn;
      }
    }
    const float ma = block_sum(sa, red) * inv_cols;
    const float mb = a.ln ? block_sum(sb, red) * inv_cols : 0.f;
    for (int c = threadIdx.x * V; c < a.cols; c += blockDim.x * V) {
      float d[V], v[V];
      if (a.dres != nullptr) ldv<V>(a.dres, row * a.cols + c, a.dres_dt, d);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float t = __fsub_rn(__fsub_rn(gn_s[c + j], mb),
                                  __fmul_rn(n_s[c + j], ma));
        float x = rnd(__fmul_rn(r, t), a.norm_dt);
        if (a.has_add) {
          x = rnd(x, a.add_dt);
          if (a.dres != nullptr) x = rnd(__fadd_rn(x, d[j]), a.add_dt);
        }
        if (apb) apb[c + j] += x;
        v[j] = x;
      }
      stv<V>(a.dx, row * a.cols + c, a.dx_dt, v);
    }
  }
  const long long base = (long long)blockIdx.x * a.cols;
  for (int c = threadIdx.x * V; c < a.cols; c += blockDim.x * V)
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (aw) a.pw[base + c + j] = aw[c + j];
      if (ab) a.pb[base + c + j] = ab[c + j];
      if (apb) a.ppb[base + c + j] = apb[c + j];
    }
}

// Up to three folds in one launch (blockIdx.y picks one): out[c] = the sum
// of part[0..nparts)[c], lane j of FOLD_LANES adding partials j, j + 8, ...
// in order and the lanes then added in order, rounded to p_dt, then to
// cast_dt, stored as out_dt.
struct FoldArgs {
  const float* part[3];
  void* out[3];
  int out_dt[3], p_dt[3], cast_dt[3];
  int nparts, cols;
};

__global__ void __launch_bounds__(32 * FOLD_LANES)
    partial_fold_kernel(FoldArgs f) {
  __shared__ float lanes[FOLD_LANES][33];
  const int q = blockIdx.y;
  const float* part = f.part[q];
  const int c = blockIdx.x * 32 + threadIdx.x;
  const int j = threadIdx.y;
  float s = 0.f;
  if (c < f.cols) {
#pragma unroll 4
    for (int i = j; i < f.nparts; i += FOLD_LANES) {
      s = __fadd_rn(s, part[(long long)i * f.cols + c]);
    }
  }
  lanes[j][threadIdx.x] = s;
  __syncthreads();
  if (j == 0 && c < f.cols) {
    float t = lanes[0][threadIdx.x];
    for (int i = 1; i < FOLD_LANES; ++i)
      t = __fadd_rn(t, lanes[i][threadIdx.x]);
    float v[1] = {rnd(rnd(t, f.p_dt[q]), f.cast_dt[q])};
    stv<1>(f.out[q], c, f.out_dt[q], v);
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// ring: a row-group kernel, whose plan counts on the SM's whole shared
// memory (the largest share of its L1) for its CTAs an SM
template <typename K, typename... Args>
cudaError_t launch(K kernel, bool ring, unsigned grid, int threads, int smem,
                   cudaStream_t st, Args... args) {
  cudaError_t err = ring ? cudaFuncSetAttribute(
                               kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared)
                         : cudaSuccess;
  if (err == cudaSuccess) err = set_smem(kernel, (size_t)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, (size_t)smem, st>>>(args...);
  return cudaGetLastError();
}

template <class D>
cudaError_t fwd_ring(int nc, int grid, int threads, int smem, cudaStream_t st,
                     const FwdArgs& a, const Ring& p) {
  if (nc == 1)
    return launch(norm_fwd_ring_kernel<1, D>, true, grid, threads, smem, st, a, p);
  if (nc == 2)
    return launch(norm_fwd_ring_kernel<2, D>, true, grid, threads, smem, st, a, p);
  return cudaErrorInvalidValue;
}

template <class D>
cudaError_t fwd_row(int nc, int grid, int threads, cudaStream_t st,
                    const FwdArgs& a) {
  if (nc == 1)
    return launch(norm_fwd_row_kernel<1, D>, false, grid, threads, 32 * 4, st, a);
  if (nc == 2)
    return launch(norm_fwd_row_kernel<2, D>, false, grid, threads, 32 * 4, st, a);
  return cudaErrorInvalidValue;
}

template <class D>
cudaError_t bwd_ring(int nc, int grid, int threads, int smem, cudaStream_t st,
                     const BwdArgs& a, const Ring& p) {
  if (nc == 1)
    return launch(norm_bwd_ring_kernel<1, D>, true, grid, threads, smem, st, a, p);
  if (nc == 2)
    return launch(norm_bwd_ring_kernel<2, D>, true, grid, threads, smem, st, a, p);
  return cudaErrorInvalidValue;
}

// The backward's weight, bias and pre-bias gradients (dw, db, dpb; null
// where not asked for) from its `grid` partial rows, in one
// partial_fold_kernel launch. The plain order rounds each product to P
// before the sum, and the sum to P after it (a bf16 sum's rounding); the
// fused order sums fp32 products.
cudaError_t fold_partials(const BwdArgs& a, int grid, void* dw, void* db,
                          void* dpb, int b_dt, int b_cast, int pb_dt,
                          int pb_cast, cudaStream_t st) {
  const int fold_p = a.fused ? F32 : a.out_dt;
  FoldArgs f{};
  f.nparts = grid;
  f.cols = a.cols;
  int n = 0;
  const struct {
    const float* part;
    void* out;
    int out_dt, p_dt, cast_dt;
  } folds[3] = {{a.pw, dw, a.w_dt, fold_p, a.w_cast},
                {a.pb, db, b_dt, fold_p, b_cast},
                {a.ppb, dpb, pb_dt, a.add_dt, pb_cast}};
  for (const auto& g : folds) {
    if (g.out == nullptr) continue;
    f.part[n] = g.part;
    f.out[n] = g.out;
    f.out_dt[n] = g.out_dt;
    f.p_dt[n] = g.p_dt;
    f.cast_dt[n] = g.cast_dt;
    ++n;
  }
  if (n == 0) return cudaSuccess;
  partial_fold_kernel<<<dim3((unsigned)((a.cols + 31) / 32), (unsigned)n),
                        dim3(32, FOLD_LANES), 0, st>>>(f);
  return cudaGetLastError();
}

}  // namespace

// ring != 0: the row-group kernel with nc 8-column chunks a thread (1-2),
// grid CTAs of threads, smem bytes, the Ring fields; else the block-per-row
// kernels, one row a block (grid = rows): nc > 0 the one holding nc chunks a
// thread in registers, nc = 0 the looping one (vec elements a step)
extern "C" int fused_norm_fwd(const void* x, const void* res, const void* pb,
                              const void* w, const void* b, void* out,
                              void* res_out, void* mean, void* rstd,
                              long long rows, int cols, int x_dt, int res_dt,
                              int pb_dt, int w_dt, int w_cast, int b_dt,
                              int b_cast, int out_dt, int add_dt, int norm_dt,
                              int ln, int fused, int vec, float eps, int ring,
                              int grid, int threads, int smem, int gwarps,
                              int groups, int nc, int stages, int stage_bytes,
                              long long rows_per_cta, void* stream) {
  FwdArgs a{x, res, pb, w, b, out, res_out, static_cast<float*>(mean),
            static_cast<float*>(rstd), rows, cols, x_dt, res_dt, pb_dt, w_dt,
            w_cast, b_dt, b_cast, out_dt, add_dt, norm_dt, ln, fused, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ring) {
    Ring p{rows_per_cta, gwarps, groups, stages, stage_bytes};
    if (fits<FwdO2>(a)) return fwd_ring<FwdO2>(nc, grid, threads, smem, st, a, p);
    if (fits<FwdO2F32Res>(a))
      return fwd_ring<FwdO2F32Res>(nc, grid, threads, smem, st, a, p);
    if (fits<FwdBf16>(a)) return fwd_ring<FwdBf16>(nc, grid, threads, smem, st, a, p);
    return fwd_ring<FwdAny>(nc, grid, threads, smem, st, a, p);
  }
  if (nc > 0) {  // decode: the serving dtypes fixed
    if (fits<FwdBf16>(a)) return fwd_row<FwdBf16>(nc, grid, threads, st, a);
    return fwd_row<FwdAny>(nc, grid, threads, st, a);
  }
  if (vec == 8) return launch(norm_fwd_kernel<8>, false, grid, threads, smem, st, a);
  return launch(norm_fwd_kernel<1>, false, grid, threads, smem, st, a);
}

// grid is also the number of partial rows in part_w, part_b and part_pb
extern "C" int fused_norm_bwd(const void* dy, const void* dres, const void* h,
                              const void* mean, const void* rstd,
                              const void* w, void* dx, void* part_w,
                              void* part_b, void* part_pb, void* dw, void* db,
                              void* dpb, long long rows, int cols, int grid,
                              int dy_dt, int dres_dt, int h_dt, int w_dt,
                              int w_cast, int dx_dt, int b_cast, int b_dt,
                              int pb_cast, int pb_dt, int out_dt, int add_dt,
                              int norm_dt, int has_add, int ln, int fused,
                              int vec, int ring, int threads, int smem,
                              int gwarps, int groups, int nc, int stages,
                              int stage_bytes, long long rows_per_cta,
                              void* stream) {
  BwdArgs a{dy, dres, h, w, static_cast<const float*>(mean),
            static_cast<const float*>(rstd), dx, static_cast<float*>(part_w),
            static_cast<float*>(part_b), static_cast<float*>(part_pb), rows,
            cols, dy_dt, dres_dt, h_dt, w_dt, w_cast, dx_dt, out_dt, add_dt,
            norm_dt, has_add, ln, fused};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (ring) {
    Ring p{rows_per_cta, gwarps, groups, stages, stage_bytes};
    err = fits<BwdO2>(a)
              ? bwd_ring<BwdO2>(nc, grid, threads, smem, st, a, p)
              : bwd_ring<BwdAny>(nc, grid, threads, smem, st, a, p);
  } else if (vec == 8) {
    err = launch(norm_bwd_kernel<8>, false, grid, threads, smem, st, a,
                 rows_per_cta);
  } else {
    err = launch(norm_bwd_kernel<1>, false, grid, threads, smem, st, a,
                 rows_per_cta);
  }
  if (err != cudaSuccess) return err;
  return fold_partials(a, grid, dw, db, dpb, b_dt, b_cast, pb_dt, pb_cast,
                       st);
}
