// Flash attention for Hopper (sm_90a), forward and backward. The ports of
// paddle_tpu/ops/flash_attention.py:
//   _flash_fwd_kernel      (with_lse=False; prefill, generate)  -> flash_fwd
//   _flash_fwd_kernel_lse  (with_lse=True; training forward)    -> flash_fwd_lse
//   _flash_bwd_dq_kernel   (training backward, dq)              -> flash_bwd_dq
//   _flash_bwd_dkv_kernel  (training backward, dk and dv)       -> flash_bwd_dkv
// The forward with lse is the same kernel template as the forward, with the
// lse store switched on at compile time.
//
// Every kernel also takes the `with_segs` and `dropout_p > 0` branches of its
// Pallas kernel as compile-time flags SEGS and DROP (see SegDrop), entered
// through the *_segdrop entry points; DROP draws B0, the port of _keep_tile
// (keep_elem). The flag-free instantiations compile as before: the flags
// only add code, and the extra argument comes last.
//
// What it computes: out = softmax(q k^T * sm_scale [+ causal mask]) v per
// (batch, head), online softmax in fp32, output in q's dtype. Causal masking
// is bottom-right aligned (query row i sees keys j <= i + Lk - Lq); rows that
// see no key at all emit 0. GQA reads kv head h / (H / Hkv) directly instead
// of materialising repeated K/V. Lq and Lk may be any length: tile edges are
// masked, so the TPU's lane-alignment floor (_fit_block) has no counterpart.
//
// Layout: q (B, Lq, H, D), k/v (B, Lk, Hkv, D), out (B, Lq, H, D), all
// contiguous, the layout of paddle's flash_attention API.
//
// What bounds it on an H100: at prefill lengths (L >= 512, D = 128) the work
// is 4 * Lq * Lk * D operations per head against 2 * (Lq + Lk) * D elements
// moved, so the tensor-core rate bounds it (989 TFLOP/s bf16). Two kernels,
// K tiles past the causal diagonal never loaded:
//
// * bfloat16 (serving and training): one block per (128-row Q tile, batch
//   * head), built for Hopper: a producer warp streams K/V tiles by TMA
//   through a two-stage mbarrier ring while two consumer warpgroups run
//   wgmma (S = Q K^T from shared memory, O += P V with P re-packed in
//   registers and V read through the transpose flag) and the online
//   softmax in registers. The design notes sit above the kernel.
// * float32 (parity runs): the products on the CUDA cores in fp32, one
//   block per (64-row Q tile, batch * head); the Q tile staged once in
//   shared memory pre-scaled by sm_scale, K transposed and padded; each
//   thread owns a 4x4 block of scores and a 4 x (D/16) block of the
//   accumulator; row statistics across 16 lanes by shuffles.
//
// lse (forward with lse): per (batch, head, query row) the logsumexp of the
// scaled logits, layout (B, H, Lq) fp32; a row that sees no key gets +1e30
// (so exp(s - lse) is 0 in the backward) and out 0.
//
// Backward. With P = exp(S * sm_scale - lse) recomputed from the saved lse,
// dP = dO V^T, dS = P o (dP - delta) * sm_scale and delta = rowsum(dO o O)
// (computed by the caller): dq = dS K, dk = dS^T Q, dv = P^T dO. It does
// 2.5x the forward's products (S, dP, dq in one kernel; S, dP, dv, dk in
// the other), so the tensor-core rate bounds it too. Two kernels, as on the
// TPU, so that neither needs atomics:
// * dq: one block per (Q tile, batch * head); it streams 64-key K/V tiles
//   over the causal range only (the forward's rule) and keeps dq in fp32
//   registers.
// * dk/dv: one block per (K tile, batch * kv head); it loops over the
//   H / Hkv query heads of its group (GQA: the group's sum is taken in
//   registers, where the TPU package repeated K/V and let AD sum) and over
//   the 64-query Q/dO tiles from the first one that can see the K tile.
// In bf16 both are built for Hopper like the forward: 128-row blocks (query
// rows for dq, keys for dk/dv) of two consumer warpgroups, 64 rows each,
// fed by one producer warp through a TMA/mbarrier ring. The score and dP
// products (S = Q K^T, dP = dO V^T for dq; S^T = K Q^T, dP^T = V dO^T for
// dk/dv) are wgmma with both operands in shared memory; P and dS come out
// of them in the accumulator layout of the warpgroup's own rows, so they
// are re-packed in registers as the bf16 A operands of the second products
// (dq += dS K; dv += P^T dO, dk += dS^T Q), whose B operand (K, dO, Q) is
// read N-major through the transpose flag: nothing is transposed in shared
// memory. The design notes sit above the two kernels. In fp32 they run on
// the CUDA cores, 256 threads, each owning a 4x4 block of the score tile
// and a 4 x (D/16) block of the gradient, with rows of stride D + 1 in
// shared memory so that neither the row-wise nor the column-wise reads
// conflict.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // query rows per block
constexpr int BN = 64;   // keys per streamed tile
constexpr int NT = 256;  // threads: 16 row groups x 16 lanes

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

template <int D>
struct Smem {
  static constexpr int QS = D + 4;    // Q row stride (float4-aligned, bank-shifted)
  static constexpr int KS = BN + 1;   // transposed-K row stride
  static constexpr int PS = BN + 1;   // P row stride
  static constexpr int floats = BM * QS + D * KS + BN * D + BM * PS;
  static constexpr size_t bytes = floats * sizeof(float);
};

constexpr float LSE_MASKED = 1e30f;  // lse of a row that sees no key

// The segment ids and the dropout of the variant kernels (the `with_segs`
// and `dropout_p > 0` branches of the Pallas kernels), compile-time flags
// SEGS and DROP of every kernel below; the flag-free instantiations never
// read it.
// * SEGS: query row i of batch b sees key j only where qseg[b * Lq + i] ==
//   kseg[b * Lk + j] (ids (B, L) int32, shared by the heads), on top of the
//   causal rule.
// * DROP: a probability P_ij that multiplies V (forward, dv) or a dP_ij
//   (dq, dk) is kept where keep_elem() says, and then scaled by inv_keep;
//   the normaliser and the lse take the undropped P. keep_prob = fp32(1 -
//   p) and inv_keep = fp32(1 / (1 - p)), each rounded once from a double
//   on the host, as JAX rounds the Python floats against fp32 arrays.
struct SegDrop {
  const int* qseg;
  const int* kseg;
  uint32_t seed;
  float keep_prob;
  float inv_keep;
};

// B0, the port of _keep_tile (paddle_tpu/ops/flash_attention.py:47): the
// stateless lowbias32 hash of (seed, bh, absolute query row, absolute key
// column), bh = b * H + h the flat (batch, query head) index; the element is
// kept where its top 24 bits times 2^-24 (exact in fp32) are below
// keep_prob. Keyed on absolute coordinates, it is the same mask under every
// kernel's tiling. keep_base() folds the seed and bh terms, taken once per
// (block, head).
__device__ __forceinline__ uint32_t keep_base(uint32_t seed, int bh) {
  return (seed * 0xC2B2AE3Du) ^ ((uint32_t)bh * 0x27D4EB2Fu);
}

__device__ __forceinline__ bool keep_elem(uint32_t base, int row, int col,
                                          float keep_prob) {
  uint32_t h = ((uint32_t)row * 0x9E3779B1u) ^ ((uint32_t)col * 0x85EBCA77u) ^ base;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return (float)(h >> 8) * (1.0f / 16777216.0f) < keep_prob;
}

template <typename T, int D, bool LSE, bool SEGS, bool DROP>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Lq, int Lk, int H, int Hkv,
                 int causal, float sm_scale, SegDrop sd) {
  using S = Smem<D>;
  constexpr int DJ = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BM][QS]
  float* Kt = Qs + BM * S::QS;      // [D][KS]
  float* Vs = Kt + D * S::KS;       // [BN][D]
  float* Ps = Vs + BN * D;          // [BM][PS]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / Hkv);
  const int m0 = blockIdx.x * BM;
  const long q_stride = (long)H * D;     // between sequence positions
  const long kv_stride = (long)Hkv * D;
  const T* qb = q + ((long)b * Lq * H + h) * D;
  const T* kb = k + ((long)b * Lk * Hkv + kvh) * D;
  const T* vb = v + ((long)b * Lk * Hkv + kvh) * D;
  T* ob = o + ((long)b * Lq * H + h) * D;

  for (int idx = tid; idx < BM * D; idx += NT) {
    const int r = idx / D, d = idx % D, i = m0 + r;
    Qs[r * S::QS + d] = i < Lq ? to_f(qb[(long)i * q_stride + d]) * sm_scale : 0.f;
  }

  const int shift = Lk - Lq;  // bottom-right causal alignment
  int n_end = Lk;
  if (causal) n_end = min(Lk, max(0, m0 + BM + shift));

  float m_i[4], l_i[4], acc[4][DJ];
  int qs[4];  // SEGS: the segment ids of the thread's rows
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_i[r] = -INFINITY;
    l_i[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[r][j] = 0.f;
    const int row = m0 + ty * 4 + r;
    qs[r] = SEGS && row < Lq ? sd.qseg[(long)b * Lq + row] : 0;
  }
  const int* ks = SEGS ? sd.kseg + (long)b * Lk : nullptr;
  const uint32_t kbase = DROP ? keep_base(sd.seed, bh) : 0u;

  for (int n0 = 0; n0 < n_end; n0 += BN) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BN * D; idx += NT) {
      const int r = idx / D, d = idx % D, j = n0 + r;
      const bool in = j < Lk;
      Kt[d * S::KS + r] = in ? to_f(kb[(long)j * kv_stride + d]) : 0.f;
      Vs[r * D + d] = in ? to_f(vb[(long)j * kv_stride + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[r] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + r) * S::QS + d]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tx + 16 * c;
        const float k0 = Kt[(d + 0) * S::KS + col];
        const float k1 = Kt[(d + 1) * S::KS + col];
        const float k2 = Kt[(d + 2) * S::KS + col];
        const float k3 = Kt[(d + 3) * S::KS + col];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          s[r][c] = fmaf(a[r].x, k0, s[r][c]);
          s[r][c] = fmaf(a[r].y, k1, s[r][c]);
          s[r][c] = fmaf(a[r].z, k2, s[r][c]);
          s[r][c] = fmaf(a[r].w, k3, s[r][c]);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = m0 + ty * 4 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = n0 + tx + 16 * c;
        bool ok = col < Lk && (!causal || row + shift >= col);
        if (SEGS && ok) ok = ks[col] == qs[r];
        s[r][c] = ok ? s[r][c] : -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[r], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no valid key yet
      const float alpha = expf(m_i[r] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[r][c] - m_use);
        // the normaliser takes the undropped p, P V the dropped one
        Ps[(ty * 4 + r) * S::PS + tx + 16 * c] =
            !DROP ? p
                  : keep_elem(kbase, row, n0 + tx + 16 * c, sd.keep_prob) ? p * sd.inv_keep
                                                                          : 0.f;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_i[r] = alpha * l_i[r] + sum;
      m_i[r] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[r][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int n = 0; n < BN; ++n) {
      float p[4], vv[DJ];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = Ps[(ty * 4 + r) * S::PS + n];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[n * D + tx + 16 * j];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[r][j] = fmaf(p[r], vv[j], acc[r][j]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = m0 + ty * 4 + r;
    if (row >= Lq) continue;
    const float inv = 1.f / fmaxf(l_i[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[(long)row * q_stride + tx + 16 * j] = from_f<T>(acc[r][j] * inv);
    if (LSE && tx == 0)
      lse[(long)bh * Lq + row] = l_i[r] > 0.f ? m_i[r] + logf(l_i[r]) : LSE_MASKED;
  }
}

// ---------------------------------------------------------------------------
// bfloat16 forward: TMA-fed, warp-specialised wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One block per (128 query rows, batch * head): consumer warpgroups 0 and 1
// own 64 rows each, and one warp of warpgroup 2 (the producer) starts every
// copy. The pieces:
// * TMA. The producer loads the Q tile once, then streams 128-key K and V
//   tiles through a ring of FW_STAGES stages in shared memory; a `full`
//   mbarrier per tile counts the bytes in, an `empty` one counts the
//   consumers out, for K as soon as its S is computed and for V once its
//   P V is. The tensor maps are 4-D over (D, H, L, B), so the
//   rows of a ragged last tile past L are zero-filled, never read from the
//   next head or batch (zero keys still score 0, so the key mask stays).
//   A tile lands as D/64 boxes of 64 columns (128-byte rows) in the 128-byte
//   swizzle that wgmma reads: row r's 16-byte chunk c sits at chunk
//   c ^ (r % 8), 8 rows (1024 bytes) to a swizzle atom.
// * wgmma. S = Q K^T is m64n128k16 with both operands in shared memory,
//   K-major (descriptor SBO 1024 bytes: the next 8 rows; a 16-column k-step
//   advances the start address by 32 bytes inside the atom, the next 64
//   columns are the next box). O += P V is m64nDk16 with P in registers (the
//   score accumulators re-packed as bf16 A fragments: the accumulator
//   layout of columns 16kk..16kk+15 is the A layout of k-step kk) and V read
//   N-major from the same boxes through the transpose flag (LBO: the next
//   64 columns of D, one box on; SBO: the next 8 keys). V is never
//   transposed.
// * Online softmax in registers on exp2, log2 e folded into the scale. Only
//   tiles that cross the causal diagonal of the warpgroup's rows or the end
//   of Lk are masked. Each thread keeps a partial row sum; the 4 lanes of a
//   row add theirs once, at the end.
// * Within a warpgroup, tile i's S = Q K^T starts with tile i-1's P V, and
//   tile i's softmax runs while that P V is on the tensor cores (the two
//   warpgroups also fill each other's softmax time).
// * Key tiles run from the last to the first, so the masked tiles come
//   first; causal Q tiles run heaviest first within each (batch, head), and
//   the blocks of one head run side by side, sharing its K/V in L2.
// * setmaxnreg gives the consumers 240 registers and the producer 24: S and O
//   take 64 fp32 each per thread at D = 128, and P 32 for each of the two
//   tiles in flight.
constexpr int FW_BM = 128;       // query rows per block
constexpr int FW_BN = 128;       // keys per K/V tile
constexpr int FW_STAGES = 2;     // K/V ring depth
constexpr int FW_CONSUMERS = 256;                 // two warpgroups
constexpr int FW_THREADS = FW_CONSUMERS + 128;    // + the producer warpgroup
constexpr uint32_t SW_ROW = 128;                  // bytes of a swizzled box row
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct FwSmem {
  static constexpr uint32_t QBOX = FW_BM * SW_ROW;    // one 64-column box of Q
  static constexpr uint32_t KVBOX = FW_BN * SW_ROW;   // one of a K or V tile
  static constexpr uint32_t Q = QBOX * (D / 64);
  static constexpr uint32_t KV = KVBOX * (D / 64);
  static constexpr uint32_t BARS = Q + FW_STAGES * 2 * KV;
  // mbarriers: q_full, then per stage k_full, v_full, k_empty, v_empty
  static constexpr size_t bytes = BARS + 8 * (1 + 4 * FW_STAGES) + 1024;  // + alignment
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Wait until the phase of parity `phase` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(bar), "r"(phase) : "memory");
}

// One box of a 4-D tensor map into shared memory, counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving the writes or reads of a wgmma's registers
// (accumulators, A fragments) across the asynchronous wgmma that uses them:
// called before wgmma.fence and after the wait that retires the wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e]) :: "memory");
}

#define ACC8(d, i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x N) (+)= A (64 x 16) B (N x 16)^T, A and B K-major in shared
// memory; N = 128 (64 accumulators a thread) or 64 (32).
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24), ACC8(d, 32),
        ACC8(d, 40), ACC8(d, 48), ACC8(d, 56)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N) += A (64 x 16, bf16 fragments in registers) B (16 x N, N-major
// in shared memory, read through the transpose flag).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24), ACC8(d, 32),
        ACC8(d, 40), ACC8(d, 48), ACC8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef ACC8

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Issue d = A B^T over D columns (no commit): A (64 rows) and B, K-major in
// shared memory, each stored as D/64 boxes of 64 columns (128-byte swizzled
// rows), ABOX and BBOX bytes apart. A 16-column k-step advances the start
// address by 32 bytes inside the swizzle atom; SBO 1024 is the next 8 rows.
template <int D, uint32_t ABOX, uint32_t BBOX, int N>
__device__ __forceinline__ void mma_ss(float (&d)[N], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t box = kk / 4, off = (kk % 4) * 32;  // 64-column box, k-step
    wgmma_ss(d, sw128_desc(a + box * ABOX + off, 16, 1024),
             sw128_desc(b + box * BBOX + off, 16, 1024), kk > 0);
  }
}

// Issue d += A B (no commit): A (64 x 16 KS) as bf16 fragments in registers,
// B (16 KS rows x N columns) N-major in shared memory, read through the
// transpose flag: rows of 128 swizzled bytes, the N columns in boxes of 64
// BBOX bytes apart (LBO), SBO 1024 the next 8 rows, a k-step 16 rows on.
template <uint32_t BBOX, int KS, int N>
__device__ __forceinline__ void mma_rs(float (&d)[N], const uint32_t (&a)[KS][4],
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_rs(d, a[kk], sw128_desc(b + kk * 16 * SW_ROW, BBOX, 1024));
}

// Re-pack a 64 x 16 KS accumulator tile as bf16 A fragments: the
// accumulator layout of columns 16kk..16kk+15 is the A layout of k-step kk.
template <int KS>
__device__ __forceinline__ void pack_frags(uint32_t (&a)[KS][4],
                                           const float (&s)[KS * 8]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
}

// Start S = Q K^T for one tile (one wgmma group); q_rows is the warpgroup's
// 64 rows of the Q tile, kt the K tile.
template <int D>
__device__ __forceinline__ void qk_async(float (&s)[FW_BN / 2], uint32_t q_rows,
                                         uint32_t kt) {
  mma_ss<D, FwSmem<D>::QBOX, FwSmem<D>::KVBOX>(s, q_rows, kt);
  wgmma_commit();
}

// Start O += P V for one tile (one wgmma group).
template <int D>
__device__ __forceinline__ void pv_async(float (&o)[D / 2],
                                         const uint32_t (&p)[FW_BN / 16][4],
                                         uint32_t vt) {
  mma_rs<FwSmem<D>::KVBOX>(o, p, vt);
  wgmma_commit();
}

// The online softmax of one tile of scores, in registers. A key is masked
// for a row at or past min(Lk, the row's causal end); `wg_end` is the
// smallest causal end of the warpgroup's rows, so a tile wholly before it is
// not masked at all. Raises the running max m (raw scores) of the thread's
// two rows, adds the tile's probabilities to the partial sums l, packs them
// as bf16 A fragments into p and returns in alpha the factor by which O
// rescales.
//
// The variants (see SegDrop): with SEGS every tile is masked where a key's
// id `ks[col]` differs from the row's (qs0, qs1); with DROP the
// probabilities are dropped and scaled after the sums and before they are
// packed, so P V takes the dropped bf16 values and l the undropped ones.
// r0, r1 are the thread's two absolute query rows, kbase keep_base().
struct RowVar {
  const int* ks;
  int qs0, qs1, r0, r1;
  uint32_t kbase;
  float keep_prob, inv_keep;
};

template <bool SEGS, bool DROP>
__device__ __forceinline__ void softmax_tile(float (&s)[FW_BN / 2],
                                             uint32_t (&p)[FW_BN / 16][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int n0, int Lk,
                                             int wg_end, int end0, int end1,
                                             int t, float scale_log2,
                                             const RowVar& rv) {
  if (SEGS) {  // every tile: a key of another segment is masked
#pragma unroll
    for (int j = 0; j < FW_BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + j * 8 + t * 2 + e;
        const int kid = col < Lk ? rv.ks[col] : 0;  // past Lk: masked below
        if (kid != rv.qs0) s[j * 4 + e] = -INFINITY;
        if (kid != rv.qs1) s[j * 4 + 2 + e] = -INFINITY;
      }
  }
  if (n0 + FW_BN > min(Lk, wg_end)) {
    const int lim0 = min(Lk, end0), lim1 = min(Lk, end1);
#pragma unroll
    for (int j = 0; j < FW_BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + j * 8 + t * 2 + e;
        if (col >= lim0) s[j * 4 + e] = -INFINITY;
        if (col >= lim1) s[j * 4 + 2 + e] = -INFINITY;
      }
  }
  // rows: the thread's first (elements 4j, 4j+1) and second (4j+2, 4j+3)
  float mx0 = m[0], mx1 = m[1];
#pragma unroll
  for (int j = 0; j < FW_BN / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[j * 4], s[j * 4 + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[j * 4 + 2], s[j * 4 + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {  // the 4 lanes of a row
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  // exponent base; 0 while a row has seen no key (its scores are -inf)
  const float mb0 = mx0 == -INFINITY ? 0.f : mx0 * scale_log2;
  const float mb1 = mx1 == -INFINITY ? 0.f : mx1 * scale_log2;
  alpha[0] = fast_exp2(m[0] * scale_log2 - mb0);
  alpha[1] = fast_exp2(m[1] * scale_log2 - mb1);
  m[0] = mx0;
  m[1] = mx1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int i = 0; i < FW_BN / 2; i += 4) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[i + e] = fast_exp2(fmaf(s[i + e], scale_log2, -mb0));
      s[i + 2 + e] = fast_exp2(fmaf(s[i + 2 + e], scale_log2, -mb1));
      sum0 += s[i + e];
      sum1 += s[i + 2 + e];
    }
  }
  l[0] = l[0] * alpha[0] + sum0;
  l[1] = l[1] * alpha[1] + sum1;
  if (DROP) {
#pragma unroll
    for (int j = 0; j < FW_BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + j * 8 + t * 2 + e;
        s[j * 4 + e] = keep_elem(rv.kbase, rv.r0, col, rv.keep_prob)
                           ? s[j * 4 + e] * rv.inv_keep : 0.f;
        s[j * 4 + 2 + e] = keep_elem(rv.kbase, rv.r1, col, rv.keep_prob)
                               ? s[j * 4 + 2 + e] * rv.inv_keep : 0.f;
      }
  }
  pack_frags(p, s);
}

template <int N>
__device__ __forceinline__ void rescale_rows(float (&o)[N], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    o[i] *= alpha[0];
    o[i + 1] *= alpha[0];
    o[i + 2] *= alpha[1];
    o[i + 3] *= alpha[1];
  }
}

template <int D, bool LSE, bool SEGS, bool DROP>
__global__ void __launch_bounds__(FW_THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       int Lq, int Lk, int H, int Hkv, int causal,
                       float sm_scale, SegDrop sd) {
  using S = FwSmem<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms: 1024
  const uint32_t bar_q = sq + S::BARS;
  // stage s: the K tile, then the V tile; its barriers after q_full
  auto k_tile = [&](int s) { return sq + S::Q + (uint32_t)s * 2 * S::KV; };
  auto bar_kfull = [&](int s) { return bar_q + 8u * (1 + 4 * s); };
  auto bar_vfull = [&](int s) { return bar_q + 8u * (2 + 4 * s); };
  auto bar_kempty = [&](int s) { return bar_q + 8u * (3 + 4 * s); };
  auto bar_vempty = [&](int s) { return bar_q + 8u * (4 + 4 * s); };

  const int bh = blockIdx.y, b = bh / H, h = bh % H, kvh = h / (H / Hkv);
  // causal: heaviest Q tile first
  const int m0 = (int)(causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * FW_BM;
  const int shift = Lk - Lq;  // bottom-right causal alignment
  const int n_end = causal ? min(Lk, max(0, m0 + FW_BM + shift)) : Lk;
  const int n_tiles = (n_end + FW_BN - 1) / FW_BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < FW_STAGES; ++s) {
      mbar_init(bar_kfull(s), 1);
      mbar_init(bar_vfull(s), 1);
      mbar_init(bar_kempty(s), FW_CONSUMERS);
      mbar_init(bar_vempty(s), FW_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= FW_CONSUMERS / 32) {
    // producer warpgroup: one thread starts every copy, key tiles from the
    // last to the first
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == FW_CONSUMERS / 32 && lane == 0 && n_tiles > 0) {
      mbar_expect_tx(bar_q, S::Q);
      for (int c = 0; c < D / 64; ++c)
        tma_load(sq + c * S::QBOX, &tm_q, bar_q, c * 64, h, m0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % FW_STAGES;
        const uint32_t free_phase = ((it / FW_STAGES) & 1) ^ 1;  // first pass: free
        const int n0 = (n_tiles - 1 - it) * FW_BN;
        const uint32_t kt = k_tile(s), vt = kt + S::KV;
        mbar_wait(bar_kempty(s), free_phase);
        mbar_expect_tx(bar_kfull(s), S::KV);
        for (int c = 0; c < D / 64; ++c)
          tma_load(kt + c * S::KVBOX, &tm_k, bar_kfull(s), c * 64, kvh, n0, b);
        mbar_wait(bar_vempty(s), free_phase);
        mbar_expect_tx(bar_vfull(s), S::KV);
        for (int c = 0; c < D / 64; ++c)
          tma_load(vt + c * S::KVBOX, &tm_v, bar_vfull(s), c * 64, kvh, n0, b);
      }
    }
  } else {
    // consumer warpgroups. Tile i's S = Q K^T starts together with tile
    // i-1's O += P V, and tile i's softmax runs while that P V is still on
    // the tensor cores; O is rescaled once it has landed.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = warp / 4, t = lane % 4;
    const int row_lo = m0 + wg * 64;                             // the warpgroup's
    const int r0 = row_lo + (warp % 4) * 16 + lane / 4, r1 = r0 + 8;  // the thread's
    // causal end of a row: keys at or past it are masked
    const int wg_end = causal ? row_lo + shift + 1 : Lk;
    const int end0 = causal ? r0 + shift + 1 : Lk, end1 = causal ? r1 + shift + 1 : Lk;
    const float scale_log2 = sm_scale * LOG2E;
    const uint32_t q_rows = sq + wg * 64 * SW_ROW;
    RowVar rv{};
    if (SEGS) {
      rv.ks = sd.kseg + (long)b * Lk;
      rv.qs0 = r0 < Lq ? sd.qseg[(long)b * Lq + r0] : 0;
      rv.qs1 = r1 < Lq ? sd.qseg[(long)b * Lq + r1] : 0;
    }
    if (DROP) {
      rv.r0 = r0;
      rv.r1 = r1;
      rv.kbase = keep_base(sd.seed, bh);
      rv.keep_prob = sd.keep_prob;
      rv.inv_keep = sd.inv_keep;
    }

    float oacc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
    float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};
    float sacc[FW_BN / 2];
#pragma unroll
    for (int i = 0; i < FW_BN / 2; ++i) sacc[i] = 0.f;
    uint32_t pa[FW_BN / 16][4];

    if (n_tiles > 0) {
      mbar_wait(bar_q, 0);
      mbar_wait(bar_kfull(0), 0);
      fence_regs(sacc);
      wgmma_fence();
      qk_async<D>(sacc, q_rows, k_tile(0));
      wgmma_wait<0>();
      fence_regs(sacc);
      mbar_arrive(bar_kempty(0));
      float alpha[2];  // O is still 0: nothing to rescale
      softmax_tile<SEGS, DROP>(sacc, pa, m_i, l_i, alpha, (n_tiles - 1) * FW_BN, Lk,
                               wg_end, end0, end1, t, scale_log2, rv);
    }
    for (int it = 1; it < n_tiles; ++it) {
      const int s = it % FW_STAGES, sp = (it - 1) % FW_STAGES;
      mbar_wait(bar_kfull(s), (it / FW_STAGES) & 1);
      mbar_wait(bar_vfull(sp), ((it - 1) / FW_STAGES) & 1);
      fence_regs(sacc);
      fence_regs(oacc);
      fence_regs(pa);
      wgmma_fence();
      qk_async<D>(sacc, q_rows, k_tile(s));
      pv_async<D>(oacc, pa, k_tile(sp) + S::KV);
      wgmma_wait<1>();  // S of this tile is in
      fence_regs(sacc);
      mbar_arrive(bar_kempty(s));
      float alpha[2];
      uint32_t pa_next[FW_BN / 16][4];
      softmax_tile<SEGS, DROP>(sacc, pa_next, m_i, l_i, alpha, (n_tiles - 1 - it) * FW_BN,
                               Lk, wg_end, end0, end1, t, scale_log2, rv);
      wgmma_wait<0>();  // P V of the previous tile is in
      fence_regs(oacc);
      fence_regs(pa);   // P stays in its registers until then
      mbar_arrive(bar_vempty(sp));
      rescale_rows(oacc, alpha);
#pragma unroll
      for (int kk = 0; kk < FW_BN / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) pa[kk][e] = pa_next[kk][e];
    }
    if (n_tiles > 0) {
      const int sp = (n_tiles - 1) % FW_STAGES;
      mbar_wait(bar_vfull(sp), ((n_tiles - 1) / FW_STAGES) & 1);
      fence_regs(oacc);
      fence_regs(pa);
      wgmma_fence();
      pv_async<D>(oacc, pa, k_tile(sp) + S::KV);
      wgmma_wait<0>();
      fence_regs(oacc);
      mbar_arrive(bar_vempty(sp));
    }

    // epilogue: the 4 lanes of a row add their partial sums
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_i[0] += __shfl_xor_sync(0xffffffffu, l_i[0], off);
      l_i[1] += __shfl_xor_sync(0xffffffffu, l_i[1], off);
    }
    const float inv0 = 1.f / fmaxf(l_i[0], 1e-30f);
    const float inv1 = 1.f / fmaxf(l_i[1], 1e-30f);
    const long q_stride = (long)H * D;
    __nv_bfloat16* ob = o + ((long)b * Lq * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + t * 2;
      if (r0 < Lq)
        *reinterpret_cast<uint32_t*>(ob + (long)r0 * q_stride + col) =
            pack_bf16(oacc[j * 4] * inv0, oacc[j * 4 + 1] * inv0);
      if (r1 < Lq)
        *reinterpret_cast<uint32_t*>(ob + (long)r1 * q_stride + col) =
            pack_bf16(oacc[j * 4 + 2] * inv1, oacc[j * 4 + 3] * inv1);
    }
    if (LSE && t == 0) {  // the 4 lanes of a row hold the same m_i, l_i
      if (r0 < Lq)
        lse[(long)bh * Lq + r0] = l_i[0] > 0.f ? m_i[0] * sm_scale + logf(l_i[0]) : LSE_MASKED;
      if (r1 < Lq)
        lse[(long)bh * Lq + r1] = l_i[1] > 0.f ? m_i[1] * sm_scale + logf(l_i[1]) : LSE_MASKED;
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link against libcuda.
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// Tensor map of a contiguous bf16 (B, L, heads, D) tensor as 4-D (D, heads,
// L, B), boxes of 64 columns x 1 head x `rows` rows, 128-byte swizzle; rows
// past L read as zeros.
cudaError_t encode_tiles(CUtensorMap* map, const void* ptr, int D, int heads,
                         int L, int B, int rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t row = (cuuint64_t)D * sizeof(__nv_bfloat16);
  const cuuint64_t strides[3] = {row, row * heads, row * heads * L};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                            const_cast<void*>(ptr), dims, strides, box,
                            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D, bool LSE, bool SEGS, bool DROP>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         float* lse, int B, int Lq, int Lk, int H, int Hkv,
                         int causal, float sm_scale, SegDrop sd,
                         cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = encode_tiles(&tq, q, D, H, Lq, B, FW_BM)) != cudaSuccess ||
      (err = encode_tiles(&tk, k, D, Hkv, Lk, B, FW_BN)) != cudaSuccess ||
      (err = encode_tiles(&tv, v, D, Hkv, Lk, B, FW_BN)) != cudaSuccess)
    return err;
  auto kern = flash_fwd_wgmma_kernel<D, LSE, SEGS, DROP>;
  const size_t smem = FwSmem<D>::bytes;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + FW_BM - 1) / FW_BM, B * H);
  kern<<<grid, FW_THREADS, smem, stream>>>(tq, tk, tv,
                                           static_cast<__nv_bfloat16*>(o), lse,
                                           Lq, Lk, H, Hkv, causal, sm_scale, sd);
  return cudaGetLastError();
}

template <typename T, int D, bool LSE, bool SEGS, bool DROP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Lq, int Lk, int H, int Hkv,
                   int causal, float sm_scale, SegDrop sd, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, D, LSE, SEGS, DROP>;
  const size_t smem = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + BM - 1) / BM, B * H);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Lq, Lk, H, Hkv,
      causal, sm_scale, sd);
  return cudaGetLastError();
}

template <bool LSE, bool SEGS = false, bool DROP = false>
cudaError_t fwd_dispatch(const void* q, const void* k, const void* v, void* o,
                         float* lse, int B, int Lq, int Lk, int H, int Hkv,
                         int D, int dtype, int causal, float sm_scale,
                         cudaStream_t s, SegDrop sd = {}) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || Hkv <= 0 || H % Hkv != 0)
    return cudaErrorInvalidValue;
  if (dtype == 0 && D == 128)
    return launch<float, 128, LSE, SEGS, DROP>(q, k, v, o, lse, B, Lq, Lk, H, Hkv, causal,
                                               sm_scale, sd, s);
  if (dtype == 0 && D == 64)
    return launch<float, 64, LSE, SEGS, DROP>(q, k, v, o, lse, B, Lq, Lk, H, Hkv, causal,
                                              sm_scale, sd, s);
  if (dtype == 1 && D == 128)
    return launch_wgmma<128, LSE, SEGS, DROP>(q, k, v, o, lse, B, Lq, Lk, H, Hkv, causal,
                                              sm_scale, sd, s);
  if (dtype == 1 && D == 64)
    return launch_wgmma<64, LSE, SEGS, DROP>(q, k, v, o, lse, B, Lq, Lk, H, Hkv, causal,
                                             sm_scale, sd, s);
  return cudaErrorInvalidValue;
}

// The variant instantiation that `sd` asks for: SEGS where it carries ids,
// SEGS and DROP where `drop` is set too. Dropout always carries ids (zeros
// where there is no mask), as _flash_core_drop runs it, so no DROP-only
// instantiation is built.
template <bool LSE>
cudaError_t fwd_dispatch_var(const void* q, const void* k, const void* v, void* o,
                             float* lse, int B, int Lq, int Lk, int H, int Hkv,
                             int D, int dtype, int causal, float sm_scale,
                             cudaStream_t s, SegDrop sd, int drop) {
  if ((sd.qseg == nullptr) != (sd.kseg == nullptr) || (drop && sd.qseg == nullptr))
    return cudaErrorInvalidValue;
  if (sd.qseg != nullptr && drop)
    return fwd_dispatch<LSE, true, true>(q, k, v, o, lse, B, Lq, Lk, H, Hkv, D, dtype,
                                         causal, sm_scale, s, sd);
  if (sd.qseg != nullptr)
    return fwd_dispatch<LSE, true, false>(q, k, v, o, lse, B, Lq, Lk, H, Hkv, D, dtype,
                                          causal, sm_scale, s, sd);
  return fwd_dispatch<LSE>(q, k, v, o, lse, B, Lq, Lk, H, Hkv, D, dtype, causal,
                           sm_scale, s);
}

// ---------------------------------------------------------------------------
// backward, float32: CUDA cores
// ---------------------------------------------------------------------------

template <int D>
struct BwdSmem {
  static constexpr int RS = D + 1;   // row stride of Q, dO, K, V tiles
  static constexpr int PS = BN + 1;  // row stride of the P / dS tiles
};

// dq for one (64-row Q tile, batch * head). Thread (ty, tx) owns query rows
// ty*4 + r, key columns tx + 16c of the score tile and dq columns tx + 16j.
template <int D, bool SEGS, bool DROP>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int Lq, int Lk, int H, int Hkv, int causal,
                    float sm_scale, SegDrop sd) {
  using S = BwdSmem<D>;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BM][RS]
  float* dOs = Qs + BM * S::RS;     // [BM][RS]
  float* Ks = dOs + BM * S::RS;     // [BN][RS]
  float* Vs = Ks + BN * S::RS;      // [BN][RS]
  float* dSs = Vs + BN * S::RS;     // [BM][PS]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, kvh = h / (H / Hkv);
  const int m0 = blockIdx.x * BM;
  const long q_stride = (long)H * D, kv_stride = (long)Hkv * D;
  const float* qb = q + ((long)b * Lq * H + h) * D;
  const float* dob = dout + ((long)b * Lq * H + h) * D;
  const float* kb = k + ((long)b * Lk * Hkv + kvh) * D;
  const float* vb = v + ((long)b * Lk * Hkv + kvh) * D;
  float* dqb = dq + ((long)b * Lq * H + h) * D;

  for (int idx = tid; idx < BM * D; idx += NT) {
    const int r = idx / D, d = idx % D, i = m0 + r;
    const bool in = i < Lq;
    Qs[r * S::RS + d] = in ? qb[(long)i * q_stride + d] : 0.f;
    dOs[r * S::RS + d] = in ? dob[(long)i * q_stride + d] : 0.f;
  }
  float lse_r[4], dl_r[4];
  int qs[4];  // SEGS: the segment ids of the thread's rows
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = m0 + ty * 4 + r;
    lse_r[r] = row < Lq ? lse[(long)bh * Lq + row] : LSE_MASKED;
    dl_r[r] = row < Lq ? delta[(long)bh * Lq + row] : 0.f;
    qs[r] = SEGS && row < Lq ? sd.qseg[(long)b * Lq + row] : 0;
  }
  const int* ks = SEGS ? sd.kseg + (long)b * Lk : nullptr;
  const uint32_t kbase = DROP ? keep_base(sd.seed, bh) : 0u;

  const int shift = Lk - Lq;
  int n_end = Lk;
  if (causal) n_end = min(Lk, max(0, m0 + BM + shift));

  float acc[4][DJ];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[r][j] = 0.f;

  for (int n0 = 0; n0 < n_end; n0 += BN) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BN * D; idx += NT) {
      const int r = idx / D, d = idx % D, j = n0 + r;
      const bool in = j < Lk;
      Ks[r * S::RS + d] = in ? kb[(long)j * kv_stride + d] : 0.f;
      Vs[r * S::RS + d] = in ? vb[(long)j * kv_stride + d] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], dov[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        qv[r] = Qs[(ty * 4 + r) * S::RS + d];
        dov[r] = dOs[(ty * 4 + r) * S::RS + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float kv = Ks[(tx + 16 * c) * S::RS + d];
        const float vv = Vs[(tx + 16 * c) * S::RS + d];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          s[r][c] = fmaf(qv[r], kv, s[r][c]);
          dp[r][c] = fmaf(dov[r], vv, dp[r][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = m0 + ty * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = n0 + tx + 16 * c;
        bool ok = row < Lq && col < Lk && (!causal || row + shift >= col);
        if (SEGS && ok) ok = ks[col] == qs[r];
        const float p = ok ? expf(s[r][c] * sm_scale - lse_r[r]) : 0.f;
        // dropout: dS = P (dP' - delta) with dP' the dropped, scaled dP
        const float dpv = !DROP ? dp[r][c]
                          : keep_elem(kbase, row, col, sd.keep_prob) ? dp[r][c] * sd.inv_keep
                                                                     : 0.f;
        dSs[(ty * 4 + r) * S::PS + tx + 16 * c] = p * (dpv - dl_r[r]) * sm_scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int n = 0; n < BN; ++n) {
      float ds[4], kv[DJ];
#pragma unroll
      for (int r = 0; r < 4; ++r) ds[r] = dSs[(ty * 4 + r) * S::PS + n];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = Ks[n * S::RS + tx + 16 * j];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[r][j] = fmaf(ds[r], kv[j], acc[r][j]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = m0 + ty * 4 + r;
    if (row >= Lq) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dqb[(long)row * q_stride + tx + 16 * j] = acc[r][j];
  }
}

// dk, dv for one (64-key K tile, batch * kv head). Thread (ty, tx) owns key
// rows ty*4 + r, query columns tx + 16c of the transposed score tile and
// dk/dv columns tx + 16j.
template <int D, bool SEGS, bool DROP>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int Lq, int Lk, int H, int Hkv,
                     int causal, float sm_scale, SegDrop sd) {
  using S = BwdSmem<D>;
  constexpr int DJ = D / 16;
  constexpr int BQ = BM;
  extern __shared__ float smem[];
  float* Ks = smem;                  // [BN][RS]
  float* Vs = Ks + BN * S::RS;       // [BN][RS]
  float* Qs = Vs + BN * S::RS;       // [BQ][RS]
  float* dOs = Qs + BQ * S::RS;      // [BQ][RS]
  float* Ps = dOs + BQ * S::RS;      // [BN][PS]  P^T
  float* dSs = Ps + BN * S::PS;      // [BN][PS]  dS^T
  float* lse_s = dSs + BN * S::PS;   // [BQ]
  float* dl_s = lse_s + BQ;          // [BQ]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bkv = blockIdx.y, b = bkv / Hkv, kvh = bkv % Hkv;
  const int rep = H / Hkv;
  const int k0 = blockIdx.x * BN;
  const long q_stride = (long)H * D, kv_stride = (long)Hkv * D;
  const float* kb = k + ((long)b * Lk * Hkv + kvh) * D;
  const float* vb = v + ((long)b * Lk * Hkv + kvh) * D;

  for (int idx = tid; idx < BN * D; idx += NT) {
    const int r = idx / D, d = idx % D, j = k0 + r;
    const bool in = j < Lk;
    Ks[r * S::RS + d] = in ? kb[(long)j * kv_stride + d] : 0.f;
    Vs[r * S::RS + d] = in ? vb[(long)j * kv_stride + d] : 0.f;
  }

  const int shift = Lk - Lq;
  const int q_begin = causal ? (max(0, k0 - shift) / BQ) * BQ : 0;

  float dk_acc[4][DJ], dv_acc[4][DJ];
  int kid[4];  // SEGS: the segment ids of the thread's keys
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[r][j] = dv_acc[r][j] = 0.f;
    const int key = k0 + ty * 4 + r;
    kid[r] = SEGS && key < Lk ? sd.kseg[(long)b * Lk + key] : 0;
  }
  const int* qsb = SEGS ? sd.qseg + (long)b * Lq : nullptr;

  for (int hq = kvh * rep; hq < kvh * rep + rep; ++hq) {
    // dropout is keyed on the query head: bh = b * H + hq
    const uint32_t kbase = DROP ? keep_base(sd.seed, b * H + hq) : 0u;
    const float* qb = q + ((long)b * Lq * H + hq) * D;
    const float* dob = dout + ((long)b * Lq * H + hq) * D;
    const float* lseb = lse + ((long)b * H + hq) * Lq;
    const float* dlb = delta + ((long)b * H + hq) * Lq;
    for (int q0 = q_begin; q0 < Lq; q0 += BQ) {
      __syncthreads();  // the previous tile's readers are done
      for (int idx = tid; idx < BQ * D; idx += NT) {
        const int r = idx / D, d = idx % D, i = q0 + r;
        const bool in = i < Lq;
        Qs[r * S::RS + d] = in ? qb[(long)i * q_stride + d] : 0.f;
        dOs[r * S::RS + d] = in ? dob[(long)i * q_stride + d] : 0.f;
      }
      for (int r = tid; r < BQ; r += NT) {
        const int i = q0 + r;
        lse_s[r] = i < Lq ? lseb[i] : LSE_MASKED;
        dl_s[r] = i < Lq ? dlb[i] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          kv[r] = Ks[(ty * 4 + r) * S::RS + d];
          vv[r] = Vs[(ty * 4 + r) * S::RS + d];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float qv = Qs[(tx + 16 * c) * S::RS + d];
          const float dov = dOs[(tx + 16 * c) * S::RS + d];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            s[r][c] = fmaf(kv[r], qv, s[r][c]);
            dp[r][c] = fmaf(vv[r], dov, dp[r][c]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int key = k0 + ty * 4 + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qc = tx + 16 * c, row = q0 + qc;
          bool ok = row < Lq && key < Lk && (!causal || row + shift >= key);
          if (SEGS && ok) ok = qsb[row] == kid[r];
          const float p = ok ? expf(s[r][c] * sm_scale - lse_s[qc]) : 0.f;
          // dropout: dv takes the dropped P, dS the dropped dP
          const bool keep = !DROP || keep_elem(kbase, row, key, sd.keep_prob);
          Ps[(ty * 4 + r) * S::PS + qc] = !DROP ? p : keep ? p * sd.inv_keep : 0.f;
          const float dpv = !DROP ? dp[r][c] : keep ? dp[r][c] * sd.inv_keep : 0.f;
          dSs[(ty * 4 + r) * S::PS + qc] = p * (dpv - dl_s[qc]) * sm_scale;
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int n = 0; n < BQ; ++n) {
        float p[4], ds[4], qv[DJ], dov[DJ];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          p[r] = Ps[(ty * 4 + r) * S::PS + n];
          ds[r] = dSs[(ty * 4 + r) * S::PS + n];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          qv[j] = Qs[n * S::RS + tx + 16 * j];
          dov[j] = dOs[n * S::RS + tx + 16 * j];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            dv_acc[r][j] = fmaf(p[r], dov[j], dv_acc[r][j]);
            dk_acc[r][j] = fmaf(ds[r], qv[j], dk_acc[r][j]);
          }
      }
    }
  }

  float* dkb = dk + ((long)b * Lk * Hkv + kvh) * D;
  float* dvb = dv + ((long)b * Lk * Hkv + kvh) * D;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = k0 + ty * 4 + r;
    if (key >= Lk) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dkb[(long)key * kv_stride + tx + 16 * j] = dk_acc[r][j];
      dvb[(long)key * kv_stride + tx + 16 * j] = dv_acc[r][j];
    }
  }
}

template <int D>
constexpr size_t bwd_dq_smem() {
  return (size_t)(2 * BM * BwdSmem<D>::RS + 2 * BN * BwdSmem<D>::RS +
                  BM * BwdSmem<D>::PS) * sizeof(float);
}

template <int D>
constexpr size_t bwd_dkv_smem() {
  return (size_t)(2 * BN * BwdSmem<D>::RS + 2 * BM * BwdSmem<D>::RS +
                  2 * BN * BwdSmem<D>::PS + 2 * BM) * sizeof(float);
}

// ---------------------------------------------------------------------------
// backward, bfloat16: TMA-fed, warp-specialised wgmma
// ---------------------------------------------------------------------------

constexpr int BW_BM = 128;    // rows a block owns: queries (dq), keys (dk/dv)
constexpr int BW_BN = 64;     // rows of a streamed tile: keys (dq), queries (dk/dv)
constexpr int BW_STAGES = 4;  // ring depth

// dq: the Q and dO tiles (BW_BM rows each), then per stage the K tile and
// the V tile (BW_BN rows each), every tile as D/64 boxes of 64 columns;
// then the mbarriers.
template <int D>
struct DqSmem {
  static constexpr uint32_t QBOX = BW_BM * SW_ROW;
  static constexpr uint32_t KVBOX = BW_BN * SW_ROW;
  static constexpr uint32_t Q = QBOX * (D / 64);
  static constexpr uint32_t KV = KVBOX * (D / 64);
  static constexpr uint32_t RING = 2 * Q;
  static constexpr uint32_t BARS = RING + BW_STAGES * 2 * KV;
  // mbarriers: q_full, then per stage full, empty
  static constexpr size_t bytes = BARS + 8 * (1 + 2 * BW_STAGES) + 1024;  // + alignment
};

// dk/dv: the K and V tiles (BW_BM rows each), then per stage the Q tile and
// the dO tile (BW_BN rows each), then per stage the tile's BW_BN lse values
// (times log2 e) and BW_BN delta values, then the mbarriers.
template <int D>
struct DkvSmem {
  static constexpr uint32_t KBOX = BW_BM * SW_ROW;
  static constexpr uint32_t QBOX = BW_BN * SW_ROW;
  static constexpr uint32_t K = KBOX * (D / 64);
  static constexpr uint32_t Q = QBOX * (D / 64);
  static constexpr uint32_t RING = 2 * K;
  static constexpr uint32_t ROWS = RING + BW_STAGES * 2 * Q;
  static constexpr uint32_t BARS = ROWS + BW_STAGES * 2 * BW_BN * sizeof(float);
  // mbarriers: kv_full, then per stage full, empty
  static constexpr size_t bytes = BARS + 8 * (1 + 2 * BW_STAGES) + 1024;  // + alignment
};

// dS = P (dP - delta) of one 64 x 64 tile of a warpgroup's rows (dq), from
// its scores s and dP in the accumulator layout, packed as the A fragments
// of dq += dS K. P = exp2(s scale log2e - lse log2e); a key is masked for a
// row at or past min(Lk, the row's causal end), and a tile wholly before
// `wg_end` (the smallest causal end of the warpgroup's rows) is not masked.
// The variants as in softmax_tile: with SEGS every tile is masked by the
// ids; with DROP dS = P (dP' - delta), dP' the dropped, scaled dP.
template <bool SEGS, bool DROP>
__device__ __forceinline__ void dq_tile_ds(float (&s)[BW_BN / 2],
                                           const float (&dp)[BW_BN / 2],
                                           uint32_t (&ds)[BW_BN / 16][4], int n0,
                                           int Lk, int wg_end, int end0, int end1,
                                           int t, float scale_log2,
                                           const float (&lse2)[2],
                                           const float (&dl)[2], const RowVar& rv) {
  if (SEGS) {  // every tile: a key of another segment is masked
#pragma unroll
    for (int j = 0; j < BW_BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + j * 8 + t * 2 + e;
        const int kid = col < Lk ? rv.ks[col] : 0;  // past Lk: masked below
        if (kid != rv.qs0) s[j * 4 + e] = -INFINITY;
        if (kid != rv.qs1) s[j * 4 + 2 + e] = -INFINITY;
      }
  }
  if (n0 + BW_BN > min(Lk, wg_end)) {
    const int lim0 = min(Lk, end0), lim1 = min(Lk, end1);
#pragma unroll
    for (int j = 0; j < BW_BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + j * 8 + t * 2 + e;
        if (col >= lim0) s[j * 4 + e] = -INFINITY;
        if (col >= lim1) s[j * 4 + 2 + e] = -INFINITY;
      }
  }
  // rows: the thread's first (elements 4j, 4j+1) and second (4j+2, 4j+3)
#pragma unroll
  for (int i = 0; i < BW_BN / 2; i += 4)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float dp0 = dp[i + e], dp1 = dp[i + 2 + e];
      if (DROP) {
        const int col = n0 + (i / 4) * 8 + t * 2 + e;
        dp0 = keep_elem(rv.kbase, rv.r0, col, rv.keep_prob) ? dp0 * rv.inv_keep : 0.f;
        dp1 = keep_elem(rv.kbase, rv.r1, col, rv.keep_prob) ? dp1 * rv.inv_keep : 0.f;
      }
      s[i + e] = fast_exp2(fmaf(s[i + e], scale_log2, -lse2[0])) * (dp0 - dl[0]);
      s[i + 2 + e] = fast_exp2(fmaf(s[i + 2 + e], scale_log2, -lse2[1])) * (dp1 - dl[1]);
    }
  pack_frags(ds, s);
}

// B3: dq, the port of _flash_bwd_dq_kernel (paddle_tpu/ops/flash_attention.py:228).
// What bounds it on an H100: three products (S, dP, dq) of 2 * 64 * 64 * D
// operations for each 64 x 64 (query, key) tile against Q, dO and dq moved
// once and K, V once per Q tile (from L2): at L = 4096, D = 128 the
// tensor-core rate (989 TFLOP/s bf16) bounds it. The design keeps the tensor
// cores fed, as the forward does:
// * One block per (128 query rows, batch * head): consumer warpgroups 0 and
//   1 own 64 rows each; one warp of warpgroup 2 (the producer) loads the Q
//   and dO tiles once and streams 64-key K and V tiles through a ring of
//   BW_STAGES stages by TMA (4-D maps, so rows past L read as zeros); a
//   `full` mbarrier per stage counts the bytes in, an `empty` one the 256
//   consumer threads out once the stage's last product (dq += dS K) is done.
// * S = Q K^T and dP = dO V^T are wgmma m64n64k16 with both operands in
//   shared memory, K-major, read as they land. P = exp2(S scale log2e - lse
//   log2e) with lse log2e formed once per row; dS = P (dP - delta) is
//   re-packed in registers as bf16 A fragments, and dq += dS K is wgmma
//   m64nDk16 with K read N-major through the transpose flag (as the forward
//   reads V): K is never transposed.
// * Within a warpgroup, tile i's S and dP are issued together with tile
//   i-1's dq product, and tile i's dS is formed while that product is on
//   the tensor cores; the two warpgroups also fill each other's gaps.
// * Only tiles that cross the causal diagonal of the warpgroup's rows or the
//   end of Lk are masked; K tiles past the block's diagonal are never
//   loaded. sm_scale multiplies dq once, at the store. Causal Q tiles run
//   heaviest first.
// * setmaxnreg gives the consumers 240 registers and the producer 24: at
//   D = 128 S and dP take 32 fp32 each, dq 64, the dS fragments 16 for each
//   of the two tiles in flight.
template <int D, bool SEGS, bool DROP>
__global__ void __launch_bounds__(FW_THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int Lq, int Lk, int H,
                          int Hkv, int causal, float sm_scale, SegDrop sd) {
  using S = DqSmem<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms: 1024
  const uint32_t sdo = sq + S::Q;
  const uint32_t bar_q = sq + S::BARS;
  // stage s: the K tile, then the V tile; its barriers after q_full
  auto k_tile = [&](int s) { return sq + S::RING + (uint32_t)s * 2 * S::KV; };
  auto bar_full = [&](int s) { return bar_q + 8u * (1 + 2 * s); };
  auto bar_empty = [&](int s) { return bar_q + 8u * (2 + 2 * s); };

  const int bh = blockIdx.y, b = bh / H, h = bh % H, kvh = h / (H / Hkv);
  // causal: heaviest Q tile first
  const int m0 = (int)(causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * BW_BM;
  const int shift = Lk - Lq;  // bottom-right causal alignment
  const int n_end = causal ? min(Lk, max(0, m0 + BW_BM + shift)) : Lk;
  const int n_tiles = (n_end + BW_BN - 1) / BW_BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < BW_STAGES; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), FW_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= FW_CONSUMERS / 32) {
    // producer warpgroup: one thread starts every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == FW_CONSUMERS / 32 && lane == 0 && n_tiles > 0) {
      mbar_expect_tx(bar_q, 2 * S::Q);
      for (int c = 0; c < D / 64; ++c) {
        tma_load(sq + c * S::QBOX, &tm_q, bar_q, c * 64, h, m0, b);
        tma_load(sdo + c * S::QBOX, &tm_do, bar_q, c * 64, h, m0, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % BW_STAGES;
        const uint32_t kt = k_tile(s), vt = kt + S::KV;
        mbar_wait(bar_empty(s), ((it / BW_STAGES) & 1) ^ 1);  // first pass: free
        mbar_expect_tx(bar_full(s), 2 * S::KV);
        for (int c = 0; c < D / 64; ++c) {
          tma_load(kt + c * S::KVBOX, &tm_k, bar_full(s), c * 64, kvh, it * BW_BN, b);
          tma_load(vt + c * S::KVBOX, &tm_v, bar_full(s), c * 64, kvh, it * BW_BN, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = warp / 4, t = lane % 4;
    const int row_lo = m0 + wg * 64;                             // the warpgroup's
    const int r0 = row_lo + (warp % 4) * 16 + lane / 4, r1 = r0 + 8;  // the thread's
    // causal end of a row: keys at or past it are masked
    const int wg_end = causal ? row_lo + shift + 1 : Lk;
    const int end0 = causal ? r0 + shift + 1 : Lk, end1 = causal ? r1 + shift + 1 : Lk;
    const float scale_log2 = sm_scale * LOG2E;
    // rows past Lq take the lse of a row that sees no key: their P is 0
    const float lse2[2] = {(r0 < Lq ? lse[(long)bh * Lq + r0] : LSE_MASKED) * LOG2E,
                           (r1 < Lq ? lse[(long)bh * Lq + r1] : LSE_MASKED) * LOG2E};
    const float dl[2] = {r0 < Lq ? delta[(long)bh * Lq + r0] : 0.f,
                         r1 < Lq ? delta[(long)bh * Lq + r1] : 0.f};
    const uint32_t q_rows = sq + wg * 64 * SW_ROW, do_rows = sdo + wg * 64 * SW_ROW;
    RowVar rv{};
    if (SEGS) {
      rv.ks = sd.kseg + (long)b * Lk;
      rv.qs0 = r0 < Lq ? sd.qseg[(long)b * Lq + r0] : 0;
      rv.qs1 = r1 < Lq ? sd.qseg[(long)b * Lq + r1] : 0;
    }
    if (DROP) {
      rv.r0 = r0;
      rv.r1 = r1;
      rv.kbase = keep_base(sd.seed, bh);
      rv.keep_prob = sd.keep_prob;
      rv.inv_keep = sd.inv_keep;
    }

    float dqacc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqacc[i] = 0.f;
    float sacc[BW_BN / 2], pacc[BW_BN / 2];
#pragma unroll
    for (int i = 0; i < BW_BN / 2; ++i) sacc[i] = pacc[i] = 0.f;
    uint32_t ds[BW_BN / 16][4];

    if (n_tiles > 0) {
      mbar_wait(bar_q, 0);
      mbar_wait(bar_full(0), 0);
      fence_regs(sacc);
      fence_regs(pacc);
      wgmma_fence();
      mma_ss<D, S::QBOX, S::KVBOX>(sacc, q_rows, k_tile(0));
      mma_ss<D, S::QBOX, S::KVBOX>(pacc, do_rows, k_tile(0) + S::KV);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
      fence_regs(pacc);
      dq_tile_ds<SEGS, DROP>(sacc, pacc, ds, 0, Lk, wg_end, end0, end1, t, scale_log2,
                             lse2, dl, rv);
    }
    for (int it = 1; it < n_tiles; ++it) {
      const int s = it % BW_STAGES, sp = (it - 1) % BW_STAGES;
      mbar_wait(bar_full(s), (it / BW_STAGES) & 1);
      fence_regs(sacc);
      fence_regs(pacc);
      fence_regs(dqacc);
      fence_regs(ds);
      wgmma_fence();
      mma_ss<D, S::QBOX, S::KVBOX>(sacc, q_rows, k_tile(s));
      mma_ss<D, S::QBOX, S::KVBOX>(pacc, do_rows, k_tile(s) + S::KV);
      wgmma_commit();
      mma_rs<S::KVBOX>(dqacc, ds, k_tile(sp));
      wgmma_commit();
      wgmma_wait<1>();  // S and dP of this tile are in
      fence_regs(sacc);
      fence_regs(pacc);
      uint32_t ds_next[BW_BN / 16][4];
      dq_tile_ds<SEGS, DROP>(sacc, pacc, ds_next, it * BW_BN, Lk, wg_end, end0, end1,
                             t, scale_log2, lse2, dl, rv);
      wgmma_wait<0>();  // dq of the previous tile is in
      fence_regs(dqacc);
      fence_regs(ds);   // dS stays in its registers until then
      mbar_arrive(bar_empty(sp));
#pragma unroll
      for (int kk = 0; kk < BW_BN / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[kk][e] = ds_next[kk][e];
    }
    if (n_tiles > 0) {
      const int sp = (n_tiles - 1) % BW_STAGES;
      fence_regs(dqacc);
      fence_regs(ds);
      wgmma_fence();
      mma_rs<S::KVBOX>(dqacc, ds, k_tile(sp));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dqacc);
      fence_regs(ds);
      mbar_arrive(bar_empty(sp));
    }

    const long q_stride = (long)H * D;
    __nv_bfloat16* dqb = dq + ((long)b * Lq * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + t * 2;
      if (r0 < Lq)
        *reinterpret_cast<uint32_t*>(dqb + (long)r0 * q_stride + col) =
            pack_bf16(dqacc[j * 4] * sm_scale, dqacc[j * 4 + 1] * sm_scale);
      if (r1 < Lq)
        *reinterpret_cast<uint32_t*>(dqb + (long)r1 * q_stride + col) =
            pack_bf16(dqacc[j * 4 + 2] * sm_scale, dqacc[j * 4 + 3] * sm_scale);
    }
  }
}

// P^T = exp2(S^T scale log2e - lse log2e) of one 64-key x 64-query tile of a
// warpgroup's keys (dk/dv), in place of the scores in the accumulator
// layout: rows are the thread's keys k0 and k1, columns the tile's queries,
// whose lse log2e lie in `lse2`. With `masked`, a (key, query) pair is 0
// where the query is past Lq or, causal, does not see the key. With SEGS
// every tile is masked, a pair also where the query's id qs[q] differs from
// the key's (kid0, kid1).
template <bool SEGS>
__device__ __forceinline__ void dkv_tile_p(float (&s)[BW_BN / 2],
                                           const float* lse2, bool masked,
                                           int q0, int Lq, int k0, int k1,
                                           int shift, int causal, int t,
                                           float scale_log2, const int* qs,
                                           int kid0, int kid1) {
#pragma unroll
  for (int j = 0; j < BW_BN / 8; ++j) {
    const int col = j * 8 + t * 2;
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + col);
    s[j * 4] = fast_exp2(fmaf(s[j * 4], scale_log2, -l2.x));
    s[j * 4 + 1] = fast_exp2(fmaf(s[j * 4 + 1], scale_log2, -l2.y));
    s[j * 4 + 2] = fast_exp2(fmaf(s[j * 4 + 2], scale_log2, -l2.x));
    s[j * 4 + 3] = fast_exp2(fmaf(s[j * 4 + 3], scale_log2, -l2.y));
    if (SEGS || masked) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = q0 + col + e;
        const int qid = SEGS && q < Lq ? qs[q] : 0;
        if (q >= Lq || (causal && q + shift < k0) || (SEGS && qid != kid0)) s[j * 4 + e] = 0.f;
        if (q >= Lq || (causal && q + shift < k1) || (SEGS && qid != kid1))
          s[j * 4 + 2 + e] = 0.f;
      }
    }
  }
}

// DROP in dk/dv: the keep bits of one 64-key x 64-query tile in the
// accumulator layout (bit i for element i: rows the thread's keys k0, k1,
// columns the tile's queries), from B0 keyed (query, key).
__device__ __forceinline__ uint32_t dkv_keep_bits(uint32_t kbase, int q0, int k0,
                                                  int k1, int t, float keep_prob) {
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < BW_BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = q0 + j * 8 + t * 2 + e;
      bits |= (uint32_t)keep_elem(kbase, q, k0, keep_prob) << (j * 4 + e);
      bits |= (uint32_t)keep_elem(kbase, q, k1, keep_prob) << (j * 4 + 2 + e);
    }
  return bits;
}

// pack_frags of the kept elements of s, scaled by inv; the dropped ones 0.
template <int KS>
__device__ __forceinline__ void pack_frags_kept(uint32_t (&a)[KS][4],
                                                const float (&s)[KS * 8],
                                                uint32_t keep, float inv) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 8 * kk + 2 * e;
      a[kk][e] = pack_bf16((keep >> i) & 1u ? s[i] * inv : 0.f,
                           (keep >> (i + 1)) & 1u ? s[i + 1] * inv : 0.f);
    }
}

// dS^T = P^T (dP^T - delta) of the same tile, in place of dP^T.
__device__ __forceinline__ void dkv_tile_ds(float (&dp)[BW_BN / 2],
                                            const float (&p)[BW_BN / 2],
                                            const float* dl, int t) {
#pragma unroll
  for (int j = 0; j < BW_BN / 8; ++j) {
    const float2 d = *reinterpret_cast<const float2*>(dl + j * 8 + t * 2);
    dp[j * 4] = p[j * 4] * (dp[j * 4] - d.x);
    dp[j * 4 + 1] = p[j * 4 + 1] * (dp[j * 4 + 1] - d.y);
    dp[j * 4 + 2] = p[j * 4 + 2] * (dp[j * 4 + 2] - d.x);
    dp[j * 4 + 3] = p[j * 4 + 3] * (dp[j * 4 + 3] - d.y);
  }
}

// B4: dk and dv, the port of _flash_bwd_dkv_kernel
// (paddle_tpu/ops/flash_attention.py:288). What bounds it on an H100: four
// products (S^T, dP^T, dv, dk) of 2 * 64 * 64 * D operations for each 64 x
// 64 (key, query) tile against K, V, dk and dv moved once and Q, dO, lse
// and delta once per K tile (from L2): the tensor-core rate bounds it. The
// design:
// * One block per (128 keys, batch * kv head): consumer warpgroups 0 and 1
//   own 64 keys each and keep their dk and dv in fp32 registers across the
//   whole GQA group (64 + 64 a thread at D = 128; the group's sum is taken
//   there, without atomics). One warp of warpgroup 2 (the producer) loads
//   the K and V tiles once by TMA, then streams 64-query Q and dO tiles of
//   each query head of the group through a ring of BW_STAGES stages, from
//   the first Q tile that can see the block. Its 32 lanes put each tile's
//   64 lse (times log2 e, formed once per row) and delta values beside it
//   by plain loads: the (B, H, Lq) fp32 rows start Lq * 4 bytes apart,
//   which TMA (strides in multiples of 16 bytes) cannot take for every Lq.
//   The stage's `full` mbarrier counts the TMA bytes and the 32 lanes.
// * S^T = K Q^T and dP^T = V dO^T are wgmma m64n64k16 with both operands in
//   shared memory. Their accumulators come out key-row-major, so P^T and
//   dS^T are already the A fragments of dv += P^T dO and dk += dS^T Q
//   (wgmma m64nDk16, dO and Q read N-major through the transpose flag):
//   nothing is transposed. dv's product is issued before dS^T is formed,
//   so the two overlap; the two warpgroups fill each other's gaps.
// * Only tiles that cross the causal diagonal or the end of Lq are masked
//   (rows past Lq also get lse 1e30 from the producer, so nothing rests on
//   a zero-filled row); a warpgroup skips a tile that no query of which
//   sees its keys. sm_scale multiplies dk once, at the store. Key blocks
//   run in order of k0, so causal blocks with the most Q tiles start first.
// * setmaxnreg gives the consumers 240 registers and the producer 24.
template <int D, bool SEGS, bool DROP>
__global__ void __launch_bounds__(FW_THREADS, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int Lq, int Lk, int H,
                           int Hkv, int causal, float sm_scale, SegDrop sd) {
  using S = DkvSmem<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sk = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms: 1024
  unsigned char* base = smem_raw + (sk - smem_u32(smem_raw));
  const uint32_t sv = sk + S::K;
  const uint32_t bar_kv = sk + S::BARS;
  // stage s: the Q tile, then the dO tile; its lse and delta rows; its
  // barriers after kv_full
  auto q_tile = [&](int s) { return sk + S::RING + (uint32_t)s * 2 * S::Q; };
  auto rows = [&](int s) {
    return reinterpret_cast<float*>(base + S::ROWS) + s * 2 * BW_BN;
  };
  auto bar_full = [&](int s) { return bar_kv + 8u * (1 + 2 * s); };
  auto bar_empty = [&](int s) { return bar_kv + 8u * (2 + 2 * s); };

  const int bkv = blockIdx.y, b = bkv / Hkv, kvh = bkv % Hkv, rep = H / Hkv;
  const int k0 = blockIdx.x * BW_BM;
  const int shift = Lk - Lq;  // query i sees key j <= i + shift
  // the first Q tile that can see the block, and the Q tiles of one head
  const int q_begin = causal ? (max(0, k0 - shift) / BW_BN) * BW_BN : 0;
  const int nq = (Lq - q_begin + BW_BN - 1) / BW_BN;
  const int n_iters = rep * nq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < BW_STAGES; ++s) {
      mbar_init(bar_full(s), 1 + 32);  // the TMA's thread, then the 32 lanes
      mbar_init(bar_empty(s), FW_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= FW_CONSUMERS / 32) {
    // producer warpgroup: lane 0 of its first warp starts every copy, the
    // warp's 32 lanes load lse and delta
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == FW_CONSUMERS / 32) {
      if (lane == 0) {
        mbar_expect_tx(bar_kv, 2 * S::K);
        for (int c = 0; c < D / 64; ++c) {
          tma_load(sk + c * S::KBOX, &tm_k, bar_kv, c * 64, kvh, k0, b);
          tma_load(sv + c * S::KBOX, &tm_v, bar_kv, c * 64, kvh, k0, b);
        }
      }
      for (int it = 0; it < n_iters; ++it) {
        const int s = it % BW_STAGES;
        const int hq = kvh * rep + it / nq, q0 = q_begin + (it % nq) * BW_BN;
        mbar_wait(bar_empty(s), ((it / BW_STAGES) & 1) ^ 1);  // first pass: free
        if (lane == 0) {
          const uint32_t qt = q_tile(s);
          mbar_expect_tx(bar_full(s), 2 * S::Q);
          for (int c = 0; c < D / 64; ++c) {
            tma_load(qt + c * S::QBOX, &tm_q, bar_full(s), c * 64, hq, q0, b);
            tma_load(qt + S::Q + c * S::QBOX, &tm_do, bar_full(s), c * 64, hq, q0, b);
          }
        }
        float* r = rows(s);
        const long row0 = ((long)b * H + hq) * Lq;
        for (int i = lane; i < BW_BN; i += 32) {
          const int qi = q0 + i;
          r[i] = (qi < Lq ? lse[row0 + qi] : LSE_MASKED) * LOG2E;
          r[BW_BN + i] = qi < Lq ? delta[row0 + qi] : 0.f;
        }
        mbar_arrive(bar_full(s));
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = warp / 4, t = lane % 4;
    const int kw = k0 + wg * 64;                                     // the warpgroup's
    const int kr0 = kw + (warp % 4) * 16 + lane / 4, kr1 = kr0 + 8;  // the thread's
    const float scale_log2 = sm_scale * LOG2E;
    const uint32_t k_rows = sk + wg * 64 * SW_ROW, v_rows = sv + wg * 64 * SW_ROW;
    const int* qs = SEGS ? sd.qseg + (long)b * Lq : nullptr;
    const int kid0 = SEGS && kr0 < Lk ? sd.kseg[(long)b * Lk + kr0] : 0;
    const int kid1 = SEGS && kr1 < Lk ? sd.kseg[(long)b * Lk + kr1] : 0;

    float dkacc[D / 2], dvacc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dkacc[i] = dvacc[i] = 0.f;
    float sacc[BW_BN / 2], pacc[BW_BN / 2];
#pragma unroll
    for (int i = 0; i < BW_BN / 2; ++i) sacc[i] = pacc[i] = 0.f;

    mbar_wait(bar_kv, 0);
    for (int it = 0; it < n_iters; ++it) {
      const int s = it % BW_STAGES;
      const int q0 = q_begin + (it % nq) * BW_BN;
      mbar_wait(bar_full(s), (it / BW_STAGES) & 1);
      // no query of the tile sees a key of the warpgroup
      if (causal && q0 + BW_BN - 1 + shift < kw) {
        mbar_arrive(bar_empty(s));
        continue;
      }
      const uint32_t qt = q_tile(s), dot = qt + S::Q;
      const float* r = rows(s);
      fence_regs(sacc);
      fence_regs(pacc);
      wgmma_fence();
      mma_ss<D, S::KBOX, S::QBOX>(sacc, k_rows, qt);
      mma_ss<D, S::KBOX, S::QBOX>(pacc, v_rows, dot);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
      fence_regs(pacc);
      const bool masked = q0 + BW_BN > Lq || (causal && q0 + shift < kw + 63);
      dkv_tile_p<SEGS>(sacc, r, masked, q0, Lq, kr0, kr1, shift, causal, t, scale_log2,
                       qs, kid0, kid1);
      uint32_t pa[BW_BN / 16][4], da[BW_BN / 16][4];
      if (DROP) {
        int bh = b * H + kvh * rep + it / nq;  // keyed on the tile's query head
        const uint32_t keep = dkv_keep_bits(keep_base(sd.seed, bh), q0, kr0, kr1, t,
                                            sd.keep_prob);
        pack_frags_kept(pa, sacc, keep, sd.inv_keep);  // dv takes the dropped P
#pragma unroll
        for (int i = 0; i < BW_BN / 2; ++i)  // dS the dropped dP
          pacc[i] = (keep >> i) & 1u ? pacc[i] * sd.inv_keep : 0.f;
      } else {
        pack_frags(pa, sacc);
      }
      fence_regs(dvacc);
      fence_regs(pa);
      wgmma_fence();
      mma_rs<S::QBOX>(dvacc, pa, dot);
      wgmma_commit();
      dkv_tile_ds(pacc, sacc, r + BW_BN, t);  // under dv's product
      pack_frags(da, pacc);
      fence_regs(dkacc);
      fence_regs(da);
      wgmma_fence();
      mma_rs<S::QBOX>(dkacc, da, qt);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dvacc);
      fence_regs(dkacc);
      fence_regs(pa);  // the fragments stay in their registers until then
      fence_regs(da);
      mbar_arrive(bar_empty(s));
    }

    const long kv_stride = (long)Hkv * D;
    __nv_bfloat16* dkb = dk + ((long)b * Lk * Hkv + kvh) * D;
    __nv_bfloat16* dvb = dv + ((long)b * Lk * Hkv + kvh) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + t * 2;
      if (kr0 < Lk) {
        *reinterpret_cast<uint32_t*>(dkb + (long)kr0 * kv_stride + col) =
            pack_bf16(dkacc[j * 4] * sm_scale, dkacc[j * 4 + 1] * sm_scale);
        *reinterpret_cast<uint32_t*>(dvb + (long)kr0 * kv_stride + col) =
            pack_bf16(dvacc[j * 4], dvacc[j * 4 + 1]);
      }
      if (kr1 < Lk) {
        *reinterpret_cast<uint32_t*>(dkb + (long)kr1 * kv_stride + col) =
            pack_bf16(dkacc[j * 4 + 2] * sm_scale, dkacc[j * 4 + 3] * sm_scale);
        *reinterpret_cast<uint32_t*>(dvb + (long)kr1 * kv_stride + col) =
            pack_bf16(dvacc[j * 4 + 2], dvacc[j * 4 + 3]);
      }
    }
  }
}

template <typename K>
cudaError_t set_smem(K kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// DKV = false: dq into out0. DKV = true: dk into out0, dv into out1.
template <bool DKV, int D, bool SEGS, bool DROP>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* out0, void* out1, int B, int Lq, int Lk, int H,
                       int Hkv, int dtype, int causal, float sm_scale,
                       SegDrop sd, cudaStream_t st) {
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaError_t err;
  if (dtype == 0) {
    const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
                *vf = static_cast<const float*>(v), *df = static_cast<const float*>(dout);
    if (!DKV) {
      auto kern = flash_bwd_dq_kernel<D, SEGS, DROP>;
      if ((err = set_smem(kern, bwd_dq_smem<D>())) != cudaSuccess) return err;
      kern<<<dim3((Lq + BM - 1) / BM, B * H), NT, bwd_dq_smem<D>(), st>>>(
          qf, kf, vf, df, ls, dl, static_cast<float*>(out0), Lq, Lk, H, Hkv,
          causal, sm_scale, sd);
    } else {
      auto kern = flash_bwd_dkv_kernel<D, SEGS, DROP>;
      if ((err = set_smem(kern, bwd_dkv_smem<D>())) != cudaSuccess) return err;
      kern<<<dim3((Lk + BN - 1) / BN, B * Hkv), NT, bwd_dkv_smem<D>(), st>>>(
          qf, kf, vf, df, ls, dl, static_cast<float*>(out0),
          static_cast<float*>(out1), Lq, Lk, H, Hkv, causal, sm_scale, sd);
    }
    return cudaGetLastError();
  }
  // bf16: tensor maps of q and dO with tiles of the rows a dq block owns or
  // a dk/dv block streams, and of k and v the other way round
  CUtensorMap tq, tk, tv, tdo;
  const int q_rows = DKV ? BW_BN : BW_BM, kv_rows = DKV ? BW_BM : BW_BN;
  if ((err = encode_tiles(&tq, q, D, H, Lq, B, q_rows)) != cudaSuccess ||
      (err = encode_tiles(&tdo, dout, D, H, Lq, B, q_rows)) != cudaSuccess ||
      (err = encode_tiles(&tk, k, D, Hkv, Lk, B, kv_rows)) != cudaSuccess ||
      (err = encode_tiles(&tv, v, D, Hkv, Lk, B, kv_rows)) != cudaSuccess)
    return err;
  using bf = __nv_bfloat16;
  if (!DKV) {
    auto kern = flash_bwd_dq_wgmma_kernel<D, SEGS, DROP>;
    const size_t smem = DqSmem<D>::bytes;
    if ((err = set_smem(kern, smem)) != cudaSuccess) return err;
    kern<<<dim3((Lq + BW_BM - 1) / BW_BM, B * H), FW_THREADS, smem, st>>>(
        tq, tk, tv, tdo, ls, dl, static_cast<bf*>(out0), Lq, Lk, H, Hkv, causal,
        sm_scale, sd);
  } else {
    auto kern = flash_bwd_dkv_wgmma_kernel<D, SEGS, DROP>;
    const size_t smem = DkvSmem<D>::bytes;
    if ((err = set_smem(kern, smem)) != cudaSuccess) return err;
    kern<<<dim3((Lk + BW_BM - 1) / BW_BM, B * Hkv), FW_THREADS, smem, st>>>(
        tq, tk, tv, tdo, ls, dl, static_cast<bf*>(out0), static_cast<bf*>(out1),
        Lq, Lk, H, Hkv, causal, sm_scale, sd);
  }
  return cudaGetLastError();
}

template <bool DKV, bool SEGS = false, bool DROP = false>
cudaError_t bwd_dispatch(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* out0, void* out1, int B, int Lq, int Lk, int H,
                         int Hkv, int D, int dtype, int causal, float sm_scale,
                         cudaStream_t s, SegDrop sd = {}) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  if (D == 128)
    return launch_bwd<DKV, 128, SEGS, DROP>(q, k, v, dout, lse, delta, out0, out1, B, Lq,
                                            Lk, H, Hkv, dtype, causal, sm_scale, sd, s);
  if (D == 64)
    return launch_bwd<DKV, 64, SEGS, DROP>(q, k, v, dout, lse, delta, out0, out1, B, Lq,
                                           Lk, H, Hkv, dtype, causal, sm_scale, sd, s);
  return cudaErrorInvalidValue;
}

// The variant instantiation that `sd` and `drop` ask for (fwd_dispatch_var).
template <bool DKV>
cudaError_t bwd_dispatch_var(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, const void* delta,
                             void* out0, void* out1, int B, int Lq, int Lk, int H,
                             int Hkv, int D, int dtype, int causal, float sm_scale,
                             cudaStream_t s, SegDrop sd, int drop) {
  if ((sd.qseg == nullptr) != (sd.kseg == nullptr) || (drop && sd.qseg == nullptr))
    return cudaErrorInvalidValue;
  if (sd.qseg != nullptr && drop)
    return bwd_dispatch<DKV, true, true>(q, k, v, dout, lse, delta, out0, out1, B, Lq,
                                         Lk, H, Hkv, D, dtype, causal, sm_scale, s, sd);
  if (sd.qseg != nullptr)
    return bwd_dispatch<DKV, true, false>(q, k, v, dout, lse, delta, out0, out1, B, Lq,
                                          Lk, H, Hkv, D, dtype, causal, sm_scale, s, sd);
  return bwd_dispatch<DKV>(q, k, v, dout, lse, delta, out0, out1, B, Lq, Lk, H, Hkv, D,
                           dtype, causal, sm_scale, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each entry point returns a cudaError_t
// (0 on success). q/dout/dq (B, Lq, H, D); k/v/dk/dv (B, Lk, Hkv, D);
// lse/delta (B, H, Lq) fp32.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         int B, int Lq, int Lk, int H, int Hkv, int D,
                         int dtype, int causal, float sm_scale, void* stream) {
  return (int)fwd_dispatch<false>(q, k, v, o, nullptr, B, Lq, Lk, H, Hkv, D,
                                  dtype, causal, sm_scale,
                                  static_cast<cudaStream_t>(stream));
}

extern "C" int flash_fwd_lse(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int Lq, int Lk, int H,
                             int Hkv, int D, int dtype, int causal,
                             float sm_scale, void* stream) {
  return (int)fwd_dispatch<true>(q, k, v, o, static_cast<float*>(lse), B, Lq,
                                 Lk, H, Hkv, D, dtype, causal, sm_scale,
                                 static_cast<cudaStream_t>(stream));
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int B, int Lq,
                            int Lk, int H, int Hkv, int D, int dtype,
                            int causal, float sm_scale, void* stream) {
  return (int)bwd_dispatch<false>(q, k, v, dout, lse, delta, dq, nullptr,
                                  B, Lq, Lk, H, Hkv, D, dtype, causal,
                                  sm_scale, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int B,
                             int Lq, int Lk, int H, int Hkv, int D, int dtype,
                             int causal, float sm_scale, void* stream) {
  return (int)bwd_dispatch<true>(q, k, v, dout, lse, delta, dk, dv, B, Lq,
                                 Lk, H, Hkv, D, dtype, causal, sm_scale,
                                 static_cast<cudaStream_t>(stream));
}

// The segment-id and dropout variants of the four entry points: the same
// arguments, then q_segs (B, Lq) and kv_segs (B, Lk) int32 (both or
// neither null; both with drop), drop (0 or 1), seed (its bits as uint32), keep_prob =
// fp32(1 - p) and inv_keep = fp32(1 / (1 - p)) (see SegDrop), then the
// stream.
extern "C" int flash_fwd_segdrop(const void* q, const void* k, const void* v,
                                 void* o, int B, int Lq, int Lk, int H, int Hkv,
                                 int D, int dtype, int causal, float sm_scale,
                                 const void* q_segs, const void* kv_segs, int drop,
                                 int seed, float keep_prob, float inv_keep,
                                 void* stream) {
  const SegDrop sd{static_cast<const int*>(q_segs), static_cast<const int*>(kv_segs),
                   (uint32_t)seed, keep_prob, inv_keep};
  return (int)fwd_dispatch_var<false>(q, k, v, o, nullptr, B, Lq, Lk, H, Hkv, D, dtype,
                                      causal, sm_scale, static_cast<cudaStream_t>(stream),
                                      sd, drop);
}

extern "C" int flash_fwd_lse_segdrop(const void* q, const void* k, const void* v,
                                     void* o, void* lse, int B, int Lq, int Lk,
                                     int H, int Hkv, int D, int dtype, int causal,
                                     float sm_scale, const void* q_segs,
                                     const void* kv_segs, int drop, int seed,
                                     float keep_prob, float inv_keep, void* stream) {
  const SegDrop sd{static_cast<const int*>(q_segs), static_cast<const int*>(kv_segs),
                   (uint32_t)seed, keep_prob, inv_keep};
  return (int)fwd_dispatch_var<true>(q, k, v, o, static_cast<float*>(lse), B, Lq, Lk, H,
                                     Hkv, D, dtype, causal, sm_scale,
                                     static_cast<cudaStream_t>(stream), sd, drop);
}

extern "C" int flash_bwd_dq_segdrop(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse,
                                    const void* delta, void* dq, int B, int Lq,
                                    int Lk, int H, int Hkv, int D, int dtype,
                                    int causal, float sm_scale, const void* q_segs,
                                    const void* kv_segs, int drop, int seed,
                                    float keep_prob, float inv_keep, void* stream) {
  const SegDrop sd{static_cast<const int*>(q_segs), static_cast<const int*>(kv_segs),
                   (uint32_t)seed, keep_prob, inv_keep};
  return (int)bwd_dispatch_var<false>(q, k, v, dout, lse, delta, dq, nullptr, B, Lq, Lk,
                                      H, Hkv, D, dtype, causal, sm_scale,
                                      static_cast<cudaStream_t>(stream), sd, drop);
}

extern "C" int flash_bwd_dkv_segdrop(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse,
                                     const void* delta, void* dk, void* dv, int B,
                                     int Lq, int Lk, int H, int Hkv, int D,
                                     int dtype, int causal, float sm_scale,
                                     const void* q_segs, const void* kv_segs,
                                     int drop, int seed, float keep_prob,
                                     float inv_keep, void* stream) {
  const SegDrop sd{static_cast<const int*>(q_segs), static_cast<const int*>(kv_segs),
                   (uint32_t)seed, keep_prob, inv_keep};
  return (int)bwd_dispatch_var<true>(q, k, v, dout, lse, delta, dk, dv, B, Lq, Lk, H,
                                     Hkv, D, dtype, causal, sm_scale,
                                     static_cast<cudaStream_t>(stream), sd, drop);
}
