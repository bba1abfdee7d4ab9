// Flash attention for Hopper (sm_90a), forward and backward. The ports of
// paddle_tpu/ops/flash_attention.py:
//   _flash_fwd_kernel      (with_lse=False; prefill, generate)  -> flash_fwd
//   _flash_fwd_kernel_lse  (with_lse=True; training forward)    -> flash_fwd_lse
//   _flash_bwd_dq_kernel   (training backward, dq)              -> flash_bwd_dq
//   _flash_bwd_dkv_kernel  (training backward, dk and dv)       -> flash_bwd_dkv
// The forward with lse is the same kernel template as the forward, with the
// lse store switched on at compile time.
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
// one block per (64-row Q tile, batch * head) in both, K tiles past the
// causal diagonal never loaded:
//
// * bfloat16 (the serving path): tensor cores through mma.sync m16n8k16
//   (bf16 in, fp32 accumulate). Four warps, 16 query rows each; a warp keeps
//   its Q fragments in registers for the whole key loop; 64-key K tiles are
//   staged row-major and V tiles transposed in shared memory (rows padded so
//   the 8 row groups of a warp hit distinct banks); the scores come out in
//   the accumulator layout, the online softmax runs on them in registers
//   (row max and sum across the 4 lanes of a row by shuffles), and the
//   probabilities are re-packed as bf16 A fragments for P.V, as in
//   FlashAttention-2. wgmma, TMA and warp specialisation are later work.
// * float32 (parity runs): the products on the CUDA cores in fp32; the Q
//   tile staged once in shared memory pre-scaled by sm_scale, K transposed
//   and padded; each thread owns a 4x4 block of scores and a 4 x (D/16)
//   block of the accumulator; row statistics across 16 lanes by shuffles.
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
// * dq: one block per (64-row Q tile, batch * head); it streams 64-key K/V
//   tiles over the causal range only (the forward's rule) and keeps dq in
//   fp32 registers.
// * dk/dv: one block per (64-key K tile, batch * kv head); it loops over the
//   H / Hkv query heads of its group (GQA: the group's sum is taken in
//   registers, where the TPU package repeated K/V and let AD sum) and over
//   the Q tiles from the first one that can see the K tile, with Q, dO and
//   their transposes, lse and delta staged in shared memory.
// In bf16 both run mma.sync m16n8k16 as the forward does: a warp owns 16
// rows (queries for dq, keys for dk/dv), the score and dP tiles come out in
// the accumulator layout, and P and dS are re-packed in registers as bf16
// A operands of the second products (B operands transposed in shared
// memory). In fp32 they run on the CUDA cores, 256 threads, each owning a
// 4x4 block of the score tile and a 4 x (D/16) block of the gradient, with
// rows of stride D + 1 in shared memory so that neither the row-wise nor
// the column-wise reads conflict.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // query rows per block
constexpr int BN = 64;   // keys per streamed tile
constexpr int NT = 256;  // threads: 16 row groups x 16 lanes

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
struct Smem {
  static constexpr int QS = D + 4;    // Q row stride (float4-aligned, bank-shifted)
  static constexpr int KS = BN + 1;   // transposed-K row stride
  static constexpr int PS = BN + 1;   // P row stride
  static constexpr int floats = BM * QS + D * KS + BN * D + BM * PS;
  static constexpr size_t bytes = floats * sizeof(float);
};

constexpr float LSE_MASKED = 1e30f;  // lse of a row that sees no key

template <typename T, int D, bool LSE>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Lq, int Lk, int H, int Hkv,
                 int causal, float sm_scale) {
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
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_i[r] = -INFINITY;
    l_i[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[r][j] = 0.f;
  }

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
        const bool ok = col < Lk && (!causal || row + shift >= col);
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
        Ps[(ty * 4 + r) * S::PS + tx + 16 * c] = p;
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
// bfloat16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

constexpr int TC_NT = 128;  // 4 warps x 16 query rows

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
struct TcSmem {
  static constexpr int KST = D + 8;   // K row stride (bf16)
  static constexpr int VST = BN + 8;  // transposed-V row stride (bf16)
  static constexpr size_t bytes = (size_t)(BN * KST + D * VST) * sizeof(__nv_bfloat16);
};

template <int D, bool LSE>
__global__ void __launch_bounds__(TC_NT)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int Lq, int Lk, int H, int Hkv, int causal,
                    float sm_scale) {
  using S = TcSmem<D>;
  constexpr int KSTEPS = D / 16;  // k-steps of q.k
  constexpr int NTILE = BN / 8;   // 8-key tiles of the scores
  constexpr int DTILE = D / 8;    // 8-column tiles of the output
  constexpr int CPR = D / 8;      // 16-byte chunks per K/V row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BN][KST]
  __nv_bfloat16* Vt = Ks + BN * S::KST;                             // [D][VST]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, kvh = h / (H / Hkv);
  const int m0 = blockIdx.x * BM;
  const long q_stride = (long)H * D, kv_stride = (long)Hkv * D;
  const __nv_bfloat16* qb = q + ((long)b * Lq * H + h) * D;
  const __nv_bfloat16* kb = k + ((long)b * Lk * Hkv + kvh) * D;
  const __nv_bfloat16* vb = v + ((long)b * Lk * Hkv + kvh) * D;
  __nv_bfloat16* ob = o + ((long)b * Lq * H + h) * D;
  const int r0 = m0 + warp * 16 + g;  // this lane's two rows: r0, r0 + 8
  const int r1 = r0 + 8;

  uint32_t qa[KSTEPS][4];  // A fragments of the warp's 16 Q rows
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const int c = ks * 16 + tig * 2;
    qa[ks][0] = r0 < Lq ? ld32(qb + (long)r0 * q_stride + c) : 0u;
    qa[ks][1] = r1 < Lq ? ld32(qb + (long)r1 * q_stride + c) : 0u;
    qa[ks][2] = r0 < Lq ? ld32(qb + (long)r0 * q_stride + c + 8) : 0u;
    qa[ks][3] = r1 < Lq ? ld32(qb + (long)r1 * q_stride + c + 8) : 0u;
  }

  const int shift = Lk - Lq;  // bottom-right causal alignment
  int n_end = Lk;
  if (causal) n_end = min(Lk, max(0, m0 + BM + shift));

  float oacc[DTILE][4];
#pragma unroll
  for (int dt = 0; dt < DTILE; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[dt][e] = 0.f;
  float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};

  for (int n0 = 0; n0 < n_end; n0 += BN) {
    __syncthreads();  // the previous tile's readers are done
    for (int c = tid; c < BN * CPR; c += TC_NT) {
      const int r = c / CPR, d = (c % CPR) * 8, j = n0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (j < Lk) val = *reinterpret_cast<const uint4*>(kb + (long)j * kv_stride + d);
      *reinterpret_cast<uint4*>(Ks + r * S::KST + d) = val;
    }
    for (int c = tid; c < BN * CPR; c += TC_NT) {
      const int r = c % BN, d = (c / BN) * 8, j = n0 + r;  // lanes: consecutive keys
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (j < Lk) val = *reinterpret_cast<const uint4*>(vb + (long)j * kv_stride + d);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[(d + i) * S::VST + r] = e[i];
    }
    __syncthreads();

    float sacc[NTILE][4];
#pragma unroll
    for (int nt = 0; nt < NTILE; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
      for (int nt = 0; nt < NTILE; ++nt) {
        const __nv_bfloat16* kr = Ks + (nt * 8 + g) * S::KST + ks * 16 + tig * 2;
        mma_bf16(sacc[nt], qa[ks], ld32(kr), ld32(kr + 8));
      }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NTILE; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + nt * 8 + tig * 2 + e;
        const bool ok0 = col < Lk && (!causal || r0 + shift >= col);
        const bool ok1 = col < Lk && (!causal || r1 + shift >= col);
        sacc[nt][e] = ok0 ? sacc[nt][e] * sm_scale : -INFINITY;
        sacc[nt][2 + e] = ok1 ? sacc[nt][2 + e] * sm_scale : -INFINITY;
        mx0 = fmaxf(mx0, sacc[nt][e]);
        mx1 = fmaxf(mx1, sacc[nt][2 + e]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m_i[0], mx0), mn1 = fmaxf(m_i[1], mx1);
    const float mu0 = mn0 == -INFINITY ? 0.f : mn0;  // no valid key yet
    const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
    const float alpha0 = expf(m_i[0] - mu0), alpha1 = expf(m_i[1] - mu1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NTILE; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sacc[nt][e] = expf(sacc[nt][e] - mu0);
        sacc[nt][2 + e] = expf(sacc[nt][2 + e] - mu1);
        sum0 += sacc[nt][e];
        sum1 += sacc[nt][2 + e];
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l_i[0] = alpha0 * l_i[0] + sum0;
    l_i[1] = alpha1 * l_i[1] + sum1;
    m_i[0] = mn0;
    m_i[1] = mn1;
#pragma unroll
    for (int dt = 0; dt < DTILE; ++dt) {
      oacc[dt][0] *= alpha0;
      oacc[dt][1] *= alpha0;
      oacc[dt][2] *= alpha1;
      oacc[dt][3] *= alpha1;
    }

#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      // the score accumulators of key tiles 2kk, 2kk+1 are the A fragment
      const uint32_t pa[4] = {pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]),
                              pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]),
                              pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
                              pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < DTILE; ++dt) {
        const __nv_bfloat16* vr = Vt + (dt * 8 + g) * S::VST + kk * 16 + tig * 2;
        mma_bf16(oacc[dt], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  const float inv0 = 1.f / fmaxf(l_i[0], 1e-30f);
  const float inv1 = 1.f / fmaxf(l_i[1], 1e-30f);
#pragma unroll
  for (int dt = 0; dt < DTILE; ++dt) {
    const int col = dt * 8 + tig * 2;
    if (r0 < Lq)
      *reinterpret_cast<uint32_t*>(ob + (long)r0 * q_stride + col) =
          pack_bf16(oacc[dt][0] * inv0, oacc[dt][1] * inv0);
    if (r1 < Lq)
      *reinterpret_cast<uint32_t*>(ob + (long)r1 * q_stride + col) =
          pack_bf16(oacc[dt][2] * inv1, oacc[dt][3] * inv1);
  }
  if (LSE && tig == 0) {  // the 4 lanes of a row hold the same m_i, l_i
    if (r0 < Lq)
      lse[(long)bh * Lq + r0] = l_i[0] > 0.f ? m_i[0] + logf(l_i[0]) : LSE_MASKED;
    if (r1 < Lq)
      lse[(long)bh * Lq + r1] = l_i[1] > 0.f ? m_i[1] + logf(l_i[1]) : LSE_MASKED;
  }
}

template <int D, bool LSE>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      float* lse, int B, int Lq, int Lk, int H, int Hkv,
                      int causal, float sm_scale, cudaStream_t stream) {
  auto kern = flash_fwd_tc_kernel<D, LSE>;
  const size_t smem = TcSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + BM - 1) / BM, B * H);
  kern<<<grid, TC_NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, Lq, Lk, H, Hkv, causal, sm_scale);
  return cudaGetLastError();
}

template <typename T, int D, bool LSE>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Lq, int Lk, int H, int Hkv,
                   int causal, float sm_scale, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, D, LSE>;
  const size_t smem = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + BM - 1) / BM, B * H);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Lq, Lk, H, Hkv,
      causal, sm_scale);
  return cudaGetLastError();
}

template <bool LSE>
cudaError_t fwd_dispatch(const void* q, const void* k, const void* v, void* o,
                         float* lse, int B, int Lq, int Lk, int H, int Hkv,
                         int D, int dtype, int causal, float sm_scale,
                         cudaStream_t s) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || Hkv <= 0 || H % Hkv != 0)
    return cudaErrorInvalidValue;
  if (dtype == 0 && D == 128)
    return launch<float, 128, LSE>(q, k, v, o, lse, B, Lq, Lk, H, Hkv, causal, sm_scale, s);
  if (dtype == 0 && D == 64)
    return launch<float, 64, LSE>(q, k, v, o, lse, B, Lq, Lk, H, Hkv, causal, sm_scale, s);
  if (dtype == 1 && D == 128)
    return launch_tc<128, LSE>(q, k, v, o, lse, B, Lq, Lk, H, Hkv, causal, sm_scale, s);
  if (dtype == 1 && D == 64)
    return launch_tc<64, LSE>(q, k, v, o, lse, B, Lq, Lk, H, Hkv, causal, sm_scale, s);
  return cudaErrorInvalidValue;
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
template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int Lq, int Lk, int H, int Hkv, int causal,
                    float sm_scale) {
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
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = m0 + ty * 4 + r;
    lse_r[r] = row < Lq ? lse[(long)bh * Lq + row] : LSE_MASKED;
    dl_r[r] = row < Lq ? delta[(long)bh * Lq + row] : 0.f;
  }

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
        const bool ok = row < Lq && col < Lk && (!causal || row + shift >= col);
        const float p = ok ? expf(s[r][c] * sm_scale - lse_r[r]) : 0.f;
        dSs[(ty * 4 + r) * S::PS + tx + 16 * c] = p * (dp[r][c] - dl_r[r]) * sm_scale;
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
template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int Lq, int Lk, int H, int Hkv,
                     int causal, float sm_scale) {
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
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[r][j] = dv_acc[r][j] = 0.f;

  for (int hq = kvh * rep; hq < kvh * rep + rep; ++hq) {
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
          const bool ok = row < Lq && key < Lk && (!causal || row + shift >= key);
          const float p = ok ? expf(s[r][c] * sm_scale - lse_s[qc]) : 0.f;
          Ps[(ty * 4 + r) * S::PS + qc] = p;
          dSs[(ty * 4 + r) * S::PS + qc] = p * (dp[r][c] - dl_s[qc]) * sm_scale;
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
// backward, bfloat16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

template <int D>
struct TcBwdSmem {
  static constexpr int RST = D + 8;   // row-major tile stride (bf16)
  static constexpr int TST = BN + 8;  // transposed tile stride (bf16)
};

// Copy rows [r0, r0 + 64) of a (rows, D) bf16 matrix with row stride
// `stride` into shared memory, row-major at stride RST and, if Tt is not
// null, transposed ([D][TST]) too. Rows past `rows` are zero.
template <int D>
__device__ __forceinline__ void stage_tile(const __nv_bfloat16* __restrict__ src,
                                           long stride, int r0, int rows,
                                           __nv_bfloat16* Rs, __nv_bfloat16* Tt) {
  using S = TcBwdSmem<D>;
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < BN * CPR; c += TC_NT) {
    const int r = c % BN, d = (c / BN) * 8, j = r0 + r;  // lanes: consecutive rows
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (j < rows) val = *reinterpret_cast<const uint4*>(src + (long)j * stride + d);
    *reinterpret_cast<uint4*>(Rs + r * S::RST + d) = val;
    if (Tt != nullptr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) Tt[(d + i) * S::TST + r] = e[i];
    }
  }
}

// A fragment (16 rows x 16) at row `row` (this lane's g) of a row-major tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* t,
                                       int stride, int row, int col) {
  a[0] = ld32(t + row * stride + col);
  a[1] = ld32(t + (row + 8) * stride + col);
  a[2] = ld32(t + row * stride + col + 8);
  a[3] = ld32(t + (row + 8) * stride + col + 8);
}

// Re-pack two 8-column accumulator tiles as one bf16 A fragment.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// dq: four warps, 16 query rows each; dO and Q fragments in registers.
template <int D>
__global__ void __launch_bounds__(TC_NT)
flash_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int Lq, int Lk, int H,
                       int Hkv, int causal, float sm_scale) {
  using S = TcBwdSmem<D>;
  constexpr int KSTEPS = D / 16, NTILE = BN / 8, DTILE = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BN][RST]
  __nv_bfloat16* Vs = Ks + BN * S::RST;                             // [BN][RST]
  __nv_bfloat16* Kt = Vs + BN * S::RST;                             // [D][TST]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, kvh = h / (H / Hkv);
  const int m0 = blockIdx.x * BM;
  const long q_stride = (long)H * D, kv_stride = (long)Hkv * D;
  const __nv_bfloat16* qb = q + ((long)b * Lq * H + h) * D;
  const __nv_bfloat16* dob = dout + ((long)b * Lq * H + h) * D;
  const __nv_bfloat16* kb = k + ((long)b * Lk * Hkv + kvh) * D;
  const __nv_bfloat16* vb = v + ((long)b * Lk * Hkv + kvh) * D;
  __nv_bfloat16* dqb = dq + ((long)b * Lq * H + h) * D;
  const int r0 = m0 + warp * 16 + g, r1 = r0 + 8;

  uint32_t qa[KSTEPS][4], da[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const int c = ks * 16 + tig * 2;
    qa[ks][0] = r0 < Lq ? ld32(qb + (long)r0 * q_stride + c) : 0u;
    qa[ks][1] = r1 < Lq ? ld32(qb + (long)r1 * q_stride + c) : 0u;
    qa[ks][2] = r0 < Lq ? ld32(qb + (long)r0 * q_stride + c + 8) : 0u;
    qa[ks][3] = r1 < Lq ? ld32(qb + (long)r1 * q_stride + c + 8) : 0u;
    da[ks][0] = r0 < Lq ? ld32(dob + (long)r0 * q_stride + c) : 0u;
    da[ks][1] = r1 < Lq ? ld32(dob + (long)r1 * q_stride + c) : 0u;
    da[ks][2] = r0 < Lq ? ld32(dob + (long)r0 * q_stride + c + 8) : 0u;
    da[ks][3] = r1 < Lq ? ld32(dob + (long)r1 * q_stride + c + 8) : 0u;
  }
  const float lse0 = r0 < Lq ? lse[(long)bh * Lq + r0] : LSE_MASKED;
  const float lse1 = r1 < Lq ? lse[(long)bh * Lq + r1] : LSE_MASKED;
  const float dl0 = r0 < Lq ? delta[(long)bh * Lq + r0] : 0.f;
  const float dl1 = r1 < Lq ? delta[(long)bh * Lq + r1] : 0.f;

  const int shift = Lk - Lq;
  int n_end = Lk;
  if (causal) n_end = min(Lk, max(0, m0 + BM + shift));

  float acc[DTILE][4];
#pragma unroll
  for (int dt = 0; dt < DTILE; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  for (int n0 = 0; n0 < n_end; n0 += BN) {
    __syncthreads();  // the previous tile's readers are done
    stage_tile<D>(kb, kv_stride, n0, Lk, Ks, Kt);
    stage_tile<D>(vb, kv_stride, n0, Lk, Vs, nullptr);
    __syncthreads();

    float sacc[NTILE][4], pacc[NTILE][4];
#pragma unroll
    for (int nt = 0; nt < NTILE; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[nt][e] = pacc[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
      for (int nt = 0; nt < NTILE; ++nt) {
        const int off = (nt * 8 + g) * S::RST + ks * 16 + tig * 2;
        mma_bf16(sacc[nt], qa[ks], ld32(Ks + off), ld32(Ks + off + 8));
        mma_bf16(pacc[nt], da[ks], ld32(Vs + off), ld32(Vs + off + 8));
      }

    // dS = P o (dP - delta) * scale, in place of the scores
#pragma unroll
    for (int nt = 0; nt < NTILE; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + nt * 8 + tig * 2 + e;
        const bool ok0 = r0 < Lq && col < Lk && (!causal || r0 + shift >= col);
        const bool ok1 = r1 < Lq && col < Lk && (!causal || r1 + shift >= col);
        const float p0 = ok0 ? expf(sacc[nt][e] * sm_scale - lse0) : 0.f;
        const float p1 = ok1 ? expf(sacc[nt][2 + e] * sm_scale - lse1) : 0.f;
        sacc[nt][e] = p0 * (pacc[nt][e] - dl0) * sm_scale;
        sacc[nt][2 + e] = p1 * (pacc[nt][2 + e] - dl1) * sm_scale;
      }

#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      pack_a(a, sacc[2 * kk], sacc[2 * kk + 1]);
#pragma unroll
      for (int dt = 0; dt < DTILE; ++dt) {
        const __nv_bfloat16* kr = Kt + (dt * 8 + g) * S::TST + kk * 16 + tig * 2;
        mma_bf16(acc[dt], a, ld32(kr), ld32(kr + 8));
      }
    }
  }

#pragma unroll
  for (int dt = 0; dt < DTILE; ++dt) {
    const int col = dt * 8 + tig * 2;
    if (r0 < Lq)
      *reinterpret_cast<uint32_t*>(dqb + (long)r0 * q_stride + col) =
          pack_bf16(acc[dt][0], acc[dt][1]);
    if (r1 < Lq)
      *reinterpret_cast<uint32_t*>(dqb + (long)r1 * q_stride + col) =
          pack_bf16(acc[dt][2], acc[dt][3]);
  }
}

// dk, dv: four warps, 16 keys each; K and V fragments read from shared
// memory per step, dk and dv in fp32 registers across the whole group.
template <int D>
__global__ void __launch_bounds__(TC_NT)
flash_bwd_dkv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int Lq, int Lk, int H,
                        int Hkv, int causal, float sm_scale) {
  using S = TcBwdSmem<D>;
  constexpr int BQ = BN;  // queries per streamed tile
  constexpr int KSTEPS = D / 16, NTILE = BQ / 8, DTILE = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BN][RST]
  __nv_bfloat16* Vs = Ks + BN * S::RST;                             // [BN][RST]
  __nv_bfloat16* Qs = Vs + BN * S::RST;                             // [BQ][RST]
  __nv_bfloat16* dOs = Qs + BQ * S::RST;                            // [BQ][RST]
  __nv_bfloat16* Qt = dOs + BQ * S::RST;                            // [D][TST]
  __nv_bfloat16* dOt = Qt + D * S::TST;                             // [D][TST]
  float* lse_s = reinterpret_cast<float*>(dOt + D * S::TST);        // [BQ]
  float* dl_s = lse_s + BQ;                                         // [BQ]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int bkv = blockIdx.y, b = bkv / Hkv, kvh = bkv % Hkv;
  const int rep = H / Hkv;
  const int k0 = blockIdx.x * BN;
  const long q_stride = (long)H * D, kv_stride = (long)Hkv * D;
  const int wr = warp * 16 + g;  // this lane's key rows in the tile: wr, wr + 8
  const int c0 = k0 + wr, c1 = c0 + 8;

  stage_tile<D>(k + ((long)b * Lk * Hkv + kvh) * D, kv_stride, k0, Lk, Ks, nullptr);
  stage_tile<D>(v + ((long)b * Lk * Hkv + kvh) * D, kv_stride, k0, Lk, Vs, nullptr);

  const int shift = Lk - Lq;
  const int q_begin = causal ? (max(0, k0 - shift) / BQ) * BQ : 0;

  float dk_acc[DTILE][4], dv_acc[DTILE][4];
#pragma unroll
  for (int dt = 0; dt < DTILE; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;

  for (int hq = kvh * rep; hq < kvh * rep + rep; ++hq) {
    const __nv_bfloat16* qb = q + ((long)b * Lq * H + hq) * D;
    const __nv_bfloat16* dob = dout + ((long)b * Lq * H + hq) * D;
    const float* lseb = lse + ((long)b * H + hq) * Lq;
    const float* dlb = delta + ((long)b * H + hq) * Lq;
    for (int q0 = q_begin; q0 < Lq; q0 += BQ) {
      __syncthreads();  // the previous tile's readers are done
      stage_tile<D>(qb, q_stride, q0, Lq, Qs, Qt);
      stage_tile<D>(dob, q_stride, q0, Lq, dOs, dOt);
      for (int r = tid; r < BQ; r += TC_NT) {
        const int i = q0 + r;
        lse_s[r] = i < Lq ? lseb[i] : LSE_MASKED;
        dl_s[r] = i < Lq ? dlb[i] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys
      float sacc[NTILE][4], pacc[NTILE][4];
#pragma unroll
      for (int nt = 0; nt < NTILE; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[nt][e] = pacc[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        uint32_t ka[4], va[4];
        load_a(ka, Ks, S::RST, wr, ks * 16 + tig * 2);
        load_a(va, Vs, S::RST, wr, ks * 16 + tig * 2);
#pragma unroll
        for (int nt = 0; nt < NTILE; ++nt) {
          const int off = (nt * 8 + g) * S::RST + ks * 16 + tig * 2;
          mma_bf16(sacc[nt], ka, ld32(Qs + off), ld32(Qs + off + 8));
          mma_bf16(pacc[nt], va, ld32(dOs + off), ld32(dOs + off + 8));
        }
      }

      // P^T in sacc, dS^T in pacc
#pragma unroll
      for (int nt = 0; nt < NTILE; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qc = nt * 8 + tig * 2 + e, row = q0 + qc;
          const bool qok = row < Lq;
          const bool ok0 = qok && c0 < Lk && (!causal || row + shift >= c0);
          const bool ok1 = qok && c1 < Lk && (!causal || row + shift >= c1);
          const float ls = lse_s[qc], dl = dl_s[qc];
          const float p0 = ok0 ? expf(sacc[nt][e] * sm_scale - ls) : 0.f;
          const float p1 = ok1 ? expf(sacc[nt][2 + e] * sm_scale - ls) : 0.f;
          sacc[nt][e] = p0;
          sacc[nt][2 + e] = p1;
          pacc[nt][e] = p0 * (pacc[nt][e] - dl) * sm_scale;
          pacc[nt][2 + e] = p1 * (pacc[nt][2 + e] - dl) * sm_scale;
        }

      // dV += P^T dO, dK += dS^T Q
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t pa[4], sa[4];
        pack_a(pa, sacc[2 * kk], sacc[2 * kk + 1]);
        pack_a(sa, pacc[2 * kk], pacc[2 * kk + 1]);
#pragma unroll
        for (int dt = 0; dt < DTILE; ++dt) {
          const int off = (dt * 8 + g) * S::TST + kk * 16 + tig * 2;
          mma_bf16(dv_acc[dt], pa, ld32(dOt + off), ld32(dOt + off + 8));
          mma_bf16(dk_acc[dt], sa, ld32(Qt + off), ld32(Qt + off + 8));
        }
      }
    }
  }

  __nv_bfloat16* dkb = dk + ((long)b * Lk * Hkv + kvh) * D;
  __nv_bfloat16* dvb = dv + ((long)b * Lk * Hkv + kvh) * D;
#pragma unroll
  for (int dt = 0; dt < DTILE; ++dt) {
    const int col = dt * 8 + tig * 2;
    if (c0 < Lk) {
      *reinterpret_cast<uint32_t*>(dkb + (long)c0 * kv_stride + col) =
          pack_bf16(dk_acc[dt][0], dk_acc[dt][1]);
      *reinterpret_cast<uint32_t*>(dvb + (long)c0 * kv_stride + col) =
          pack_bf16(dv_acc[dt][0], dv_acc[dt][1]);
    }
    if (c1 < Lk) {
      *reinterpret_cast<uint32_t*>(dkb + (long)c1 * kv_stride + col) =
          pack_bf16(dk_acc[dt][2], dk_acc[dt][3]);
      *reinterpret_cast<uint32_t*>(dvb + (long)c1 * kv_stride + col) =
          pack_bf16(dv_acc[dt][2], dv_acc[dt][3]);
    }
  }
}

template <int D>
constexpr size_t tc_bwd_dq_smem() {
  return (size_t)(2 * BN * TcBwdSmem<D>::RST + D * TcBwdSmem<D>::TST) *
         sizeof(__nv_bfloat16);
}

template <int D>
constexpr size_t tc_bwd_dkv_smem() {
  return (size_t)(4 * BN * TcBwdSmem<D>::RST + 2 * D * TcBwdSmem<D>::TST) *
             sizeof(__nv_bfloat16) + 2 * BN * sizeof(float);
}

template <typename K>
cudaError_t set_smem(K kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// DKV = false: dq into out0. DKV = true: dk into out0, dv into out1.
template <bool DKV, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* out0, void* out1, int B, int Lq, int Lk, int H,
                       int Hkv, int dtype, int causal, float sm_scale,
                       cudaStream_t st) {
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaError_t err;
  if (dtype == 0) {
    const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
                *vf = static_cast<const float*>(v), *df = static_cast<const float*>(dout);
    if (!DKV) {
      auto kern = flash_bwd_dq_kernel<D>;
      if ((err = set_smem(kern, bwd_dq_smem<D>())) != cudaSuccess) return err;
      kern<<<dim3((Lq + BM - 1) / BM, B * H), NT, bwd_dq_smem<D>(), st>>>(
          qf, kf, vf, df, ls, dl, static_cast<float*>(out0), Lq, Lk, H, Hkv,
          causal, sm_scale);
    } else {
      auto kern = flash_bwd_dkv_kernel<D>;
      if ((err = set_smem(kern, bwd_dkv_smem<D>())) != cudaSuccess) return err;
      kern<<<dim3((Lk + BN - 1) / BN, B * Hkv), NT, bwd_dkv_smem<D>(), st>>>(
          qf, kf, vf, df, ls, dl, static_cast<float*>(out0),
          static_cast<float*>(out1), Lq, Lk, H, Hkv, causal, sm_scale);
    }
    return cudaGetLastError();
  }
  using bf = __nv_bfloat16;
  const bf *qb = static_cast<const bf*>(q), *kb = static_cast<const bf*>(k),
           *vb = static_cast<const bf*>(v), *db = static_cast<const bf*>(dout);
  if (!DKV) {
    auto kern = flash_bwd_dq_tc_kernel<D>;
    if ((err = set_smem(kern, tc_bwd_dq_smem<D>())) != cudaSuccess) return err;
    kern<<<dim3((Lq + BM - 1) / BM, B * H), TC_NT, tc_bwd_dq_smem<D>(), st>>>(
        qb, kb, vb, db, ls, dl, static_cast<bf*>(out0), Lq, Lk, H, Hkv, causal,
        sm_scale);
  } else {
    auto kern = flash_bwd_dkv_tc_kernel<D>;
    if ((err = set_smem(kern, tc_bwd_dkv_smem<D>())) != cudaSuccess) return err;
    kern<<<dim3((Lk + BN - 1) / BN, B * Hkv), TC_NT, tc_bwd_dkv_smem<D>(), st>>>(
        qb, kb, vb, db, ls, dl, static_cast<bf*>(out0), static_cast<bf*>(out1),
        Lq, Lk, H, Hkv, causal, sm_scale);
  }
  return cudaGetLastError();
}

template <bool DKV>
cudaError_t bwd_dispatch(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* out0, void* out1, int B, int Lq, int Lk, int H,
                         int Hkv, int D, int dtype, int causal, float sm_scale,
                         cudaStream_t s) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  if (D == 128)
    return launch_bwd<DKV, 128>(q, k, v, dout, lse, delta, out0, out1, B, Lq,
                                Lk, H, Hkv, dtype, causal, sm_scale, s);
  if (D == 64)
    return launch_bwd<DKV, 64>(q, k, v, dout, lse, delta, out0, out1, B, Lq,
                               Lk, H, Hkv, dtype, causal, sm_scale, s);
  return cudaErrorInvalidValue;
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
