// Flash-attention forward for Hopper (sm_90a): the port of
// paddle_tpu/ops/flash_attention.py::_flash_fwd_kernel (launched from
// _pallas_flash with with_lse=False), the kernel that carries Llama prefill
// and the concat-cache generate loop.
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

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Lq, int Lk,
                 int H, int Hkv, int causal, float sm_scale) {
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

template <int D>
__global__ void __launch_bounds__(TC_NT)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, int Lq, int Lk, int H,
                    int Hkv, int causal, float sm_scale) {
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
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      int B, int Lq, int Lk, int H, int Hkv, int causal,
                      float sm_scale, cudaStream_t stream) {
  auto kern = flash_fwd_tc_kernel<D>;
  const size_t smem = TcSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + BM - 1) / BM, B * H);
  kern<<<grid, TC_NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Lq,
      Lk, H, Hkv, causal, sm_scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int Lq, int Lk, int H, int Hkv, int causal, float sm_scale,
                   cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, D>;
  const size_t smem = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + BM - 1) / BM, B * H);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Lq, Lk, H, Hkv, causal,
      sm_scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         int B, int Lq, int Lk, int H, int Hkv, int D,
                         int dtype, int causal, float sm_scale, void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || Hkv <= 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 128)
    return (int)launch<float, 128>(q, k, v, o, B, Lq, Lk, H, Hkv, causal, sm_scale, s);
  if (dtype == 0 && D == 64)
    return (int)launch<float, 64>(q, k, v, o, B, Lq, Lk, H, Hkv, causal, sm_scale, s);
  if (dtype == 1 && D == 128)
    return (int)launch_tc<128>(q, k, v, o, B, Lq, Lk, H, Hkv, causal, sm_scale, s);
  if (dtype == 1 && D == 64)
    return (int)launch_tc<64>(q, k, v, o, B, Lq, Lk, H, Hkv, causal, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
