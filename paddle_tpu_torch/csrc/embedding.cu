// Embedding lookup and its deterministic backward, for Hopper (sm_90a). The
// port's own kernel: the JAX package gathers rows with jnp.take and leaves
// the gradient's scatter-add to XLA (paddle_tpu/ops/nn_ops.py embedding),
// no pallas_call.
//
// Forward (emb_fwd_kernel): out[t] = weight[ids[t]], and 0 where ids[t] is
// padding_idx (or outside [0, rows)); rows are copied as bits, 16 bytes a
// thread when the rows allow it.
//
// Backward, without atomics, so every launch (an eager step and a captured
// one alike) gives the same bits. The wrapper sorts the ids stably
// (torch.sort(stable=True), index preparation only), so the rows of one id
// lie together in token order; sorted position k belongs to the run
// [rs, re) of its id (found by binary search in the sorted ids). A run is
// cut into pieces of CHUNK rows from its start. The sums accumulate in the
// weight's dtype, rounding after each add (acc = rnd(acc + row)), as the
// JAX package's scatter-add and autograd's CPU index_put do: in fp32 that
// is the fp32 token-order sum; in bf16 it keeps the O2 gradients within
// the parity bound of the reference, whose bf16 scatter-add rounds each
// add. emb_bwd_piece_kernel sums each piece's rows of dy in token order
// from 0: a run of one piece writes its sum straight into its row, a longer
// run writes each piece's sum to scratch (fp32, holding the rounded value),
// and emb_bwd_fold_kernel adds a run's pieces in piece order from 0 and
// writes the row. So a skewed table (ERNIE's token-type ids, one id for
// all 4096 rows) is summed by 64 blocks, not one. The wrapper zeroes the
// gradient first: rows no token hit and the padding row stay 0.
//
// A piece starts at rs + m CHUNK; its scratch slot is 2 (start / CHUNK) +
// (is the run's last piece): an aligned window of CHUNK positions holds at
// most one long run's last piece and one piece of full length, so slots
// never collide (2 ceil(N / CHUNK) rows of fp32 scratch).
//
// Bound: bytes (forward reads ids and the hit rows and writes out; backward
// reads ids and dy and writes the whole gradient table, zeros included).

#include <cuda_runtime.h>

#include <cstdint>

#include "fused_io.cuh"

namespace {

constexpr int CHUNK = 64;     // rows of a piece (ops/embedding.py CHUNK)
constexpr int THREADS = 128;  // a block's threads, each V columns

__device__ __forceinline__ long long load_id(const void* ids, long long t,
                                             int i64) {
  return i64 ? static_cast<const long long*>(ids)[t]
             : (long long)static_cast<const int*>(ids)[t];
}

// one thread a (token, 16-byte / element) unit of the output row
template <typename U>
__global__ void __launch_bounds__(256) emb_fwd_kernel(
    const void* __restrict__ ids, const U* __restrict__ w, U* __restrict__ out,
    long long tokens, long long rows, int units, int i64, long long pad) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long tok = t / units;
  if (tok >= tokens) return;
  const int u = (int)(t % units);
  const long long id = load_id(ids, tok, i64);
  U v;
  if (id == pad || id < 0 || id >= rows)
    v = U{};
  else
    v = w[id * units + u];
  out[tok * units + u] = v;
}

struct Bwd {
  const long long *sorted, *perm;
  const void* dy;
  void* dw;
  float* part;
  long long n, rows, pad;
  int d, dy_dt, w_dt;
};

// first index in [lo, hi) with s[i] >= id (right = 0) or > id (right = 1)
__device__ __forceinline__ long long bound(const long long* s, long long lo,
                                           long long hi, long long id,
                                           int right) {
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (s[mid] < id || (right && s[mid] == id))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <int V>
__device__ __forceinline__ void store_row(const Bwd& a, long long id, int c,
                                          const float (&acc)[V]) {
  if (id == a.pad || id < 0 || id >= a.rows) return;
  stv<V>(a.dw, id * a.d + c, a.w_dt, acc);
}

// grid (ceil(n / CHUNK), column blocks): the pieces that start in sorted
// positions [j CHUNK, (j + 1) CHUNK)
template <int V>
__global__ void __launch_bounds__(THREADS) emb_bwd_piece_kernel(Bwd a) {
  __shared__ long long s_rs[CHUNK], s_re[CHUNK], s_id[CHUNK];
  __shared__ long long s_perm[2 * CHUNK];
  const long long k0 = (long long)blockIdx.x * CHUNK;
  const int tid = threadIdx.x;
  if (tid < CHUNK) {
    const long long k = k0 + tid;
    if (k < a.n) {
      const long long id = a.sorted[k];
      s_id[tid] = id;
      s_rs[tid] = bound(a.sorted, 0, k, id, 0);
      s_re[tid] = bound(a.sorted, k + 1, a.n, id, 1);
    } else {
      s_rs[tid] = -1;
    }
  }
  for (int i = tid; i < 2 * CHUNK; i += THREADS)
    s_perm[i] = k0 + i < a.n ? a.perm[k0 + i] : 0;
  __syncthreads();
  const int c = (blockIdx.y * THREADS + tid) * V;
  if (c >= a.d) return;
  for (int t = 0; t < CHUNK; ++t) {
    const long long k = k0 + t, rs = s_rs[t], re = s_re[t];
    if (rs < 0 || (k - rs) % CHUNK != 0) continue;   // not a piece start
    const long long pe = min(k + CHUNK, re);
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
    for (long long r = k; r < pe; ++r) {
      float v[V];
      ldv<V>(a.dy, s_perm[r - k0] * a.d + c, a.dy_dt, v);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = rnd(__fadd_rn(acc[j], v[j]), a.w_dt);
    }
    if (re - rs <= CHUNK) {
      store_row<V>(a, s_id[t], c, acc);
    } else {
      const long long slot = 2 * (k / CHUNK) + (k + CHUNK >= re ? 1 : 0);
      stv<V>(a.part, slot * a.d + c, 0, acc);
    }
  }
}

// grid as the piece kernel: the run of more than CHUNK rows that starts in
// this block's positions (at most one), its partials added in piece order
template <int V>
__global__ void __launch_bounds__(THREADS) emb_bwd_fold_kernel(Bwd a) {
  __shared__ long long s_run[3];   // start, end, id
  const long long k0 = (long long)blockIdx.x * CHUNK;
  const int tid = threadIdx.x;
  if (tid == 0) s_run[0] = -1;
  __syncthreads();
  if (tid < CHUNK && k0 + tid < a.n) {
    const long long k = k0 + tid, id = a.sorted[k];
    if (k == 0 || a.sorted[k - 1] != id) {
      const long long re = bound(a.sorted, k + 1, a.n, id, 1);
      if (re - k > CHUNK) {
        s_run[0] = k;
        s_run[1] = re;
        s_run[2] = id;
      }
    }
  }
  __syncthreads();
  const int c = (blockIdx.y * THREADS + tid) * V;
  if (s_run[0] < 0 || c >= a.d) return;
  const long long rs = s_run[0], re = s_run[1];
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  for (long long p = rs; p < re; p += CHUNK) {
    const long long slot = 2 * (p / CHUNK) + (p + CHUNK >= re ? 1 : 0);
    float v[V];
    ldv<V>(a.part, slot * a.d + c, 0, v);
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = rnd(__fadd_rn(acc[j], v[j]), a.w_dt);
  }
  store_row<V>(a, s_run[2], c, acc);
}

}  // namespace

// unit: the bytes each thread copies (16, 4 or 2; a row is row_bytes)
extern "C" int emb_fwd(const void* ids, const void* w, void* out,
                       long long tokens, long long rows, int row_bytes,
                       int unit, int ids_i64, long long pad, void* stream) {
  if (tokens == 0 || row_bytes == 0) return cudaSuccess;
  const int units = row_bytes / unit;
  const unsigned grid = (unsigned)((tokens * units + 255) / 256);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (unit == 16)
    emb_fwd_kernel<uint4><<<grid, 256, 0, st>>>(
        ids, static_cast<const uint4*>(w), static_cast<uint4*>(out), tokens,
        rows, units, ids_i64, pad);
  else if (unit == 4)
    emb_fwd_kernel<uint32_t><<<grid, 256, 0, st>>>(
        ids, static_cast<const uint32_t*>(w), static_cast<uint32_t*>(out),
        tokens, rows, units, ids_i64, pad);
  else
    emb_fwd_kernel<uint16_t><<<grid, 256, 0, st>>>(
        ids, static_cast<const uint16_t*>(w), static_cast<uint16_t*>(out),
        tokens, rows, units, ids_i64, pad);
  return cudaGetLastError();
}

// sorted, perm: the ids sorted stably and their token indices (int64, n);
// dw zeroed by the caller; part: fp32 scratch of 2 ceil(n / 64) x d
extern "C" int emb_bwd(const long long* sorted, const long long* perm,
                       const void* dy, void* dw, float* part, long long n,
                       long long rows, int d, int dy_dt, int w_dt,
                       long long pad, int vec, void* stream) {
  if (n == 0 || d == 0) return cudaSuccess;
  Bwd a{sorted, perm, dy, dw, part, n, rows, pad, d, dy_dt, w_dt};
  const dim3 grid((unsigned)((n + CHUNK - 1) / CHUNK),
                  (unsigned)((d / vec + THREADS - 1) / THREADS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 8) {
    emb_bwd_piece_kernel<8><<<grid, THREADS, 0, st>>>(a);
    emb_bwd_fold_kernel<8><<<grid, THREADS, 0, st>>>(a);
  } else {
    emb_bwd_piece_kernel<1><<<grid, THREADS, 0, st>>>(a);
    emb_bwd_fold_kernel<1><<<grid, THREADS, 0, st>>>(a);
  }
  return cudaGetLastError();
}
