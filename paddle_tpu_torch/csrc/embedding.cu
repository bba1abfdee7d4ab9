// Embedding lookup and its deterministic backward, for Hopper (sm_90a). The
// port's own kernel: the JAX package gathers rows with jnp.take and leaves
// the gradient's scatter-add to XLA (paddle_tpu/ops/nn_ops.py embedding),
// no pallas_call.
//
// Forward (emb_fwd_kernel): out[t] = weight[ids[t]], and 0 where ids[t] is
// padding_idx (or outside [0, rows)); rows are copied as bits, 16 bytes a
// thread when the rows allow it.
//
// Backward, without atomics on the sums, so every launch (an eager step and
// a captured one alike) gives the same bits. The tokens of one id, in token
// order, form its run; a run is cut into pieces of CHUNK rows from its
// start. The sums accumulate in the weight's dtype, rounding after each add
// (acc = rnd(acc + row)), as the JAX package's scatter-add and autograd's
// CPU index_put do: in fp32 that is the fp32 token-order sum; in bf16 it
// keeps the O2 gradients within the parity bound of the reference, whose
// bf16 scatter-add rounds each add. A piece is summed in token order from
// 0; a run of one piece is its piece's sum, a longer run's pieces are added
// in piece order from 0. Rows that no token hit, the padding row and ids
// outside [0, rows) are 0. Three steps:
// - emb_bwd_hist_kernel, then an emb_bwd_radix_kernel a pass: the tokens
//   sorted by key (id + 1, or 0 for the padding id and ids outside [0,
//   rows)) by a stable LSD radix sort, 8 bits a pass (a pass per byte of
//   rows), over tiles of TILE sorted positions, a CTA a tile: each key goes
//   after the smaller digits and its digit's keys in earlier tiles (read
//   from the pass's digit counts by tile), earlier warps, batches and lanes
//   (a lane's rank among its digit's lanes by ballots). A pass counts the
//   next pass's digits by the tile each key lands in. (One CTA sorting all
//   n took 0.012 ms of ERNIE's 4096 ids and 0.052 of Llama's 24576 on an
//   H100.)
// - emb_bwd_index_kernel (a thread a sorted position): the row pointer,
//   rp[r] = the positions with a key below r + 1, each entry written once,
//   by the position where the keys step past it. No search: row r's run is
//   [rp[r], rp[r + 1]).
// - emb_bwd_table_kernel: every row of the gradient written once, with
//   vector stores. Its first CTAs are windows of WINDOW sorted positions:
//   the segments that start in a window (a run of at most CHUNK rows, or a
//   piece of a longer one), each thread streaming its columns of their dy
//   rows in order through a cp.async ring (RING rows in flight) into the
//   ordered adds, a segment's sum written at its end (a run's row, or the
//   piece's fp32 scratch slot); the CTA that finishes a long run's last
//   piece (a ticket a run, counted atomically) adds its pieces in order
//   into its row. Its other CTAs, ROWS_PER_CTA rows each, write 0 into the
//   rows no token hit.
// So the gradient needs no zero fill; runs of many rows (ERNIE's positions,
// 32 tokens each) load many rows at once, and a skewed table (ERNIE's
// token-type ids, one id for all 4096 rows) is summed by 64 CTAs, not one.
// A piece starts at rs + m CHUNK; its scratch slot is 2 (start / WINDOW) +
// (is the run's last piece): a window (WINDOW <= CHUNK positions) holds
// the start of at most one long run's last piece and one piece of full
// length, so slots never collide (2 ceil(n / WINDOW) rows of fp32
// scratch).
//
// Bound: bytes (forward reads ids and the hit rows and writes out; backward
// reads ids and dy and writes the whole gradient table). The dtype sets of
// the paths (bf16 dy into bf16, fp32 into fp32) are instantiations with
// their codes fixed; any other set reads its codes at run time. Element
// offsets are 64-bit; positions and rows are 32-bit (the wrapper raises
// where they would come near 2^31).

#include <cuda_runtime.h>

#include <cstdint>

#include "fused_io.cuh"

namespace {

constexpr int CHUNK = 64;   // rows of a piece (ops/embedding.py CHUNK)
constexpr int WINDOW = 16;  // sorted positions a window (ops/embedding.py)

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
  const void* ids;   // n ids, int32 or int64 (ids_i64)
  const void* dy;    // (n, d)
  void* dw;          // (rows, d), every element written
  int* keys;         // n: the sorted keys (id + 1; 0 drops the token)
  int* perm;         // n: their tokens
  int* rp;           // rows + 1: row r's run is [rp[r], rp[r + 1])
  int* tickets;      // windows x strips: pieces of a long run done
  int* hist;         // passes x RADIX x tiles: the sort's digit counts
  float* part;       // 2 windows x d slots (first the sort's 2 n ints)
  long long pad;
  int n, rows, d, ids_i64, dy_dt, w_dt, windows, strips, passes, tiles;
};

template <int DY, int W>
struct EmbDt {
  static constexpr int dy = DY, w = W;
};
using EmbBf16 = EmbDt<BF16, BF16>;
using EmbF32 = EmbDt<F32, F32>;
using EmbAny = EmbDt<-1, -1>;

template <class Dt>
bool fits(const Bwd& a) {
  return (Dt::dy < 0 || Dt::dy == a.dy_dt) && (Dt::w < 0 || Dt::w == a.w_dt);
}

// the sort: a stable LSD radix sort of the keys, 8 bits a pass, over tiles
// of TILE sorted positions, a CTA a tile, a warp ITEMS batches of 32 of it
constexpr int RADIX = 256;
constexpr int TILE_WARPS = 4;
constexpr int TILE_THREADS = 32 * TILE_WARPS;
constexpr int ITEMS = 4;
constexpr int TILE = TILE_THREADS * ITEMS;   // ops/embedding.py SORT_TILE

__device__ __forceinline__ int key_of(const Bwd& a, int t) {
  const long long id = load_id(a.ids, t, a.ids_i64);
  return id == a.pad || id < 0 || id >= a.rows ? 0 : (int)id + 1;
}

// the lanes whose digit equals this lane's, among the lanes that hold one
// (ok): one ballot a bit of the digit (__match_any_sync was slower)
__device__ __forceinline__ unsigned peers_of(int dg, bool ok) {
  unsigned peers = __ballot_sync(~0u, ok);
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const unsigned set = __ballot_sync(~0u, (dg >> b) & 1);
    peers &= (dg >> b) & 1 ? set : ~set;
  }
  return peers;
}

// hist[p][g][t]: pass p's count of digit g in tile t
__device__ __forceinline__ int* hist_at(const Bwd& a, int p, int g, int t) {
  return a.hist + ((long long)p * RADIX + g) * a.tiles + t;
}

// tile t: its first pass's digit counts; zero its counts of the second
__global__ void __launch_bounds__(TILE_THREADS) emb_bwd_hist_kernel(Bwd a) {
  __shared__ int cnt[RADIX];
  const int t = blockIdx.x, tid = threadIdx.x;
  for (int g = tid; g < RADIX; g += TILE_THREADS) cnt[g] = 0;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int e = t * TILE + i * TILE_THREADS + tid;
    if (e < a.n) atomicAdd(&cnt[key_of(a, e) & (RADIX - 1)], 1);
  }
  __syncthreads();
  for (int g = tid; g < RADIX; g += TILE_THREADS) {
    *hist_at(a, 0, g, t) = cnt[g];
    if (a.passes > 1) *hist_at(a, 1, g, t) = 0;
  }
}

// pass p over tile t: each key placed after the keys of smaller digits and
// the keys of its digit in earlier tiles, earlier warps, earlier batches
// and lower lanes (a lane's rank among its digit's lanes by ballots), so
// the order within a digit stays the positions' order. The passes
// alternate between keys / perm and part's first 2 n floats (free until
// the windows), the last one landing in keys / perm. Pass p counts the
// next pass's digits by the tile each key lands in, and zeroes its tile's
// counts of the pass after.
__global__ void __launch_bounds__(TILE_THREADS) emb_bwd_radix_kernel(Bwd a,
                                                                     int p) {
  __shared__ int cnt[TILE_WARPS][RADIX];   // counts, then next places
  __shared__ int base[RADIX];
  const int t = blockIdx.x, tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int shift = 8 * p;
  const bool to_out = (a.passes - p) % 2 == 1;
  int* tmp = reinterpret_cast<int*>(a.part);
  const int* src_k = to_out ? tmp : a.keys;
  const int* src_t = to_out ? tmp + a.n : a.perm;
  int* dst_k = to_out ? a.keys : tmp;
  int* dst_t = to_out ? a.perm : tmp + a.n;
  const int e0 = t * TILE + w * 32 * ITEMS + lane;
  int key[ITEMS], tok[ITEMS];
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) {
    const int e = e0 + 32 * u;
    key[u] = e < a.n ? (p == 0 ? key_of(a, e) : src_k[e]) : 0;
    tok[u] = e < a.n ? (p == 0 ? e : src_t[e]) : 0;
  }
  for (int i = tid; i < TILE_WARPS * RADIX; i += TILE_THREADS)
    cnt[i / RADIX][i % RADIX] = 0;
  __syncthreads();
#pragma unroll
  for (int u = 0; u < ITEMS; ++u)
    if (e0 + 32 * u < a.n)
      atomicAdd(&cnt[w][(key[u] >> shift) & (RADIX - 1)], 1);
  // each digit's keys in all tiles (then summed over the smaller digits)
  // and in the tiles before this one
  int before[RADIX / TILE_THREADS];
#pragma unroll
  for (int k = 0; k < RADIX / TILE_THREADS; ++k) {
    const int* h = hist_at(a, p, tid + k * TILE_THREADS, 0);
    int all = 0;
    before[k] = 0;
    for (int i = 0; i < a.tiles; ++i) {
      if (i == t) before[k] = all;
      all += h[i];
    }
    base[tid + k * TILE_THREADS] = all;
  }
  __syncthreads();
  if (w == 0) {   // exclusive scan of base over the digits, 8 a lane
    int v[RADIX / 32], sum = 0;
#pragma unroll
    for (int i = 0; i < RADIX / 32; ++i) {
      v[i] = sum;
      sum += base[lane * (RADIX / 32) + i];
    }
    int inc = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(~0u, inc, o);
      if (lane >= o) inc += x;
    }
#pragma unroll
    for (int i = 0; i < RADIX / 32; ++i)
      base[lane * (RADIX / 32) + i] = inc - sum + v[i];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < RADIX / TILE_THREADS; ++k) {
    const int g = tid + k * TILE_THREADS;
    int at = base[g] + before[k];
    for (int ww = 0; ww < TILE_WARPS; ++ww) {
      const int c = cnt[ww][g];
      cnt[ww][g] = at;
      at += c;
    }
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) {
    const bool ok = e0 + 32 * u < a.n;
    const int dg = (key[u] >> shift) & (RADIX - 1);
    const unsigned peers = peers_of(dg, ok);
    int* c = &cnt[w][dg];
    if (ok) {
      const int at = *c + __popc(peers & below);
      dst_k[at] = key[u];
      dst_t[at] = tok[u];
      if (p + 1 < a.passes)
        atomicAdd(hist_at(a, p + 1, (key[u] >> (shift + 8)) & (RADIX - 1),
                          at / TILE), 1);
    }
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) *c += __popc(peers);
    __syncwarp();
  }
  if (p + 2 < a.passes)
    for (int g = tid; g < RADIX; g += TILE_THREADS)
      *hist_at(a, p + 2, g, t) = 0;
}

// a thread a sorted position k in [0, n]: rp[r] = k for the rows r in
// [keys[k - 1], keys[k]) (keys[-1] = 0, keys[n] = rows + 1), so each row's
// entry is written once; a gap of more than 32 rows by the whole warp (a
// warp writing each row's position by a search among its lanes was 2.7x
// slower at ERNIE's position table on an H100). The first position of each
// window also zeroes its tickets.
__global__ void __launch_bounds__(128) emb_bwd_index_kernel(Bwd a) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  int r0 = 0, r1 = 0;   // rows [r0, r1) get rp = k
  if (k <= a.n) {
    r0 = k == 0 ? 0 : a.keys[k - 1];
    r1 = k == a.n ? a.rows + 1 : a.keys[k];
    if (k < a.n && k % WINDOW == 0)
      for (int y = 0; y < a.strips; ++y)
        a.tickets[(k / WINDOW) * a.strips + y] = 0;
  }
  if (r1 - r0 <= 32)
    for (int r = r0; r < r1; ++r) a.rp[r] = k;
  unsigned wide = __ballot_sync(~0u, r1 - r0 > 32);
  while (wide) {
    const int j = __ffs(wide) - 1;
    wide &= wide - 1;
    const int s0 = __shfl_sync(~0u, r0, j), s1 = __shfl_sync(~0u, r1, j);
    const int kj = __shfl_sync(~0u, k, j);
    for (int r = s0 + lane; r < s1; r += 32) a.rp[r] = kj;
  }
}

constexpr int MAX_THREADS = 256;   // ops/embedding.py MAX_THREADS
constexpr int ROWS_PER_CTA = 16;   // ops/embedding.py ROWS_PER_CTA
constexpr int RING = 16;           // dy rows a window thread has in flight
constexpr int AHEAD = 8;           // rows loaded before their adds (vec 1)
constexpr int NO_END = -0x7fffffff - 1;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// bytes of a window thread's ring slot: V elements of dy (16 for bf16)
template <class Dt>
__host__ __device__ constexpr int slot_bytes() {
  return Dt::dy == BF16 ? 16 : 32;
}

// a thread's V columns of cnt rows of dy, row i at src(i), handed in order
// to use(i, x) as fp32. V = 8: through the thread's RING slots of shared
// memory by cp.async, RING rows in flight (each thread reads only its own
// slots, so no barrier); V = 1: AHEAD rows loaded into registers at a time
template <int V, class Dt, class Src, class Use>
__device__ __forceinline__ void stream_rows(char* ring, int cnt, int dt,
                                            Src src, Use use) {
  if constexpr (V == 8) {
    constexpr int SLOT = slot_bytes<Dt>();
    const int bytes = dt == F32 ? 32 : 16;
    auto slot = [&](int i) {
      return ring + ((i % RING) * (int)blockDim.x + (int)threadIdx.x) * SLOT;
    };
    auto issue = [&](int i) {
      if (i < cnt) {
        const char* g = static_cast<const char*>(src(i));
        cp_async16(slot(i), g);
        if (SLOT == 32 && bytes == 32) cp_async16(slot(i) + 16, g + 16);
      }
      cp_commit();
    };
    for (int i = 0; i < RING; ++i) issue(i);
    for (int i = 0; i < cnt; ++i) {
      cp_wait<RING - 1>();
      float x[V];
      ldv<V>(slot(i), 0, dt, x);
      use(i, x);
      issue(i + RING);
    }
    cp_wait<0>();
  } else {
    for (int i0 = 0; i0 < cnt; i0 += AHEAD) {
      float x[AHEAD][V];
#pragma unroll
      for (int u = 0; u < AHEAD; ++u)
        if (i0 + u < cnt) ldv<V>(src(i0 + u), 0, dt, x[u]);
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        if (i0 + u >= cnt) break;
        use(i0 + u, x[u]);
      }
    }
  }
}

// acc = rnd(acc + x) in fp32, rounded to the weight's dtype w_dt
template <int V>
__device__ __forceinline__ void add_row(float (&acc)[V], const float (&x)[V],
                                        int w_dt) {
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = rnd(__fadd_rn(acc[j], x[j]), w_dt);
}

// V floats of another CTA's scratch, read from L2 (not a stale L1 line)
template <int V>
__device__ __forceinline__ void ld_l2(const float* p, float (&x)[V]) {
  if constexpr (V == 8) {
    const float4 lo = __ldcg(reinterpret_cast<const float4*>(p));
    const float4 hi = __ldcg(reinterpret_cast<const float4*>(p) + 1);
    x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
    x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) x[j] = __ldcg(p + j);
  }
}

// the scratch slot of the piece from p of the long run ending at re
__device__ __forceinline__ long long slot_of(int p, int re) {
  return 2LL * (p / WINDOW) + (p + CHUNK >= re ? 1 : 0);
}

// window win of the table kernel (and a column strip), sorted positions
// [k0, k0 + WINDOW) with k0 = win WINDOW. Its segments (a run of at most
// CHUNK rows, or a piece of a longer run, that starts in the window) are
// the positions [b0, b1), b1 - k0 < WINDOW + CHUNK; a thread streams its
// columns of their dy rows in order, each segment's sum from 0 written at
// its end (a short run's row, or the piece's scratch slot). The CTA that
// completes a long run's last piece adds its pieces in order into its row.
template <int V, class Dt>
__device__ __forceinline__ void window(const Bwd& a, int win) {
  // s_run[q]: the long run [rs, re) of row r whose piece q (1: its last)
  // starts in the window
  __shared__ int s_tok[WINDOW + CHUNK], s_end[WINDOW + CHUNK];
  __shared__ int s_b[2], s_run[2][3], s_fold[2];
  extern __shared__ __align__(16) char ring[];
  const int dy_dt = Dt::dy >= 0 ? Dt::dy : a.dy_dt;
  const int w_dt = Dt::w >= 0 ? Dt::w : a.w_dt;
  const int tid = threadIdx.x, k0 = win * WINDOW;
  const int c = (blockIdx.y * blockDim.x + tid) * V;
  if (tid == 0) {
    s_b[0] = min(k0 + WINDOW, a.n);
    s_b[1] = min(k0 + WINDOW + CHUNK, a.n);
    s_run[0][0] = s_run[1][0] = -1;
  }
  __syncthreads();
  for (int i = tid; i < WINDOW + CHUNK && k0 + i < a.n; i += blockDim.x) {
    const int k = k0 + i, key = a.keys[k];
    s_tok[i] = a.perm[k];
    s_end[i] = NO_END;
    if (key == 0) continue;   // a dropped token
    const int rs = a.rp[key - 1], re = a.rp[key];
    if ((k - rs) % CHUNK == 0) atomicMin(&s_b[i < WINDOW ? 0 : 1], k);
    if (k + 1 != re && (k + 1 - rs) % CHUNK != 0) continue;
    if (re - rs <= CHUNK) {
      s_end[i] = key - 1;   // the row
      continue;
    }
    const int ps = k - (k - rs) % CHUNK, q = ps + CHUNK >= re ? 1 : 0;
    s_end[i] = -1 - q;      // the piece's slot
    if (ps >= k0 && ps < k0 + WINDOW) {
      s_run[q][0] = rs;
      s_run[q][1] = re;
      s_run[q][2] = key - 1;
    }
  }
  __syncthreads();
  const int b0 = s_b[0], b1 = s_b[1];
  if (b0 < k0 + WINDOW && c < a.d) {
    const int esz = dy_dt == F32 ? 4 : 2;
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
    stream_rows<V, Dt>(
        ring, b1 - b0, dy_dt,
        [&](int i) {
          return static_cast<const char*>(a.dy) +
                 ((long long)s_tok[b0 + i - k0] * a.d + c) * esz;
        },
        [&](int i, const float (&x)[V]) {
          add_row<V>(acc, x, w_dt);
          const int end = s_end[b0 + i - k0];
          if (end == NO_END) return;
          if (end >= 0)
            stv<V>(a.dw, (long long)end * a.d + c, w_dt, acc);
          else
            stv<V>(a.part, (2LL * win - 1 - end) * a.d + c, F32, acc);
#pragma unroll
          for (int j = 0; j < V; ++j) acc[j] = 0.f;
        });
  }
  if (s_run[0][0] < 0 && s_run[1][0] < 0) return;
  // a long run's pieces: the last CTA to finish one adds them all
  __threadfence();
  __syncthreads();
  if (tid < 2) {
    s_fold[tid] = 0;
    const int rs = s_run[tid][0], re = s_run[tid][1];
    if (rs >= 0) {
      const int done = atomicAdd(
          &a.tickets[(rs / WINDOW) * a.strips + blockIdx.y], 1);
      s_fold[tid] = done == (re - rs + CHUNK - 1) / CHUNK - 1;
    }
  }
  __syncthreads();
  if (c >= a.d) return;
#pragma unroll 1
  for (int q = 0; q < 2; ++q) {
    if (!s_fold[q]) continue;
    __threadfence();
    const int rs = s_run[q][0], re = s_run[q][1];
    float sum[V];
#pragma unroll
    for (int j = 0; j < V; ++j) sum[j] = 0.f;
    for (int p0 = rs; p0 < re; p0 += AHEAD * CHUNK) {
      float pc[AHEAD][V];
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        const int p = p0 + u * CHUNK;
        if (p < re) ld_l2<V>(a.part + slot_of(p, re) * a.d + c, pc[u]);
      }
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        if (p0 + u * CHUNK >= re) break;
        add_row<V>(sum, pc[u], w_dt);
      }
    }
    stv<V>(a.dw, (long long)s_run[q][2] * a.d + c, w_dt, sum);
  }
}

// rows [t ROWS_PER_CTA, (t + 1) ROWS_PER_CTA) (and a column strip): 0 in
// each that no token hit (the padding row and the rows of dropped ids among
// them); a hit row is its window's
template <int V, class Dt>
__device__ __forceinline__ void zero_rows(const Bwd& a, int t) {
  __shared__ int s_rp[ROWS_PER_CTA + 1];
  const int tid = threadIdx.x, r0 = t * ROWS_PER_CTA;
  if (tid <= ROWS_PER_CTA) s_rp[tid] = a.rp[min(r0 + tid, a.rows)];
  __syncthreads();
  const int c = (blockIdx.y * blockDim.x + tid) * V;
  if (c >= a.d) return;
  const int w_dt = Dt::w >= 0 ? Dt::w : a.w_dt;
  float z[V];
#pragma unroll
  for (int j = 0; j < V; ++j) z[j] = 0.f;
  const int nr = min(ROWS_PER_CTA, a.rows - r0);
  for (int i = 0; i < nr; ++i)
    if (s_rp[i] == s_rp[i + 1])
      stv<V>(a.dw, (long long)(r0 + i) * a.d + c, w_dt, z);
}

// grid (windows + ceil(rows / ROWS_PER_CTA), column strips): the windows'
// CTAs first, then the zero rows'. In one launch the zero rows' stores hide
// the windows' chains of loads; launched after the windows, they waited
// for them (3-21% slower on an H100).
template <int V, class Dt>
__global__ void __launch_bounds__(MAX_THREADS) emb_bwd_table_kernel(Bwd a) {
  if ((int)blockIdx.x < a.windows)
    window<V, Dt>(a, blockIdx.x);
  else
    zero_rows<V, Dt>(a, blockIdx.x - a.windows);
}

template <int V, class Dt>
cudaError_t launch_table(const Bwd& a, int threads, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      emb_bwd_table_kernel<V, Dt>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      RING * MAX_THREADS * slot_bytes<Dt>());
  if (attr != cudaSuccess) return attr;
  const unsigned ctas =
      (unsigned)(a.windows + (a.rows + ROWS_PER_CTA - 1) / ROWS_PER_CTA);
  emb_bwd_table_kernel<V, Dt>
      <<<dim3(ctas, (unsigned)a.strips), threads,
         V == 8 ? RING * threads * slot_bytes<Dt>() : 0, st>>>(a);
  return cudaGetLastError();
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

// ids: n ids (int32, or int64 where ids_i64); dy: (n, d); dw: (rows, d),
// written whole; idx: int32 scratch of 2 n + rows + 1 + windows x strips +
// passes x 256 x ceil(n / 512); part: fp32 scratch of max(2 windows x d,
// 2 n); threads, strips: the table kernel's CTA width and column strips
// (ops/embedding.py launch_plan)
extern "C" int emb_bwd(const void* ids, const void* dy, void* dw, int* idx,
                       float* part, int n, int rows, int d, int ids_i64,
                       int dy_dt, int w_dt, long long pad, int vec,
                       int threads, int strips, void* stream) {
  if (rows == 0 || d == 0) return cudaSuccess;
  const int windows = (n + WINDOW - 1) / WINDOW;
  int passes = 0;
  for (unsigned m = (unsigned)rows; m; m >>= 8) ++passes;
  int* tickets = idx + 2LL * n + rows + 1;
  Bwd a{ids,     dy,    dw,   idx,   idx + n, idx + 2LL * n, tickets,
        tickets + (long long)windows * strips, part, pad, n, rows, d,
        ids_i64, dy_dt, w_dt, windows, strips, passes,
        (n + TILE - 1) / TILE};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    emb_bwd_hist_kernel<<<(unsigned)a.tiles, TILE_THREADS, 0, st>>>(a);
    for (int p = 0; p < passes; ++p)
      emb_bwd_radix_kernel<<<(unsigned)a.tiles, TILE_THREADS, 0, st>>>(a, p);
  }
  emb_bwd_index_kernel<<<(unsigned)(n / 128 + 1), 128, 0, st>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (vec == 8 && fits<EmbBf16>(a))
    return launch_table<8, EmbBf16>(a, threads, st);
  if (vec == 8 && fits<EmbF32>(a))
    return launch_table<8, EmbF32>(a, threads, st);
  if (vec == 8) return launch_table<8, EmbAny>(a, threads, st);
  return launch_table<1, EmbAny>(a, threads, st);
}
