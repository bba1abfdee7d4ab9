// K11: greedy non-maximum suppression for Hopper (sm_90a). Replaces the
// JAX package's suppression sweep _nms_suppress (paddle_tpu/ops/vision.py:
// 58-76), a lax.fori_loop over the score-sorted candidates that
// multiclass_nms vmaps over classes and images and nms runs once.
//
// Input: boxes (P, k, 4) fp32 xyxy, each of the P problems already in score
// order; the IoU threshold. Output: keep (P, k), one byte a candidate.
// Two launches:
//   (a) nms_mask: mask[p][i][w] holds bit b of word w where j = 64 w + b
//       lies after i (j > i) and iou(box i, box j) > thr. A block of 64
//       threads takes a 64 x 64 tile of one problem, both tiles' boxes
//       staged in shared memory; tiles wholly at j <= i are skipped (their
//       words are never read).
//   (b) nms_sweep: one warp a problem walks i = 0 ... k - 1 in order. Where
//       bit i of `removed` is clear, box i is kept and its row is ORed into
//       `removed` (the words from i's own on). That is the reference's
//       kill = alive_i & (iou[i] > thr) & (idx > i).
// The IoU is the reference's _pairwise_iou (vision.py:40-47) in its order
// of operations, every step rounded on its own (no contracted fma, which
// would move an IoU that lies at the threshold): max / min of the corners,
// clip(., 0), inter = w h, union = (area_a + area_b) - inter, inter /
// (union + 1e-9), and a strict >. NaN propagates through max, min and clip
// as in XLA and PyTorch.
//
// Bound: operations (k (k - 1) / 2 IoUs a problem against 17 bytes a
// candidate), and past that the sweep's k dependent steps, each one load
// of a word and one OR. The design is the simple one: the mask costs
// P k ceil(k / 64) 8 bytes of scratch (82 MB at PP-YOLOE-l's 640 problems
// of 1000), and the sweep's latency is hidden only by running the P
// problems' warps side by side.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TILE = 64;

__device__ __forceinline__ float fmax_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float fmin_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float clip0(float v) { return v < 0.f ? 0.f : v; }

__device__ __forceinline__ float area(const float4 b) {
  return __fmul_rn(clip0(__fsub_rn(b.z, b.x)), clip0(__fsub_rn(b.w, b.y)));
}

__device__ __forceinline__ float iou(const float4 a, const float4 b) {
  const float w = clip0(__fsub_rn(fmin_nan(a.z, b.z), fmax_nan(a.x, b.x)));
  const float h = clip0(__fsub_rn(fmin_nan(a.w, b.w), fmax_nan(a.y, b.y)));
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(area(a), area(b)), inter);
  return __fdiv_rn(inter, __fadd_rn(uni, 1e-9f));
}

// grid (P, words, words): x the problem, y the column tile, z the row tile
__global__ void __launch_bounds__(TILE)
    nms_mask_kernel(const float4* __restrict__ boxes, int k, int words,
                    float thr, unsigned long long* __restrict__ mask) {
  const int p = blockIdx.x, c = blockIdx.y, r = blockIdx.z;
  if (c < r) return;
  __shared__ float4 cols[TILE];
  const float4* bp = boxes + (long long)p * k;
  const int t = threadIdx.x;
  const int j0 = c * TILE, i = r * TILE + t;
  if (j0 + t < k) cols[t] = bp[j0 + t];
  __syncthreads();
  if (i >= k) return;
  const float4 a = bp[i];
  const int n = min(TILE, k - j0);
  unsigned long long bits = 0ull;
  for (int b = 0; b < n; ++b) {
    if (j0 + b > i && iou(a, cols[b]) > thr) bits |= 1ull << b;
  }
  mask[((long long)p * k + i) * words + c] = bits;
}

// one warp a problem; removed[] (words of 64 bits) in shared memory
__global__ void __launch_bounds__(32)
    nms_sweep_kernel(const unsigned long long* __restrict__ mask, int k,
                     int words, unsigned char* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];
  const int p = blockIdx.x, lane = threadIdx.x;
  for (int q = lane; q < words; q += 32) removed[q] = 0ull;
  __syncwarp();
  const unsigned long long* mp = mask + (long long)p * k * words;
  unsigned char* kp = keep + (long long)p * k;
  for (int i = 0; i < k; ++i) {
    const int w = i >> 6;
    const bool alive = !((removed[w] >> (i & 63)) & 1ull);
    __syncwarp();
    if (alive) {
      const unsigned long long* row = mp + (long long)i * words;
      for (int q = w + lane; q < words; q += 32) removed[q] |= row[q];
      __syncwarp();
    }
    if (lane == 0) kp[i] = alive ? 1 : 0;
  }
}

}  // namespace

extern "C" int nms_suppress(const void* boxes, int P, int k, int words,
                            float thr, void* mask, void* keep, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  nms_mask_kernel<<<dim3(P, words, words), TILE, 0, st>>>(
      static_cast<const float4*>(boxes), k, words, thr,
      static_cast<unsigned long long*>(mask));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  nms_sweep_kernel<<<P, 32, words * sizeof(unsigned long long), st>>>(
      static_cast<const unsigned long long*>(mask), k, words,
      static_cast<unsigned char*>(keep));
  return cudaGetLastError();
}
