// Greedy NMS per (image, class) row over candidates in priority order.
//
// Replaces the JAX package's ops/detection.py::nms_fixed, which is not a
// Pallas kernel: XLA runs it as a parallel fixpoint (keep <- cand and no
// higher-priority kept overlapper) under lax.while_loop, vmapped over
// (image, class). In torch the loop's test reads a device bool on the host,
// which a CUDA graph cannot capture, and unrolled to its bound of K passes
// it would read the [rows, K, K] mask K times (~8.6 GB at batch 32, 90
// classes, K = 100). The fixpoint's result is the greedy walk in priority
// order (the reference's docstring argues it), which is what this kernel
// computes, in one launch for a whole batch.
//
// Input: boxes float32 [rows, K, 4] (ymin, xmin, ymax, xmax), 16-byte
// aligned, and scores float32 [rows, K], each row already in priority
// order (scores non-increasing, ties by position: the stable descending
// sort the caller selects with). So "i has priority over j" is i < j.
// Output: keep uint8 [rows, K].
//
// What bounds it on an H100: operations. Per row it reads K boxes and
// scores (20 bytes each) and writes K bytes, and tests K(K-1)/2 pairs at
// ~13 float32 operations each; at batch 32, 90 classes and K = 100 that is
// 6.0 MB (1.8 us at 3.35 TB/s) against 185 MFLOP (2.8 us at 67 TFLOP/s
// outside the tensor cores). A warp issues ~16 instructions a pair test.
//
// Design: one warp per row, kWarps rows per block, each warp on its own
// slice of shared memory, so every warp both tests and walks and no warp
// waits on another; a template instance
// per number of 32-candidate words W = ceil(K / 32), so every per-word
// array is in registers.
//   - Stage: the warp copies its row's boxes and areas into shared memory
//     and ballots the candidate words (score > score threshold).
//   - Pair tests: lane l owns the rows i = 32u + l, one in each word u, with
//     their boxes in registers, and builds their suppression words m[u][w]
//     (bit t: i suppresses j = 32w + t) in registers. The warp walks the
//     columns j once, every lane reading the same box j (a shared-memory
//     broadcast), and tests only the words at or right of each row's own:
//     the upper triangle, without a ballot per test.
//   - Walk, word by word, every value the same in all lanes: a word's open
//     candidates are those no kept box of an earlier word suppressed (those
//     words' kept rows ORed into `done` with one __reduce_or_sync a word).
//     Within the word the greedy result is the unique fixpoint of keep <-
//     open and no kept box before it overlaps: priority is a strict order,
//     so the suppression graph is acyclic, and each pass (one
//     __reduce_or_sync of the kept lanes' in-word rows) settles one more
//     level of it. A row of few suppressions settles in two or three passes
//     a word, where a walk from kept box to kept box with __ffs takes a step
//     per kept box, and on the served rows nearly every candidate is kept.
// The test is the reference's, operation for operation: inter and union
// formed as _inter_union forms them, max and min propagating NaN as
// torch.maximum and jnp.maximum do (PTX max.NaN / min.NaN), then inter >
// thr * union, each operation rounded on its own (built with -fmad=false).
// The kept bits are written out as bytes at the end.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 256;  // ops/detection.py MAX_CANDIDATES
constexpr int kWarps = 4;  // rows (warps) per block: 4 rows of 256 candidates take 20 KB
constexpr unsigned kFull = 0xffffffffu;

// max and min that return NaN when either operand is NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Does a (higher priority, area aa) suppress b (area ab)? The reference's
// test: inter > thr * ((aa + ab) - inter).
__device__ __forceinline__ bool suppresses(float4 a, float aa, float4 b, float ab, float thr) {
  const float h = max_nan(min_nan(a.z, b.z) - max_nan(a.x, b.x), 0.0f);
  const float wd = max_nan(min_nan(a.w, b.w) - max_nan(a.y, b.y), 0.0f);
  const float inter = h * wd;
  const float uni = (aa + ab) - inter;
  return inter > thr * uni;
}

// Shared memory of one warp for rows of k candidates: the boxes and the
// areas, padded to whole 32-candidate words.
__host__ __device__ constexpr int warp_bytes(int k) { return ((k + 31) / 32) * 32 * 20; }

template <int W>
__global__ void __launch_bounds__(kWarps * 32)
nms_fixed_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
                 uint8_t* __restrict__ keep, int rows, int k, float iou_thr, float score_thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= rows) return;  // the whole warp: nothing below is shared across warps
  float4* box = reinterpret_cast<float4*>(smem + warp * (32 * W * 20));
  float* area = reinterpret_cast<float*>(box + 32 * W);

  // Stage the row; past k, zero boxes that are never candidates.
  uint32_t cand[W];  // the candidate set, word by word (the same in every lane)
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int j = 32 * w + lane;
    float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    bool is_cand = false;
    if (j < k) {
      b = boxes[row * k + j];
      is_cand = scores[row * k + j] > score_thr;
    }
    box[j] = b;
    area[j] = max_nan(b.z - b.x, 0.0f) * max_nan(b.w - b.y, 0.0f);
    cand[w] = __ballot_sync(kFull, is_cand);
  }
  __syncwarp();

  // The pair tests: lane l owns the rows i = 32u + l, one in each word u,
  // and builds their suppression words m[u][w] (bit t: i suppresses 32w +
  // t) in registers; every lane reads the same box j at a time, so the
  // warp walks the columns once and tests only words at or right of each
  // row's own.
  float4 bi[W];
  float ai[W];
  uint32_t m[W][W];
#pragma unroll
  for (int u = 0; u < W; ++u) {
    bi[u] = box[32 * u + lane];
    ai[u] = area[32 * u + lane];
#pragma unroll
    for (int w = u; w < W; ++w) m[u][w] = 0u;
  }
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int n = min(32, k - 32 * w);
    for (int t = 0; t < n; ++t) {
      const float4 bj = box[32 * w + t];
      const float aj = area[32 * w + t];
#pragma unroll
      for (int u = 0; u <= w; ++u)
        m[u][w] |= (uint32_t)suppresses(bi[u], ai[u], bj, aj, iou_thr) << t;
    }
  }
  // in a row's own word, only the boxes after it
#pragma unroll
  for (int u = 0; u < W; ++u) m[u][u] &= lane == 31 ? 0u : ~0u << (lane + 1);

  // The walk, word by word: a word's kept set is decided from the kept
  // boxes of the words before it (folded into `done`) and its own.
  uint32_t done[W], kept[W];
#pragma unroll
  for (int w = 0; w < W; ++w) done[w] = 0u;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint32_t open = cand[w] & ~done[w];
    uint32_t kw = open;
    for (;;) {  // the in-word fixpoint: at most 32 passes
      const uint32_t sup = __reduce_or_sync(kFull, (kw >> lane) & 1u ? m[w][w] : 0u);
      const uint32_t next = open & ~sup;
      if (next == kw) break;
      kw = next;
    }
    kept[w] = kw;
#pragma unroll
    for (int v = w + 1; v < W; ++v)
      done[v] |= __reduce_or_sync(kFull, (kw >> lane) & 1u ? m[w][v] : 0u);
  }
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int j = 32 * w + lane;
    if (j < k) keep[row * k + j] = (kept[w] >> lane) & 1u;
  }
}

void launch_words(int words, unsigned blocks, int smem, cudaStream_t stream,
                  const float4* boxes, const float* scores, uint8_t* keep, int rows, int k,
                  float iou_thr, float score_thr) {
  switch (words) {
#define TWD_NMS_CASE(W)                                                                  \
  case W:                                                                                \
    nms_fixed_kernel<W><<<blocks, kWarps * 32, smem, stream>>>(boxes, scores, keep, rows, k, \
                                                               iou_thr, score_thr);        \
    break;
    TWD_NMS_CASE(1)
    TWD_NMS_CASE(2)
    TWD_NMS_CASE(3)
    TWD_NMS_CASE(4)
    TWD_NMS_CASE(5)
    TWD_NMS_CASE(6)
    TWD_NMS_CASE(7)
    TWD_NMS_CASE(8)
#undef TWD_NMS_CASE
  }
}

}  // namespace

// boxes: float32 [rows, k, 4], 16-byte aligned; scores: float32 [rows, k];
// keep: uint8 [rows, k]. One warp per row, k <= 256. Launches on `stream`
// and returns cudaGetLastError(), or an error code for arguments it refuses.
extern "C" int twd_nms_fixed(const float* boxes, const float* scores, uint8_t* keep, int rows,
                             int k, float iou_thr, float score_thr, cudaStream_t stream) {
  if (rows < 0 || k < 0 || k > kMaxK || (reinterpret_cast<uintptr_t>(boxes) & 15))
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || k == 0) return 0;
  launch_words((k + 31) / 32, (unsigned)((rows + kWarps - 1) / kWarps), kWarps * warp_bytes(k),
               stream, reinterpret_cast<const float4*>(boxes), scores, keep, rows, k, iou_thr,
               score_thr);
  return (int)cudaGetLastError();
}
