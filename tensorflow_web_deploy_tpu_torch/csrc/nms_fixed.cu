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
// outside the tensor cores). The walk itself is K dependent steps a row.
//
// Design: one block per row, 4 warps. The block stages its row's boxes,
// areas and the candidate bits (score > score threshold, one __ballot_sync
// per 32 candidates) in shared memory, then builds the upper triangle of
// the K x K "i suppresses j" bitmask there: each warp takes rows i in turn,
// and for each 32-column word from i's own on, each lane tests one j > i
// and __ballot_sync packs the word (words left of i's are never read). The
// test is the reference's, operation for operation: inter and union formed
// as _inter_union forms them, max and min propagating NaN as
// torch.maximum and jnp.maximum do (PTX max.NaN / min.NaN), then
// inter > thr * union, each operation rounded on its own (built with
// -fmad=false). Then warp 0 walks i = 0 .. K-1 in order, lane w holding
// word w of the suppressed and the kept sets: i is kept when it is a
// candidate and no kept box has suppressed it, and a kept i ORs its row
// in. The kept bits are written out as bytes at the end.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 256;  // ops/detection.py MAX_CANDIDATES
constexpr int kWords = kMaxK / 32;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
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

__global__ void __launch_bounds__(kThreads)
nms_fixed_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
                 uint8_t* __restrict__ keep, int k, float iou_thr, float score_thr) {
  __shared__ float4 box[kMaxK];
  __shared__ float area[kMaxK];
  __shared__ uint32_t cand[kWords];
  __shared__ uint32_t mask[kMaxK * kWords];
  const long long row = blockIdx.x;
  const int words = (k + 31) / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < words * 32; i += kThreads) {
    bool is_cand = false;
    if (i < k) {
      const float4 b = boxes[row * k + i];
      box[i] = b;
      area[i] = max_nan(b.z - b.x, 0.0f) * max_nan(b.w - b.y, 0.0f);
      is_cand = scores[row * k + i] > score_thr;
    }
    const uint32_t bits = __ballot_sync(kFull, is_cand);
    if (lane == 0) cand[i / 32] = bits;
  }
  __syncthreads();
  for (int i = warp; i < k; i += kWarps) {
    const float4 a = box[i];
    const float area_i = area[i];
    for (int w = i / 32; w < words; ++w) {
      const int j = 32 * w + lane;
      bool suppresses = false;
      if (j > i && j < k) {
        const float4 b = box[j];
        const float h = max_nan(min_nan(a.z, b.z) - max_nan(a.x, b.x), 0.0f);
        const float wd = max_nan(min_nan(a.w, b.w) - max_nan(a.y, b.y), 0.0f);
        const float inter = h * wd;
        const float uni = (area_i + area[j]) - inter;
        suppresses = inter > iou_thr * uni;
      }
      const uint32_t bits = __ballot_sync(kFull, suppresses);
      if (lane == 0) mask[i * words + w] = bits;
    }
  }
  __syncthreads();
  if (warp != 0) return;
  const uint32_t my_cand = lane < words ? cand[lane] : 0u;
  uint32_t removed = 0, kept = 0;  // lane w: word w of each set
  for (int i = 0; i < k; ++i) {
    const int w = i / 32;
    const uint32_t open = __shfl_sync(kFull, my_cand & ~removed, w);
    if ((open >> (i % 32)) & 1u) {  // uniform across the warp
      if (lane == w) kept |= 1u << (i % 32);
      if (lane >= w && lane < words) removed |= mask[i * words + lane];
    }
  }
  for (int w = 0; w < words; ++w) {  // every lane takes part in each shuffle
    const uint32_t word = __shfl_sync(kFull, kept, w);
    const int j = 32 * w + lane;
    if (j < k) keep[row * k + j] = (word >> lane) & 1u;
  }
}

}  // namespace

// boxes: float32 [rows, k, 4], 16-byte aligned; scores: float32 [rows, k];
// keep: uint8 [rows, k]. One block per row, k <= 256. Launches on `stream`
// and returns cudaGetLastError(), or an error code for arguments it refuses.
extern "C" int twd_nms_fixed(const float* boxes, const float* scores, uint8_t* keep, int rows,
                             int k, float iou_thr, float score_thr, cudaStream_t stream) {
  if (rows < 0 || k < 0 || k > kMaxK || (reinterpret_cast<uintptr_t>(boxes) & 15))
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || k == 0) return 0;
  nms_fixed_kernel<<<(unsigned)rows, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(boxes), scores, keep, k, iou_thr, score_thr);
  return (int)cudaGetLastError();
}
