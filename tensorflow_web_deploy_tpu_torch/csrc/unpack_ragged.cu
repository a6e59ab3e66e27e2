// Ragged byte arena + meta table -> padded canvases, in one launch.
//
// Replaces the JAX package's ops/image.py::unpack_ragged, which is not a
// Pallas kernel: XLA compiles it as a masked gather with static shapes
// (one int32 index per canvas byte, clipped, then a select). The ragged wire
// ships each image's h*w*3 bytes tight, back to back, and an int32 meta
// table of (byte_offset, h, w, valid) per image; this kernel rebuilds the
// [K, S, S, 3] uint8 canvases the classic wire would have shipped
// (bit-identical to the host's pad_to_canvas) and the [K, 2] int32 valid
// sizes, (1, 1) for a hole.
//
// What bounds it on an H100: bytes. It reads each image's bytes once and
// writes every canvas byte once, no arithmetic to speak of; at batch 8 of
// the 512 canvas that is ~9 MB, 2.8 us at 3.35 TB/s. The gather form would
// materialise an index per canvas byte (at batch 32 of the 2048 canvas, a
// 3.2 GB int64 index on the torch side); this kernel needs no temporaries.
//
// Design: one block per (canvas row, image). The block reads its meta row,
// then writes the canvas row as 32-bit words: a word left of the image's
// width is assembled from the two aligned source words it straddles
// (__funnelshift_r; the arena may start an image row at any byte), a word
// right of it, and every word of a row below the image or of a hole, is
// zero. So the zero fill comes from the meta table, never from what the
// arena holds: stale bytes of an earlier batch cannot leak. A row that does
// not fit the canvas or the arena is written as a hole; callers validate
// rows on the host and raise before the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// meta row: byte offset into the arena, valid h, valid w, valid flag
struct Row {
  long long off;
  int h, w;
  bool valid;
};

__device__ __forceinline__ Row read_row(const int32_t* __restrict__ meta, int k, int s,
                                        long long arena_bytes) {
  const int32_t* m = meta + 4 * k;
  Row r{m[0], m[1], m[2], m[3] > 0};
  r.valid = r.valid && r.h > 0 && r.h <= s && r.w > 0 && r.w <= s && r.off >= 0 &&
            r.off + (long long)r.h * r.w * 3 <= arena_bytes;
  return r;
}

// row_bytes % 4 == 0 and the canvases 4-byte aligned: 32-bit stores, and
// 32-bit loads from the arena (itself 4-byte aligned) wherever the aligned
// words lie inside it.
__global__ void unpack_words(const uint8_t* __restrict__ arena, long long arena_bytes,
                             const int32_t* __restrict__ meta, uint8_t* __restrict__ canvases,
                             int32_t* __restrict__ hws, int s) {
  const int y = blockIdx.x, k = blockIdx.y;
  const Row r = read_row(meta, k, s, arena_bytes);
  if (y == 0 && threadIdx.x == 0) {
    hws[2 * k] = r.valid ? r.h : 1;
    hws[2 * k + 1] = r.valid ? r.w : 1;
  }
  const int row_words = s * 3 / 4;
  const int wb = (r.valid && y < r.h) ? r.w * 3 : 0;  // image bytes in this canvas row
  const long long start = r.off + (long long)y * r.w * 3;
  const int mis = (int)(start & 3);
  const uint32_t* src = reinterpret_cast<const uint32_t*>(arena + (start - mis));
  uint32_t* dst = reinterpret_cast<uint32_t*>(canvases + ((long long)k * s + y) * s * 3);
  for (int j = threadIdx.x; j < row_words; j += blockDim.x) {
    const int x = 4 * j;
    uint32_t v = 0;
    if (x < wb) {
      // the aligned words holding bytes [x, x + 4) of the image row
      if (start - mis + 4LL * j + (mis ? 8 : 4) <= arena_bytes) {
        const uint32_t lo = __ldg(src + j);
        v = mis ? __funnelshift_r(lo, __ldg(src + j + 1), 8 * mis) : lo;
      } else {  // at the arena's end: byte by byte
        const uint8_t* b = arena + start + x;
        for (int i = 0; i < 4 && x + i < wb; ++i) v |= (uint32_t)__ldg(b + i) << (8 * i);
      }
      if (wb - x < 4) v &= (1u << (8 * (wb - x))) - 1u;  // the image's bytes only
    }
    dst[j] = v;
  }
}

// any canvas side: byte stores
__global__ void unpack_bytes(const uint8_t* __restrict__ arena, long long arena_bytes,
                             const int32_t* __restrict__ meta, uint8_t* __restrict__ canvases,
                             int32_t* __restrict__ hws, int s) {
  const int y = blockIdx.x, k = blockIdx.y;
  const Row r = read_row(meta, k, s, arena_bytes);
  if (y == 0 && threadIdx.x == 0) {
    hws[2 * k] = r.valid ? r.h : 1;
    hws[2 * k + 1] = r.valid ? r.w : 1;
  }
  const int wb = (r.valid && y < r.h) ? r.w * 3 : 0;
  const uint8_t* src = arena + r.off + (long long)y * r.w * 3;
  uint8_t* dst = canvases + ((long long)k * s + y) * s * 3;
  for (int x = threadIdx.x; x < s * 3; x += blockDim.x) dst[x] = x < wb ? __ldg(src + x) : 0;
}

constexpr int kMaxThreads = 256;

}  // namespace

// arena: uint8 [arena_bytes], 4-byte aligned; meta: int32 [batch, 4] rows
// (byte_offset, h, w, valid); canvases: uint8 [batch, s, s, 3]; hws: int32
// [batch, 2]. One block per (canvas row, image), at most 65535 images.
// Launches on `stream` and returns cudaGetLastError(), or an error code for
// arguments it refuses.
extern "C" int twd_unpack_ragged(const uint8_t* arena, long long arena_bytes,
                                 const int32_t* meta, uint8_t* canvases, int32_t* hws, int batch,
                                 int s, cudaStream_t stream) {
  if (batch < 0 || batch > 65535 || s < 1 || arena_bytes < 0 ||
      (reinterpret_cast<uintptr_t>(arena) & 3))
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const int row_bytes = s * 3;
  const bool words = row_bytes % 4 == 0 && (reinterpret_cast<uintptr_t>(canvases) & 3) == 0;
  const int units = words ? row_bytes / 4 : row_bytes;
  const int threads = units >= kMaxThreads ? kMaxThreads : ((units + 31) / 32) * 32;
  const dim3 grid((unsigned)s, (unsigned)batch);
  if (words)
    unpack_words<<<grid, threads, 0, stream>>>(arena, arena_bytes, meta, canvases, hws, s);
  else
    unpack_bytes<<<grid, threads, 0, stream>>>(arena, arena_bytes, meta, canvases, hws, s);
  return (int)cudaGetLastError();
}
