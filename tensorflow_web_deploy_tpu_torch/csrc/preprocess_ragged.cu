// Ragged rgb preprocess for Hopper (sm_90a): the ragged byte arena + its
// int32 meta table → bilinear resize from each image's valid (h, w) region
// → normalize, stored NHWC in float32 or bf16, in one launch.
//
// Replaces three steps of the JAX package, none of them a Pallas kernel:
// ops/image.py::unpack_ragged (an XLA masked gather that rebuilds padded
// canvases), the rgb matmul resize (ops/image.py::_bilinear_matrix and
// resize_from_valid_mm, two float32 GEMMs over the whole canvas) and the
// normalize of ops/image.py::make_preprocess_fn, with the cast to the
// serving dtype after it. It computes the same function as
//   make_preprocess_fn(out_h, out_w, mode, "rgb", "matmul", out_dtype)(
//       *unpack_ragged_plain(arena, meta, s))
// without the canvas: the resize's taps are clamped into each image's
// valid region (ops/image.py::_dynamic_axis_coords), so no pad byte is ever
// read, and each tap reads the arena at the image's byte offset. Every row
// of a sampling matrix has two non-zero taps, so the taps are gathered
// instead of multiplied (the plan of csrc/preprocess_i420.cu).
//
// Bound: memory. Per image it must read the valid bytes of each distinct
// tap row (at most h·w·3, fewer on a downscale) and write out_h·out_w·3
// elements; ~40 float32 operations per output pixel are far below the
// card's float32 rate.
//
// Design:
//   - a block of kThreads threads owns one image × a band of `rows` (≤ 32)
//     whole output rows; grid (bands, images). The band height comes from
//     the shapes alone: ops/preprocess_ragged.py::launch_shape;
//   - the block reads its meta row on the device (so a CUDA graph captures
//     the launch); a hole (valid 0) or a row that does not fit the canvas or
//     the arena is a zero 1 × 1 image, as the plain version's hole, and
//     reads nothing from the arena;
//   - warp 0 computes the band's row taps and finds its distinct source
//     rows with two ballots: each distinct row is staged once;
//   - each distinct row's w·3 bytes are copied into shared memory with
//     16-byte cp.async straight from the arena. An image row starts at any
//     byte, so each copy starts at the 16-byte boundary at or below its
//     row's start, and the row's offset is kept with its slot. While the
//     copies fly, the block computes the column taps (byte offsets and
//     weights, 16 bytes an output column) into shared memory;
//   - each thread computes pixels of the band from shared memory, rows
//     first, then columns, in float32 (see Numerics), and writes their channels into a
//     staging buffer laid out at the same address mod 16 as the band in
//     device memory; the band, rows·out_w·3 contiguous NHWC elements, goes
//     out with 16-byte stores, its unaligned head and tail 2 bytes at a
//     time.
//
// Numerics: the plain version's two matmuls run on the card as float32
// GEMMs, which accumulate an output in order of the contraction index with
// fused multiply-adds, from zero: along an axis, the lo tap's product
// rounded, then the hi tap's fused into it (zero taps add nothing). The
// kernel does exactly that, rows first, then columns, with explicit
// __fmaf_rn, and is built with -fmad=false so that nvcc contracts nothing
// else: a tap coordinate divides first, as the plain version's does, and
// every other multiply and add rounds on its own. So on the card it equals
// the plain version bit for bit (chip_smoke.py, ragged_preprocess); rounding
// both taps before the add instead left float32 ulps that near zero (caffe's
// v - mean, inception's v / 127.5 - 1) became many bf16 ulps. Where
// the two taps of an axis coincide at the clamp edge, their weights add
// first, as _bilinear_matrix adds them, and the second weight is zero. The
// normalize divides exactly (div_exact). The caffe mode flips RGB to BGR and
// subtracts the float32 means. The bf16 store rounds the float32 result to
// nearest even, as torch's cast does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 32;  // output rows per band: warp 0 holds one each
constexpr int kThreads = 128;  // per block
constexpr int kMaxSide = 8192;
// dynamic shared memory a block may ask for: sm_90's 227 KB less room for
// the kernel's static arrays
constexpr int kMaxDynamicSmem = 224 * 1024;

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// A block's dynamic shared memory, in bytes from its start. The wrapper's
// LaunchShape.smem (ops/preprocess_ragged.py) computes the same sum.
struct Layout {
  int staged, band, total;  // region offsets; the column taps at 0
  int pitch;                // bytes per staged row
  __host__ __device__ Layout(int s, int out_w, int rows, int elt) {
    pitch = align16(3 * s + 15);  // a row's valid bytes and up to 15 before it
    staged = align16(16 * out_w);
    band = staged + 2 * rows * pitch;  // a band of r rows has at most 2r distinct taps
    total = band + align16(rows * out_w * 3 * elt + 16);
  }
};

// One output column's taps: byte offsets of source columns lo and hi in a
// staged row, and their weights.
struct __align__(16) ColTap {
  int lo, hi;
  float wa, wb;
};

// Bilinear tap along one axis for output index i (half-pixel centers).
// `valid` is the dynamic extent, `total` the canvas side. Same formula as
// ops/image.py::_dynamic_axis_coords: the divide comes first.
struct Tap {
  int lo, hi;
  float frac;
};

__device__ __forceinline__ Tap axis_tap(int i, int out_size, int valid, int total) {
  const float in_f = (float)valid;
  float c = ((float)i + 0.5f) * (in_f / (float)out_size) - 0.5f;
  c = fminf(fmaxf(c, 0.0f), in_f - 1.0f);
  const float lo = floorf(c);
  const float hi = fminf(fminf(lo + 1.0f, in_f - 1.0f), (float)(total - 1));
  return Tap{(int)lo, (int)hi, c - lo};
}

// The two weights of a tap as _bilinear_matrix forms them: 1 - frac at lo
// and frac at hi; where lo == hi, both on lo, added.
__device__ __forceinline__ float2 tap_weights(const Tap& t) {
  const float a = 1.0f - t.frac;
  return t.lo == t.hi ? make_float2(a + t.frac, 0.0f) : make_float2(a, t.frac);
}

// Slots of a band's distinct source rows, on warp 0 (as in
// csrc/preprocess_i420.cu). Lane r holds the taps (lo, hi) of band row r
// when `act`. Both sequences are nondecreasing and hi - lo is 0 or 1, so
// in the order lo_0, hi_0, lo_1, hi_1, ... a row is either new and above
// every row before it, or one of the last two distinct rows: lo_r is new
// iff lo_r > hi_(r-1), hi_r iff hi_r > max(lo_r, hi_(r-1)), and a lo_r
// below hi_(r-1) is lo_(r-1), the distinct row before the last. A slot is
// the count of new rows up to its position, less one; each new row is
// written to list[slot]. Returns the number of distinct rows.
__device__ __forceinline__ int band_slots(int lo, int hi, bool act, int lane, int* list,
                                          int& slot_lo, int& slot_hi) {
  int prev_hi = __shfl_up_sync(0xffffffffu, hi, 1);
  if (lane == 0) prev_hi = -1;
  const bool new_lo = act && lo > prev_hi;
  const bool new_hi = act && hi > max(lo, prev_hi);
  const unsigned bl = __ballot_sync(0xffffffffu, new_lo);
  const unsigned bh = __ballot_sync(0xffffffffu, new_hi);
  const unsigned upto = 0xffffffffu >> (31 - lane);  // lanes 0..lane
  const unsigned before = upto >> 1;                 // lanes 0..lane-1
  slot_lo = __popc(bl & upto) + __popc(bh & before) - 1 - (lo < prev_hi ? 1 : 0);
  slot_hi = __popc(bl & upto) + __popc(bh & upto) - 1;
  if (new_lo) list[slot_lo] = lo;
  if (new_hi) list[slot_hi] = hi;
  return __popc(bl) + __popc(bh);
}

// 16 bytes global -> shared, bypassing L1; both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem, uintptr_t gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

// A staged byte as a float, exactly, without a conversion instruction:
// 2^23 + b is the float with b in its low mantissa bits, less 2^23.
__device__ __forceinline__ float byte_f(const unsigned char* p) {
  return __uint_as_float(0x4B000000u | *p) - 8388608.0f;
}

// x / d correctly rounded, for the normalize's divisors d (127.5, 255) and
// r = 1 / d rounded: the reciprocal product corrected by its exact residual
// (Markstein), as in csrc/preprocess_i420.cu; tiny x take the IEEE division.
__device__ __forceinline__ float div_exact(float x, float d, float r) {
  if (x != 0.0f && x < 0x1p-64f) return x / d;
  const float q = __fmul_rn(x, r);
  const float e = __fmaf_rn(-d, q, x);
  return __fmaf_rn(e, r, q);
}

// Three channels of one pixel into the staging band at `o`, two of them as
// one paired store: the first two when `o` is aligned for it, else the last
// two. Each value rounds to nearest even.
__device__ __forceinline__ void store3(float* o, const float v[3], bool first_pair) {
  if (first_pair) {
    *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
    o[2] = v[2];
  } else {
    o[0] = v[0];
    *reinterpret_cast<float2*>(o + 1) = make_float2(v[1], v[2]);
  }
}
__device__ __forceinline__ void store3(__nv_bfloat16* o, const float v[3], bool first_pair) {
  if (first_pair) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v[0], v[1]);
    o[2] = __float2bfloat16_rn(v[2]);
  } else {
    o[0] = __float2bfloat16_rn(v[0]);
    *reinterpret_cast<__nv_bfloat162*>(o + 1) = __floats2bfloat162_rn(v[1], v[2]);
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
    preprocess_ragged_kernel(const uint8_t* __restrict__ arena, long long arena_bytes,
                             const int32_t* __restrict__ meta, OutT* __restrict__ out, int s,
                             int out_h, int out_w, int mode, int band_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_list[2 * kMaxRows];  // the band's distinct source rows
  __shared__ int s_count;
  // per band row: shared-memory offsets of its two source rows, their weights
  __shared__ int s_off[2][kMaxRows];
  __shared__ float s_w[2][kMaxRows];

  const Layout L(s, out_w, band_rows, (int)sizeof(OutT));
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * band_rows;
  const int rows = min(band_rows, out_h - i0);

  // The meta row; one that does not fit the canvas or the arena is a hole
  // (the engine checks rows on the host before the launch).
  const int32_t* m = meta + 4 * b;
  const long long off = m[0];
  int h = m[1], w = m[2];
  const bool valid = m[3] > 0 && h > 0 && h <= s && w > 0 && w <= s && off >= 0 &&
                     off + (long long)h * w * 3 <= arena_bytes;
  if (!valid) h = w = 1;
  const uintptr_t base = reinterpret_cast<uintptr_t>(arena) + (valid ? off : 0);
  const long long row_bytes = 3LL * w;

  if (tid < 32) {
    const bool act = tid < rows;
    const Tap t = act ? axis_tap(i0 + tid, out_h, h, s) : Tap{0, 0, 0.0f};
    int slot_lo, slot_hi;
    const int n = band_slots(t.lo, t.hi, act, tid, s_list, slot_lo, slot_hi);
    if (act) {
      // a staged row sits at its slot, offset by its start's address mod 16
      s_off[0][tid] = L.staged + slot_lo * L.pitch + (int)((base + t.lo * row_bytes) & 15);
      s_off[1][tid] = L.staged + slot_hi * L.pitch + (int)((base + t.hi * row_bytes) & 15);
      const float2 wt = tap_weights(t);
      s_w[0][tid] = wt.x;
      s_w[1][tid] = wt.y;
    }
    if (tid == 0) s_count = n;
  }
  __syncthreads();

  // Stage the distinct rows' w·3 bytes, one 16-byte chunk per step of k: a
  // row takes at most `chunks` of them, its start being up to 15 bytes past
  // a 16-byte boundary; chunks past the one holding its last byte are
  // skipped. A hole stages one zero row. The column taps are computed while
  // the copies fly.
  if (valid) {
    const int chunks = (int)((row_bytes + 30) >> 4);
    const int n = s_count;
    for (int k = tid; k < n * chunks; k += kThreads) {
      const int slot = k / chunks;
      const int ch = k - slot * chunks;
      const uintptr_t src = base + (uintptr_t)(s_list[slot] * row_bytes);
      const uintptr_t start = (src & ~(uintptr_t)15) + 16 * ch;
      if (start < src + row_bytes) cp_async16(smem + L.staged + slot * L.pitch + 16 * ch, start);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  } else if (tid == 0) {
    *reinterpret_cast<uint4*>(smem + L.staged) = make_uint4(0, 0, 0, 0);
  }
  ColTap* cols = reinterpret_cast<ColTap*>(smem);
  for (int j = tid; j < out_w; j += kThreads) {
    const Tap t = axis_tap(j, out_w, w, s);
    const float2 wt = tap_weights(t);
    cols[j] = ColTap{3 * t.lo, 3 * t.hi, wt.x, wt.y};
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  OutT* g = out + ((long long)b * out_h + i0) * out_w * 3;
  const int lead = (int)(reinterpret_cast<uintptr_t>(g) & 15);
  unsigned char* band = smem + L.band + lead;  // the band's bytes, at g's address mod 16
  OutT* ob = reinterpret_cast<OutT*>(band);
  const int npix = rows * out_w;
  // pixel p = r * out_w + j; (r, j) step by carries, with no division
  const int dr = kThreads / out_w, dj = kThreads - dr * out_w;
  int r = tid / out_w, j = tid - r * out_w, row = -1;
  const unsigned char *r0 = smem, *r1 = smem;
  float ah = 0.0f, bh = 0.0f;
  // element 3p is aligned for a paired store when (lead / elt + 3p) is even
  const int pair_phase = (lead / (int)sizeof(OutT)) & 1;
  for (int p = tid; p < npix; p += kThreads) {
    if (r != row) {  // this thread's band row changed: its taps into registers
      row = r;
      r0 = smem + s_off[0][r];
      r1 = smem + s_off[1][r];
      ah = s_w[0][r];
      bh = s_w[1][r];
    }
    const ColTap x = cols[j];
    float v[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float p00 = byte_f(r0 + x.lo + c), p01 = byte_f(r0 + x.hi + c);
      const float p10 = byte_f(r1 + x.lo + c), p11 = byte_f(r1 + x.hi + c);
      // each axis as a float32 GEMM accumulates its two taps: the first
      // product rounded, the second fused into it
      const float t0 = __fmaf_rn(bh, p10, ah * p00), t1 = __fmaf_rn(bh, p11, ah * p01);
      v[c] = __fmaf_rn(x.wb, t1, x.wa * t0);
    }
    float o[3];
    if (mode == 3) {  // caffe: BGR, less the float32 means
      o[0] = v[2] - 103.939f;
      o[1] = v[1] - 116.779f;
      o[2] = v[0] - 123.68f;
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if (mode == 0) {
          o[c] = div_exact(v[c], 127.5f, 1.0f / 127.5f) - 1.0f;  // inception: v / 127.5 - 1
        } else if (mode == 1) {
          o[c] = div_exact(v[c], 255.0f, 1.0f / 255.0f);  // zero_one: v / 255
        } else {
          o[c] = v[c];  // raw
        }
      }
    }
    store3(ob + 3 * p, o, ((p & 1) ^ pair_phase) == 0);
    j += dj;
    r += dr;
    if (j >= out_w) {
      j -= out_w;
      ++r;
    }
  }
  __syncthreads();

  // The band is one contiguous span of NHWC: 16-byte stores from the first
  // 16-byte boundary in it, the bytes before that boundary and after the
  // last one 2 at a time (a whole number of elements each).
  const int nbytes = npix * 3 * (int)sizeof(OutT);
  const int head = min((16 - lead) & 15, nbytes);
  const int body = (nbytes - head) >> 4;
  const int tail_at = head + 16 * body;
  unsigned char* dst = reinterpret_cast<unsigned char*>(g);
  for (int k = tid; k < body; k += kThreads)
    reinterpret_cast<uint4*>(dst + head)[k] = reinterpret_cast<const uint4*>(band + head)[k];
  if (tid < head / 2)
    reinterpret_cast<uint16_t*>(dst)[tid] = reinterpret_cast<const uint16_t*>(band)[tid];
  if (tid >= 32 && tid - 32 < (nbytes - tail_at) / 2)
    reinterpret_cast<uint16_t*>(dst + tail_at)[tid - 32] =
        reinterpret_cast<const uint16_t*>(band + tail_at)[tid - 32];
}

template <typename OutT>
int launch(const uint8_t* arena, long long arena_bytes, const int32_t* meta, void* out,
           int batch, int s, int out_h, int out_w, int mode, int rows, cudaStream_t stream) {
  // above 48 KB a block's shared memory must be asked for; once, up to the most
  static const cudaError_t attr = cudaFuncSetAttribute(
      preprocess_ragged_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxDynamicSmem);
  if (attr != cudaSuccess) return (int)attr;
  const Layout layout(s, out_w, rows, (int)sizeof(OutT));
  if (layout.total > kMaxDynamicSmem) return (int)cudaErrorInvalidConfiguration;
  const int bands = (out_h + rows - 1) / rows;
  if (batch == 0 || bands == 0 || out_w == 0) return 0;
  preprocess_ragged_kernel<OutT><<<dim3(bands, batch), kThreads, layout.total, stream>>>(
      arena, arena_bytes, meta, static_cast<OutT*>(out), s, out_h, out_w, mode, rows);
  return (int)cudaGetLastError();
}

}  // namespace

// arena: uint8 [arena_bytes], 16-byte aligned (reads stay inside the
// 16-byte granules that hold its bytes); meta: int32 [batch, 4] rows
// (byte_offset, h, w, valid), image k's pixel (y, x, c) at arena byte
// offset + (y·w + x)·3 + c. out: [batch, out_h, out_w, 3], float32
// (out_dtype 0) or bf16 (1). s: the canvas side the valid sizes must fit.
// mode: 0 inception, 1 zero_one, 2 raw, 3 caffe. Launch shape: bands of
// `rows` (1..32) output rows. Launches on `stream` and returns
// cudaGetLastError(), or an error code for arguments it refuses.
extern "C" int twd_preprocess_ragged(const uint8_t* arena, long long arena_bytes,
                                     const int32_t* meta, void* out, int out_dtype, int batch,
                                     int s, int out_h, int out_w, int mode, int rows,
                                     cudaStream_t stream) {
  if ((out_dtype != 0 && out_dtype != 1) || (reinterpret_cast<uintptr_t>(arena) & 15) ||
      arena_bytes < 0 || s < 1 || s > kMaxSide || batch < 0 || batch > 65535 || out_h < 0 ||
      out_w < 0 || mode < 0 || mode > 3 || rows < 1 || rows > kMaxRows)
    return (int)cudaErrorInvalidValue;
  if (out_dtype == 0)
    return launch<float>(arena, arena_bytes, meta, out, batch, s, out_h, out_w, mode, rows,
                         stream);
  return launch<__nv_bfloat16>(arena, arena_bytes, meta, out, batch, s, out_h, out_w, mode,
                               rows, stream);
}
