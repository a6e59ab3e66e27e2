// Fused I420 preprocess for Hopper (sm_90a): packed I420 canvases →
// bilinear resize from each image's valid (h, w) region → BT.601 inverse →
// clip to [0, 255] → normalize, stored NHWC in float32 or bf16.
//
// Replaces the TPU kernel ops/pallas_preprocess.py::preprocess_i420 of the
// JAX package (body `_kernel`), together with the two steps its caller runs
// around it: the decode of each image's big-endian (h, w) trailer from the
// wire row (serving/engine.py::serve_packed) and the cast to the serving
// dtype. It computes the same function, not the same blocks: the Pallas
// kernel builds dense (out, S) sampling matrices for the MXU, but every row
// of those matrices has two non-zero taps, so here the taps are gathered.
//
// Bound: memory. Per image it must read the tap rows × tap columns of the
// valid region (at most 1.5·S² bytes, fewer on a downscale) and write
// out_h·out_w·3 elements; at ~55 float32 operations per output pixel the
// arithmetic is far below the card's float32 rate. In bf16 the output is
// half the bytes of float32, and the store is the larger part of the bound.
// On the card the pixel loop's ~100 instructions a pixel, not the bytes, set
// the time at the main path's batch of 8 (PERF.md).
//
// Design:
//   - a block owns one image × a band of `rows` (≤ 32) whole output rows;
//     grid (bands, batch). The launch shape (rows, threads) comes from the
//     shapes alone: ops/preprocess_i420.py::launch_shape;
//   - warp 0 computes the band's row taps and finds its distinct source
//     rows with two ballots (Y rows lo and hi; chroma rows lo/2 and hi/2):
//     each distinct row is staged once, however many taps share it;
//   - the distinct Y, U and V rows are copied across the valid width into
//     shared memory with 16-byte cp.async. A wire row is 1.5·S² + 4 bytes,
//     so an image starts at any multiple of 4: each copy starts at the
//     16-byte boundary at or below its row's start, and the row's offset is
//     kept with its slot. While the copies fly, the block computes the
//     column taps (lo, hi, frac: 8 bytes an output column) into shared
//     memory, once for all its rows;
//   - each thread then computes pixels of the band from shared memory and
//     writes their channels into a staging buffer laid out at the same
//     address mod 16 as the band in device memory. Per pixel it spends no
//     quarter-rate instruction and takes no branch but its row's: the 12
//     gathered bytes become floats by bit pattern (2^23 + b, less 2^23),
//     the normalize divides by FMAs (div_exact), its (row, column) step by
//     carries, its row's taps stay in registers, and two of its three
//     channels go out as one paired store;
//   - the band, rows·out_w·3 contiguous NHWC elements, goes out with
//     16-byte stores; its unaligned head and tail 2 bytes at a time.
// Resize planes first, then convert and clip (the reference's order:
// clipping does not commute with the resize on out-of-gamut chroma).
//
// Numerics: build with -fmad=false so that every multiply and add rounds as
// the reference's float32 ops do (nvcc contracts a*b+c into an FMA by
// default, which moves a tap coordinate by an ulp). Tap coordinates divide
// first, as the reference does. The sums are taken in the order of the
// reference's matmuls: rows first, then columns; where the two chroma taps
// of an axis fall on one half-resolution row or column, their weights add
// first, as in the reference's folded sampling matrices. The bf16 store
// rounds the float32 result to nearest even, as torch's cast does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 32;  // output rows per band: warp 0 holds one each
constexpr int kMaxThreads = 512;
constexpr int kMaxSide = 8192;  // canvas side; column taps are kept in 16 bits
// dynamic shared memory a block may ask for: sm_90's 227 KB less room for
// the kernel's static arrays
constexpr int kMaxDynamicSmem = 224 * 1024;

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// A block's dynamic shared memory, in bytes from its start. The wrapper's
// LaunchShape.smem (ops/preprocess_i420.py) computes the same sum.
struct Layout {
  int y, u, v, band, total;  // region offsets; the column taps at 0
  int y_pitch, c_pitch;      // bytes per staged Y / chroma row
  __host__ __device__ Layout(int s, int out_w, int rows, int elt) {
    y_pitch = align16(s + 15);  // a row's valid bytes and up to 15 before it
    c_pitch = align16(s / 2 + 15);
    y = align16(8 * out_w);
    u = y + 2 * rows * y_pitch;  // a band of r rows has at most 2r distinct taps
    v = u + 2 * rows * c_pitch;
    band = v + 2 * rows * c_pitch;
    total = band + align16(rows * out_w * 3 * elt + 16);
  }
};

// One output column's taps: source columns lo, hi and the weight of hi.
struct __align__(8) ColTap {
  short lo, hi;
  float frac;
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

// Slots of a band's distinct source rows, on warp 0. Lane r holds the taps
// (lo, hi) of band row r when `act`. Both sequences are nondecreasing and
// hi - lo is 0 or 1, so in the order lo_0, hi_0, lo_1, hi_1, ... a row is
// either new and above every row before it, or one of the last two distinct
// rows: lo_r is new iff lo_r > hi_(r-1), hi_r iff hi_r > max(lo_r, hi_(r-1)),
// and a lo_r below hi_(r-1) is lo_(r-1), the distinct row before the last.
// A slot is the count of new rows up to its position, less one; each new row
// is written to list[slot]. Returns the number of distinct rows.
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

// Chunk `ch` of the copy of a row of `count` bytes at `src` into shared
// memory at `dst`: the copy starts at the 16-byte boundary at or below src
// (dst, 16-byte aligned, gets the bytes from there on) and ends with the
// chunk that holds the row's last byte; chunks past it are skipped.
__device__ __forceinline__ void stage_chunk(unsigned char* dst, uintptr_t src, int count, int ch) {
  const uintptr_t start = (src & ~(uintptr_t)15) + 16 * ch;
  if (start < src + count) cp_async16(dst + 16 * ch, start);
}

// A staged byte as a float, exactly, without a conversion instruction:
// 2^23 + b is the float with b in its low mantissa bits, and subtracting
// `zero` (2^23 for luma, 2^23 + 128 for centered chroma) is exact.
__device__ __forceinline__ float byte_f(const unsigned char* p, float zero) {
  return __uint_as_float(0x4B000000u | *p) - zero;
}
constexpr float kLuma0 = 8388608.0f;     // 2^23
constexpr float kChroma0 = 8388736.0f;   // 2^23 + 128

// x / d correctly rounded, for the normalize's divisors d (127.5, 255) and
// x in [0, 255], r = 1 / d rounded: the reciprocal product corrected by its
// exact residual (Markstein): q = x·r, e = x - d·q (exact by an FMA), then
// q + e·r rounded once. Below 2^-64 the residual can underflow, so such x
// (which sums of bytes times taps never give) take the IEEE division. Equal
// to IEEE division on every float32 in [0, 255] (tests/test_torch_preprocess.py
// checks the identity); the compiler's division gives the same quotient but
// branches to a slow path for some dividends, and on canvases whose colours
// clip that path dominated the pixel loop.
__device__ __forceinline__ float div_exact(float x, float d, float r) {
  if (x != 0.0f && x < 0x1p-64f) return x / d;
  const float q = __fmul_rn(x, r);
  const float e = __fmaf_rn(-d, q, x);
  return __fmaf_rn(e, r, q);
}

// Three channels of one pixel into the staging band at `o`, two of them as
// one 4-byte (bf16) or 8-byte (float) store: the first two when `o` is
// aligned for it, else the last two. Each value rounds to nearest even.
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
__global__ void __launch_bounds__(kMaxThreads)
    preprocess_i420_kernel(const uint8_t* __restrict__ packed, long long image_stride,
                           const int32_t* __restrict__ hws, OutT* __restrict__ out, int s,
                           int out_h, int out_w, int mode, int band_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_list[2][2 * kMaxRows];  // distinct Y rows, distinct chroma rows
  __shared__ int s_count[2];
  // per band row: shared-memory offsets of its Y, U and V rows (lo, hi each),
  // and its luma weights (1 - frac, frac) and chroma weights
  __shared__ int s_off[6][kMaxRows];
  __shared__ float s_w[4][kMaxRows];

  const Layout L(s, out_w, band_rows, (int)sizeof(OutT));
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * band_rows;
  const int rows = min(band_rows, out_h - i0);
  const int s2 = s / 2;
  const uint8_t* img = packed + (long long)b * image_stride;
  const uintptr_t base = reinterpret_cast<uintptr_t>(img);
  const uintptr_t u_off = (uintptr_t)s * s;  // U plane, then V, then the trailer
  const uintptr_t v_off = u_off + (uintptr_t)s2 * s2;

  // The valid size, from the table or from the trailer; sizes outside
  // [1, S] are clamped so that no tap leaves the canvas.
  int h, w;
  if (hws != nullptr) {
    h = hws[2 * b];
    w = hws[2 * b + 1];
  } else {
    const uint8_t* t = img + v_off + (uintptr_t)s2 * s2;
    h = (t[0] << 8) | t[1];
    w = (t[2] << 8) | t[3];
  }
  h = min(max(h, 1), s);
  w = min(max(w, 1), s);

  if (tid < 32) {
    const bool act = tid < rows;
    const Tap t = act ? axis_tap(i0 + tid, out_h, h, s) : Tap{0, 0, 0.0f};
    const int clo = t.lo >> 1, chi = t.hi >> 1;
    int y0, y1, c0, c1;
    const int ny = band_slots(t.lo, t.hi, act, tid, s_list[0], y0, y1);
    const int nc = band_slots(clo, chi, act, tid, s_list[1], c0, c1);
    if (act) {
      // a staged row sits at its slot, offset by its start's address mod 16
      auto at = [&](int region, int pitch, int slot, uintptr_t src) {
        return region + slot * pitch + (int)(src & 15);
      };
      s_off[0][tid] = at(L.y, L.y_pitch, y0, base + (uintptr_t)t.lo * s);
      s_off[1][tid] = at(L.y, L.y_pitch, y1, base + (uintptr_t)t.hi * s);
      s_off[2][tid] = at(L.u, L.c_pitch, c0, base + u_off + (uintptr_t)clo * s2);
      s_off[3][tid] = at(L.u, L.c_pitch, c1, base + u_off + (uintptr_t)chi * s2);
      s_off[4][tid] = at(L.v, L.c_pitch, c0, base + v_off + (uintptr_t)clo * s2);
      s_off[5][tid] = at(L.v, L.c_pitch, c1, base + v_off + (uintptr_t)chi * s2);
      const float a = 1.0f - t.frac, c = t.frac;
      const bool same = clo == chi;
      s_w[0][tid] = a;
      s_w[1][tid] = c;
      s_w[2][tid] = same ? a + c : a;
      s_w[3][tid] = same ? 0.0f : c;
    }
    if (tid == 0) {
      s_count[0] = ny;
      s_count[1] = nc;
    }
  }
  __syncthreads();

  // Stage the distinct rows across the valid width (chroma: columns up to
  // (w - 1) / 2), one 16-byte chunk per step of k: a row takes at most
  // y_chunks (c_chunks) of them, its start being up to 15 bytes past a
  // 16-byte boundary. The column taps are computed while they fly.
  {
    const int wc = (w + 1) >> 1;
    const int y_chunks = (w + 30) >> 4, c_chunks = (wc + 30) >> 4;
    const int ny = s_count[0], nc = s_count[1];
    for (int k = tid; k < ny * y_chunks; k += nthreads) {
      const int slot = k / y_chunks;
      const int ch = k - slot * y_chunks;
      const uintptr_t src = base + (uintptr_t)s_list[0][slot] * s;
      stage_chunk(smem + L.y + slot * L.y_pitch, src, w, ch);
    }
    for (int k = tid; k < nc * c_chunks; k += nthreads) {
      const int slot = k / c_chunks;
      const int ch = k - slot * c_chunks;
      const uintptr_t row = (uintptr_t)s_list[1][slot] * s2;
      stage_chunk(smem + L.u + slot * L.c_pitch, base + u_off + row, wc, ch);
      stage_chunk(smem + L.v + slot * L.c_pitch, base + v_off + row, wc, ch);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  ColTap* cols = reinterpret_cast<ColTap*>(smem);
  for (int j = tid; j < out_w; j += nthreads) {
    const Tap t = axis_tap(j, out_w, w, s);
    cols[j] = ColTap{(short)t.lo, (short)t.hi, t.frac};
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  OutT* g = out + ((long long)b * out_h + i0) * out_w * 3;
  const int lead = (int)(reinterpret_cast<uintptr_t>(g) & 15);
  unsigned char* band = smem + L.band + lead;  // the band's bytes, at g's address mod 16
  OutT* ob = reinterpret_cast<OutT*>(band);
  const int npix = rows * out_w;
  // pixel p = r * out_w + j; (r, j) step by carries, with no division
  const int dr = nthreads / out_w, dj = nthreads - dr * out_w;
  int r = tid / out_w, j = tid - r * out_w, row = -1;
  int oy0 = 0, oy1 = 0, ou0 = 0, ou1 = 0, ov0 = 0, ov1 = 0;
  float ah = 0.0f, bh = 0.0f, ca = 0.0f, cb = 0.0f;
  // element 3p is aligned for a paired store when (lead / elt + 3p) is even
  const int pair_phase = (lead / (int)sizeof(OutT)) & 1;
  for (int p = tid; p < npix; p += nthreads) {
    if (r != row) {  // this thread's band row changed: its taps into registers
      row = r;
      oy0 = s_off[0][r], oy1 = s_off[1][r], ou0 = s_off[2][r], ou1 = s_off[3][r];
      ov0 = s_off[4][r], ov1 = s_off[5][r];
      ah = s_w[0][r], bh = s_w[1][r], ca = s_w[2][r], cb = s_w[3][r];
    }
    const ColTap x = cols[j];
    const float aw = 1.0f - x.frac, bw = x.frac;
    const int x0 = x.lo, x1 = x.hi, k0 = x0 >> 1, k1 = x1 >> 1;
    // chroma columns: where the two taps fall on one column, their weights add
    const bool same = k0 == k1;
    const float wa = same ? aw + bw : aw, wb = same ? 0.0f : bw;

    const float y00 = byte_f(smem + oy0 + x0, kLuma0), y01 = byte_f(smem + oy0 + x1, kLuma0);
    const float y10 = byte_f(smem + oy1 + x0, kLuma0), y11 = byte_f(smem + oy1 + x1, kLuma0);
    const float yy = aw * (ah * y00 + bh * y10) + bw * (ah * y01 + bh * y11);
    auto plane = [&](int o0, int o1) {
      const float p00 = byte_f(smem + o0 + k0, kChroma0), p01 = byte_f(smem + o0 + k1, kChroma0);
      const float p10 = byte_f(smem + o1 + k0, kChroma0), p11 = byte_f(smem + o1 + k1, kChroma0);
      return wa * (ca * p00 + cb * p10) + wb * (ca * p01 + cb * p11);
    };
    const float uu = plane(ou0, ou1);
    const float vv = plane(ov0, ov1);

    // BT.601 inverse (ops/image.py::BT601_INV), clip, normalize.
    float rgb[3];
    rgb[0] = yy + 1.402f * vv;
    rgb[1] = yy + -0.344136f * uu + -0.714136f * vv;
    rgb[2] = yy + 1.772f * uu;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float v = fminf(fmaxf(rgb[c], 0.0f), 255.0f);
      if (mode == 0) {
        v = div_exact(v, 127.5f, 1.0f / 127.5f) - 1.0f;  // inception: v / 127.5 - 1
      } else if (mode == 1) {
        v = div_exact(v, 255.0f, 1.0f / 255.0f);  // zero_one: v / 255
      }                                           // mode 2: raw
      rgb[c] = v;
    }
    store3(ob + 3 * p, rgb, ((p & 1) ^ pair_phase) == 0);
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
  for (int k = tid; k < body; k += nthreads)
    reinterpret_cast<uint4*>(dst + head)[k] = reinterpret_cast<const uint4*>(band + head)[k];
  if (tid < head / 2)
    reinterpret_cast<uint16_t*>(dst)[tid] = reinterpret_cast<const uint16_t*>(band)[tid];
  if (tid >= 32 && tid - 32 < (nbytes - tail_at) / 2)
    reinterpret_cast<uint16_t*>(dst + tail_at)[tid - 32] =
        reinterpret_cast<const uint16_t*>(band + tail_at)[tid - 32];
}

template <typename OutT>
int launch(const uint8_t* packed, long long image_stride, const int32_t* hws, void* out,
           int batch, int s, int out_h, int out_w, int mode, int rows, int threads,
           cudaStream_t stream) {
  // above 48 KB a block's shared memory must be asked for; once, up to the most
  static const cudaError_t attr = cudaFuncSetAttribute(
      preprocess_i420_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxDynamicSmem);
  if (attr != cudaSuccess) return (int)attr;
  const Layout layout(s, out_w, rows, (int)sizeof(OutT));
  if (layout.total > kMaxDynamicSmem) return (int)cudaErrorInvalidConfiguration;
  const int bands = (out_h + rows - 1) / rows;
  if (batch == 0 || bands == 0 || out_w == 0) return 0;
  preprocess_i420_kernel<OutT><<<dim3(bands, batch), threads, layout.total, stream>>>(
      packed, image_stride, hws, static_cast<OutT*>(out), s, out_h, out_w, mode, rows);
  return (int)cudaGetLastError();
}

}  // namespace

// packed: uint8, image b at packed + b * image_stride, each image a
// [3S/2, S] row-major I420 canvas; with hws == NULL, each image's valid
// (h, w) is read from the 4 bytes after its canvas (big-endian u16 h, then
// w: the engine's wire row), else from hws, int32 [batch, 2]. out: [batch,
// out_h, out_w, 3], float32 (out_dtype 0) or bf16 (1). mode: 0 inception,
// 1 zero_one, 2 raw. Launch shape: bands of `rows` (1..32) output rows,
// `threads` (a multiple of 32, at most 512) per block. Launches on `stream`
// and returns cudaGetLastError(), or an error code for arguments it refuses.
extern "C" int twd_preprocess_i420(const uint8_t* packed, long long image_stride,
                                   const int32_t* hws, void* out, int out_dtype, int batch,
                                   int s, int out_h, int out_w, int mode, int rows,
                                   int threads, cudaStream_t stream) {
  if ((out_dtype != 0 && out_dtype != 1) || s < 4 || s % 4 || s > kMaxSide || batch < 0 ||
      batch > 65535 || out_h < 0 || out_w < 0 || mode < 0 || mode > 2 || rows < 1 ||
      rows > kMaxRows || threads < 64 || threads > kMaxThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  if (out_dtype == 0)
    return launch<float>(packed, image_stride, hws, out, batch, s, out_h, out_w, mode, rows,
                         threads, stream);
  return launch<__nv_bfloat16>(packed, image_stride, hws, out, batch, s, out_h, out_w, mode,
                               rows, threads, stream);
}
