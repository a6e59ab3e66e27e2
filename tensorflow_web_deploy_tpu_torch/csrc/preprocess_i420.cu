// Fused I420 preprocess for Hopper (sm_90a): packed I420 canvases →
// bilinear resize from each image's valid (h, w) region → BT.601 inverse →
// clip to [0, 255] → normalize, written as float32 NHWC.
//
// Replaces the TPU kernel ops/pallas_preprocess.py::preprocess_i420 of the
// JAX package (body `_kernel`). It computes the same function, not the same
// blocks: the Pallas kernel builds dense (out, S) sampling matrices and runs
// four matmuls because the MXU wants matmuls, but every row of those
// matrices has exactly two non-zero taps. Here each thread gathers its taps
// directly:
//   - one thread per output pixel, grid (out_w / 32, out_h / 8, batch);
//   - Y: 2x2 taps from the Y plane;
//   - U, V: 2x2 taps from the half-resolution planes at columns lo/2 and
//     hi/2 (the x2 nearest upsample folded in; where the two coincide their
//     weights add, as in the reference's folded matrices);
//   - resize planes first, then convert and clip (the reference's order:
//     clipping does not commute with the resize on out-of-gamut chroma).
//
// Bound: memory. Per image it must read at most 1.5*S*S canvas bytes (only
// the taps of the valid region, in practice fewer) and write
// out_h*out_w*12 bytes; at ~45 flops per output pixel the arithmetic is
// far below the card's float32 rate. The design touches only the taps it
// needs and makes one pass with no intermediates in device memory.
//
// Numerics: build with -fmad=false so that every multiply and add rounds
// as the reference's float32 ops do (nvcc contracts a*b+c into an FMA by
// default, which moves a tap coordinate by an ulp). The sums are taken in
// the order of the reference's matmuls: rows first, then columns.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;

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

__global__ void preprocess_i420_kernel(const uint8_t* __restrict__ packed,
                                       long long image_stride,
                                       const int32_t* __restrict__ hws,
                                       float* __restrict__ out, int s, int out_h,
                                       int out_w, int mode) {
  const int j = blockIdx.x * kTileW + threadIdx.x;
  const int i = blockIdx.y * kTileH + threadIdx.y;
  const int b = blockIdx.z;
  if (i >= out_h || j >= out_w) return;

  // Valid sizes outside [1, S] are clamped so that no tap leaves the canvas.
  const int h = min(max(hws[2 * b], 1), s);
  const int w = min(max(hws[2 * b + 1], 1), s);
  const Tap th = axis_tap(i, out_h, h, s);
  const Tap tw = axis_tap(j, out_w, w, s);
  const float ah = 1.0f - th.frac, bh = th.frac;
  const float aw = 1.0f - tw.frac, bw = tw.frac;

  const uint8_t* yp = packed + (long long)b * image_stride;
  const float y00 = yp[th.lo * s + tw.lo], y01 = yp[th.lo * s + tw.hi];
  const float y10 = yp[th.hi * s + tw.lo], y11 = yp[th.hi * s + tw.hi];
  const float yy = aw * (ah * y00 + bh * y10) + bw * (ah * y01 + bh * y11);

  // Chroma planes: (S/2, S/2) each, contiguous after the Y plane.
  const int s2 = s / 2;
  const uint8_t* up = yp + s * s;
  const uint8_t* vp = up + s2 * s2;
  const int r0 = th.lo >> 1, r1 = th.hi >> 1;
  const int c0 = tw.lo >> 1, c1 = tw.hi >> 1;
  auto plane = [&](const uint8_t* p) {
    const float p00 = (float)p[r0 * s2 + c0] - 128.0f;
    const float p01 = (float)p[r0 * s2 + c1] - 128.0f;
    const float p10 = (float)p[r1 * s2 + c0] - 128.0f;
    const float p11 = (float)p[r1 * s2 + c1] - 128.0f;
    return aw * (ah * p00 + bh * p10) + bw * (ah * p01 + bh * p11);
  };
  const float uu = plane(up);
  const float vv = plane(vp);

  // BT.601 inverse (ops/image.py::BT601_INV), clip, normalize.
  float rgb[3];
  rgb[0] = yy + 1.402f * vv;
  rgb[1] = yy + -0.344136f * uu + -0.714136f * vv;
  rgb[2] = yy + 1.772f * uu;
  float* o = out + (((long long)b * out_h + i) * out_w + j) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float x = fminf(fmaxf(rgb[c], 0.0f), 255.0f);
    if (mode == 0) {
      x = x / 127.5f - 1.0f;  // inception
    } else if (mode == 1) {
      x = x / 255.0f;  // zero_one
    }                  // mode 2: raw
    o[c] = x;
  }
}

}  // namespace

// packed: uint8, image b at packed + b * image_stride, each image a
// [3S/2, S] row-major I420 canvas. hws: int32 [batch, 2]. out: float32
// [batch, out_h, out_w, 3]. mode: 0 inception, 1 zero_one, 2 raw.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int twd_preprocess_i420(const uint8_t* packed, long long image_stride,
                                   const int32_t* hws, float* out, int batch, int s,
                                   int out_h, int out_w, int mode, cudaStream_t stream) {
  const dim3 block(kTileW, kTileH);
  const dim3 grid((out_w + kTileW - 1) / kTileW, (out_h + kTileH - 1) / kTileH, batch);
  preprocess_i420_kernel<<<grid, block, 0, stream>>>(packed, image_stride, hws, out, s,
                                                     out_h, out_w, mode);
  return (int)cudaGetLastError();
}
