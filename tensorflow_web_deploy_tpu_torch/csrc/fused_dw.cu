// Fused depthwise convolution + bias + optional relu6 for Hopper (sm_90a),
// stride 1, NHWC, float32 accumulation.
//
// Replaces the TPU kernel ops/pallas_depthwise.py::fused_dw_call of the JAX
// package (body `_fused_dw_kernel`), together with the pad, cast-in and
// cast-out its caller (ops/depthwise.py::fused_depthwise_bn) runs around
// it:
//   out[b,y,x,c] = act(sum_{dh,dw} xpad[b, y+dh, x+dw, c] * taps[dh*kw+dw, c]
//                      + bias[c]),   act = clip to [0, 6] or none,
// where xpad is x zero-padded by (pad_top, pad_left) and the taps hold the
// BN-folded depthwise kernel.
//
// Bound: memory. Per output element it reads one input element (the kh*kw
// taps of neighbouring outputs overlap and hit L1/L2) and writes one; at
// ~21 float32 operations per element against 2+2 bytes in bf16 the
// arithmetic is far below the card's float32 rate. The design makes one
// pass over the activations with no padded copy and no float32
// intermediate in device memory:
//   - one thread per output pixel x 8 channels; neighbouring threads take
//     neighbouring channel groups of one pixel, then the next pixel, so a
//     warp's loads and stores are contiguous 16-byte accesses (bf16; two
//     per thread in float32). The channel count must be a multiple of 8;
//     the wrapper checks it;
//   - SAME zero-padding by a bounds check on each tap instead of a padded
//     copy: an out-of-range tap contributes 0 * tap, as the padded
//     reference's does;
//   - the kh*kw tap vectors and the bias are read through L1/L2 (every
//     pixel of the batch reads the same kh*kw*C floats).
// The Pallas kernel holds one whole padded image in VMEM per grid step; a
// block here holds nothing in shared memory. A halo tile in shared memory
// and TMA loads are later work.
//
// Numerics: the input is converted to float32 and the taps are summed in
// the reference's order, (dh, dw) row-major, each as a multiply then an add.
// Build with -fmad=false: nvcc would otherwise contract the multiply-add
// into an FMA, which rounds once where the reference rounds twice. Then
// the bias is added, the clip applied (a NaN stays NaN, as torch.clamp
// keeps it), and the result rounded to the input type (round to nearest
// even, as torch's cast does).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kVec = 8;  // channels per thread
constexpr int kThreads = 256;

template <typename T>
struct Vec8;

template <>
struct Vec8<float> {
  __device__ __forceinline__ static void load(const float* p, float v[kVec]) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  }
  __device__ __forceinline__ static void store(float* p, const float v[kVec]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};

template <>
struct Vec8<__nv_bfloat16> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float v[kVec]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float v[kVec]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_dw_kernel(const T* __restrict__ x, const float* __restrict__ taps,
                    const float* __restrict__ bias, T* __restrict__ out, int batch, int h,
                    int w, int c, int oh, int ow, int kh, int kw, int pad_top, int pad_left,
                    int relu6) {
  const int groups = c / kVec;
  const long long total = (long long)batch * oh * ow * groups;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c0 = (int)(idx % groups) * kVec;
  long long p = idx / groups;
  const int ox = (int)(p % ow);
  p /= ow;
  const int oy = (int)(p % oh);
  const int b = (int)(p / oh);

  float acc[kVec] = {};
  for (int dh = 0; dh < kh; ++dh) {
    const int iy = oy + dh - pad_top;
    const bool row_in = iy >= 0 && iy < h;
    for (int dw = 0; dw < kw; ++dw) {
      const int ix = ox + dw - pad_left;
      float v[kVec];
      if (row_in && ix >= 0 && ix < w) {
        Vec8<T>::load(x + (((long long)b * h + iy) * w + ix) * c + c0, v);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) v[j] = 0.0f;
      }
      float k[kVec];
      Vec8<float>::load(taps + (long long)(dh * kw + dw) * c + c0, k);
      const bool first = dh == 0 && dw == 0;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float t = v[j] * k[j];
        acc[j] = first ? t : acc[j] + t;
      }
    }
  }
  float bv[kVec];
  Vec8<float>::load(bias + c0, bv);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    float y = acc[j] + bv[j];
    if (relu6) y = y < 0.0f ? 0.0f : (y > 6.0f ? 6.0f : y);
    acc[j] = y;
  }
  Vec8<T>::store(out + (((long long)b * oh + oy) * ow + ox) * c + c0, acc);
}

template <typename T>
int launch(const void* x, const float* taps, const float* bias, void* out, int batch, int h,
           int w, int c, int oh, int ow, int kh, int kw, int pad_top, int pad_left, int relu6,
           cudaStream_t stream) {
  const long long total = (long long)batch * oh * ow * (c / kVec);
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  fused_dw_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), taps, bias, static_cast<T*>(out), batch, h, w, c, oh, ow, kh,
      kw, pad_top, pad_left, relu6);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [batch, h, w, c] NHWC, float32 (dtype 0) or bfloat16 (dtype 1); taps:
// float32 [kh*kw, c]; bias: float32 [c]; out: [batch, oh, ow, c] NHWC in x's
// type. c % 8 == 0 and every pointer 16-byte aligned. Pads are the zero
// rows above and columns left of x; rows and columns past its end are
// zeros too, as far as oh and ow reach. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int twd_fused_dw(const void* x, const float* taps, const float* bias, void* out,
                            int batch, int h, int w, int c, int oh, int ow, int kh, int kw,
                            int pad_top, int pad_left, int relu6, int dtype,
                            cudaStream_t stream) {
  if (c % kVec) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch<float>(x, taps, bias, out, batch, h, w, c, oh, ow, kh, kw, pad_top,
                           pad_left, relu6, stream);
    case 1:
      return launch<__nv_bfloat16>(x, taps, bias, out, batch, h, w, c, oh, ow, kh, kw,
                                   pad_top, pad_left, relu6, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
