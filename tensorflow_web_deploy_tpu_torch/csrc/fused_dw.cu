// Fused 3x3 depthwise convolution + bias + optional relu6 for Hopper (sm_90a),
// stride 1 or 2, NHWC, float32 accumulation.
//
// Replaces the TPU kernel ops/pallas_depthwise.py::fused_dw_call of the JAX
// package (body `_fused_dw_kernel`, stride 1), together with the pad, cast-in
// and cast-out its caller (ops/depthwise.py::fused_depthwise_bn) runs around
// it, and the caller's stride-2 path `_shift_mac`, which does the same
// arithmetic on strided slices:
//   out[b,y,x,c] = act(sum_{dh,dw} xpad[b, y*s+dh, x*s+dw, c] * taps[dh*3+dw, c]
//                      + bias[c]),   act = clip to [0, 6] or none,
// where xpad is x zero-padded by (pad_top, pad_left) above and left, and by
// zeros past its end as far as oh and ow reach; the taps hold the BN-folded
// depthwise kernel.
//
// Bound: memory. Each output element needs one input element (at stride 1)
// and one output element moved, 2 + 2 bytes in bf16, against 9 multiplies,
// 8 adds, the bias and the clamp: ~5 operations per byte, far below the
// card's float32 ridge. So the design moves every activation byte once from
// device memory and spends few instructions per byte:
//   - a block is one image x a tile of th output rows x tw output columns x
//     a slab of 8*groups channels (up to 64: 128 contiguous bytes of a pixel
//     in bf16; the launch rule takes 16 or 32). It stages its input halo
//     tile, ((th-1)*s+3) x ((tw-1)*s+3) pixels x the slab, in shared memory
//     once, with 16-byte cp.async;
//     sources outside the image are zero-filled (source size 0), and that
//     zero fill is the SAME padding, so no padded copy exists;
//   - a thread owns one 8-channel group and a run of `run` outputs along a
//     row. It loads its group's 9 x 8 float32 taps and 8 biases into
//     registers once (while the tile is in flight), then walks its run with
//     the 3 x 3 window of 8-channel vectors in registers: per output it reads
//     s new columns of 3 vectors from shared memory (3 at stride 1, 6 at
//     stride 2) instead of 9;
//   - index math is 32-bit, derived once per block and thread; the tile's
//     load loop steps its (row, column) by carries, with no division;
//   - the launch shape (groups, threads along x, rows, run) is the caller's:
//     ops/fused_dw.py::launch_shape picks it per layer so that the small maps
//     still spread over the card's SMs.
// Registers (nvcc -Xptxas -v, sm_90a, -O3 -fmad=false, CUDA 12.8): 179 a
// thread for bf16 at stride 1, 128 at stride 2 (4 bytes spilled); 173 and
// 128 for float32 (none spilled); relu6 on or off alike. The launch rule's
// blocks of at most 64 threads keep several blocks resident per SM all the
// same, so that one block's tile load overlaps another's arithmetic.
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

constexpr int kVec = 8;           // channels per thread
constexpr int kK = 3;             // kernel height and width
constexpr int kMaxThreads = 256;  // per block; the wrapper's rule stays within it
constexpr int kMaxGroups = 8;     // 8-channel groups per block (a 64-channel slab)
constexpr int kMaxRows = 64;      // output rows per block (blockDim.z)
// shared memory a block may take on sm_90 (227 KB)
constexpr int kMaxSmem = 232448;

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

// 16 bytes global -> shared, bypassing L1; src_bytes 0 fills the 16 bytes
// with zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

// clip to [0, 6] that keeps a NaN, as torch.clamp does: two instructions
// where the compare-and-select form takes four
__device__ __forceinline__ float relu6_nan(float y) {
  asm("max.NaN.f32 %0, %0, 0f00000000;\n" : "+f"(y));
  asm("min.NaN.f32 %0, %0, 0f40C00000;\n" : "+f"(y));
  return y;
}

// One column of the window: the 3 vectors (dh = 0, 1, 2) at tile column `col`.
template <typename T>
__device__ __forceinline__ void load_column(const T* rows, int col, int pix, int row_pitch,
                                            float v[kK][kVec]) {
#pragma unroll
  for (int dh = 0; dh < kK; ++dh) Vec8<T>::load(rows + dh * row_pitch + col * pix, v[dh]);
}

// One output of a thread's run: load the window's S new columns (c1 and c2
// at stride 2, c2 at stride 1; c0 comes from the last output), sum the 9
// taps in (dh, dw) order, add the bias, clamp, round and store.
template <typename T, int S, bool kRelu6>
__device__ __forceinline__ void dw_output(const T* rows, int col, int pix, int row_pitch,
                                          const float (&k)[kK * kK][kVec],
                                          const float (&bv)[kVec], T* dst,
                                          float (&c0)[kK][kVec], float (&c1)[kK][kVec],
                                          float (&c2)[kK][kVec]) {
  if (S == 2) load_column(rows, col + 1, pix, row_pitch, c1);
  load_column(rows, col + 2, pix, row_pitch, c2);
  float acc[kVec];
#pragma unroll
  for (int dh = 0; dh < kK; ++dh) {
#pragma unroll
    for (int dw = 0; dw < kK; ++dw) {
      const float* v = dw == 0 ? c0[dh] : (dw == 1 ? c1[dh] : c2[dh]);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float t = v[j] * k[dh * kK + dw][j];
        acc[j] = (dh == 0 && dw == 0) ? t : acc[j] + t;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const float y = acc[j] + bv[j];
    acc[j] = kRelu6 ? relu6_nan(y) : y;
  }
  Vec8<T>::store(dst, acc);
}

// Block: blockDim = (groups, nx, th); grid = (batch * slabs, row tiles,
// column tiles). Thread (g, xi, r) computes output row oy0 + r, columns
// ox0 + xi*run .. + run - 1, channels slab*8*groups + 8*g .. + 7.
template <typename T, int S, bool kRelu6>
__global__ void __launch_bounds__(kMaxThreads)
    fused_dw_kernel(const T* __restrict__ x, const float* __restrict__ taps,
                    const float* __restrict__ bias, T* __restrict__ out, int h, int w, int c,
                    int oh, int ow, int pad_top, int pad_left, int run, int slabs) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  constexpr int kChunks = sizeof(T) * kVec / 16;  // 16-byte copies per vector
  constexpr int kPer16 = 16 / sizeof(T);            // elements per copy
  const int groups = blockDim.x, nx = blockDim.y, th = blockDim.z;
  const int g = threadIdx.x, xi = threadIdx.y, r = threadIdx.z;
  const int pix = groups * kVec;  // tile elements per pixel (the slab)
  const int tw = nx * run;
  const int iw = (tw - 1) * S + kK, ih = (th - 1) * S + kK;
  const int b = blockIdx.x / slabs, slab = blockIdx.x - b * slabs;
  const int oy0 = blockIdx.y * th, ox0 = blockIdx.z * tw;
  const int ch = slab * pix + g * kVec;  // first channel of this thread's group
  const T* xb = x + (size_t)b * h * w * c;

  // Stage the halo tile: pixel lanes (xi, r) walk the tile's pixels, lane g
  // copies its group's vector of each.
  {
    const int lanes = nx * th, lane = xi + nx * r;
    int iy = lane / iw, ix = lane - iy * iw;
    const int step_y = lanes / iw, step_x = lanes - step_y * iw;
    const int y_in = oy0 * S - pad_top, x_in = ox0 * S - pad_left;
    while (iy < ih) {
      const int gy = y_in + iy, gx = x_in + ix;
      const bool in = (unsigned)gy < (unsigned)h && (unsigned)gx < (unsigned)w;
      // an outside source reads nothing; its address only has to be valid
      const T* src = in ? xb + (gy * w + gx) * c + ch : xb;
      T* dst = tile + (iy * iw + ix) * pix + g * kVec;
#pragma unroll
      for (int k = 0; k < kChunks; ++k) cp_async16(dst + k * kPer16, src + k * kPer16, in ? 16 : 0);
      ix += step_x;
      iy += step_y;
      if (ix >= iw) {
        ix -= iw;
        ++iy;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // Taps and bias into registers while the tile is in flight.
  float k[kK * kK][kVec], bv[kVec];
#pragma unroll
  for (int t = 0; t < kK * kK; ++t) Vec8<float>::load(taps + t * c + ch, k[t]);
  Vec8<float>::load(bias + ch, bv);

  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int oy = oy0 + r, ox = ox0 + xi * run;
  if (oy >= oh || ox >= ow) return;
  const int n = min(run, ow - ox);
  const int row_pitch = iw * pix;
  const T* rows = tile + r * S * row_pitch + g * kVec;  // tap row dh = 0
  int col = xi * run * S;                               // tile column of tap dw = 0
  T* dst = out + (((size_t)b * oh + oy) * ow + ox) * c + ch;

  // The window's three columns rotate through A, B and C, so that no
  // register moves: each output loads S new columns and hands its last
  // 3 - S to the next, which sees them as its first.
  float A[kK][kVec], B[kK][kVec], C[kK][kVec];
  load_column(rows, col, pix, row_pitch, A);
  if (S == 1) load_column(rows, col + 1, pix, row_pitch, B);
  using Column = float[kK][kVec];
  auto step = [&](Column& c0, Column& c1, Column& c2) {
    dw_output<T, S, kRelu6>(rows, col, pix, row_pitch, k, bv, dst, c0, c1, c2);
    col += S;
    dst += c;
  };
  // at stride 1 the columns go (A B C) -> (B C A) -> (C A B); at stride 2
  // (A B C) -> (C A B) -> (B C A)
  int i = 0;
  for (; i + 3 <= n; i += 3) {
    step(A, B, C);
    if (S == 1) {
      step(B, C, A);
      step(C, A, B);
    } else {
      step(C, A, B);
      step(B, C, A);
    }
  }
  if (i < n) {
    step(A, B, C);
    if (i + 1 < n) {
      if (S == 1)
        step(B, C, A);
      else
        step(C, A, B);
    }
  }
}

template <typename T, int S, bool kRelu6>
int launch(const void* x, const float* taps, const float* bias, void* out, int batch, int h,
           int w, int c, int oh, int ow, int pad_top, int pad_left, int groups, int nx, int th,
           int run, cudaStream_t stream) {
  // above 48 KB a block's shared memory must be asked for; once, up to the most
  static const cudaError_t attr = cudaFuncSetAttribute(
      fused_dw_kernel<T, S, kRelu6>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const int slabs = c / (groups * kVec);
  const long long tw = (long long)nx * run;
  const long long smem =
      ((th - 1LL) * S + kK) * ((tw - 1) * S + kK) * groups * kVec * (long long)sizeof(T);
  const long long grid_x = (long long)batch * slabs;
  const long long grid_y = (oh + th - 1) / th, grid_z = (ow + tw - 1) / tw;
  if (smem > kMaxSmem || grid_x > INT_MAX || grid_y > 65535 || grid_z > 65535)
    return (int)cudaErrorInvalidConfiguration;
  if (grid_x == 0 || grid_y == 0 || grid_z == 0) return 0;
  fused_dw_kernel<T, S, kRelu6><<<dim3((unsigned)grid_x, (unsigned)grid_y, (unsigned)grid_z),
                                  dim3(groups, nx, th), (size_t)smem, stream>>>(
      static_cast<const T*>(x), taps, bias, static_cast<T*>(out), h, w, c, oh, ow, pad_top,
      pad_left, run, slabs);
  return (int)cudaGetLastError();
}

using Launcher = int (*)(const void*, const float*, const float*, void*, int, int, int, int, int,
                         int, int, int, int, int, int, int, cudaStream_t);
// [dtype][stride - 1][relu6]
constexpr Launcher kLaunchers[2][2][2] = {
    {{launch<float, 1, false>, launch<float, 1, true>},
     {launch<float, 2, false>, launch<float, 2, true>}},
    {{launch<__nv_bfloat16, 1, false>, launch<__nv_bfloat16, 1, true>},
     {launch<__nv_bfloat16, 2, false>, launch<__nv_bfloat16, 2, true>}}};

}  // namespace

// x: [batch, h, w, c] NHWC, float32 (dtype 0) or bfloat16 (dtype 1); taps:
// float32 [9, c] (a 3x3 kernel, (dh, dw) row-major); bias: float32 [c]; out:
// [batch, oh, ow, c] NHWC in x's type. stride 1 or 2; c a multiple of
// 8 * groups; every pointer 16-byte aligned; h * w * c < 2^31. Pads are the
// zero rows above and columns left of x; rows and columns past its end are
// zeros too, as far as oh and ow reach. The launch shape: blocks of
// (groups, nx, th) threads, each thread `run` outputs along a row; at most
// 256 threads, 8 groups and 64 rows. Launches on `stream` and returns
// cudaGetLastError(), or an error code for arguments it refuses.
extern "C" int twd_fused_dw(const void* x, const float* taps, const float* bias, void* out,
                            int batch, int h, int w, int c, int oh, int ow, int stride,
                            int pad_top, int pad_left, int relu6, int dtype, int groups, int nx,
                            int th, int run, cudaStream_t stream) {
  if ((dtype != 0 && dtype != 1) || (stride != 1 && stride != 2) || groups < 1 ||
      groups > kMaxGroups || nx < 1 || th < 1 || th > kMaxRows || run < 1 ||
      groups * nx * th > kMaxThreads || c % (groups * kVec) || (long long)h * w * c > INT_MAX ||
      batch < 0 || oh < 0 || ow < 0)
    return (int)cudaErrorInvalidValue;
  return kLaunchers[dtype][stride - 1][relu6 != 0](x, taps, bias, out, batch, h, w, c, oh, ow,
                                                   pad_top, pad_left, groups, nx, th, run,
                                                   stream);
}
