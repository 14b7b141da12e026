// Fused RMSNorm for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::_rmsnorm_kernel
// (reached through rmsnorm_pallas): y = x * rsqrt(mean(x^2) + eps) * w,
// fp32 accumulation, cast back to x's type.
//
// Design.  One warp per row, 8 rows per 256-thread block, any number of
// rows and any width d.  Pass one accumulates the fp32 sum of squares
// with 16-byte vector loads and a warp-shuffle reduction; pass two
// re-reads the row (now in L1/L2), scales by rsqrt(mean + eps) and w,
// and stores with 16-byte vector stores.  The vector path needs d to be
// a multiple of the vector width (4 fp32 / 8 bf16) and 16-byte aligned
// rows; otherwise the same two passes run on scalar loads, so a ragged
// width is handled whole.  The TPU wrapper's power-of-two block_rows
// search has no counterpart here.
//
// Bound on this card: memory, 2 * rows * d * itemsize bytes (x read once,
// y written once) plus w; ~4 flops per element is far below the compute
// roof.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kThreads = kRowsPerBlock * 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads) rmsnorm_kernel(const TX* __restrict__ x,
                                                           const TW* __restrict__ w,
                                                           TX* __restrict__ out, int rows, int d,
                                                           float eps, bool vec) {
  constexpr int kVec = 16 / sizeof(TX);
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const TX* xr = x + (size_t)row * d;
  TX* yr = out + (size_t)row * d;

  float ss = 0.f;
  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = lane; i < d / kVec; i += 32) {
      alignas(16) TX buf[kVec];
      *reinterpret_cast<uint4*>(buf) = xv[i];
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float f = to_f32(buf[e]);
        ss = fmaf(f, f, ss);
      }
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      const float f = to_f32(xr[i]);
      ss = fmaf(f, f, ss);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float inv = rsqrtf(ss / (float)d + eps);

  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4* yv = reinterpret_cast<uint4*>(yr);
    for (int i = lane; i < d / kVec; i += 32) {
      alignas(16) TX buf[kVec];
      *reinterpret_cast<uint4*>(buf) = xv[i];
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        buf[e] = from_f32<TX>(to_f32(buf[e]) * inv * to_f32(w[i * kVec + e]));
      yv[i] = *reinterpret_cast<const uint4*>(buf);
    }
  } else {
    for (int i = lane; i < d; i += 32) yr[i] = from_f32<TX>(to_f32(xr[i]) * inv * to_f32(w[i]));
  }
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, void* out, int rows, int d, float eps,
                   cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(TX);
  const bool vec = d % kVec == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  rmsnorm_kernel<TX, TW><<<blocks, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<TX*>(out), rows, d, eps,
      vec);
  return cudaGetLastError();
}

}  // namespace

// x_dtype / w_dtype: 0 = float32, 1 = bfloat16; out has x's type.
// Returns cudaGetLastError() after the launch.
extern "C" int rmsnorm_fwd(int x_dtype, int w_dtype, const void* x, const void* w, void* out,
                           int rows, int d, float eps, void* stream) {
  if (rows <= 0 || d <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0) return launch<float, float>(x, w, out, rows, d, eps, s);
  if (x_dtype == 0 && w_dtype == 1)
    return launch<float, __nv_bfloat16>(x, w, out, rows, d, eps, s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float>(x, w, out, rows, d, eps, s);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, d, eps, s);
  return cudaErrorInvalidValue;
}
