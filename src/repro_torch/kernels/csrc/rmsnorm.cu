// Fused RMSNorm for Hopper (sm_90a), one pass over each row.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::_rmsnorm_kernel
// (reached through rmsnorm_pallas): y = x * rsqrt(mean(x^2) + eps) * w,
// fp32 accumulation, cast back to x's type.
//
// Design.  Each row's x and w are read from device memory once, both with
// 16-byte loads issued before the reduction, and the row stays in
// registers for the scale-and-store: one memory round trip where a second
// pass over x (and w read after the reduction) made two.
//   - The widths the models use (768, 2048, zamba2's shared block at
//     4096, the dense zoo's 6144, 8192 and 18432, deepseek-v2-236b's
//     512 (kv_norm), 1536 (q_norm) and 5120 (d_model), internvl2-1b's 896,
//     h2o-danube-3-4b's 3840) are
//     instantiated with a compile-time count of 16-byte vectors a row,
//     shared by the fewest warps that keep a lane at 2 vectors or under
//     (kMaxVecPerLane: 512 bf16 takes one warp, 768 and 896 64 threads, 1536 and
//     2048 128, 4096 256), up to the block's 256 threads, where a lane
//     takes up to 4 (f32 at 3840 and 4096, bf16 at 5120, 6144 and 8192:
//     2.5, 3 and 4 vectors); a row past 4 vectors a lane at 256 threads
//     takes more lanes, up to a block of 1,024 threads a row (f32 at 5120,
//     6144 and 8192: 512 threads, 2.5, 3 and 4 vectors; 18432: 1,024
//     threads, 3 vectors in bf16 and 5 in f32), so
//     the row still stays in registers, read once.  The warps of a row
//     meet in shared memory.  A warp a row with up to 8 vectors a lane
//     measured 0.5 us slower at 2048 (tools/kernel_variants.py).
//   - Any other width, or rows off the 16-byte grid, take a generic path
//     with no limit on the width: a warp a row, scalar loads, two passes
//     over x (the second from L1/L2), w read in the second.
// The entry reports the path it launched, and kernels/rmsnorm.py counts
// launches by path.
// empty_kernel is launched through the same library by chip_smoke.py to
// time the floor of a launch on this path.
//
// Bound on this card: memory, 2 * rows * d * itemsize bytes (x read once,
// y written once) plus w; ~4 flops per element.  At the serving shapes
// (16-256 rows) that is under 1 us, and the launch sets the time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockThreads = 256;
constexpr int kMaxVecPerLane = 2;
constexpr int kWideVecPerLane = 4;  // a lane's vectors before a row takes more than 256 threads
constexpr int kMaxRowThreads = 1024;
constexpr int kGenericRows = 8;  // rows (warps) a block on the generic path

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

// Threads that share a row of `nvec` 16-byte vectors: a warp up to
// kMaxVecPerLane vectors a lane, else the least power-of-two number of
// warps that keeps a lane at or under it, up to kBlockThreads; past
// kWideVecPerLane vectors a lane there, the least power of two up to
// kMaxRowThreads that keeps a lane at or under that.
__host__ __device__ constexpr int row_threads(int nvec) {
  int t = 32;
  while (t < kBlockThreads && nvec > t * kMaxVecPerLane) t *= 2;
  while (t < kMaxRowThreads && nvec > t * kWideVecPerLane) t *= 2;
  return t;
}

// A block's threads: kBlockThreads (rows of up to 256 threads each), or
// one row of more.
__host__ __device__ constexpr int block_threads(int nvec) {
  return row_threads(nvec) > kBlockThreads ? row_threads(nvec) : kBlockThreads;
}

// Element e of a run of T packed in 32-bit words, as fp32.
template <typename T>
__device__ __forceinline__ float word_f32(const uint32_t* v, int e) {
  if constexpr (sizeof(T) == 4) return __uint_as_float(v[e]);
  return __uint_as_float(e & 1 ? v[e >> 1] & 0xffff0000u : v[e >> 1] << 16);
}

// kVec elements of TW starting at w + e0 (e0 a multiple of kVec), as raw
// 32-bit words: 16 bytes of w of x's type, 32 of f32 w beside bf16 x, 8 of
// bf16 w beside f32 x.
template <typename TW, int kVec>
struct WVec {
  static constexpr int kWords = kVec * (int)sizeof(TW) / 4;
  uint32_t v[kWords];
  __device__ __forceinline__ void load(const TW* w, int e0) {
    if constexpr (kWords == 2) {
      const uint2 a = *reinterpret_cast<const uint2*>(w + e0);
      v[0] = a.x, v[1] = a.y;
    } else {
#pragma unroll
      for (int i = 0; i < kWords / 4; ++i) {
        const uint4 a = reinterpret_cast<const uint4*>(w + e0)[i];
        v[4 * i] = a.x, v[4 * i + 1] = a.y, v[4 * i + 2] = a.z, v[4 * i + 3] = a.w;
      }
    }
  }
  __device__ __forceinline__ float at(int e) const { return word_f32<TW>(v, e); }
};

template <typename TX, typename TW, int NVEC>
__global__ void __launch_bounds__(block_threads(NVEC))
    rmsnorm_row_kernel(const TX* __restrict__ x, const TW* __restrict__ w, TX* __restrict__ out,
                       int rows, float eps) {
  constexpr int kVec = 16 / sizeof(TX);
  constexpr int D = NVEC * kVec;
  constexpr int TPR = row_threads(NVEC);
  constexpr int RPB = block_threads(NVEC) / TPR;  // rows a block
  constexpr int VPT = (NVEC + TPR - 1) / TPR;
  constexpr int WPR = TPR / 32;  // warps a row
  const int sub = threadIdx.x % TPR;
  const int row = blockIdx.x * RPB + threadIdx.x / TPR;
  const bool live = row < rows;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * D);

  // every load of the row, x and w, before any arithmetic
  uint4 xv[VPT];
  WVec<TW, kVec> wv[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int v = k * TPR + sub;
    if (live && v < NVEC) {
      xv[k] = xr[v];
      wv[k].load(w, v * kVec);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    if (live && k * TPR + sub < NVEC) {
      const uint32_t e[4] = {xv[k].x, xv[k].y, xv[k].z, xv[k].w};
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float f = word_f32<TX>(e, i);
        ss = fmaf(f, f, ss);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if constexpr (WPR > 1) {
    __shared__ float part[block_threads(NVEC) / 32];
    const int wid = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) part[wid] = ss;
    __syncthreads();
    const float* p = part + (wid / WPR) * WPR;
    ss = p[0];
#pragma unroll
    for (int i = 1; i < WPR; ++i) ss += p[i];
  }
  if (!live) return;
  const float inv = rsqrtf(ss / (float)D + eps);
  uint4* yr = reinterpret_cast<uint4*>(out + (size_t)row * D);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int v = k * TPR + sub;
    if (v < NVEC) {
      alignas(16) TX buf[kVec];
      const uint32_t e[4] = {xv[k].x, xv[k].y, xv[k].z, xv[k].w};
#pragma unroll
      for (int i = 0; i < kVec; ++i) buf[i] = from_f32<TX>(word_f32<TX>(e, i) * inv * wv[k].at(i));
      yr[v] = *reinterpret_cast<const uint4*>(buf);
    }
  }
}

// Any width, any alignment: a warp a row, scalar loads; the scale pass
// reads x again (from L1/L2) and w.
template <typename TX, typename TW>
__global__ void __launch_bounds__(kGenericRows * 32)
    rmsnorm_generic_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                           TX* __restrict__ out, int rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kGenericRows + (threadIdx.x >> 5);
  if (row >= rows) return;
  const TX* xr = x + (size_t)row * d;
  float ss = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float f = to_f32(xr[i]);
    ss = fmaf(f, f, ss);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float inv = rsqrtf(ss / (float)d + eps);
  TX* yr = out + (size_t)row * d;
  for (int i = lane; i < d; i += 32) yr[i] = from_f32<TX>(to_f32(xr[i]) * inv * to_f32(w[i]));
}

template <typename TX, typename TW, int NVEC>
cudaError_t launch_rows(const void* x, const void* w, void* out, int rows, float eps,
                        cudaStream_t stream) {
  constexpr int BT = block_threads(NVEC), RPB = BT / row_threads(NVEC);
  rmsnorm_row_kernel<TX, TW, NVEC><<<(rows + RPB - 1) / RPB, BT, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<TX*>(out), rows, eps);
  return cudaGetLastError();
}

// Writes the path it launched to *path: 0 = one pass (an instantiated
// width, rows and w on the 16-byte grid), 1 = generic.
template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, void* out, int rows, int d, float eps, int* path,
                   cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(TX);
  constexpr int kWAlign = kVec * sizeof(TW);  // bytes of w beside one x vector
  const bool aligned = d % kVec == 0 &&
                       ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16) ==
                           0 &&
                       reinterpret_cast<uintptr_t>(w) % (kWAlign < 16 ? kWAlign : 16) == 0;
  *path = 0;
  if (aligned) {
    switch (d) {
      case 512: return launch_rows<TX, TW, 512 / kVec>(x, w, out, rows, eps, stream);
      case 768: return launch_rows<TX, TW, 768 / kVec>(x, w, out, rows, eps, stream);
      case 896: return launch_rows<TX, TW, 896 / kVec>(x, w, out, rows, eps, stream);
      case 1536: return launch_rows<TX, TW, 1536 / kVec>(x, w, out, rows, eps, stream);
      case 2048: return launch_rows<TX, TW, 2048 / kVec>(x, w, out, rows, eps, stream);
      case 3840: return launch_rows<TX, TW, 3840 / kVec>(x, w, out, rows, eps, stream);
      case 4096: return launch_rows<TX, TW, 4096 / kVec>(x, w, out, rows, eps, stream);
      case 5120: return launch_rows<TX, TW, 5120 / kVec>(x, w, out, rows, eps, stream);
      case 6144: return launch_rows<TX, TW, 6144 / kVec>(x, w, out, rows, eps, stream);
      case 8192: return launch_rows<TX, TW, 8192 / kVec>(x, w, out, rows, eps, stream);
      case 18432: return launch_rows<TX, TW, 18432 / kVec>(x, w, out, rows, eps, stream);
      default: break;
    }
  }
  *path = 1;
  rmsnorm_generic_kernel<TX, TW><<<(rows + kGenericRows - 1) / kGenericRows, kGenericRows * 32,
                                   0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<TX*>(out), rows, d, eps);
  return cudaGetLastError();
}

__global__ void empty_kernel() {}

}  // namespace

// x_dtype / w_dtype: 0 = float32, 1 = bfloat16; out has x's type; any
// rows and d.  *path gets the path launched (0 one pass, 1 generic).
// Returns cudaGetLastError() after the launch.
extern "C" int rmsnorm_fwd(int x_dtype, int w_dtype, const void* x, const void* w, void* out,
                           int rows, int d, float eps, int* path, void* stream) {
  if (rows <= 0 || d <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0) return launch<float, float>(x, w, out, rows, d, eps, path, s);
  if (x_dtype == 0 && w_dtype == 1)
    return launch<float, __nv_bfloat16>(x, w, out, rows, d, eps, path, s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float>(x, w, out, rows, d, eps, path, s);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, d, eps, path, s);
  return cudaErrorInvalidValue;
}

// One launch of a kernel that does nothing, on the same stream: the floor
// of a launch through this library.
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
