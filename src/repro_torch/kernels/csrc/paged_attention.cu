// Paged flash-decode / chunk-extend attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py::_paged_kernel
// (reached through paged_flash_attention_folded).  It computes the same
// function: online-softmax attention of group-major-folded queries
// q (B, Hkv, QL = G*T, dk) against KV pages reached through page_table,
// query i at position offsets[b] + i % T, mask kv_pos <= q_pos, optional
// tanh softcap, values from the first v_width columns of a page (MLA),
// and zeros for a query with nothing to attend.
//
// Design.  One thread block per (query tile, kv head, batch row).  The
// tile holds up to 32 / NV folded query rows (NV value columns per lane),
// and the host shrinks it while the grid would leave the card's SMs
// idle, so chunk-extend spreads over more blocks.  The block's warps
// split the row's logical pages among themselves (warp w takes pages w,
// w + nw, ...), so at decode (G*T = 1) every warp walks its own pages
// instead of one warp computing while the others wait at barriers.  Each
// warp keeps m, l and an output accumulator for every row of the tile in
// registers, stages its page through its own slice of shared memory in
// tiles of kt keys (16-byte loads where the layout allows, all of a tile's
// loads in flight before any store, converted to fp32), and needs only
// __syncwarp.  A key is scored by 32 / kt lanes, each taking an
// interleaved share of dk, so a 16-key page keeps all 32 lanes busy; each
// staged key and value element is read once for all rows of the tile,
// whose independent chains give the lane its parallelism.  The warps'
// partial softmax states are merged through
// shared memory at the end.  The block reads page_table[b, j] and
// offsets[b] itself and never loads a page that lies past the row's last
// query or whose table entry is the unallocated sentinel (>= n_pages).
// Masked keys contribute exactly zero, so the result equals the
// gather-then-softmax oracle even for a row whose first pages are masked.
//
// Bound on this card: memory.  The work must read the attended K/V pages
// once (sum over rows of ceil((last_q + 1) / page_size) pages of
// page_size * Hkv * (dk + dv) elements) plus q and write out; at decode
// (T = 1) that is ~1 flop per byte, far under the ~295 flop/byte at
// which the tensor cores would bound it.  Pages are staged synchronously
// (no cp.async/TMA pipeline, no split-KV across blocks, CUDA-core fp32
// math): its time on the card is recorded against that byte bound in
// PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kMaxThreads = kMaxWarps * 32;
constexpr float kNegInf = -1e30f;  // the reference's mask value

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

__device__ __forceinline__ void unpack(const uint4& r, float* f, const float*) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ void unpack(const uint4& r, float* f, const __nv_bfloat16*) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// What a launch needs; the launcher fills in the last three.
struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int* table;
  const int* offsets;
  void* out;
  int batch, hkv, ql, dk, n_pages, page_size, pages_per_slot, dv_store, dv, tokens_per_row;
  float scale, softcap;
  int kt;         // keys per staged tile: a power of two dividing 32, at most a page
  int ks_stride;  // shared-memory row stride of a staged key
  int vec;        // 16-byte global loads are aligned
};

// One warp copies a tile of nk keys -- dk key elements (global row stride
// k_stride) and dv value elements (v_stride) each -- into fp32 shared
// memory: keys at ks[key * ks_stride], values at ks[vs_off + key * dv].
// With `vec`, a lane issues up to kBatch 16-byte loads of K and V before it
// stores any, so a 16-key page costs one round trip to memory rather than
// one per load.
constexpr int kBatch = 8;

template <typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ k_src, size_t k_stride,
                                           const T* __restrict__ v_src, size_t v_stride, int dk,
                                           int dv, float* ks, int ks_stride, int vs_off, int nk,
                                           int lane, bool vec) {
  constexpr int E = 16 / sizeof(T);
  if (vec) {
    const int pk = dk / E, pv = dv / E;
    const int n_k = nk * pk, n = n_k + nk * pv;
    for (int i0 = lane; i0 < n; i0 += 32 * kBatch) {
      uint4 raw[kBatch];
      int dst[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + 32 * u;
        dst[u] = -1;
        if (i < n_k) {
          const int r = i / pk;
          const int c = (i - r * pk) * E;
          raw[u] = *reinterpret_cast<const uint4*>(k_src + r * k_stride + c);
          dst[u] = r * ks_stride + c;
        } else if (i < n) {
          const int iv = i - n_k;
          const int r = iv / pv;
          const int c = (iv - r * pv) * E;
          raw[u] = *reinterpret_cast<const uint4*>(v_src + r * v_stride + c);
          dst[u] = vs_off + r * dv + c;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (dst[u] >= 0) {
          float f[E];
          unpack(raw[u], f, k_src);
#pragma unroll
          for (int e = 0; e < E; ++e) ks[dst[u] + e] = f[e];
        }
      }
    }
  } else {
    for (int i = lane; i < nk * dk; i += 32) {
      const int r = i / dk;
      ks[r * ks_stride + (i - r * dk)] = to_f32(k_src[r * k_stride + (i - r * dk)]);
    }
    for (int i = lane; i < nk * dv; i += 32) {
      const int r = i / dv;
      ks[vs_off + r * dv + (i - r * dv)] = to_f32(v_src[r * v_stride + (i - r * dv)]);
    }
  }
}

// NV: value columns per lane (dv <= 32 * NV).  ROWS: folded query rows per
// block; a ragged last tile pads by repeating its last row, so no loop over
// rows needs a guard.
template <typename T, int NV, int ROWS>
__global__ void __launch_bounds__(kMaxThreads) paged_attention_kernel(const Args a) {
  // independent dot-product chains per lane: at least 4 between the rows
  constexpr int kParts = ROWS >= 4 ? 1 : 4 / ROWS;
  extern __shared__ float smem[];
  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ k_pages = static_cast<const T*>(a.k_pages);
  const T* __restrict__ v_pages = static_cast<const T*>(a.v_pages);
  const int nw = blockDim.x >> 5;
  const int q0 = blockIdx.x * ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rows = min(ROWS, a.ql - q0);
  const int dk = a.dk, dv = a.dv, kt = a.kt, ks_stride = a.ks_stride;
  const int key = lane & (kt - 1);  // the tile key this lane scores
  const int lpk = 32 / kt;          // lanes per key
  const int sub = lane / kt;        // this lane's share of dk: d = sub, sub + lpk, ...
  const int vs_off = kt * ks_stride;
  float* qs = smem;                                          // [ROWS][dk], pre-scaled
  float* ks = qs + ROWS * dk + warp * (vs_off + kt * dv);    // this warp's K then V tile
  const float* vs = ks + vs_off;

  const size_t q_base = ((size_t)(b * a.hkv + h) * a.ql + q0) * dk;
  for (int i = tid; i < ROWS * dk; i += blockDim.x) {
    const int r = i / dk;
    qs[i] = to_f32(q[q_base + min(r, rows - 1) * dk + (i - r * dk)]) * a.scale;
  }
  __syncthreads();

  const int off = a.offsets[b];
  const int last_q = off + a.tokens_per_row - 1;
  const size_t k_stride = (size_t)a.hkv * dk;
  const size_t v_stride = (size_t)a.hkv * a.dv_store;

  int q_pos[ROWS];
  float m[ROWS], l[ROWS], acc[ROWS][NV];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    q_pos[r] = off + (q0 + min(r, rows - 1)) % a.tokens_per_row;
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c) acc[r][c] = 0.f;
  }

  for (int j = warp; j < a.pages_per_slot; j += nw) {
    const int page0 = j * a.page_size;
    if (page0 > last_q) break;  // this and every later page lies past the last query
    const int pid = a.table[b * a.pages_per_slot + j];
    if (pid < 0 || pid >= a.n_pages) continue;  // unallocated: nothing is read
    for (int k0 = 0; k0 < a.page_size && page0 + k0 <= last_q; k0 += kt) {
      const int nk = min(kt, a.page_size - k0);
      const size_t row0 = (size_t)pid * a.page_size + k0;
      __syncwarp();  // the warp's previous tile is consumed
      stage_tile(k_pages + row0 * k_stride + (size_t)h * dk, k_stride,
                 v_pages + row0 * v_stride + (size_t)h * a.dv_store, v_stride, dk, dv, ks,
                 ks_stride, vs_off, nk, lane, a.vec);
      __syncwarp();
      const int kv_pos = page0 + k0 + key;
      // scores: each staged key element is read once for every row
      float dot[kParts][ROWS];
#pragma unroll
      for (int pp = 0; pp < kParts; ++pp)
#pragma unroll
        for (int r = 0; r < ROWS; ++r) dot[pp][r] = 0.f;
      if (key < nk) {
        const float* kr = ks + key * ks_stride;
        int d = sub;
        for (; d + (kParts - 1) * lpk < dk; d += kParts * lpk) {
#pragma unroll
          for (int pp = 0; pp < kParts; ++pp) {
            const float kd = kr[d + pp * lpk];
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
              dot[pp][r] = fmaf(qs[r * dk + d + pp * lpk], kd, dot[pp][r]);
          }
        }
        for (; d < dk; d += lpk) {
          const float kd = kr[d];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) dot[0][r] = fmaf(qs[r * dk + d], kd, dot[0][r]);
        }
      }
      // online softmax; one lane per key carries its probability
      float p[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float dr = dot[0][r];
#pragma unroll
        for (int pp = 1; pp < kParts; ++pp) dr += dot[pp][r];
        for (int o = kt; o < 32; o <<= 1) dr += __shfl_xor_sync(0xffffffffu, dr, o);
        const bool valid = key < nk && kv_pos <= q_pos[r];
        float s = kNegInf;
        if (valid) s = a.softcap > 0.f ? tanhf(dr / a.softcap) * a.softcap : dr;
        const float m_new = fmaxf(m[r], warp_max(s));
        p[r] = (valid && sub == 0) ? expf(s - m_new) : 0.f;
        const float corr = expf(m[r] - m_new);
        l[r] = l[r] * corr + warp_sum(p[r]);
#pragma unroll
        for (int c = 0; c < NV; ++c) acc[r][c] *= corr;
        m[r] = m_new;
      }
      // values: each staged value element is read once for every row
      for (int kk = 0; kk < nk; ++kk) {
        float v[NV];
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          const int d = lane + 32 * c;
          v[c] = d < dv ? vs[kk * dv + d] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float pk = __shfl_sync(0xffffffffu, p[r], kk);
#pragma unroll
          for (int c = 0; c < NV; ++c) acc[r][c] = fmaf(pk, v[c], acc[r][c]);
        }
      }
    }
  }

  // Merge the warps' partial states: red[w][r] = {m, l, acc[0 .. dv)}.
  __syncthreads();  // every warp is done with its staging slice
  float* red = smem;
  const int rstride = dv + 2;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float* slot = red + (warp * ROWS + r) * rstride;
    if (lane == 0) {
      slot[0] = m[r];
      slot[1] = l[r];
    }
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int d = lane + 32 * c;
      if (d < dv) slot[2 + d] = acc[r][c];
    }
  }
  __syncthreads();
  T* __restrict__ out = static_cast<T*>(a.out);
  for (int i = tid; i < rows * dv; i += blockDim.x) {
    const int r = i / dv;
    const int d = i - r * dv;
    float mx = kNegInf;
    for (int w = 0; w < nw; ++w) mx = fmaxf(mx, red[(w * ROWS + r) * rstride]);
    float lsum = 0.f, acc_d = 0.f;
    for (int w = 0; w < nw; ++w) {
      const float* slot = red + (w * ROWS + r) * rstride;
      const float f = expf(slot[0] - mx);
      lsum = fmaf(slot[1], f, lsum);
      acc_d = fmaf(slot[2 + d], f, acc_d);
    }
    // a query with nothing attendable keeps l == 0 and writes zeros
    out[((size_t)(b * a.hkv + h) * a.ql + q0 + r) * dv + d] =
        from_f32<T>(acc_d / fmaxf(lsum, 1e-30f));
  }
}

// Shared-memory row stride for staged keys: congruent to 32 / kt mod 32, so
// the lanes scoring a tile (key = lane % kt, d = lane / kt + i * 32 / kt)
// hit 32 distinct banks.
inline int key_stride(int dk, int kt) {
  const int lpk = 32 / kt;
  return dk + (((lpk - dk) % 32) + 32) % 32;
}

inline size_t smem_bytes(int nw, int kt, int rows, int dk, int dv) {
  const size_t stage = (size_t)rows * dk + (size_t)nw * kt * (key_stride(dk, kt) + dv);
  const size_t merge = (size_t)nw * rows * (dv + 2);
  return sizeof(float) * (stage > merge ? stage : merge);
}

template <typename T, int NV, int ROWS>
cudaError_t run(Args a, int smem_max, cudaStream_t stream) {
  int kt = 32;
  while (kt > a.page_size) kt >>= 1;
  // Warps per block: as many as shared memory allows (then smaller tiles).
  int nw = kMaxWarps;
  while (smem_bytes(nw, kt, ROWS, a.dk, a.dv) > (size_t)smem_max) {
    if (nw > 1)
      nw >>= 1;
    else if (kt > 1)
      kt >>= 1;
    else
      return cudaErrorInvalidValue;
  }
  constexpr int E = 16 / sizeof(T);
  const bool aligned = ((reinterpret_cast<uintptr_t>(a.k_pages) |
                         reinterpret_cast<uintptr_t>(a.v_pages)) & 15) == 0;
  a.kt = kt;
  a.ks_stride = key_stride(a.dk, kt);
  a.vec = aligned && a.dk % E == 0 && a.dv % E == 0 && a.dv_store % E == 0;
  const size_t smem = smem_bytes(nw, kt, ROWS, a.dk, a.dv);
  auto kernel = paged_attention_kernel<T, NV, ROWS>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.ql + ROWS - 1) / ROWS, a.hkv, a.batch);
  kernel<<<grid, nw * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int NV>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int kRows = 32 / NV;  // a lane holds kRows * NV accumulators
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  // Query rows per block: the power of two covering QL (at most kRows),
  // halved while the grid would give the card under four blocks per SM.
  int rows = 1;
  while (rows < a.ql && rows < kRows) rows <<= 1;
  while (rows > 1 && (long)((a.ql + rows - 1) / rows) * a.hkv * a.batch < 4L * sms) rows >>= 1;
  if (rows == 1) return run<T, NV, 1>(a, smem_max, stream);
  if (rows == 2) return run<T, NV, 2>(a, smem_max, stream);
  if constexpr (kRows >= 4)
    if (rows == 4) return run<T, NV, 4>(a, smem_max, stream);
  if constexpr (kRows >= 8)
    if (rows == 8) return run<T, NV, 8>(a, smem_max, stream);
  if constexpr (kRows >= 16)
    if (rows == 16) return run<T, NV, 16>(a, smem_max, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pages and out share it).  table and
// offsets are int32.  Returns cudaGetLastError() after the launch.
extern "C" int paged_attention_fwd(int dtype, const void* q, const void* k_pages,
                                   const void* v_pages, const void* table, const void* offsets,
                                   void* out, int batch, int hkv, int ql, int dk, int n_pages,
                                   int page_size, int pages_per_slot, int dv_store, int dv,
                                   int tokens_per_row, float scale, float softcap,
                                   void* stream) {
  if (batch <= 0 || hkv <= 0 || ql <= 0 || dk <= 0 || dv <= 0 || page_size <= 0 ||
      tokens_per_row <= 0 || dv > dv_store)
    return cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, static_cast<const int*>(table),
               static_cast<const int*>(offsets), out, batch, hkv, ql, dk, n_pages, page_size,
               pages_per_slot, dv_store, dv, tokens_per_row, scale, softcap, 0, 0, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
#define PAGED_LAUNCH(NV) \
  return dtype == 0 ? launch<float, NV>(a, s) : launch<__nv_bfloat16, NV>(a, s)
  if (dv <= 64) PAGED_LAUNCH(2);
  if (dv <= 128) PAGED_LAUNCH(4);
  if (dv <= 256) PAGED_LAUNCH(8);
  if (dv <= 512) PAGED_LAUNCH(16);
#undef PAGED_LAUNCH
  return cudaErrorInvalidValue;
}
