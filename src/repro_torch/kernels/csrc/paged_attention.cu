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
// Three paths, chosen by the caller (kernels/flash_decode.py::kernel_path)
// and passed in as `path`; the C entry refuses a path that does not apply.
// What the sources share (Args, the launch of the tensor-core path) is in
// csrc/paged_attention.cuh.
//
// Split-KV decode path (path 2: G*T <= 8, dk and dv in {64, 128}, f32 or
// bf16: serve and parity decode, GQA decode up to G 8).  At decode only one
// block per (batch row, kv head) would leave the card short of blocks (192
// at the serve shape, 1.45 per SM) and each block's page walk one
// dependent load after another.  Here the grid is (splits, Hkv, B): the
// host (flash_decode.py::decode_plan) picks the split count (about 2
// blocks an SM, more where a split would take over 8 rounds) and the
// round size (K and V rows within 32 KiB).  A block reads the row's offset,
// its page-table entries and Q in one round trip, turns its share of the
// row's live pages into one cache row per key, and issues the first two
// rounds of K and V rows at once as 16-byte cp.async copies in the cache's
// dtype (zero fill for unallocated pages; element loads where rows are off
// the 16-byte grid), each later round as soon as its stage of the 2-stage
// ring is free.  A round is scored from shared memory (a thread a key, Q
// in fp32 broadcast from shared memory), its probabilities taken with
// ex2.approx against the running row max, and P.V summed by (key group,
// 16-byte column group) threads in registers across rounds.  With more
// than one split, each writes (m, l, acc) to an f32 workspace; the last
// block of a (b, h) to finish (a __threadfence, then an atomic counter that
// it resets to 0) merges them, so the op stays one launch.  A query with
// nothing attendable writes zeros, an empty split contributes l = 0.
// tools/kernel_variants.py times other plans and the phases' shares
// (NVIDIA H100 80GB HBM3, 700 W; B 16, Hkv 12, dk 64, page 16): at 128-576
// keys 0.0223 ms with 2 splits of 32 KiB rounds, 0.0330 with every page of
// 3 splits in one round; at 2048-4096 keys 0.0856 ms with 5 splits of 7
// rounds.  Splits run as one thread-block cluster merging through
// distributed shared memory measured no faster at 128-576 keys and slower
// at 2048-4096: a cluster's blocks wait for its slowest split.
//
// Tensor-core path (path 1, bf16 and f32 (3xTF32) alike: from
// flash_decode.TENSOR_CORE_MIN_ROWS folded rows at dk, dv in {64, 128},
// every fold at dk = dv = 192, and every fold at MLA's dk 576 / dv 512
// with one latent pool as K and V): in csrc/paged_tensor_core.cu, and
// MLA's fold in csrc/paged_mla.cu, compiled apart so the build runs them
// in parallel; their notes there.
//
// CUDA-core path (path 0: every other call -- MLA's dk 576 / dv 512 with
// separate K and V pools, other widths, in either dtype; since the f32
// tensor-core route, no f32 fold of the widths above: the route measured
// faster at every one of them from 9 rows, parity's f32 chunk-extend and
// verify T 9 included, flash_decode.py).
// One thread block per (query tile, kv head, batch row).  The tile holds
// up to 32 / NV folded query rows (NV value columns per lane), and the
// host shrinks it while the grid would leave the card's SMs idle, so
// chunk-extend spreads over more blocks.  The block's warps split the
// row's logical pages among themselves (warp w takes pages w, w + nw,
// ...), so at decode (G*T = 1) every warp walks its own pages
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
// which the tensor cores would bound it; at the serve prefill (G*T 16) it
// is ~16 flops a byte; at granite's MQA prefill (G*T 768 over one K/V
// head) the K/V reads alone carry ~750 flops a byte, but q and out (3 MB
// each at B 16) keep the call bytes-bound.  The CUDA-core
// path stages pages synchronously (no cp.async pipeline, fp32 math); the
// tensor-core and decode paths pipeline them, read each row's K/V once a
// block, and split the keys where the grid is small.  The paths' times on
// the card are recorded against that bound in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm80.cuh"
#include "paged_attention.cuh"

namespace {

using paged::Args;
using paged::kLog2e;
using paged::kNegInf;

constexpr int kMaxWarps = 8;
constexpr int kMaxThreads = kMaxWarps * 32;

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


using mma_sm80::cp_async16;
using mma_sm80::cp_async_commit;
using mma_sm80::cp_async_wait;

// ---------------------------------------------- decode: split-KV, streamed pages
constexpr int kDecThreads = 256;
constexpr int kDecWarps = kDecThreads / 32;

__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__host__ __device__ constexpr size_t up16(size_t x) { return (x + 15) & ~(size_t)15; }

// Byte offsets into a decode block's shared memory: the row's page-table
// entries; a 2-stage ring of rounds of K and V rows (in the cache's dtype,
// rows padded by 16 bytes so a quarter warp's 16-byte reads of 8 rows hit
// distinct banks), reused for the P.V partial sums after the last round;
// a round's scores, then probabilities [QLT][round_keys]; Q in fp32
// [QLT][DK]; per-warp row maxima and sums; the running row max and sum;
// each of the split's keys' cache rows; the last-block flag.
template <typename T, int QLT, int DK, int DV>
struct DecLayout {
  static constexpr int E = 16 / (int)sizeof(T);     // elements of a 16-byte chunk
  static constexpr int KROW = DK + E, VROW = DV + E;  // padded rows, in elements
  static constexpr int NCG = DV / E;                  // P.V: 16-byte column groups
  static constexpr int NKG = kDecThreads / NCG;       // P.V: key groups
  size_t stage, ring, s, q, stats, run, rows, flag, total;
  __host__ __device__ DecLayout(int pages_per_slot, int round_keys, int split_keys) {
    stage = (size_t)round_keys * (KROW + VROW) * sizeof(T);  // bytes of one stage
    const size_t rbytes = (size_t)NKG * QLT * DV * sizeof(float);
    ring = up16((size_t)pages_per_slot * sizeof(int));
    s = ring + up16(2 * stage > rbytes ? 2 * stage : rbytes);
    q = s + up16((size_t)QLT * round_keys * sizeof(float));
    stats = q + up16((size_t)QLT * DK * sizeof(float));
    run = stats + up16((size_t)2 * kDecWarps * QLT * sizeof(float));
    rows = run + up16((size_t)2 * QLT * sizeof(float));
    flag = rows + up16((size_t)split_keys * sizeof(int));
    total = flag + 16;
  }
};

// One block per (split, kv head, batch row).  The split takes an equal
// share of the row's live pages (those at or below its last query: split
// s of n takes pages [s c, s c + c) with c = ceil(live / n)) and streams
// them in rounds of round_pages pages through a 2-stage cp.async ring: the
// first two rounds are issued at once (at the serve decode shape that is
// every page of the split), and each later one as soon as its stage is
// free, so a round's loads overlap the scoring of the one before.  The
// online softmax carries each row's max and sum across rounds; the P.V
// sums stay in registers.  QLT: the folded query rows a block computes (ql
// <= QLT; rows past ql repeat the last).
template <typename T, int QLT, int DK, int DV>
__global__ void __launch_bounds__(kDecThreads, 1)
    paged_decode_kernel(const Args a, int splits, int round_pages, int split_pages,
                        float* __restrict__ ws, int* __restrict__ counters) {
  using L = DecLayout<T, QLT, DK, DV>;
  constexpr int E = L::E, KROW = L::KROW, VROW = L::VROW, NCG = L::NCG, NKG = L::NKG;
  constexpr int KC = DK / E, VC = DV / E;  // 16-byte chunks of a K and a V row
  const int ps = a.page_size, P = a.pages_per_slot, ql = a.ql;
  const int rk = round_pages * ps;  // keys a round
  const L lay(P, rk, split_pages * ps);
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  int* tab = reinterpret_cast<int*>(sm);
  float* red = reinterpret_cast<float*>(sm + lay.ring);  // after the last round: [NKG][QLT][DV]
  float* ss = reinterpret_cast<float*>(sm + lay.s);
  float* qs = reinterpret_cast<float*>(sm + lay.q);
  float* wmax = reinterpret_cast<float*>(sm + lay.stats);  // [kDecWarps][QLT]
  float* wsum = wmax + kDecWarps * QLT;
  float* mrun = reinterpret_cast<float*>(sm + lay.run);  // [QLT] running row max, then sum
  float* lrun = mrun + QLT;
  int* rows = reinterpret_cast<int*>(sm + lay.rows);  // cache row of each key, -1 unread
  int* flag = reinterpret_cast<int*>(sm + lay.flag);

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * a.hkv + h;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* __restrict__ q = static_cast<const T*>(a.q) + (size_t)bh * ql * DK;
  const T* kh = static_cast<const T*>(a.k_pages) + (size_t)h * DK;
  const T* vh = static_cast<const T*>(a.v_pages) + (size_t)h * a.dv_store;
  const size_t k_stride = (size_t)a.hkv * DK, v_stride = (size_t)a.hkv * a.dv_store;

  // 1. the row's offset, its page-table entries and Q in one round trip
  const int off = a.offsets[b];
  for (int i = tid; i < P; i += kDecThreads) tab[i] = a.table[(size_t)b * P + i];
  for (int i = tid; i < QLT * DK; i += kDecThreads) {
    const int r = i / DK;
    qs[i] = to_f32(q[min(r, ql - 1) * DK + (i - r * DK)]);
  }
  if (tid < QLT) {
    mrun[tid] = kNegInf;
    lrun[tid] = 0.f;
  }
  __syncthreads();
  const int last_q = off + a.tokens_per_row - 1;
  const int live = last_q < 0 ? 0 : min(P, last_q / ps + 1);
  const int chunk = (live + splits - 1) / splits;  // at most split_pages
  const int j0 = min(live, split * chunk), j1 = min(live, j0 + chunk);
  const int nk = (j1 - j0) * ps;
  const int n_rounds = (nk + rk - 1) / rk;

  // 2. each key's cache row (-1 on an unallocated page: negative or >=
  // n_pages), so the copy loops divide by nothing but constants; then the
  // first two rounds' K and V rows, zero-filled where unallocated
  for (int key = tid; key < nk; key += kDecThreads) {
    const int pid = tab[j0 + key / ps];
    rows[key] = pid >= 0 && pid < a.n_pages ? pid * ps + key % ps : -1;
  }
  __syncthreads();
  auto issue = [&](int r) {  // round r into stage r % 2
    const int kb = r * rk, n = min(rk, nk - kb);
    T* ks = reinterpret_cast<T*>(sm + lay.ring + (r & 1) * lay.stage);
    T* vs = ks + rk * KROW;
    if (a.vec) {
      for (int i = tid; i < n * (KC + VC); i += kDecThreads) {
        const int key = i / (KC + VC), c = i - key * (KC + VC);
        const int row = rows[kb + key];
        if (c < KC)
          cp_async16(ks + key * KROW + c * E, kh + (row >= 0 ? row * k_stride + c * E : 0),
                     row >= 0);
        else
          cp_async16(vs + key * VROW + (c - KC) * E,
                     vh + (row >= 0 ? row * v_stride + (c - KC) * E : 0), row >= 0);
      }
    } else {  // rows off the 16-byte grid: element loads
      for (int i = tid; i < n * (DK + DV); i += kDecThreads) {
        const int key = i / (DK + DV), c = i - key * (DK + DV);
        const int row = rows[kb + key];
        if (c < DK)
          ks[key * KROW + c] = row >= 0 ? kh[row * k_stride + c] : from_f32<T>(0.f);
        else
          vs[key * VROW + c - DK] = row >= 0 ? vh[row * v_stride + c - DK] : from_f32<T>(0.f);
      }
    }
    cp_async_commit();
  };
  issue(0);
  issue(1);

  int q_pos[QLT];
#pragma unroll
  for (int r = 0; r < QLT; ++r) q_pos[r] = off + min(r, ql - 1) % a.tokens_per_row;
  const int cg = tid % NCG, kg = tid / NCG;  // P.V: this thread's columns and keys
  float acc[QLT][E];
#pragma unroll
  for (int r = 0; r < QLT; ++r)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;

  for (int rd = 0; rd < n_rounds; ++rd) {
    cp_async_wait<1>();  // this round has landed; the next may be in flight
    __syncthreads();
    const T* ks = reinterpret_cast<const T*>(sm + lay.ring + (rd & 1) * lay.stage);
    const T* vs = ks + rk * KROW;
    const int kb = rd * rk, n = min(rk, nk - kb);

    // 3. scores: thread i takes keys i, i + 256, ...; a masked key scores -inf
    float mloc[QLT];
#pragma unroll
    for (int r = 0; r < QLT; ++r) mloc[r] = kNegInf;
    for (int key = tid; key < n; key += kDecThreads) {
      const T* kr = ks + key * KROW;
      float d[QLT][2];
#pragma unroll
      for (int r = 0; r < QLT; ++r) d[r][0] = d[r][1] = 0.f;
#pragma unroll
      for (int c = 0; c < DK; c += E) {
        float f[E];
        unpack(*reinterpret_cast<const uint4*>(kr + c), f, kr);
#pragma unroll
        for (int r = 0; r < QLT; ++r)
#pragma unroll
          for (int e = 0; e < E; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qs + r * DK + c + e);
            d[r][0] = fmaf(qv.x, f[e], d[r][0]);
            d[r][1] = fmaf(qv.y, f[e + 1], d[r][1]);
            d[r][0] = fmaf(qv.z, f[e + 2], d[r][0]);
            d[r][1] = fmaf(qv.w, f[e + 3], d[r][1]);
          }
      }
      const bool in = rows[kb + key] >= 0;
      const int kv_pos = j0 * ps + kb + key;
#pragma unroll
      for (int r = 0; r < QLT; ++r) {
        float s = (d[r][0] + d[r][1]) * a.scale;
        if (a.softcap > 0.f) s = tanhf(s / a.softcap) * a.softcap;
        s = in && kv_pos <= q_pos[r] ? s : -INFINITY;
        ss[r * rk + key] = s;
        mloc[r] = fmaxf(mloc[r], s);
      }
    }
#pragma unroll
    for (int r = 0; r < QLT; ++r) {
      const float m = warp_max(mloc[r]);
      if (lane == 0) wmax[warp * QLT + r] = m;
    }
    __syncthreads();

    // 4. probabilities against the running max (>= -1e30, so a masked key
    // gives p = 0 and rows that have seen nothing keep l = 0)
    float m_new[QLT], corr[QLT], lloc[QLT];
#pragma unroll
    for (int r = 0; r < QLT; ++r) {
      m_new[r] = mrun[r];
#pragma unroll
      for (int w = 0; w < kDecWarps; ++w) m_new[r] = fmaxf(m_new[r], wmax[w * QLT + r]);
      corr[r] = ex2_ftz((mrun[r] - m_new[r]) * kLog2e);
      lloc[r] = 0.f;
    }
    for (int key = tid; key < n; key += kDecThreads) {
#pragma unroll
      for (int r = 0; r < QLT; ++r) {
        const float p = ex2_ftz((ss[r * rk + key] - m_new[r]) * kLog2e);
        ss[r * rk + key] = p;
        lloc[r] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < QLT; ++r) {
      const float l = warp_sum(lloc[r]);
      if (lane == 0) wsum[warp * QLT + r] = l;
    }
    __syncthreads();

    // 5. P.V: thread (kg, cg) rescales and adds keys kg, kg + NKG, ... of
    // the round over its 16 bytes of value columns
#pragma unroll
    for (int r = 0; r < QLT; ++r)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= corr[r];
    for (int key = kg; key < n; key += NKG) {
      float f[E];
      unpack(*reinterpret_cast<const uint4*>(vs + key * VROW + cg * E), f, vs);
#pragma unroll
      for (int r = 0; r < QLT; ++r) {
        const float p = ss[r * rk + key];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] = fmaf(p, f[e], acc[r][e]);
      }
    }
#pragma unroll
    for (int r = 0; r < QLT; ++r) {
      if (tid == r) {
        float l = lrun[r] * corr[r];
#pragma unroll
        for (int w = 0; w < kDecWarps; ++w) l += wsum[w * QLT + r];
        lrun[r] = l;
        mrun[r] = m_new[r];
      }
    }
    __syncthreads();  // the stage and the probabilities are consumed
    if (rd + 2 < n_rounds) issue(rd + 2);
    else cp_async_commit();  // keeps one group a round for the wait above
  }
  cp_async_wait<0>();
  __syncthreads();

  // 6. the key groups' sums meet in shared memory (over the ring); the
  // split's (m, l, acc) go straight to out when there is one split, else to
  // the workspace
#pragma unroll
  for (int r = 0; r < QLT; ++r)
#pragma unroll
    for (int e = 0; e < E; e += 4)
      *reinterpret_cast<float4*>(red + (kg * QLT + r) * DV + cg * E + e) =
          make_float4(acc[r][e], acc[r][e + 1], acc[r][e + 2], acc[r][e + 3]);
  __syncthreads();
  T* __restrict__ out = static_cast<T*>(a.out) + (size_t)bh * ql * DV;
  float* wsp = splits > 1 ? ws + (size_t)bh * splits * ql * (DV + 2) : nullptr;
  for (int i = tid; i < ql * DV; i += kDecThreads) {
    const int r = i / DV, d = i - r * DV;
    float o = 0.f;
#pragma unroll
    for (int g = 0; g < NKG; ++g) o += red[(g * QLT + r) * DV + d];
    if (splits == 1) {
      // a query with nothing attendable keeps l == 0 and writes zeros
      out[i] = from_f32<T>(o / fmaxf(lrun[r], 1e-30f));
    } else {
      float* slot = wsp + ((size_t)split * ql + r) * (DV + 2);
      slot[2 + d] = o;
      if (d == 0) {
        slot[0] = mrun[r];
        slot[1] = lrun[r];
      }
    }
  }
  if (splits == 1) return;

  // 7. the last split of (b, h) to finish merges them all and resets the
  // counter for the next launch on the stream
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(counters + bh, 1) == splits - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  for (int i = tid; i < ql * DV; i += kDecThreads) {
    const int r = i / DV, d = i - r * DV;
    float mx = kNegInf;
    for (int sp = 0; sp < splits; ++sp)
      mx = fmaxf(mx, __ldcg(wsp + ((size_t)sp * ql + r) * (DV + 2)));
    float l = 0.f, o = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
      const float* slot = wsp + ((size_t)sp * ql + r) * (DV + 2);
      // an empty split has m = -1e30 and l = 0: weight 0, or 1 times 0
      const float f = ex2_ftz((__ldcg(slot) - mx) * kLog2e);
      l = fmaf(__ldcg(slot + 1), f, l);
      o = fmaf(__ldcg(slot + 2 + d), f, o);
    }
    out[i] = from_f32<T>(o / fmaxf(l, 1e-30f));
  }
  if (tid == 0) counters[bh] = 0;
}

template <typename T, int QLT, int DK, int DV>
cudaError_t run_decode(Args a, int splits, int round_pages, float* ws, int* counters,
                       cudaStream_t stream) {
  int dev = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  constexpr int E = 16 / (int)sizeof(T);
  const bool aligned = ((reinterpret_cast<uintptr_t>(a.k_pages) |
                         reinterpret_cast<uintptr_t>(a.v_pages)) & 15) == 0;
  a.vec = aligned && a.dv_store % E == 0;
  const int split_pages = (a.pages_per_slot + splits - 1) / splits;  // the most a split takes
  const DecLayout<T, QLT, DK, DV> lay(a.pages_per_slot, round_pages * a.page_size,
                                      split_pages * a.page_size);
  if (lay.total > (size_t)smem_max) return cudaErrorInvalidValue;
  auto kernel = paged_decode_kernel<T, QLT, DK, DV>;
  if (lay.total > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(splits, a.hkv, a.batch), kDecThreads, lay.total, stream>>>(
      a, splits, round_pages, split_pages, ws, counters);
  return cudaGetLastError();
}

template <typename T, int QLT>
cudaError_t launch_decode_dims(const Args& a, int splits, int rp, float* ws, int* counters,
                               cudaStream_t s) {
  if (a.dk == 64 && a.dv == 64) return run_decode<T, QLT, 64, 64>(a, splits, rp, ws, counters, s);
  if (a.dk == 64 && a.dv == 128)
    return run_decode<T, QLT, 64, 128>(a, splits, rp, ws, counters, s);
  if (a.dk == 128 && a.dv == 64)
    return run_decode<T, QLT, 128, 64>(a, splits, rp, ws, counters, s);
  if (a.dk == 128 && a.dv == 128)
    return run_decode<T, QLT, 128, 128>(a, splits, rp, ws, counters, s);
  return cudaErrorInvalidValue;
}

// The decode path takes G*T <= 8 and dk, dv in {64, 128}, f32 or bf16, in
// rounds of round_pages pages; with more than one split it needs the
// workspace and the zeroed counters.
cudaError_t launch_decode(const Args& a, int dtype, int splits, int round_pages, void* ws,
                          void* counters, cudaStream_t s) {
  if (a.ql > 8 || splits < 1 || splits > (a.pages_per_slot > 1 ? a.pages_per_slot : 1) ||
      round_pages < 1 || (splits > 1 && (ws == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  float* w = static_cast<float*>(ws);
  int* c = static_cast<int*>(counters);
  if (dtype == 0)
    return a.ql == 1 ? launch_decode_dims<float, 1>(a, splits, round_pages, w, c, s)
                     : launch_decode_dims<float, 8>(a, splits, round_pages, w, c, s);
  return a.ql == 1 ? launch_decode_dims<__nv_bfloat16, 1>(a, splits, round_pages, w, c, s)
                   : launch_decode_dims<__nv_bfloat16, 8>(a, splits, round_pages, w, c, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pages and out share it).  table and
// offsets are int32.  path: 0 = the CUDA-core kernel (every shape), 1 = the
// tensor-core kernel (bf16, and f32 at MLA's fold), 2 = the split-KV
// decode kernel (paths 1 and 2 are refused with cudaErrorInvalidValue
// where they do not apply).  splits: the
// key splits of paths 1 and 2; round_pages: the pages a path-2 split loads
// a round; groups: path 1's row groups (flash_decode.tensor_core_plan).
// With more than one split, workspace holds batch * hkv * splits * ql *
// (dv + 2) floats and counters batch * hkv (path 2) or batch * hkv * groups
// (path 1) int32 that are zero before the launch and zero again after it
// (both may be null with one split, and on path 1 at MLA's dk 576 / dv 512,
// whose splits merge in a thread-block cluster).  Returns
// cudaGetLastError() after the launch.
extern "C" int paged_attention_fwd(int dtype, const void* q, const void* k_pages,
                                   const void* v_pages, const void* table, const void* offsets,
                                   void* out, int batch, int hkv, int ql, int dk, int n_pages,
                                   int page_size, int pages_per_slot, int dv_store, int dv,
                                   int tokens_per_row, float scale, float softcap, int path,
                                   int splits, int round_pages, int groups, void* workspace,
                                   void* counters, void* stream) {
  if (batch <= 0 || hkv <= 0 || ql <= 0 || dk <= 0 || dv <= 0 || page_size <= 0 ||
      tokens_per_row <= 0 || dv > dv_store)
    return cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, static_cast<const int*>(table),
               static_cast<const int*>(offsets), out, batch, hkv, ql, dk, n_pages, page_size,
               pages_per_slot, dv_store, dv, tokens_per_row, scale, softcap, 0, 0, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (path == 1) return paged::launch_tc(a, dtype, groups, splits, workspace, counters, s);
  if (path == 2) return launch_decode(a, dtype, splits, round_pages, workspace, counters, s);
  if (path != 0) return cudaErrorInvalidValue;
#define PAGED_LAUNCH(NV) \
  return dtype == 0 ? launch<float, NV>(a, s) : launch<__nv_bfloat16, NV>(a, s)
  if (dv <= 64) PAGED_LAUNCH(2);
  if (dv <= 128) PAGED_LAUNCH(4);
  if (dv <= 256) PAGED_LAUNCH(8);
  if (dv <= 512) PAGED_LAUNCH(16);
#undef PAGED_LAUNCH
  return cudaErrorInvalidValue;
}
