// Flash attention (full-sequence forward) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (reached through flash_attention_bhsd).  It computes the same function:
// for q (BH, Sq, HD) against k, v (BH, Skv, HD), logits q.k * 1/sqrt(HD) in
// fp32, the causal mask k_pos <= q_pos and the sliding window
// k_pos > q_pos - window (positions count from 0 in both), an online softmax
// over key tiles with fp32 state, P.V accumulated in fp32 (the TPU body
// converts V to fp32; the bf16 path below feeds the tensor cores P rounded
// to bf16), l clamped at 1e-30, and the output cast to q's type.
//
// Design.  Two kernels share the contract.  Both give one block of 4 warps
// to a (bh, tile of query rows) pair and walk the key tiles themselves:
// the TPU carries (m, l, acc) in VMEM across the sequential KV axis of its
// grid; here that state lives in registers.  The loop starts at the first
// tile the window lets the tile's first row see and stops after the tile
// holding the last row's diagonal when causal: the TPU's pl.when skip of
// wholly masked tiles, done as loop bounds.  A masked key gets p = 0, so a
// row whose first tiles are wholly masked carries no weight from them (the
// TPU body gives such a row exp(0) and relies on a later tile's correction;
// the two agree for every row that sees its own position).  Query tiles run
// heaviest-first (grid.y counts them from the end), so causal blocks with
// long key ranges start before short ones.
//
// - bf16 (flash_mma_kernel): FA2-style on the tensor cores with
//   mma.sync.m16n8k16 (bf16 in, fp32 accumulate).  A warp owns 16 query
//   rows; Q is loaded once into A fragments, and each 64-key tile of K and
//   V is copied to shared memory with cp.async (rows padded by 16 bytes, so
//   ldmatrix reads hit distinct banks).  S = Q.K^T comes from ldmatrix'd K
//   fragments; the online softmax runs on the accumulator fragments (a row
//   spans a quad of lanes); P is packed to bf16 straight from those
//   fragments into the A operand of P.V, with V fragments from
//   ldmatrix.trans.  The logits are exact fp32 sums of exact bf16 products;
//   rounding P to bf16 for the product is what the bf16 tolerance (2e-2)
//   covers.  Loads are not pipelined and no wgmma/TMA is used yet.
// - float32 (flash_f32_kernel): CUDA-core fp32 math, no TF32, so f32 holds
//   2e-5.  A warp owns R rows;
//   each step stages 32 keys and their values in shared memory as fp32;
//   lane j scores key j for all R rows (Q read as broadcast float4s, K rows
//   padded so a warp's float4 reads hit distinct banks), the row max is a
//   warp reduction, each lane keeps a partial row sum, and the
//   probabilities go through a per-warp shared-memory slice to the P.V
//   product, where a lane owns output columns lane, lane + 32, ...
//
// Bound on this card: the work must read q, k and v once and write out
// once, and for causal attention do about 2 * BH * S^2 * HD multiply-adds'
// worth of flops (QK and PV over the lower triangle).  At S = 512 and
// HD = 64 in bf16 that is ~64 flops a byte, below the ~295 at which the
// tensor cores bound it, so bytes bound short sequences and the
// tensor-core rate bounds long ones; in f32 the 67 TFLOP/s CUDA-core rate
// bounds both.  The kernels' times on the card are recorded against that
// bound in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBK = 32;  // keys per staged tile: one per lane
constexpr float kNegInf = -1e30f;  // the reference's mask value

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

// Rows [row0, row0 + rows) of a (n_rows, HD) float matrix into shared memory
// at dst[r * stride] with 16-byte copies, zeros past n_rows.
template <int HD>
__device__ __forceinline__ void stage_rows(const float* __restrict__ src, int row0, int n_rows,
                                           float* dst, int stride, int rows) {
  constexpr int kPerRow = HD / 4;
  for (int i = threadIdx.x; i < rows * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i - r * kPerRow) * 4;
    *reinterpret_cast<float4*>(dst + r * stride + c) =
        row0 + r < n_rows
            ? *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * HD + c)
            : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int sq, skv;
  float scale;
  int causal, window;
};

template <int HD, int R>
constexpr size_t smem_floats() {
  // Q tile, K tile (rows padded by 4), V tile, per-warp probabilities
  return (size_t)kWarps * R * HD + (size_t)kBK * (HD + 4) + (size_t)kBK * HD +
         (size_t)kWarps * R * kBK;
}

template <int HD, int R>
__global__ void __launch_bounds__(kThreads) flash_f32_kernel(const Args a) {
  constexpr int NC = HD / 32;  // output columns per lane
  constexpr int BQ = kWarps * R;
  constexpr int KS = HD + 4;  // K row stride: float4 reads of 8 lanes hit distinct banks
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [BQ][HD]
  float* ks = qs + BQ * HD;                     // [kBK][KS]
  float* vs = ks + kBK * KS;                    // [kBK][HD]
  float* ps = vs + kBK * HD;                    // [kWarps][R][kBK]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest query tiles first
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* __restrict__ qg = static_cast<const float*>(a.q) + (size_t)bh * a.sq * HD;
  const float* __restrict__ kg = static_cast<const float*>(a.k) + (size_t)bh * a.skv * HD;
  const float* __restrict__ vg = static_cast<const float*>(a.v) + (size_t)bh * a.skv * HD;
  stage_rows<HD>(qg, q0, a.sq, qs, HD, BQ);

  // the keys any row of this tile may see
  int k_end = a.skv;
  if (a.causal) k_end = min(a.skv, q0 + BQ);
  int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  k_begin -= k_begin % kBK;

  const int r0 = q0 + warp * R;  // this warp's first query row
  const float* qw = qs + warp * R * HD;
  float* pw = ps + warp * R * kBK;
  float m[R], l[R], acc[R][NC];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;  // this lane's share of the row sum
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // Q is staged; the previous tile is consumed
    stage_rows<HD>(kg, k0, a.skv, ks, KS, kBK);
    stage_rows<HD>(vg, k0, a.skv, vs, HD, kBK);
    __syncthreads();

    // scores: lane j takes key k0 + j for every row of the warp
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
    const float* kr = ks + lane * KS;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + r * HD + d);
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }
    // online softmax; a masked key carries p = 0
    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qpos = r0 + r;
      const bool valid = kpos < a.skv && (!a.causal || kpos <= qpos) &&
                         (a.window <= 0 || kpos > qpos - a.window);
      const float sv = valid ? s[r] * a.scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float p = valid ? expf(sv - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);
      l[r] = fmaf(l[r], corr, p);
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= corr;
      m[r] = m_new;
      pw[r * kBK + lane] = p;
    }
    __syncwarp();
    // P.V: lane owns columns lane + 32 c
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float vv[4][NC];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < NC; ++c) vv[u][c] = vs[(kk + u) * HD + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 pv = *reinterpret_cast<const float4*>(pw + r * kBK + kk);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc[r][c] = fmaf(pv.x, vv[0][c], acc[r][c]);
          acc[r][c] = fmaf(pv.y, vv[1][c], acc[r][c]);
          acc[r][c] = fmaf(pv.z, vv[2][c], acc[r][c]);
          acc[r][c] = fmaf(pv.w, vv[3][c], acc[r][c]);
        }
      }
    }
    __syncwarp();  // pw is rewritten by the next tile
  }

  float* __restrict__ og = static_cast<float*>(a.out) + (size_t)bh * a.sq * HD;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    // a row with nothing attendable keeps l == 0 and writes zeros
    const float lsum = fmaxf(warp_sum(l[r]), 1e-30f);
    if (r0 + r < a.sq) {
#pragma unroll
      for (int c = 0; c < NC; ++c) og[(size_t)(r0 + r) * HD + lane + 32 * c] = acc[r][c] / lsum;
    }
  }
}

// ------------------------------------------------------ bf16 tensor-core path
constexpr int kMmaRows = 64;  // query rows per block: 16 per warp
constexpr int kMmaKeys = 64;  // keys per staged tile

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16x8 fp32) += a (16x16 bf16, row-major) * b (16x8 bf16, col-major)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, zero-filled when !valid (src then unread)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [row0, row0 + rows) of a (n_rows, HD) bf16 matrix into shared memory
// with row stride HD + 8, zeros past n_rows.
template <int HD>
__device__ __forceinline__ void copy_rows_async(const __nv_bfloat16* __restrict__ src, int row0,
                                                int n_rows, __nv_bfloat16* dst, int rows) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * 8;
    const bool ok = row0 + r < n_rows;
    cp_async16(dst + r * (HD + 8) + c, src + (size_t)(ok ? row0 + r : 0) * HD + c, ok);
  }
}

template <int HD>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)(kMmaRows + 2 * kMmaKeys) * (HD + 8);
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_mma_kernel(const Args a) {
  constexpr int LD = HD + 8;   // padded shared row, in bf16
  constexpr int KC = HD / 16;  // k-steps of Q.K^T
  constexpr int DT = HD / 8;   // 8-wide output column tiles
  extern __shared__ float4 smem4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem4);  // [kMmaRows][LD]
  __nv_bfloat16* ks = qs + kMmaRows * LD;                         // [kMmaKeys][LD]
  __nv_bfloat16* vs = ks + kMmaKeys * LD;                         // [kMmaKeys][LD]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kMmaRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: this lane's matrix and row
  const int g = lane >> 2, tq = lane & 3;   // accumulator: row g (and g + 8), cols 2 tq
  const __nv_bfloat16* __restrict__ qg =
      static_cast<const __nv_bfloat16*>(a.q) + (size_t)bh * a.sq * HD;
  const __nv_bfloat16* __restrict__ kg =
      static_cast<const __nv_bfloat16*>(a.k) + (size_t)bh * a.skv * HD;
  const __nv_bfloat16* __restrict__ vg =
      static_cast<const __nv_bfloat16*>(a.v) + (size_t)bh * a.skv * HD;

  copy_rows_async<HD>(qg, q0, a.sq, qs, kMmaRows);
  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[KC][4];  // this warp's 16 rows as A fragments
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
    ldmatrix_x4(qf[kc], qs + (warp * 16 + (mi & 1) * 8 + mr) * LD + kc * 16 + (mi >> 1) * 8);

  int k_end = a.skv;
  if (a.causal) k_end = min(a.skv, q0 + kMmaRows);
  int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  k_begin -= k_begin % kMmaKeys;

  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;  // l: this lane's share
  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kMmaKeys) {
    __syncthreads();  // the previous tile is consumed
    copy_rows_async<HD>(kg, k0, a.skv, ks, kMmaKeys);
    copy_rows_async<HD>(vg, k0, a.skv, vs, kMmaKeys);
    cp_async_wait_all();
    __syncthreads();

    float s[8][4];  // 16 rows x 64 keys: 8 key tiles of 8
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int nt = 0; nt < 8; nt += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, ks + (nt * 8 + (mi >> 1) * 8 + mr) * LD + kc * 16 + (mi & 1) * 8);
        mma_bf16(s[nt], qf[kc], b[0], b[1]);
        mma_bf16(s[nt + 1], qf[kc], b[2], b[3]);
      }
    }
    // scale, mask (only a tile that may hold masked keys), row max
    const bool full = k0 + kMmaKeys <= a.skv && (!a.causal || k0 + kMmaKeys - 1 <= q0) &&
                      (a.window <= 0 || k0 > q0 + kMmaRows - 1 - a.window);
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float va = s[nt][j] * a.scale, vb = s[nt][2 + j] * a.scale;
        if (!full) {
          const int key = k0 + nt * 8 + tq * 2 + j;
          const bool in = key < a.skv;
          if (!(in && (!a.causal || key <= row_a) && (a.window <= 0 || key > row_a - a.window)))
            va = kNegInf;
          if (!(in && (!a.causal || key <= row_b) && (a.window <= 0 || key > row_b - a.window)))
            vb = kNegInf;
        }
        s[nt][j] = va;
        s[nt][2 + j] = vb;
        mx_a = fmaxf(mx_a, va);
        mx_b = fmaxf(mx_b, vb);
      }
    }
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {  // a row spans the 4 lanes of a quad
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o2));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float corr_a = __expf(m_a - mn_a), corr_b = __expf(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float pa = s[nt][j] <= kNegInf ? 0.f : __expf(s[nt][j] - mn_a);
        const float pb = s[nt][2 + j] <= kNegInf ? 0.f : __expf(s[nt][2 + j] - mn_b);
        s[nt][j] = pa;
        s[nt][2 + j] = pb;
        sum_a += pa;
        sum_b += pb;
      }
    }
    l_a = fmaf(l_a, corr_a, sum_a);
    l_b = fmaf(l_b, corr_b, sum_b);
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= corr_a;
      o[dt][1] *= corr_a;
      o[dt][2] *= corr_b;
      o[dt][3] *= corr_b;
    }
    // O += P.V: the accumulator fragments of two key tiles are the A
    // fragment of one 16-key step
#pragma unroll
    for (int kc = 0; kc < kMmaKeys / 16; ++kc) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vs + (kc * 16 + (mi & 1) * 8 + mr) * LD + (dt + (mi >> 1)) * 8);
        mma_bf16(o[dt], pa, b[0], b[1]);
        mma_bf16(o[dt + 1], pa, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int o2 = 1; o2 < 4; o2 <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o2);
  }
  // a row with nothing attendable keeps l == 0 and writes zeros
  l_a = fmaxf(l_a, 1e-30f);
  l_b = fmaxf(l_b, 1e-30f);
  __nv_bfloat16* __restrict__ og = static_cast<__nv_bfloat16*>(a.out) + (size_t)bh * a.sq * HD;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = dt * 8 + tq * 2;
    if (row_a < a.sq)
      *reinterpret_cast<uint32_t*>(og + (size_t)row_a * HD + col) =
          pack_bf16(o[dt][0] / l_a, o[dt][1] / l_a);
    if (row_b < a.sq)
      *reinterpret_cast<uint32_t*>(og + (size_t)row_b * HD + col) =
          pack_bf16(o[dt][2] / l_b, o[dt][3] / l_b);
  }
}

template <int HD>
cudaError_t run_mma(const Args& a, int bh, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<HD>();
  auto kernel = flash_mma_kernel<HD>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int n_q_tiles = (a.sq + kMmaRows - 1) / kMmaRows;
  if (n_q_tiles > 65535) return cudaErrorInvalidValue;
  kernel<<<dim3(bh, n_q_tiles), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int HD, int R>
cudaError_t run_f32(const Args& a, int bh, cudaStream_t stream) {
  constexpr int BQ = kWarps * R;
  const size_t smem = sizeof(float) * smem_floats<HD, R>();
  auto kernel = flash_f32_kernel<HD, R>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int n_q_tiles = (a.sq + BQ - 1) / BQ;
  if (n_q_tiles > 65535) return cudaErrorInvalidValue;
  kernel<<<dim3(bh, n_q_tiles), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it); all
// contiguous (BH, S, hd) with 16-byte-aligned storage.  causal: 0/1;
// window: 0 = none.  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                   void* out, int bh, int sq, int skv, int hd, int causal,
                                   int window, float scale, void* stream) {
  if (bh <= 0 || sq <= 0 || skv <= 0 || window < 0) return cudaErrorInvalidValue;
  if (((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) & 15) != 0)
    return cudaErrorMisalignedAddress;
  const Args a{q, k, v, out, sq, skv, scale, causal, window};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (hd == 64) return run_f32<64, 16>(a, bh, s);
    if (hd == 128) return run_f32<128, 16>(a, bh, s);
    if (hd == 192) return run_f32<192, 8>(a, bh, s);
  } else if (dtype == 1) {
    if (hd == 64) return run_mma<64>(a, bh, s);
    if (hd == 128) return run_mma<128>(a, bh, s);
    if (hd == 192) return run_mma<192>(a, bh, s);
  }
  return cudaErrorInvalidValue;
}
