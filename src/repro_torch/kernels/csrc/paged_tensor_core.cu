// Paged attention for Hopper (sm_90a), the tensor-core path: bf16, and
// f32 in 3xTF32.
//
// Part of the port of the TPU kernel
// src/repro/kernels/flash_decode.py::_paged_kernel (reached through
// paged_flash_attention_folded); csrc/paged_attention.cu holds the C entry,
// the other two paths and the function the three compute.
//
// The paged attention kernel's tensor-core path (path 1 of
// csrc/paged_attention.cu's entry), in either dtype: dk and dv in {64, 128}
// from flash_decode.TENSOR_CORE_MIN_ROWS folded rows up, any number of
// them, and dk = dv = 192 at every fold -- the serve prefill, speculative
// verify from T 9, parity's f32 chunk-extend, and the dense zoo's folds:
// granite-34b's MQA (G 48: 48 decode rows, 768 prefill rows), qwen2-72b's
// 128 prefill rows at dk 128, nemotron-4-340b's 12 and 192 rows at dk 192.
//
// Why mma.sync and not wgmma: only the G*T queries of one (b, kv head)
// share a K tile, and at the serve prefill that is 16 rows, exactly one
// mma.sync.m16n8k16 M-tile; wgmma's 64-row M would leave 3/4 of every
// product empty at 16 rows and pad nemotron's 12 to 64.  That does not
// hold for MLA's fold (all 128 heads on one latent fill a 64-row M-tile):
// launch_tc sends (dk, dv) = (576, 512) to csrc/paged_mla.cu, whose note
// says why it keeps mma.sync there too.
//
// Design.  The fold is cut into row groups of at most 8 M-tiles of 16
// rows (flash_decode.TENSOR_CORE_F32_MAX_TILES in f32: 4 at dk 192); a
// block takes one (key split, row group, batch row x kv head), a warp an
// M-tile, times in-block key splits while the group has under 4 M-tiles
// (halved while two stages of them pass 200 KiB).  The block walks its share of
// the row's units of 32 logical keys (one unit spans four 8-key pages, two
// 16-key pages, one 32-key page or half a 64-key page) in stages of one
// unit per in-block split.  The warps of a split copy each of its units'
// K and V rows together (ps rows of dk elements per page at stride Hkv*dk) with
// 16-byte cp.async into shared rows padded by 16 bytes (so ldmatrix reads
// hit distinct banks), and every M-tile warp of the split reads the unit
// from there: K and V are read from memory once per block, where private
// per-warp rings read them once per warp (and ran out of shared memory at
// 6 M-tiles of dk 128).  The ring holds 3
// stages where they fit 200 KiB, else 2: the next stages' copies are in
// flight while one is computed, one __syncthreads a stage (a barrier for
// each in-block split's warps alone measured no faster).  A key on an unallocated page or a page past the row's
// last query is not read and is masked.  S = Q.K^T and O += P.V run on
// mma.sync; the
// scale multiplies the fp32 S (as the plain version's einsum(q, k) *
// scale: pre-scaling bf16 Q would round differently), then softcap; only a
// unit that reaches past the tile's smallest query position, or holds an
// unread key, is masked; the online softmax uses the quad-shuffle form of
// csrc/flash_attention.cu.  The in-block splits' states merge through
// shared memory over the ring.  Where the grid would leave most of the
// card's SMs idle (granite's MQA decode: Hkv 1 x B 16 = 16 blocks), the
// host's plan (flash_decode.tensor_core_plan) shares a row's units out
// among blocks (contiguous shares), whose states go to an f32 workspace;
// the last block of a (row, kv head, group) to finish merges them (each
// row's split weights once, then o in 16-byte loads) and resets its
// counter, as on the decode path.  The plan comes from the host; run_tc
// refuses one that does not fit, and the wrapper raises.
//
// The two routes, one kernel body (paged_tc_kernel<T, DK, DV>).  bf16: Q
// as A fragments loaded once a warp, straight from memory;
// mma.sync.m16n8k16, P packed from the S fragments, V through
// ldmatrix.trans.  f32 (3xTF32; csrc/paged_mla.cu's f32 route carried over
// to the GQA folds): split into TF32 hi and lo, Q would take dk registers a
// lane beside O's dv / 2 (the bf16 kernel runs at 246 already), so the
// group's Q rows are copied into shared memory once a block, ahead of the
// ring, in the first stage's copy group.  Every operand is split into TF32
// hi and lo (mma_sm80::split_tf32) as its fragment is read, and each
// product is taken as three mma.sync.m16n8k8 passes (lo.hi + hi.lo +
// hi.hi, about 2^-22 of a product): S sums hi.hi apart from the cross
// products (one chain took nemotron's decode 1.17x as long), P.V takes
// mma_sm80::mma_3xtf32.  Q's and K's fragments move as 32-bit words
// through ldmatrix's b16 form, V's B fragment by word loads (rows padded
// by 4 floats put the 32 words in distinct banks), P's A fragment comes
// straight from S's accumulators with a key tile's keys taken in the
// order 2q, 2q + 1.  f32 doubles the ring (a 32-key unit at 192/192 is
// 49 KiB), so its stages are 3 where Q and the ring fit 226 KiB, else 2 (8
// M-tiles at 192).  Q staged pre-split into hi and lo (twice its bytes;
// no room at 6 M-tiles of 192) took granite's MQA decode 1.19x as long,
// and two ring stages gained nothing (tools/kernel_variants.py tc_f32).
//
// Bound on this card: memory at every bf16 shape the port serves (csrc/
// paged_attention.cu's note).  f32 counts three TF32 passes at 494.7
// TFLOP/s: the prefill folds (granite's 768 rows, nemotron's 192 at dk
// 192) are bound by them, the decode folds by their bytes.  ptxas -v
// (sm_90a, nvcc 12.9): bf16 156 registers at dk = dv = 64, 247 at 128, 246
// at 192, 226 and 248 at the mixed widths; f32 200 at 64, 166 at 128, 216
// at 192, 198 at 128/64 and 234 at 64/128; no spills.

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

using mma_sm80::cp_async16;
using mma_sm80::cp_async_commit;
using mma_sm80::cp_async_wait;
using mma_sm80::ldmatrix_x4;
using mma_sm80::ldmatrix_x4_trans;
using mma_sm80::mma_3xtf32;
using mma_sm80::mma_bf16;
using mma_sm80::mma_tf32;
using mma_sm80::pack_bf16;
using mma_sm80::split_tf32;

constexpr int kTcUnit = 32;      // logical keys per staged unit: two k16 steps of P.V
constexpr int kTcMaxTiles = 8;   // 16-row M-tiles a block (a warp each)
constexpr int kTcWarps = 4;      // warps a block aims at: with fewer M-tiles, key splits in it
constexpr size_t kTcRingBudget = 200 * 1024;  // a ring with splits in the block
// f32: the group's Q and the ring (the card's 227 KiB a block, a KiB to spare)
constexpr size_t kTcSmemBudget = 226 * 1024;

// A route's layout: shared rows padded by 16 bytes (ldmatrix's 8 rows and
// f32 V's 32 words hit distinct banks), a K + V unit's elements, one
// warp's merge slot (floats).
template <typename T, int DK, int DV>
struct TcCfg {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int EPC = 16 / (int)sizeof(T);  // elements a 16-byte chunk
  static constexpr int LDK = DK + EPC;
  static constexpr int LDV = DV + EPC;
  static constexpr int UNIT = kTcUnit * (LDK + LDV);
  static constexpr int RED = 32 + 16 * DV;
};

// A block of `tiles` M-tiles under `splits` key splits: its warps are
// tiles x wsplits (the in-block key splits: the `tiles` warps of one split
// stage and read every wsplits-th unit of the block's share); in f32 the
// group's Q rows (q bytes, padded) come first, then the ring of `stages`
// stages of one unit a split (3 where they fit the budgets, else 2); the
// warps' merge slots (wsplits > 1) and the split merge's weights (splits >
// 1) reuse it.  The CPU tests mirror it
// (tests/test_torch_paged_paths.py::tensor_core_block).
struct TcBlock {
  int wsplits, stages;
  size_t smem;
};

inline size_t tc_ring_bytes(int stages, int wsplits, int dk, int dv, int item) {
  return (size_t)stages * wsplits * kTcUnit * ((dk + dv) * item + 32);
}

inline TcBlock tc_block(int tiles, int splits, int dk, int dv, int item) {
  const size_t q = item == 4 ? (size_t)tiles * 16 * (dk * 4 + 16) : 0;  // bf16: in registers
  TcBlock p{tiles >= kTcWarps ? 1 : kTcWarps / tiles, 3, 0};
  while (p.wsplits > 1 && tc_ring_bytes(2, p.wsplits, dk, dv, item) > kTcRingBudget)
    p.wsplits >>= 1;
  const size_t ring3 = tc_ring_bytes(3, p.wsplits, dk, dv, item);
  if ((p.wsplits > 1 && ring3 > kTcRingBudget) || q + ring3 > kTcSmemBudget) p.stages = 2;
  size_t smem = q + tc_ring_bytes(p.stages, p.wsplits, dk, dv, item);
  const size_t red = p.wsplits > 1 ? (size_t)tiles * p.wsplits * (32 + 16 * dv) * 4 : 0;
  const size_t weights = splits > 1 ? (size_t)(splits + 1) * tiles * 16 * 4 : 0;
  if (red > smem) smem = red;
  if (weights > smem) smem = weights;
  p.smem = smem;
  return p;
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(x, y);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

// Warp mt of the `tiles` warps staging a unit copies its share of the
// unit's NC 16-byte chunks a row into rows of LD elements, key r's from
// base + row(r) * stride (row(r): lane r's `row`; -1 zero-fills).  A
// unit's 32 * NC chunks are a multiple of 32, so every lane of the warp
// takes the same number and the shuffles see the whole warp.  Unrolled at
// 16 chunks a row or fewer (bf16 dk 64 and 128: 0.5-3% faster than a loop
// on an H100); a loop above, where unrolling bf16's 24 measured 19-33%
// slower (tools/kernel_variants.py tc).
template <typename T, int NC, int LD>
__device__ __forceinline__ void copy_unit(T* dst, const T* base, size_t stride, int row, int mt,
                                          int tiles, int lane) {
  constexpr int EPC = 16 / (int)sizeof(T);
  auto one = [&](int i) {
    const int r = i / NC, c = (i % NC) * EPC;
    const int src = __shfl_sync(0xffffffffu, row, r);
    cp_async16(dst + r * LD + c, base + (src >= 0 ? (size_t)src * stride + c : 0), src >= 0);
  };
  if constexpr (NC <= 16) {
#pragma unroll
    for (int t = 0; t < NC; ++t) {
      const int i = (mt + tiles * t) * 32 + lane;
      if (i >= kTcUnit * NC) break;
      one(i);
    }
  } else {
    for (int i = mt * 32 + lane; i < kTcUnit * NC; i += 32 * tiles) one(i);
  }
}

// The share of unit u (logical keys [32 u, 32 u + 32) of head h) that warp
// mt of the `tiles` warps staging it copies into its place in a stage, as
// 16-byte cp.async: the tiles warps split its K and V chunks.  A key on a
// page past the row's last query or on an unallocated page is not read; a
// unit with no such key, or at or past u_end, copies nothing.  Returns the
// unit's valid-key bits (bit r: key 32 u + r lies on a read page), the same
// in every warp that stages it.
template <typename T, int DK, int DV>
__device__ __forceinline__ uint32_t tc_stage(const Args& a, const T* __restrict__ kp,
                                             const T* __restrict__ vp, int b, int h, int last_q,
                                             int u, int u_end, T* ks, int mt, int tiles,
                                             int lane) {
  using C = TcCfg<T, DK, DV>;
  if (u >= u_end) return 0u;
  const int key = u * kTcUnit + lane;
  const int j = key / a.page_size;
  int row = -1;  // physical cache row of this lane's key
  if (j < a.pages_per_slot && j * a.page_size <= last_q) {
    const int pid = a.table[b * a.pages_per_slot + j];
    if (pid >= 0 && pid < a.n_pages) row = pid * a.page_size + key - j * a.page_size;
  }
  const uint32_t valid = __ballot_sync(0xffffffffu, row >= 0);
  if (valid == 0u) return 0u;
  copy_unit<T, DK / C::EPC, C::LDK>(ks, kp + (size_t)h * DK, (size_t)a.hkv * DK, row, mt, tiles,
                                    lane);
  copy_unit<T, DV / C::EPC, C::LDV>(ks + kTcUnit * C::LDK, vp + (size_t)h * a.dv_store,
                                    (size_t)a.hkv * a.dv_store, row, mt, tiles, lane);
  return valid;
}

// One block per (key split, row group, batch row x kv head).  The group's
// `tiles` M-tiles are a warp each, times wsplits in-block key splits.  The
// block's share of the row's units is split s's of gridDim.x (contiguous,
// ceil(units / splits) each); it walks them in stages of wsplits units,
// each copied together (tc_stage) and read by the `tiles` warps of its
// in-block split: K/V are read from memory once per block.  A split's
// state goes straight to out (one split) or to the f32 workspace (o, then
// every slot's (m, l) after all of o), whose last block of a (row, kv head,
// group) merges the splits and resets the counter.  bf16 takes Q as A
// fragments in registers and its products on mma.sync.m16n8k16; f32 stages
// the group's Q rows in shared memory and takes every product in 3xTF32.
template <typename T, int DK, int DV>
__global__ void __launch_bounds__(256)
    paged_tc_kernel(const Args a, int tiles, int wsplits, int stages, float* __restrict__ ws,
                    int* __restrict__ counters) {
  using C = TcCfg<T, DK, DV>;
  constexpr bool F32 = C::F32;
  extern __shared__ float4 smem4[];
  __shared__ int last_block;
  const int split = blockIdx.x, splits = gridDim.x, grp = blockIdx.y, bh = blockIdx.z;
  const int b = bh / a.hkv, h = bh - b * a.hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mt = warp % tiles, wsplit = warp / tiles;
  const int ql = a.ql;
  const int tile = grp * tiles + mt;  // this warp's M-tile of the fold
  const bool active = tile * 16 < ql;  // the last group may hold fewer tiles
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: this lane's matrix and row
  const int g = lane >> 2, tq4 = lane & 3;  // accumulator: rows g, g + 8; cols 2 tq4
  const T* __restrict__ kp = static_cast<const T*>(a.k_pages);
  const T* __restrict__ vp = static_cast<const T*>(a.v_pages);
  const int row_a = tile * 16 + g, row_b = row_a + 8;
  const int rows0 = grp * tiles * 16, rows1 = min(ql, rows0 + tiles * 16);
  // f32: the group's Q rows (padded, zeros past QL), then the ring
  T* qs = reinterpret_cast<T*>(smem4);
  T* ring = qs + (F32 ? tiles * 16 * C::LDK : 0);

  // bf16: this warp's 16 folded rows as A fragments, straight from memory
  // (rows past QL are zeros); f32: the group's rows into shared memory, in
  // the first stage's copy group
  uint32_t qf[F32 ? 1 : DK / 16][4];
  if constexpr (F32) {
    constexpr int NC = DK / C::EPC;
    const T* qg = static_cast<const T*>(a.q) + ((size_t)bh * ql + rows0) * DK;
    for (int i = threadIdx.x; i < tiles * 16 * NC; i += blockDim.x) {
      const int r = i / NC, col = (i - r * NC) * C::EPC;
      const bool in = rows0 + r < ql;
      cp_async16(qs + r * C::LDK + col, qg + (in ? (size_t)r * DK + col : 0), in);
    }
  } else {
    const uint32_t* __restrict__ q32 =
        reinterpret_cast<const uint32_t*>(static_cast<const T*>(a.q) + (size_t)bh * ql * DK);
    const bool in_a = row_a < ql, in_b = row_b < ql;
#pragma unroll
    for (int kc = 0; kc < DK / 16; ++kc) {
      const int c = kc * 8 + tq4;  // 32-bit word of columns kc * 16 + 2 tq4, + 1
      qf[kc][0] = in_a ? q32[row_a * (DK / 2) + c] : 0u;
      qf[kc][1] = in_b ? q32[row_b * (DK / 2) + c] : 0u;
      qf[kc][2] = in_a ? q32[row_a * (DK / 2) + c + 4] : 0u;
      qf[kc][3] = in_b ? q32[row_b * (DK / 2) + c + 4] : 0u;
    }
  }

  const int off = a.offsets[b];
  const int last_q = off + a.tokens_per_row - 1;
  const int qpos_a = off + row_a % a.tokens_per_row, qpos_b = off + row_b % a.tokens_per_row;
  // the tile's smallest query position: keys at or below it need no
  // position mask
  const int qmin = __reduce_min_sync(
      0xffffffffu, min(row_a < ql ? qpos_a : INT_MAX, row_b < ql ? qpos_b : INT_MAX));
  // the row's units of keys [0, last_q] within its page table; this block's share
  const int units = last_q < 0 ? 0
                               : min(last_q / kTcUnit + 1,
                                     (a.pages_per_slot * a.page_size + kTcUnit - 1) / kTcUnit);
  const int chunk = (units + splits - 1) / splits;
  const int u0 = min(units, split * chunk), u1 = min(units, u0 + chunk);
  const int n_stages = (u1 - u0 + wsplits - 1) / wsplits;
  const float c = a.scale;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;  // l: this lane's share
  float o[DV / 8][4];
#pragma unroll
  for (int dt = 0; dt < DV / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;

  // stage s holds units u0 + s wsplits + (0 .. wsplits) in ring slot s % stages
  auto unit_at = [&](int s) {
    return ring + (size_t)((s % stages) * wsplits + wsplit) * C::UNIT;
  };
  auto issue = [&](int s) {
    const uint32_t v = tc_stage<T, DK, DV>(a, kp, vp, b, h, last_q, u0 + s * wsplits + wsplit,
                                           u1, unit_at(s), mt, tiles, lane);
    cp_async_commit();
    return v;
  };
  uint32_t v0 = issue(0), v1 = stages == 3 ? issue(1) : 0u, v2 = 0u;
  for (int s = 0; s < n_stages; ++s) {
    if (stages == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // stage s (and Q) landed from every thread; stage s - 1 is consumed
    const uint32_t vn = issue(s + stages - 1);  // into stage s - 1's slot
    if (stages == 3)
      v2 = vn;
    else
      v1 = vn;
    const uint32_t valid = v0;
    v0 = v1;
    v1 = v2;
    if (!active || valid == 0u) continue;
    const T* ks = unit_at(s);
    const T* vs = ks + kTcUnit * C::LDK;
    float sc[4][4];  // 16 rows x 32 keys: 4 key tiles of 8
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
    if constexpr (F32) {
      // Q's A fragment of a k8 step and K's B fragments of two key tiles,
      // each an ldmatrix of 32-bit words (4 floats a 16-byte row), split
      // into hi and lo; the cross products lo.hi + hi.lo summed apart from
      // hi.hi, so a key tile's S is two dependent chains of mma.sync, not
      // one of three times the length (csrc/paged_mla.cu's f32 route)
      float sx[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) sx[nt][0] = sx[nt][1] = sx[nt][2] = sx[nt][3] = 0.f;
      const T* qt = qs + (mt * 16 + (mi & 1) * 8 + mr) * C::LDK + (mi >> 1) * 4;
#pragma unroll
      for (int kc = 0; kc < DK / 8; ++kc) {
        uint32_t raw[4], ah[4], al[4];
        ldmatrix_x4(raw, qt + kc * 8);
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(raw[i]), ah[i], al[i]);
#pragma unroll
        for (int nt = 0; nt < 4; nt += 2) {
          uint32_t bk[4], bh[4], bl[4];
          ldmatrix_x4(bk, ks + (nt * 8 + (mi >> 1) * 8 + mr) * C::LDK + kc * 8 + (mi & 1) * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(bk[i]), bh[i], bl[i]);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            mma_tf32(sx[nt + u], al, bh[2 * u], bh[2 * u + 1]);
            mma_tf32(sx[nt + u], ah, bl[2 * u], bl[2 * u + 1]);
            mma_tf32(sc[nt + u], ah, bh[2 * u], bh[2 * u + 1]);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] += sx[nt][e];
    } else {
#pragma unroll
      for (int kc = 0; kc < DK / 16; ++kc) {
#pragma unroll
        for (int nt = 0; nt < 4; nt += 2) {
          uint32_t bk[4];
          ldmatrix_x4(bk, ks + (nt * 8 + (mi >> 1) * 8 + mr) * C::LDK + kc * 16 + (mi & 1) * 8);
          mma_bf16(sc[nt], qf[kc], bk[0], bk[1]);
          mma_bf16(sc[nt + 1], qf[kc], bk[2], bk[3]);
        }
      }
    }
    // scale (fp32, as the plain version), softcap, mask only a unit that
    // reaches past qmin or holds an unread key
    const int k0 = (u0 + s * wsplits + wsplit) * kTcUnit;
    const bool full = valid == 0xffffffffu && k0 + kTcUnit - 1 <= qmin;
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float va = sc[nt][e] * c, vb = sc[nt][2 + e] * c;
        if (a.softcap > 0.f) {
          va = tanhf(va / a.softcap) * a.softcap;
          vb = tanhf(vb / a.softcap) * a.softcap;
        }
        if (!full) {
          const int kr = nt * 8 + tq4 * 2 + e;
          const bool in = (valid >> kr) & 1u;
          if (!(in && k0 + kr <= qpos_a)) va = -INFINITY;
          if (!(in && k0 + kr <= qpos_b)) vb = -INFINITY;
        }
        sc[nt][e] = va;
        sc[nt][2 + e] = vb;
        mx_a = fmaxf(mx_a, va);
        mx_b = fmaxf(mx_b, vb);
      }
    }
    // a row spans the 4 lanes of a quad
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float mc_a = mx_a * kLog2e, mc_b = mx_b * kLog2e;
    // m starts at -1e30: corr is 0 until a row sees a key; -inf gives
    // p = 0; the difference is taken before scaling (see flash_attention.cu)
    const float corr_a = exp2f((m_a - mx_a) * kLog2e);
    const float corr_b = exp2f((m_b - mx_b) * kLog2e);
    m_a = mx_a;
    m_b = mx_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pa = exp2f(fmaf(sc[nt][e], kLog2e, -mc_a));
        const float pb = exp2f(fmaf(sc[nt][2 + e], kLog2e, -mc_b));
        sc[nt][e] = pa;
        sc[nt][2 + e] = pb;
        sum_a += pa;
        sum_b += pb;
      }
    }
    l_a = fmaf(l_a, corr_a, sum_a);
    l_b = fmaf(l_b, corr_b, sum_b);
#pragma unroll
    for (int dt = 0; dt < DV / 8; ++dt) {
      o[dt][0] *= corr_a;
      o[dt][1] *= corr_a;
      o[dt][2] *= corr_b;
      o[dt][3] *= corr_b;
    }
    if constexpr (F32) {
      // O += P.V in 3xTF32: a key tile's accumulator fragment is P's A
      // fragment with the tile's keys taken in the order k = q <-> key 2q,
      // k = q + 4 <-> key 2q + 1; V's B fragment (keys 2 tq4 and 2 tq4 + 1,
      // column g) is read in the same order, a word at a time
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        uint32_t ph[4], pl[4];
        split_tf32(sc[kc][0], ph[0], pl[0]);
        split_tf32(sc[kc][2], ph[1], pl[1]);
        split_tf32(sc[kc][1], ph[2], pl[2]);
        split_tf32(sc[kc][3], ph[3], pl[3]);
        const T* vk = vs + (kc * 8 + 2 * tq4) * C::LDV + g;
#pragma unroll
        for (int dt = 0; dt < DV / 8; ++dt) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(vk[dt * 8], bh0, bl0);
          split_tf32(vk[C::LDV + dt * 8], bh1, bl1);
          mma_3xtf32(o[dt], ph, pl, bh0, bh1, bl0, bl1);
        }
      }
    } else {
      // O += P.V: two key tiles' accumulator fragments are one A fragment
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        const uint32_t pa[4] = {pack_bf16(sc[2 * kc][0], sc[2 * kc][1]),
                                pack_bf16(sc[2 * kc][2], sc[2 * kc][3]),
                                pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]),
                                pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3])};
#pragma unroll
        for (int dt = 0; dt < DV / 8; dt += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv,
                            vs + (kc * 16 + (mi & 1) * 8 + mr) * C::LDV + (dt + (mi >> 1)) * 8);
          mma_bf16(o[dt], pa, bv[0], bv[1]);
          mma_bf16(o[dt + 1], pa, bv[2], bv[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);

  // The block's state: to out with one split, else to its workspace slots
  // [split][row] = {m, l, o[DV]} (f32, unnormalised).
  T* __restrict__ out = static_cast<T*>(a.out) + (size_t)bh * ql * DV;
  // workspace slot (split, row): o at wo + (split * ql + row) * DV, (m, l)
  // at wml + split * ql + row
  float* wo = splits > 1 ? ws + (size_t)bh * splits * ql * DV : nullptr;
  float2* wml = splits > 1 ? reinterpret_cast<float2*>(ws + (size_t)a.batch * a.hkv * splits *
                                                                 ql * DV) +
                                 (size_t)bh * splits * ql
                           : nullptr;
  if (wsplits == 1) {  // a warp holds its rows' whole state
    if (active) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = half ? row_b : row_a;
        if (row >= ql) continue;
        const float m = half ? m_b : m_a, l = half ? l_b : l_a;
        if (splits == 1) {
          // a query with nothing attendable keeps l == 0 and writes zeros
          const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
          for (int dt = 0; dt < DV / 8; ++dt)
            store2(out + (size_t)row * DV + dt * 8 + tq4 * 2, o[dt][2 * half] * inv,
                   o[dt][2 * half + 1] * inv);
        } else {
          float* slot = wo + ((size_t)split * ql + row) * DV;
          if (tq4 == 0) wml[(size_t)split * ql + row] = make_float2(m, l);
#pragma unroll
          for (int dt = 0; dt < DV / 8; ++dt)
            *reinterpret_cast<float2*>(slot + dt * 8 + tq4 * 2) =
                make_float2(o[dt][2 * half], o[dt][2 * half + 1]);
        }
      }
    }
  } else {  // merge the in-block splits through shared memory (over Q and the ring)
    __syncthreads();  // every warp is done with the ring
    float* red = reinterpret_cast<float*>(smem4);
    float* slot = red + warp * C::RED;  // {m[16], l[16], o[16][DV]}
    if (tq4 == 0) {
      slot[g] = m_a;
      slot[g + 8] = m_b;
      slot[16 + g] = l_a;
      slot[16 + g + 8] = l_b;
    }
#pragma unroll
    for (int dt = 0; dt < DV / 8; ++dt) {
      const int col = dt * 8 + tq4 * 2;
      slot[32 + g * DV + col] = o[dt][0];
      slot[32 + g * DV + col + 1] = o[dt][1];
      slot[32 + (g + 8) * DV + col] = o[dt][2];
      slot[32 + (g + 8) * DV + col + 1] = o[dt][3];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < (rows1 - rows0) * DV; i += blockDim.x) {
      const int qi = rows0 + i / DV, d = i % DV;
      const int t = (qi >> 4) - grp * tiles, r = qi & 15;
      float mx = kNegInf;
      for (int sp = 0; sp < wsplits; ++sp) mx = fmaxf(mx, red[(sp * tiles + t) * C::RED + r]);
      float lsum = 0.f, acc = 0.f;
      for (int sp = 0; sp < wsplits; ++sp) {
        const float* sl = red + (sp * tiles + t) * C::RED;
        const float f = exp2f((sl[r] - mx) * kLog2e);
        lsum = fmaf(sl[16 + r], f, lsum);
        acc = fmaf(sl[32 + r * DV + d], f, acc);
      }
      if (splits == 1) {
        // a query with nothing attendable keeps l == 0 and writes zeros
        store1(out + (size_t)qi * DV + d, acc / fmaxf(lsum, 1e-30f));
      } else {
        wo[((size_t)split * ql + qi) * DV + d] = acc;
        if (d == 0) wml[(size_t)split * ql + qi] = make_float2(mx, lsum);
      }
    }
  }
  if (splits == 1) return;

  // the last split of (row, kv head, group) to finish merges them all and
  // resets the counter for the next launch on the stream
  __threadfence();
  __syncthreads();
  int* counter = counters + (size_t)bh * gridDim.y + grp;
  if (threadIdx.x == 0) last_block = atomicAdd(counter, 1) == splits - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  // each row's split weights (shared memory, over the ring), then o in
  // 16-byte loads, several splits' in flight
  const int R = rows1 - rows0;
  float* wgt = reinterpret_cast<float*>(smem4);  // [splits][R], then 1 / l [R]
  float* inv = wgt + (size_t)splits * R;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const float2* ml = wml + rows0 + r;
    float mx = kNegInf;
    for (int sp = 0; sp < splits; ++sp) mx = fmaxf(mx, __ldcg(ml + (size_t)sp * ql).x);
    float l = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
      // an empty split has m = -1e30 and l = 0: weight 0, or 1 times 0
      const float2 v = __ldcg(ml + (size_t)sp * ql);
      const float w = exp2f((v.x - mx) * kLog2e);
      wgt[sp * R + r] = w;
      l = fmaf(v.y, w, l);
    }
    inv[r] = 1.f / fmaxf(l, 1e-30f);
  }
  __syncthreads();
  constexpr int V4 = DV / 4;
  const size_t step = (size_t)ql * V4;  // float4s from one split's slot to the next
  for (int i = threadIdx.x; i < R * V4; i += blockDim.x) {
    const int r = i / V4, c4 = i - r * V4;
    const float4* src = reinterpret_cast<const float4*>(wo + (size_t)(rows0 + r) * DV) + c4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int sp = 0; sp < splits; ++sp) {
      const float4 v = __ldcg(src + sp * step);
      const float w = wgt[sp * R + r];
      acc.x = fmaf(v.x, w, acc.x);
      acc.y = fmaf(v.y, w, acc.y);
      acc.z = fmaf(v.z, w, acc.z);
      acc.w = fmaf(v.w, w, acc.w);
    }
    const float sc = inv[r];
    store4(out + (size_t)(rows0 + r) * DV + c4 * 4,
           make_float4(acc.x * sc, acc.y * sc, acc.z * sc, acc.w * sc));
  }
  if (threadIdx.x == 0) *counter = 0;
}

template <typename T, int DK, int DV>
cudaError_t run_tc(const Args& a, int groups, int splits, float* ws, int* counters,
                   cudaStream_t stream) {
  int dev = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const int mtiles = (a.ql + 15) / 16;
  const int tiles = (mtiles + groups - 1) / groups;
  const int units = (a.pages_per_slot * a.page_size + kTcUnit - 1) / kTcUnit;
  // the plan (flash_decode.tensor_core_plan): groups of at most 8 M-tiles,
  // none empty; at most a split a unit; the workspace with more than one
  if (groups < 1 || groups > 65535 || tiles > kTcMaxTiles || (groups - 1) * tiles >= mtiles ||
      splits < 1 || splits > (units > 1 ? units : 1) ||
      (splits > 1 && (ws == nullptr || counters == nullptr)) ||
      (long)a.batch * a.hkv > 65535)
    return cudaErrorInvalidValue;
  const TcBlock blk = tc_block(tiles, splits, DK, DV, (int)sizeof(T));
  if (blk.smem > (size_t)smem_max) return cudaErrorInvalidValue;
  auto kernel = paged_tc_kernel<T, DK, DV>;
  if (blk.smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)blk.smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(splits, groups, a.batch * a.hkv), tiles * blk.wsplits * 32, blk.smem, stream>>>(
      a, tiles, blk.wsplits, blk.stages, ws, counters);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_widths(const Args& a, int groups, int splits, float* w, int* c,
                       cudaStream_t s) {
  if (a.dk == 64 && a.dv == 64) return run_tc<T, 64, 64>(a, groups, splits, w, c, s);
  if (a.dk == 64 && a.dv == 128) return run_tc<T, 64, 128>(a, groups, splits, w, c, s);
  if (a.dk == 128 && a.dv == 64) return run_tc<T, 128, 64>(a, groups, splits, w, c, s);
  if (a.dk == 128 && a.dv == 128) return run_tc<T, 128, 128>(a, groups, splits, w, c, s);
  if (a.dk == 192 && a.dv == 192) return run_tc<T, 192, 192>(a, groups, splits, w, c, s);
  return cudaErrorInvalidValue;
}

}  // namespace

cudaError_t paged::launch_tc(const Args& a, int dtype, int groups, int splits, void* ws,
                             void* counters, cudaStream_t s) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k_pages) |
                         reinterpret_cast<uintptr_t>(a.v_pages)) & 15) == 0;
  if (!aligned || a.dv_store * (dtype == 1 ? 2 : 4) % 16 != 0) return cudaErrorInvalidValue;
  if (a.dk == 576 && a.dv == 512) return paged::launch_mla(a, dtype, groups, splits, s);
  float* w = static_cast<float*>(ws);
  int* c = static_cast<int*>(counters);
  if (dtype == 1) return run_widths<__nv_bfloat16>(a, groups, splits, w, c, s);
  if (dtype == 0) return run_widths<float>(a, groups, splits, w, c, s);
  return cudaErrorInvalidValue;
}
