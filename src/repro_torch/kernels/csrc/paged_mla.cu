// Paged attention for Hopper (sm_90a), the tensor-core path at MLA's
// fold, in bf16 and in f32 (3xTF32).
//
// Part of the port of the TPU kernel
// src/repro/kernels/flash_decode.py::_paged_kernel (reached through
// paged_flash_attention_folded, whose v_width reads values from the first
// columns of a shared MLA page); csrc/paged_attention.cu holds the C entry,
// and csrc/paged_tensor_core.cu's launch_tc sends (dk, dv) = (576, 512)
// here (path 1, counted as the tensor-core path).
//
// The shape: deepseek-v2-236b's absorbed MLA puts all 128 query heads on
// one latent "KV head" (Hkv 1): q_eff (B, 1, 128 T, 576) against pages of
// 576 elements (the 512-wide latent c_kv, then the 64-wide RoPE key), the
// values the first 512 columns of the same rows, the scale 1 / sqrt(192)
// from the caller.  Every row of the fold shares every key, so a row
// group of M-tiles is full, unlike the GQA folds of
// csrc/paged_tensor_core.cu, where only the G*T queries of one KV head
// share a K tile.  The CUDA-core path read each row's whole latent once
// per 2 folded rows (64 times at G 128) in f32 FMAs.
//
// Design.  A block takes one (key split, row group of up to MlaCfg::MAX_TILES
// 16-row M-tiles, batch row x kv head).  Its Q rows (padded to MlaCfg::LD)
// are copied into shared memory once; the row's units of latent
// (MlaCfg::UNIT keys) are copied once a block with 16-byte cp.async into a
// 3-stage ring (2 where 3 do not fit) of padded rows, each lane's
// page-table entry loaded a unit ahead: S = Q.K^T reads all 576 columns of
// a unit, and P.V reads its first 512 -- the values are never copied on
// their own.  Each M-tile has NW warps: warp w owns value columns
// [w DV / NW, (w + 1) DV / NW) of O (64 f32 registers a lane at NW 4) and
// k-steps [w KS, (w + 1) KS) of S's depth.  The warps' partial S (16 rows x
// UNIT keys, f32) meet in shared memory under a named barrier for the
// M-tile's warps (bar.sync 1 + tile): warp w sums its share of the tile's
// fragment slots over the warps in warp order, and after a second barrier
// every warp reads the sums, so all hold the same S and P, each in the
// registers where its P.V takes the A fragments.  (Each warp computing S
// over all 576 columns itself, NW times the Q.K^T products, took the bf16
// decode 1.42x as long: flash_decode.py.)  The ring's one __syncthreads a
// stage also orders the exchange's slots from one unit to the next.  Scale
// (fp32, as the plain version), softcap, the causal and allocation mask,
// the online softmax and the zeros of a row with nothing to attend are
// csrc/paged_tensor_core.cu's.  Where the grid leaves SMs idle the host's
// plan (flash_decode.tensor_core_plan) shares a row's units out among key
// splits, launched as one thread-block cluster a (row, kv head, group):
// each block leaves its state (f32 o, rows padded to kMlaStateLD, and m,
// l) in its own shared memory, and block k merges the group's k-th share
// of rows, reading the others' through distributed shared memory -- no
// f32 workspace round trip (merging through the workspace by the last
// block, as csrc/paged_tensor_core.cu does, took the bf16 decode 1.34x as
// long: flash_decode.py).
//
// The two routes.  bf16: mma.sync.m16n8k16, fragments by ldmatrix (Q and
// K) and ldmatrix.trans (V), rows padded by 8 bf16, 32-key units, 64-row
// groups (Q 73 KiB, 3 stages of 36.5 KiB).  f32: every operand split into
// TF32 hi and lo (mma_sm80::split_tf32) and each product taken as three
// mma.sync.m16n8k8 TF32 passes (lo.hi + hi.lo + hi.hi, about 2^-22 of a
// product, as the f32 flash kernel; S sums hi.hi apart from the cross
// products, P.V takes mma_sm80::mma_3xtf32); rows padded by 4 floats (580: the
// eight 16-byte rows of an ldmatrix and the 32 words of V's B fragment
// land in distinct banks); Q's A fragments and K's B fragments move as
// 32-bit words through ldmatrix's b16 form (4 floats a 16-byte row, the
// m16n8k8 layout), V's B fragments (a column of keys, which ldmatrix.trans
// cannot give in 32 bits) by word loads, P's A fragments from S's
// accumulators with the keys of a k-step taken in the order 2q, 2q + 1
// (csrc/flash_attention.cu's f32 kernel).  The f32 operands take twice the
// bytes, so a 64-row group's Q (145 KiB) leaves no room for a ring: the
// f32 route takes 32-row groups and 16-key units (Q 72.5 KiB, 3 stages of
// 36.25 KiB, 10 KiB of partial S; the measured alternatives are in
// flash_decode.py).  Calls with separate K and V pools take the CUDA-core
// kernel in either dtype.
//
// Why mma.sync and not wgmma, though MLA's fold fills wgmma's 64-row M:
// the tensor-core path's fragments, online softmax and split merge carry
// over, and with them the bf16 fold takes the serve decode under SDPA on
// pre-gathered K/V (PERF.md); the time at this shape goes to shared-memory
// traffic (the fragments of Q, K and V, the partial-S exchange) and the
// splits' merge, not to the products.  The f32 route runs one block of 8
// warps an SM and is latency-bound: copies skipping S, P.V, the ring's
// copies or the exchange take 24%, 10%, 14% and 1% off its decode, and 8
// warps an M-tile run no faster than 4 (tools/kernel_variants.py mla).
//
// Bound on this card: bf16 is memory-bound at the serve decode (B 16, G
// 128, 128-576 keys: 1.34 GFLOP over 10.2 MB, 3.0 us of bytes at 3.35 TB/s
// against 1.4 us of products at 989 TFLOP/s); f32 is bound by its three
// TF32 passes (8.1 us at 494.7 TFLOP/s, against 6.1 us of bytes).  ptxas
// -v (sm_90a, nvcc 12.9): bf16 128 registers (the cap of 512 threads), f32
// 158 (256 threads), no spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

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

constexpr int kMlaDK = 576, kMlaDV = 512;
// bf16: logical keys a staged unit (two k16 steps of P.V), 16-row M-tiles
// a block (a 64-row group), warps an M-tile (each a share of O's columns
// and S's depth)
constexpr int kMlaUnit = 32;
constexpr int kMlaMaxTiles = 4;
constexpr int kMlaColWarps = 4;
// f32: the same at twice the bytes an element (a 32-row group)
constexpr int kMlaF32Unit = 16;
constexpr int kMlaF32MaxTiles = 2;
constexpr int kMlaF32ColWarps = 4;
// key splits merge in a thread-block cluster through distributed shared
// memory, at most kMlaMaxClusterSplits of them (the portable cluster size)
constexpr int kMlaMaxClusterSplits = 8;
constexpr int kMlaStateLD = kMlaDV + 8;  // a merged row's floats: 2-way-free float2 stores
// shared memory a block may take (the card's 227 KiB, a KiB to spare)
constexpr size_t kMlaSmemBudget = 226 * 1024;

// A route's layout: padded shared row (elements), unit, M-tiles a block,
// warps an M-tile.
template <typename T>
struct MlaCfg {
  static constexpr int LD = kMlaDK + 8;  // ldmatrix rows hit distinct banks
  static constexpr int UNIT = kMlaUnit, MAX_TILES = kMlaMaxTiles, NW = kMlaColWarps;
};
template <>
struct MlaCfg<float> {
  static constexpr int LD = kMlaDK + 4;
  static constexpr int UNIT = kMlaF32Unit, MAX_TILES = kMlaF32MaxTiles, NW = kMlaF32ColWarps;
};

// A block of `tiles` M-tiles: its Q rows, `stages` units of latent, and
// each warp's partial S (16 x UNIT f32) and each M-tile's summed S.  3
// stages where they fit the budget, else 2.  The split merge reuses it:
// the block's state and the weights of the rows it merges.  The CPU tests
// mirror it (tests/test_torch_paged_paths.py::mla_block).
struct MlaBlock {
  int stages;
  size_t smem;
};

template <typename T>
size_t mla_bytes(int tiles, int stages) {
  using C = MlaCfg<T>;
  const size_t q = (size_t)tiles * 16 * C::LD * sizeof(T);
  const size_t ring = (size_t)stages * C::UNIT * C::LD * sizeof(T);
  const size_t sums = (size_t)tiles * (C::NW + 1) * 16 * C::UNIT * 4;
  return q + ring + sums;
}

template <typename T>
MlaBlock mla_block(int tiles, int splits) {
  MlaBlock p{mla_bytes<T>(tiles, 3) <= kMlaSmemBudget ? 3 : 2, 0};
  p.smem = mla_bytes<T>(tiles, p.stages);
  // the block's state, (m, l) and each merged row's weights
  const size_t merge = splits > 1 ? (size_t)tiles * 16 * (kMlaStateLD * 4 + 8) +
                                        (size_t)(splits + 1) * tiles * 16 * 4
                                  : 0;
  if (merge > p.smem) p.smem = merge;
  return p;
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// One block per (key split, row group, batch row x kv head); warp
// tile * NW + w takes M-tile `tile` of the group and its column share w.
// The block's share of the row's units is split s's of gridDim.x
// (contiguous, ceil(units / splits) each).  With one split the warps write
// out; with more, each block's state is merged across the splits in the
// thread-block cluster of a (row, kv head, group).
template <typename T>
__global__ void __launch_bounds__(MlaCfg<T>::MAX_TILES * MlaCfg<T>::NW * 32)
    paged_mla_kernel(const Args a, int tiles, int stages) {
  using C = MlaCfg<T>;
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int DK = kMlaDK, DV = kMlaDV, LD = C::LD, NW = C::NW, UNIT = C::UNIT;
  constexpr int EPC = 16 / (int)sizeof(T);  // elements a 16-byte chunk
  constexpr int NC = DK / EPC;              // chunks a row
  constexpr int KW = F32 ? 8 : 16;          // an mma's k: m16n8k8 TF32, m16n8k16 bf16
  constexpr int KS = DK / KW / NW;          // S's k-steps a warp
  constexpr int VC = DV / NW;               // O's columns a warp
  constexpr int NT = UNIT / 8;              // key tiles of S
  constexpr int PER = NT * 32 / NW;         // S's fragment slots a warp sums for its M-tile
  constexpr uint32_t kAll = UNIT == 32 ? 0xffffffffu : (1u << UNIT) - 1u;
  static_assert(DK / KW % NW == 0 && VC % 16 == 0 && UNIT % 16 == 0 && NT * 32 % NW == 0,
                "the column shares must be whole k-steps, the units whole key-tile pairs");
  extern __shared__ float4 smem4[];
  T* qs = reinterpret_cast<T*>(smem4);
  T* ring = qs + tiles * 16 * LD;
  // [tile][warp][key tile][lane] partial S, then [tile][key tile][lane] sums
  float4* partials = reinterpret_cast<float4*>(ring + stages * UNIT * LD);
  float4* sums = partials + tiles * NW * NT * 32;
  const int split = blockIdx.x, splits = gridDim.x, grp = blockIdx.y, bh = blockIdx.z;
  const int b = bh / a.hkv, h = bh - b * a.hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const int mt = warp / NW, wc = warp - mt * NW;
  const int ql = a.ql;
  const int tile = grp * tiles + mt;  // this warp's M-tile of the fold
  const bool active = tile * 16 < ql;  // the last group may hold fewer rows
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: this lane's matrix and row
  const int g = lane >> 2, tq4 = lane & 3;  // accumulator: rows g, g + 8; cols 2 tq4
  const int row_a = tile * 16 + g, row_b = row_a + 8;
  const int rows0 = grp * tiles * 16, rows1 = min(ql, rows0 + tiles * 16);
  const T* __restrict__ kp = static_cast<const T*>(a.k_pages) + (size_t)h * DK;
  const size_t kstride = (size_t)a.hkv * DK;

  // the group's Q rows (zeros past QL), in the first stage's copy group
  {
    const T* qg = static_cast<const T*>(a.q) + ((size_t)bh * ql + rows0) * DK;
    for (int i = threadIdx.x; i < tiles * 16 * NC; i += blockDim.x) {
      const int r = i / NC, col = (i - r * NC) * EPC;
      const bool in = rows0 + r < ql;
      cp_async16(qs + r * LD + col, qg + (in ? (size_t)r * DK + col : 0), in);
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
                               : min(last_q / UNIT + 1,
                                     (a.pages_per_slot * a.page_size + UNIT - 1) / UNIT);
  const int chunk = (units + splits - 1) / splits;
  const int u0 = min(units, split * chunk), u1 = min(units, u0 + chunk);
  const float c = a.scale;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;  // l: this lane's share
  float o[VC / 8][4];
#pragma unroll
  for (int dt = 0; dt < VC / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;

  // This lane's key of unit u (logical key UNIT u + lane, lanes below
  // UNIT): its page-table entry, loaded a unit ahead of its copy, or -1 for
  // a key on a page past the row's last query or past the block's share.
  auto table_entry = [&](int u) -> int {
    const int j = (u * UNIT + lane) / a.page_size;
    return lane < UNIT && u < u1 && j < a.pages_per_slot && j * a.page_size <= last_q
               ? a.table[b * a.pages_per_slot + j]
               : -1;
  };
  // Unit u into ring slot `dst`, every warp a share of its UNIT x NC
  // 16-byte chunks; a key on an unallocated page or none (pid < 0) is not
  // read, a unit with no read key copies nothing.  Returns the unit's
  // valid-key bits (bit r: key UNIT u + r lies on a read page), the same in
  // every warp.
  auto stage = [&](int u, int pid, T* dst) -> uint32_t {
    const int key = u * UNIT + lane;
    const int row = pid >= 0 && pid < a.n_pages
                        ? pid * a.page_size + key - key / a.page_size * a.page_size
                        : -1;  // physical cache row of this lane's key
    const uint32_t valid = __ballot_sync(0xffffffffu, row >= 0);
    if (valid == 0u) return 0u;
    // UNIT * NC chunks, a multiple of 32: every lane of a warp takes the
    // same number
    for (int i = warp * 32 + lane; i < UNIT * NC; i += 32 * nwarps) {
      const int r = i / NC, col = (i - r * NC) * EPC;
      const int src = __shfl_sync(0xffffffffu, row, r);
      cp_async16(dst + r * LD + col, kp + (src >= 0 ? (size_t)src * kstride + col : 0),
                 src >= 0);
    }
    return valid;
  };
  auto unit_at = [&](int s) { return ring + (size_t)(s % stages) * UNIT * LD; };
  auto issue = [&](int s, int pid) {
    const uint32_t v = stage(u0 + s, pid, unit_at(s));
    cp_async_commit();
    return v;
  };
  const int n_units = u1 - u0;
  uint32_t v0 = issue(0, table_entry(u0)), v1 = 0u, v2 = 0u;
  if (stages == 3) v1 = issue(1, table_entry(u0 + 1));
  int pid_next = table_entry(u0 + stages - 1);
  for (int s = 0; s < n_units; ++s) {
    if (stages == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // unit s (and Q) landed from every thread; unit s - 1 is consumed
    const uint32_t vn = issue(s + stages - 1, pid_next);  // into unit s - 1's slot
    pid_next = table_entry(u0 + s + stages);  // used by the next unit's issue
    if (stages == 3)
      v2 = vn;
    else
      v1 = vn;
    const uint32_t valid = v0;
    v0 = v1;
    v1 = v2;
    if (!active || valid == 0u) continue;
    const T* ks = unit_at(s);
    float sc[NT][4];  // 16 rows x UNIT keys: NT key tiles of 8
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
    const int kc0 = wc * KS;
    if constexpr (F32) {
      // Q's A fragment of a k8 step and K's B fragments of two key tiles,
      // each an ldmatrix of 32-bit words, split into hi and lo; the cross
      // products lo.hi + hi.lo summed apart from hi.hi, so a key tile's S
      // is two dependent chains of mma.sync, not one of three times the
      // length (mma_3xtf32's order)
      float sx[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) sx[nt][0] = sx[nt][1] = sx[nt][2] = sx[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int kc = kc0 + kk;
        uint32_t raw[4], ah[4], al[4];
        ldmatrix_x4(raw, qs + (mt * 16 + (mi & 1) * 8 + mr) * LD + kc * 8 + (mi >> 1) * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(raw[i]), ah[i], al[i]);
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          uint32_t bk[4], bh[4], bl[4];
          ldmatrix_x4(bk, ks + (nt * 8 + (mi >> 1) * 8 + mr) * LD + kc * 8 + (mi & 1) * 4);
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
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] += sx[nt][e];
    } else {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int kc = kc0 + kk;
        uint32_t qa[4];
        ldmatrix_x4(qa, qs + (mt * 16 + (lane & 15)) * LD + kc * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          uint32_t bk[4];
          ldmatrix_x4(bk, ks + (nt * 8 + (mi >> 1) * 8 + mr) * LD + kc * 16 + (mi & 1) * 8);
          mma_bf16(sc[nt], qa, bk[0], bk[1]);
          mma_bf16(sc[nt + 1], qa, bk[2], bk[3]);
        }
      }
    }
    // Every warp of the M-tile writes its partial S; warp w sums slots
    // [w PER, (w + 1) PER) of the M-tile's NT x 32 (a key tile's fragment
    // in a lane) over the warps in warp order and writes them; every warp
    // reads the sums.  Each slot is summed once, so every warp of the
    // M-tile holds the same S.
    {
      float4* tile_partials = partials + (size_t)mt * NW * NT * 32;
      float4* tile_sums = sums + (size_t)mt * NT * 32;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        tile_partials[(wc * NT + nt) * 32 + lane] =
            make_float4(sc[nt][0], sc[nt][1], sc[nt][2], sc[nt][3]);
      named_barrier(1 + mt, NW * 32);
#pragma unroll
      for (int i = lane; i < PER; i += 32) {
        const int slot = wc * PER + i;
        float4 t = tile_partials[slot];
#pragma unroll
        for (int w = 1; w < NW; ++w) {
          const float4 q = tile_partials[w * NT * 32 + slot];
          t.x += q.x;
          t.y += q.y;
          t.z += q.z;
          t.w += q.w;
        }
        tile_sums[slot] = t;
      }
      named_barrier(1 + mt, NW * 32);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float4 t = tile_sums[nt * 32 + lane];
        sc[nt][0] = t.x;
        sc[nt][1] = t.y;
        sc[nt][2] = t.z;
        sc[nt][3] = t.w;
      }
    }
    // scale (fp32, as the plain version), softcap, mask only a unit that
    // reaches past qmin or holds an unread key
    const int k0 = (u0 + s) * UNIT;
    const bool full = valid == kAll && k0 + UNIT - 1 <= qmin;
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
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
    for (int nt = 0; nt < NT; ++nt) {
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
    for (int dt = 0; dt < VC / 8; ++dt) {
      o[dt][0] *= corr_a;
      o[dt][1] *= corr_a;
      o[dt][2] *= corr_b;
      o[dt][3] *= corr_b;
    }
    // O[:, this warp's columns] += P.V, V the unit's first DV columns
    const T* vs = ks + wc * VC;
    if constexpr (F32) {
      // A key tile's accumulator fragment is P's A fragment with the
      // tile's keys taken in the order k = q <-> key 2q, k = q + 4 <->
      // key 2q + 1; V's B fragment (keys 2 tq4 and 2 tq4 + 1, column g)
      // is read in the same order, a word at a time
#pragma unroll
      for (int kc = 0; kc < NT; ++kc) {
        uint32_t ph[4], pl[4];
        split_tf32(sc[kc][0], ph[0], pl[0]);
        split_tf32(sc[kc][2], ph[1], pl[1]);
        split_tf32(sc[kc][1], ph[2], pl[2]);
        split_tf32(sc[kc][3], ph[3], pl[3]);
        const T* v0 = vs + (kc * 8 + 2 * tq4) * LD + g;
#pragma unroll
        for (int dt = 0; dt < VC / 8; ++dt) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(v0[dt * 8], bh0, bl0);
          split_tf32(v0[LD + dt * 8], bh1, bl1);
          mma_3xtf32(o[dt], ph, pl, bh0, bh1, bl0, bl1);
        }
      }
    } else {
      // two key tiles' accumulator fragments are one A fragment
#pragma unroll
      for (int kc = 0; kc < UNIT / 16; ++kc) {
        const uint32_t pa[4] = {pack_bf16(sc[2 * kc][0], sc[2 * kc][1]),
                                pack_bf16(sc[2 * kc][2], sc[2 * kc][3]),
                                pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]),
                                pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3])};
#pragma unroll
        for (int dt = 0; dt < VC / 8; dt += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv,
                            vs + (kc * 16 + (mi & 1) * 8 + mr) * LD + (dt + (mi >> 1)) * 8);
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

  T* __restrict__ out = static_cast<T*>(a.out) + (size_t)bh * ql * DV;
  if (splits == 1) {  // the warp's rows and columns, normalised, to out
    if (!active) return;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? row_b : row_a;
      if (row >= ql) continue;
      // a query with nothing attendable keeps l == 0 and writes zeros
      const float inv = 1.f / fmaxf(half ? l_b : l_a, 1e-30f);
      T* dst = out + (size_t)row * DV + wc * VC + tq4 * 2;
#pragma unroll
      for (int dt = 0; dt < VC / 8; ++dt) {
        if constexpr (F32)
          *reinterpret_cast<float2*>(dst + dt * 8) =
              make_float2(o[dt][2 * half] * inv, o[dt][2 * half + 1] * inv);
        else
          *reinterpret_cast<uint32_t*>(dst + dt * 8) =
              pack_bf16(o[dt][2 * half] * inv, o[dt][2 * half + 1] * inv);
      }
    }
    return;
  }
  // More than one split: each block's state (f32 o, unnormalised, rows
  // padded to kMlaStateLD, then each row's (m, l)) goes to its own shared
  // memory, over Q and the ring
  const int R = rows1 - rows0;
  constexpr int SLD = kMlaStateLD;
  __syncthreads();  // every warp is done with Q and the ring
  float* state = reinterpret_cast<float*>(smem4);
  float2* state_ml = reinterpret_cast<float2*>(state + (size_t)tiles * 16 * SLD);
  if (active) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? row_b : row_a;
      if (row >= ql) continue;
      float* slot = state + (size_t)(row - rows0) * SLD + wc * VC + tq4 * 2;
      if (wc == 0 && tq4 == 0)
        state_ml[row - rows0] = make_float2(half ? m_b : m_a, half ? l_b : l_a);
#pragma unroll
      for (int dt = 0; dt < VC / 8; ++dt)
        *reinterpret_cast<float2*>(slot + dt * 8) =
            make_float2(o[dt][2 * half], o[dt][2 * half + 1]);
    }
  }
  // The splits of a (row, kv head, group) are one cluster: block `split`
  // merges the group's rows [r0, r0 + n), reading every block's state
  // through distributed shared memory, and no block leaves while another
  // may still read its state.
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int per = (R + splits - 1) / splits;
  const int r0 = min(R, split * per), n = min(R, r0 + per) - r0;
  float* wgt = reinterpret_cast<float*>(state_ml + tiles * 16);  // [splits][per], 1 / l [per]
  float* inv = wgt + splits * per;
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    float2 ml[kMlaMaxClusterSplits];
    float mx = kNegInf;
#pragma unroll
    for (int sp = 0; sp < kMlaMaxClusterSplits; ++sp) {
      if (sp < splits) {
        ml[sp] = cluster.map_shared_rank(state_ml, sp)[r0 + r];
        mx = fmaxf(mx, ml[sp].x);
      }
    }
    float l = 0.f;
#pragma unroll
    for (int sp = 0; sp < kMlaMaxClusterSplits; ++sp) {
      if (sp < splits) {
        // an empty split has m = -1e30 and l = 0: weight 0, or 1 times 0
        const float w = exp2f((ml[sp].x - mx) * kLog2e);
        wgt[sp * per + r] = w;
        l = fmaf(ml[sp].y, w, l);
      }
    }
    inv[r] = 1.f / fmaxf(l, 1e-30f);
  }
  __syncthreads();
  constexpr int V4 = DV / 4;
  for (int i = threadIdx.x; i < n * V4; i += blockDim.x) {
    const int r = i / V4, c4 = i - r * V4;
    const size_t at = (size_t)(r0 + r) * (SLD / 4) + c4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int sp = 0; sp < splits; ++sp) {
      const float4 v = reinterpret_cast<const float4*>(cluster.map_shared_rank(state, sp))[at];
      const float w = wgt[sp * per + r];
      acc.x = fmaf(v.x, w, acc.x);
      acc.y = fmaf(v.y, w, acc.y);
      acc.z = fmaf(v.z, w, acc.z);
      acc.w = fmaf(v.w, w, acc.w);
    }
    const float sc = inv[r];
    T* dst = out + (size_t)(rows0 + r0 + r) * DV + c4 * 4;
    if constexpr (F32)
      *reinterpret_cast<float4*>(dst) = make_float4(acc.x * sc, acc.y * sc, acc.z * sc, acc.w * sc);
    else
      *reinterpret_cast<uint2*>(dst) =
          make_uint2(pack_bf16(acc.x * sc, acc.y * sc), pack_bf16(acc.z * sc, acc.w * sc));
  }
  cluster.sync();
}

template <typename T>
cudaError_t run_mla(const Args& a, int groups, int splits, cudaStream_t stream) {
  using C = MlaCfg<T>;
  int dev = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const int mtiles = (a.ql + 15) / 16;
  const int tiles = (mtiles + groups - 1) / groups;
  const int units = (a.pages_per_slot * a.page_size + C::UNIT - 1) / C::UNIT;
  // the plan (flash_decode.tensor_core_plan): groups of at most MAX_TILES
  // M-tiles, none empty; at most a split a unit and a cluster's worth
  if (groups < 1 || groups > 65535 || tiles > C::MAX_TILES || (groups - 1) * tiles >= mtiles ||
      splits < 1 || splits > (units > 1 ? units : 1) || splits > kMlaMaxClusterSplits ||
      (long)a.batch * a.hkv > 65535)
    return cudaErrorInvalidValue;
  const MlaBlock blk = mla_block<T>(tiles, splits);
  if (blk.smem > (size_t)smem_max) return cudaErrorInvalidValue;
  auto kernel = paged_mla_kernel<T>;
  if (blk.smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)blk.smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, groups, a.batch * a.hkv);
  cfg.blockDim = dim3(tiles * C::NW * 32);
  cfg.dynamicSmemBytes = blk.smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = splits;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, a, tiles, blk.stages);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// MLA's fold on the tensor cores: one latent pool as K and V (values its
// first 512 columns), in the row groups and key splits of the host's plan;
// dtype 0 (f32, 3xTF32) or 1 (bf16).
cudaError_t paged::launch_mla(const Args& a, int dtype, int groups, int splits,
                              cudaStream_t stream) {
  if (a.dk != kMlaDK || a.dv != kMlaDV || a.dv_store != kMlaDK || a.k_pages != a.v_pages)
    return cudaErrorInvalidValue;
  if (dtype == 0) return run_mla<float>(a, groups, splits, stream);
  if (dtype == 1) return run_mla<__nv_bfloat16>(a, groups, splits, stream);
  return cudaErrorInvalidValue;
}
