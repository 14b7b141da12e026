// Mamba2 SSD within-chunk term for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd.py::_ssd_chunk_kernel
// (reached through ssd_chunk_pallas).  For one (batch, chunk) and one
// block of heads, over the chunk's q positions:
//
//   Y_diag[i,h,p] = sum_{j<=i} S[i,j] * exp(cum[i,h] - cum[j,h]) * dt[j,h] * x[j,h,p]
//   state[h,p,n]  = sum_j exp(cum[q-1,h] - cum[j,h]) * dt[j,h] * x[j,h,p] * B[j,n]
//
// with S = C.B^T and cum the running sum of dA.  Inputs x, B, C in f32 or
// bf16, dA and dt in f32; both outputs f32.
//
// Design.  One block of 8 warps per (batch*chunk, head block); q is padded
// to 16-row tiles (at most 8).  The two input types take two routes on one
// warp layout, each held to its gates on the card:
//   - f32: S = C.B^T as fp32 FMA in order on the CUDA cores, the plain
//     version's rounding bit for bit (s_tiles: the 2e-5 gate needs it);
//     Y_diag and the states on the tensor cores in 3xTF32
//     (mma.sync.m16n8k8, each operand split into TF32 hi and lo by
//     integer rounding, lo.hi + hi.lo + hi.hi), as the f32 flash kernel
//     does.  Warp w owns rows 16 w .. 16 w + 15: S stays in registers in
//     the accumulator layout (only tiles on or below the diagonal), and
//     Y = M.x takes M = S o exp(cum_i - cum_j) o dt_j from it (the
//     difference before the exp, the mask only on the diagonal tile, the
//     S columns 2t, 2t + 1 taken as k = t, t + 4 so the accumulator feeds
//     the A fragment without a shuffle, x read in the same order).  The
//     states (w o x)^T.B, w_j = exp(cum_end - cum_j) dt_j, a 16 p x (n /
//     warps-per-p-tile) tile a warp, w o x split as it is loaded.
//   - bf16: every product on the tensor cores (mma.sync.m16n8k16, fp32
//     accumulation).  S = C.B^T from the bf16 operands as they are (their
//     products are exact in fp32), in registers in the accumulator layout
//     as on the f32 route.  Y = M.x: M formed in fp32 from the
//     accumulators as on the f32 route (the mask on the diagonal tile
//     before the split), then split into three bf16 parts hi + mid + lo
//     (about 2^-24 of M) that feed the A fragments of three products
//     against x (bf16, exact): an accumulator tile pair (columns 2t, 2t + 1
//     of tiles 2k and 2k + 1) is the A fragment of k-step k, the P-from-S
//     packing of csrc/paged_tensor_core.cu.  The states (w o x)^T.B take w o
//     x in three bf16 parts as x's fragment is loaded.  Every fragment comes
//     through ldmatrix (x and B transposed where j is the summed index).
//     The result sits within 1e-4 of the plain version (the f32 plain
//     outputs rounded to bf16 miss it): mamba2's bf16 eval holds its logits
//     to an f32 witness of the same weights (chip_smoke.py, witness_gate).
//   - B and C come into shared memory once per block through 16-byte
//     cp.async, rows padded (bf16 by 8 elements, f32 by 4) so fragment
//     loads hit distinct banks.
//   - each head's x, dA and dt come in through cp.async into a head slot,
//     with its running sums and state weights beside them (in the
//     reference's rounding: in order within blocks of 16 positions, each
//     block offset by the in-order total of the blocks before, what its
//     jnp.cumsum computes on the CPU backend).  Where all of the block's
//     heads fit in half of a block's shared memory (short chunks: serving
//     prefill), each has a slot: every copy is issued at once, the warps
//     sum the heads side by side, and the heads run with no barrier between
//     them.  Else two slots: the next head's copy is in flight while one
//     computes, warp 0 sums it, one barrier a head, and shared memory does
//     not grow with the heads a block takes.  (bf16 at q 128 would hold
//     all 8 heads in 229,376 bytes; so it ran 1.2x slower than through two
//     slots, every copy landing before any head computed:
//     tools/kernel_variants.py.)
//   - the outputs leave straight from the accumulator fragments, 8 bytes
//     a lane: each store fills whole 32-byte sectors.
//   Every output element is written once by one thread: no atomics, the
//   same result from run to run.  Padded rows (dt = 0) and idle rows give
//   exactly 0.
//
// Bound on this card, at mamba2-1.3b's eval shapes (q 128, h 64, p 64,
// n 128): bytes (the f32 Y_diag and states are most of what moves, ~172
// MB at bf16 8 x 512; in f32 three TF32 passes at 494.7 TFLOP/s come near
// that time, in bf16 three bf16 passes take about a third of it).  One
// block of 8 warps an SM: the register bound leaves up to 255 a thread.
// ptxas -v (sm_90a): bf16 168-172 registers at p 64, 156-158 at 32,
// 144-146 at 16; f32 183-222 at p 64; no spills.  bf16's shared memory
// would admit two blocks at q 128 (109,568 bytes); capped at 128
// registers for them it spilled and ran 1.07x slower.
// tools/kernel_variants.py times each choice here undone, the phases'
// shares, and a zero fill of the outputs (the f32 writes alone take
// about half of the f32 route's time).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm80.cuh"

namespace {

using mma_sm80::cp_async16;
using mma_sm80::cp_async_commit;
using mma_sm80::cp_async_wait;
using mma_sm80::ldmatrix_x4;
using mma_sm80::ldmatrix_x4_trans;
using mma_sm80::mma_3xtf32;
using mma_sm80::mma_bf16;
using mma_sm80::smem_addr;
using mma_sm80::split_tf32;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxQ = kWarps * 16;
constexpr int kCumBlock = 16;
constexpr int kSmemLimit = 232448;  // bytes a block may take on an H100
constexpr unsigned kFull = 0xffffffffu;

// Bytes of dynamic shared memory (kernels/ssd.py::smem_bytes mirrors it):
// B and C (q rows of n + pad), `slots` head slots, each one head's x (q
// rows of p + pad) and its running sums, dt and state weights.
__host__ __device__ constexpr int pad_of(int item) { return item == 4 ? 4 : 8; }
__host__ __device__ constexpr size_t smem_bytes(int q, int p, int n, int item, int slots) {
  return (size_t)((q + 15) & ~15) *
         (2 * (n + pad_of(item)) * item + slots * ((p + pad_of(item)) * item + 3 * sizeof(float)));
}

// Head slots a block takes: one a head where all of its heads fit in half
// of the block's limit, so every copy is issued at once; else two, the
// next head's copy in flight while one computes.
int head_slots(int q, int p, int n, int item, int hb) {
  return hb <= 2 || smem_bytes(q, p, n, item, hb) <= kSmemLimit / 2 ? hb : 2;
}

template <typename T, int P, int N>
struct Tile {
  static constexpr int LDB = N + pad_of(sizeof(T));  // B and C rows (elements)
  static constexpr int LDX = P + pad_of(sizeof(T));  // x rows
  // states: 16 p a m-tile; warps share an m-tile's n columns in units of
  // one 8-column n-tile
  static constexpr int MT = P / 16;
  static constexpr int WPM = kWarps / MT;
  static constexpr int UNITS = N / 8;
  static constexpr int UPW = UNITS / WPM > 0 ? UNITS / WPM : 1;  // n-tiles a warp
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// A 16 x 8 accumulator tile out, 8 bytes a lane: row_a / row_b point at
// column 0 of rows g and g + 8; ok_a / ok_b say whether they are written.
// (16-byte stores after a lane swap measured slower:
// tools/kernel_variants.py float4_lane_swap.)
__device__ __forceinline__ void store_tile(float* row_a, float* row_b, const float (&c)[4], int t,
                                           bool ok_a, bool ok_b) {
  if (ok_a) *reinterpret_cast<float2*>(row_a + 2 * t) = make_float2(c[0], c[1]);
  if (ok_b) *reinterpret_cast<float2*>(row_b + 2 * t) = make_float2(c[2], c[3]);
}

// One warp: one head's running sums and state weights, in place over the
// [cum (dA on entry) | dt | w] rows of qp floats, in the reference's
// rounding.  Lane k < qp / 16 takes positions 16 k .. 16 k + 15; padded
// positions get cum = cum[q-1] (finite) and w = 0 (dt is zero-filled).
__device__ __forceinline__ void head_sums(float* hv, int q, int qp, int lane) {
  float* cum = hv;
  const float* dtv = hv + qp;
  float* wv = hv + 2 * qp;
  const int s = lane * kCumBlock;
  float r[kCumBlock];
  float run = 0.f;
#pragma unroll
  for (int i = 0; i < kCumBlock; ++i) {
    const float a = s + i < q ? cum[s + i] : 0.f;
    run = i == 0 ? a : run + a;
    r[i] = run;
  }
  float before = 0.f;  // in-order total of the blocks before this lane's
#pragma unroll
  for (int m = 0; m < kMaxQ / kCumBlock - 1; ++m) {
    const float tm = __shfl_sync(kFull, run, m);
    if (m < lane) before = before + tm;
  }
  // run stays put past q (+0), so the last block's total is its cum[q-1]
  const float end = __shfl_sync(kFull, run + before, (q - 1) / kCumBlock);
  if (s < qp) {
#pragma unroll
    for (int i = 0; i < kCumBlock; ++i) {
      const int j = s + i;
      if (j < q) {
        const float c = r[i] + before;
        cum[j] = c;
        wv[j] = expf(end - c) * dtv[j];
      } else {
        cum[j] = end;
        wv[j] = 0.f;
      }
    }
  }
}

// ------------------------------------------------------------ S = C.B^T
// f32: fp32 FMA in order over n, as the plain version's product sums, bit
// for bit.  exp-weighted sums of dt x carry S's rounding into Y_diag at up
// to ~20x, and the f32 gate (2e-5) holds only against the same rounding: a
// tensor-core S, even an exact one, misses it against the in-order fp32
// plain version at mamba2-1.3b's shapes (tools/ssd_rounding.py).  Each lane
// forms its own fragment's values, so S lands in the accumulator layout.
template <int N>
__device__ __forceinline__ void s_tiles(float (&s)[16][4], const float* Cs, const float* Bs,
                                        int warp, int lane) {
  constexpr int LD = N + 4;
  const int g = lane >> 2, t = lane & 3;
  const float* ca = Cs + (warp * 16 + g) * LD;
  const float* cb = ca + 8 * LD;
#pragma unroll
  for (int nt = 0; nt < 2 * kWarps; ++nt) {
    if ((nt >> 1) <= warp) {
      const float* b0 = Bs + (nt * 8 + 2 * t) * LD;
      const float* b1 = b0 + LD;
      float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
#pragma unroll 4
      for (int k = 0; k < N; k += 4) {
        const float4 a = *reinterpret_cast<const float4*>(ca + k);
        const float4 c = *reinterpret_cast<const float4*>(cb + k);
        const float4 u = *reinterpret_cast<const float4*>(b0 + k);
        const float4 v = *reinterpret_cast<const float4*>(b1 + k);
        s00 = fmaf(a.w, u.w, fmaf(a.z, u.z, fmaf(a.y, u.y, fmaf(a.x, u.x, s00))));
        s01 = fmaf(a.w, v.w, fmaf(a.z, v.z, fmaf(a.y, v.y, fmaf(a.x, v.x, s01))));
        s10 = fmaf(c.w, u.w, fmaf(c.z, u.z, fmaf(c.y, u.y, fmaf(c.x, u.x, s10))));
        s11 = fmaf(c.w, v.w, fmaf(c.z, v.z, fmaf(c.y, v.y, fmaf(c.x, v.x, s11))));
      }
      s[nt][0] = s00;
      s[nt][1] = s01;
      s[nt][2] = s10;
      s[nt][3] = s11;
    }
  }
}

// M's four values of one accumulator tile: S times exp(cum_i - cum_j) dt_j
// at rows g (ca) and g + 8 (cb), columns j0 = 8 tile + 2t and j0 + 1;
// `diag` masks j > i (jl: the column within the 16-row diagonal tile).
__device__ __forceinline__ void m_values(float (&m)[4], const float (&s)[4], const float* cum,
                                         const float* dtv, int j0, float ca, float cb, bool diag,
                                         int jl, int g) {
  const float2 cj = *reinterpret_cast<const float2*>(cum + j0);
  const float2 dj = *reinterpret_cast<const float2*>(dtv + j0);
  m[0] = s[0] * expf(ca - cj.x) * dj.x;
  m[1] = s[1] * expf(ca - cj.y) * dj.y;
  m[2] = s[2] * expf(cb - cj.x) * dj.x;
  m[3] = s[3] * expf(cb - cj.y) * dj.y;
  if (diag) {
    if (jl > g) m[0] = 0.f;
    if (jl + 1 > g) m[1] = 0.f;
    if (jl > g + 8) m[2] = 0.f;
    if (jl + 1 > g + 8) m[3] = 0.f;
  }
}

// ----------------------------------------------------- Y_diag of one head
template <int P>
__device__ __forceinline__ void y_head(const float (&s)[16][4], const float* xs, const float* hv,
                                       int qp, int q, int warp, int lane, float* yg, int hp) {
  constexpr int LD = P + 4;
  const int g = lane >> 2, t = lane & 3;
  const float* cum = hv;
  const float* dtv = hv + qp;
  const int r0 = warp * 16;
  const float ca = cum[r0 + g], cb = cum[r0 + g + 8];
  float acc[P / 8][4] = {};
#pragma unroll
  for (int kc = 0; kc < 2 * kWarps; ++kc) {
    if ((kc >> 1) <= warp) {
      // this lane's columns 2t, 2t + 1 of the tile serve as k = t, t + 4
      float m[4];
      m_values(m, s[kc], cum, dtv, kc * 8 + 2 * t, ca, cb, (kc >> 1) == warp,
               (kc & 1) * 8 + 2 * t, g);
      uint32_t ah[4], al[4];
      split_tf32(m[0], ah[0], al[0]);
      split_tf32(m[2], ah[1], al[1]);
      split_tf32(m[1], ah[2], al[2]);
      split_tf32(m[3], ah[3], al[3]);
      const float* v0 = xs + (kc * 8 + 2 * t) * LD + g;  // x rows in the same order
#pragma unroll
      for (int pt = 0; pt < P / 8; ++pt) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(v0[pt * 8], bh0, bl0);
        split_tf32(v0[LD + pt * 8], bh1, bl1);
        mma_3xtf32(acc[pt], ah, al, bh0, bh1, bl0, bl1);
      }
    }
  }
  const int ra = r0 + g, rb = ra + 8;
#pragma unroll
  for (int nt = 0; nt < P / 8; ++nt)
    store_tile(yg + (size_t)ra * hp + nt * 8, yg + (size_t)rb * hp + nt * 8, acc[nt], t, ra < q,
               rb < q);
}

// ------------------------------------------------------ states of one head
template <int P, int N>
__device__ __forceinline__ void state_head(const float* xs, const float* Bs, const float* wv,
                                           int qt, int warp, int lane, float* sg) {
  using K = Tile<float, P, N>;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp / K::WPM, u0 = (warp % K::WPM) * K::UPW;
  if (u0 >= K::UNITS) return;
  float acc[K::UPW][4] = {};
#pragma unroll
  for (int kc = 0; kc < 2 * kWarps; ++kc) {
    if (kc < 2 * qt) {
      // k = t, t + 4 taken as j = j0, j0 + 1 (j0 = 8 kc + 2t) on both sides
      const int j0 = kc * 8 + 2 * t;
      const float2 w = *reinterpret_cast<const float2*>(wv + j0);
      const float* xr = xs + j0 * K::LDX + mt * 16 + g;
      uint32_t ah[4], al[4];
      split_tf32(xr[0] * w.x, ah[0], al[0]);
      split_tf32(xr[8] * w.x, ah[1], al[1]);
      split_tf32(xr[K::LDX] * w.y, ah[2], al[2]);
      split_tf32(xr[K::LDX + 8] * w.y, ah[3], al[3]);
      const float* br = Bs + j0 * K::LDB + g;
#pragma unroll
      for (int u = 0; u < K::UPW; ++u) {
        if (u0 + u < K::UNITS) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(br[(u0 + u) * 8], bh0, bl0);
          split_tf32(br[K::LDB + (u0 + u) * 8], bh1, bl1);
          mma_3xtf32(acc[u], ah, al, bh0, bh1, bl0, bl1);
        }
      }
    }
  }
  float* ra = sg + (size_t)(mt * 16 + g) * N;
#pragma unroll
  for (int i = 0; i < K::UPW; ++i)
    if (u0 + i < K::UNITS)
      store_tile(ra + (u0 + i) * 8, ra + 8 * N + (u0 + i) * 8, acc[i], t, true, true);
}

// ----------------------------------------------- bf16, on the tensor cores
// Fragments through ldmatrix: lane 8 i + r addresses row r of 8 x 8 matrix
// i (li = i, lr = r below).

// v0, v1 (neighbouring k) in three bf16 parts, packed as mma operands:
// hi + mid + lo = v to about 2^-24 of v (each remainder is exact in fp32).
// Zero stays exactly zero in every part.
__device__ __forceinline__ void split_bf16x3(float v0, float v1, uint32_t& hi, uint32_t& mid,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float r0 = v0 - __low2float(h), r1 = v1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(r0 - __low2float(m), r1 - __high2float(m));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// c += (hi + mid + lo).b, the small parts first
__device__ __forceinline__ void mma_bf16x3(float* c, const uint32_t (&ah)[4],
                                           const uint32_t (&am)[4], const uint32_t (&al)[4],
                                           uint32_t b0, uint32_t b1) {
  mma_bf16(c, al, b0, b1);
  mma_bf16(c, am, b0, b1);
  mma_bf16(c, ah, b0, b1);
}

// S = C.B^T: warp w's rows 16 w .. 16 w + 15 against key tiles on or below
// the diagonal, k-steps of 16 over n; an x4 load of B gives two 8-row tiles.
template <int N>
__device__ __forceinline__ void s_tiles_bf16(float (&s)[16][4], const __nv_bfloat16* Cs,
                                             const __nv_bfloat16* Bs, int warp, int lane) {
  constexpr int LD = N + 8;
  const int li = lane >> 3, lr = lane & 7;
  const __nv_bfloat16* ca = Cs + (warp * 16 + (li & 1) * 8 + lr) * LD + (li >> 1) * 8;
  const __nv_bfloat16* bb = Bs + ((li >> 1) * 8 + lr) * LD + (li & 1) * 8;
#pragma unroll
  for (int k = 0; k < N; k += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, ca + k);
#pragma unroll
    for (int jt = 0; jt < kWarps; ++jt) {
      if (jt <= warp) {
        uint32_t b[4];
        ldmatrix_x4(b, bb + jt * 16 * LD + k);
        mma_bf16(s[2 * jt], a, b[0], b[1]);
        mma_bf16(s[2 * jt + 1], a, b[2], b[3]);
      }
    }
  }
}

// Y_diag of one head: k-step kc takes S's tiles 2 kc and 2 kc + 1 as M's
// A fragment, x's rows 16 kc .. 16 kc + 15 (transposed) as B, two p-tiles
// an x4 load.
template <int P>
__device__ __forceinline__ void y_head_bf16(const float (&s)[16][4], const __nv_bfloat16* xs,
                                            const float* hv, int qp, int q, int warp, int lane,
                                            float* yg, int hp) {
  constexpr int LD = P + 8;
  const int g = lane >> 2, t = lane & 3, li = lane >> 3, lr = lane & 7;
  const float* cum = hv;
  const float* dtv = hv + qp;
  const int r0 = warp * 16;
  const float ca = cum[r0 + g], cb = cum[r0 + g + 8];
  const __nv_bfloat16* xl = xs + ((li & 1) * 8 + lr) * LD + (li >> 1) * 8;
  float acc[P / 8][4] = {};
#pragma unroll
  for (int kc = 0; kc < kWarps; ++kc) {
    if (kc <= warp) {
      float m0[4], m1[4];
      m_values(m0, s[2 * kc], cum, dtv, kc * 16 + 2 * t, ca, cb, kc == warp, 2 * t, g);
      m_values(m1, s[2 * kc + 1], cum, dtv, kc * 16 + 8 + 2 * t, ca, cb, kc == warp, 8 + 2 * t,
               g);
      uint32_t ah[4], am[4], al[4];
      split_bf16x3(m0[0], m0[1], ah[0], am[0], al[0]);
      split_bf16x3(m0[2], m0[3], ah[1], am[1], al[1]);
      split_bf16x3(m1[0], m1[1], ah[2], am[2], al[2]);
      split_bf16x3(m1[2], m1[3], ah[3], am[3], al[3]);
#pragma unroll
      for (int pt = 0; pt < P / 16; ++pt) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, xl + kc * 16 * LD + pt * 16);
        mma_bf16x3(acc[2 * pt], ah, am, al, b[0], b[1]);
        mma_bf16x3(acc[2 * pt + 1], ah, am, al, b[2], b[3]);
      }
    }
  }
  const int ra = r0 + g, rb = ra + 8;
#pragma unroll
  for (int nt = 0; nt < P / 8; ++nt)
    store_tile(yg + (size_t)ra * hp + nt * 8, yg + (size_t)rb * hp + nt * 8, acc[nt], t, ra < q,
               rb < q);
}

// The states of one head: A = (w o x)^T (x's rows 16 kc .. 16 kc + 15
// transposed, times w_j, in three parts), B = B's rows (transposed), two
// n-tiles an x4 load (one where a warp owns one).
template <int P, int N>
__device__ __forceinline__ void state_head_bf16(const __nv_bfloat16* xs, const __nv_bfloat16* Bs,
                                                const float* wv, int qt, int warp, int lane,
                                                float* sg) {
  using K = Tile<__nv_bfloat16, P, N>;
  const int g = lane >> 2, t = lane & 3, li = lane >> 3, lr = lane & 7;
  const int mt = warp / K::WPM, u0 = (warp % K::WPM) * K::UPW;
  if (u0 >= K::UNITS) return;
  const __nv_bfloat16* xa = xs + ((li >> 1) * 8 + lr) * K::LDX + mt * 16 + (li & 1) * 8;
  const __nv_bfloat16* bl = Bs + ((li & 1) * 8 + lr) * K::LDB;
  float acc[K::UPW + 1][4] = {};
#pragma unroll
  for (int kc = 0; kc < kWarps; ++kc) {
    if (kc < qt) {
      uint32_t raw[4];
      ldmatrix_x4_trans(raw, xa + kc * 16 * K::LDX);
      const float2 w0 = *reinterpret_cast<const float2*>(wv + kc * 16 + 2 * t);
      const float2 w1 = *reinterpret_cast<const float2*>(wv + kc * 16 + 8 + 2 * t);
      uint32_t ah[4], am[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 w = i < 2 ? w0 : w1;
        split_bf16x3(__uint_as_float(raw[i] << 16) * w.x,
                     __uint_as_float(raw[i] & 0xffff0000u) * w.y, ah[i], am[i], al[i]);
      }
#pragma unroll
      for (int u = 0; u < K::UPW; u += 2) {
        if (u0 + u < K::UNITS) {
          const bool two = u + 1 < K::UPW && u0 + u + 1 < K::UNITS;
          uint32_t b[4];
          ldmatrix_x4_trans(b, bl + kc * 16 * K::LDB + (u0 + u + (two && li >= 2)) * 8);
          mma_bf16x3(acc[u], ah, am, al, b[0], b[1]);
          if (two) mma_bf16x3(acc[u + 1], ah, am, al, b[2], b[3]);
        }
      }
    }
  }
  float* ra = sg + (size_t)(mt * 16 + g) * N;
#pragma unroll
  for (int i = 0; i < K::UPW; ++i)
    if (u0 + i < K::UNITS)
      store_tile(ra + (u0 + i) * 8, ra + 8 * N + (u0 + i) * 8, acc[i], t, true, true);
}

// ------------------------------------------------------------------ kernel
template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dA,
                     const float* __restrict__ dt, const T* __restrict__ B,
                     const T* __restrict__ C, float* __restrict__ y, float* __restrict__ st,
                     int q, int H, int hb, int slots) {
  using K = Tile<T, P, N>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int qp = (q + 15) & ~15, qt = qp / 16;
  const bool resident = slots == hb;     // every head in its own slot
  T* Bs = reinterpret_cast<T*>(smem);     // [qp][LDB]
  T* Cs = Bs + qp * K::LDB;               // [qp][LDB]
  T* xs0 = Cs + qp * K::LDB;              // [slots][qp][LDX]: heads' x
  float* hv0 = reinterpret_cast<float*>(xs0 + slots * qp * K::LDX);  // [slots][cum | dt | w][qp]
  constexpr bool kBf16 = sizeof(T) == 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bc = blockIdx.x, h0 = blockIdx.y * hb;
  constexpr int E = 16 / sizeof(T);  // elements a 16-byte copy

  // B and C, rows past q zero-filled
  {
    constexpr int CH = N / E;
    const T* Bg = B + (size_t)bc * q * N;
    const T* Cg = C + (size_t)bc * q * N;
    for (int i = tid; i < qp * CH; i += kThreads) {
      const int r = i / CH, c = (i % CH) * E;
      const bool in = r < q;
      const size_t o = in ? (size_t)r * N + c : 0;
      cp_async16(Bs + r * K::LDB + c, Bg + o, in);
      cp_async16(Cs + r * K::LDB + c, Cg + o, in);
    }
  }
  cp_async_commit();
  auto slot_of = [&](int hh) { return resident ? hh : hh & 1; };
  // x of head hh (all threads) and its dA and dt (warp 0, which sums them
  // when the heads stream through two slots)
  auto load_head = [&](int hh) {
    const int h = h0 + hh;
    T* xs = xs0 + slot_of(hh) * qp * K::LDX;
    constexpr int CH = P / E;
    const T* xg = x + ((size_t)bc * q * H + h) * P;
    for (int i = tid; i < qp * CH; i += kThreads) {
      const int r = i / CH, c = (i % CH) * E;
      const bool in = r < q;
      cp_async16(xs + r * K::LDX + c, xg + (in ? (size_t)r * H * P + c : 0), in);
    }
    if (warp == 0) {
      float* hv = hv0 + slot_of(hh) * 3 * qp;
      for (int j = lane; j < qp; j += 32) {
        const bool in = j < q;
        const size_t o = in ? ((size_t)bc * q + j) * H + h : 0;
        cp_async4(hv + j, dA + o, in);
        cp_async4(hv + qp + j, dt + o, in);
      }
    }
  };
  if (resident) {
    // every copy at once; the warps sum the heads side by side
    for (int hh = 0; hh < hb; ++hh) load_head(hh);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int hh = warp; hh < hb; hh += kWarps) head_sums(hv0 + hh * 3 * qp, q, qp, lane);
  } else {
    load_head(0);
    cp_async_commit();
    load_head(1);
    cp_async_commit();
    cp_async_wait<1>();
    if (warp == 0) {
      __syncwarp();
      head_sums(hv0, q, qp, lane);
    }
  }
  __syncthreads();

  float s[16][4] = {};
  if (warp < qt) {
    if constexpr (kBf16)
      s_tiles_bf16<N>(s, Cs, Bs, warp, lane);
    else
      s_tiles<N>(s, Cs, Bs, warp, lane);
  }

  for (int hh = 0; hh < hb; ++hh) {
    const int h = h0 + hh, buf = slot_of(hh);
    const T* xs = xs0 + buf * qp * K::LDX;
    const float* hv = hv0 + buf * 3 * qp;
    float* yh = y + ((size_t)bc * q * H + h) * P;
    float* sh = st + ((size_t)bc * H + h) * P * N;
    if constexpr (kBf16) {
      if (warp < qt) y_head_bf16<P>(s, xs, hv, qp, q, warp, lane, yh, H * P);
      state_head_bf16<P, N>(xs, Bs, hv + 2 * qp, qt, warp, lane, sh);
    } else {
      if (warp < qt) y_head<P>(s, xs, hv, qp, q, warp, lane, yh, H * P);
      state_head<P, N>(xs, Bs, hv + 2 * qp, qt, warp, lane, sh);
    }
    if (resident) continue;  // no slot is reused
    // head hh + 1's copies have landed for this thread; warp 0 sums them
    cp_async_wait<0>();
    if (warp == 0 && hh + 1 < hb) {
      __syncwarp();
      head_sums(hv0 + (buf ^ 1) * 3 * qp, q, qp, lane);
    }
    __syncthreads();  // head hh + 1 visible to all; this head's buffers free
    if (hh + 2 < hb) load_head(hh + 2);
    cp_async_commit();
  }
}

template <typename T, int P, int N>
cudaError_t launch(const void* x, const void* dA, const void* dt, const void* B, const void* C,
                   void* y, void* st, int bnc, int q, int H, int hb, cudaStream_t stream) {
  const int slots = head_slots(q, P, N, sizeof(T), hb);
  const size_t bytes = smem_bytes(q, P, N, sizeof(T), slots);
  auto kern = ssd_chunk_kernel<T, P, N>;
  static bool opted_in = false;  // shared memory above 48 KB, once per instantiation
  if (!opted_in) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  if (bytes > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  const dim3 grid(bnc, H / hb);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dA), static_cast<const float*>(dt),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<float*>(y),
      static_cast<float*>(st), q, H, hb, slots);
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t launch_n(int N, const void* x, const void* dA, const void* dt, const void* B,
                     const void* C, void* y, void* st, int bnc, int q, int H, int hb,
                     cudaStream_t s) {
  switch (N) {
    case 16: return launch<T, P, 16>(x, dA, dt, B, C, y, st, bnc, q, H, hb, s);
    case 32: return launch<T, P, 32>(x, dA, dt, B, C, y, st, bnc, q, H, hb, s);
    case 64: return launch<T, P, 64>(x, dA, dt, B, C, y, st, bnc, q, H, hb, s);
    case 128: return launch<T, P, 128>(x, dA, dt, B, C, y, st, bnc, q, H, hb, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_pn(int P, int N, const void* x, const void* dA, const void* dt, const void* B,
                      const void* C, void* y, void* st, int bnc, int q, int H, int hb,
                      cudaStream_t s) {
  switch (P) {
    case 16: return launch_n<T, 16>(N, x, dA, dt, B, C, y, st, bnc, q, H, hb, s);
    case 32: return launch_n<T, 32>(N, x, dA, dt, B, C, y, st, bnc, q, H, hb, s);
    case 64: return launch_n<T, 64>(N, x, dA, dt, B, C, y, st, bnc, q, H, hb, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B and C); dA, dt, y and states are
// float32.  x (bnc, q, H, P), dA/dt (bnc, q, H), B/C (bnc, q, N) ->
// y (bnc, q, H, P), states (bnc, H, P, N), all contiguous.  hb heads per
// block must divide H.  Returns cudaGetLastError() after the launch.
extern "C" int ssd_chunk_fwd(int dtype, const void* x, const void* dA, const void* dt,
                             const void* B, const void* C, void* y, void* states, int bnc, int q,
                             int H, int P, int N, int hb, void* stream) {
  if (bnc <= 0 || q <= 0 || q > kMaxQ || H <= 0 || hb <= 0 || H % hb) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_pn<float>(P, N, x, dA, dt, B, C, y, states, bnc, q, H, hb, s);
  if (dtype == 1)
    return launch_pn<__nv_bfloat16>(P, N, x, dA, dt, B, C, y, states, bnc, q, H, hb, s);
  return cudaErrorInvalidValue;
}
