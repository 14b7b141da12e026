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
// Design.  Two kernels share the contract.  Each block owns a (bh, tile of
// query rows) pair and walks the key tiles itself: the TPU carries
// (m, l, acc) in VMEM across the sequential KV axis of its grid; here that
// state lives in registers.  The loop starts at the first tile the window
// lets the tile's first row see and stops after the tile holding the last
// row's diagonal when causal: the TPU's pl.when skip of wholly masked
// tiles, done as loop bounds.  A masked key gets p = 0, so a row whose
// first tiles are wholly masked carries no weight from them (the TPU body
// gives such a row exp(0) and relies on a later tile's correction; the two
// agree for every row that sees its own position).  Query tiles run
// heaviest-first (grid.y counts them from the end), so causal blocks with
// long key ranges start before short ones.
//
// - bf16 (flash_wgmma_kernel): warp-specialised on Hopper's asynchronous
//   tensor cores.  A block owns 64 * NWG query rows: NWG consumer
//   warpgroups of 64 rows each (wgmma's M; NWG = 3 for HD 64 from 1024
//   queries on, 2 otherwise) and one producer warpgroup, registers moved
//   to the consumers with setmaxnreg.  One producer thread loads Q and
//   then K and V tiles (128 keys at HD 64, 64 at HD 128/192) with TMA
//   (cp.async.bulk.tensor over 3-D maps (HD, S, BH), 128-byte swizzle,
//   64-column slabs; rows past S come back as zeros and never read the
//   next head) into two Q slots and a 2-stage K/V ring, each with full and
//   empty mbarriers; K and V have their own, so Q.K^T of tile j starts
//   while V_j is still landing, and a consumer warp releases a slot once
//   its wgmma reads are done.  The blocks are persistent, one per SM: work
//   items (bh, query tile) run heaviest first, dealt to the blocks in
//   alternating order each round, and the ring runs on across items, so
//   the next item's Q and tiles load while this one finishes.
//   S = Q.K^T is wgmma.m64nBNk16 with both operands in swizzled shared
//   memory (the descriptor's start advances 32 bytes per k16 step inside a
//   slab and one slab per 4 steps).  O += P.V takes P from registers (the
//   S accumulator fragments packed to bf16 are wgmma's A operand) and V
//   from shared memory read MN-major through the transpose bit, one
//   m64n64k16 per 64-column slab.  Each warpgroup software-pipelines its
//   tiles: S of tile j and P.V of tile j - 1 are issued together, and the
//   softmax of tile j waits only for S, so it overlaps P.V.  The online
//   softmax runs on the accumulator fragments: a row spans the 4 lanes of
//   a quad (2 shuffles a row per tile), four partial maxima and sums a row
//   keep the dependency chains short, scale * log2(e) is folded into one
//   FMA before ex2 (the special-function unit's: at 16 a clock per SM it
//   takes as long as the products at HD 64), and only a tile that can hold
//   a masked key runs the mask, as a loop of its own (a mask test inside
//   the exp loop tripled the softmax's cost on the card).  All groups of a
//   block walk all of the item's tiles; a tile wholly masked for one
//   group's rows gives it p = 0.  The logits are exact fp32 sums of exact
//   bf16 products; rounding P to bf16 for the product is what the bf16
//   tolerance (2e-2) covers.  ptxas -v (sm_90a, nvcc 12.9): no spills and
//   no serialised wgmma at HD 64, 128 or 192; a block is allocated 168
//   registers a thread at NWG 2 (384 threads) and 128 at NWG 3 (512), and
//   setmaxnreg then gives the consumers 240 / 160 and the producer 24.
// - float32 (flash_f32_kernel): 3xTF32 on mma.sync.m16n8k8.  Each operand
//   x is split into hi (x rounded to TF32, as cvt.rna.tf32 rounds) and lo
//   (x - hi, rounded the same way), and every product is formed as
//   lo.hi + hi.lo + hi.hi in the fp32 accumulator (lo.lo, about 2^-22 of
//   the product, is dropped): fp32 accuracy from the TF32 tensor cores,
//   three passes at 494.7 TFLOP/s against 67 on the CUDA cores (mma.sync
//   itself reaches ~316 TFLOP/s of TF32 on an H100: tools/kernel_variants.py).
//   A block of
//   4 warps; K and V tiles of 32 keys come in through a 2-stage cp.async
//   ring, rows padded to HD + 4 floats so the fragment loads hit distinct
//   banks, and each warp splits its K and V fragments as it loads them
//   (ldmatrix moves 32-bit words as pairs of b16: one x4 gives the B
//   fragments of two k-steps).  At HD 64 a warp owns two 16-row M-tiles,
//   so each K/V fragment and its split serve 32 rows, and Q is split once
//   into hi and lo halves in shared memory (128 rows a block); at 128 and
//   192 a warp owns one M-tile (two would not fit the O fragments in the
//   registers) and splits Q as it reads it each tile (64 rows a block).
//   The online softmax runs on the S fragments as in the bf16 kernel (quad
//   shuffles, scale * log2(e) folded into one FMA before ex2, the mask only
//   on tiles that can hold a hidden key); a warp skips a tile wholly masked
//   for its rows.  P.V takes P from the S fragments without shuffles: a
//   lane holds keys 2t and 2t + 1 of each 8-key step where the A fragment
//   wants k = t and t + 4, so the step's keys are taken in the order
//   k = q <-> key 2q, k = q + 4 <-> key 2q + 1, and V's B fragment is read
//   in the same order.  tools/kernel_variants.py times each choice undone
//   against this kernel (NVIDIA H100 80GB HBM3, 700 W; BH 24 x 4096 / 96 x
//   512, hd 64, ms): this kernel 0.86 / 0.089; one M-tile a warp 1.00 /
//   0.093; two cvt.rna.tf32 a split 0.96 / 0.106; 64-key tiles 1.00 /
//   0.102; all three 1.31 / 0.110.
//   ptxas -v (sm_90a, nvcc 12.9): 181, 134 and 184 registers at HD 64, 128
//   and 192, no spills.
//
// Bound on this card: the work must read q, k and v once and write out
// once, and for causal attention do about 2 * BH * S^2 * HD multiply-adds'
// worth of flops (QK and PV over the lower triangle).  At S = 512 and
// HD = 64 in bf16 that is ~64 flops a byte, below the ~295 at which the
// tensor cores bound it, so bytes bound short sequences and the
// tensor-core rate bounds long ones; in f32 on this route the bound is
// three TF32 passes, 3 * flops at 494.7 TFLOP/s (67 TFLOP/s on the CUDA
// cores).  The kernels' times on the card are recorded against that
// bound in PERF.md.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm80.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the reference's mask value

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int sq, skv;
  float scale;
  int causal, window;
  int bh;  // heads x batch (the wgmma kernel's persistent schedule)
};

// ------------------------------------------------------ bf16 wgmma/TMA path
using mma_sm80::pack_bf16;
using mma_sm80::smem_addr;

constexpr float kLog2e = 1.4426950408889634f;

template <int HD, int NWG_>
struct WgCfg {
  // NWG consumer warpgroups of 64 query rows (wgmma's M) and their
  // registers after setmaxnreg (the producer warpgroup keeps 24): three
  // groups fit HD 64's S, P and O fragments in 160, two take 240
  static constexpr int NWG = NWG_;
  static constexpr int REGS = NWG == 3 ? 160 : 240;
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int ST = 2;  // K/V ring depth (3 measured no faster)
  static constexpr int BM = 64 * NWG;             // query rows per block
  static constexpr int BN = HD == 64 ? 128 : 64;  // keys per tile
  static constexpr int SLABS = HD / 64;        // 128-byte swizzle slabs along HD
  static constexpr uint32_t Q_BYTES = SLABS * BM * 128;
  static constexpr uint32_t T_BYTES = SLABS * BN * 128;  // one K or V tile
  // two Q slots (the next item's Q loads during this one), ST K and V slots
  static constexpr size_t SMEM = 1024 + 2 * Q_BYTES + 2 * ST * T_BYTES + 8 * (4 + 4 * ST);
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the barrier's phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a 3-D map into shared memory; completion counts bytes on bar.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled operand whose
// 8-row groups (1024-byte swizzle atoms) follow each other: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (SW128).
// K-major operands use only the stride offset; the MN-major V tile (one
// 64-column atom wide) steps along K by the same 1024 bytes, which is set
// in both fields.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of the warpgroup's committed wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// exp2 on the special-function unit, subnormal results flushed to zero
// (a p below 2^-126 weighs nothing beside the row's largest, which is 1).
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across its issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (64 x 64 fp32; 32 a thread) (+)= A (64 x 16) * B^T (B 64 x 16), both
// K-major in shared memory; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t desc_a,
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 128 fp32; 64 a thread) (+)= A (64 x 16) * B^T (B 128 x 16), both
// K-major in shared memory; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t desc_a,
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64 fp32; 32 a thread) += A (64 x 16 bf16 in registers: a warp's
// 16 rows as an mma.sync A fragment) * B (16 x 64, shared memory, MN-major:
// the transpose bit is set).
__device__ __forceinline__ void wgmma_rs_m64n64_tb(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_s(float (&s)[BN / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (BN == 128)
    wgmma_ss_m64n128(s, da, db, acc);
  else
    wgmma_ss_m64n64(s, da, db, acc);
}

template <int HD, int NWG>
__global__ void __launch_bounds__(WgCfg<HD, NWG>::THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const Args a) {
  using C = WgCfg<HD, NWG>;
  constexpr int BM = C::BM, BN = C::BN, SLABS = C::SLABS, ST = C::ST;
  constexpr int kConsumerWarps = 4 * C::NWG;
  extern __shared__ uint8_t smem_raw[];
  // swizzle atoms must sit on 1024-byte boundaries
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s0 = base;                        // Q slot n at q_s0 + n * Q_BYTES
  const uint32_t k_s0 = q_s0 + 2 * C::Q_BYTES;        // K slot st at k_s0 + st * T_BYTES
  const uint32_t v_s0 = k_s0 + ST * C::T_BYTES;       // V slot st at v_s0 + st * T_BYTES
  const uint32_t bars = v_s0 + ST * C::T_BYTES;       // 8-byte mbarriers
  auto q_full = [&](int n) { return bars + 8u * n; };  // Q of slot n landed
  auto q_empty = [&](int n) { return bars + 8u * (2 + n); };  // Q of slot n released
  auto k_full = [&](int st) { return bars + 8u * (4 + st); };  // K tile landed
  auto v_full = [&](int st) { return bars + 8u * (4 + ST + st); };
  auto k_empty = [&](int st) { return bars + 8u * (4 + 2 * ST + st); };  // K tile released
  auto v_empty = [&](int st) { return bars + 8u * (4 + 3 * ST + st); };

  // Persistent: item i is query tile n_q_tiles - 1 - i / BH of head i % BH
  // (heaviest first); in round n the grid's blocks take items n * grid ...
  // n * grid + grid - 1, in block order on even rounds and reversed on odd
  // ones, which evens out the causal items' sums (round-robin left the
  // busiest block 15% over the mean at BH 24 x 4096).  The ring's slots and
  // phases run on across items, so the producer loads the next item's Q and
  // tiles while the consumers finish this one.
  const int n_q_tiles = (a.sq + BM - 1) / BM;
  const int n_items = n_q_tiles * a.bh;
  auto item_of = [&](int n) {
    return n * (int)gridDim.x + ((n & 1) ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x);
  };
  int bh = 0, q0 = 0, k_begin = 0, n_tiles = 0;
  auto take = [&](int item) {  // this item's head, rows and key tiles
    bh = item % a.bh;
    q0 = (n_q_tiles - 1 - item / a.bh) * BM;
    int k_end = a.skv;
    if (a.causal) k_end = min(a.skv, q0 + BM);
    k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
    k_begin -= k_begin % BN;
    n_tiles = k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0;
  };

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int n = 0; n < 2; ++n) {
      mbar_init(q_full(n), 1);
      mbar_init(q_empty(n), kConsumerWarps);  // one arrival per consumer warp
    }
    for (int st = 0; st < ST; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), kConsumerWarps);
      mbar_init(v_empty(st), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // ---------------------------------------------------------- producer
    // (one thread of the last warpgroup issues every copy)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == kConsumerWarps && lane == 0) {
      int r = 0;  // ring slots filled so far
      for (int n = 0; item_of(n) < n_items; ++n) {
        take(item_of(n));
        const int qn = n & 1;
        mbar_wait(q_empty(qn), ((n >> 1) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(q_full(qn), C::Q_BYTES);
        for (int sl = 0; sl < SLABS; ++sl)
          tma_load_3d(q_s0 + qn * C::Q_BYTES + sl * BM * 128, &tq, sl * 64, q0, bh, q_full(qn));
        for (int it = 0; it < n_tiles; ++it, ++r) {
          const int st = r % ST;
          const uint32_t ph = (r / ST) & 1;
          const int k0 = k_begin + it * BN;
          mbar_wait(k_empty(st), ph ^ 1);
          mbar_expect_tx(k_full(st), C::T_BYTES);
          for (int sl = 0; sl < SLABS; ++sl)
            tma_load_3d(k_s0 + st * C::T_BYTES + sl * BN * 128, &tk, sl * 64, k0, bh, k_full(st));
          mbar_wait(v_empty(st), ph ^ 1);
          mbar_expect_tx(v_full(st), C::T_BYTES);
          for (int sl = 0; sl < SLABS; ++sl)
            tma_load_3d(v_s0 + st * C::T_BYTES + sl * BN * 128, &tv, sl * 64, k0, bh, v_full(st));
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::REGS) : "memory");
    // ------------------------------------------------------------ consumers
    const int wg = warp >> 2;  // warpgroup: rows [q0 + 64 wg, q0 + 64 wg + 64) of an item
    const int g = lane >> 2, tq4 = lane & 3;
    const float c = a.scale * kLog2e;  // exp(x * scale) = exp2(x * c)
    int r0 = 0, row_a = 0, row_b = 0;  // the group's first row, this thread's two rows
    uint32_t q_s = q_s0;               // the item's Q slot
    float m_a, m_b, l_a, l_b;          // l: this lane's share of the row sum
    float o[SLABS][32];
    float s[BN / 2];         // S of a tile, then its probabilities
    uint32_t p[BN / 16][4];  // P as wgmma A fragments, one per 16 keys

    // S = Q.K^T of the tile in ring slot r, issued (the caller waited for K)
    auto issue_s = [&](int r) {
      const uint32_t kt = k_s0 + (r % ST) * C::T_BYTES;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;  // k16 step inside a slab
        const uint64_t da = sw128_desc(q_s + (kk >> 2) * BM * 128 + wg * 64 * 128 + off, 16);
        const uint64_t db = sw128_desc(kt + (kk >> 2) * BN * 128 + off, 16);
        wgmma_s<BN>(s, da, db, kk > 0);
      }
      wgmma_commit();
    };
    // O += P.V of the tile in ring slot r, issued (the caller waited for V)
    auto issue_pv = [&](int r) {
      const uint32_t vt = v_s0 + (r % ST) * C::T_BYTES;
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc)
#pragma unroll
        for (int sl = 0; sl < SLABS; ++sl)
          wgmma_rs_m64n64_tb(o[sl], p[kc], sw128_desc(vt + sl * BN * 128 + kc * 2048, 1024));
      wgmma_commit();
    };
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);  // the warp's wgmma reads are done
    };
    auto skip = [&](int r) {  // wait for a tile and release it unread
      const uint32_t ph = (r / ST) & 1;
      mbar_wait(k_full(r % ST), ph);
      if (lane == 0) mbar_arrive(k_empty(r % ST));
      mbar_wait(v_full(r % ST), ph);
      if (lane == 0) mbar_arrive(v_empty(r % ST));
    };
    auto fence_acc = [&]() {
#pragma unroll
      for (int sl = 0; sl < SLABS; ++sl) fence_regs(o[sl]);
      fence_regs(p);
    };
    // Online softmax of tile `it` on the S fragments: s becomes the
    // probabilities, m and l advance; corr is each row's rescale of O.
    auto softmax = [&](int it, float& corr_a, float& corr_b) {
      const int k0 = k_begin + it * BN;
      // mask only a tile that may hold a key hidden from one of the rows
      const bool full = k0 + BN <= a.skv && (!a.causal || k0 + BN - 1 <= r0) &&
                        (a.window <= 0 || k0 > r0 + 63 - a.window);
      if (!full) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + j * 8 + tq4 * 2 + e;
            const bool in = key < a.skv;
            if (!(in && (!a.causal || key <= row_a) && (a.window <= 0 || key > row_a - a.window)))
              s[4 * j + e] = -INFINITY;
            if (!(in && (!a.causal || key <= row_b) && (a.window <= 0 || key > row_b - a.window)))
              s[4 * j + 2 + e] = -INFINITY;
          }
      }
      // row max: four partial maxima a row keep the chains short; a row
      // spans the 4 lanes of a quad
      float xa[4] = {m_a, -INFINITY, -INFINITY, -INFINITY};
      float xb[4] = {m_b, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          xa[(2 * j + e) & 3] = fmaxf(xa[(2 * j + e) & 3], s[4 * j + e]);
          xb[(2 * j + e) & 3] = fmaxf(xb[(2 * j + e) & 3], s[4 * j + 2 + e]);
        }
      float mx_a = fmaxf(fmaxf(xa[0], xa[1]), fmaxf(xa[2], xa[3]));
      float mx_b = fmaxf(fmaxf(xb[0], xb[1]), fmaxf(xb[2], xb[3]));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
      // m starts at -1e30, so corr is 0 until a row sees a key and a
      // masked score (-inf) gives p = 0; the difference is taken before
      // scaling, or the rounding of -1e30 * c would give exp2 of +-1e23
      corr_a = ex2_ftz((m_a - mx_a) * c);
      corr_b = ex2_ftz((m_b - mx_b) * c);
      m_a = mx_a;
      m_b = mx_b;
      const float mc_a = mx_a * c, mc_b = mx_b * c;
      float ya[4] = {0.f, 0.f, 0.f, 0.f}, yb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[4 * j + e] = ex2_ftz(fmaf(s[4 * j + e], c, -mc_a));
          s[4 * j + 2 + e] = ex2_ftz(fmaf(s[4 * j + 2 + e], c, -mc_b));
          ya[(2 * j + e) & 3] += s[4 * j + e];
          yb[(2 * j + e) & 3] += s[4 * j + 2 + e];
        }
      l_a = fmaf(l_a, corr_a, (ya[0] + ya[1]) + (ya[2] + ya[3]));
      l_b = fmaf(l_b, corr_b, (yb[0] + yb[1]) + (yb[2] + yb[3]));
    };
    // rescale O; two 8-key accumulator tiles are the A fragment of one
    // 16-key step of P.V
    auto rescale_and_pack = [&](float corr_a, float corr_b) {
#pragma unroll
      for (int sl = 0; sl < SLABS; ++sl)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[sl][4 * j] *= corr_a;
          o[sl][4 * j + 1] *= corr_a;
          o[sl][4 * j + 2] *= corr_b;
          o[sl][4 * j + 3] *= corr_b;
        }
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) {
        p[kc][0] = pack_bf16(s[8 * kc], s[8 * kc + 1]);
        p[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
        p[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
        p[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
      }
    };
    int r_base = 0;  // ring slot of the item's tile 0
    for (int n = 0; item_of(n) < n_items; ++n) {
      take(item_of(n));
      r0 = q0 + wg * 64;
      row_a = r0 + (warp & 3) * 16 + g;
      row_b = row_a + 8;
      m_a = m_b = kNegInf;
      l_a = l_b = 0.f;
#pragma unroll
      for (int sl = 0; sl < SLABS; ++sl)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[sl][i] = 0.f;
      // The tiles some row of the item needs are one run [j0, j1]; every
      // group walks all of it (a tile wholly masked for one group's rows
      // gives it p = 0) and releases any other tile unread.  take() bounds
      // the tiles so that the run is all of them, but this form compiles to
      // a faster loop than one over [0, n_tiles): 2.5% at BH 24 x 4096 and
      // 7% at 96 x 512 on an H100, the two measured in turns in one process.
      auto need = [&](int it) {
        const int k0 = k_begin + it * BN;
        return (!a.causal || k0 <= q0 + BM - 1) && (a.window <= 0 || k0 + BN - 1 > q0 - a.window);
      };
      int j0 = 0, j1 = n_tiles - 1;
      while (j0 < n_tiles && !need(j0)) ++j0;
      while (j1 >= j0 && !need(j1)) --j1;
      for (int it = 0; it < j0; ++it) skip(r_base + it);
      q_s = q_s0 + (n & 1) * C::Q_BYTES;
      mbar_wait(q_full(n & 1), (n >> 1) & 1);
      if (j0 <= j1) {
        // Software pipeline: S of tile it and P.V of tile it - 1 run on the
        // tensor cores while the softmax of tile it waits only for S.
        float corr_a, corr_b;
        int r = r_base + j0;
        mbar_wait(k_full(r % ST), (r / ST) & 1);
        fence_acc();
        wgmma_fence();
        issue_s(r);
        wgmma_wait<0>();
        fence_regs(s);
        release(k_empty(r % ST));
        softmax(j0, corr_a, corr_b);
        rescale_and_pack(corr_a, corr_b);
        for (int it = j0 + 1; it <= j1; ++it) {
          r = r_base + it;
          mbar_wait(k_full(r % ST), (r / ST) & 1);
          mbar_wait(v_full((r - 1) % ST), ((r - 1) / ST) & 1);
          fence_acc();
          wgmma_fence();
          issue_s(r);
          issue_pv(r - 1);
          wgmma_wait<1>();  // S of tile it; P.V of tile it - 1 still runs
          fence_regs(s);
          release(k_empty(r % ST));
          softmax(it, corr_a, corr_b);
          wgmma_wait<0>();  // P.V of tile it - 1
          fence_acc();
          release(v_empty((r - 1) % ST));
          rescale_and_pack(corr_a, corr_b);
        }
        release(q_empty(n & 1));  // the item's last S has read Q
        mbar_wait(v_full(r % ST), (r / ST) & 1);
        fence_acc();
        wgmma_fence();
        issue_pv(r);
        wgmma_wait<0>();
        fence_acc();
        release(v_empty(r % ST));
      } else {
        release(q_empty(n & 1));
      }
      for (int it = max(j0, j1 + 1); it < n_tiles; ++it) skip(r_base + it);
      r_base += n_tiles;

      l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
      l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
      // a row with nothing attendable keeps l == 0 and writes zeros
      const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
      __nv_bfloat16* __restrict__ og =
          static_cast<__nv_bfloat16*>(a.out) + (size_t)bh * a.sq * HD;
#pragma unroll
      for (int sl = 0; sl < SLABS; ++sl)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = sl * 64 + j * 8 + tq4 * 2;
          if (row_a < a.sq)
            *reinterpret_cast<uint32_t*>(og + (size_t)row_a * HD + col) =
                pack_bf16(o[sl][4 * j] * inv_a, o[sl][4 * j + 1] * inv_a);
          if (row_b < a.sq)
            *reinterpret_cast<uint32_t*>(og + (size_t)row_b * HD + col) =
                pack_bf16(o[sl][4 * j + 2] * inv_b, o[sl][4 * j + 3] * inv_b);
        }
    }
  }
}

// ------------------------------------------------ float32: 3xTF32 mma.sync
using mma_sm80::cp_async16;
using mma_sm80::cp_async_commit;
using mma_sm80::cp_async_wait;
using mma_sm80::ldmatrix_x4;
using mma_sm80::mma_3xtf32;
using mma_sm80::split_tf32;

constexpr int kF32Threads = 128;  // 4 warps

template <int HD>
struct F32Cfg {
  static constexpr int BN = 32;      // keys per tile
  static constexpr int LD = HD + 4;  // padded rows (floats): fragment loads hit distinct banks
  // M-tiles of 16 query rows a warp: at HD 64 two, so each K and V
  // fragment (and its split) serves 32 rows, with Q split once into hi and
  // lo halves in shared memory; at 128 and 192 one (the O fragments of two
  // would not fit the registers), with Q split as it is read, each tile
  static constexpr int MT = HD == 64 ? 2 : 1;
  static constexpr bool QSPLIT = MT == 2;
  static constexpr int BM = 4 * 16 * MT;  // query rows a block
  // Q (hi and lo, or as loaded), then a 2-stage ring of K and V tiles
  static constexpr size_t SMEM =
      sizeof(float) * ((QSPLIT ? 2 : 1) * (size_t)BM * LD + 2 * 2 * BN * LD);
};

// Rows [row0, row0 + rows) of a (n_rows, HD) f32 matrix into shared memory
// at dst[r * LD] with 16-byte cp.async, zero-filled past n_rows.
template <int HD, int LD>
__device__ __forceinline__ void cp_rows(const float* __restrict__ src, int row0, int n_rows,
                                        float* dst, int rows) {
  constexpr int kChunks = HD / 4;
  for (int i = threadIdx.x; i < rows * kChunks; i += kF32Threads) {
    const int r = i / kChunks, c = (i - r * kChunks) * 4;
    const bool in = row0 + r < n_rows;
    cp_async16(dst + r * LD + c, src + (in ? (size_t)(row0 + r) * HD + c : 0), in);
  }
}

template <int HD>
__global__ void __launch_bounds__(kF32Threads) flash_f32_kernel(const Args a) {
  using C = F32Cfg<HD>;
  constexpr int BN = C::BN, LD = C::LD, KSTEPS = HD / 8, MT = C::MT, BM = C::BM;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [BM][LD]: Q, then its hi halves
  float* qlo = qs + BM * LD;                     // [BM][LD]: Q's lo halves (QSPLIT)
  float* ring = qs + (C::QSPLIT ? 2 : 1) * BM * LD;  // stage st: K at 2 st BN LD, then V

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest query tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;    // fragment row and column group
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: this lane's matrix and row
  const float* __restrict__ qg = static_cast<const float*>(a.q) + (size_t)bh * a.sq * HD;
  const float* __restrict__ kg = static_cast<const float*>(a.k) + (size_t)bh * a.skv * HD;
  const float* __restrict__ vg = static_cast<const float*>(a.v) + (size_t)bh * a.skv * HD;

  // the keys any row of this tile may see
  int k_end = a.skv;
  if (a.causal) k_end = min(a.skv, q0 + BM);
  int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  k_begin -= k_begin % BN;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0;
  auto load_tile = [&](int it) {
    float* ks = ring + (it & 1) * 2 * BN * LD;
    cp_rows<HD, LD>(kg, k_begin + it * BN, a.skv, ks, BN);
    cp_rows<HD, LD>(vg, k_begin + it * BN, a.skv, ks + BN * LD, BN);
  };
  cp_rows<HD, LD>(qg, q0, a.sq, qs, BM);
  cp_async_commit();
  if (n_tiles > 0) load_tile(0);
  cp_async_commit();
  if constexpr (C::QSPLIT) {
    // split Q once for all warps: hi in place, lo beside it (the loop's
    // first barrier orders these writes before any read)
    cp_async_wait<1>();
    __syncthreads();
    for (int i = threadIdx.x; i < BM * HD / 4; i += kF32Threads) {
      const int r = i / (HD / 4), col = (i - r * (HD / 4)) * 4;
      float4* p = reinterpret_cast<float4*>(qs + r * LD + col);
      const float4 x = *p;
      uint32_t h[4], l[4];
      split_tf32(x.x, h[0], l[0]);
      split_tf32(x.y, h[1], l[1]);
      split_tf32(x.z, h[2], l[2]);
      split_tf32(x.w, h[3], l[3]);
      *reinterpret_cast<uint4*>(p) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(qlo + r * LD + col) = make_uint4(l[0], l[1], l[2], l[3]);
    }
  }

  const int r0 = q0 + warp * 16 * MT;  // this warp's first row
  const float c = a.scale * kLog2e;    // exp(x * scale) = exp2(x * c)
  float m_a[MT], m_b[MT], l_a[MT], l_b[MT];  // l: this lane's share
  float o[MT][HD / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m_a[mt] = m_b[mt] = kNegInf;
    l_a[mt] = l_b[mt] = 0.f;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      o[mt][dt][0] = o[mt][dt][1] = o[mt][dt][2] = o[mt][dt][3] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    // the next tile's copy is in flight while this one is computed
    if (it + 1 < n_tiles) load_tile(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* ks = ring + (it & 1) * 2 * BN * LD;
    const float* vs = ks + BN * LD;
    const int k0 = k_begin + it * BN;
    // a tile wholly masked for this warp's rows is skipped
    const bool need = r0 < a.sq && (!a.causal || k0 <= r0 + 16 * MT - 1) &&
                      (a.window <= 0 || k0 + BN - 1 > r0 - a.window);
    if (need) {
      // S = Q.K^T: K's B fragments of two k-steps come from one ldmatrix
      // (it moves 32-bit words as pairs of b16)
      float s[MT][BN / 8][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt)
          s[mt][nt][0] = s[mt][nt][1] = s[mt][nt][2] = s[mt][nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; kk += 2) {
        // Q's A fragments of k-steps kk and kk + 1, hi and lo
        uint32_t ah[MT][2][4], al[MT][2][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int off = (warp * 16 * MT + mt * 16 + (mi & 1) * 8 + mr) * LD + (kk + u) * 8 +
                            (mi >> 1) * 4;
            if constexpr (C::QSPLIT) {
              ldmatrix_x4(ah[mt][u], qs + off);
              ldmatrix_x4(al[mt][u], qlo + off);
            } else {
              uint32_t raw[4];
              ldmatrix_x4(raw, qs + off);
#pragma unroll
              for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(raw[i]), ah[mt][u][i], al[mt][u][i]);
            }
          }
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt) {
          uint32_t raw[4], bh[4], bl[4];
          ldmatrix_x4(raw, ks + (nt * 8 + mr) * LD + kk * 8 + mi * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(raw[i]), bh[i], bl[i]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_3xtf32(s[mt][nt], ah[mt][0], al[mt][0], bh[0], bh[1], bl[0], bl[1]);
            mma_3xtf32(s[mt][nt], ah[mt][1], al[mt][1], bh[2], bh[3], bl[2], bl[3]);
          }
        }
      }
      // online softmax on the fragments, a row spanning the 4 lanes of a quad
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int rm = r0 + mt * 16, row_a = rm + g, row_b = row_a + 8;
        // mask only a tile that may hold a key hidden from one of the rows
        const bool full = k0 + BN <= a.skv && (!a.causal || k0 + BN - 1 <= rm) &&
                          (a.window <= 0 || k0 > rm + 15 - a.window);
        if (!full) {
#pragma unroll
          for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = k0 + nt * 8 + 2 * t + e;
              const bool in = key < a.skv;
              if (!(in && (!a.causal || key <= row_a) &&
                    (a.window <= 0 || key > row_a - a.window)))
                s[mt][nt][e] = -INFINITY;
              if (!(in && (!a.causal || key <= row_b) &&
                    (a.window <= 0 || key > row_b - a.window)))
                s[mt][nt][2 + e] = -INFINITY;
            }
        }
        float xa[2] = {m_a[mt], -INFINITY}, xb[2] = {m_b[mt], -INFINITY};
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            xa[e] = fmaxf(xa[e], s[mt][nt][e]);
            xb[e] = fmaxf(xb[e], s[mt][nt][2 + e]);
          }
        float mx_a = fmaxf(xa[0], xa[1]), mx_b = fmaxf(xb[0], xb[1]);
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
        // m starts at -1e30: corr is 0 once a row first sees a key, and a
        // masked score (-inf) gives p = 0; the difference is taken before
        // scaling (see the bf16 kernel)
        const float corr_a = ex2_ftz((m_a[mt] - mx_a) * c);
        const float corr_b = ex2_ftz((m_b[mt] - mx_b) * c);
        m_a[mt] = mx_a;
        m_b[mt] = mx_b;
        const float mc_a = mx_a * c, mc_b = mx_b * c;
        float ya[2] = {0.f, 0.f}, yb[2] = {0.f, 0.f};
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s[mt][nt][e] = ex2_ftz(fmaf(s[mt][nt][e], c, -mc_a));
            s[mt][nt][2 + e] = ex2_ftz(fmaf(s[mt][nt][2 + e], c, -mc_b));
            ya[e] += s[mt][nt][e];
            yb[e] += s[mt][nt][2 + e];
          }
        l_a[mt] = fmaf(l_a[mt], corr_a, ya[0] + ya[1]);
        l_b[mt] = fmaf(l_b[mt], corr_b, yb[0] + yb[1]);
#pragma unroll
        for (int dt = 0; dt < HD / 8; ++dt) {
          o[mt][dt][0] *= corr_a;
          o[mt][dt][1] *= corr_a;
          o[mt][dt][2] *= corr_b;
          o[mt][dt][3] *= corr_b;
        }
      }
      // O += P.V.  This lane's probabilities sit at keys 2t and 2t + 1 of
      // each 8-key step, where P's A fragment wants k = t and t + 4: the
      // step's keys are taken in the order k = q <-> key 2q, k = q + 4 <->
      // key 2q + 1, and V's B fragment is read in the same order.
#pragma unroll
      for (int kc = 0; kc < BN / 8; ++kc) {
        uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          split_tf32(s[mt][kc][0], ph[mt][0], pl[mt][0]);
          split_tf32(s[mt][kc][2], ph[mt][1], pl[mt][1]);
          split_tf32(s[mt][kc][1], ph[mt][2], pl[mt][2]);
          split_tf32(s[mt][kc][3], ph[mt][3], pl[mt][3]);
        }
        const float* v0 = vs + (kc * 8 + 2 * t) * LD + g;
#pragma unroll
        for (int dt = 0; dt < HD / 8; ++dt) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(v0[dt * 8], bh0, bl0);
          split_tf32(v0[LD + dt * 8], bh1, bl1);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_3xtf32(o[mt][dt], ph[mt], pl[mt], bh0, bh1, bl0, bl1);
        }
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's copy
  }
  cp_async_wait<0>();

  float* __restrict__ og = static_cast<float*>(a.out) + (size_t)bh * a.sq * HD;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float la = l_a[mt], lb = l_b[mt];
    la += __shfl_xor_sync(0xffffffffu, la, 1);
    lb += __shfl_xor_sync(0xffffffffu, lb, 1);
    la += __shfl_xor_sync(0xffffffffu, la, 2);
    lb += __shfl_xor_sync(0xffffffffu, lb, 2);
    // a row with nothing attendable keeps l == 0 and writes zeros
    const float inv_a = 1.f / fmaxf(la, 1e-30f), inv_b = 1.f / fmaxf(lb, 1e-30f);
    const int row_a = r0 + mt * 16 + g, row_b = row_a + 8;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      const int col = dt * 8 + 2 * t;
      if (row_a < a.sq)
        *reinterpret_cast<float2*>(og + (size_t)row_a * HD + col) =
            make_float2(o[mt][dt][0] * inv_a, o[mt][dt][1] * inv_a);
      if (row_b < a.sq)
        *reinterpret_cast<float2*>(og + (size_t)row_b * HD + col) =
            make_float2(o[mt][dt][2] * inv_b, o[mt][dt][3] * inv_b);
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (the library
// links no libcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A (HD, S, BH) bf16 map read in boxes of 64 columns x `rows` rows of one
// head, 128-byte swizzled; rows past S read as zeros.
bool make_map(EncodeTiledFn encode, CUtensorMap* map, const void* ptr, int hd, int s, int bh,
              int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2, (cuuint64_t)s * hd * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int NWG>
cudaError_t run_wgmma(const Args& a, int bh, cudaStream_t stream) {
  using C = WgCfg<HD, NWG>;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  if (!make_map(encode, &tq, a.q, HD, a.sq, bh, C::BM) ||
      !make_map(encode, &tk, a.k, HD, a.skv, bh, C::BN) ||
      !make_map(encode, &tv, a.v, HD, a.skv, bh, C::BN))
    return cudaErrorInvalidValue;
  auto kernel = flash_wgmma_kernel<HD, NWG>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (e != cudaSuccess) return e;
  // one persistent block per SM (at most one per work item)
  int dev = 0, sms = 0;
  cudaError_t e2 = cudaGetDevice(&dev);
  if (e2 == cudaSuccess) e2 = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e2 != cudaSuccess) return e2;
  const long n_items = (long)((a.sq + C::BM - 1) / C::BM) * bh;
  if (n_items > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<(int)(n_items < sms ? n_items : sms), C::THREADS, C::SMEM, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t run_f32(const Args& a, int bh, cudaStream_t stream) {
  using C = F32Cfg<HD>;
  auto kernel = flash_f32_kernel<HD>;
  if (C::SMEM > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (e != cudaSuccess) return e;
  }
  const int n_q_tiles = (a.sq + C::BM - 1) / C::BM;
  if (n_q_tiles > 65535) return cudaErrorInvalidValue;
  kernel<<<dim3(bh, n_q_tiles), kF32Threads, C::SMEM, stream>>>(a);
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
  const Args a{q, k, v, out, sq, skv, scale, causal, window, bh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (hd == 64) return run_f32<64>(a, bh, s);
    if (hd == 128) return run_f32<128>(a, bh, s);
    if (hd == 192) return run_f32<192>(a, bh, s);
  } else if (dtype == 1) {
    // HD 64 takes three consumer groups (192 rows a block, so K and V are
    // read from L2 a third fewer times) from 1024 queries on; below that a
    // causal block has few key tiles and 128-row blocks balance better
    // (BH 24 x 4096: 0.149 ms with three, 0.153 with two; BH 96 x 512:
    // 0.035 with three, 0.029 with two; NVIDIA H100 80GB HBM3, 700 W)
    if (hd == 64) return sq >= 1024 ? run_wgmma<64, 3>(a, bh, s) : run_wgmma<64, 2>(a, bh, s);
    if (hd == 128) return run_wgmma<128, 2>(a, bh, s);
    if (hd == 192) return run_wgmma<192, 2>(a, bh, s);
  }
  return cudaErrorInvalidValue;
}
