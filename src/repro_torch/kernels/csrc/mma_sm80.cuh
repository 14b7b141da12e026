// Warp-level tensor-core and copy helpers (sm_80 instructions, used on
// sm_90a): ldmatrix fragments, mma.sync.m16n8k16 in bf16 and m16n8k8 in
// TF32 with fp32 accumulation, the 3xTF32 split, 16-byte cp.async with zero
// fill, bf16 packing.  Shared by the kernels that build their tiles per
// warp (csrc/paged_attention.cu's tensor-core path, csrc/flash_attention.cu's
// f32 kernel, csrc/ssd.cu).
//
// Fragment layout of mma.sync.m16n8k16 (and of each 16-row slice of a
// wgmma accumulator): lane = 4 g + t holds rows g and g + 8, columns 2 t
// and 2 t + 1 of every 8-column tile.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_sm80 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane 8 i + r gives the address of row r of matrix i.
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

// 16 bytes global -> shared, zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x = hi + lo to about 2^-22 of x: hi is x rounded to TF32 (to nearest,
// ties away from zero, as cvt.rna.tf32.f32 rounds), lo the rest (exact in
// fp32) with half of TF32's last bit added: the tensor cores read the top
// 19 bits of an operand, so lo is rounded the same way where it is used.
// In integer arithmetic: two cvt.rna.tf32 per value measured 10% slower at
// BH 24 x 4096 on an H100 (tools/kernel_variants.py).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// c (16x8 fp32) += a (16x8 tf32, row-major) * b (8x8 tf32, col-major).  A:
// lane 4 g + t holds (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B: (k
// t, n g), (k t + 4, n g); C as above.
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a.b in 3xTF32: the cross terms hi.lo and lo.hi, then hi.hi (lo.lo,
// about 2^-22 of the product, is dropped).
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

}  // namespace mma_sm80
