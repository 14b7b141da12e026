// What the paged attention kernel's sources share: csrc/paged_attention.cu
// (the C entry, the CUDA-core and split-KV decode paths),
// csrc/paged_tensor_core.cu (the tensor-core path, bf16 and f32) and
// csrc/paged_mla.cu (its MLA fold, bf16 and f32), compiled apart so the
// build runs them in parallel.
#pragma once

#include <cuda_runtime.h>

namespace paged {

constexpr float kNegInf = -1e30f;  // the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;

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

// The tensor-core path (csrc/paged_tensor_core.cu): dtype 1 (bf16) or 0
// (f32, 3xTF32) with dk and dv in {64, 128} or both 192, or MLA's dk 576 /
// dv 512 (launch_mla), 16-byte-aligned rows, in the row groups and key splits of
// the host's plan; with more than one split the workspace and the zeroed
// counters (one a (row, kv head, group)).
cudaError_t launch_tc(const Args& a, int dtype, int groups, int splits, void* ws, void* counters,
                      cudaStream_t s);

// The tensor-core path at MLA's fold (csrc/paged_mla.cu): dtype 1 (bf16) or
// 0 (f32, 3xTF32), dk 576, the values the first 512 columns of the same
// pages (k_pages == v_pages).  One key split or a thread-block cluster of
// them; no workspace.
cudaError_t launch_mla(const Args& a, int dtype, int groups, int splits, cudaStream_t s);

}  // namespace paged
