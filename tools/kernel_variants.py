"""Design measurements behind the f32 flash kernel, the paged decode path,
the paged tensor-core path (bf16 and f32) and its MLA fold, the SSD chunk
kernel and RMSNorm, on one CUDA card.

    python3 tools/kernel_variants.py [flash] [decode] [tc] [tc_f32] [mla] [ssd] [rmsnorm]
        [mma] [ssd_logits]

(no argument: every group).  Each variant is the committed source (its
``mma_sm80.cuh`` inlined) with one design choice undone by a text
substitution, built with the port's own nvcc flags into
``build/variants/`` and called through the same C entry as the committed
kernel, so the two are timed in turns in one process (committed, variant,
variant, committed) with ``chip_smoke.time_ms`` (cold L2, median of 30):

- f32 flash at BH 24 x 4096 and 96 x 512, hd 64, causal: one M-tile a
  warp instead of two; two ``cvt.rna.tf32`` per split instead of integer
  rounding; 64-key tiles instead of 32; all three at once;
- the paged decode path at the serving decode shape (B 16, Hkv 12, dk 64,
  page 16, 128-576 keys) and at 2048-4096 keys: plans of other split
  counts and round sizes (module constants of ``flash_decode``), and
  copies that stream the pages and compute nothing, or stop before the
  splits' merge;
- the paged tensor-core path (``tc``): the routing boundary against the
  decode and CUDA-core paths (each forced through
  ``flash_decode.kernel_path``) at bf16 folds of 5-15 rows (B 16, G 1,
  Hkv 12, dk 64; G 8 and 12 at Hkv 8, dk 128); the plan's constants
  (``TENSOR_CORE_BLOCKS_PER_SM``, ``TENSOR_CORE_MIN_UNITS``,
  ``TENSOR_CORE_MAX_SPLITS``) and plans forced through
  ``flash_decode.tensor_core_plan`` at the dense zoo's decode and prefill
  shapes, ds-paper-100m's serve prefill and verify T 9, and over one MQA
  row of 4096 keys; and the kernel rebuilt with a 112 KiB ring budget
  instead of 200, the copy as a loop at every width or unrolled at 192
  too, and 8 warps a block as the target instead of 4;
- the paged tensor-core path's f32 route (``tc_f32``, 3xTF32): the
  routing boundary against the decode and CUDA-core paths at f32 folds of
  8-40 rows (ds-paper-100m's verify T 9 at B 16 and at spec_parity's B 4,
  12 and 16 rows, parity's chunk-extend, G 8 x T 5 and qwen2-72b's G 8
  decode at dk 128); the f32 group cap (``TENSOR_CORE_F32_MAX_TILES`` 4,
  6 and 8) at the zoo's f32 prefill shapes and forced key splits at its
  decode shapes; the kernel rebuilt with two ring stages, S's three
  products on one accumulator chain, and Q staged pre-split; then each
  f32 shape's record (``paged_f32_shapes``: nemotron-4-340b's dk 192
  decode and prefill, granite-34b's G 48 decode and 768-row prefill,
  qwen2-72b's prefill, verify T 9, parity's chunk-extend) beside the
  CUDA-core path forced in the same call, bound, plain version and SDPA;
- the paged kernel's MLA fold (``mla``: deepseek-v2-236b's bf16 decode, B
  16, Hkv 1, G 128, dk 576, v_width 512, 128-576 keys, and its T 4 fold of
  512 rows): row groups of 32 and 64 rows (``flash_decode.MLA_MAX_TILES``
  2 and 4) for the committed kernel (4 warps an M-tile sharing S's
  depth, the key splits merged in a cluster), the kernel rebuilt with 2
  warps an M-tile and with each warp computing S whole (the partial-S
  exchange skipped); copies that stop after the main loop and before the
  merge;
  plans forced to 1-8 key splits at 64- and 32-row groups; the CUDA-core
  path forced through ``flash_decode.kernel_path``; and the clusters of
  2-8 blocks the card holds at once (``cudaOccupancyMaxActiveClusters``);
  then the f32 route (3xTF32) at the same shapes against the plain version
  at 2e-5: 32- and 16-row groups (``flash_decode.MLA_F32_MAX_TILES``), 8
  or 2 warps an M-tile, 32-key units, 2 ring stages, S's three products
  in one accumulator or in four, copies skipping S, P.V, the ring's reads
  or copies, or the partial-S exchange, plans of 1-8 key splits, the
  CUDA-core path and the timed shape's record;
- the SSD chunk kernel at mamba2-1.3b's eval shapes (b 8 x nc 4 and b 2 x
  nc 32 chunks of 128, h 64, p 64, n 128) and the serve prefill shape (b
  16, q 16) in bf16, and at 8 x 4 in f32 (a variant that misses the gate,
  ``chip_smoke.ssd_tol``, is reported with its error, not timed), and at
  chunks of 64 in f32: heads streamed through two slots even where all fit
  one each (bf16), each head its own slot wherever all fit the block's
  limit and not only half of it; registers capped for two blocks an SM
  (bf16); M and w x in two bf16
  parts instead of three (bf16); 16-byte stores after a lane swap instead
  of 8-byte ones straight from the fragments; expf as __expf; copies
  that stop after C.B^T, or skip Y_diag or the states, for the phases'
  shares; and a zero fill of the f32 outputs (what writing them alone
  takes);
- RMSNorm at 16 and 256 rows of 768 and 2048, 16 of 6144 and 8192, 16
  and 256 of 18432 (bf16): up to 8 vectors a lane (a warp a row at the
  narrow widths) instead of 2; at least 128 threads a row; one warp a
  block instead of 256 threads; at most 256 threads a row (a larger
  per-lane budget: 9 vectors a lane at 18432) instead of 1,024; w loaded
  after the reduction (a second round trip), beside an empty launch;
- the ``mma.sync`` ceilings: m16n8k8 TF32 and m16n8k16 bf16 with 4
  independent accumulators a warp and 32 warps an SM;
- ``ssd_logits`` (not in the default run): mamba2-1.3b's bf16 eval logits
  for the committed SSD kernel (three bf16 parts on the tensor cores), and
  for the plain scan with its products in float64 and with M and w x in
  three bf16 parts: against the plain chunked scan (the in-order design)
  at 1e-1, and each row's distance from the f32 witness over the plain
  scan's.

Every variant is held against the plain version first.  Prints one JSON
line per measurement, then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as c  # noqa: E402
from repro_torch.kernels import _build, flash_decode  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_bhsd_plain  # noqa: E402

OUT = ROOT / "build" / "variants"


def substitute(src: str, edits) -> str:
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"variant edit no longer applies: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def source(name: str) -> str:
    """A committed source with the shared header inlined, so an edit may
    reach either."""
    header = (_build.CSRC / "mma_sm80.cuh").read_text().replace("#pragma once\n", "")
    return (_build.CSRC / name).read_text().replace('#include "mma_sm80.cuh"\n', header)


def paged_source() -> str:
    """The paged kernel's three sources as one (a variant builds one file):
    the entry with the CUDA-core and decode paths, then the tensor-core
    path and its MLA fold."""
    rest = [(_build.CSRC / name).read_text().replace('#include "mma_sm80.cuh"\n', "")
            for name in ("paged_tensor_core.cu", "paged_mla.cu")]
    return "\n".join([source("paged_attention.cu"), *rest])


FLASH_EDITS = {
    "one_mtile": [("static constexpr int MT = HD == 64 ? 2 : 1;", "static constexpr int MT = 1;")],
    "cvt_split": [("  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
                   "  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;",
                   "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(hi) : \"f\"(x));\n"
                   "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(lo) : \"f\"(x - __uint_as_float(hi)));")],
    "keys64": [("static constexpr int BN = 32;      // keys per tile",
                "static constexpr int BN = HD == 64 ? 64 : 32;")],
}
FLASH_EDITS["all_three"] = [e for k in ("one_mtile", "cvt_split", "keys64") for e in FLASH_EDITS[k]]

# paged decode: copies that stop short (their output is then not the op's):
# "loads_only" streams every round and computes nothing, "before_merge"
# returns once the splits' partial states are written
_ROUND = "    const int kb = rd * rk, n = min(rk, nk - kb);\n"
DECODE_STOPS = {
    "loads_only": [(_ROUND, _ROUND + "    __syncthreads();\n    if (rd + 2 < n_rounds) issue(rd + 2);\n"
                            "    else cp_async_commit();\n    continue;\n"),
                   ("  // 6. the key groups' sums meet", "  return;\n  // 6. the key groups' sums meet")],
    "before_merge": [("  // 7. the last split of (b, h) to finish merges them all",
                      "  return;\n  // 7. the last split of (b, h) to finish merges them all")],
}

# the paged tensor-core path with one design choice undone
TC_EDITS = {
    "ring_112k": [("constexpr size_t kTcRingBudget = 200 * 1024;",
                   "constexpr size_t kTcRingBudget = 112 * 1024;")],
    "copy_loop": [("  if constexpr (NC <= 16) {\n#pragma unroll", "  if constexpr (false) {\n#pragma unroll")],
    "copy_unrolled_192": [("  if constexpr (NC <= 16) {\n#pragma unroll",
                           "  if constexpr (true) {\n#pragma unroll")],
    "eight_warps": [("constexpr int kTcWarps = 4;", "constexpr int kTcWarps = 8;")],
}

# the f32 tensor-core route (3xTF32) with one design choice undone: two
# ring stages wherever three fit; S's three products on one accumulator
# chain; Q staged pre-split into TF32 hi and lo (twice its bytes, plain
# loads) instead of split as each fragment is read
TC_F32_EDITS = {
    "two_stages": [("  if ((p.wsplits > 1 && ring3 > kTcRingBudget) || q + ring3 > kTcSmemBudget)",
                    "  if (item == 4 || (p.wsplits > 1 && ring3 > kTcRingBudget) ||\n"
                    "      q + ring3 > kTcSmemBudget)")],
    "s_one_chain": [("            mma_tf32(sx[nt + u], al, bh[2 * u], bh[2 * u + 1]);\n"
                     "            mma_tf32(sx[nt + u], ah, bl[2 * u], bl[2 * u + 1]);\n",
                     "            mma_tf32(sc[nt + u], al, bh[2 * u], bh[2 * u + 1]);\n"
                     "            mma_tf32(sc[nt + u], ah, bl[2 * u], bl[2 * u + 1]);\n")],
    "q_presplit": [
        ("  const size_t q = item == 4 ? (size_t)tiles * 16 * (dk * 4 + 16) : 0;",
         "  const size_t q = item == 4 ? 2 * (size_t)tiles * 16 * (dk * 4 + 16) : 0;"),
        ("  T* ring = qs + (F32 ? tiles * 16 * C::LDK : 0);",
         "  T* ring = qs + (F32 ? 2 * tiles * 16 * C::LDK : 0);"),
        ("      cp_async16(qs + r * C::LDK + col, qg + (in ? (size_t)r * DK + col : 0), in);\n",
         "      const float4 x = in ? *reinterpret_cast<const float4*>(qg + (size_t)r * DK + col)\n"
         "                          : make_float4(0.f, 0.f, 0.f, 0.f);\n"
         "      uint4 hi, lo;\n"
         "      split_tf32(x.x, hi.x, lo.x);\n      split_tf32(x.y, hi.y, lo.y);\n"
         "      split_tf32(x.z, hi.z, lo.z);\n      split_tf32(x.w, hi.w, lo.w);\n"
         "      *reinterpret_cast<uint4*>(qs + r * C::LDK + col) = hi;\n"
         "      *reinterpret_cast<uint4*>(qs + (tiles * 16 + r) * C::LDK + col) = lo;\n"),
        ("        uint32_t raw[4], ah[4], al[4];\n        ldmatrix_x4(raw, qt + kc * 8);\n"
         "#pragma unroll\n"
         "        for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(raw[i]), ah[i], al[i]);\n",
         "        uint32_t ah[4], al[4];\n        ldmatrix_x4(ah, qt + kc * 8);\n"
         "        ldmatrix_x4(al, qt + tiles * 16 * C::LDK + kc * 8);\n")],
}

SSD_EDITS = {  # name: (edits, the dtypes it is timed in)
    "two_slots": ([("return hb <= 2 || smem_bytes(q, p, n, item, hb) <= kSmemLimit / 2 ? hb : 2;",
                    "return hb <= 2 ? hb : 2;")], ("bfloat16",)),
    "slots_to_the_limit": ([("smem_bytes(q, p, n, item, hb) <= kSmemLimit / 2 ? hb : 2;",
                             "smem_bytes(q, p, n, item, hb) <= kSmemLimit ? hb : 2;")],
                           ("bfloat16", "float32")),
    # registers capped for two blocks an SM (bf16 only)
    "two_blocks_an_sm": ([("__launch_bounds__(kThreads, 1)",
                           "__launch_bounds__(kThreads, sizeof(T) == 2 ? 2 : 1)")], ("bfloat16",)),
    "two_bf16_parts": ([("  mma_bf16(c, al, b0, b1);\n  mma_bf16(c, am, b0, b1);\n",
                         "  mma_bf16(c, am, b0, b1);\n")], ("bfloat16",)),
    "float4_lane_swap": ([
        ("  if (ok_a) *reinterpret_cast<float2*>(row_a + 2 * t) = make_float2(c[0], c[1]);\n"
         "  if (ok_b) *reinterpret_cast<float2*>(row_b + 2 * t) = make_float2(c[2], c[3]);\n",
         "  const bool odd = t & 1;\n"
         "  const float r0 = __shfl_xor_sync(kFull, odd ? c[0] : c[2], 1);\n"
         "  const float r1 = __shfl_xor_sync(kFull, odd ? c[1] : c[3], 1);\n"
         "  if (!odd) {\n"
         "    if (ok_a) *reinterpret_cast<float4*>(row_a + 2 * t) = make_float4(c[0], c[1], r0, r1);\n"
         "  } else if (ok_b) {\n"
         "    *reinterpret_cast<float4*>(row_b + 2 * t - 2) = make_float4(r0, r1, c[2], c[3]);\n"
         "  }\n")], ("float32", "bfloat16")),
    "fast_exp": ([("  m[0] = s[0] * expf(ca - cj.x) * dj.x;\n  m[1] = s[1] * expf(ca - cj.y) * dj.y;\n"
                   "  m[2] = s[2] * expf(cb - cj.x) * dj.x;\n  m[3] = s[3] * expf(cb - cj.y) * dj.y;\n",
                   "  m[0] = s[0] * __expf(ca - cj.x) * dj.x;\n  m[1] = s[1] * __expf(ca - cj.y) * dj.y;\n"
                   "  m[2] = s[2] * __expf(cb - cj.x) * dj.x;\n  m[3] = s[3] * __expf(cb - cj.y) * dj.y;\n")],
                 ("float32", "bfloat16")),
}
# copies that stop short (their output is then not the op's), timed in both types
_HEAD_LOOP = "  for (int hh = 0; hh < hb; ++hh) {\n    const int h = h0 + hh, buf = slot_of(hh);"
SSD_STOPS = {
    "s_only": [(_HEAD_LOOP, "  float z = 0.f;\n  for (int i = 0; i < 16; ++i) z += s[i][0] + s[i][1] + s[i][2] + s[i][3];\n"
                            "  if (z == 1234.5f) y[0] = z;\n  cp_async_wait<0>();\n  return;\n" + _HEAD_LOOP)],
    "no_y": [("      if (warp < qt) y_head_bf16<P>(s, xs, hv, qp, q, warp, lane, yh, H * P);\n", ""),
             ("      if (warp < qt) y_head<P>(s, xs, hv, qp, q, warp, lane, yh, H * P);\n", "")],
    "no_states": [("      state_head_bf16<P, N>(xs, Bs, hv + 2 * qp, qt, warp, lane, sh);\n", ""),
                  ("      state_head<P, N>(xs, Bs, hv + 2 * qp, qt, warp, lane, sh);\n", "")],
}
RMSNORM_EDITS = {
    "eight_vectors_a_lane": [("constexpr int kMaxVecPerLane = 2;", "constexpr int kMaxVecPerLane = 8;")],
    "block_of_128_a_row": [("  int t = 32;\n", "  int t = 128;\n")],
    "one_warp_a_block": [("constexpr int kBlockThreads = 256;", "constexpr int kBlockThreads = 32;")],
    "at_most_256_threads_a_row": [("constexpr int kMaxRowThreads = 1024;",
                                   "constexpr int kMaxRowThreads = 256;")],
    "w_after_reduction": [("      xv[k] = xr[v];\n      wv[k].load(w, v * kVec);\n", "      xv[k] = xr[v];\n"),
                          ("  const float inv = rsqrtf(ss / (float)D + eps);\n",
                           "  const float inv = rsqrtf(ss / (float)D + eps);\n#pragma unroll\n"
                           "  for (int k = 0; k < VPT; ++k)\n"
                           "    if (k * TPR + sub < NVEC) wv[k].load(w, (k * TPR + sub) * kVec);\n")],
}

MMA_BENCH = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int K>
__global__ void mma_loop(float* out, int iters) {
  float c[4][4] = {};
  const uint32_t a[4] = {threadIdx.x, 1u, 2u, 3u}, b0 = 5u, b1 = 7u;
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (K == 0)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  float s = 0.f;
  for (int j = 0; j < 4; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_run(int kind, int blocks, int iters, void* out, void* stream) {
  if (kind == 0) mma_loop<0><<<blocks, 128, 0, (cudaStream_t)stream>>>((float*)out, iters);
  else mma_loop<1><<<blocks, 128, 0, (cudaStream_t)stream>>>((float*)out, iters);
  return cudaGetLastError();
}
"""


def build_all(sources: dict) -> dict:
    """Compile every variant source (one nvcc each, all at once) into its
    own shared library; the loaded libraries by name."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc, procs = _build.nvcc_path(), {}
    for name, src in sources.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC), str(cu),
             "-o", str(OUT / f"lib{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} does not build:\n{log[-4000:]}")
        libs[name] = ctypes.CDLL(str(OUT / f"lib{name}.so"))
    return libs


def in_turns(fns: dict) -> dict:
    """Median ms of each callable, timed in the order a, b, ..., ..., b, a."""
    names = list(fns)
    ms = {n: [] for n in names}
    for n in names + names[::-1]:
        ms[n].append(c.time_ms(fns[n]))
    return ms


def flash_variants(libs: dict) -> None:
    sig = _build.SIGNATURES["flash_attention_fwd"]
    names = ["committed", *FLASH_EDITS]
    for n in names:
        libs[f"flash_{n}"].flash_attention_fwd.argtypes = sig
    gen = torch.Generator(device="cuda").manual_seed(23)
    for bh, s in ((24, 4096), (96, 512)):
        q, k, v = (torch.randn((bh, s, 64), generator=gen, device="cuda") for _ in range(3))
        out = torch.empty_like(q)

        def call(lib):
            st = lib.flash_attention_fwd(0, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                         out.data_ptr(), bh, s, s, 64, 1, 0, 1.0 / math.sqrt(64),
                                         torch.cuda.current_stream().cuda_stream)
            _build.check(st, "flash_attention_fwd (variant)")

        want = flash_attention_bhsd_plain(q, k, v, causal=True)
        errs = {}
        for n in names:
            call(libs[f"flash_{n}"])
            torch.cuda.synchronize()
            errs[n] = (out - want).abs().max().item()
            c.require(errs[n] <= 2e-5 + 2e-5 * want.abs().max().item(),
                      f"flash variant {n} misses 2e-5 ({errs[n]})")
        ms = in_turns({n: (lambda lib=libs[f"flash_{n}"]: call(lib)) for n in names})
        for n in names:
            c.emit({"what": "flash_f32", "variant": n, "BH": bh, "S": s, "hd": 64,
                    "ms": ms[n], "max_abs_err": errs[n]})


def decode_variants(libs: dict) -> None:
    sig = _build.SIGNATURES["paged_attention_fwd"]
    for n in ("committed", *DECODE_STOPS):
        libs[f"paged_{n}"].paged_attention_fwd.argtypes = sig
    rng = np.random.default_rng(3)
    shapes = {"decode": (rng.integers(128, 576, 16).tolist(), 40)}
    rng.integers(0, 32, 16)  # the serve phase's prefill offsets
    shapes["decode_long"] = (rng.integers(2047, 4096, 16).tolist(), 256)
    consts = ("DECODE_ROUND_BYTES", "DECODE_BLOCKS_PER_SM")
    committed = {k: getattr(flash_decode, k) for k in consts}
    plans = [(32 << 10, 2), (16 << 10, 2), (64 << 10, 2), (32 << 10, 4), (32 << 10, 6),
             (1 << 20, 3)]  # the last: every page of a split in one round
    for label, (offs, P) in shapes.items():
        q, kp, vp, table, offt = c.paged_inputs(B=16, hkv=12, g=1, T=1, dk=64, ps=16, P=P,
                                                offsets=offs, dtype=torch.bfloat16, seed=21)
        fn = lambda: flash_decode.paged_flash_attention_folded(  # noqa: E731
            q, kp, vp, table, offt, tokens_per_row=1, scale=0.125)
        want = flash_decode.paged_flash_attention_folded_plain(
            q, kp, vp, table, offt, tokens_per_row=1, scale=0.125)
        for rb, bps in plans:
            flash_decode.DECODE_ROUND_BYTES, flash_decode.DECODE_BLOCKS_PER_SM = rb, bps
            plan = flash_decode.decode_plan(16, 12, P, 16, 64, 64, 2, 132)
            try:
                got = fn()
                torch.cuda.synchronize()
            except RuntimeError as e:  # a round past the shared memory: refused at launch
                c.emit({"what": "decode_plan", "at": label, "round_bytes": rb,
                        "blocks_per_sm": bps, "plan": plan, "refused": str(e)})
                continue
            err = (got.float() - want.float()).abs().max().item()
            c.require(err <= 2e-2 + 2e-2 * want.float().abs().max().item(),
                      f"decode plan {plan} misses 2e-2 ({err})")
            c.emit({"what": "decode_plan", "at": label, "round_bytes": rb,
                    "blocks_per_sm": bps, "plan": plan, "ms": c.time_ms(fn), "max_abs_err": err})
        for k, v in committed.items():
            setattr(flash_decode, k, v)
        lib0 = _build.library()
        fns = {}
        for n in ("committed", *DECODE_STOPS):
            def run(lib=libs[f"paged_{n}"]):
                _build._lib = lib
                try:
                    fn()
                finally:
                    _build._lib = lib0
            fns[n] = run
        ms = in_turns(fns)
        for n, t in ms.items():
            c.emit({"what": "decode_phases", "at": label, "variant": n, "ms": t})
        c.emit({"what": "empty_launch", "ms": c.time_ms(lambda: torch.cuda._sleep(0))})


def _fold_case(B, hkv, g, T, dk, offs, P=40, dtype=torch.bfloat16):
    """A paged call at the given fold (page 16, time_paged's seed) and its
    plain output."""
    q, kp, vp, table, offt = c.paged_inputs(B=B, hkv=hkv, g=g, T=T, dk=dk, ps=16, P=P,
                                            offsets=offs, dtype=dtype, seed=21)
    scale = 1.0 / math.sqrt(dk)
    fn = lambda: flash_decode.paged_flash_attention_folded(  # noqa: E731
        q, kp, vp, table, offt, tokens_per_row=T, scale=scale)
    want = flash_decode.paged_flash_attention_folded_plain(q, kp, vp, table, offt,
                                                           tokens_per_row=T, scale=scale)
    return fn, want


def _checked_ms(what: str, fn, want, tol: float = 2e-2) -> dict:
    got = fn()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    c.require(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
              f"{what} misses {tol} ({err})")
    return {"ms": c.time_ms(fn), "max_abs_err": err}


def tc_variants(libs: dict) -> None:
    """The tensor-core path: its routing boundary (paths forced through
    ``flash_decode.kernel_path``), its plan (the module's constants, and
    plans forced through ``flash_decode.tensor_core_plan``), no rebuild;
    then the committed kernel against each of ``TC_EDITS`` in turns, at
    the dense zoo's and ds-paper-100m's bf16 shapes (B 16)."""
    rng = np.random.default_rng(3)
    decode_offs = rng.integers(128, 576, 16).tolist()  # the serve phase's decode offsets
    prefill_offs = (16 * rng.integers(0, 32, 16)).tolist()
    real_plan = flash_decode.tensor_core_plan
    folds = [(5, 12, 1, 5, 64), (8, 12, 1, 8, 64), (9, 12, 1, 9, 64), (12, 12, 1, 12, 64),
             (15, 12, 1, 15, 64), (8, 8, 8, 1, 128), (12, 8, 12, 1, 128)]
    for rows, hkv, g, T, dk in folds:
        fn, want = _fold_case(16, hkv, g, T, dk, [o - T + 1 for o in decode_offs])
        for path in ("decode", "tensor_core", "cuda_core"):
            if path == "decode" and rows > flash_decode.DECODE_MAX_ROWS:
                continue
            c.emit({"what": "tc_boundary", "rows": rows, "G": g, "T": T, "dk": dk,
                    "Hkv": hkv, "path": path,
                    **_checked_ms(f"{path} at {rows} rows, dk {dk}", c.on_path(path, fn),
                                  want)})
    consts = ("TENSOR_CORE_BLOCKS_PER_SM", "TENSOR_CORE_MIN_UNITS", "TENSOR_CORE_MAX_SPLITS")
    committed = {k: getattr(flash_decode, k) for k in consts}
    shapes = {"granite_decode": (16, 1, 48, 1, 128, decode_offs, 40),
              "granite_prefill": (16, 1, 48, 16, 128, prefill_offs, 40),
              "qwen2_prefill": (16, 8, 8, 16, 128, prefill_offs, 40),
              "nemotron_decode": (16, 8, 12, 1, 192, decode_offs, 40),
              "nemotron_prefill": (16, 8, 12, 16, 192, prefill_offs, 40),
              "serve_prefill": (16, 12, 1, 16, 64, prefill_offs, 40),
              "verify_T9": (16, 12, 1, 9, 64, [o - 8 for o in decode_offs], 40),
              "mqa_row_4096": (1, 1, 48, 1, 128, [4095], 256)}
    forced = {"granite_decode": [(1, 1), (1, 4), (1, 8), (1, 16), (3, 2)],
              "mqa_row_4096": [(1, 16), (1, 32), (1, 64), (3, 16)]}
    try:
        for label, (B, hkv, g, T, dk, offs, P) in shapes.items():
            fn, want = _fold_case(B, hkv, g, T, dk, offs, P)
            for bps, min_units, max_splits in ((1, 2, 16), (2, 2, 16), (1, 1, 16), (1, 4, 16),
                                               (1, 2, 64)):
                flash_decode.TENSOR_CORE_BLOCKS_PER_SM = bps
                flash_decode.TENSOR_CORE_MIN_UNITS = min_units
                flash_decode.TENSOR_CORE_MAX_SPLITS = max_splits
                plan = flash_decode.tensor_core_plan(B, hkv, g * T, P, 16, 132, (dk, dk))
                c.emit({"what": "tc_plan", "at": label, "blocks_per_sm": bps,
                        "min_units": min_units, "max_splits": max_splits, "plan": plan,
                        **_checked_ms(f"tc plan {plan} at {label}", fn, want)})
            for k, v in committed.items():
                setattr(flash_decode, k, v)
            for plan in forced.get(label, ()):
                flash_decode.tensor_core_plan = lambda *_a, p=plan, **_k: p
                c.emit({"what": "tc_plan", "at": label, "forced": plan,
                        **_checked_ms(f"tc plan {plan} at {label}", fn, want)})
                flash_decode.tensor_core_plan = real_plan
    finally:
        for k, v in committed.items():
            setattr(flash_decode, k, v)
        flash_decode.tensor_core_plan = real_plan
    names = ["committed", *TC_EDITS]
    for n in names:
        libs[f"tc_{n}"].paged_attention_fwd.argtypes = _build.SIGNATURES["paged_attention_fwd"]
    lib0 = _build.library()
    for label, (B, hkv, g, T, dk, offs, P) in shapes.items():
        if label == "mqa_row_4096":
            continue
        fn, want = _fold_case(B, hkv, g, T, dk, offs, P)
        fns, errs = {}, {}
        for n in names:
            def run(lib=libs[f"tc_{n}"]):
                _build._lib = lib
                try:
                    return fn()
                finally:
                    _build._lib = lib0
            fns[n] = run
            got = run()
            torch.cuda.synchronize()
            errs[n] = (got.float() - want.float()).abs().max().item()
            c.require(torch.allclose(got.float(), want.float(), atol=2e-2, rtol=2e-2),
                      f"tc variant {n} misses 2e-2 at {label} ({errs[n]})")
        ms = in_turns(fns)
        for n in names:
            c.emit({"what": "tc_variant", "variant": n, "at": label, "ms": ms[n],
                    "max_abs_err": errs[n]})


# the MLA fold's kernel with one design choice undone
MLA_EDITS = {
    "colwarps2": [("constexpr int kMlaColWarps = 4;", "constexpr int kMlaColWarps = 2;")],
    # each warp computes S over all 576 columns: no partial-S exchange
    # (nor its shared memory)
    "s_recomputed": [("  constexpr int KS = DK / KW / NW;", "  constexpr int KS = DK / KW;"),
                     ("    const int kc0 = wc * KS;", "    const int kc0 = 0;"),
                     ("    {\n      float4* tile_partials",
                      "    if (false) {\n      float4* tile_partials"),
                     ("  const size_t sums = (size_t)tiles * (C::NW + 1) * 16 * C::UNIT * 4;",
                      "  const size_t sums = 0;")],
}
# the f32 route (3xTF32) with one design choice undone, and the row groups
# (MLA_F32_MAX_TILES) each runs at: 8 or 2 warps an M-tile instead of 4;
# 32-key units instead of 16 (two stages fit beside 16 rows only); 2 ring
# stages instead of 3; S's three products in one accumulator
# (mma_3xtf32) instead of hi.hi apart from the cross products; and the
# even and odd k-steps of S in separate accumulators too (four chains a
# key tile)
_F32_S_MMA = ("            mma_tf32(sx[nt + u], al, bh[2 * u], bh[2 * u + 1]);\n"
              "            mma_tf32(sx[nt + u], ah, bl[2 * u], bl[2 * u + 1]);\n"
              "            mma_tf32(sc[nt + u], ah, bh[2 * u], bh[2 * u + 1]);\n")
MLA_F32_EDITS = {
    "colwarps8": [("constexpr int kMlaF32ColWarps = 4;", "constexpr int kMlaF32ColWarps = 8;")],
    "colwarps2": [("constexpr int kMlaF32ColWarps = 4;", "constexpr int kMlaF32ColWarps = 2;")],
    "unit32": [("constexpr int kMlaF32Unit = 16;", "constexpr int kMlaF32Unit = 32;")],
    "stages2": [("  MlaBlock p{mla_bytes<T>(tiles, 3) <= kMlaSmemBudget ? 3 : 2, 0};",
                 "  MlaBlock p{sizeof(T) == 2 && mla_bytes<T>(tiles, 3) <= kMlaSmemBudget ? 3 : 2,"
                 " 0};")],
    "one_acc": [(_F32_S_MMA,
                 "            mma_3xtf32(sc[nt + u], ah, al, bh[2 * u], bh[2 * u + 1], "
                 "bl[2 * u], bl[2 * u + 1]);\n")],
    "acc4": [("      float sx[NT][4];\n",
              "      float sx[NT][4], sc2[NT][4] = {}, sx2[NT][4] = {};\n"),
             (_F32_S_MMA,
              "            if (kk & 1) {\n"
              "              mma_tf32(sx2[nt + u], al, bh[2 * u], bh[2 * u + 1]);\n"
              "              mma_tf32(sx2[nt + u], ah, bl[2 * u], bl[2 * u + 1]);\n"
              "              mma_tf32(sc2[nt + u], ah, bh[2 * u], bh[2 * u + 1]);\n"
              "            } else {\n" + _F32_S_MMA + "            }\n"),
             ("        for (int e = 0; e < 4; ++e) sc[nt][e] += sx[nt][e];",
              "        for (int e = 0; e < 4; ++e)\n"
              "          sc[nt][e] += sc2[nt][e] + (sx[nt][e] + sx2[nt][e]);")],
}
MLA_F32_TILES = {"committed": (2, 1), "colwarps8": (2, 1), "colwarps2": (2,), "unit32": (1,),
                 "stages2": (2,), "one_acc": (2,), "acc4": (2, 1)}
# how many clusters of the committed MLA kernel the card holds at once, by
# cluster size (cudaOccupancyMaxActiveClusters), appended to its source
MLA_CLUSTERS = r"""
template <typename T>
int max_clusters(int tiles, int splits, int* n) {
  const MlaBlock blk = mla_block<T>(tiles, splits);
  auto kernel = paged_mla_kernel<T>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)blk.smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, 1, 132);
  cfg.blockDim = dim3(tiles * MlaCfg<T>::NW * 32);
  cfg.dynamicSmemBytes = blk.smem;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = splits;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
}

extern "C" int mla_max_clusters(int f32, int tiles, int splits, int* n) {
  return f32 ? max_clusters<float>(tiles, splits, n)
             : max_clusters<__nv_bfloat16>(tiles, splits, n);
}
"""
# copies that stop short (their output is then not the op's): after the
# main loop, and after each split's state is written (before the merge)
_MLA_OUT = ("  T* __restrict__ out = static_cast<T*>(a.out) + (size_t)bh * ql * DV;\n"
            "  if (splits == 1) {")
MLA_STOPS = {
    "loop_only": [(_MLA_OUT, "  return;\n" + _MLA_OUT)],
    "before_merge": [("  cg::cluster_group cluster = cg::this_cluster();\n  cluster.sync();",
                      "  return;\n  cg::cluster_group cluster = cg::this_cluster();\n"
                      "  cluster.sync();")],
}
# f32 copies that skip a part of each unit's work: a product (P.V, or S's
# k-steps), the ring's global reads (zero fill instead), the copies
# themselves (the units computed on what shared memory holds), or the
# partial-S exchange (each warp keeps its own partial S): their shares of
# the f32 route's time
MLA_F32_STOPS = {
    "no_read": [("      cp_async16(dst + r * LD + col, kp + (src >= 0 ? (size_t)src * kstride + col "
                 ": 0),\n                 src >= 0);",
                 "      cp_async16(dst + r * LD + col, kp, false);")],
    "no_copy": [("    for (int i = warp * 32 + lane; i < UNIT * NC; i += 32 * nwarps) {",
                 "    for (int i = warp * 32 + lane; i < 0; i += 32 * nwarps) {")],
    "no_exchange": [("    {\n      float4* tile_partials",
                     "    if (false) {\n      float4* tile_partials")],
    "no_pv": [("      for (int kc = 0; kc < NT; ++kc) {\n        uint32_t ph[4], pl[4];",
               "      for (int kc = 0; kc < 0; ++kc) {\n        uint32_t ph[4], pl[4];")],
    "no_s": [("      for (int kk = 0; kk < KS; ++kk) {\n        const int kc = kc0 + kk;\n"
              "        uint32_t raw[4], ah[4], al[4];",
              "      for (int kk = 0; kk < 0; ++kk) {\n        const int kc = kc0 + kk;\n"
              "        uint32_t raw[4], ah[4], al[4];")],
}


def mla_variants(libs: dict) -> None:
    """The MLA fold at mla_serve's timed shapes (bf16, B 16, G 128, offsets
    128-576 from seed 3, T 1 and 4), after the clusters the card holds at
    once by size: the committed kernel and ``MLA_EDITS`` at 64- and 32-row
    groups in turns, ``MLA_STOPS`` beside the committed kernel, plans of
    1-8 key splits at both row groups, and the CUDA-core path; then the
    f32 route (``mla_f32_variants``)."""
    probe = libs["mla_committed"].mla_max_clusters
    probe.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    for f32, all_tiles in ((0, (4, 2)), (1, (2, 1))):
        for tiles in all_tiles:
            for splits in range(2, 9):
                n = ctypes.c_int(-1)
                c.emit({"what": "mla_max_active_clusters", "dtype": "f32" if f32 else "bf16",
                        "rows": 16 * tiles, "cluster": splits,
                        "status": probe(f32, tiles, splits, ctypes.byref(n)),
                        "clusters": n.value, "blocks": n.value * splits})
    rng = np.random.default_rng(3)
    offs = rng.integers(128, 576, 16).tolist()
    names = ["committed", *MLA_EDITS]
    for n in (*names, *MLA_STOPS):
        libs[f"mla_{n}"].paged_attention_fwd.argtypes = _build.SIGNATURES["paged_attention_fwd"]
    lib0 = _build.library()
    real_plan = flash_decode.tensor_core_plan
    tiles0 = flash_decode.MLA_MAX_TILES
    for label, T in (("decode", 1), ("t4", 4)):
        q, kv, _, table, offt = c.paged_inputs(B=16, hkv=1, g=128, T=T, dk=576, ps=16, P=40,
                                               offsets=offs, dtype=torch.bfloat16, seed=23,
                                               shared_kv=True)
        call = dict(tokens_per_row=T, scale=c.MLA_SCALE, v_width=512)
        fn = lambda: flash_decode.paged_flash_attention_folded(  # noqa: E731
            q, kv, kv, table, offt, **call)
        want = flash_decode.paged_flash_attention_folded_plain(q, kv, kv, table, offt, **call)
        fns, errs = {}, {}
        for n in names:
            for tiles in (4, 2):
                def run(lib=libs[f"mla_{n}"], tiles=tiles):
                    _build._lib = lib
                    flash_decode.MLA_MAX_TILES = tiles
                    try:
                        return fn()
                    finally:
                        _build._lib = lib0
                        flash_decode.MLA_MAX_TILES = tiles0
                key = f"{n}_rows{16 * tiles}"
                fns[key] = run
                got = run()
                torch.cuda.synchronize()
                errs[key] = (got.float() - want.float()).abs().max().item()
                c.require(torch.allclose(got.float(), want.float(), atol=2e-2, rtol=2e-2),
                          f"mla variant {key} misses 2e-2 at {label} ({errs[key]})")
        ms = in_turns(fns)
        for key in fns:
            c.emit({"what": "mla_variant", "variant": key, "at": label, "ms": ms[key],
                    "max_abs_err": errs[key]})
        stops = {}
        for n in ("committed", *MLA_STOPS):
            def run(lib=libs[f"mla_{n}"]):
                _build._lib = lib
                try:
                    fn()
                finally:
                    _build._lib = lib0
            stops[n] = run
        for n, t in in_turns(stops).items():
            c.emit({"what": "mla_phases", "at": label, "variant": n, "ms": t})
        plan = real_plan(16, 1, 128 * T, 40, 16, 132, flash_decode.MLA_WIDTHS)
        try:
            for groups in (8 * T // 4, 8 * T // 2):  # 64- and 32-row groups
                for splits in range(1, 9):
                    flash_decode.tensor_core_plan = lambda *_a, p=(groups, splits), **_k: p
                    c.emit({"what": "mla_plan", "at": label, "groups": groups,
                            "splits": splits, "planned": (groups, splits) == plan,
                            **_checked_ms(f"mla plan {splits} splits at {label}", fn, want)})
        finally:
            flash_decode.tensor_core_plan = real_plan
        c.emit({"what": "mla_path", "at": label, "path": "cuda_core",
                **_checked_ms(f"mla CUDA-core path at {label}", c.on_path("cuda_core", fn),
                              want)})
    mla_f32_variants(libs, offs)


def mla_f32_variants(libs: dict, offs: list) -> None:
    """The f32 MLA fold (3xTF32) at mla_serve's timed shapes (B 16, G 128,
    T 1 and 4): the committed kernel and ``MLA_F32_EDITS`` at their row
    groups in turns (against the plain version at 2e-5), ``MLA_STOPS`` and
    ``MLA_F32_STOPS`` beside the committed kernel, plans of 1-8 key splits
    at 32- and 16-row groups, the CUDA-core path, and the timed shape's
    record (bound, plain and SDPA) from ``chip_smoke.time_paged_mla``."""
    names = ["committed", *MLA_F32_EDITS]
    lib_of = {n: libs["mla_committed" if n == "committed" else f"mla_f32_{n}"] for n in names}
    for n in MLA_F32_STOPS:
        lib_of[n] = libs[f"mla_f32_{n}"]
    for n in MLA_STOPS:
        lib_of[n] = libs[f"mla_{n}"]
    for lib in lib_of.values():
        lib.paged_attention_fwd.argtypes = _build.SIGNATURES["paged_attention_fwd"]
    lib0 = _build.library()
    real_plan = flash_decode.tensor_core_plan
    tiles0 = flash_decode.MLA_F32_MAX_TILES
    for label, T in (("decode", 1), ("t4", 4)):
        q, kv, _, table, offt = c.paged_inputs(B=16, hkv=1, g=128, T=T, dk=576, ps=16, P=40,
                                               offsets=offs, dtype=torch.float32, seed=23,
                                               shared_kv=True)
        call = dict(tokens_per_row=T, scale=c.MLA_SCALE, v_width=512)
        fn = lambda: flash_decode.paged_flash_attention_folded(  # noqa: E731
            q, kv, kv, table, offt, **call)
        want = flash_decode.paged_flash_attention_folded_plain(q, kv, kv, table, offt, **call)
        fns, errs = {}, {}
        for n in names:
            for tiles in MLA_F32_TILES[n]:
                def run(lib=lib_of[n], tiles=tiles):
                    _build._lib = lib
                    flash_decode.MLA_F32_MAX_TILES = tiles
                    try:
                        return fn()
                    finally:
                        _build._lib = lib0
                        flash_decode.MLA_F32_MAX_TILES = tiles0
                key = f"{n}_rows{16 * tiles}"
                fns[key] = run
                got = run()
                torch.cuda.synchronize()
                errs[key] = (got.float() - want.float()).abs().max().item()
                c.require(torch.allclose(got.float(), want.float(), atol=c.F32_TOL,
                                         rtol=c.F32_TOL),
                          f"mla f32 variant {key} misses {c.F32_TOL} at {label} ({errs[key]})")
        ms = in_turns(fns)
        for key in fns:
            c.emit({"what": "mla_f32_variant", "variant": key, "at": label, "ms": ms[key],
                    "max_abs_err": errs[key]})
        stops = {}
        for n in ("committed", *MLA_STOPS, *MLA_F32_STOPS):
            def run(lib=lib_of[n]):
                _build._lib = lib
                try:
                    fn()
                finally:
                    _build._lib = lib0
            stops[n] = run
        for n, t in in_turns(stops).items():
            c.emit({"what": "mla_f32_phases", "at": label, "variant": n, "ms": t})
        plan = real_plan(16, 1, 128 * T, 40, 16, 132, flash_decode.MLA_WIDTHS, torch.float32)
        try:
            for tiles in (2, 1):
                groups = 8 * T // tiles
                for splits in range(1, 9):
                    flash_decode.MLA_F32_MAX_TILES = tiles
                    flash_decode.tensor_core_plan = lambda *_a, p=(groups, splits), **_k: p
                    c.emit({"what": "mla_f32_plan", "at": label, "groups": groups,
                            "splits": splits, "planned": (groups, splits) == plan,
                            **_checked_ms(f"mla f32 plan {splits} splits at {label}", fn, want,
                                          c.F32_TOL)})
        finally:
            flash_decode.tensor_core_plan = real_plan
            flash_decode.MLA_F32_MAX_TILES = tiles0
        c.emit({"what": "mla_f32_path", "at": label, "path": "cuda_core",
                **_checked_ms(f"mla f32 CUDA-core path at {label}", c.on_path("cuda_core", fn),
                              want, c.F32_TOL)})
        c.emit({"what": "mla_f32_timed", **c.time_paged_mla(f"{label}_f32", T, offs,
                                                            torch.float32)})


def _f32_shapes() -> dict:
    """The zoo's f32 serve shapes (B 16, page 16, 40 pages a slot; decode
    offsets 128-576 and prefill offsets from seed 3, as zoo_serve times
    their bf16 counterparts) and the f32 calls of ds-paper-100m (verify T 9
    at B 16, and parity's chunk-extend: B 4, 8 pages a slot):
    label -> (B, Hkv, G, T, dk, offsets, P)."""
    rng = np.random.default_rng(3)
    decode_offs = rng.integers(128, 576, 16).tolist()
    prefill_offs = (16 * rng.integers(0, 32, 16)).tolist()
    return {"nemotron_decode": (16, 8, 12, 1, 192, decode_offs, 40),
            "nemotron_prefill": (16, 8, 12, 16, 192, prefill_offs, 40),
            "granite_decode": (16, 1, 48, 1, 128, decode_offs, 40),
            "granite_prefill": (16, 1, 48, 16, 128, prefill_offs, 40),
            "qwen2_prefill": (16, 8, 8, 16, 128, prefill_offs, 40),
            "verify_T9": (16, 12, 1, 9, 64, [o - 8 for o in decode_offs], 40),
            "f32_chunk_extend": (4, 12, 1, 16, 64, [0, 16, 32, 48], 8)}


def tc_f32_variants(libs: dict) -> None:
    """The f32 tensor-core route (3xTF32): its routing boundary against the
    decode and CUDA-core paths (each forced through
    ``flash_decode.kernel_path``) at f32 folds of 8-40 rows at dk 64 and
    128; the f32 group cap (``TENSOR_CORE_F32_MAX_TILES`` at the shape's dk:
    4, 6 and 8) and
    forced key splits at the zoo's f32 shapes; the committed kernel
    against each of ``TC_F32_EDITS`` in turns (against the plain version
    at 2e-5); then each shape's record (``paged_f32_shapes``)."""
    f32, tol = torch.float32, c.F32_TOL
    shapes = _f32_shapes()
    decode_offs = shapes["nemotron_decode"][5]
    prefill_offs = shapes["nemotron_prefill"][5]
    folds = {"qwen2_decode_g8": (16, 8, 8, 1, 128, decode_offs, 40),
             "verify_T9": shapes["verify_T9"],
             "spec_parity_T9": (4, 12, 1, 9, 64, [0, 13, 40, 100], 8),
             "rows12": (16, 12, 1, 12, 64, [o - 11 for o in decode_offs], 40),
             "rows16": (16, 12, 1, 16, 64, prefill_offs, 40),
             "f32_chunk_extend": shapes["f32_chunk_extend"],
             "verify_T5_g8": (16, 8, 8, 5, 128, [o - 4 for o in decode_offs], 40)}
    real_plan = flash_decode.tensor_core_plan
    for label, (B, hkv, g, T, dk, offs, P) in folds.items():
        fn, want = _fold_case(B, hkv, g, T, dk, offs, P, f32)
        for path in ("decode", "tensor_core", "cuda_core"):
            if path == "decode" and g * T > flash_decode.DECODE_MAX_ROWS:
                continue
            c.emit({"what": "tc_f32_boundary", "at": label, "rows": g * T, "B": B, "dk": dk,
                    "path": path,
                    **_checked_ms(f"f32 {path} at {label}", c.on_path(path, fn), want, tol)})
    tiles0 = dict(flash_decode.TENSOR_CORE_F32_MAX_TILES)
    forced = {"granite_decode": [(1, 1), (1, 4), (1, 8), (1, 16), (3, 2)],
              "nemotron_decode": [(1, 1), (1, 2)]}
    try:
        for label, (B, hkv, g, T, dk, offs, P) in shapes.items():
            fn, want = _fold_case(B, hkv, g, T, dk, offs, P, f32)
            if g * T > 64:
                for tiles in (4, 6, 8):
                    flash_decode.TENSOR_CORE_F32_MAX_TILES = {**tiles0, dk: tiles}
                    plan = real_plan(B, hkv, g * T, P, 16, 132, (dk, dk), f32)
                    c.emit({"what": "tc_f32_plan", "at": label, "max_tiles": tiles,
                            "plan": plan,
                            **_checked_ms(f"f32 plan {plan} at {label}", fn, want, tol)})
                flash_decode.TENSOR_CORE_F32_MAX_TILES = tiles0
            for plan in forced.get(label, ()):
                flash_decode.tensor_core_plan = lambda *_a, p=plan, **_k: p
                c.emit({"what": "tc_f32_plan", "at": label, "forced": plan,
                        **_checked_ms(f"f32 plan {plan} at {label}", fn, want, tol)})
                flash_decode.tensor_core_plan = real_plan
    finally:
        flash_decode.TENSOR_CORE_F32_MAX_TILES = tiles0
        flash_decode.tensor_core_plan = real_plan
    names = ["committed", *TC_F32_EDITS]
    for n in names:
        libs[f"tc_f32_{n}"].paged_attention_fwd.argtypes = _build.SIGNATURES["paged_attention_fwd"]
    lib0 = _build.library()
    for label, (B, hkv, g, T, dk, offs, P) in shapes.items():
        if flash_decode.kernel_path(f32, g * T, dk, dk) != "tensor_core":
            continue
        fn, want = _fold_case(B, hkv, g, T, dk, offs, P, f32)
        fns, errs = {}, {}
        for n in names:
            def run(lib=libs[f"tc_f32_{n}"]):
                _build._lib = lib
                try:
                    return fn()
                finally:
                    _build._lib = lib0
            try:
                got = run()
                torch.cuda.synchronize()
            except RuntimeError as e:  # a variant's block may not fit this shape
                c.emit({"what": "tc_f32_variant", "variant": n, "at": label, "error": str(e)})
                continue
            fns[n] = run
            errs[n] = (got.float() - want.float()).abs().max().item()
            c.require(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
                      f"tc f32 variant {n} misses {tol} at {label} ({errs[n]})")
        for n, t in in_turns(fns).items():
            c.emit({"what": "tc_f32_variant", "variant": n, "at": label, "ms": t,
                    "max_abs_err": errs[n]})
    paged_f32_shapes()


def paged_f32_shapes() -> None:
    """The f32 paged calls of ``_f32_shapes`` timed as zoo_serve times their
    bf16 counterparts (``chip_smoke.time_paged``), each on the path
    ``flash_decode.kernel_path`` gives it and forced onto the CUDA-core
    path beside it, with the bound of each route (and apart, the bytes
    and three TF32 passes), the plain version and SDPA."""
    for label, (B, hkv, g, T, dk, offs, P) in _f32_shapes().items():
        rec = c.time_paged(f"{label}_f32", B, T, offs, torch.float32, P=P, hkv=hkv, g=g, dk=dk,
                           cuda_core=True)
        # time_paged's inputs again (its seed), for the bound's two parts
        q, kp, _, table, offt = c.paged_inputs(B=B, hkv=hkv, g=g, T=T, dk=dk, ps=16, P=P,
                                               offsets=offs, dtype=torch.float32, seed=21)
        nbytes, flops = c.paged_work(q, kp, table, offt, T, dk)
        c.emit({"what": "paged_f32_shape", **rec,
                "bytes_ms": nbytes / c.HBM_BYTES_PER_S * 1e3,
                "tf32x3_ms": 3 * flops / c.TF32_OPS * 1e3})


def ssd_variants(libs: dict) -> None:
    from repro_torch.kernels.ssd import _DTYPES, ssd_chunk_plain

    names = ["committed", *SSD_EDITS, *SSD_STOPS]
    for n in names:
        libs[f"ssd_{n}"].ssd_chunk_fwd.argtypes = _build.SIGNATURES["ssd_chunk_fwd"]
    serve_lengths = [16, 0, 5, 16, 1, 0, 9, 16, 16, 3, 16, 0, 12, 16, 7, 16]
    shapes = [("eval_8x512", 8, 4, 128, torch.bfloat16, None),
              ("eval_2x4096", 2, 32, 128, torch.bfloat16, None),
              ("serve_prefill", 16, 1, 16, torch.bfloat16, serve_lengths),
              ("eval_8x512", 8, 4, 128, torch.float32, None),
              ("chunk64_8x512", 8, 8, 64, torch.float32, None)]
    h, p, n = 64, 64, 128
    for label, b, nc, q, dtype, lengths in shapes:
        x, dt, A, B, C = c.ssd_inputs(b, nc, q, h, p, n, dtype, 70, lengths)
        dA = dt * A
        y = torch.empty((b, nc, q, h, p), device="cuda")
        st = torch.empty((b, nc, h, p, n), device="cuda")
        tag = str(dtype).removeprefix("torch.")

        def call(lib):
            status = lib.ssd_chunk_fwd(_DTYPES[dtype], x.data_ptr(), dA.data_ptr(), dt.data_ptr(),
                                       B.data_ptr(), C.data_ptr(), y.data_ptr(), st.data_ptr(),
                                       b * nc, q, h, p, n, 8,
                                       torch.cuda.current_stream().cuda_stream)
            _build.check(status, "ssd_chunk_fwd (variant)")

        want = ssd_chunk_plain(x, dA, dt, B, C)
        t = c.ssd_tol(dtype)
        errs, run = {}, ["committed"] + [k for k, (_, tags) in SSD_EDITS.items() if tag in tags]
        for name in list(run):
            call(libs[f"ssd_{name}"])
            torch.cuda.synchronize()
            errs[name] = max((y - want[0]).abs().max().item(), (st - want[1]).abs().max().item())
            ok = torch.allclose(y, want[0], atol=t, rtol=t) and torch.allclose(st, want[1], atol=t,
                                                                              rtol=t)
            c.require(ok or name != "committed", f"ssd misses its gate at {label}")
            if not ok:  # a variant that is not the op is reported, not timed
                c.emit({"what": "ssd", "variant": name, "at": label, "misses_gate": t,
                        "dtype": tag, "max_abs_err": errs[name]})
                run.remove(name)
        timed = run + list(SSD_STOPS)
        ms = in_turns({name: (lambda lib=libs[f"ssd_{name}"]: call(lib)) for name in timed})
        for name in timed:
            c.emit({"what": "ssd", "variant": name, "at": label, "dtype": tag, "ms": ms[name],
                    "max_abs_err": errs.get(name)})
        # what writing the f32 outputs alone takes under the same timing
        c.emit({"what": "ssd_outputs_zero_fill", "at": label, "bytes": 4 * (y.numel() + st.numel()),
                "ms": c.time_ms(lambda: (y.zero_(), st.zero_()))})


def ssd_logits(_libs: dict) -> None:
    """mamba2-1.3b's bf16 eval logits (seed-0 weights, 8 x 512 and 2 x 4096)
    for the committed kernel (three bf16 parts on the tensor cores) and for
    the plain scan with its products taken another way: C.B^T and M.x in
    float64, rounded once; M.x and (w x)^T.B with M and w x in three bf16
    parts, as the kernel forms them.  Each against the plain chunked scan
    (fp32 FMA in order) at the old 1e-1 comparison, and each batch row's
    distance from the f32 plain forward of the same weights over the plain
    scan's (``chip_smoke.witness_gate``'s ratio)."""
    import repro_torch.models.ssm as ssm
    from repro_torch.models import Model, ModelRuntime
    from repro_torch.train.data import DataConfig, SyntheticLM

    einsum = torch.einsum

    def einsum_f64(eq, *ops):
        if eq in ("bcqkh,bckhp->bcqhp", "bcqn,bckn->bcqk"):
            return einsum(eq, *(o.double() for o in ops)).float()
        return einsum(eq, *ops)

    def einsum_bf16x3(eq, *ops):
        if eq in ("bcqkh,bckhp->bcqhp", "bckhp,bckn->bchpn"):
            a, b = ops
            parts = []
            for _ in range(3):
                parts.append(a.bfloat16().float())
                a = a - parts[-1]
            return sum(einsum(eq, part, b) for part in reversed(parts))
        return einsum(eq, *ops)

    cfg, params_cpu = c.ssm_weights()
    params = c.cast_params(params_cpu, torch.bfloat16, "cuda")
    del params_cpu
    p32 = c.cast_params(params, torch.float32, "cuda")
    gate = c.SSM_LOGIT_TOL[torch.bfloat16]
    for b, s in c.EVAL_SHAPES:
        tokens = SyntheticLM(cfg, DataConfig(seq_len=s, global_batch=b, seed=1234),
                             device="cuda").batch(0)["tokens"]
        plain = Model(cfg, ModelRuntime(dtype=torch.bfloat16, use_ssd_kernel=False))
        kern = Model(cfg, ModelRuntime(dtype=torch.bfloat16, use_ssd_kernel=True))
        with torch.no_grad():
            witness = Model(cfg, ModelRuntime(dtype=torch.float32, use_ssd_kernel=False)).forward(
                p32, tokens)
            base = plain.forward(params, tokens).float()
            got = {}
            for name, patch in (("plain_scan_f64_products", einsum_f64),
                                ("plain_scan_bf16x3_products", einsum_bf16x3)):
                ssm.torch.einsum = patch
                try:
                    got[name] = plain.forward(params, tokens).float()
                finally:
                    ssm.torch.einsum = einsum
            got["committed"] = kern.forward(params, tokens).float()
        base_rows = c.row_distance(base, witness, cfg.vocab_size)
        for name, out in got.items():
            d = (out - base).abs()
            c.emit({"what": "ssd_logits", "at": f"bf16_{b}x{s}", "route": name,
                    "against": "plain chunked scan", "max_abs": d.max().item(),
                    "mean_abs": d.mean().item(),
                    "worst_over_gate": (d / (gate + gate * base.abs())).max().item(),
                    "witness_row_ratios": (c.row_distance(out, witness, cfg.vocab_size)
                                           / base_rows).tolist()})
        del base, got, witness


def rmsnorm_variants(libs: dict) -> None:
    from repro_torch.kernels.rmsnorm import rmsnorm_plain

    names = ["committed", *RMSNORM_EDITS]
    for n in names:
        libs[f"rmsnorm_{n}"].rmsnorm_fwd.argtypes = _build.SIGNATURES["rmsnorm_fwd"]
    gen = torch.Generator(device="cuda").manual_seed(22)
    for rows, d in ((16, 768), (256, 768), (16, 2048), (256, 2048), (16, 6144), (16, 8192),
                    (16, 18432), (256, 18432)):
        x = torch.randn((rows, d), generator=gen, device="cuda").bfloat16()
        w = (torch.randn((d,), generator=gen, device="cuda") + 1.0).bfloat16()
        out = torch.empty_like(x)

        def call(lib):
            status = lib.rmsnorm_fwd(1, 1, x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, d,
                                     1e-5, ctypes.byref(ctypes.c_int()),
                                     torch.cuda.current_stream().cuda_stream)
            _build.check(status, "rmsnorm_fwd (variant)")

        want = rmsnorm_plain(x, w, 1e-5).float()
        errs = {}
        for name in names:
            call(libs[f"rmsnorm_{name}"])
            torch.cuda.synchronize()
            errs[name] = (out.float() - want).abs().max().item()
            c.require(torch.allclose(out.float(), want, atol=2e-2, rtol=2e-2),
                      f"rmsnorm variant {name} misses 2e-2 at {rows} x {d} ({errs[name]})")
        ms = in_turns({name: (lambda lib=libs[f"rmsnorm_{name}"]: call(lib)) for name in names})
        for name in names:
            c.emit({"what": "rmsnorm", "variant": name, "rows": rows, "d": d, "ms": ms[name],
                    "max_abs_err": errs[name]})
    c.emit({"what": "empty_launch", "ms": c.time_launch_floor()})


def mma_ceilings(lib) -> None:
    lib.mma_run.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                            ctypes.c_void_p]
    blocks, iters = 132 * 8, 4096  # 32 warps an SM
    out = torch.empty(blocks * 128, device="cuda")
    for kind, name, macs in ((0, "tf32 m16n8k8", 16 * 8 * 8), (1, "bf16 m16n8k16", 16 * 8 * 16)):
        ms = c.time_ms(lambda: lib.mma_run(kind, blocks, iters, out.data_ptr(),
                                           torch.cuda.current_stream().cuda_stream), iters=5)
        n_mma = blocks * 4 * iters * 4
        c.emit({"what": "mma_sync_ceiling", "kind": name, "ms": ms,
                "tflops": 2 * macs * n_mma / (ms * 1e-3) / 1e12})


GROUPS = ("flash", "decode", "tc", "tc_f32", "mla", "ssd", "rmsnorm", "mma", "ssd_logits")


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device is available", file=sys.stderr)
        return 2
    groups = sys.argv[1:] or [g for g in GROUPS if g != "ssd_logits"]
    if any(g not in GROUPS for g in groups):
        print(f"kernel_variants: groups are {GROUPS}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    sources = {}
    if "flash" in groups:
        flash = source("flash_attention.cu")
        sources["flash_committed"] = flash
        sources.update({f"flash_{n}": substitute(flash, e) for n, e in FLASH_EDITS.items()})
    if any(g in groups for g in ("decode", "tc", "tc_f32", "mla")):
        paged = paged_source()
    if "decode" in groups:
        sources["paged_committed"] = paged
        sources.update({f"paged_{n}": substitute(paged, e) for n, e in DECODE_STOPS.items()})
    if "tc" in groups:
        sources["tc_committed"] = paged
        sources.update({f"tc_{n}": substitute(paged, e) for n, e in TC_EDITS.items()})
    if "tc_f32" in groups:
        sources["tc_f32_committed"] = paged
        sources.update({f"tc_f32_{n}": substitute(paged, e) for n, e in TC_F32_EDITS.items()})
    if "mla" in groups:
        sources["mla_committed"] = paged + MLA_CLUSTERS
        sources.update({f"mla_{n}": substitute(paged, e) for n, e in MLA_EDITS.items()})
        sources.update({f"mla_{n}": substitute(paged, e) for n, e in MLA_STOPS.items()})
        sources.update({f"mla_f32_{n}": substitute(paged, e)
                        for n, e in {**MLA_F32_EDITS, **MLA_F32_STOPS}.items()})
    if "ssd" in groups:
        ssd = source("ssd.cu")
        sources["ssd_committed"] = ssd
        sources.update({f"ssd_{n}": substitute(ssd, e) for n, (e, _) in SSD_EDITS.items()})
        sources.update({f"ssd_{n}": substitute(ssd, e) for n, e in SSD_STOPS.items()})
    if "rmsnorm" in groups:
        rms = source("rmsnorm.cu")
        sources["rmsnorm_committed"] = rms
        sources.update({f"rmsnorm_{n}": substitute(rms, e) for n, e in RMSNORM_EDITS.items()})
    if "mma" in groups:
        sources["mma"] = MMA_BENCH
    _build.library()
    libs = build_all(sources)
    for group, fn in (("flash", flash_variants), ("decode", decode_variants),
                      ("tc", tc_variants), ("tc_f32", tc_f32_variants),
                      ("mla", mla_variants), ("ssd", ssd_variants),
                      ("rmsnorm", rmsnorm_variants),
                      ("ssd_logits", ssd_logits)):
        if group in groups:
            fn(libs)
    if "mma" in groups:
        mma_ceilings(libs["mma"])
    print(c.smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
