"""Design measurements behind the f32 flash kernel and the paged decode path,
on one CUDA card.

    python3 tools/kernel_variants.py

Each variant is the committed source with one design choice undone by a
text substitution, built with the port's own nvcc flags into
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
- the ``mma.sync`` ceilings: m16n8k8 TF32 and m16n8k16 bf16 with 4
  independent accumulators a warp and 32 warps an SM.

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


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    flash = (_build.CSRC / "flash_attention.cu").read_text()
    paged = (_build.CSRC / "paged_attention.cu").read_text()
    sources = {"flash_committed": flash, "paged_committed": paged, "mma": MMA_BENCH}
    sources.update({f"flash_{n}": substitute(flash, e) for n, e in FLASH_EDITS.items()})
    sources.update({f"paged_{n}": substitute(paged, e) for n, e in DECODE_STOPS.items()})
    _build.library()
    libs = build_all(sources)
    flash_variants(libs)
    decode_variants(libs)
    mma_ceilings(libs["mma"])
    print(c.smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
