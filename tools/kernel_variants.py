"""Design measurements behind the f32 flash kernel, the paged decode path,
the SSD chunk kernel and RMSNorm, on one CUDA card.

    python3 tools/kernel_variants.py [flash] [decode] [ssd] [rmsnorm] [mma] [ssd_logits]

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
- the SSD chunk kernel at mamba2-1.3b's eval shapes (b 8 x nc 4 and b 2 x
  nc 32 chunks of 128, h 64, p 64, n 128) and the serve prefill shape (b
  16, q 16) in bf16, and at 8 x 4 in f32 (a variant that misses the gate
  is reported with its error, not timed): heads streamed through two
  slots even where all fit one each; the in-order states' loop over j not unrolled (bf16);
  16-byte stores after a lane swap instead of 8-byte ones straight from
  the fragments (f32); expf as __expf (f32); copies that
  stop after C.B^T, or skip Y_diag or the states, for the phases'
  shares; and a zero fill of the f32 outputs (what writing them alone
  takes);
- RMSNorm at 16 and 256 rows of 768 and 2048 (bf16): up to 8 vectors a
  lane (a warp a row at these widths) instead of 2; at least 128 threads
  a row; one warp a block instead of 256 threads; w loaded after the
  reduction (a second round trip), beside an empty launch;
- the ``mma.sync`` ceilings: m16n8k8 TF32 and m16n8k16 bf16 with 4
  independent accumulators a warp and 32 warps an SM;
- ``ssd_logits`` (not in the default run): mamba2-1.3b's bf16 eval logits
  against the plain chunked scan for the committed SSD kernel and for the
  plain scan with its products in float64.

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

SSD_EDITS = {  # name: (edits, the dtypes it is timed in)
    "two_slots": ([("return hb <= 2 || smem_bytes(q, p, n, item, hb) <= kSmemLimit ? hb : 2;",
                    "return hb <= 2 ? hb : 2;")], ("bfloat16",)),
    "states_loop_rolled": ([("#pragma unroll 2\n    for (int j = 0; j < q; ++j) {",
                              "#pragma unroll 1\n    for (int j = 0; j < q; ++j) {")], ("bfloat16",)),
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
         "  }\n")], ("float32",)),
    "fast_exp": ([("  m[0] = s[0] * expf(ca - cj.x) * dj.x;\n  m[1] = s[1] * expf(ca - cj.y) * dj.y;\n"
                   "  m[2] = s[2] * expf(cb - cj.x) * dj.x;\n  m[3] = s[3] * expf(cb - cj.y) * dj.y;\n",
                   "  m[0] = s[0] * __expf(ca - cj.x) * dj.x;\n  m[1] = s[1] * __expf(ca - cj.y) * dj.y;\n"
                   "  m[2] = s[2] * __expf(cb - cj.x) * dj.x;\n  m[3] = s[3] * __expf(cb - cj.y) * dj.y;\n")],
                 ("float32",)),
}
# copies that stop short (their output is then not the op's), timed in both types
_HEAD_LOOP = "  for (int hh = 0; hh < hb; ++hh) {\n    const int h = h0 + hh, buf = slot_of(hh);"
SSD_STOPS = {
    "s_only": [(_HEAD_LOOP, "  float z = 0.f;\n  for (int i = 0; i < 16; ++i) z += s[i][0] + s[i][1] + s[i][2] + s[i][3];\n"
                            "  if (z == 1234.5f) y[0] = z + Ss[0];\n  cp_async_wait<0>();\n  return;\n" + _HEAD_LOOP)],
    "no_y": [("        y_in_order<P>(Ss, qp + 1, Xf, hv, q, qp, tid, yh, H * P);\n", ";\n"),
             ("      if (warp < qt) y_head<P>(s, xs, hv, qp, q, warp, lane, yh, H * P);\n", "")],
    "no_states": [("        state_in_order<P, N>(Xf, Bs, hv + 2 * qp, q, tid - kHalf, sh);\n", ";\n"),
                  ("      state_head<P, N>(xs, Bs, hv + 2 * qp, qt, warp, lane, sh);\n", "")],
}
RMSNORM_EDITS = {
    "eight_vectors_a_lane": [("constexpr int kMaxVecPerLane = 2;", "constexpr int kMaxVecPerLane = 8;")],
    "block_of_128_a_row": [("  int t = 32;\n", "  int t = 128;\n")],
    "one_warp_a_block": [("constexpr int kBlockThreads = 256;", "constexpr int kBlockThreads = 32;")],
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


def ssd_variants(libs: dict) -> None:
    from repro_torch.kernels.ssd import _DTYPES, ssd_chunk_plain

    names = ["committed", *SSD_EDITS, *SSD_STOPS]
    for n in names:
        libs[f"ssd_{n}"].ssd_chunk_fwd.argtypes = _build.SIGNATURES["ssd_chunk_fwd"]
    serve_lengths = [16, 0, 5, 16, 1, 0, 9, 16, 16, 3, 16, 0, 12, 16, 7, 16]
    shapes = [("eval_8x512", 8, 4, 128, torch.bfloat16, None),
              ("eval_2x4096", 2, 32, 128, torch.bfloat16, None),
              ("serve_prefill", 16, 1, 16, torch.bfloat16, serve_lengths),
              ("eval_8x512", 8, 4, 128, torch.float32, None)]
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
        t = c.tol(dtype)
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
    against the plain chunked scan (fp32 FMA in order) for the committed
    kernel and for the plain scan with its two products (C.B^T, M.x) in
    float64, rounded once: how far a rounding other than the plain one
    moves them against the eval gate."""
    import repro_torch.models.ssm as ssm
    from repro_torch.models import Model, ModelRuntime
    from repro_torch.train.data import DataConfig, SyntheticLM

    einsum = torch.einsum

    def einsum_f64(eq, *ops):
        if eq in ("bcqkh,bckhp->bcqhp", "bcqn,bckn->bcqk"):
            return einsum(eq, *(o.double() for o in ops)).float()
        return einsum(eq, *ops)

    cfg, params_cpu = c.ssm_weights()
    params = c.cast_params(params_cpu, torch.bfloat16, "cuda")
    del params_cpu
    gate = c.SSM_LOGIT_TOL[torch.bfloat16]
    for b, s in c.EVAL_SHAPES:
        tokens = SyntheticLM(cfg, DataConfig(seq_len=s, global_batch=b, seed=1234),
                             device="cuda").batch(0)["tokens"]
        plain = Model(cfg, ModelRuntime(dtype=torch.bfloat16, use_ssd_kernel=False))
        kern = Model(cfg, ModelRuntime(dtype=torch.bfloat16, use_ssd_kernel=True))
        with torch.no_grad():
            base = plain.forward(params, tokens).float()
            got = {}
            ssm.torch.einsum = einsum_f64
            try:
                got["plain_scan_f64_products"] = plain.forward(params, tokens).float()
            finally:
                ssm.torch.einsum = einsum
            got["committed"] = kern.forward(params, tokens).float()
        for name, out in got.items():
            d = (out - base).abs()
            c.emit({"what": "ssd_logits", "at": f"bf16_{b}x{s}", "route": name,
                    "against": "plain chunked scan", "max_abs": d.max().item(),
                    "mean_abs": d.mean().item(),
                    "worst_over_gate": (d / (gate + gate * base.abs())).max().item()})
        del base, got


def rmsnorm_variants(libs: dict) -> None:
    from repro_torch.kernels.rmsnorm import rmsnorm_plain

    names = ["committed", *RMSNORM_EDITS]
    for n in names:
        libs[f"rmsnorm_{n}"].rmsnorm_fwd.argtypes = _build.SIGNATURES["rmsnorm_fwd"]
    gen = torch.Generator(device="cuda").manual_seed(22)
    for rows, d in ((16, 768), (256, 768), (16, 2048), (256, 2048)):
        x = torch.randn((rows, d), generator=gen, device="cuda").bfloat16()
        w = (torch.randn((d,), generator=gen, device="cuda") + 1.0).bfloat16()
        out = torch.empty_like(x)

        def call(lib):
            status = lib.rmsnorm_fwd(1, 1, x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, d,
                                     1e-5, torch.cuda.current_stream().cuda_stream)
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


GROUPS = ("flash", "decode", "ssd", "rmsnorm", "mma", "ssd_logits")


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
    if "decode" in groups:
        paged = source("paged_attention.cu")
        sources["paged_committed"] = paged
        sources.update({f"paged_{n}": substitute(paged, e) for n, e in DECODE_STOPS.items()})
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
                      ("ssd", ssd_variants), ("rmsnorm", rmsnorm_variants),
                      ("ssd_logits", ssd_logits)):
        if group in groups:
            fn(libs)
    if "mma" in groups:
        mma_ceilings(libs["mma"])
    print(c.smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
