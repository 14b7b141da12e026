"""Smoke run of the PyTorch/CUDA port on one GPU: builds the hand-written
kernels, holds each against its plain PyTorch version, drives the serving
engine (paged and dense caches), training, eval and the SSM family at full
width and prints what it measured.

    python3 chip_smoke.py

Phases, each printing one JSON line:

- ``env``: torch/CUDA versions, ``nvcc --version``, whether ``triton``
  imports, the card's name and power limit;
- ``build``: compiles ``src/repro_torch/kernels/csrc/*.cu`` (one ``nvcc``
  per source, in parallel) into ``build/kernels/``;
- ``kernels``: each kernel against its plain version on the card, f32
  (atol/rtol 2e-5) and bf16 (2e-2): paged attention over the serving
  slice's shapes and the GQA/MQA/MLA/softcap/verify/aliased/parked cases,
  and its bf16 tensor-core path's edges (G*T 16 at pages of 8-64 with
  offsets 0 and straddling a page, G 2 x T 16, a ragged G 3 x T 8 fold,
  dk = dv = 128, a parked row held exactly zero, aliased first pages,
  softcap 30; each record names the path), its split-KV decode path's
  edges in f32 and bf16 (the ``dec_*`` cases: one row over 1 and 4096
  keys, mixed long and short rows, pages of 8 and 64, softcap 30 at T 1,
  a G 2 x T 4 fold, GQA G 8 at dk 128, a parked row beside aliased first
  pages), RMSNorm (and its gradient;
  d = 768 and mamba2's 2048), flash attention over the reference's sweep,
  sliding windows, the model layout, and in both dtypes the eval phase's
  shapes and the kernels' edges (S 192 and 320 with a ragged last tile,
  S 1216 with a ragged last 192-row one, ``sq != skv``, windows 32
  and 128, hd 128 and 192), and
  the SSD chunk kernel over the reference's
  sweep, chunks of 1-16 positions, the serve prefill shape with padded
  tokens and idle rows, mamba2's eval shapes, and ``ops.ssd`` from a
  carried state (final state at 1e-4);
- ``parity``: full-width ``ds-paper-100m`` in f32 from seed 0, the engine
  on ``cuda`` (kernel path) against the same engine on ``cpu`` (plain
  path), in paged mode (12 paged-attention launches per dispatch, none on
  the bf16 tensor-core path, 12 per decode dispatch on the decode path,
  and 25 RMSNorm) and in dense mode, now the
  engine's default as in the reference (25 RMSNorm, no paged launch):
  equal greedy tokens (a near-tie below 1e-3 of the CPU's top-2 logit gap
  is the one allowed exception) and counters, and dense tokens equal to
  paged ones;
- ``serve``: full width in bf16, paged, 32 requests, tokens/s,
  per-dispatch times from CUDA events, peak memory, 12 tensor-core paged
  launches per prefill dispatch, 12 decode-path ones per decode dispatch
  and none on the CUDA-core path, and each kernel at the decode and
  prefill shapes (the paged kernel also at ``decode_long``: 16 rows of
  2048-4096 keys, and on its CUDA-core path at parity's f32 chunk-extend
  shape: 4 rows of 16 tokens, 8 pages a slot), held against its plain
  version and timed beside its bound, its plain version and one PyTorch
  call as a yardstick (RMSNorm also beside an empty launch through the
  same library, ``launch_floor_ms``);
- ``profile``: 16 decode dispatches at the serve shape timed on the host
  clock, then 16 more traced with ``torch.profiler``: device busy time,
  idle share against the unprofiled wall time, top device ops;
- ``train_parity``: full-width f32 training at 4 of the 12 layers (the
  depth cut keeps its CPU side short), 2 x 128 tokens, 2 AdamW steps on
  the card against the same steps on the CPU from the same weights and
  batches (loss, grad norm, parameters), once as one batch and once as 2
  microbatches with int8 stochastic-rounding accumulation;
- ``train``: full width in f32, 8 x 512 tokens, 20 steps through the span
  runner into a checkpoint, resumed for 2 more and held against an
  uninterrupted 22-step run: losses, step times, tokens/s, peak memory,
  and one step traced with ``torch.profiler``;
- ``eval``: full-width forward through the eval runner in bf16 and f32
  at 8 x 512 and 2 x 4096: tokens/s, 12 flash and 25 RMSNorm launches
  per forward, logits with the flash kernel against direct attention, a
  traced forward, and the flash kernel timed beside its bound (f32: three
  TF32 passes, its route, with the CUDA-core figure beside it), its plain
  version and ``F.scaled_dot_product_attention``;
- ``ssm_weights``: full-width ``mamba2-1.3b`` (48 layers, d_model 2048,
  1.35 B parameters) drawn once from seed 0 on the host, reused below;
- ``ssm_parity``: f32, the dense-cache engine on the card against the
  same engine on the CPU: equal greedy tokens and counters, 48 SSD
  launches per prefill dispatch, none per decode dispatch, 49 RMSNorm per
  dispatch;
- ``ssm_serve``: bf16, dense cache, 32 requests: tokens/s, per-dispatch
  times, peak memory, 16 decode dispatches traced, the SSD kernel at the
  serve prefill shape and RMSNorm at d = 2048 timed beside their bounds;
- ``ssm_eval``: the eval runner on a bf16 checkpoint of the same weights
  written with the port's ``save_state``, bf16 and f32 at 8 x 512 and
  2 x 4096: finite loss, 48 SSD and 49 RMSNorm launches per forward,
  logits with the SSD kernel against the plain chunked scan, a traced
  forward, and the SSD kernel timed at both shapes beside its bound
  (``bound_route``: f32 on the route it takes, C.B^T on the CUDA cores
  and the rest 3xTF32; bf16 on the tensor cores, though the kernel takes
  bf16 in order on the CUDA cores), the CUDA-core figure beside it.

Then a ``kernels`` summary line (the paged kernel's launches also per
path), the card's ``nvidia-smi`` name and power
limit, and last ``{"ok": true, "device": {...}}``.  Any failed check
exits non-zero before the last line.  Needs one CUDA device; exits
non-zero without a result when there is none or when run outside a
checkout of the repository.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
F32_TOL = 2e-5
BF16_TOL = 2e-2
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor / fp32 non-tensor
TF32_OPS = 494.7e12  # dense TF32 tensor cores


class CheckFailed(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def release_device_memory() -> None:
    """Free what earlier phases left (an engine and its scheduler reference
    each other, so only the cycle collector frees an engine's parameters
    and cache) before a phase reads its peak memory."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"


# ------------------------------------------------------------------ env / build
def phase_env() -> dict:
    from repro_torch.kernels import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60)
    try:
        import triton  # noqa: F401

        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    rec = {
        "phase": "env",
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvcc": nvcc.stdout.strip().splitlines()[-1] if nvcc.stdout else None,
        "triton": triton_version,
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smi_line(),
    }
    emit(rec)
    return rec


def phase_build(verbose: bool = False) -> dict:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    path = _build.build(verbose=verbose)
    _build.library()
    rec = {"phase": "build", "seconds": time.perf_counter() - t0,
           "library": str(path.relative_to(ROOT))}
    emit(rec)
    return rec


# ------------------------------------------------------------------ kernel checks
def tol(dtype) -> float:
    return BF16_TOL if dtype == torch.bfloat16 else F32_TOL


def paged_inputs(*, B, hkv, g, T, dk, ps, P, offsets, dtype, seed, dv_store=None,
                 shared_kv=False, n_pages=None, alias=False, parked=()):
    """Random pools and a page table backing each row's positions
    [0, offsets[b] + T) with distinct physical pages (the allocator
    invariant), sentinel elsewhere; ``alias`` maps every row's first page
    to one physical page; ``parked`` rows hold only sentinels."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    need = [-(-(int(o) + T) // ps) for o in offsets]
    n_pages = n_pages or sum(need) + 3
    dv_store = dv_store or dk
    kp = torch.randn((n_pages, ps, hkv, dk), generator=gen, device="cuda").to(dtype)
    vp = kp if shared_kv else torch.randn(
        (n_pages, ps, hkv, dv_store), generator=gen, device="cuda").to(dtype)
    perm = torch.randperm(n_pages, generator=gen, device="cuda").tolist()
    table = torch.full((B, P), n_pages, dtype=torch.int32)
    shared = perm.pop()
    for b in range(B):
        if b in parked:
            continue
        for j in range(need[b]):
            table[b, j] = shared if (alias and j == 0) else perm.pop()
    q = torch.randn((B, hkv, g * T, dk), generator=gen, device="cuda").to(dtype)
    return q, kp, vp, table.cuda(), torch.as_tensor(offsets, dtype=torch.int32).cuda()


def paged_cases():
    """(name, kwargs for paged_inputs, softcap, v_width)."""
    ragged4 = [0, 37, 130, 500]
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        d = {"dtype": dtype}
        tag = "f32" if dtype == torch.float32 else "bf16"
        cases += [
            (f"slice_decode_{tag}", dict(B=4, hkv=12, g=1, T=1, dk=64, ps=16, P=40,
                                         offsets=ragged4, seed=1, **d), 0.0, 0),
            (f"slice_prefill_{tag}", dict(B=4, hkv=12, g=1, T=16, dk=64, ps=16, P=40,
                                          offsets=[0, 32, 128, 480], seed=2, **d), 0.0, 0),
            (f"gqa_{tag}", dict(B=3, hkv=8, g=8, T=1, dk=128, ps=16, P=40,
                                offsets=[5, 300, 77], seed=3, **d), 0.0, 0),
            (f"mqa_{tag}", dict(B=2, hkv=1, g=48, T=1, dk=128, ps=16, P=40,
                                offsets=[200, 9], seed=4, **d), 0.0, 0),
            (f"mla_{tag}", dict(B=2, hkv=1, g=16, T=1, dk=576, ps=16, P=40,
                                offsets=[150, 31], seed=5, shared_kv=True, **d), 0.0, 512),
            (f"softcap30_{tag}", dict(B=3, hkv=12, g=1, T=16, dk=64, ps=16, P=40,
                                      offsets=[0, 48, 200], seed=6, **d), 30.0, 0),
            (f"verify_T5_{tag}", dict(B=3, hkv=8, g=8, T=5, dk=128, ps=16, P=40,
                                      offsets=[17, 0, 250], seed=7, **d), 0.0, 0),
            (f"aliased_{tag}", dict(B=3, hkv=12, g=1, T=1, dk=64, ps=16, P=40,
                                    offsets=[20, 20, 40], seed=8, alias=True, **d), 0.0, 0),
            (f"parked_{tag}", dict(B=3, hkv=12, g=1, T=1, dk=64, ps=16, P=40,
                                   offsets=[20, 33, 70], seed=9, parked=(1,), **d), 0.0, 0),
            # pages smaller and larger than the kernel's 32-key tile
            (f"page8_{tag}", dict(B=3, hkv=12, g=1, T=16, dk=64, ps=8, P=80,
                                  offsets=[0, 9, 300], seed=10, **d), 0.0, 0),
            (f"page64_{tag}", dict(B=3, hkv=8, g=8, T=1, dk=128, ps=64, P=10,
                                   offsets=[0, 70, 400], seed=11, **d), 0.0, 0),
        ]
    # the bf16 tensor-core path's edges (G*T >= 16, dk and dv in {64, 128}):
    # page sizes 8-64 with offsets 0 and straddling a page, 32 and a ragged
    # 24 folded rows, dk = dv = 128, a parked row, aliased first pages
    bf = {"dtype": torch.bfloat16}
    for ps in (8, 16, 32, 64):
        cases.append((f"tc_page{ps}_bf16", dict(B=3, hkv=4, g=1, T=16, dk=64, ps=ps, P=8,
                                                offsets=[0, ps // 2 + 3, 5 * ps - 7],
                                                seed=30 + ps, **bf), 0.0, 0))
    cases += [
        ("tc_g2_t16_bf16", dict(B=3, hkv=6, g=2, T=16, dk=64, ps=16, P=40,
                                offsets=[0, 21, 300], seed=31, **bf), 0.0, 0),
        ("tc_g3_t8_ragged24_bf16", dict(B=3, hkv=4, g=3, T=8, dk=64, ps=16, P=40,
                                        offsets=[3, 40, 129], seed=32, **bf), 0.0, 0),
        ("tc_dk128_bf16", dict(B=2, hkv=4, g=1, T=16, dk=128, ps=16, P=40,
                               offsets=[0, 77], seed=33, **bf), 0.0, 0),
        ("tc_parked_bf16", dict(B=3, hkv=12, g=1, T=16, dk=64, ps=16, P=40,
                                offsets=[20, 33, 70], seed=34, parked=(1,), **bf), 0.0, 0),
        ("tc_aliased_bf16", dict(B=3, hkv=12, g=1, T=16, dk=64, ps=16, P=40,
                                 offsets=[20, 20, 40], seed=35, alias=True, **bf), 0.0, 0),
        ("tc_softcap30_page8_bf16", dict(B=3, hkv=4, g=1, T=16, dk=64, ps=8, P=80,
                                         offsets=[0, 13, 200], seed=36, **bf), 30.0, 0),
    ]
    # the split-KV decode path's edges (G*T <= 8, dk and dv in {64, 128}),
    # both dtypes: one row (the fewest blocks) over 1 key and over 4096
    # keys (256 pages), long and short rows in one batch, pages of 8 and
    # 64, a softcap, a G 2 x T 4 fold, GQA G 8 at dk 128 over 4096 keys
    # (the gqa, page64, aliased and parked cases above take this path too)
    for dtype in (torch.float32, torch.bfloat16):
        d = {"dtype": dtype}
        tag = "f32" if dtype == torch.float32 else "bf16"
        cases += [
            (f"dec_b1_ctx1_{tag}", dict(B=1, hkv=12, g=1, T=1, dk=64, ps=16, P=8,
                                        offsets=[0], seed=40, **d), 0.0, 0),
            (f"dec_b1_ctx4096_{tag}", dict(B=1, hkv=12, g=1, T=1, dk=64, ps=16, P=256,
                                           offsets=[4095], seed=41, **d), 0.0, 0),
            (f"dec_ctx4096_mixed_{tag}", dict(B=4, hkv=12, g=1, T=1, dk=64, ps=16, P=256,
                                              offsets=[4095, 0, 2500, 130], seed=42, **d),
             0.0, 0),
            (f"dec_page8_{tag}", dict(B=3, hkv=12, g=1, T=1, dk=64, ps=8, P=80,
                                      offsets=[0, 9, 600], seed=43, **d), 0.0, 0),
            (f"dec_page64_{tag}", dict(B=3, hkv=12, g=1, T=1, dk=64, ps=64, P=10,
                                       offsets=[0, 70, 630], seed=44, **d), 0.0, 0),
            (f"dec_softcap30_{tag}", dict(B=3, hkv=12, g=1, T=1, dk=64, ps=16, P=40,
                                          offsets=[0, 48, 600], seed=45, **d), 30.0, 0),
            (f"dec_g2_t4_{tag}", dict(B=3, hkv=6, g=2, T=4, dk=64, ps=16, P=40,
                                      offsets=[0, 21, 300], seed=46, **d), 0.0, 0),
            (f"dec_gqa8_dk128_ctx4096_{tag}", dict(B=2, hkv=8, g=8, T=1, dk=128, ps=16, P=256,
                                                   offsets=[4095, 777], seed=47, **d), 0.0, 0),
            (f"dec_parked_aliased_{tag}", dict(B=4, hkv=12, g=1, T=1, dk=64, ps=16, P=40,
                                               offsets=[20, 33, 20, 400], seed=48, alias=True,
                                               parked=(1,), **d), 0.0, 0),
        ]
    # the parity engine's slots (max_len 128: 8 pages of 16), its own dtype
    cases += [
        ("parity_decode_f32", dict(B=4, hkv=12, g=1, T=1, dk=64, ps=16, P=8,
                                   offsets=[0, 37, 90, 127], seed=12, dtype=torch.float32),
         0.0, 0),
        ("parity_prefill_f32", dict(B=4, hkv=12, g=1, T=16, dk=64, ps=16, P=8,
                                    offsets=[0, 16, 48, 112], seed=13, dtype=torch.float32),
         0.0, 0),
    ]
    return cases


def check_paged_attention() -> dict:
    from repro_torch.kernels.flash_decode import (
        kernel_path,
        paged_flash_attention_folded,
        paged_flash_attention_folded_plain,
    )

    worst = {"float32": 0.0, "bfloat16": 0.0}
    for name, kw, softcap, v_width in paged_cases():
        q, kp, vp, table, offs = paged_inputs(**kw)
        T = kw["T"]
        scale = 1.0 / math.sqrt(kw["dk"])
        got = paged_flash_attention_folded(q, kp, vp, table, offs, tokens_per_row=T,
                                           scale=scale, softcap=softcap, v_width=v_width)
        torch.cuda.synchronize()
        want = paged_flash_attention_folded_plain(q, kp, vp, table, offs, tokens_per_row=T,
                                                  scale=scale, softcap=softcap,
                                                  v_width=v_width)
        err = (got.float() - want.float()).abs().max().item()
        t = tol(kw["dtype"])
        ok = bool(torch.allclose(got.float(), want.float(), atol=t, rtol=t))
        dv = v_width or vp.shape[-1]
        path = kernel_path(q.dtype, q.shape[2], q.shape[3], dv)
        rec = {"phase": "kernels", "kernel": "paged_attention", "case": name,
               "shape": list(q.shape), "page_size": kw["ps"], "path": path,
               "max_abs_err": err, "ok": ok}
        require(not name.startswith("dec_") or path == "decode",
                f"paged_attention case {name} did not take the decode path")
        if kw.get("parked"):
            zero = bool((got[list(kw["parked"])] == 0).all().item())
            rec["parked_rows_exact_zero"] = zero
            ok = ok and zero
        emit(rec)
        require(ok, f"paged_attention case {name} disagrees with its plain version")
        key = str(kw["dtype"]).removeprefix("torch.")
        worst[key] = max(worst[key], err)
    return worst


def check_rmsnorm() -> dict:
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain

    gen = torch.Generator(device="cuda").manual_seed(11)
    cases = [(r, d, dt, dt) for dt in (torch.float32, torch.bfloat16)
             for r in (1, 37, 4096) for d in (64, 768, 3840)]
    cases += [(37, 100, torch.bfloat16, torch.bfloat16), (37, 100, torch.float32, torch.float32),
              (37, 768, torch.bfloat16, torch.float32)]
    cases += [(37, 768, torch.float32, "misaligned"), (37, 768, torch.bfloat16, "misaligned")]
    # mamba2-1.3b's width: a decode dispatch (16 rows) and a prefill one (16 x 16)
    cases += [(r, 2048, dt, dt) for dt in (torch.float32, torch.bfloat16) for r in (16, 256)]
    # widths past the compiled ones (qwen2-72b's 8192, nemotron-4-340b's 18432): the generic path
    cases += [(37, 8192, torch.float32, torch.float32), (37, 8192, torch.bfloat16, torch.bfloat16),
              (5, 18432, torch.bfloat16, torch.float32)]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for rows, d, xdt, wdt in cases:
        x = torch.randn((rows, d), generator=gen, device="cuda").to(xdt)
        misaligned = wdt == "misaligned"
        if misaligned:  # rows off the 16-byte grid take the scalar path
            x = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(rows, d)
            wdt = xdt
        w = (torch.randn((d,), generator=gen, device="cuda") + 1.0).to(wdt)
        got = rmsnorm(x, w, 1e-5)
        torch.cuda.synchronize()
        want = rmsnorm_plain(x, w, 1e-5)
        err = (got.float() - want.float()).abs().max().item()
        t = tol(xdt)
        ok = bool(torch.allclose(got.float(), want.float(), atol=t, rtol=t))
        emit({"phase": "kernels", "kernel": "rmsnorm", "rows": rows, "d": d,
              "x_dtype": str(xdt), "w_dtype": str(wdt), "misaligned": misaligned,
              "max_abs_err": err, "ok": ok})
        require(ok, f"rmsnorm rows={rows} d={d} {xdt} disagrees with its plain version")
        key = str(xdt).removeprefix("torch.")
        worst[key] = max(worst[key], err)
    return worst


def check_rmsnorm_grad() -> float:
    """The autograd wrapper's gradients on the card against autograd
    through the plain version (f32): the kernel's forward must not cut
    the graph."""
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain

    gen = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn((37, 768), generator=gen, device="cuda")
    w = torch.randn((768,), generator=gen, device="cuda") + 1.0
    g = torch.randn((37, 768), generator=gen, device="cuda")
    grads = []
    for fn in (rmsnorm, rmsnorm_plain):
        xx, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
        fn(xx, ww, 1e-5).backward(g)
        grads.append((xx.grad, ww.grad))
    err = max((a - b).abs().max().item() for a, b in zip(grads[0], grads[1]))
    ok = all(torch.allclose(a, b, atol=1e-4, rtol=1e-4) for a, b in zip(grads[0], grads[1]))
    emit({"phase": "kernels", "kernel": "rmsnorm", "case": "grad_f32", "max_abs_err": err,
          "ok": ok})
    require(ok, "rmsnorm's gradient on the card disagrees with autograd of its plain version")
    return err


def flash_cases():
    """(name, bh, s, hd, block, causal, window, dtype): the reference's sweep
    (tests/test_kernels.py::test_flash_attention_sweep), its sliding-window
    cases and the eval phase's timed shapes."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for bh, s, hd, block in ((2, 128, 64, 64), (1, 256, 128, 128), (3, 512, 64, 256),
                                 (2, 128, 192, 64)):
            for causal in (True, False):
                cases.append((f"sweep_{bh}x{s}x{hd}_b{block}_{'causal' if causal else 'full'}"
                              f"_{tag}", bh, s, hd, block, causal, 0, dtype))
        for window in (32, 128):
            cases.append((f"window{window}_{tag}", 2, 256, 64, 64, True, window, dtype))
    # the eval phase's shapes and each kernel's edges, in both dtypes: a
    # ragged last block of 128 rows (bf16 and f32 at hd 64), windows at S
    # 320, head widths 128 and 192 (wgmma: two and three 64-column slabs;
    # 3xTF32: one M-tile a warp, 64-row blocks, Q split as it is read), and
    # from 1024 queries on bf16 hd 64's 192-row blocks (three warpgroups): a
    # ragged last block of 64 rows, a window
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        cases.append((f"eval_8x512_{tag}", 96, 512, 64, 512, True, 0, dtype))
        cases.append((f"eval_2x4096_{tag}", 24, 4096, 64, 512, True, 0, dtype))
        for s, causal in ((192, True), (192, False), (320, True), (320, False)):
            cases.append((f"ragged_s{s}_{'causal' if causal else 'full'}_{tag}", 3, s, 64, 64,
                          causal, 0, dtype))
        for window in (32, 128):
            cases.append((f"window{window}_s320_{tag}", 2, 320, 64, 64, True, window, dtype))
        for hd in (128, 192):
            for causal in (True, False):
                cases.append((f"hd{hd}_s320_{'causal' if causal else 'full'}_{tag}", 2, 320, hd,
                              64, causal, 0, dtype))
        for causal in (True, False):
            cases.append((f"rows192_s1216_{'causal' if causal else 'full'}_{tag}", 2, 1216, 64,
                          64, causal, 0, dtype))
        cases.append((f"rows192_window128_s1216_{tag}", 2, 1216, 64, 64, True, 128, dtype))
    return cases


# (name, bh, sq, skv, hd, causal): queries and keys of different lengths
# (positions count from 0 in both)
FLASH_SQ_NE_SKV = [(f"sq{sq}_skv{skv}", 2, sq, skv, 64, causal)
                   for sq, skv in ((128, 320), (320, 192), (1216, 1024))
                   for causal in (True, False)]


def check_flash_attention() -> dict:
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import (
        flash_attention_bhsd,
        flash_attention_bhsd_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(13)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for name, bh, s, hd, block, causal, window, dtype in flash_cases():
        q, k, v = (torch.randn((bh, s, hd), generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        got = flash_attention_bhsd(q, k, v, causal=causal, window=window, block_q=block,
                                   block_k=block)
        torch.cuda.synchronize()
        want = flash_attention_bhsd_plain(q, k, v, causal=causal, window=window)
        err = (got.float() - want.float()).abs().max().item()
        t = tol(dtype)
        ok = bool(torch.allclose(got.float(), want.float(), atol=t, rtol=t))
        emit({"phase": "kernels", "kernel": "flash_attention", "case": name,
              "shape": [bh, s, hd], "max_abs_err": err, "ok": ok})
        require(ok, f"flash_attention case {name} disagrees with its plain version")
        key = str(dtype).removeprefix("torch.")
        worst[key] = max(worst[key], err)
    for name, bh, sq, skv, hd, causal in FLASH_SQ_NE_SKV:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((bh, sq, hd), generator=gen, device="cuda").to(dtype)
            k, v = (torch.randn((bh, skv, hd), generator=gen, device="cuda").to(dtype)
                    for _ in range(2))
            got = flash_attention_bhsd(q, k, v, causal=causal, block_q=64, block_k=64)
            torch.cuda.synchronize()
            want = flash_attention_bhsd_plain(q, k, v, causal=causal)
            err = (got.float() - want.float()).abs().max().item()
            ok = bool(torch.allclose(got.float(), want.float(), atol=tol(dtype), rtol=tol(dtype)))
            case = (f"{name}_{'causal' if causal else 'full'}_"
                    f"{'f32' if dtype == torch.float32 else 'bf16'}")
            emit({"phase": "kernels", "kernel": "flash_attention", "case": case,
                  "shape": [bh, sq, skv, hd], "max_abs_err": err, "ok": ok})
            require(ok, f"flash_attention case {case} disagrees with its plain version")
            key = str(dtype).removeprefix("torch.")
            worst[key] = max(worst[key], err)
    # operands at an offset off the 16-byte grid (the wrapper copies them)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(2 * 128 * 64 + 1, generator=gen, device="cuda").to(dtype)[1:]
                   .view(2, 128, 64) for _ in range(3))
        got = flash_attention_bhsd(q, k, v, causal=True)
        torch.cuda.synchronize()
        want = flash_attention_bhsd_plain(q, k, v, causal=True)
        err = (got.float() - want.float()).abs().max().item()
        ok = bool(torch.allclose(got.float(), want.float(), atol=tol(dtype), rtol=tol(dtype)))
        name = f"misaligned_{'f32' if dtype == torch.float32 else 'bf16'}"
        emit({"phase": "kernels", "kernel": "flash_attention", "case": name,
              "shape": [2, 128, 64], "max_abs_err": err, "ok": ok})
        require(ok, f"flash_attention case {name} disagrees with its plain version")
    # the model layout: (B, S, H, hd) folded to (B*H, S, hd) and back
    q, k, v = (torch.randn((2, 128, 4, 64), generator=gen, device="cuda") for _ in range(3))
    got = ops.flash_attention(q, k, v, causal=True, block_q=64, block_k=64)
    torch.cuda.synchronize()
    want = ref.ORACLES["flash_attention"](q, k, v, causal=True)
    err = (got - want).abs().max().item()
    ok = bool(torch.allclose(got, want, atol=F32_TOL, rtol=F32_TOL))
    emit({"phase": "kernels", "kernel": "flash_attention", "case": "model_layout_f32",
          "shape": list(q.shape), "max_abs_err": err, "ok": ok})
    require(ok, "flash_attention in the model layout disagrees with its oracle")
    worst["float32"] = max(worst["float32"], err)
    return worst


def ssd_inputs(b, nc, q, h, p, n, dtype, seed, lengths=None):
    """Random SSD chunk inputs on the card with the reference sweep's
    distributions (x, B, C ~ N(0, 1) in ``dtype``; dt = softplus(N(0, 1))
    and A = -exp(N(0, 1) / 2) in f32).  ``lengths`` gives each batch row's
    valid positions (one chunk): later ones get dt = 0, as the padded
    tokens of a prefill dispatch do.  Returns ``(x, dt, A, B, C)``."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, nc, q, h, p), generator=gen, device="cuda").to(dtype)
    dt = F.softplus(torch.randn((b, nc, q, h), generator=gen, device="cuda"))
    A = -torch.exp(torch.randn((h,), generator=gen, device="cuda") * 0.5)
    B = torch.randn((b, nc, q, n), generator=gen, device="cuda").to(dtype)
    C = torch.randn((b, nc, q, n), generator=gen, device="cuda").to(dtype)
    if lengths is not None:
        valid = torch.arange(q, device="cuda")[None, :] < torch.as_tensor(lengths, device="cuda")[:, None]
        dt = dt * valid[:, None, :, None]
    return x, dt, A, B, C


def ssd_cases():
    """(name, (b, nc, q, h, p, n), block_h, dtype, lengths): the reference's
    sweep (tests/test_kernels.py::test_ssd_kernel_sweep), short chunks
    (serving prefill picks divisors of prefill_chunk), the serve prefill
    shape with padded tokens and idle rows, and the eval shapes of
    mamba2-1.3b (8 x 512, 2 x 4096)."""
    serve_lengths = [16, 0, 5, 16, 1, 0, 9, 16, 16, 3, 16, 0, 12, 16, 7, 16]
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for b, l, h, p, n, chunk, bh in ((2, 64, 4, 16, 16, 16, 2), (1, 128, 8, 32, 32, 32, 4),
                                         (2, 256, 16, 64, 128, 128, 8)):
            cases.append((f"sweep_{b}x{l}_h{h}_p{p}_n{n}_q{chunk}_{tag}",
                          (b, l // chunk, chunk, h, p, n), bh, dtype, None))
        for q in (1, 2, 4, 7, 16):
            cases.append((f"q{q}_{tag}", (2, 3, q, 16, 64, 128), 8, dtype, None))
        cases.append((f"serve_prefill_padded_{tag}", (16, 1, 16, 64, 64, 128), 8, dtype,
                       serve_lengths))
        cases.append((f"eval_8x512_{tag}", (8, 4, 128, 64, 64, 128), 8, dtype, None))
        cases.append((f"eval_2x4096_{tag}", (2, 32, 128, 64, 64, 128), 8, dtype, None))
    return cases


# The kernel and its plain version take the same running sums and differ
# only in summation order: 2e-5 (f32) holds for Y_diag and the states.
# ops.ssd adds the inter-chunk scan, where a state carried over many
# chunks sums the per-chunk rounding differences: its final state is held
# at 1e-4 (the reference's own test holds it at 1e-3).
SSD_STATE_TOL = 1e-4


def check_ssd() -> dict:
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ssd import ssd_chunk, ssd_chunk_plain

    worst = {"float32": 0.0, "bfloat16": 0.0}
    for seed, (name, (b, nc, q, h, p, n), bh, dtype, lengths) in enumerate(ssd_cases()):
        x, dt, A, B, C = ssd_inputs(b, nc, q, h, p, n, dtype, 40 + seed, lengths)
        dA = dt * A
        y, st = ssd_chunk(x, dA, dt, B, C, block_h=bh)
        torch.cuda.synchronize()
        y_want, st_want = ssd_chunk_plain(x, dA, dt, B, C)
        err = max((y - y_want).abs().max().item(), (st - st_want).abs().max().item())
        t = tol(dtype)
        ok = bool(torch.allclose(y, y_want, atol=t, rtol=t)
                  and torch.allclose(st, st_want, atol=t, rtol=t))
        rec = {"phase": "kernels", "kernel": "ssd", "case": name,
               "shape": {"b": b, "nc": nc, "q": q, "h": h, "p": p, "n": n, "block_h": bh},
               "max_abs_err": err, "ok": ok}
        if lengths is not None:
            idle = [r for r, length in enumerate(lengths) if length == 0]
            zero = bool((y[idle] == 0).all().item() and (st[idle] == 0).all().item())
            rec["idle_rows_exact_zero"] = zero
            ok = ok and zero
        emit(rec)
        require(ok, f"ssd case {name} disagrees with its plain version")
        key = str(dtype).removeprefix("torch.")
        worst[key] = max(worst[key], err)
    # the model-layout op: kernel + inter-chunk glue from a carried state,
    # against the model's plain chunked scan
    gen = torch.Generator(device="cuda").manual_seed(60)
    for dtype in (torch.float32, torch.bfloat16):
        x, dt, A, B, C = ssd_inputs(2, 4, 64, 16, 64, 128, dtype, 61)
        x, dt = x.reshape(2, 256, 16, 64), dt.reshape(2, 256, 16)
        B, C = B.reshape(2, 256, 128), C.reshape(2, 256, 128)
        init = torch.randn((2, 16, 64, 128), generator=gen, device="cuda")
        y, final = ops.ssd(x, dt, A, B, C, chunk=64, initial_state=init)
        torch.cuda.synchronize()
        y_want, final_want = ref.ORACLES["ssd"](x, dt, A, B, C, 64, initial_state=init)
        t = tol(dtype)
        y_err = (y.float() - y_want.float()).abs().max().item()
        st_err = (final - final_want).abs().max().item()
        ok = bool(torch.allclose(y.float(), y_want.float(), atol=t, rtol=t)
                  and torch.allclose(final, final_want, atol=SSD_STATE_TOL, rtol=SSD_STATE_TOL))
        name = f"ops_initial_state_{'f32' if dtype == torch.float32 else 'bf16'}"
        emit({"phase": "kernels", "kernel": "ssd", "case": name, "shape": list(x.shape),
              "chunk": 64, "max_abs_err": y_err, "final_state_max_abs_err": st_err,
              "final_state_tol": SSD_STATE_TOL, "ok": ok})
        require(ok, f"ssd case {name} disagrees with the model's chunked scan")
        key = str(dtype).removeprefix("torch.")
        worst[key] = max(worst[key], y_err)
    return worst


def phase_kernels() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = {"paged_attention": check_paged_attention(), "rmsnorm": check_rmsnorm(),
            "flash_attention": check_flash_attention(), "ssd": check_ssd()}
    errs["rmsnorm"]["grad_float32"] = check_rmsnorm_grad()
    rec = {"phase": "kernels", "max_abs_err": errs,
           "launches_in_checks": read_launches()}
    emit(rec)
    return rec


# ------------------------------------------------------------------ parity
NEAR_TIE_GAP = 1e-3


def parity_requests(vocab: int):
    """6 greedy requests, ragged prompts of 5-70 tokens; p0 and p5 share a
    40-token prefix (p5 is admitted after p0 published it)."""
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(1)
    prefix = rng.integers(1, vocab, 40).tolist()
    tails = {0: 8, 5: 4}
    lengths = [48, 70, 23, 5, 61, 44]
    prompts = []
    for i, n in enumerate(lengths):
        if i in tails:
            prompts.append(prefix + rng.integers(1, vocab, tails[i]).tolist())
        else:
            prompts.append(rng.integers(1, vocab, n).tolist())
    return [Request(uid=f"p{i}", prompt=p, max_new_tokens=24) for i, p in enumerate(prompts)]


def next_token_logits(model, params, tokens, device) -> torch.Tensor:
    """Logits after ``tokens`` from a fresh one-row cache (paged where the
    architecture pages, dense otherwise)."""
    ps = 16
    pages = -(-(len(tokens) + 1) // ps)
    if model.supports_paged_cache:
        cache = model.init_cache(1, pages * ps, paged=True, page_size=ps, n_pages=pages,
                                 device=device)
        cache["page_table"].copy_(torch.arange(pages, dtype=torch.int32)[None])
    else:
        cache = model.init_cache(1, pages * ps, device=device)
    logits = None
    for s in range(0, len(tokens), ps):
        chunk = tokens[s:s + ps]
        tok = torch.tensor([chunk], dtype=torch.long, device=device)
        logits, _ = model.prefill_chunk(
            params, cache, tok, torch.tensor([s], device=device),
            torch.tensor([len(chunk)], device=device))
    return logits[0, :model.cfg.vocab_size].float()


def run_engine(model, params, reqs, device, **kw):
    from repro_torch.serving.engine import ServeEngine

    eng = ServeEngine(model, params, device=device, **kw)
    eng.submit(reqs)
    t0 = time.perf_counter()
    eng.run_to_completion()
    if device == "cuda":
        torch.cuda.synchronize()
    return eng, time.perf_counter() - t0


def launch_counters() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.flash_decode import paged_flash_attention_folded
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd import ssd_chunk

    return {"paged_attention": paged_flash_attention_folded, "rmsnorm": rmsnorm,
            "flash_attention": flash_attention_bhsd, "ssd": ssd_chunk}


def reset_launches():
    from repro_torch.kernels import flash_decode

    for fn in launch_counters().values():
        fn.launches = 0
    paged = flash_decode.paged_flash_attention_folded
    paged.launches_by_path = dict.fromkeys(flash_decode.PATHS, 0)


def read_launches() -> dict:
    """Launches per kernel, and the paged kernel's per path
    (``paged_attention_cuda_core``, ``paged_attention_tensor_core``,
    ``paged_attention_decode``)."""
    from repro_torch.kernels.flash_decode import paged_flash_attention_folded

    counts = {name: fn.launches for name, fn in launch_counters().items()}
    for path, n in paged_flash_attention_folded.launches_by_path.items():
        counts[f"paged_attention_{path}"] = n
    return counts


PARITY_COUNTERS = ("dispatches", "prefill_dispatches", "decode_dispatches", "tokens_emitted",
                   "prefix_hit_tokens", "peak_pages")


def compare_greedy(model, params_cpu, gpu, cpu, what: str) -> list:
    """Require equal finished requests and greedy outputs of two engine
    runs, a near-tie at the first difference (a CPU top-2 logit gap below
    ``NEAR_TIE_GAP``) being the one allowed exception; the divergences."""
    got = {r.uid: r.output for r in gpu.finished}
    want = {r.uid: r.output for r in cpu.finished}
    require(sorted(got) == sorted(want), f"{what}: the runs finished different requests")
    prompts = {r.uid: r.prompt for r in cpu.finished}
    divergences = []
    for uid in sorted(want):
        a, b = got[uid], want[uid]
        require(len(a) == len(b), f"{what}: {uid}: output lengths differ")
        k = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if k is None:
            continue
        lg = next_token_logits(model, params_cpu, prompts[uid] + b[:k], "cpu")
        top2 = torch.topk(lg, 2).values
        gap = float(top2[0] - top2[1])
        divergences.append({"uid": uid, "index": k, "cpu_top2_gap": gap})
        require(gap < NEAR_TIE_GAP,
                f"{what}: {uid}: the runs diverge at token {k} with a CPU top-2 gap of {gap}")
    return divergences


def compare_counters(a, b, what: str) -> dict:
    counters = {c: [getattr(a, c), getattr(b, c)] for c in PARITY_COUNTERS}
    for c, (g, h) in counters.items():
        require(g == h, f"{what}: counter {c} differs: {g} against {h}")
    return counters


def phase_parity() -> dict:
    """Full-width ds-paper-100m in f32, card against CPU, in paged mode
    (paged kernel, RMSNorm) and in dense mode (RMSNorm, plain attention
    over the per-slot cache), and dense against paged on the card."""
    from repro_torch.configs import get_arch
    from repro_torch.models import Model, ModelRuntime

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 parity: full-precision matmuls
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_arch("ds-paper-100m")
    model = Model(cfg, ModelRuntime(dtype=torch.float32))
    base = dict(max_batch=4, max_len=128, prefill_chunk=16)
    modes = {"paged": dict(base, page_size=16, cache_mode="paged"),
             "dense": dict(base, cache_mode="dense")}
    params_gpu = model.init(0, device="cuda")
    params_cpu = model.init(0, device="cpu")
    rec = {"phase": "parity", "arch": cfg.name, "dtype": "float32", "modes": {}}
    card = {}
    for mode, kw in modes.items():
        reset_launches()
        gpu, gpu_s = run_engine(model, params_gpu, parity_requests(cfg.vocab_size), "cuda", **kw)
        launches = read_launches()
        cpu, cpu_s = run_engine(model, params_cpu, parity_requests(cfg.vocab_size), "cpu", **kw)
        divergences = compare_greedy(model, params_cpu, gpu, cpu, f"parity {mode}")
        counters = compare_counters(gpu, cpu, f"parity {mode}, card against CPU")
        d = gpu.dispatches
        want_paged = cfg.n_layers * d if mode == "paged" else 0
        require(launches["paged_attention"] == want_paged,
                f"{mode}: paged attention launched {launches['paged_attention']} times for "
                f"{d} dispatches")
        require(launches["rmsnorm"] == (2 * cfg.n_layers + 1) * d,
                f"{mode}: rmsnorm launched {launches['rmsnorm']} times for {d} dispatches")
        require(launches["paged_attention_tensor_core"] == 0,
                f"{mode}: f32 paged attention took the bf16 tensor-core path")
        # f32 decode dispatches (G*T 1) run the split-KV decode path, f32
        # prefill (G*T 16) the CUDA-core one
        want_decode = cfg.n_layers * gpu.decode_dispatches if mode == "paged" else 0
        require(launches["paged_attention_decode"] == want_decode,
                f"{mode}: decode-path paged launches {launches['paged_attention_decode']} != "
                f"{want_decode} (12 per decode dispatch)")
        if mode == "paged":
            require(gpu.prefix_hit_tokens > 0, "the shared prefix was never hit")
        card[mode] = gpu
        rec["modes"][mode] = {
            "tokens_equal": not divergences, "divergences": divergences,
            "counters_card_cpu": counters, "launches": launches,
            "launches_per_dispatch": {k: v / d for k, v in launches.items()},
            "card_s": gpu_s, "cpu_s": cpu_s}
    rec["dense_vs_paged_divergences"] = compare_greedy(
        model, params_cpu, card["dense"], card["paged"], "parity, dense against paged")
    emit(rec)
    return rec


# ------------------------------------------------------------------ serve
def serve_requests(vocab: int):
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(2)
    return [Request(uid=f"s{i}", prompt=rng.integers(1, vocab, int(n)).tolist(),
                    max_new_tokens=64)
            for i, n in enumerate(rng.integers(128, 513, 32))]


class DispatchTimer:
    """Wraps an engine dispatch callable; records CUDA events around each
    call (the device time between the dispatch's first and last queued
    work, host gaps included)."""

    def __init__(self, fn):
        self.fn, self.events = fn, []

    def __call__(self, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(*args)
        end.record()
        self.events.append((start, end))
        return out

    def ms(self):
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


def summary(xs):
    xs = sorted(xs)
    if not xs:
        return {"n": 0}
    return {"n": len(xs), "median": xs[(len(xs) - 1) // 2],
            "p99": xs[(99 * len(xs) - 1) // 100], "mean": sum(xs) / len(xs)}


def time_ms(fn, iters: int = 30) -> float:
    """Median device time of one call.  Each call runs behind a 64 MiB
    write that evicts the 50 MB L2 (the main path finds a layer's pages
    cold) and a ~1 ms device spin, so the host has queued the whole call
    before its start event fires and host launch overhead is not timed."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sorted(s.elapsed_time(e) for s, e in pairs)[iters // 2]


def paged_work(q, kp, table, offs, T, dv):
    """Bytes the paged-attention call must move and the flops it must do
    for these inputs: q and out once, plus every attended K/V page once;
    scores and values over the keys each query may see."""
    b, hkv, ql, dk = q.shape
    n_pages, ps = kp.shape[0], kp.shape[1]
    item = q.element_size()
    tab, off = table.cpu().tolist(), offs.cpu().tolist()
    pages = 0
    flops = 0
    for r in range(b):
        last = off[r] + T - 1
        pages += sum(1 for j, pid in enumerate(tab[r]) if j * ps <= last and 0 <= pid < n_pages)
        keys = sum(off[r] + (i % T) + 1 for i in range(ql))
        flops += 2 * (dk + dv) * keys * hkv
    nbytes = (q.numel() + b * hkv * ql * dv) * item + pages * ps * hkv * (dk + dv) * item
    nbytes += table.numel() * 4 + offs.numel() * 4
    return nbytes, flops


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_at_shape(what: str, kern, plain, dtype) -> float:
    """Hold a kernel against its plain version on the timed inputs; the
    max abs error, or a failed check."""
    got = kern()
    torch.cuda.synchronize()
    want = plain()
    err = (got.float() - want.float()).abs().max().item()
    t = tol(dtype)
    require(bool(torch.allclose(got.float(), want.float(), atol=t, rtol=t)),
            f"{what} disagrees with its plain version at the serve shape (max err {err})")
    return err


def time_paged(label, B, T, offsets, dtype, P=40):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import (
        kernel_path,
        paged_flash_attention_folded,
        paged_flash_attention_folded_plain,
    )

    hkv, dk, ps = 12, 64, 16
    q, kp, vp, table, offs = paged_inputs(B=B, hkv=hkv, g=1, T=T, dk=dk, ps=ps, P=P,
                                          offsets=offsets, dtype=dtype, seed=21)
    scale = 1.0 / math.sqrt(dk)
    kern = lambda: paged_flash_attention_folded(  # noqa: E731
        q, kp, vp, table, offs, tokens_per_row=T, scale=scale)
    plain = lambda: paged_flash_attention_folded_plain(  # noqa: E731
        q, kp, vp, table, offs, tokens_per_row=T, scale=scale)
    # yardstick: SDPA on K/V pre-gathered to a contiguous (B, H, P*ps, dk)
    # cache with a boolean mask (the gather is not timed)
    safe = table.long().clamp(max=kp.shape[0] - 1)
    kc = kp[safe].reshape(B, P * ps, hkv, dk).transpose(1, 2).contiguous()
    vc = vp[safe].reshape(B, P * ps, hkv, dk).transpose(1, 2).contiguous()
    q_pos = offs.long()[:, None] + torch.arange(T, device="cuda")[None]
    alloc = torch.repeat_interleave(table < kp.shape[0], ps, dim=1)
    mask = ((torch.arange(P * ps, device="cuda")[None, None] <= q_pos[..., None])
            & alloc[:, None])[:, None]
    lib = lambda: F.scaled_dot_product_attention(q, kc, vc, attn_mask=mask)  # noqa: E731
    nbytes, flops = paged_work(q, kp, table, offs, T, dk)
    bms, by = bound(nbytes, flops, dtype)
    err = check_at_shape(f"paged attention ({label})", kern, plain, dtype)
    return {"at": label, "shape": {"B": B, "Hkv": hkv, "G": 1, "T": T, "dk": dk,
                                   "page_size": ps, "pages_per_slot": P},
            "path": kernel_path(dtype, T, dk, dk), "max_abs_err": err,
            "ms": time_ms(kern), "plain_ms": time_ms(plain), "bound_ms": bms,
            "bound_by": by, "library_ms": time_ms(lib),
            "library_call": "F.scaled_dot_product_attention on pre-gathered contiguous K/V"}


def time_rmsnorm(label, rows, d, dtype):
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain

    gen = torch.Generator(device="cuda").manual_seed(22)
    x = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((d,), generator=gen, device="cuda") + 1.0).to(dtype)
    nbytes = 2 * rows * d * x.element_size() + d * w.element_size()
    bms, by = bound(nbytes, 4 * rows * d, dtype)
    err = check_at_shape(f"rmsnorm ({label})", lambda: rmsnorm(x, w, 1e-5),
                         lambda: rmsnorm_plain(x, w, 1e-5), dtype)
    return {"at": label, "shape": {"rows": rows, "d": d}, "max_abs_err": err,
            "ms": time_ms(lambda: rmsnorm(x, w, 1e-5)),
            "plain_ms": time_ms(lambda: rmsnorm_plain(x, w, 1e-5)),
            "bound_ms": bms, "bound_by": by,
            "library_ms": time_ms(lambda: F.rms_norm(x, (d,), w, 1e-5)),
            "library_call": "F.rms_norm", "launch_floor_ms": time_launch_floor()}


def time_launch_floor() -> float:
    """An empty kernel launched through the kernel library on the current
    stream, timed as the kernels are: the floor of a launch on this path."""
    from repro_torch.kernels import _build

    lib = _build.library()
    return time_ms(lambda: _build.check(
        lib.empty_launch(torch.cuda.current_stream().cuda_stream), "empty_launch"))


def phase_serve() -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.models import Model, ModelRuntime
    from repro_torch.serving.engine import Request

    cfg = get_arch("ds-paper-100m")
    dtype = torch.bfloat16
    model = Model(cfg, ModelRuntime(dtype=dtype))
    params = model.init(0, device="cuda")
    kw = dict(max_batch=16, max_len=640, prefill_chunk=16, page_size=16, cache_mode="paged")
    warm = [Request(uid=f"w{i}", prompt=list(range(1, 40 + i)), max_new_tokens=4)
            for i in range(2)]
    run_engine(model, params, warm, "cuda", **kw)

    from repro_torch.serving.engine import ServeEngine

    reqs = serve_requests(cfg.vocab_size)
    eng = ServeEngine(model, params, device="cuda", **kw)
    eng._decode, eng._prefill = DispatchTimer(eng._decode), DispatchTimer(eng._prefill)
    eng.submit(reqs)
    release_device_memory()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    outs = {r.uid: r.output for r in eng.finished}
    require(len(outs) == len(reqs), "not every serve request finished")
    require(all(len(o) == 64 and all(0 <= t < cfg.vocab_size for t in o) for o in outs.values()),
            "a serve request emitted a wrong number of tokens or an id outside the vocab")
    d = eng.dispatches
    require(launches["paged_attention"] == cfg.n_layers * d, "paged launches != 12/dispatch")
    # a prefill dispatch (16 rows of 16 tokens, G*T 16) runs the tensor-core
    # path, a decode dispatch (G*T 1) the split-KV decode one, and nothing
    # runs the CUDA-core path
    require(launches["paged_attention_tensor_core"] == cfg.n_layers * eng.prefill_dispatches,
            f"tensor-core paged launches {launches['paged_attention_tensor_core']} != 12 per "
            f"prefill dispatch ({eng.prefill_dispatches})")
    require(launches["paged_attention_decode"] == cfg.n_layers * eng.decode_dispatches,
            f"decode-path paged launches {launches['paged_attention_decode']} != 12 per "
            f"decode dispatch ({eng.decode_dispatches})")
    require(launches["paged_attention_cuda_core"] == 0,
            f"serve launched the CUDA-core paged path {launches['paged_attention_cuda_core']} "
            "times")
    require(launches["rmsnorm"] == (2 * cfg.n_layers + 1) * d, "rmsnorm launches != 25/dispatch")
    rec = {
        "phase": "serve", "arch": cfg.name, "dtype": "bfloat16", "requests": len(reqs),
        "prompt_tokens": sum(len(r.prompt) for r in reqs), "max_new_tokens": 64,
        "max_batch": 16, "page_size": 16, "wall_s": wall,
        "tokens_emitted": eng.tokens_emitted, "tokens_per_s": eng.tokens_emitted / wall,
        "dispatches": d, "prefill_dispatches": eng.prefill_dispatches,
        "decode_dispatches": eng.decode_dispatches,
        "decode_dispatch_ms": summary(eng._decode.ms()),
        "prefill_dispatch_ms": summary(eng._prefill.ms()),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "peak_pages": eng.peak_pages, "total_pages": eng.n_pages, "launches": launches,
    }
    rng = np.random.default_rng(3)
    rec["kernel_times"] = {
        "paged_attention": {
            "decode": time_paged("decode", 16, 1, rng.integers(128, 576, 16).tolist(), dtype),
            "prefill": time_paged("prefill", 16, 16,
                                  (16 * rng.integers(0, 32, 16)).tolist(), dtype),
            # long contexts on the decode path: 2048-4096 keys, 256 pages a slot
            "decode_long": time_paged("decode_long", 16, 1,
                                      rng.integers(2047, 4096, 16).tolist(), dtype, P=256),
            # the CUDA-core path at parity's f32 prefill: 4 rows of 16 tokens
            # at page-aligned offsets, 8 pages a slot (max_len 128)
            "f32_chunk_extend": time_paged("f32_chunk_extend", 4, 16, [0, 16, 32, 48],
                                           torch.float32, P=8),
        },
        "rmsnorm": {
            "decode": time_rmsnorm("decode", 16, cfg.d_model, dtype),
            "prefill": time_rmsnorm("prefill", 16 * 16, cfg.d_model, dtype),
        },
    }
    emit(rec)
    return rec


def trace(fn, reps: int, unit: str, watch: tuple = ()) -> dict:
    """Where the time of ``fn`` goes: ``reps`` calls timed on the host clock
    without the profiler, then ``reps`` more traced with torch.profiler.
    Device busy time is the sum of the traced kernels and copies (one
    stream); the idle share is 1 - busy / the unprofiled wall time, so the
    profiler's own host overhead is not counted as idle.  ``watch`` names
    substrings of device ops reported whether or not they are in the top
    8."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        profiled_wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    busy_ms = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {f"wall_ms_per_{unit}": wall_ms / reps,
            f"profiled_wall_ms_per_{unit}": profiled_wall_ms / reps,
            f"device_busy_ms_per_{unit}": busy_ms / reps,
            "device_idle_share": (1 - busy_ms / wall_ms) if dev else None,
            f"device_ops_per_{unit}": len(dev) / reps,
            "top_device_ops": [{"name": n[:80], f"ms_per_{unit}": v[0] / reps,
                                f"count_per_{unit}": v[1] / reps} for n, v in top],
            "watched_ops": {w: {f"ms_per_{unit}": sum(v[0] for n, v in by_name.items() if w in n)
                                / reps,
                                f"count_per_{unit}": sum(v[1] for n, v in by_name.items() if w in n)
                                / reps} for w in watch}}


def phase_profile() -> dict:
    """Where a decode dispatch's time goes at the serve shape: 16 rows
    decoding at once, 16 ticks timed and 16 traced (``trace``)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import Model, ModelRuntime
    from repro_torch.serving.engine import Request, ServeEngine

    cfg = get_arch("ds-paper-100m")
    model = Model(cfg, ModelRuntime(dtype=torch.bfloat16))
    params = model.init(0, device="cuda")
    rng = np.random.default_rng(4)
    eng = ServeEngine(model, params, device="cuda", max_batch=16, max_len=640,
                      prefill_chunk=16, page_size=16, cache_mode="paged")
    eng.submit([Request(uid=f"q{i}", prompt=rng.integers(1, cfg.vocab_size, 256).tolist(),
                        max_new_tokens=64) for i in range(16)])
    for _ in range(4):  # tick 1 drains every prompt; then warm decode ticks
        eng.step()
    d0 = eng.decode_dispatches
    ticks = 16
    traced = trace(eng.step, ticks, "dispatch")
    require(eng.decode_dispatches - d0 == 2 * ticks, "timed ticks were not all decode dispatches")
    rec = {"phase": "profile", "what": "decode dispatch, 16 rows, prompts 256", "ticks": ticks,
           **traced}
    emit(rec)
    return rec


# ------------------------------------------------------------------ training
def heartbeat_events(events: list):
    """A heartbeat for the job runners that records a CUDA event each
    time it is called (after a step's loss has reached the host)."""

    def beat(progress=None):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events.append(e)

    return beat


def event_intervals_ms(events: list) -> list:
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


# Tolerances of the card against the CPU, f32 on both (no TF32): losses and
# gradient norms differ only by summation order (rtol 1e-4).  A parameter
# moves by at most ~lr per Adam step, so a near-zero gradient whose sign
# differs between the devices moves it by at most 2 * (lr_1 + lr_2) =
# 9e-5 over the two steps (lr 1.5e-5 then 3e-5, the job defaults'
# warmup); parameters are held at atol 1e-4 + rtol 1e-4.
PARITY_RTOL = 1e-4
PARITY_PARAM_ATOL = 1e-4


def train_two_steps(job: dict, device: str, seq_len: int, batch: int):
    from repro_torch import prng
    from repro_torch.launch.train import build_model, build_train_step
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import init_opt_state

    model = build_model(job)
    step_fn, opt_cfg = build_train_step(job, model)
    data = SyntheticLM(model.cfg, DataConfig(seq_len=seq_len, global_batch=batch), device=device)
    params = model.init(0, device=device)
    opt = init_opt_state(params, opt_cfg)
    metrics = []
    for step in range(2):
        params, opt, met = step_fn(params, opt, data.batch(step), prng.PRNGKey(step, device=device))
        metrics.append({"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"])})
    return metrics, params


# train_parity runs 4 of ds-paper-100m's 12 layers at full width: at all 12
# its CPU side (2 x 2 full-width f32 steps, 135M-element threefry draws)
# took 55 s on the host of a one-H100 machine, the script's longest phase.
TRAIN_PARITY_LAYERS = 4


def phase_train_parity() -> dict:
    from repro_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs = {"one_batch": {}, "microbatches2_int8": {"microbatches": 2, "accum_dtype": "int8"}}
    rec = {"phase": "train_parity", "arch": "ds-paper-100m", "dtype": "float32",
           "layers": TRAIN_PARITY_LAYERS, "tokens": "2 x 128", "steps": 2, "rtol": PARITY_RTOL,
           "param_atol": PARITY_PARAM_ATOL, "runs": {}}
    for name, extra in runs.items():
        job = {"arch": "ds-paper-100m", "arch_overrides": {"n_layers": TRAIN_PARITY_LAYERS},
               **extra}
        t0 = time.perf_counter()
        reset_launches()
        card, card_params = train_two_steps(job, "cuda", 128, 2)
        card_launches = read_launches()["rmsnorm"]
        card_s = time.perf_counter() - t0
        card_params = [p.cpu() for p in tree_leaves(card_params)]
        t0 = time.perf_counter()
        cpu, cpu_params = train_two_steps(job, "cpu", 128, 2)
        cpu_s = time.perf_counter() - t0
        worst = 0.0
        for a, b in zip(card_params, tree_leaves(cpu_params)):
            worst = max(worst, (a - b).abs().max().item())
            require(bool(torch.allclose(a, b, atol=PARITY_PARAM_ATOL, rtol=PARITY_RTOL)),
                    f"train_parity {name}: parameters after 2 steps differ (max {worst})")
        for step, (c, h) in enumerate(zip(card, cpu)):
            for key in ("loss", "grad_norm"):
                require(math.isfinite(c[key]) and abs(c[key] - h[key]) <= PARITY_RTOL * abs(h[key]),
                        f"train_parity {name}: {key} at step {step} card {c[key]} cpu {h[key]}")
        # one forward and one backward per microbatch; norms run forward only
        per_step = (2 * TRAIN_PARITY_LAYERS + 1) * job.get("microbatches", 1)
        require(card_launches == 2 * per_step,
                f"rmsnorm launched {card_launches} times in 2 training steps")
        rec["runs"][name] = {"card": card, "cpu": cpu, "param_max_abs_err": worst,
                             "card_s": card_s, "cpu_s": cpu_s,
                             "rmsnorm_launches": card_launches}
    emit(rec)
    return rec


TRAIN_JOB = {"arch": "ds-paper-100m", "run": "smoke", "seq_len": 512, "global_batch": 8}


def phase_train(store_root: Path) -> dict:
    from repro_torch.core.storage import ObjectStore
    from repro_torch.launch.train import run_train_span
    from repro_torch.train.checkpoint import checkpoint_exists

    torch.backends.cuda.matmul.allow_tf32 = False
    store = ObjectStore(str(store_root / "interrupted"))
    events: list = []
    release_device_memory()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    first = run_train_span({**TRAIN_JOB, "start_step": 0, "num_steps": 20}, store,
                           heartbeat_events(events), device="cuda")
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    step_ms = event_intervals_ms(events)
    require(len(first["losses"]) == 20 and all(math.isfinite(x) for x in first["losses"]),
            "the 20 training losses are not all finite")
    require(checkpoint_exists(store, "smoke", 20), "no checkpoint at step 20")
    require(launches["rmsnorm"] == 20 * 25 and launches["flash_attention"] == 0,
            f"training launches {launches}: want 25 RMSNorm per step and no flash kernel")
    resumed = run_train_span({**TRAIN_JOB, "start_step": 20, "num_steps": 2}, store,
                             lambda progress=None: None, device="cuda")
    whole = run_train_span({**TRAIN_JOB, "start_step": 0, "num_steps": 22},
                           ObjectStore(str(store_root / "uninterrupted")),
                           lambda progress=None: None, device="cuda")
    for got, want in zip(first["losses"] + resumed["losses"], whole["losses"]):
        require(abs(got - want) <= PARITY_RTOL * abs(want),
                f"resumed training diverges from the uninterrupted run: {got} vs {want}")
    tokens = TRAIN_JOB["seq_len"] * TRAIN_JOB["global_batch"]
    med = summary(step_ms)["median"]
    rec = {"phase": "train", "arch": "ds-paper-100m", "dtype": "float32",
           "tokens_per_step": tokens, "losses": first["losses"],
           "resumed_losses": resumed["losses"], "uninterrupted_losses": whole["losses"][20:],
           "step_ms": summary(step_ms), "tokens_per_s": tokens / (med / 1e3),
           "max_memory_allocated_bytes": peak, "launches": launches,
           "profile": trace_train_step()}
    emit(rec)
    return rec


def trace_train_step() -> dict:
    """Where a full-width f32 train step's time goes (8 x 512 tokens, the
    span runner's step on its own: 3 steps timed, 3 traced)."""
    from repro_torch import prng
    from repro_torch.launch.train import build_model, build_train_step
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import init_opt_state

    model = build_model(TRAIN_JOB)
    step_fn, opt_cfg = build_train_step(TRAIN_JOB, model)
    batch = SyntheticLM(model.cfg, DataConfig(seq_len=TRAIN_JOB["seq_len"],
                                              global_batch=TRAIN_JOB["global_batch"]),
                        device="cuda").batch(0)
    state = {"params": model.init(0, device="cuda")}
    state["opt"] = init_opt_state(state["params"], opt_cfg)
    key = prng.PRNGKey(0, device="cuda")

    def one_step():
        state["params"], state["opt"], met = step_fn(state["params"], state["opt"], batch, key)
        float(met["loss"])

    one_step()  # warm
    return {"what": "f32 train step, 8 x 512 tokens", **trace(one_step, 3, "step")}


def flash_work(bh: int, s: int, hd: int, dtype) -> tuple:
    """Bytes (q, k, v read once, out written once) and causal flops
    (2 * BH * S^2 * hd: QK and PV over the lower triangle)."""
    item = torch.tensor([], dtype=dtype).element_size()
    return 4 * bh * s * hd * item, 2 * bh * s * s * hd


def time_flash(bh: int, s: int, dtype) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        flash_attention_bhsd,
        flash_attention_bhsd_plain,
    )

    hd = 64
    gen = torch.Generator(device="cuda").manual_seed(23)
    q, k, v = (torch.randn((bh, s, hd), generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    kern = lambda: flash_attention_bhsd(q, k, v, causal=True)  # noqa: E731
    plain = lambda: flash_attention_bhsd_plain(q, k, v, causal=True)  # noqa: E731
    # SDPA takes its fast kernels for (batch, heads, S, hd): the same folded
    # tensors with a unit batch axis
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q[None], k[None], v[None], is_causal=True)
    err = check_at_shape(f"flash attention ({bh}x{s})", kern, plain, dtype)
    nbytes, flops = flash_work(bh, s, hd, dtype)
    bms, by = bound(nbytes, flops, dtype)
    route = {"bound_route": "bf16 tensor cores, 989 TFLOP/s"}
    if dtype == torch.float32:
        # the f32 kernel runs 3xTF32 on the tensor cores: its bound is three
        # TF32 passes; the CUDA-core figure stands beside it
        route = {"bound_route": "3xTF32 tensor cores: 3 passes at 494.7 TFLOP/s",
                 "bound_ms_cuda_core": bms, "bound_by_cuda_core": by}
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 3 * flops / TF32_OPS
        bms, by = max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")
    return {"shape": {"BH": bh, "S": s, "hd": hd}, "dtype": str(dtype).removeprefix("torch."),
            "max_abs_err": err, "ms": time_ms(kern), "plain_ms": time_ms(plain, iters=10),
            "bound_ms": bms, "bound_by": by, **route, "library_ms": time_ms(lib),
            "library_call": "F.scaled_dot_product_attention(is_causal=True) on the folded "
                            "tensors viewed as (1, BH, S, hd)"}


EVAL_SHAPES = ((8, 512), (2, 4096))
# Logits with the flash kernel against direct attention: f32 differs by
# summation order only; in bf16 the direct path rounds its probabilities
# to bf16 before P.V (as the reference) while the kernel keeps fp32, and
# the difference compounds over 12 layers of bf16 activations.
EVAL_LOGIT_TOL = {torch.float32: 1e-3, torch.bfloat16: 1e-1}


def phase_eval(store_root: Path) -> dict:
    from repro_torch.core.storage import ObjectStore
    from repro_torch.launch.train import build_model, run_eval
    from repro_torch.models import Model, ModelRuntime
    from repro_torch.train.checkpoint import latest_step, restore_state
    from repro_torch.train.data import DataConfig, SyntheticLM

    torch.backends.cuda.matmul.allow_tf32 = False
    store = ObjectStore(str(store_root / "interrupted"))
    n_batches = 3
    rec = {"phase": "eval", "arch": "ds-paper-100m", "ckpt_step": latest_step(store, "smoke"),
           "runs": [], "kernel_times": []}
    for dtype, name in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        job = {**TRAIN_JOB, "dtype": name, "n_batches": n_batches}
        base = build_model(job)
        params, _ = restore_state(store, "smoke", rec["ckpt_step"], base.abstract_params(),
                                  device="cuda")
        for b, s in EVAL_SHAPES:
            events: list = []
            reset_launches()
            out = run_eval({**job, "seq_len": s, "global_batch": b}, store,
                           heartbeat_events(events), device="cuda")
            launches = read_launches()
            ms = event_intervals_ms(events)
            require(launches["flash_attention"] == 12 * n_batches
                    and launches["rmsnorm"] == 25 * n_batches,
                    f"eval {name} {b}x{s}: launches {launches}, want 12 flash and 25 RMSNorm "
                    "per forward")
            require(math.isfinite(out["loss"]), f"eval {name} {b}x{s}: loss not finite")
            batch = SyntheticLM(base.cfg, DataConfig(seq_len=s, global_batch=b, seed=1234),
                                device="cuda").batch(0)
            with torch.no_grad():
                logits = {impl: Model(base.cfg, ModelRuntime(dtype=dtype, attn_impl=impl))
                          .forward(params, batch["tokens"]) for impl in ("kernel", "direct")}
            err = (logits["kernel"] - logits["direct"]).abs().max().item()
            t = EVAL_LOGIT_TOL[dtype]
            require(bool(torch.isfinite(logits["kernel"]).all())
                    and bool(torch.allclose(logits["kernel"], logits["direct"], atol=t, rtol=t)),
                    f"eval {name} {b}x{s}: kernel logits differ from direct by {err}")
            del logits
            evaluator = Model(base.cfg, ModelRuntime(dtype=dtype))
            with torch.no_grad():
                profile = trace(lambda: float(evaluator.loss(params, batch)[0]), 3, "forward")
            rec["runs"].append({
                "dtype": name, "batch": b, "seq_len": s, "loss": out["loss"], "ppl": out["ppl"],
                "forward_ms": summary(ms), "tokens_per_s": b * s / (summary(ms)["median"] / 1e3),
                "launches": launches,
                "launches_per_forward": {k: v / n_batches for k, v in launches.items()},
                "logits_kernel_vs_direct_max_abs_err": err, "logits_tol": t,
                "profile": profile})
            rec["kernel_times"].append(time_flash(b * base.cfg.n_heads, s, dtype))
        del params
    emit(rec)
    return rec


# ------------------------------------------------------------------ the SSM family
SSM_ARCH = "mamba2-1.3b"


def ssm_weights():
    """Full-width mamba2-1.3b weights from seed 0, drawn once on the host
    in f32 and reused by every SSM phase (cast or moved as each needs)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import Model, ModelRuntime

    from repro_torch.tree import tree_leaves

    cfg = get_arch(SSM_ARCH)
    t0 = time.perf_counter()
    params = Model(cfg, ModelRuntime(dtype=torch.float32)).init(0, device="cpu")
    emit({"phase": "ssm_weights", "arch": cfg.name, "seconds": time.perf_counter() - t0,
          "parameters": sum(t.numel() for t in tree_leaves(params))})
    return cfg, params


def cast_params(params, dtype, device):
    """The tree on ``device`` in ``dtype``, the SSM's A_log, D and dt_bias
    kept float32 (as in the reference and ``Model.init``)."""
    from repro_torch.models.ssm import FP32_PARAMS
    from repro_torch.tree import tree_map_with_path

    return tree_map_with_path(
        lambda path, t: t.to(device=device,
                             dtype=torch.float32 if path[-1] in FP32_PARAMS else dtype),
        params)


def phase_ssm_parity(cfg, params_cpu) -> dict:
    """Full-width mamba2-1.3b in f32 from seed 0: the dense-cache engine on
    the card (SSD kernel at prefill, RMSNorm) against the same engine on
    the CPU (plain path): equal greedy tokens (the near-tie exception of
    ``phase_parity``) and counters; 48 SSD launches per prefill dispatch,
    none per decode dispatch, 49 RMSNorm per dispatch."""
    from repro_torch.models import Model, ModelRuntime

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = Model(cfg, ModelRuntime(dtype=torch.float32))
    kw = dict(max_batch=4, max_len=128, prefill_chunk=16, cache_mode="dense")
    params_gpu = cast_params(params_cpu, torch.float32, "cuda")
    reset_launches()
    gpu, gpu_s = run_engine(model, params_gpu, parity_requests(cfg.vocab_size), "cuda", **kw)
    launches = read_launches()
    del params_gpu
    cpu, cpu_s = run_engine(model, params_cpu, parity_requests(cfg.vocab_size), "cpu", **kw)
    divergences = compare_greedy(model, params_cpu, gpu, cpu, "ssm_parity")
    counters = compare_counters(gpu, cpu, "ssm_parity, card against CPU")
    L, d, pd = cfg.n_layers, gpu.dispatches, gpu.prefill_dispatches
    require(launches["ssd"] == L * pd,
            f"ssd launched {launches['ssd']} times for {pd} prefill dispatches")
    require(launches["rmsnorm"] == (L + 1) * d,
            f"rmsnorm launched {launches['rmsnorm']} times for {d} dispatches")
    require(launches["paged_attention"] == 0 and launches["flash_attention"] == 0,
            f"attention kernels launched in an SSM run: {launches}")
    rec = {"phase": "ssm_parity", "arch": cfg.name, "dtype": "float32", "layers": L,
           "cache_mode": "dense", "tokens_equal": not divergences, "divergences": divergences,
           "counters_card_cpu": counters, "launches": launches,
           "ssd_per_prefill_dispatch": launches["ssd"] / pd,
           "rmsnorm_per_dispatch": launches["rmsnorm"] / d, "card_s": gpu_s, "cpu_s": cpu_s}
    emit(rec)
    return rec


def ssd_work(b, nc, q, h, p, n, item) -> tuple:
    """Bytes (x, B, C in their type, dA and dt in f32 read once; Y_diag and
    the states written once in f32) and operations (2 per multiply-add of
    C.B^T and of Y_diag over the causal triangle, and of the states):
    ``(bytes, flops of C.B^T, flops of Y_diag and the states)``."""
    tri = q * (q + 1) // 2
    nbytes = (b * nc * q * (h * p + 2 * n) * item + 2 * b * nc * q * h * 4
              + b * nc * q * h * p * 4 + b * nc * h * p * n * 4)
    return nbytes, 2 * b * nc * tri * n, 2 * b * nc * (h * tri * p + h * q * p * n)


def ssd_bound(nbytes, s_flops, yst_flops, dtype) -> dict:
    """The kernel's bound: bf16, every product on the tensor cores at the
    card's bf16 peak (the kernel itself takes them in order on the fp32
    CUDA cores, the plain version's rounding, which mamba2's bf16 eval gate
    needs); f32, on the route it takes, C.B^T in order on the fp32 CUDA
    cores and Y_diag and the states as three TF32 passes on the tensor
    cores.  The all-CUDA-core figure (the bf16 route's own) stands beside
    it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    if dtype == torch.bfloat16:
        t_ops = (s_flops + yst_flops) / PEAK_OPS[torch.bfloat16]
        route = ("bf16 tensor cores (989 TFLOP/s); the kernel runs in-order fp32 FMA on the "
                 "CUDA cores: bound_ms_cuda_core")
    else:
        t_ops = max(s_flops / PEAK_OPS[torch.float32], 3 * yst_flops / TF32_OPS)
        route = ("C.B^T on the fp32 CUDA cores (67 TFLOP/s); Y_diag and states 3xTF32: "
                 "3 passes at 494.7 TFLOP/s")
    cc_ms, cc_by = bound(nbytes, s_flops + yst_flops, torch.float32)
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "bound_route": route,
            "bound_ms_cuda_core": cc_ms, "bound_by_cuda_core": cc_by}


def time_ssd(label, b, nc, q, dtype, lengths=None) -> dict:
    from repro_torch.kernels.ssd import ssd_chunk, ssd_chunk_plain

    h, p, n = 64, 64, 128  # mamba2-1.3b
    x, dt, A, B, C = ssd_inputs(b, nc, q, h, p, n, dtype, 70, lengths)
    dA = dt * A
    kern = lambda: ssd_chunk(x, dA, dt, B, C)  # noqa: E731
    plain = lambda: ssd_chunk_plain(x, dA, dt, B, C)  # noqa: E731
    got, want = kern(), None
    torch.cuda.synchronize()
    want = plain()
    err = max((got[0] - want[0]).abs().max().item(), (got[1] - want[1]).abs().max().item())
    t = tol(dtype)
    require(all(bool(torch.allclose(g, w, atol=t, rtol=t)) for g, w in zip(got, want)),
            f"ssd ({label}) disagrees with its plain version (max err {err})")
    del got, want
    bounds = ssd_bound(*ssd_work(b, nc, q, h, p, n, x.element_size()), dtype)
    return {"at": label, "shape": {"b": b, "nc": nc, "q": q, "h": h, "p": p, "n": n},
            "dtype": str(dtype).removeprefix("torch."), "max_abs_err": err,
            "ms": time_ms(kern), "plain_ms": time_ms(plain, iters=10), **bounds,
            "library_ms": None,
            "library_call": "none: no one PyTorch call computes the SSD chunk term"}


SSM_SERVE_KW = dict(max_batch=16, max_len=640, prefill_chunk=16, cache_mode="dense")


def phase_ssm_serve(cfg, params) -> dict:
    """Full-width mamba2-1.3b in bf16 on the dense state cache: 32
    requests (prompts 128-512, 64 new tokens), tokens/s, per-dispatch
    times, peak memory; 16 decode dispatches traced; the SSD kernel at the
    serve prefill shape and RMSNorm at d = 2048 timed beside their bounds."""
    from repro_torch.models import Model, ModelRuntime
    from repro_torch.serving.engine import Request, ServeEngine

    dtype = torch.bfloat16
    model = Model(cfg, ModelRuntime(dtype=dtype))
    warm = [Request(uid=f"w{i}", prompt=list(range(1, 40 + i)), max_new_tokens=4)
            for i in range(2)]
    run_engine(model, params, warm, "cuda", **SSM_SERVE_KW)
    reqs = serve_requests(cfg.vocab_size)
    eng = ServeEngine(model, params, device="cuda", **SSM_SERVE_KW)
    eng._decode, eng._prefill = DispatchTimer(eng._decode), DispatchTimer(eng._prefill)
    eng.submit(reqs)
    release_device_memory()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    outs = {r.uid: r.output for r in eng.finished}
    require(len(outs) == len(reqs), "not every SSM serve request finished")
    require(all(len(o) == 64 and all(0 <= t < cfg.vocab_size for t in o) for o in outs.values()),
            "an SSM serve request emitted a wrong number of tokens or an id outside the vocab")
    L, d, pd = cfg.n_layers, eng.dispatches, eng.prefill_dispatches
    require(launches["ssd"] == L * pd, f"ssd launches {launches['ssd']} != {L}/prefill dispatch")
    require(launches["rmsnorm"] == (L + 1) * d, f"rmsnorm launches != {L + 1}/dispatch")
    rec = {
        "phase": "ssm_serve", "arch": cfg.name, "dtype": "bfloat16", "cache_mode": "dense",
        "requests": len(reqs), "prompt_tokens": sum(len(r.prompt) for r in reqs),
        "max_new_tokens": 64, "max_batch": 16, "prefill_chunk": 16, "wall_s": wall,
        "tokens_emitted": eng.tokens_emitted, "tokens_per_s": eng.tokens_emitted / wall,
        "dispatches": d, "prefill_dispatches": pd, "decode_dispatches": eng.decode_dispatches,
        "decode_dispatch_ms": summary(eng._decode.ms()),
        "prefill_dispatch_ms": summary(eng._prefill.ms()),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "peak_cache_bytes": eng.peak_cache_bytes, "launches": launches,
    }
    del eng
    # where a decode dispatch's time goes: 16 rows at prompts 256
    rng = np.random.default_rng(5)
    eng = ServeEngine(model, params, device="cuda", **SSM_SERVE_KW)
    eng.submit([Request(uid=f"q{i}", prompt=rng.integers(1, cfg.vocab_size, 256).tolist(),
                        max_new_tokens=64) for i in range(16)])
    while eng.decode_dispatches < 4:  # prompts drain in 16 prefill dispatches, then decode
        eng.step()
    d0, p0 = eng.decode_dispatches, eng.prefill_dispatches
    ticks = 16
    rec["profile"] = {"what": "decode dispatch, 16 rows, prompts 256", "ticks": ticks,
                      **trace(eng.step, ticks, "dispatch")}
    require(eng.decode_dispatches - d0 == 2 * ticks and eng.prefill_dispatches == p0,
            "traced SSM ticks were not all decode dispatches")
    del eng
    rec["kernel_times"] = {
        "ssd": {"serve_prefill": time_ssd("serve_prefill", 16, 1, 16, dtype,
                                          rng.integers(0, 17, 16).tolist())},
        "rmsnorm": {"decode": time_rmsnorm("decode", 16, cfg.d_model, dtype),
                    "prefill": time_rmsnorm("prefill", 16 * 16, cfg.d_model, dtype)},
    }
    emit(rec)
    return rec


SSM_EVAL_JOB = {"arch": SSM_ARCH, "run": "ssm"}
# Logits with the SSD kernel against the plain chunked scan: f32 differs by
# summation order only; bf16 activations round each layer's small
# differences, compounded over 48 layers.
SSM_LOGIT_TOL = {torch.float32: 1e-3, torch.bfloat16: 1e-1}


def phase_ssm_eval(cfg, params, store_root: Path) -> dict:
    """The eval runner on a checkpoint of the seed-0 weights (bf16, written
    with the port's ``save_state``), bf16 and f32 at 8 x 512 and 2 x 4096:
    finite loss, 48 SSD and 49 RMSNorm launches per forward, logits with
    the kernel against ``use_ssd_kernel=False``, a traced forward, and the
    SSD kernel timed at both shapes."""
    from repro_torch.core.storage import ObjectStore
    from repro_torch.launch.train import run_eval
    from repro_torch.models import Model, ModelRuntime
    from repro_torch.train.checkpoint import restore_state, save_state
    from repro_torch.train.data import DataConfig, SyntheticLM

    torch.backends.cuda.matmul.allow_tf32 = False
    store = ObjectStore(str(store_root / "ssm"))
    t0 = time.perf_counter()
    save_state(store, SSM_EVAL_JOB["run"], 0, params)
    save_s = time.perf_counter() - t0
    n_batches, L = 3, cfg.n_layers
    rec = {"phase": "ssm_eval", "arch": cfg.name, "checkpoint_dtype": "bfloat16",
           "checkpoint_save_s": save_s, "runs": [], "kernel_times": []}
    for dtype, name in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        job = {**SSM_EVAL_JOB, "dtype": name, "n_batches": n_batches}
        base = Model(cfg, ModelRuntime(dtype=dtype))
        restored, _ = restore_state(store, job["run"], 0, base.abstract_params(), device="cuda")
        for b, s in EVAL_SHAPES:
            events: list = []
            reset_launches()
            out = run_eval({**job, "seq_len": s, "global_batch": b}, store,
                           heartbeat_events(events), device="cuda")
            launches = read_launches()
            ms = event_intervals_ms(events)
            require(launches["ssd"] == L * n_batches and launches["rmsnorm"] == (L + 1) * n_batches,
                    f"ssm_eval {name} {b}x{s}: launches {launches}, want {L} SSD and {L + 1} "
                    "RMSNorm per forward")
            require(math.isfinite(out["loss"]), f"ssm_eval {name} {b}x{s}: loss not finite")
            batch = SyntheticLM(cfg, DataConfig(seq_len=s, global_batch=b, seed=1234),
                                device="cuda").batch(0)
            with torch.no_grad():
                logits = {k: Model(cfg, ModelRuntime(dtype=dtype, use_ssd_kernel=k))
                          .forward(restored, batch["tokens"]) for k in (True, False)}
            err = (logits[True] - logits[False]).abs().max().item()
            t = SSM_LOGIT_TOL[dtype]
            require(bool(torch.isfinite(logits[True]).all())
                    and bool(torch.allclose(logits[True], logits[False], atol=t, rtol=t)),
                    f"ssm_eval {name} {b}x{s}: kernel logits differ from the plain scan by {err}")
            del logits
            evaluator = Model(cfg, ModelRuntime(dtype=dtype))
            with torch.no_grad():
                profile = trace(lambda: float(evaluator.loss(restored, batch)[0]), 1, "forward",
                                watch=("ssd_chunk_kernel",))
            rec["runs"].append({
                "dtype": name, "batch": b, "seq_len": s, "loss": out["loss"], "ppl": out["ppl"],
                "forward_ms": summary(ms), "tokens_per_s": b * s / (summary(ms)["median"] / 1e3),
                "launches": launches,
                "launches_per_forward": {k: v / n_batches for k, v in launches.items()},
                "logits_kernel_vs_plain_max_abs_err": err, "logits_tol": t, "profile": profile})
            rec["kernel_times"].append(time_ssd(f"{name}_{b}x{s}", b, s // 128, 128, dtype))
        del restored
    emit(rec)
    return rec


KERNELS = {
    "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                        "src/repro/kernels/flash_decode.py:134"),
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:25"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:99"),
    "ssd": ("src/repro_torch/kernels/csrc/ssd.cu", "src/repro/kernels/ssd.py:61"),
}


def kernels_line(checks: dict, serve: dict, train: dict, evals: dict, ssm_serve: dict,
                 ssm_eval: dict) -> dict:
    """One row per kernel: its launches on the main paths (serve, train,
    eval, ssm_serve, ssm_eval: counts set to 0 before each and read after),
    its worst error, and its times at its first timed shape with the
    others beside."""
    def total(runs):
        return {k: sum(r["launches"][k] for r in runs) for k in runs[0]["launches"]}

    paths = {"serve": serve["launches"], "train": train["launches"], "eval": total(evals["runs"]),
             "ssm_serve": ssm_serve["launches"], "ssm_eval": total(ssm_eval["runs"])}
    timed_by_kernel = {
        "paged_attention": serve["kernel_times"]["paged_attention"],
        "rmsnorm": {**serve["kernel_times"]["rmsnorm"],
                    **{f"d2048_{k}": t for k, t in ssm_serve["kernel_times"]["rmsnorm"].items()}},
        "flash_attention": {f"{t['dtype']}_{t['shape']['BH']}x{t['shape']['S']}": t
                            for t in evals["kernel_times"]},
        "ssd": {**{t["at"]: t for t in ssm_eval["kernel_times"]},
                **ssm_serve["kernel_times"]["ssd"]},
    }
    from repro_torch.kernels.flash_decode import PATHS

    kernel_paths = {f"paged_attention_{p}": sum(counts[f"paged_attention_{p}"]
                                                for counts in paths.values())
                    for p in PATHS}
    rows = []
    for name, (source, replaces) in KERNELS.items():
        launches = {path: counts[name] for path, counts in paths.items()}
        timed = timed_by_kernel[name]
        first = next(iter(timed.values()))
        errs = [*checks["max_abs_err"][name].values(), *(t["max_abs_err"] for t in timed.values())]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(launches.values()), "launches_by_path": launches,
            "max_abs_err": max(errs), "max_abs_err_by_dtype": checks["max_abs_err"][name],
            "ms": first["ms"], "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": first["library_ms"],
            "at": next(iter(timed)),
            **({"launches_by_kernel_path": {k.removeprefix("paged_attention_"): v
                                            for k, v in kernel_paths.items()}}
               if name == "paged_attention" else {}),
            **{f: first[f] for f in ("bound_route", "bound_ms_cuda_core", "launch_floor_ms")
               if f in first},
            "other_shapes": {k: {f: t[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                   "bound_route", "bound_ms_cuda_core",
                                                   "library_ms", "launch_floor_ms", "path",
                                                   "max_abs_err") if f in t}
                             for k, t in list(timed.items())[1:]},
        })
    return {"kernels": rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repository)

    import tempfile

    phase_env()
    phase_build()
    checks = phase_kernels()
    phase_parity()
    serve = phase_serve()
    phase_profile()
    phase_train_parity()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        train = phase_train(Path(tmp))
        evals = phase_eval(Path(tmp))
        cfg, params_cpu = ssm_weights()
        phase_ssm_parity(cfg, params_cpu)
        params = cast_params(params_cpu, torch.bfloat16, "cuda")
        del params_cpu
        ssm_serve = phase_ssm_serve(cfg, params)
        ssm_eval = phase_ssm_eval(cfg, params, Path(tmp))
    emit(kernels_line(checks, serve, train, evals, ssm_serve, ssm_eval))
    name = torch.cuda.get_device_name(0)
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
