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
  slice's shapes and the GQA/MQA/MLA/softcap/verify (G 8 x T 5, and
  ds-paper-100m's G 1 x T 5 and T 9)/aliased/parked cases,
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
- ``spec_parity``: f32, the speculative engines (paged ``ngram`` and
  ``draft``, dense ``ngram``, ``spec_k`` 4: verify at T 5; the draft is
  the same arch from seed 7) and the grouped engine on the card against
  the same engines on the CPU: equal greedy tokens (the near-tie
  exception) and counters, speculative ones included, tokens equal to
  ``parity``'s non-speculative card runs, 12 decode-path paged launches
  and 25 RMSNorm per verify dispatch, 25 RMSNorm per dispatch draft
  dispatches included, and a draft run that rolls back;
- ``spec_serve``: bf16, paged, 8 decode-heavy requests of 256 new tokens
  through the plain engine, ``ngram`` at ``spec_k`` 8 (verify T 9: the
  CUDA-core path) and ``draft`` at ``spec_k`` 4 (T 5: the decode path):
  tokens/s, dispatches per token, accepted per dispatch, verify dispatch
  times from CUDA events, launches by path, peak memory, tokens against
  the plain run (reported, not gated: bf16 verify rounds unlike T
  sequential decodes), a traced verify tick each, and the paged kernel at
  the verify shapes (B 16, T 5 and 9, 128-576 keys) beside its bound,
  plain version and SDPA;
- ``ds_parity``: the control plane and its payloads on the card, f32
  full-width ``ds-paper-100m`` from seed 0, through the paper's four
  commands (``run_ds.main``, ``startCluster --foreground`` so the worker
  threads' launches are counted; no job names a device, so each runs on
  cuda): 2 train spans of 2 steps at 4 x 256 against one direct 4-step
  span (losses, parameters at ``train_parity``'s tolerances), 2 eval shards
  against direct ``run_eval`` (12 flash and 25 RMSNorm a shard), a static
  serve job and a streaming lease of ``parity``'s 6 requests against
  ``parity``'s card engine (tokens, counters; 12 paged and 25 RMSNorm a
  dispatch; the request queue ends empty), two streaming leases of 3
  requests at once on the card (launches the exact sum of both), a seeded
  revocation drill on the ``SimRunner`` (one notice; every request served
  once, checkpoint resumes, tokens equal an uninterrupted run's) and a
  static ``mamba2-1.3b`` job against a direct engine (48 SSD launches a
  prefill dispatch);
- ``ds_serve``: ``serve``'s 32 requests in bf16 in one call: the bare
  engine, the lease payload called directly (no runner) and one streaming
  lease in the foreground, in turns (the queue's, the object store's, the
  engine's and the rest's shares of each foreground lease's wall time,
  timed in its worker thread; queue transactions per engine tick; one
  more lease under cProfile for its top self-time functions) and the
  detached flow (``startCluster`` spawns the worker
  host, ``monitor`` polls until the queue drains, the host's summary);
  tokens/s of each, peak memory of the lease beside the bare engine's;
  every request served and acked, detached completions equal to the
  foreground's;
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
            # ds-paper-100m's verify dispatch (G 1): spec_k 4 on the decode
            # path, spec_k 8 on the CUDA-core one; page-crossing offsets
            (f"verify_g1_T5_{tag}", dict(B=4, hkv=12, g=1, T=5, dk=64, ps=16, P=40,
                                         offsets=[0, 13, 130, 571], seed=14, **d), 0.0, 0),
            (f"verify_g1_T9_{tag}", dict(B=4, hkv=12, g=1, T=9, dk=64, ps=16, P=40,
                                         offsets=[0, 9, 128, 567], seed=15, **d), 0.0, 0),
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


def divergences(model, params_cpu, a, b, what: str) -> list:
    """The first differing token of each request two engine runs finished
    (their finished requests and output lengths must be equal) and the
    CPU's top-2 logit gap after ``b``'s prefix there."""
    got = {r.uid: r.output for r in a.finished}
    want = {r.uid: r.output for r in b.finished}
    require(sorted(got) == sorted(want), f"{what}: the runs finished different requests")
    prompts = {r.uid: r.prompt for r in b.finished}
    out = []
    for uid in sorted(want):
        x, y = got[uid], want[uid]
        require(len(x) == len(y), f"{what}: {uid}: output lengths differ")
        k = next((i for i, (u, v) in enumerate(zip(x, y)) if u != v), None)
        if k is None:
            continue
        lg = next_token_logits(model, params_cpu, prompts[uid] + y[:k], "cpu")
        top2 = torch.topk(lg, 2).values
        out.append({"uid": uid, "index": k, "cpu_top2_gap": float(top2[0] - top2[1])})
    return out


def compare_greedy(model, params_cpu, gpu, cpu, what: str) -> list:
    """Require equal finished requests and greedy outputs of two engine
    runs, a near-tie at the first difference (a CPU top-2 logit gap below
    ``NEAR_TIE_GAP``) being the one allowed exception; the divergences."""
    divs = divergences(model, params_cpu, gpu, cpu, what)
    for d in divs:
        require(d["cpu_top2_gap"] < NEAR_TIE_GAP,
                f"{what}: {d['uid']}: the runs diverge at token {d['index']} with a CPU "
                f"top-2 gap of {d['cpu_top2_gap']}")
    return divs


def compare_counters(a, b, what: str, names=PARITY_COUNTERS) -> dict:
    counters = {c: [getattr(a, c), getattr(b, c)] for c in names}
    for c, (g, h) in counters.items():
        require(g == h, f"{what}: counter {c} differs: {g} against {h}")
    return counters


def phase_parity() -> tuple:
    """Full-width ds-paper-100m in f32, card against CPU, in paged mode
    (paged kernel, RMSNorm) and in dense mode (RMSNorm, plain attention
    over the per-slot cache), and dense against paged on the card.
    Returns the record and the card's engines by mode."""
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
    return rec, card


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


# ------------------------------------------------------------------ speculative decoding
SPEC_COUNTERS = ("spec_dispatches", "draft_dispatches", "draft_tokens_proposed",
                 "draft_tokens_accepted", "spec_tokens_emitted")
DRAFT_SEED = 7  # the reference bench's draft model: the same arch from seed 7


class LaunchesPerCall:
    """Wraps a dispatch callable; records the kernel launches each call
    made (the launch counters' growth across it)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args):
        before = read_launches()
        out = self.fn(*args)
        after = read_launches()
        self.calls.append({k: after[k] - before[k] for k in after})
        return out


def require_verify_launches(eng, paged: bool, path: str, what: str) -> None:
    """Every verify dispatch of ``eng`` (wrapped in ``LaunchesPerCall``)
    launched 12 paged kernels, all on ``path`` (none on the dense cache),
    and 25 RMSNorm."""
    calls = eng._verify.calls
    require(len(calls) == eng.spec_dispatches > 0,
            f"{what}: {len(calls)} verify calls for {eng.spec_dispatches} spec dispatches")
    want = 12 if paged else 0
    for c in calls:
        require(c["paged_attention"] == want and c[f"paged_attention_{path}"] == want
                and c["rmsnorm"] == 25,
                f"{what}: a verify dispatch launched {c}, not {want} paged on the {path} "
                "path and 25 RMSNorm")


def phase_spec_parity(plain: dict) -> dict:
    """Full-width ds-paper-100m in f32: the speculative engines (paged
    ``ngram`` at ``spec_k`` 4 and 8, paged ``draft`` from seed 7 and from
    the target's own params, dense ``ngram``; ``spec_k`` 4 unless named)
    and the grouped engine on the card against the same engines on the
    CPU: equal greedy tokens (near-tie exception) and counters, tokens
    equal to the non-speculative card runs of ``parity`` (``plain``), 12
    paged launches and 25 RMSNorm a verify dispatch (T 5 on the decode
    path, T 9 on the CUDA-core path), 25 RMSNorm a dispatch draft
    dispatches included, and rollback exercised: the seed-7 draft rejects,
    the self-draft keeps some drafts and loses the rest."""
    from repro_torch.configs import get_arch
    from repro_torch.models import Model, ModelRuntime
    from repro_torch.serving.engine import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_arch("ds-paper-100m")
    model = Model(cfg, ModelRuntime(dtype=torch.float32))
    draft = Model(cfg, ModelRuntime(dtype=torch.float32))
    params = {d: model.init(0, device=d) for d in ("cuda", "cpu")}
    draft_params = {d: draft.init(DRAFT_SEED, device=d) for d in ("cuda", "cpu")}
    base = dict(max_batch=4, max_len=128, prefill_chunk=16)
    paged = dict(base, page_size=16, cache_mode="paged")
    engines = {
        "paged_ngram": (dict(paged, speculative="ngram", spec_k=4), "paged"),
        "paged_ngram_k8": (dict(paged, speculative="ngram", spec_k=8), "paged"),
        "paged_draft": (dict(paged, speculative="draft", spec_k=4), "paged"),
        "paged_draft_self": (dict(paged, speculative="draft", spec_k=4), "paged"),
        "dense_ngram": (dict(base, cache_mode="dense", speculative="ngram", spec_k=4), "dense"),
        "paged_grouped": (dict(paged, dispatch_mode="grouped"), "paged"),
    }
    # the seed-7 draft seldom agrees with the target; the target drafting
    # for itself lands its greedy drafts until a row reaches its budget, so
    # its verify keeps a run of drafts and rewinds the rest
    drafts = {"paged_draft": (draft, draft_params), "paged_draft_self": (model, params)}
    t_phase = time.perf_counter()
    rec = {"phase": "spec_parity", "arch": cfg.name, "dtype": "float32",
           "draft_init_seed": DRAFT_SEED, "engines": {}}
    for name, (kw, mode) in engines.items():
        runs = {}
        for dev in ("cuda", "cpu"):
            extra = ({"draft_model": drafts[name][0], "draft_params": drafts[name][1][dev]}
                     if name in drafts else {})
            eng = ServeEngine(model, params[dev], device=dev, **kw, **extra)
            if eng._verify is not None:
                eng._verify = LaunchesPerCall(eng._verify)
            eng.submit(parity_requests(cfg.vocab_size))
            reset_launches()
            t0 = time.perf_counter()
            eng.run_to_completion()
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = read_launches()
            runs[dev] = (eng, time.perf_counter() - t0)
        gpu, cpu = runs["cuda"][0], runs["cpu"][0]
        what = f"spec_parity {name}"
        divs = compare_greedy(model, params["cpu"], gpu, cpu, f"{what}, card against CPU")
        counters = compare_counters(gpu, cpu, f"{what}, card against CPU",
                                    PARITY_COUNTERS + SPEC_COUNTERS)
        vs_plain = compare_greedy(model, params["cpu"], gpu, plain[mode],
                                  f"{what} against parity's {mode} card run")
        n = gpu.dispatches + gpu.draft_dispatches
        require(launches["rmsnorm"] == 25 * n,
                f"{what}: rmsnorm launched {launches['rmsnorm']} times for {n} dispatches")
        require(launches["paged_attention"] == (12 * n if mode == "paged" else 0),
                f"{what}: paged attention launched {launches['paged_attention']} times for "
                f"{n} dispatches")
        require(launches["paged_attention_tensor_core"] == 0,
                f"{what}: f32 paged attention took the bf16 tensor-core path")
        if kw.get("speculative"):
            require(gpu.decode_dispatches == gpu.spec_dispatches > 0,
                    f"{what}: not every decode dispatch was a verify dispatch")
            # G 1: T = spec_k + 1 up to 8 takes the decode path, 9-15 the CUDA-core one
            path = "decode" if kw["spec_k"] + 1 <= 8 else "cuda_core"
            require_verify_launches(gpu, mode == "paged", path, what)
        else:
            require(gpu.prefill_dispatches == 0 and gpu.decode_dispatches > gpu.scheduler.tick,
                    f"{what}: grouped dispatch ran fused prefill or one dispatch a tick")
            require(launches["paged_attention_decode"] == 12 * gpu.decode_dispatches,
                    f"{what}: decode-path launches {launches['paged_attention_decode']} != 12 "
                    f"per decode dispatch ({gpu.decode_dispatches})")
        if name in drafts:
            require(gpu.draft_dispatches > 0
                    and gpu.draft_tokens_accepted < gpu.draft_tokens_proposed,
                    f"{what}: the draft run never rolled back")
        if name == "paged_draft_self":
            require(gpu.draft_tokens_accepted > 0,
                    f"{what}: the self-draft had no draft accepted")
        rec["engines"][name] = {
            "spec_k": kw.get("spec_k"), "tokens_equal": not divs, "divergences": divs,
            "tokens_equal_to_plain": not vs_plain, "divergences_from_plain": vs_plain,
            "counters_card_cpu": counters, "launches": launches,
            "accepted_per_dispatch": gpu.stats.snapshot()["accepted_per_dispatch"],
            "card_s": runs["cuda"][1], "cpu_s": runs["cpu"][1]}
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    return rec


def decode_heavy_requests(n_requests: int, max_new: int, seed: int = 11):
    """Short prompts, long generations (a copy of the reference bench's
    ``decode_heavy_requests``): almost every dispatch is a decode tick."""
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(seed)
    return [Request(uid=f"d{i}",
                    prompt=[int(t) for t in rng.integers(1, 200, size=int(rng.integers(4, 12)))],
                    max_new_tokens=max_new)
            for i in range(n_requests)]


SPEC_SERVE_KW = dict(max_batch=8, max_len=288, prefill_chunk=16, page_size=16,
                     cache_mode="paged")
SPEC_SERVE_NEW = 256


def phase_spec_serve() -> dict:
    """Full-width ds-paper-100m in bf16, 8 decode-heavy requests of 256 new
    tokens through the plain engine, ``ngram`` at ``spec_k`` 8 (verify T 9:
    the CUDA-core path) and ``draft`` at ``spec_k`` 4 (T 5: the decode
    path): tokens/s, dispatches per token, accepted per dispatch, verify
    dispatch times, launches by path (12 a verify dispatch on its path),
    peak memory, one traced verify tick each, tokens against the plain run
    reported (bf16 verify rounds unlike T sequential decodes: not gated),
    and the paged kernel at the verify shapes."""
    from repro_torch.configs import get_arch
    from repro_torch.models import Model, ModelRuntime
    from repro_torch.serving.engine import ServeEngine

    cfg = get_arch("ds-paper-100m")
    dtype = torch.bfloat16
    model = Model(cfg, ModelRuntime(dtype=dtype))
    params = model.init(0, device="cuda")
    draft = Model(cfg, ModelRuntime(dtype=dtype))
    draft_params = draft.init(DRAFT_SEED, device="cuda")
    modes = {
        "off": ({}, None),
        "ngram": (dict(speculative="ngram", spec_k=8), "cuda_core"),
        "draft": (dict(speculative="draft", spec_k=4, draft_model=draft,
                       draft_params=draft_params), "decode"),
    }
    # the gap of a divergence: f32 on the CPU with the same (bf16) weights
    f32_model = Model(cfg, ModelRuntime(dtype=torch.float32))
    params_cpu = cast_params(params, torch.float32, "cpu")
    t_phase = time.perf_counter()
    rec = {"phase": "spec_serve", "arch": cfg.name, "dtype": "bfloat16",
           "requests": 8, "max_new_tokens": SPEC_SERVE_NEW, **SPEC_SERVE_KW,
           "draft_init_seed": DRAFT_SEED, "engines": {}}
    launches_total: dict = {}
    engines = {}
    for name, (extra, path) in modes.items():
        run_engine(model, params, decode_heavy_requests(2, 8, seed=5), "cuda",
                   **SPEC_SERVE_KW, **extra)  # warm the shapes
        reqs = decode_heavy_requests(8, SPEC_SERVE_NEW)
        eng = ServeEngine(model, params, device="cuda", **SPEC_SERVE_KW, **extra)
        eng._decode, eng._prefill = DispatchTimer(eng._decode), DispatchTimer(eng._prefill)
        if eng._verify is not None:
            eng._verify = LaunchesPerCall(DispatchTimer(eng._verify))
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
        for k, v in launches.items():
            launches_total[k] = launches_total.get(k, 0) + v
        outs = {r.uid: r.output for r in eng.finished}
        require(len(outs) == 8 and all(len(o) == SPEC_SERVE_NEW
                                       and all(0 <= t < cfg.vocab_size for t in o)
                                       for o in outs.values()),
                f"spec_serve {name}: a request did not finish with {SPEC_SERVE_NEW} tokens in "
                "the vocab")
        n = eng.dispatches + eng.draft_dispatches
        require(launches["paged_attention"] == 12 * n and launches["rmsnorm"] == 25 * n,
                f"spec_serve {name}: launches {launches} for {n} dispatches")
        if path is not None:
            require_verify_launches(eng, True, path, f"spec_serve {name}")
        engines[name] = eng
        snap = eng.stats.snapshot()
        rec["engines"][name] = {
            "spec_k": extra.get("spec_k"), "verify_path": path, "wall_s": wall,
            "tokens_emitted": eng.tokens_emitted, "tokens_per_s": eng.tokens_emitted / wall,
            "dispatches": eng.dispatches, "decode_dispatches": eng.decode_dispatches,
            "prefill_dispatches": eng.prefill_dispatches,
            "dispatches_per_token": eng.dispatches / eng.tokens_emitted,
            "spec_dispatches": eng.spec_dispatches, "draft_dispatches": eng.draft_dispatches,
            "draft_tokens_proposed": eng.draft_tokens_proposed,
            "draft_tokens_accepted": eng.draft_tokens_accepted,
            "accepted_per_dispatch": snap["accepted_per_dispatch"],
            "verify_dispatch_ms": summary(eng._verify.fn.ms()) if path else None,
            "decode_dispatch_ms": summary(eng._decode.ms()),
            "prefill_dispatch_ms": summary(eng._prefill.ms()),
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "launches": launches}
        if name != "off":
            t0 = time.perf_counter()
            rec["engines"][name]["divergences_from_off"] = divergences(
                f32_model, params_cpu, eng, engines["off"], f"spec_serve {name} against off")
            rec["engines"][name]["divergences_s"] = time.perf_counter() - t0
    rec["launches"] = launches_total
    # one verify tick each, traced: 8 rows decoding, prompts ingested first
    rec["profile"] = {}
    for name in ("ngram", "draft"):
        eng = ServeEngine(model, params, device="cuda", **dict(SPEC_SERVE_KW, max_len=640),
                          **modes[name][0])
        eng.submit(decode_heavy_requests(8, 600, seed=13))
        for _ in range(4):
            eng.step()
        d0 = eng.spec_dispatches
        traced = trace(eng.step, 16, "tick", watch=("paged_", "rmsnorm"))
        require(eng.spec_dispatches - d0 == 32, f"spec_serve {name}: a traced tick was not "
                "one verify dispatch")
        rec["profile"][name] = {"what": f"verify tick, 8 rows, {name} spec_k "
                                        f"{modes[name][0]['spec_k']}", **traced}
    del engines
    release_device_memory()
    rng = np.random.default_rng(6)
    rec["kernel_times"] = {"paged_attention": {
        f"verify_T{T}": time_paged(f"verify_T{T}", 16, T,
                                   rng.integers(128, 576 - T + 1, 16).tolist(), dtype)
        for T in (5, 9)}}
    rec["seconds"] = time.perf_counter() - t_phase
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


# ------------------------------------------------------------------ the control plane
DS_CONFIG = {"tasks_per_machine": 1, "cluster_machines": 1, "machine_type": ["sim.large"],
             "machine_price": 1.0, "sqs_message_visibility": 600.0, "max_receive_count": 3,
             "check_if_done": False}
DS_TRAIN = {"arch": "ds-paper-100m", "seq_len": 256, "global_batch": 4}
# parity's engine knobs as a distributed-serve job (no "device": it runs on cuda)
DS_SERVE_F32 = {"arch": "ds-paper-100m", "max_new_tokens": 24, "max_batch": 4, "max_len": 128,
                "prefill_chunk": 16, "cache_mode": "paged", "page_size": 16}
# the reference's revocation-drill workload (tests/test_elastic_serving.py), no prefix store
DS_DRILL = {"arch": "ds-paper-100m", "max_new_tokens": 12, "max_len": 32, "max_batch": 2,
            "prefill_chunk": 4, "cache_mode": "paged", "page_size": 8, "prefix_cache": True}
DS_TICK = 30.0


def ds_commands(workdir: Path, app: str, config: dict, job: dict, *, foreground: bool = True):
    """The paper's four commands through ``run_ds.main`` (their printed
    lines kept off this script's output): setup, submitJob, startCluster
    (``--foreground``: the worker host's ThreadRunner runs here, so its
    launches are counted) and monitor.  Returns the workdir's store."""
    import contextlib
    import io

    from repro_torch.core.storage import ObjectStore
    from repro_torch.launch import run_ds

    files = workdir / "files"
    files.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, obj in (("config", {"app_name": app, **DS_CONFIG, **config}), ("job", job),
                      ("fleet", {"startup_seconds": 0.0})):
        paths[name] = str(files / f"{name}.json")
        Path(paths[name]).write_text(json.dumps(obj))
    wd = str(workdir / "wd")
    steps = [["setup", "--config", paths["config"]], ["submitJob", paths["job"]],
             ["startCluster", paths["fleet"], *(["--foreground"] if foreground else [])]]
    if foreground:
        steps.append(["monitor", "--poll", "0.05"])
    with contextlib.redirect_stdout(io.StringIO()):
        for argv in steps:
            require(run_ds.main(["--workdir", wd, *argv]) == 0, f"{app}: run_ds {argv[0]} failed")
    return ObjectStore(str(workdir / "wd" / "store"))


def ds_request_queue(path: Path, bodies: list) -> str:
    from repro_torch.core.queue import DurableQueue

    q = DurableQueue(str(path))
    q.send_batch(bodies)
    q.close()
    return str(path)


def ds_queue_counts(path: str) -> dict:
    from repro_torch.core.queue import DurableQueue

    q = DurableQueue(path)
    counts = q.counts()
    q.close()
    return counts


def ds_completions(results: dict) -> dict:
    return {uid: r["completion"] for uid, r in results["requests"].items()}


def ds_job_results(store, app: str) -> list:
    """The results of every completed job, from the worker host's exported
    logs (``logs/<app>/``)."""
    out = []
    for info in store.list(f"logs/{app}/"):
        for line in store.get_text(info.key).splitlines():
            event = json.loads(line)
            if event.get("message") == "job complete":
                out.append(event["result"])
    return out


def as_finished(outputs: dict, prompts: dict):
    """Completions in the shape ``divergences`` reads an engine run in."""
    import types

    return types.SimpleNamespace(finished=[
        types.SimpleNamespace(uid=u, prompt=prompts[u], output=o) for u, o in outputs.items()])


def ds_compare_greedy(model, got: dict, want: dict, prompts: dict, what: str) -> list:
    """Equal greedy completions, or a near-tie (``compare_greedy``'s CPU
    top-2 gap) at each first difference; the CPU weights are drawn only
    when the completions differ."""
    if got == want:
        return []
    params_cpu = model.init(0, device="cpu")
    return compare_greedy(model, params_cpu, as_finished(got, prompts),
                          as_finished(want, prompts), what)


def ds_lease_counter(store, prefix: str, name: str) -> int:
    """A counter summed over each worker's last record under ``prefix``:
    its final ``RESULTS-<worker>.json`` supersedes its slice and drain
    records under ``leases/`` (the reference's drill aggregation)."""
    finals, slices = {}, {}
    for info in store.list(prefix):
        base = info.key.rsplit("/", 1)[-1][:-len(".json")]
        if "/leases/" in info.key:
            slices[base] = store.get_json(info.key)
        elif "/RESULTS-" in info.key:
            finals[base.split("RESULTS-", 1)[-1]] = store.get_json(info.key)
    return sum(int(v.get(name, 0)) for v in {**slices, **finals}.values())


def add_launches(total: dict, launches: dict) -> dict:
    return {k: total.get(k, 0) + v for k, v in launches.items()}


def phase_ds_parity(root: Path, plain: dict) -> dict:
    """The control plane and its payloads on the card, f32 full-width
    ds-paper-100m from seed 0, through the paper's four commands
    (``startCluster --foreground``): train spans against a direct span run,
    eval shards against direct ``run_eval``, a static serve job and a
    streaming lease against ``parity``'s card engine, two streaming leases
    at once, a seeded revocation drill on the ``SimRunner``, and a static
    mamba2-1.3b serve job against a direct engine.  No job names a device:
    each runs on cuda."""
    import shutil

    from repro_torch.configs import get_arch
    from repro_torch.core import DSConfig, DSRuntime, FleetFile, JobFile, SimRunner, VirtualClock
    from repro_torch.core.chaos import ChaosMonkey
    from repro_torch.core.jobs import step_span_job_file
    from repro_torch.core.queue import DurableQueue
    from repro_torch.core.storage import ObjectStore
    from repro_torch.launch import serve
    from repro_torch.launch.train import build_model, run_eval, run_train_span
    from repro_torch.serving.engine import Request, ServeEngine
    from repro_torch.train.checkpoint import latest_step, restore_state
    from repro_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    cfg = get_arch("ds-paper-100m")
    L = cfg.n_layers
    rec = {"phase": "ds_parity", "arch": cfg.name, "dtype": "float32", "device_in_jobs": False,
           "runs": {}}
    total: dict = {}

    # -- train: 2 spans of 2 steps at 4 x 256 against one direct 4-step span
    jf = step_span_job_file(arch="ds-paper-100m", total_steps=4, span=2, run="ds",
                            shared=dict(DS_TRAIN, total_steps=4))
    t0 = time.perf_counter()
    reset_launches()
    store = ds_commands(root / "train", "DSTrain", {"payload": "distributed-train"},
                        json.loads(jf.to_json()))
    launches = read_launches()
    total = add_launches(total, launches)
    ds_s = time.perf_counter() - t0
    spans = sorted(ds_job_results(store, "DSTrain"), key=lambda r: r["span"][0])
    ds_losses = [x for r in spans for x in r["losses"]]
    require(latest_step(store, "ds") == 4 and len(ds_losses) == 4,
            f"ds_parity train: checkpoint at {latest_step(store, 'ds')}, losses {ds_losses}")
    require(launches["rmsnorm"] == 4 * (2 * L + 1) and launches["flash_attention"] == 0
            and launches["paged_attention"] == 0,
            f"ds_parity train: launches {launches}, want 25 RMSNorm a step and no attention kernel")
    direct_store = ObjectStore(str(root / "train_direct"))
    direct = run_train_span({**DS_TRAIN, "total_steps": 4, "run": "ds", "start_step": 0,
                             "num_steps": 4}, direct_store, lambda progress=None: None,
                            device="cuda")
    for step, (got, want) in enumerate(zip(ds_losses, direct["losses"])):
        require(abs(got - want) <= PARITY_RTOL * abs(want),
                f"ds_parity train: loss at step {step} {got} against direct {want}")
    like = build_model(DS_TRAIN).abstract_params()
    a, _ = restore_state(store, "ds", 4, like, device="cuda")
    b, _ = restore_state(direct_store, "ds", 4, like, device="cuda")
    worst = max((x - y).abs().max().item() for x, y in zip(tree_leaves(a), tree_leaves(b)))
    require(all(bool(torch.allclose(x, y, atol=PARITY_PARAM_ATOL, rtol=PARITY_RTOL))
                for x, y in zip(tree_leaves(a), tree_leaves(b))),
            f"ds_parity train: parameters at step 4 differ from the direct run by {worst}")
    del a, b
    rec["runs"]["train"] = {"losses": ds_losses, "direct_losses": direct["losses"],
                            "param_max_abs_err": worst, "launches": launches, "wall_s": ds_s}

    # -- eval: 2 shards on that checkpoint against direct run_eval
    eval_root = root / "eval"
    shutil.copytree(root / "train" / "wd" / "store" / "ckpt" / "ds" / "4",
                    eval_root / "wd" / "store" / "ckpt" / "ds" / "4")
    eval_job = {**DS_TRAIN, "run": "ds", "n_batches": 1}
    t0 = time.perf_counter()
    reset_launches()
    store = ds_commands(eval_root, "DSEval", {"payload": "distributed-eval"},
                        {**eval_job, "groups": [{"shard": 0}, {"shard": 1}]})
    launches = read_launches()
    total = add_launches(total, launches)
    ds_s = time.perf_counter() - t0
    require(launches["flash_attention"] == 2 * L and launches["rmsnorm"] == 2 * (2 * L + 1),
            f"ds_parity eval: launches {launches}, want 12 flash and 25 RMSNorm a shard")
    metrics = []
    for shard in (0, 1):
        got = store.get_json(f"runs/ds/eval/shard{shard}/METRICS.json")
        want = run_eval({**eval_job, "shard": shard, "output_prefix": f"direct/shard{shard}"},
                        store, lambda progress=None: None, device="cuda")
        require(got["ckpt_step"] == want["ckpt_step"] == 4 and got["shard"] == shard
                and abs(got["loss"] - want["loss"]) <= 1e-6 * abs(want["loss"])
                and abs(got["ppl"] - want["ppl"]) <= 1e-6 * abs(want["ppl"]),
                f"ds_parity eval shard {shard}: {got} against direct {want}")
        metrics.append({"ds": got, "direct": want, "bitwise_equal": got == want})
    rec["runs"]["eval"] = {"metrics": metrics, "launches": launches, "wall_s": ds_s}

    # -- serve: parity's 6 requests, static batch and one streaming lease
    reqs = parity_requests(cfg.vocab_size)
    prompts = {r.uid: r.prompt for r in reqs}
    card = {r.uid: r.output for r in plain["paged"].finished}
    t0 = time.perf_counter()
    reset_launches()
    store = ds_commands(root / "serve_static", "DSServe", {"payload": "distributed-serve"},
                        {**DS_SERVE_F32, "groups": [{"prompts": [r.prompt for r in reqs],
                                                     "output_prefix": "serve/static"}]})
    launches = read_launches()
    total = add_launches(total, launches)
    res = store.get_json("serve/static/RESULTS.json")
    got = {f"p{u.removeprefix('req')}": o for u, o in ds_completions(res).items()}
    require(got == card, "ds_parity serve: the static job's completions differ from parity's "
                         "card engine")
    counters = {c: [res[c], getattr(plain["paged"], c)] for c in PARITY_COUNTERS}
    require(all(a == b for a, b in counters.values()),
            f"ds_parity serve: counters differ from parity's card engine: {counters}")
    d = res["dispatches"]
    require(launches["paged_attention"] == L * d and launches["rmsnorm"] == (2 * L + 1) * d,
            f"ds_parity serve: launches {launches} for {d} dispatches")
    rec["runs"]["serve_static"] = {"tokens_equal": True, "counters": counters,
                                   "launches": launches, "wall_s": time.perf_counter() - t0}

    bodies = [{"uid": r.uid, "prompt": r.prompt, "max_new_tokens": 24} for r in reqs]
    lease = {**DS_SERVE_F32, "expected_requests": 6, "stream_idle_polls": 200}
    t0 = time.perf_counter()
    rq = ds_request_queue(root / "stream_requests.sqlite", bodies)
    reset_launches()
    store = ds_commands(root / "serve_stream", "DSStream", {"payload": "distributed-serve"},
                        {**lease, "groups": [{"request_queue": rq,
                                              "output_prefix": "serve/stream"}]})
    launches = read_launches()
    total = add_launches(total, launches)
    res = store.get_json("serve/stream/RESULTS.json")
    counts = ds_queue_counts(rq)
    require(ds_completions(res) == card, "ds_parity stream: completions differ from parity's "
                                         "card engine")
    require(counts == {"visible": 0, "in_flight": 0, "dead": 0},
            f"ds_parity stream: request queue ends {counts}")
    d = res["dispatches"]
    require(launches["paged_attention"] == L * d and launches["rmsnorm"] == (2 * L + 1) * d,
            f"ds_parity stream: launches {launches} for {d} dispatches")
    rec["runs"]["serve_stream"] = {"tokens_equal": True, "queue": counts, "dispatches": d,
                                   "launches": launches, "wall_s": time.perf_counter() - t0}

    # -- two streaming leases at once on the one card, 3 requests each
    t0 = time.perf_counter()
    groups = []
    for i, part in enumerate((bodies[:3], bodies[3:])):
        groups.append({"request_queue": ds_request_queue(root / f"pair_{i}.sqlite", part),
                       "output_prefix": f"serve/pair{i}", "expected_requests": 3})
    reset_launches()
    with LeaseProbe() as probe:
        store = ds_commands(root / "serve_pair", "DSPair",
                            {"payload": "distributed-serve", "tasks_per_machine": 2},
                            {**lease, "groups": groups})
    launches = read_launches()
    total = add_launches(total, launches)
    pair = [store.get_json(f"serve/pair{i}/RESULTS.json") for i in (0, 1)]
    got = {**ds_completions(pair[0]), **ds_completions(pair[1])}
    model = serve._cached_model(DS_SERVE_F32)
    divs = ds_compare_greedy(model, got, card, prompts, "ds_parity two leases")
    d = sum(r["dispatches"] for r in pair)
    require(launches["paged_attention"] == L * d and launches["rmsnorm"] == (2 * L + 1) * d,
            f"ds_parity two leases: launches {launches} are not the sum over both leases' "
            f"{d} dispatches")
    spans = sorted(probe.spans)
    require(len(spans) == 2, f"ds_parity two leases: {len(spans)} lease calls")
    for i in (0, 1):
        counts = ds_queue_counts(groups[i]["request_queue"])
        require(counts == {"visible": 0, "in_flight": 0, "dead": 0},
                f"ds_parity two leases: request queue {i} ends {counts}")
    rec["runs"]["two_leases"] = {
        "tokens_equal": not divs, "divergences": divs,
        "dispatches": [r["dispatches"] for r in pair], "launches": launches,
        "lease_wall_s": [b - a for a, b in spans],
        "overlap_s": max(0.0, min(b for _, b in spans) - max(a for a, _ in spans)),
        "wall_s": time.perf_counter() - t0}

    # -- a seeded revocation drill on the SimRunner: one revocation notice
    t0 = time.perf_counter()
    serve.reset_serve_state()
    clk = VirtualClock()
    drill_cfg = DSConfig(app_name="DSDrill", payload="distributed-serve", cluster_machines=1,
                         tasks_per_machine=1, machine_type=["sim.large"], machine_price=1.0,
                         cpu_shares=8192, memory_mb=16384, sqs_message_visibility=240.0,
                         check_if_done=False, idle_alarm_seconds=100_000.0,
                         monitor_poll_seconds=DS_TICK, autoscale="queue", min_workers=1,
                         max_workers=2, autoscale_queue_per_worker=2,
                         autoscale_up_cooldown_seconds=DS_TICK,
                         autoscale_down_cooldown_seconds=3600.0)
    rt = DSRuntime(drill_cfg, store_root=str(root / "drill" / "store"), clock=clk)
    rt.setup()
    sys_prompt = [11, 12, 13, 14, 15, 16, 17, 18, 21, 22, 23, 24, 25, 26, 27, 28]
    drill_prompts = {f"q{i}": sys_prompt + [31 + i] for i in range(6)}
    rq_path = str(root / "drill" / "requests.sqlite")
    drq = DurableQueue(rq_path, default_visibility=240.0, max_receive_count=6, clock=clk)
    drq.send_batch([{"uid": u, "prompt": p, "max_new_tokens": 12}
                    for u, p in drill_prompts.items()])
    rt.submit_job(JobFile(shared=dict(DS_DRILL, request_queue=rq_path, expected_requests=6,
                                      output_prefix="serve/drill", stream_slice_ticks=2,
                                      stream_idle_polls=8, request_visibility=240.0,
                                      request_max_receive_count=6),
                          groups=[{}, {}]))
    rt.start_cluster(FleetFile(startup_seconds=DS_TICK, market_seed=7))
    chaos = ChaosMonkey.revocation_drill(rt.fleet, clk, seed=1234, n_revocations=1,
                                         start=3 * DS_TICK, spacing=2 * DS_TICK,
                                         notice_seconds=2 * DS_TICK, store=rt.store,
                                         logs=rt.logs)
    reset_launches()
    summary = SimRunner(rt, tick_seconds=DS_TICK, chaos=chaos).run(max_ticks=300)
    launches = read_launches()
    total = add_launches(total, launches)
    counts = drq.counts()
    drq.close()
    served = {info.key.rsplit("/", 1)[-1][:-len(".json")]: rt.store.get_json(info.key)
              for info in rt.store.list("serve/drill/requests/")}
    drill_model = serve._cached_model(DS_DRILL)
    whole = ServeEngine(drill_model, serve._seed_params(DS_DRILL, drill_model, 0,
                                                        torch.device("cuda")),
                        device="cuda", max_batch=2, max_len=32, prefill_chunk=4,
                        cache_mode="paged", page_size=8)
    whole.submit([Request(uid=u, prompt=p, max_new_tokens=12) for u, p in drill_prompts.items()])
    want = {r.uid: r.output for r in whole.run_to_completion()}
    del whole
    got = {u: r["completion"] for u, r in served.items()}
    drill_counters = {c: ds_lease_counter(rt.store, "serve/drill/", c)
                      for c in ("revocation_notices", "drain_requeued_requests",
                                "requests_resumed", "checkpoints_published",
                                "checkpoint_resumes", "tokens_recovered")}
    # one completion record per request, every message acked, none dead
    require(counts == {"visible": 0, "in_flight": 0, "dead": 0} and sorted(got) == sorted(want),
            f"ds_parity drill: queue ends {counts}, served {sorted(got)}")
    require(drill_counters["revocation_notices"] >= 1 and drill_counters["checkpoint_resumes"] > 0,
            f"ds_parity drill: no checkpoint resume {drill_counters}")
    divs = ds_compare_greedy(drill_model, got, want, drill_prompts, "ds_parity drill")
    require(launches["paged_attention"] * (2 * L + 1) == launches["rmsnorm"] * L
            and launches["paged_attention"] > 0,
            f"ds_parity drill: launches {launches} are not 12 paged and 25 RMSNorm a dispatch")
    rec["runs"]["revocation_drill"] = {
        "tokens_equal_uninterrupted": not divs, "divergences": divs, "queue": counts,
        "counters": drill_counters, "chaos": [[c.kind, c.target, c.time] for c in chaos.log],
        "summary": {k: getattr(summary, k) for k in ("jobs_done", "preemptions", "ticks")},
        "launches": launches, "wall_s": time.perf_counter() - t0}
    serve.reset_serve_state()

    # -- a static mamba2-1.3b serve job (dense cache) against a direct engine
    ssm_job = {"arch": SSM_ARCH, "max_new_tokens": 16, "max_batch": 4, "max_len": 128,
               "prefill_chunk": 16, "cache_mode": "dense"}
    ssm_cfg = get_arch(SSM_ARCH)
    ssm_reqs = parity_requests(ssm_cfg.vocab_size)[:4]
    t0 = time.perf_counter()
    reset_launches()
    store = ds_commands(root / "serve_ssm", "DSMamba", {"payload": "distributed-serve"},
                        {**ssm_job, "groups": [{"prompts": [r.prompt for r in ssm_reqs],
                                                "output_prefix": "serve/ssm"}]})
    launches = read_launches()
    total = add_launches(total, launches)
    res = store.get_json("serve/ssm/RESULTS.json")
    ssm_model = serve._cached_model(ssm_job)
    eng = ServeEngine(ssm_model, serve._seed_params(ssm_job, ssm_model, 0, torch.device("cuda")),
                      device="cuda", max_batch=4, max_len=128, prefill_chunk=16,
                      cache_mode="dense")
    eng.submit([Request(uid=f"req{i}", prompt=r.prompt, max_new_tokens=16)
                for i, r in enumerate(ssm_reqs)])
    want = {r.uid: r.output for r in eng.run_to_completion()}
    require(ds_completions(res) == want, "ds_parity mamba2: completions differ from a direct "
                                         "engine on the card")
    counters = {c: [res[c], getattr(eng, c)] for c in PARITY_COUNTERS}
    require(all(a == b for a, b in counters.values()),
            f"ds_parity mamba2: counters differ from a direct engine: {counters}")
    Ls, d, pd = ssm_cfg.n_layers, res["dispatches"], res["prefill_dispatches"]
    require(launches["ssd"] == Ls * pd and launches["rmsnorm"] == (Ls + 1) * d,
            f"ds_parity mamba2: launches {launches} for {pd} prefill / {d} dispatches, want "
            f"{Ls} SSD a prefill dispatch and {Ls + 1} RMSNorm a dispatch")
    rec["runs"]["serve_mamba2"] = {"tokens_equal": True, "counters": counters,
                                   "ssd_per_prefill_dispatch": launches["ssd"] / pd,
                                   "launches": launches, "wall_s": time.perf_counter() - t0}
    del eng
    serve._MODEL_CACHE.clear()
    serve._PARAM_CACHE.clear()
    release_device_memory()
    rec["launches"] = total
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    return rec


class LeaseTimers:
    """Wall time of one serving lease by layer, inside its thread: the
    queue (``DurableQueue`` methods: each one sqlite transaction), the
    object store (``ObjectStore`` methods), the engine's setup (building
    it and submitting requests, which sizes and grows the page pool), the
    engine's stepping (``ServeEngine`` and ``RequestScheduler`` methods
    the lease calls) and the rest (the lease loop's own Python).  Each category's time is exclusive: a queue
    call inside an engine call (the heartbeat's lease extension) counts as
    queue time only.  Transactions count the outermost queue calls."""

    def __init__(self):
        from repro_torch.core.queue import DurableQueue
        from repro_torch.core.storage import ObjectStore
        from repro_torch.serving.engine import ServeEngine
        from repro_torch.serving.scheduler import RequestScheduler

        self.targets = [
            ("queue", DurableQueue, ("__init__", "send", "send_batch", "receive",
                                     "receive_batch", "delete", "delete_batch",
                                     "change_visibility", "release", "counts", "close")),
            ("store", ObjectStore, ("put_bytes", "put_text", "put_json", "get_bytes", "get_text",
                                    "get_json", "exists", "head", "list", "delete")),
            ("engine_setup", ServeEngine, ("__init__", "submit", "submit_resume")),
            ("engine", ServeEngine, ("step", "checkpoint_slot", "snapshot")),
            ("engine", RequestScheduler, ("drain_finished", "trim_samples", "timing",
                                          "sample_marks")),
        ]
        self.seconds = {"queue": 0.0, "store": 0.0, "engine_setup": 0.0, "engine": 0.0}
        self.calls = dict.fromkeys(self.seconds, 0)
        self.thread = None
        self._stack: list = []  # [category, time of nested timed calls]
        self._saved: list = []

    def _wrap(self, cat: str, name: str, fn):
        import threading

        def timed(*args, **kwargs):
            if threading.get_ident() != self.thread:
                return fn(*args, **kwargs)
            outer = [c for c, _ in self._stack]
            self._stack.append([cat, 0.0])
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
                return iter(list(out)) if name == "list" else out
            finally:
                elapsed = time.perf_counter() - t0
                _, inner = self._stack.pop()
                self.seconds[cat] += elapsed - inner
                if cat not in outer:
                    self.calls[cat] += 1
                if self._stack:
                    self._stack[-1][1] += elapsed

        return timed

    def __enter__(self):
        for cat, cls, names in self.targets:
            for name in names:
                fn = cls.__dict__[name]
                self._saved.append((cls, name, fn))
                setattr(cls, name, self._wrap(cat, name, fn))
        return self

    def __exit__(self, *exc):
        for cls, name, fn in self._saved:
            setattr(cls, name, fn)

    def split(self, wall_s: float, ticks: int) -> dict:
        secs = dict(self.seconds, other=wall_s - sum(self.seconds.values()))
        return {"wall_s": wall_s, "seconds": secs,
                "share": {k: v / wall_s for k, v in secs.items()},
                "queue_transactions": self.calls["queue"],
                "store_operations": self.calls["store"], "engine_ticks": ticks,
                "queue_transactions_per_tick": self.calls["queue"] / max(1, ticks)}


def profile_top(prof, n: int = 10) -> list:
    """The functions with the most self time in a cProfile."""
    import pstats

    rows = sorted(((tt, nc, f"{Path(key[0]).name}:{key[1]}:{key[2]}")
                   for key, (_, nc, tt, _, _) in pstats.Stats(prof).stats.items()),
                  reverse=True)[:n]
    return [f"{name} {tt * 1e3:.1f} ms in {nc} calls" for tt, nc, name in rows]


class LeaseProbe:
    """Stands in for the ``distributed-serve`` payload around one run:
    records each call's start and end (a lease's wall time, in its worker
    thread) and, for a single lease, times its layers with
    :class:`LeaseTimers` (``layers``) or runs it under cProfile
    (``profile``)."""

    def __init__(self, *, layers: bool = False, profile: bool = False):
        from repro_torch.core.worker import PAYLOAD_REGISTRY

        self.registry, self.profile = PAYLOAD_REGISTRY, profile
        self.payload = PAYLOAD_REGISTRY["distributed-serve"]
        self.timers = LeaseTimers() if layers else None
        self.spans, self.wall_s, self.prof = [], [], None

    def __call__(self, job, ctx):
        import cProfile
        import threading

        prof = cProfile.Profile() if self.profile else None
        if self.timers is not None:
            self.timers.thread = threading.get_ident()
        t0 = time.perf_counter()
        if prof is not None:
            prof.enable()
        try:
            return self.payload(job, ctx)
        finally:
            if prof is not None:
                prof.disable()
                self.prof = prof
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            self.spans.append((t0, t1))
            self.wall_s.append(t1 - t0)

    def __enter__(self):
        self.registry["distributed-serve"] = self
        if self.timers is not None:
            self.timers.__enter__()
        return self

    def __exit__(self, *exc):
        if self.timers is not None:
            self.timers.__exit__(*exc)
        self.registry["distributed-serve"] = self.payload


class GcClock:
    """Seconds the cyclic garbage collector ran during a block (every
    thread), from ``gc.callbacks``, and its collections by generation."""

    def __enter__(self):
        import gc

        self.seconds, self.collections, self._t0 = 0.0, [0, 0, 0], 0.0
        gc.callbacks.append(self._callback)
        return self

    def _callback(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.seconds += time.perf_counter() - self._t0
            self.collections[info["generation"]] += 1

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._callback)

    def record(self) -> dict:
        return {"gc_s": self.seconds, "gc_collections_by_generation": self.collections}


def stop_process(pid: int, grace_s: float = 10.0):
    """Reap a child that ends within ``grace_s`` (its exit status), or kill
    it; ``None`` when something else reaped it first."""
    import os
    import signal

    deadline = time.time() + grace_s
    try:
        while time.time() < deadline:
            done, status = os.waitpid(pid, os.WNOHANG)
            if done:
                return status
            time.sleep(0.2)
        os.kill(pid, signal.SIGKILL)
        return os.waitpid(pid, 0)[1]
    except ChildProcessError:
        return None


def phase_ds_serve(root: Path) -> dict:
    """``serve``'s 32 requests in bf16 at ``serve``'s knobs, in one call:
    the bare engine (its requests submitted at once, and one by one as a
    lease submits them), the lease payload called directly on this thread
    (no runner: the lease loop's own cost), and one streaming lease
    through the four commands in the foreground (a worker thread beside
    the runner's monitor loop), in turns (bare, bare one by one, direct,
    lease, lease under cProfile, then the four again; each unprofiled
    lease's wall time split by :class:`LeaseTimers`, the profiled one's
    top self-time functions; the garbage collector's time in each run),
    and the paper's detached flow (``startCluster`` spawns the worker host,
    ``monitor`` polls until the queue drains, the host's
    ``summary/<app>.json``).  Gates: every request served and acked, and
    the detached completions equal the foreground's."""
    import contextlib
    import io
    import os
    import threading

    from repro_torch.configs import get_arch
    from repro_torch.core import LogGroup, MetricRegistry, WallClock, WorkerContext
    from repro_torch.core.storage import ObjectStore
    from repro_torch.launch import run_ds, serve
    from repro_torch.serving.engine import Request, ServeEngine

    t_phase = time.perf_counter()
    cfg = get_arch("ds-paper-100m")
    L = cfg.n_layers
    job = {"arch": "ds-paper-100m", "dtype": "bfloat16", "max_new_tokens": 64,
           "max_batch": 16, "max_len": 640, "prefill_chunk": 16, "cache_mode": "paged",
           "page_size": 16}
    kw = dict(max_batch=16, max_len=640, prefill_chunk=16, page_size=16, cache_mode="paged")
    reqs = serve_requests(cfg.vocab_size)
    bodies = [{"uid": r.uid, "prompt": r.prompt, "max_new_tokens": 64} for r in reqs]
    model = serve._cached_model(job)
    params = serve._seed_params(job, model, 0, torch.device("cuda"))
    warm = [Request(uid=f"w{i}", prompt=list(range(1, 40 + i)), max_new_tokens=4)
            for i in range(2)]
    run_engine(model, params, warm, "cuda", **kw)
    lease = {**job, "expected_requests": len(reqs), "stream_idle_polls": 200}
    rec = {"phase": "ds_serve", "arch": cfg.name, "dtype": "bfloat16", "requests": len(reqs),
           "max_new_tokens": 64, "max_batch": 16, "nvidia_smi": smi_line(),
           "bare_engine": [], "bare_one_by_one": [], "direct": [], "foreground": []}
    outputs = {}

    def bare_run(one_by_one: bool) -> dict:
        eng = ServeEngine(model, params, device="cuda", **kw)
        for batch in ([[r] for r in serve_requests(cfg.vocab_size)] if one_by_one
                      else [serve_requests(cfg.vocab_size)]):
            eng.submit(batch)
        release_device_memory()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with GcClock() as gc_clock:
            eng.run_to_completion()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        outputs["bare_one_by_one" if one_by_one else "bare"] = {
            r.uid: r.output for r in eng.finished}
        return {"wall_s": wall, "tokens": eng.tokens_emitted,
                "tokens_per_s": eng.tokens_emitted / wall, "ticks": eng.stats.ticks,
                "dispatches": eng.dispatches, "total_pages": eng.n_pages,
                "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                **gc_clock.record()}

    def direct_run(name: str) -> tuple:
        rq = ds_request_queue(root / f"{name}_requests.sqlite", bodies)
        store = ObjectStore(str(root / name / "store"))
        ctx = WorkerContext(store=store, logs=LogGroup(name), metrics=MetricRegistry(),
                            clock=WallClock(), task=None, worker_id=name)
        release_device_memory()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        timers = LeaseTimers()
        timers.thread = threading.get_ident()
        t0 = time.perf_counter()
        with GcClock() as gc_clock, timers:
            serve.serve_payload({**lease, "request_queue": rq, "output_prefix": "serve/lease"},
                                ctx)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        res = store.get_json("serve/lease/RESULTS.json")
        counts = ds_queue_counts(rq)
        require(len(res["requests"]) == len(reqs) and counts == {"visible": 0, "in_flight": 0,
                                                                  "dead": 0},
                f"ds_serve {name}: {len(res['requests'])} served, request queue ends {counts}")
        d = res["dispatches"]
        require(launches["paged_attention"] == L * d and launches["rmsnorm"] == (2 * L + 1) * d,
                f"ds_serve {name}: launches {launches} for {d} dispatches")
        outputs[name] = ds_completions(res)
        return {"wall_s": wall, "tokens": res["tokens_emitted"],
                "tokens_per_s": res["tokens_emitted"] / wall, "ticks": res["ticks"],
                "dispatches": d, "total_pages": res["total_pages"],
                "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                "split": timers.split(wall, res["ticks"]), **gc_clock.record()}, launches

    def lease_run(name: str, profile: bool) -> tuple:
        rq = ds_request_queue(root / f"{name}_requests.sqlite", bodies)
        release_device_memory()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        with LeaseProbe(layers=not profile, profile=profile) as probe, GcClock() as gc_clock:
            store = ds_commands(root / name, f"DS{name.title()}",
                                {"payload": "distributed-serve"},
                                {**lease, "groups": [{"request_queue": rq,
                                                      "output_prefix": "serve/lease"}]})
        commands_s = time.perf_counter() - t0
        launches = read_launches()
        res = store.get_json("serve/lease/RESULTS.json")
        counts = ds_queue_counts(rq)
        require(len(res["requests"]) == len(reqs) and counts == {"visible": 0, "in_flight": 0,
                                                                  "dead": 0},
                f"ds_serve {name}: {len(res['requests'])} served, request queue ends {counts}")
        d = res["dispatches"]
        require(launches["paged_attention"] == L * d and launches["rmsnorm"] == (2 * L + 1) * d,
                f"ds_serve {name}: launches {launches} for {d} dispatches")
        lease_s = probe.wall_s[0]
        outputs[name] = ds_completions(res)
        run = {"lease_wall_s": lease_s, "commands_wall_s": commands_s,
               "tokens": res["tokens_emitted"], "tokens_per_s": res["tokens_emitted"] / lease_s,
               "ticks": res["ticks"], "dispatches": d, "total_pages": res["total_pages"],
               "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
               "queue": counts, "launches": launches, **gc_clock.record()}
        if profile:
            run["top_self_time"] = profile_top(probe.prof)
        else:
            run["split"] = probe.timers.split(lease_s, res["ticks"])
        return run, launches

    total: dict = {}
    for name in ("bare", "bare_one_by_one", "direct", "foreground", "profiled",
                 "bare", "bare_one_by_one", "direct2", "foreground2"):
        if name.startswith("bare"):
            one_by_one = name == "bare_one_by_one"
            rec["bare_one_by_one" if one_by_one else "bare_engine"].append(bare_run(one_by_one))
            continue
        if name.startswith("direct"):
            run, launches = direct_run(name)
            rec["direct"].append(run)
        elif name == "profiled":
            rec["profiled"], launches = lease_run(name, True)
        else:
            run, launches = lease_run(name, False)
            rec["foreground"].append(run)
        total = add_launches(total, launches)
    fg = outputs["foreground"]
    require(all(outputs[n] == fg for n in ("foreground2", "profiled", "direct", "direct2")),
            "ds_serve: the leases' completions differ between runs")
    rec["bare_one_by_one_equals_bare"] = outputs["bare_one_by_one"] == outputs["bare"]

    def mean_tps(runs):
        return sum(r["tokens_per_s"] for r in runs) / len(runs)

    rec["one_by_one_over_bare_tokens_per_s"] = (mean_tps(rec["bare_one_by_one"])
                                                 / mean_tps(rec["bare_engine"]))
    rec["direct_over_bare_tokens_per_s"] = mean_tps(rec["direct"]) / mean_tps(rec["bare_engine"])
    rec["lease_over_direct_tokens_per_s"] = mean_tps(rec["foreground"]) / mean_tps(rec["direct"])
    rec["lease_over_bare_tokens_per_s"] = mean_tps(rec["foreground"]) / mean_tps(rec["bare_engine"])
    rec["foreground_vs_bare_tokens_equal"] = fg == outputs["bare"]  # reported, not gated

    # the paper's detached flow: the worker host is a second process
    workdir = root / "detached"
    rq = ds_request_queue(root / "detached_requests.sqlite", bodies)
    src = str(ROOT / "src")
    os.environ["PYTHONPATH"] = os.pathsep.join([src, *filter(None, [os.environ.get(
        "PYTHONPATH")])])
    t0 = time.perf_counter()
    ds_commands(workdir, "DSDetached", {"payload": "distributed-serve"},
                {**lease, "groups": [{"request_queue": rq, "output_prefix": "serve/lease"}]},
                foreground=False)
    pid = int((workdir / "wd" / "worker_host.pid").read_text())
    monitor_out = io.StringIO()
    store = ObjectStore(str(workdir / "wd" / "store"))
    try:
        with contextlib.redirect_stdout(monitor_out):
            require(run_ds.main(["--workdir", str(workdir / "wd"), "monitor", "--poll",
                                 "0.5"]) == 0, "ds_serve detached: monitor failed")
        monitor_s = time.perf_counter() - t0
        deadline = time.time() + 300
        while not store.exists("summary/DSDetached.json") and time.time() < deadline:
            time.sleep(0.2)
        summary_s = time.perf_counter() - t0
    finally:
        status = stop_process(pid)
    require(store.exists("summary/DSDetached.json"),
            "ds_serve detached: the worker host wrote no summary within 300 s")
    summary = store.get_json("summary/DSDetached.json")
    res = store.get_json("serve/lease/RESULTS.json")
    counts = ds_queue_counts(rq)
    require(summary["jobs_done"] == 1 and len(res["requests"]) == len(reqs)
            and counts == {"visible": 0, "in_flight": 0, "dead": 0},
            f"ds_serve detached: summary {summary}, {len(res['requests'])} served, request "
            f"queue ends {counts}")
    require(ds_completions(res) == fg,
            "ds_serve detached: completions differ from the foreground lease's")
    rec["detached"] = {"tokens": res["tokens_emitted"], "summary": summary,
                       "start_to_drained_s": monitor_s, "start_to_summary_s": summary_s,
                       "tokens_per_s_start_to_summary": res["tokens_emitted"] / summary_s,
                       "worker_host_exit_status": status, "queue": counts,
                       "monitor_lines": len(monitor_out.getvalue().splitlines()),
                       "completions_equal_foreground": True}
    rec["launches"] = total
    serve.reset_serve_state()
    serve._MODEL_CACHE.clear()
    serve._PARAM_CACHE.clear()
    release_device_memory()
    rec["seconds"] = time.perf_counter() - t_phase
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


def kernels_line(checks: dict, serve: dict, spec_serve: dict, ds_parity: dict, ds_serve: dict,
                 train: dict, evals: dict, ssm_serve: dict, ssm_eval: dict) -> dict:
    """One row per kernel: its launches on the main paths (serve,
    spec_serve, ds_parity's and ds_serve's payload runs, train, eval,
    ssm_serve, ssm_eval: counts set to 0 before each run and read after),
    its worst error, and its times at its first timed shape with the
    others beside."""
    def total(runs):
        return {k: sum(r["launches"][k] for r in runs) for k in runs[0]["launches"]}

    paths = {"serve": serve["launches"], "spec_serve": spec_serve["launches"],
             "ds_parity": ds_parity["launches"], "ds_serve": ds_serve["launches"],
             "train": train["launches"], "eval": total(evals["runs"]),
             "ssm_serve": ssm_serve["launches"], "ssm_eval": total(ssm_eval["runs"])}
    timed_by_kernel = {
        "paged_attention": {**serve["kernel_times"]["paged_attention"],
                            **spec_serve["kernel_times"]["paged_attention"]},
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
    _, plain = phase_parity()
    serve = phase_serve()
    phase_profile()
    phase_spec_parity(plain)
    spec_serve = phase_spec_serve()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        ds_parity = phase_ds_parity(Path(tmp), plain)
        del plain
        ds_serve = phase_ds_serve(Path(tmp))
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
    emit(kernels_line(checks, serve, spec_serve, ds_parity, ds_serve, train, evals, ssm_serve,
                      ssm_eval))
    name = torch.cuda.get_device_name(0)
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
