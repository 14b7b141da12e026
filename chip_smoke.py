"""Smoke run of the PyTorch/CUDA port on one GPU: builds the hand-written
kernels, holds each against its plain PyTorch version, drives the paged
serving engine at full width and prints what it measured.

    python3 chip_smoke.py

Phases, each printing one JSON line:

- ``env``: torch/CUDA versions, ``nvcc --version``, whether ``triton``
  imports, the card's name and power limit;
- ``build``: compiles ``src/repro_torch/kernels/csrc/*.cu`` (one ``nvcc``
  per source, in parallel) into ``build/kernels/``;
- ``kernels``: each kernel against its plain version on the card, f32
  (atol/rtol 2e-5) and bf16 (2e-2), over the slice's shapes and the
  GQA/MQA/MLA/softcap/verify/aliased/parked cases;
- ``parity``: full-width ``ds-paper-100m`` in f32 from seed 0, the engine
  on ``cuda`` (kernel path) against the same engine on ``cpu`` (plain
  path): equal greedy tokens (a near-tie below 1e-3 of the CPU's top-2
  logit gap is the one allowed exception), equal counters, and launch
  counts of 12 paged-attention and 25 RMSNorm kernels per dispatch;
- ``serve``: full width in bf16, 32 requests, tokens/s, per-dispatch
  times from CUDA events, peak memory, and each kernel at the decode and
  prefill shapes, held against its plain version (bf16 tolerance) and
  timed beside its bound, its plain version and one PyTorch call as a
  yardstick;
- ``profile``: 16 decode dispatches at the serve shape timed on the host
  clock, then 16 more traced with ``torch.profiler``: device busy time,
  idle share against the unprofiled wall time, top device ops.

Then a ``kernels`` summary line, the card's ``nvidia-smi`` name and power
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


class CheckFailed(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


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
        rec = {"phase": "kernels", "kernel": "paged_attention", "case": name,
               "shape": list(q.shape), "max_abs_err": err, "ok": ok}
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


def phase_kernels() -> dict:
    from repro_torch.kernels.flash_decode import paged_flash_attention_folded
    from repro_torch.kernels.rmsnorm import rmsnorm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = {"paged_attention": check_paged_attention(), "rmsnorm": check_rmsnorm()}
    rec = {"phase": "kernels", "max_abs_err": errs,
           "launches_in_checks": {"paged_attention": paged_flash_attention_folded.launches,
                                  "rmsnorm": rmsnorm.launches}}
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
    """Logits after ``tokens`` from a fresh one-row paged cache."""
    ps = 16
    pages = -(-(len(tokens) + 1) // ps)
    cache = model.init_cache(1, pages * ps, paged=True, page_size=ps, n_pages=pages,
                             device=device)
    cache["page_table"].copy_(torch.arange(pages, dtype=torch.int32)[None])
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


def reset_launches():
    from repro_torch.kernels.flash_decode import paged_flash_attention_folded
    from repro_torch.kernels.rmsnorm import rmsnorm

    paged_flash_attention_folded.launches = 0
    rmsnorm.launches = 0


def read_launches() -> dict:
    from repro_torch.kernels.flash_decode import paged_flash_attention_folded
    from repro_torch.kernels.rmsnorm import rmsnorm

    return {"paged_attention": paged_flash_attention_folded.launches,
            "rmsnorm": rmsnorm.launches}


PARITY_COUNTERS = ("dispatches", "prefill_dispatches", "decode_dispatches", "tokens_emitted",
                   "prefix_hit_tokens", "peak_pages")


def phase_parity() -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.models import Model, ModelRuntime

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 parity: full-precision matmuls
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_arch("ds-paper-100m")
    model = Model(cfg, ModelRuntime(dtype=torch.float32))
    kw = dict(max_batch=4, max_len=128, prefill_chunk=16, page_size=16, cache_mode="paged")
    params_gpu = model.init(0, device="cuda")
    reset_launches()
    gpu, gpu_s = run_engine(model, params_gpu, parity_requests(cfg.vocab_size), "cuda", **kw)
    launches = read_launches()
    del params_gpu
    params_cpu = model.init(0, device="cpu")
    cpu, cpu_s = run_engine(model, params_cpu, parity_requests(cfg.vocab_size), "cpu", **kw)
    got = {r.uid: r.output for r in gpu.finished}
    want = {r.uid: r.output for r in cpu.finished}
    require(sorted(got) == sorted(want), "card and CPU finished different requests")
    prompts = {r.uid: r.prompt for r in cpu.finished}
    divergences = []
    for uid in sorted(want):
        a, b = got[uid], want[uid]
        require(len(a) == len(b), f"{uid}: output lengths differ")
        k = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if k is None:
            continue
        lg = next_token_logits(model, params_cpu, prompts[uid] + b[:k], "cpu")
        top2 = torch.topk(lg, 2).values
        gap = float(top2[0] - top2[1])
        divergences.append({"uid": uid, "index": k, "cpu_top2_gap": gap})
        require(gap < NEAR_TIE_GAP,
                f"{uid}: card and CPU diverge at token {k} with a CPU top-2 gap of {gap}")
    counters = {c: [getattr(gpu, c), getattr(cpu, c)] for c in PARITY_COUNTERS}
    for c, (g, h) in counters.items():
        require(g == h, f"counter {c} differs: card {g}, CPU {h}")
    require(gpu.prefix_hit_tokens > 0, "the shared prefix was never hit")
    d = gpu.dispatches
    require(launches["paged_attention"] == cfg.n_layers * d,
            f"paged attention launched {launches['paged_attention']} times for {d} dispatches")
    require(launches["rmsnorm"] == (2 * cfg.n_layers + 1) * d,
            f"rmsnorm launched {launches['rmsnorm']} times for {d} dispatches")
    rec = {"phase": "parity", "arch": cfg.name, "dtype": "float32",
           "tokens_equal": not divergences, "divergences": divergences,
           "counters_card_cpu": counters, "launches": launches,
           "launches_per_dispatch": {k: v / d for k, v in launches.items()},
           "card_s": gpu_s, "cpu_s": cpu_s}
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


def time_paged(label, B, T, offsets, dtype):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import (
        paged_flash_attention_folded,
        paged_flash_attention_folded_plain,
    )

    hkv, dk, ps, P = 12, 64, 16, 40
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
            "max_abs_err": err,
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
            "library_call": "F.rms_norm"}


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
    for name, n in launches.items():
        require(n > 0, f"kernel {name} never launched on the main path")
    d = eng.dispatches
    require(launches["paged_attention"] == cfg.n_layers * d, "paged launches != 12/dispatch")
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
        },
        "rmsnorm": {
            "decode": time_rmsnorm("decode", 16, cfg.d_model, dtype),
            "prefill": time_rmsnorm("prefill", 16 * 16, cfg.d_model, dtype),
        },
    }
    emit(rec)
    return rec


def phase_profile() -> dict:
    """Where a decode dispatch's time goes at the serve shape: 16 rows
    decoding at once.  16 steady decode ticks are timed on the host clock
    without the profiler, then 16 more are traced with torch.profiler.
    Device busy time is the sum of the traced kernels and copies (one
    stream); the idle share is 1 - busy / the unprofiled wall time, so the
    profiler's own host overhead is not counted as idle."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.step()
        torch.cuda.synchronize()
        profiled_wall_ms = (time.perf_counter() - t0) * 1e3
    require(eng.decode_dispatches - d0 == 2 * ticks, "timed ticks were not all decode dispatches")
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    busy_ms = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    rec = {"phase": "profile", "what": "decode dispatch, 16 rows, prompts 256",
           "ticks": ticks, "wall_ms_per_dispatch": wall_ms / ticks,
           "profiled_wall_ms_per_dispatch": profiled_wall_ms / ticks,
           "device_busy_ms_per_dispatch": busy_ms / ticks,
           "device_idle_share": (1 - busy_ms / wall_ms) if dev else None,
           "device_ops_per_dispatch": len(dev) / ticks,
           "top_device_ops": [{"name": n[:80], "ms_per_dispatch": v[0] / ticks,
                               "count_per_dispatch": v[1] / ticks} for n, v in top]}
    emit(rec)
    return rec


KERNELS = {
    "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                        "src/repro/kernels/flash_decode.py:134"),
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:25"),
}


def kernels_line(checks: dict, serve: dict) -> dict:
    rows = []
    for name, (source, replaces) in KERNELS.items():
        times = serve["kernel_times"][name]
        dec = times["decode"]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": serve["launches"][name],
            "max_abs_err": max(*checks["max_abs_err"][name].values(),
                               dec["max_abs_err"], times["prefill"]["max_abs_err"]),
            "max_abs_err_by_dtype": checks["max_abs_err"][name],
            "ms": dec["ms"], "plain_ms": dec["plain_ms"], "bound_ms": dec["bound_ms"],
            "bound_by": dec["bound_by"], "library_ms": dec["library_ms"],
            "at": "decode", "prefill": {k: times["prefill"][k] for k in
                                        ("ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "max_abs_err")},
        })
    return {"kernels": rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repository)

    phase_env()
    phase_build()
    checks = phase_kernels()
    phase_parity()
    serve = phase_serve()
    phase_profile()
    emit(kernels_line(checks, serve))
    name = torch.cuda.get_device_name(0)
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
