"""How far apart the bf16 routes of the hybrid model's logits lie, on the
card.

    python3 tools/hybrid_bf16_routes.py

Full-width ``zamba2-1.2b`` with ``chip_smoke.py``'s weights (seed 0,
``lora_b`` drawn non-zero) and eval batches (8 x 512 and 2 x 4096 from
``SyntheticLM`` seed 1234).  For each batch it prints one JSON line with
the largest and mean absolute difference between every pair of these
logits:

- ``w32``: the plain path in f32 (``attn_impl="direct"``, the plain SSD
  scan): the witness;
- ``k32``: the kernels in f32;
- ``kernel``: the kernels in bf16 (SSD and flash on the card);
- ``direct``, ``chunked``, ``chunked128``: the plain SSD scan with direct
  attention, or the online-softmax ``chunked_attention`` at the default
  chunk and at 128, in bf16;
- ``flash_plain``: bf16 with the flash kernel's plain version in its place
  (fp32 probabilities and products, one rounding of the output);

with, for each bf16 route against ``direct`` and against ``w32``, the
verdict of ``chip_smoke.py``'s bf16 logits gate (``torch.allclose`` at
``atol = rtol = 1e-1``, as the dense and mamba2 evals hold it) and the
worst element's share of its allowance; then the hidden state after every
layer of the ``w32``, ``kernel`` and ``direct`` runs, to show where the
bf16 routes part; then, on the q, k, v the first shared-block invocation
sees, the flash kernel's and direct attention's outputs against a float64
softmax; and the flash kernel at hd 128 timed at both eval shapes.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import Model, ModelRuntime  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.layers import attention_scores  # noqa: E402
from repro_torch.train.data import DataConfig, SyntheticLM  # noqa: E402


def stats(a: torch.Tensor, b: torch.Tensor) -> dict:
    d = (a.float() - b.float()).abs()
    return {"max": d.max().item(), "mean": d.mean().item()}


def gate(a: torch.Tensor, b: torch.Tensor, t: float) -> dict:
    """``torch.allclose(a, b, atol=t, rtol=t)`` and the worst element's
    share of its allowance ``t + t |b|``."""
    a, b = a.float(), b.float()
    return {"allclose": bool(torch.allclose(a, b, atol=t, rtol=t)),
            "worst_over_gate": ((a - b).abs() / (t + t * b.abs())).max().item()}


def layer_states(cfg, params, tokens, dtype, **rt) -> list:
    """The hidden state (f32) after every layer of one forward."""
    seen = []
    layer = transformer._layer_apply

    def capture(*a, **kw):
        h = layer(*a, **kw)
        seen.append(h.float())
        return h

    transformer._layer_apply = capture
    try:
        Model(cfg, ModelRuntime(dtype=dtype, **rt)).forward(params, tokens)
    finally:
        transformer._layer_apply = layer
    return seen


def fold(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) -> (B*H, S, hd)."""
    return x.permute(0, 2, 1, 3).reshape(-1, x.shape[1], x.shape[3])


def route_logits(cfg, p16, p32, tokens) -> dict:
    def run(params, dtype, **rt):
        return Model(cfg, ModelRuntime(dtype=dtype, **rt)).forward(params, tokens)

    plain = dict(use_ssd_kernel=False)
    out = {"w32": run(p32, torch.float32, attn_impl="direct", **plain),
           "k32": run(p32, torch.float32),
           "kernel": run(p16, torch.bfloat16),
           "direct": run(p16, torch.bfloat16, attn_impl="direct", **plain),
           "chunked": run(p16, torch.bfloat16, attn_impl="chunked", **plain),
           "chunked128": run(p16, torch.bfloat16, attn_impl="chunked", attn_chunk=128, **plain)}
    launch = fa._launch
    fa._launch = lambda q, k, v, causal, window: fa.flash_attention_bhsd_plain(
        q, k, v, causal=causal, window=window)
    try:
        out["flash_plain"] = run(p16, torch.bfloat16, attn_impl="kernel")
    finally:
        fa._launch = launch
    return out


def first_invocation_qkv(cfg, p16, tokens) -> tuple:
    """The q, k, v of the first flash call of a bf16 forward."""
    seen = []
    flash = ops.flash_attention

    def capture(q, k, v, **kw):
        if not seen:
            seen.append((q.clone(), k.clone(), v.clone()))
        return flash(q, k, v, **kw)

    ops.flash_attention = capture
    try:
        Model(cfg, ModelRuntime(dtype=torch.bfloat16)).forward(p16, tokens)
    finally:
        ops.flash_attention = flash
    return seen[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("hybrid_bf16_routes: no CUDA device is available", file=sys.stderr)
        return 2
    t0 = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    c.phase_env()
    c.phase_build()
    cfg, pc = c.hybrid_weights()
    p16 = c.cast_params(pc, torch.bfloat16, "cuda")
    p32 = c.cast_params(pc, torch.float32, "cuda")
    del pc
    for b, s in c.EVAL_SHAPES:
        tokens = SyntheticLM(cfg, DataConfig(seq_len=s, global_batch=b, seed=1234),
                             device="cuda").batch(0)["tokens"]
        with torch.no_grad():
            out = route_logits(cfg, p16, p32, tokens)
            names = list(out)
            t = c.SSM_LOGIT_TOL[torch.bfloat16]
            c.emit({"what": "logits", "batch": b, "seq_len": s,
                    "pairs": {f"{x}-{y}": stats(out[x], out[y])
                              for i, x in enumerate(names) for y in names[i + 1:]},
                    "logit_absmax_w32": out["w32"].abs().max().item(),
                    "logit_std_w32": out["w32"].float().std().item(),
                    "bf16_gate": {f"{x}-{y}": gate(out[x], out[y], t)
                                  for x in names[2:] for y in ("direct", "w32") if x != y}})
            del out
            plain = dict(use_ssd_kernel=False, attn_impl="direct")
            w32 = layer_states(cfg, p32, tokens, torch.float32, **plain)
            kern = layer_states(cfg, p16, tokens, torch.bfloat16)
            direct = layer_states(cfg, p16, tokens, torch.bfloat16, **plain)
            c.emit({"what": "hidden state after each layer", "batch": b, "seq_len": s,
                    "layers": [{"layer": i, "rms_w32": w.square().mean().sqrt().item(),
                                "kernel_w32": stats(k, w), "direct_w32": stats(d, w),
                                "kernel_direct": stats(k, d)}
                               for i, (w, k, d) in enumerate(zip(w32, kern, direct))]})
            del w32, kern, direct
            q, k, v = first_invocation_qkv(cfg, p16, tokens)
            exact = fa.flash_attention_bhsd_plain(*(fold(x.double()) for x in (q, k, v)),
                                                  causal=True)
            kern = fold(ops.flash_attention(q, k, v))
            pos = torch.arange(s, device="cuda")[None].expand(b, s)
            direct = fold(attention_scores(q, k, v, causal=True, q_positions=pos,
                                           kv_positions=pos))
            c.emit({"what": "first shared invocation's attention", "batch": b, "seq_len": s,
                    "q_absmax": q.abs().max().item(), "kernel_vs_f64": stats(kern, exact),
                    "direct_vs_f64": stats(direct, exact),
                    "kernel_vs_direct": stats(kern, direct)})
            del exact, kern, direct
    for bh, s in ((256, 512), (64, 4096)):
        c.emit(c.time_flash(bh, s, torch.bfloat16, hd=128))
    print(c.smi_line(), flush=True)
    print(f"seconds {time.time() - t0:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
