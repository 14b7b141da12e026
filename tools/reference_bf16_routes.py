"""How far apart the JAX reference's own bf16 routes through the zamba2
hybrid lie, on the CPU: the yardstick for the port's bf16 logits gate.

    python3 tools/reference_bf16_routes.py [--layers 38 12 6]

``zamba2-1.2b`` at d_model 512 (8 heads, so the shared block keeps its
head width of 128; d_ff 2048), every other field as published, at each
depth given; weights from ``init`` at key 0 with ``lora_b`` drawn non-zero
(normal of std 1/sqrt(rank), numpy ``default_rng(1)``), cast to bf16 (the
SSM's ``A_log``, ``D`` and ``dt_bias`` kept f32); tokens 2 x 512 from
numpy ``default_rng(3)``.  Three forwards of the reference: f32 with
direct attention on the bf16-rounded weights (the witness), bf16 with
direct attention, bf16 with chunked attention (chunk 128).  For each
depth it prints one JSON line: for each pair, the largest and mean
absolute logit difference, the worst element's share of the allowance of
``allclose(atol=rtol=1e-1)`` (above 1: the pair misses that gate), and
each batch row's mean distance from the witness.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch  # noqa: E402
from repro.models import Model, ModelRuntime  # noqa: E402

FP32_LEAVES = ("A_log", "D", "dt_bias")
TOL = 1e-1


def bf16_weights(params):
    return jax.tree_util.tree_map_with_path(
        lambda path, a: a if str(path[-1].key) in FP32_LEAVES else a.astype(jnp.bfloat16), params)


def compare(x: np.ndarray, ref: np.ndarray) -> dict:
    d = np.abs(x - ref)
    return {"max": float(d.max()), "mean": float(d.mean()),
            "worst_over_gate": float((d / (TOL + TOL * np.abs(ref))).max())}


def run(n_layers: int) -> dict:
    cfg = dataclasses.replace(get_arch("zamba2-1.2b"), d_model=512, n_heads=8, n_kv_heads=8,
                              d_ff=2048, n_layers=n_layers)
    params = Model(cfg).init(jax.random.PRNGKey(0))
    lb = params["shared"]["lora_b"]
    draw = np.random.default_rng(1).standard_normal(lb.shape).astype(np.float32)
    params["shared"]["lora_b"] = jnp.asarray(draw / np.sqrt(lb.shape[1]))
    p16 = bf16_weights(params)
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), p16)
    tokens = jnp.asarray(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 512)))

    def logits(params, **rt):
        out = Model(cfg, ModelRuntime(**rt)).forward(params, tokens)
        return np.asarray(out.astype(jnp.float32))[..., :cfg.vocab_size]

    w32 = logits(p32, dtype=jnp.float32, attn_impl="direct")
    direct = logits(p16, dtype=jnp.bfloat16, attn_impl="direct")
    chunked = logits(p16, dtype=jnp.bfloat16, attn_impl="chunked", attn_chunk=128)
    return {"layers": n_layers, "d_model": cfg.d_model, "tokens": [2, 512],
            "logit_std_f32": float(w32.std()),
            "bf16_direct_vs_f32": compare(direct, w32),
            "bf16_chunked_vs_f32": compare(chunked, w32),
            "bf16_chunked_vs_bf16_direct": compare(chunked, direct),
            "row_distance_from_f32": {
                route: np.abs(x - w32).mean(axis=(1, 2)).tolist()
                for route, x in (("direct", direct), ("chunked", chunked))}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[38, 12, 6])
    for n in ap.parse_args().layers:
        print(json.dumps(run(n)), flush=True)


if __name__ == "__main__":
    main()
