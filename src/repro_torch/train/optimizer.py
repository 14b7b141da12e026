"""AdamW with global-norm clipping, a warmup + cosine schedule, optional
int8 blockwise moments and an optional fp32 master copy.

Counterpart of the reference package's ``train/optimizer.py``, step for
step in the same float32 arithmetic.  Trees are the port's parameter
trees (``models.transformer``: ``layers`` a list of per-layer dicts);
the moments mirror them.  ``opt_state["step"]`` is a Python int (the
reference keeps an int32 scalar; the checkpoint bridge converts).
``opt_state_specs`` lays the state out over a mesh from the parameters'
specs (``sharding.rules.param_specs``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.sharding.spec import PartitionSpec as P
from repro_torch.tree import tree_leaves, tree_map

Tree = Any

QBLOCK = 128


# ----------------------------------------------------- layout-preserving int8
# Blocks run along the LAST dim so ``q`` keeps the parameter's shape; the
# per-block fp32 scale has shape[:-1] + (n_blocks,).
def _lastdim_blocks(d: int) -> int:
    return max(1, -(-d // QBLOCK))


def quantize_blockwise(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric int8 quantization in QBLOCK-wide blocks along the last dim."""
    x = x.float()
    shape = tuple(x.shape) if x.dim() else (1,)
    d = shape[-1]
    nb = _lastdim_blocks(d)
    blocks = F.pad(x.reshape(shape), (0, nb * QBLOCK - d)).reshape(shape[:-1] + (nb, QBLOCK))
    scale = (blocks.abs().amax(dim=-1) / 127.0).clamp_min(1e-20)
    q = torch.clamp(torch.round(blocks / scale[..., None]), -127, 127)
    q = q.reshape(shape[:-1] + (nb * QBLOCK,))[..., :d].to(torch.int8)
    return {"q": q.reshape(x.shape), "scale": scale}


def dequantize_blockwise(qd: Dict[str, torch.Tensor], shape, dtype=torch.float32) -> torch.Tensor:
    q, scale = qd["q"], qd["scale"]
    s = tuple(q.shape) if q.dim() else (1,)
    d = s[-1]
    nb = scale.shape[-1]
    qp = F.pad(q.reshape(s).float(), (0, nb * QBLOCK - d))
    blocks = qp.reshape(s[:-1] + (nb, QBLOCK)) * scale[..., None]
    out = blocks.reshape(s[:-1] + (nb * QBLOCK,))[..., :d]
    return out.reshape(shape).to(dtype)


# ------------------------------------------------------------------ schedule
@dataclass(frozen=True)
class Schedule:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    final_frac: float = 0.1

    def __call__(self, step: int) -> float:
        """The learning rate at ``step``, in float32 as the reference
        computes it."""
        f = np.float32
        s = f(step)
        if s < self.warmup_steps:
            return float(f(self.peak_lr) * s / f(max(self.warmup_steps, 1)))
        prog = np.clip((s - f(self.warmup_steps))
                       / f(max(self.total_steps - self.warmup_steps, 1)), f(0), f(1))
        cos = f(self.peak_lr) * (f(self.final_frac) + f(1 - self.final_frac) * f(0.5)
                                 * (f(1) + np.cos(f(math.pi) * prog)))
        return float(f(cos))


@dataclass(frozen=True)
class AdamWConfig:
    schedule: Schedule = Schedule()
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moments_dtype: str = "f32"  # f32 | int8
    master_fp32: bool = False  # keep fp32 master when params are low-precision


# ------------------------------------------------------------------- optimizer
def init_opt_state(params: Tree, cfg: AdamWConfig) -> Tree:
    def zeros_like_moment(p):
        if cfg.moments_dtype == "int8":
            shape = tuple(p.shape) if p.dim() else (1,)
            return {
                "q": torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                "scale": torch.zeros(shape[:-1] + (_lastdim_blocks(shape[-1]),),
                                     dtype=torch.float32, device=p.device),
            }
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    state = {
        "step": 0,
        "mu": tree_map(zeros_like_moment, params),
        "nu": tree_map(zeros_like_moment, params),
    }
    if cfg.master_fp32:
        state["master"] = tree_map(lambda p: p.float().clone(), params)
    return state


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(torch.stack([g.float().square().sum() for g in tree_leaves(tree)]).sum())


@torch.no_grad()
def adamw_update(params: Tree, grads: Tree, state: Tree,
                 cfg: AdamWConfig) -> Tuple[Tree, Tree, Dict[str, Any]]:
    """One AdamW step.  Returns (new_params, new_state, metrics); the
    metrics' ``grad_norm`` and ``clip_scale`` stay on the device."""
    f = np.float32
    step = int(state["step"]) + 1
    lr = cfg.schedule(step)

    gnorm = global_norm(grads)
    if cfg.clip_norm > 0:
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    else:
        scale = torch.ones_like(gnorm)

    bc1 = float(f(1.0) - f(cfg.b1) ** f(step))
    bc2 = float(f(1.0) - f(cfg.b2) ** f(step))
    use_master = "master" in state
    ref_params = state["master"] if use_master else params

    def upd(p, g, mu, nu):
        g = g.float() * scale
        if cfg.moments_dtype == "int8":
            mu_f = dequantize_blockwise(mu, p.shape)
            nu_f = dequantize_blockwise(nu, p.shape)
        else:
            mu_f, nu_f = mu, nu
        # the reference's arithmetic op for op, in two temporaries of the
        # leaf's size (``g``, ``tmp``) besides the three results: on the
        # host each fresh multi-GB tensor costs about as much as the op
        tmp = torch.mul(g, 1 - cfg.b1)
        mu_f = mu_f * cfg.b1
        mu_f.add_(tmp)
        nu_f = nu_f * cfg.b2
        nu_f.add_(g.square_().mul_(1 - cfg.b2))
        delta = torch.div(mu_f, bc1, out=tmp)
        den = torch.div(nu_f, bc2, out=g).sqrt_().add_(cfg.eps)
        delta.div_(den).add_(den.copy_(p).mul_(cfg.weight_decay))
        new_p = p.float() - delta.mul_(lr)
        if cfg.moments_dtype == "int8":
            return new_p, quantize_blockwise(mu_f), quantize_blockwise(nu_f)
        return new_p, mu_f, nu_f

    outs = tree_map(lambda p, g, mu, nu: upd(p, g, mu, nu), ref_params, grads, state["mu"],
                    state["nu"])

    def part(i):
        return tree_map(lambda _, o: o[i], ref_params, outs)

    new_master = part(0)
    new_params = tree_map(lambda m, p: m.to(p.dtype), new_master, params)
    new_state = {"step": step, "mu": part(1), "nu": part(2)}
    if use_master:
        new_state["master"] = new_master
    metrics = {"grad_norm": gnorm, "lr": lr, "clip_scale": scale}
    return new_params, new_state, metrics


def opt_state_specs(param_specs_tree: Tree, cfg: AdamWConfig) -> Tree:
    """PartitionSpecs for the optimizer state, derived from param specs.

    int8 moments keep the parameter layout (blocks run along the last dim),
    so ``q`` inherits the parameter spec verbatim and the per-block scale
    inherits every axis except the last (which stays unsharded: the block
    count rarely divides the mesh axis).  Everything stays ZeRO-sharded.
    """

    def moment_spec(spec: P):
        if cfg.moments_dtype == "int8":
            axes = tuple(spec)
            scale_axes = axes[:-1] + (None,) if axes else (None,)
            return {"q": spec, "scale": P(*scale_axes)}
        return spec

    state_specs = {
        "step": P(),
        "mu": tree_map(moment_spec, param_specs_tree),
        "nu": tree_map(moment_spec, param_specs_tree),
    }
    if cfg.master_fp32:
        state_specs["master"] = param_specs_tree
    return state_specs
