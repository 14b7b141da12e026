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

from torch.distributed.tensor import DTensor

from repro_torch.sharding.spec import PartitionSpec as P
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map

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


# A leaf larger than this many elements is updated in place one slice of
# its first dimension at a time, and its squares summed a slice at a time:
# no temporary of the update is larger than a slice (256 MiB in f32).
SLICE_ELEMS = 1 << 26


def _row_slices(t: torch.Tensor, slice_elems: int) -> list:
    """Slices of ``t``'s first dimension of at most ``slice_elems``
    elements each (whole rows), or ``[None]``, the whole leaf, when ``t``
    fits, has fewer than 2 dimensions (the int8 blocks run along the last)
    or is a DTensor."""
    if t.dim() < 2 or t.numel() <= slice_elems or isinstance(t, DTensor):
        return [None]
    rows = max(1, slice_elems // max(1, t.numel() // t.shape[0]))
    return [slice(a, min(a + rows, t.shape[0])) for a in range(0, t.shape[0], rows)]


def _rows(t, rows):
    """``t``'s rows ``rows`` (a view), or ``t`` itself for ``None``; an
    int8 moment's ``q`` and ``scale`` alike."""
    if rows is None:
        return t
    if isinstance(t, dict):
        return {"q": t["q"][rows], "scale": t["scale"][rows]}
    return t[rows]


def global_norm(tree: Tree) -> torch.Tensor:
    """The gradients' global L2 norm: one partial sum of squares per slice
    of a leaf (``_row_slices``), so a large leaf's squares never exist
    whole."""
    parts = [_rows(g, rows).float().square().sum() for g in tree_leaves(tree)
             for rows in _row_slices(g, SLICE_ELEMS)]
    return torch.sqrt(torch.stack(parts).sum())


@dataclass(frozen=True)
class StepScalars:
    """What every leaf's update shares: the step, its learning rate, the
    gradients' global norm, the clip scale and the bias corrections."""

    step: int
    lr: float
    grad_norm: torch.Tensor
    scale: torch.Tensor
    bc1: float
    bc2: float


def step_scalars(grads: Tree, state: Tree, cfg: AdamWConfig) -> StepScalars:
    f = np.float32
    step = int(state["step"]) + 1
    gnorm = global_norm(grads)
    if cfg.clip_norm > 0:
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    else:
        scale = torch.ones_like(gnorm)
    return StepScalars(step=step, lr=cfg.schedule(step), grad_norm=gnorm, scale=scale,
                       bc1=float(f(1.0) - f(cfg.b1) ** f(step)),
                       bc2=float(f(1.0) - f(cfg.b2) ** f(step)))


def adamw_leaf(p, g, mu, nu, k: StepScalars, cfg: AdamWConfig,
               in_place: bool = False) -> Tuple[torch.Tensor, Any, Any]:
    """One leaf's (or one slice's) AdamW update: the new f32 parameter and
    the new moments (int8 ones quantized), from the reference's arithmetic
    op for op.  ``p`` is the parameter or its f32 master.  ``in_place``:
    the same ops written into ``mu`` and ``nu`` (f32 moments) and into
    ``p`` (when f32), which are then the results."""
    g = g.float() * k.scale
    if cfg.moments_dtype == "int8":  # fresh f32 moments: updated where they lie
        mu_f = dequantize_blockwise(mu, p.shape)
        nu_f = dequantize_blockwise(nu, p.shape)
        own = True
    else:
        mu_f, nu_f, own = mu, nu, in_place
    # two temporaries of the leaf's size (``g``, ``tmp``) besides what is
    # not updated in place: on the host each fresh multi-GB tensor costs
    # about as much as the op
    tmp = torch.mul(g, 1 - cfg.b1)
    mu_f = mu_f.mul_(cfg.b1) if own else mu_f * cfg.b1
    mu_f.add_(tmp)
    nu_f = nu_f.mul_(cfg.b2) if own else nu_f * cfg.b2
    nu_f.add_(g.square_().mul_(1 - cfg.b2))
    delta = torch.div(mu_f, k.bc1, out=tmp)
    den = torch.div(nu_f, k.bc2, out=g).sqrt_().add_(cfg.eps)
    delta.div_(den).add_(den.copy_(p).mul_(cfg.weight_decay))
    delta.mul_(k.lr)
    new_p = p.sub_(delta) if in_place and p.dtype == torch.float32 else p.float() - delta
    if cfg.moments_dtype == "int8":
        return new_p, quantize_blockwise(mu_f), quantize_blockwise(nu_f)
    return new_p, mu_f, nu_f


def _metrics(k: StepScalars) -> Dict[str, Any]:
    return {"grad_norm": k.grad_norm, "lr": k.lr, "clip_scale": k.scale}


@torch.no_grad()
def adamw_update(params: Tree, grads: Tree, state: Tree,
                 cfg: AdamWConfig) -> Tuple[Tree, Tree, Dict[str, Any]]:
    """One AdamW step.  Returns (new_params, new_state, metrics); the
    metrics' ``grad_norm`` and ``clip_scale`` stay on the device."""
    k = step_scalars(grads, state, cfg)
    use_master = "master" in state
    ref_params = state["master"] if use_master else params
    outs = tree_map(lambda p, g, mu, nu: adamw_leaf(p, g, mu, nu, k, cfg), ref_params, grads,
                    state["mu"], state["nu"])

    def part(i):
        return tree_map(lambda _, o: o[i], ref_params, outs)

    new_master = part(0)
    new_params = tree_map(lambda m, p: m.to(p.dtype), new_master, params)
    new_state = {"step": k.step, "mu": part(1), "nu": part(2)}
    if use_master:
        new_state["master"] = new_master
    return new_params, new_state, _metrics(k)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def check_unaliased(*trees: Tree) -> None:
    """Raise ``ValueError`` when two tensor leaves of ``trees`` share
    storage (a view of another leaf, a tied weight, one tensor twice):
    an update in place would write that storage twice."""
    seen: Dict[int, str] = {}
    for i, tree in enumerate(trees):
        for path, t in tree_leaves_with_path(tree):
            if not isinstance(t, torch.Tensor):
                continue
            key = _local(t).untyped_storage()._cdata
            name = f"{i}:{'/'.join(map(str, path))}"
            if key in seen:
                raise ValueError(f"leaves {seen[key]} and {name} share storage: an update in "
                                 "place would write it twice")
            seen[key] = name


def _write(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``, laying ``src`` out as ``dst`` first over a mesh;
    nothing when ``src`` is ``dst`` (updated in place)."""
    if src is dst:
        return
    if isinstance(dst, DTensor) and tuple(src.placements) != tuple(dst.placements):
        src = src.redistribute(dst.device_mesh, dst.placements)
    dst.copy_(src)


def _write_moment(dst, src) -> None:
    if isinstance(dst, dict):
        _write(dst["q"], src["q"])
        _write(dst["scale"], src["scale"])
    else:
        _write(dst, src)


def _pop_leaves(tree: Tree, path: Tuple = ()):
    """``tree``'s leaves in ``tree_leaves`` order, each dropped from its
    container (set to None) once the caller has taken it."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            if isinstance(tree[key], (dict, list)):
                yield from _pop_leaves(tree[key])
            else:
                leaf, tree[key] = tree[key], None
                yield leaf
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            if isinstance(v, (dict, list)):
                yield from _pop_leaves(v)
            else:
                leaf, tree[i] = v, None
                yield leaf
    else:
        yield tree


@torch.no_grad()
def adamw_update_(params: Tree, grads: Tree, state: Tree, cfg: AdamWConfig,
                  slice_elems: int = SLICE_ELEMS) -> Tuple[Tree, Tree, Dict[str, Any]]:
    """One AdamW step in place: the counterpart of the reference's update
    under ``jax.jit(..., donate_argnums=(0, 1))``.  The new values are
    written into the tensors of ``params`` (and ``state["master"]``), of
    the f32 moments, or of the int8 moments' ``q`` and ``scale``, and
    ``state["step"]`` is advanced; returns ``(params, state, metrics)``,
    the same trees.  Bit for bit :func:`adamw_update`: the global norm and
    the clip scale come first, then each leaf takes :func:`adamw_leaf`
    one slice of its first dimension at a time (``slice_elems`` elements
    at most; AdamW is elementwise and the int8 blocks run along the last
    dimension, so a slice's result is the whole leaf's rows), each
    gradient dropped as soon as its leaf is written.  ``grads`` is
    consumed: its containers are emptied (leaves set to None) as the walk
    goes, so a caller holding no other reference frees each gradient
    then.  Leaves that share storage are refused (``check_unaliased``).
    Works on DTensors laid out as their parameters, a leaf at a time."""
    use_master = "master" in state
    check_unaliased(params, state["mu"], state["nu"], state.get("master", {}))
    k = step_scalars(grads, state, cfg)
    ref_params = state["master"] if use_master else params
    flat_p = tree_leaves(params)
    flat_ref = tree_leaves(ref_params) if use_master else flat_p
    flat_mu = _moment_leaves(state["mu"], ref_params)
    flat_nu = _moment_leaves(state["nu"], ref_params)
    n = 0
    for i, g in enumerate(_pop_leaves(grads)):
        p, ref, mu, nu = flat_p[i], flat_ref[i], flat_mu[i], flat_nu[i]
        n += 1
        for rows in _row_slices(ref, slice_elems):
            views = [_rows(t, rows) for t in (ref, g, mu, nu)]
            new_p, mu_o, nu_o = adamw_leaf(*views, k, cfg, in_place=True)
            _write(views[0], new_p)
            _write_moment(views[2], mu_o)
            _write_moment(views[3], nu_o)
            if use_master:
                _write(_rows(p, rows), new_p)  # rounded as ``.to(p.dtype)`` rounds
            del views, new_p, mu_o, nu_o
        del g
    if n != len(flat_p):
        raise ValueError(f"{n} gradient leaves for {len(flat_p)} parameters")
    state["step"] = k.step
    return params, state, _metrics(k)


class _Leaf:
    """A moment held as one leaf (an int8 moment's ``{"q", "scale"}``)."""

    def __init__(self, value):
        self.value = value


def _moment_leaves(moments: Tree, like: Tree) -> list:
    """The moments a parameter leaf each (an int8 moment's ``{"q",
    "scale"}`` dict as one), in ``tree_leaves(like)`` order."""
    return [box.value for box in tree_leaves(tree_map(lambda _, m: _Leaf(m), like, moments))]


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
