"""Cell construction for the dry run and the roofline (counterpart of the
reference package's ``launch/cells.py``).

A *cell* = (architecture x input shape x mesh).  For each cell this
module provides:

- ``args``          -- meta tensors for every input of the step (the
                       parameters from ``Model.abstract_params``, the cache
                       from ``init_cache(device="meta")``, the batch):
                       shapes and dtypes, nothing allocated;
- ``step_fn``       -- the step (train / prefill / serve prefill / decode)
                       the rule set binds;
- ``in_shardings``  -- a :class:`PartitionSpec` tree matched to each input
                       (``param_specs``, ``opt_state_specs``, the cache's
                       and the batch's specs).

:func:`trace_cell` runs the step once on those meta inputs laid out on the
mesh as DTensors, under the cell's rules, and records what one rank does
(``roofline.hbm.Recorder``): its FLOPs, its buffer trace and its
collectives.  The reference lowers and compiles instead; the port is
eager, so the reference's ``unroll_layers`` has nothing to unroll (no
layer loop hides inside a scan here) and keeps only its other effect,
the MoE strategy (``shardmap`` for the probes, ``capacity`` otherwise).

Decode cells run ``decode_step`` (one new token a row against a
``seq_len`` cache); ``long_500k`` also splits the cache's sequence over
every mesh axis.  The serving engine's hot paths are cells of their own:
``serve_prefill_*`` (fused chunked prefill, ``Model.prefill_chunk``),
``serve_ragged_*`` (decode at per-row positions) and ``serve_paged_*``
(the same decode against the paged cache, its pool half the dense
reservation).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec, cell_applicable
from repro_torch.launch.mesh import H100, dp_axes, hbm_bytes, mesh_shape, n_chips
from repro_torch.models import Model, ModelRuntime
from repro_torch.roofline.hbm import Recorder, recording, storage_key
from repro_torch.sharding.logical import axis_rules, train_rules
from repro_torch.sharding.rules import ShardingPolicy, choose_policy, param_specs
from repro_torch.sharding.spec import PartitionSpec as P
from repro_torch.sharding.spec import axis_size, spec_placements
from repro_torch.train.optimizer import AdamWConfig, Schedule, init_opt_state, opt_state_specs
from repro_torch.train.steps import TrainStepConfig, make_train_step
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path

# tokens ingested per row per serve_prefill dispatch (chunked prefill)
SERVE_PREFILL_CHUNK = 512

# serve_paged cell: page size and pool fraction of the dense reservation --
# the cell holds a pool strictly smaller than batch * max_len
SERVE_PAGE_SIZE = 128
SERVE_PAGED_POOL_FRACTION = 0.5


@dataclass
class Cell:
    arch: str
    shape: ShapeSpec
    cfg: ArchConfig
    model: Model
    step_fn: Callable
    args: Tuple  # trees of meta tensors
    in_shardings: Tuple  # a PartitionSpec tree per argument
    donate: Tuple[int, ...]
    rules: Dict
    policy: ShardingPolicy
    microbatches: int


def card_bytes() -> int:
    """What a card holds: ``hbm_bytes()`` where a card is present, else
    the data sheet's figure for ``launch.mesh.H100``."""
    return hbm_bytes() if torch.cuda.is_available() else H100["hbm_bytes"]


def decode_cell_rules(mesh, shape: ShapeSpec) -> Dict:
    """Decode rule sets: the KV cache's sequence over 'model'
    (flash-decode); long-context also over the dp axes.  The reference's
    rules, entry for entry."""
    multi = "pod" in mesh_shape(mesh)
    r = train_rules(multi)
    if shape.name == "long_500k":
        r["kv_seq"] = tuple(dp_axes(mesh)) + ("model",)
        r["batch"] = None  # batch=1
        r["cache_batch"] = None
        r["heads"] = None
        r["kv_heads"] = None
        return r
    # flash-decode: cache seq over 'model'; heads/kv-heads must then stay
    # unsharded (a spec may use each mesh axis only once)
    r["kv_seq"] = "model"
    # paged cache: the page POOL dim shards over 'model' (pages are
    # unordered, the table restores logical order per row)
    r["kv_pages"] = "model"
    r["kv_heads"] = None
    r["heads"] = None
    # decode reshards activations, not weights: the FFN inputs take the
    # 'data'-sharded hidden dim ("act_embed") so x @ W contracts over a
    # sharded dim (a partial product and a sum of small activations, not a
    # gather of FSDP weight shards every token)
    r["act_embed"] = "data"
    r["act_heads"] = "model"  # wo contraction over its 'model'-sharded dim
    r["act_batch"] = None
    # the residual stream lives d-sharded over 'data' at decode; the KV
    # cache keeps batch over 'data' via "cache_batch"
    r["embed"] = "data"
    r["batch"] = None
    return r


def pick_microbatches(cfg: ArchConfig, shape: ShapeSpec) -> int:
    """Keep ~128k global tokens per microbatch for train cells."""
    if shape.kind != "train":
        return 1
    tokens = shape.seq_len * shape.global_batch
    mb = max(1, tokens // 131_072)
    while shape.global_batch % mb:
        mb -= 1
    return mb


def auto_train_knobs(cfg: ArchConfig) -> Dict[str, Any]:
    """Size-adaptive production defaults: big models get 8-bit Adam
    moments, bf16 gradient accumulation and sqrt-segmented remat; small
    models keep plain fp32 state."""
    big = cfg.param_count() >= 30e9
    seg = 0
    if cfg.n_layers >= 24 and cfg.family in ("dense", "moe", "vlm"):
        target = max(2, int(round(cfg.n_layers ** 0.5)))
        layers = cfg.n_layers - (cfg.first_k_dense if cfg.family == "moe" else 0)
        for k in range(target, 1, -1):
            if layers % k == 0:
                seg = k
                break
    return {
        "moments_dtype": "int8" if big else "f32",
        "accum_dtype": "bf16" if big else "f32",
        "remat_segment": seg if big else 0,
    }


def make_opt_config(
    cfg: ArchConfig, *, moments_dtype: str = "f32", master_fp32: bool = True
) -> AdamWConfig:
    return AdamWConfig(
        schedule=Schedule(peak_lr=3e-4, warmup_steps=100, total_steps=10_000),
        moments_dtype=moments_dtype,
        master_fp32=master_fp32,  # bf16 params (+ fp32 master by default)
    )


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, shape: ShapeSpec, mesh) -> Tuple[Dict, Dict]:
    """(meta tensors, PartitionSpecs) for a training batch."""
    b, s = shape.global_batch, shape.seq_len
    dp = dp_axes(mesh)
    structs: Dict[str, Any] = {"tokens": _meta((b, s), torch.int32),
                               "labels": _meta((b, s), torch.int32)}
    specs: Dict[str, Any] = {"tokens": P(dp, None), "labels": P(dp, None)}
    if cfg.is_encoder_decoder:
        structs["frames"] = _meta((b, cfg.encoder_seq, cfg.d_model), torch.bfloat16)
        specs["frames"] = P(dp, None, None)
    if cfg.n_vision_tokens:
        structs["patches"] = _meta((b, cfg.n_vision_tokens, cfg.d_model), torch.bfloat16)
        specs["patches"] = P(dp, None, None)
    return structs, specs


def cache_specs(cfg: ArchConfig, cache_shapes, rules, mesh) -> Any:
    """PartitionSpecs for the decode cache from the logical rule set."""

    def leaf_spec(path, leaf):
        # cache layouts (see Model.init_cache):
        #   k/v:            (L, B, T, Hkv, hd)   logical (None,batch,kv_seq,kv_heads,None)
        #   c_kv/k_rope:    (L, B, T, r)         (None,batch,kv_seq,None)
        #   cross_k/v:      (L, B, Tenc, H, hd)  (None,batch,None,kv_heads,None)
        #   shared_k/v:     (I, B, T, H, hd)
        #   state.conv_*:   (L, B, k-1, C)       (None,batch,None,ssm_inner?)
        #   state.ssm:      (L, B, h, p, n)      (None,batch,ssm_heads,None,None)
        name = path[-1] if path else ""
        if name in ("k_pages", "v_pages"):
            #   k_pages/v_pages: (L, n_pages, ps, Hkv, hd)
            logical = (None, "kv_pages", None, "kv_heads", None)
        elif name == "kv_pages":
            #   MLA pool: (L, n_pages, ps, r+qr)
            logical = (None, "kv_pages", None, None)
        elif name == "page_table":
            logical = (None, None)  # tiny, replicated
        elif name in ("k", "v", "shared_k", "shared_v"):
            logical = (None, "cache_batch", "kv_seq", "kv_heads", None)
        elif name in ("cross_k", "cross_v"):
            logical = (None, "cache_batch", None, "kv_heads", None)
        elif name in ("c_kv", "k_rope"):
            logical = (None, "cache_batch", "kv_seq", None)
        elif name == "conv_x":
            logical = (None, "cache_batch", None, "ssm_inner")
        elif name in ("conv_B", "conv_C"):
            logical = (None, "cache_batch", None, None)
        elif name == "ssm":
            logical = (None, "cache_batch", "ssm_heads", None, None)
        else:
            logical = tuple(None for _ in leaf.shape)
        axes = []
        for dim, lg in zip(leaf.shape, logical):
            mesh_axes = rules.get(lg) if lg else None
            if mesh_axes is None:
                axes.append(None)
                continue
            size = axis_size(mesh, mesh_axes)
            axes.append(mesh_axes if (size <= dim and dim % size == 0) else None)
        return P(*axes)

    return tree_map_with_path(leaf_spec, cache_shapes)


def cell_cache(model: Model, shape: ShapeSpec, mesh) -> Any:
    """The decode cache of a serving or decode cell, as meta tensors.  A
    ``serve_paged`` cell holds a page pool strictly smaller than the dense
    reservation (tokens resident, not worst case): ``SERVE_PAGED_POOL_FRACTION``
    of it in pages of ``SERVE_PAGE_SIZE``, a whole number on 'model', over
    which the pool shards; its page table stays replicated."""
    b = shape.global_batch
    if shape.kind != "serve_paged":
        return model.init_cache(b, shape.seq_len, device="meta")
    pages_per_slot = shape.seq_len // SERVE_PAGE_SIZE
    n_pages = int(b * pages_per_slot * SERVE_PAGED_POOL_FRACTION)
    n_pages -= n_pages % axis_size(mesh, "model")
    return model.init_cache(b, shape.seq_len, paged=True, page_size=SERVE_PAGE_SIZE,
                            n_pages=n_pages, device="meta")


def build_cell(
    arch: str,
    shape_name: str,
    mesh,
    *,
    cfg_override: Optional[ArchConfig] = None,
    moments_dtype: str = "f32",
    master_fp32: bool = True,
    accum_dtype: str = "f32",
    remat_segment: int = 0,
    attn_impl: str = "auto",
    remat: bool = True,
    unroll_layers: bool = False,
    microbatches: Optional[int] = None,
    policy: Optional[ShardingPolicy] = None,
    sequence_parallel: bool = False,
) -> Cell:
    """The cell's step, its meta inputs and their specs on ``mesh`` (a
    ``DeviceMesh`` or a mapping ``{axis: size}``).  The knobs are the
    reference's; the sharding policy's budget is the card's memory
    (:func:`card_bytes`).  A train cell donates its parameters and
    optimizer state to the step, as the reference's does."""
    cfg = cfg_override or get_arch(arch)
    shape = SHAPES[shape_name]
    ok, reason = cell_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"cell ({arch},{shape_name}) not applicable: {reason}")

    if shape.kind == "train" and not unroll_layers:
        auto = auto_train_knobs(cfg)
        if moments_dtype == "f32":
            moments_dtype = auto["moments_dtype"]
        if accum_dtype == "f32":
            accum_dtype = auto["accum_dtype"]
        if remat_segment == 0:
            remat_segment = auto["remat_segment"]

    multi = "pod" in mesh_shape(mesh)
    if shape.kind == "train" and attn_impl == "auto":
        # flash-style memory for the training backward: chunked attention
        # never keeps (S x S) scores for the backward
        attn_impl = "chunked"
    rt = ModelRuntime(
        dtype=torch.bfloat16,
        attn_impl=attn_impl,
        remat=remat and shape.kind == "train",
        remat_segment=remat_segment,
        # the expert-parallel MoE is the production path and the probes'
        # (the reference's unrolled lowering); the full-depth cells take the
        # gather path, as the reference's scanned cells do
        moe_strategy="shardmap" if unroll_layers else "capacity",
    )
    model = Model(cfg, rt)
    params_shape = model.abstract_params()

    if policy is None:
        # train state multiplier over bf16 params: fp32 master (2x) +
        # moments (int8 ~1x / f32 4x) + accumulator (1-2x) + params (1x)
        mult = 1.0
        if shape.kind == "train":
            mult = 5.0 if moments_dtype == "int8" else 7.0
        policy = choose_policy(params_shape, mesh, hbm_budget_bytes=card_bytes(),
                               multi_pod=multi, state_multiplier=mult)
    p_specs, _ = param_specs(params_shape, mesh, policy)

    if shape.kind == "train":
        rules = train_rules(multi)
        if sequence_parallel:
            rules = dict(rules, residual_seq="model")
        mb = microbatches if microbatches is not None else pick_microbatches(cfg, shape)
        opt_cfg = make_opt_config(cfg, moments_dtype=moments_dtype, master_fp32=master_fp32)
        # the reference jits the train cell with donate_argnums=(0, 1): the
        # port's step updates the parameters and optimizer state in place
        step = make_train_step(
            model, TrainStepConfig(microbatches=mb, accum_dtype=accum_dtype, opt=opt_cfg),
            donate=True)
        opt_shape = init_opt_state(params_shape, opt_cfg)
        o_specs = opt_state_specs(p_specs, opt_cfg)
        b_structs, b_specs = batch_specs(cfg, shape, mesh)
        rng = _meta((2,), torch.int64)  # a prng key
        args = (params_shape, opt_shape, b_structs, rng)
        in_shardings = (p_specs, o_specs, b_specs, P(None))
        donate = (0, 1)
    elif shape.kind == "prefill":
        rules = train_rules(multi)
        mb = 1
        b_structs, b_specs = batch_specs(cfg, shape, mesh)
        args = (params_shape, b_structs["tokens"])
        in_shardings = (p_specs, b_specs["tokens"])
        for side in ("frames", "patches"):
            if side in b_structs:
                args += (b_structs[side],)
                in_shardings += (b_specs[side],)
        step = _wrap_prefill(model, cfg)
        donate = ()
    elif shape.kind == "serve_prefill":
        # fused chunked prefill: the serving engine's prompt-ingestion
        # dispatch (SERVE_PREFILL_CHUNK tokens a row a call) writing the
        # decode cache in one shot
        rules = decode_cell_rules(mesh, shape)
        mb = 1
        b = shape.global_batch
        cache_shape = cell_cache(model, shape, mesh)
        c_specs = cache_specs(cfg, cache_shape, rules, mesh)

        def step(params, cache, tokens, offsets, lengths):
            return model.prefill_chunk(params, cache, tokens, offsets, lengths)

        args = (
            params_shape,
            cache_shape,
            _meta((b, SERVE_PREFILL_CHUNK), torch.int32),
            _meta((b,), torch.int32),  # per-row start offsets
            _meta((b,), torch.int32),  # per-row valid lengths
        )
        in_shardings = (p_specs, c_specs, P(None, None), P(None), P(None))
        donate = (1,)
    else:  # decode / serve_decode / serve_paged
        rules = decode_cell_rules(mesh, shape)
        mb = 1
        b = shape.global_batch
        cache_shape = cell_cache(model, shape, mesh)
        c_specs = cache_specs(cfg, cache_shape, rules, mesh)

        def step(params, cache, tokens, pos):
            return model.decode_step(params, cache, tokens, pos)

        if shape.kind in ("serve_decode", "serve_paged"):
            # ragged continuous batching: a position a row, every slot
            # advancing in one dispatch
            pos = _meta((b,), torch.int32)
        else:
            pos = _meta((), torch.int32)  # uniform
        args = (params_shape, cache_shape, _meta((b, 1), torch.int32), pos)
        in_shardings = (p_specs, c_specs, P(None, None), P(*([None] * pos.dim())))
        donate = (1,)

    return Cell(arch=arch, shape=shape, cfg=cfg, model=model, step_fn=step, args=args,
                in_shardings=in_shardings, donate=donate, rules=rules, policy=policy,
                microbatches=mb)


def _wrap_prefill(model: Model, cfg: ArchConfig):
    if cfg.is_encoder_decoder:
        return lambda params, tokens, frames: model.prefill(params, tokens, frames=frames)
    if cfg.n_vision_tokens:
        return lambda params, tokens, patches: model.prefill(params, tokens, patches=patches)
    return lambda params, tokens: model.prefill(params, tokens)


def place_args(cell: Cell, mesh) -> Tuple:
    """The cell's meta inputs as DTensors on ``mesh`` laid out by their
    specs (each rank's local shards, nothing allocated); non-tensor leaves
    (the optimizer's step count) pass through."""
    from torch.distributed.tensor import distribute_tensor

    def place(t, spec):
        if not isinstance(t, torch.Tensor):
            return t
        return distribute_tensor(t, mesh, spec_placements(spec, mesh))

    return tuple(tree_map(place, a, s) for a, s in zip(cell.args, cell.in_shardings))


@dataclass
class CellTrace:
    """One run of a cell's step on one rank: ``recorder.trace`` holds its
    FLOPs, buffers, collectives and peaks; the bytes of the step's outputs
    (local shards), of those that are inputs it updated in place (the
    decode cache), and the seconds the run took."""

    recorder: Recorder
    output_bytes: int
    alias_bytes: int
    seconds: float


def trace_cell(cell: Cell, mesh) -> CellTrace:
    """Run the cell's step once on its meta inputs under its rules and
    record one rank (the counterpart of ``lower_cell`` + ``compile``).

    On a mesh of more than one rank (a ``DeviceMesh`` over an initialised
    group: the fake backend's, for shapes only) the inputs are DTensors
    laid out by ``in_shardings``.  A one-rank mesh splits nothing: the
    step runs on the plain meta tensors, with no rules, as it runs on the
    card's one rank."""
    import time

    one = n_chips(mesh) == 1
    args = cell.args if one else place_args(cell, mesh)
    t0 = time.perf_counter()
    with recording() as rec:
        if one:
            out = cell.step_fn(*args)
        else:
            with axis_rules(mesh, cell.rules):
                out = cell.step_fn(*args)
    seconds = time.perf_counter() - t0
    ins = {storage_key(t) for t in _local_leaves(args)}
    outs = _local_leaves(out)
    return CellTrace(recorder=rec, output_bytes=sum(t.nbytes for t in outs),
                     alias_bytes=sum(t.nbytes for t in outs if storage_key(t) in ins),
                     seconds=seconds)


def _local_leaves(tree) -> list:
    from torch.distributed.tensor import DTensor

    return [t.to_local() if isinstance(t, DTensor) else t for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)]
