"""Parameter-sharding rules engine (counterpart of the reference package's
``sharding/rules.py``).

Maps every parameter leaf (by its path in the tree and its rank) to a
:class:`PartitionSpec` on the mesh, with divisibility-checked fallbacks: a
dim that does not divide its assigned mesh axes is replicated and the
decision recorded, so e.g. whisper-tiny's 6 heads or internvl2's 14 heads
degrade gracefully to replicated attention while their FFN/vocab still
shard.

Policies:
- ``tp_axis``  : tensor-parallel mesh axis ("model").
- ``fsdp_axes``: axes over which parameters/optimizer state are
  additionally sharded ZeRO-3-style (() = pure TP + DP-replication;
  ("data",) = FSDP; ("pod","data") for the largest configs).
- ``ep``       : expert parallelism -- expert dim over ``tp_axis`` when it
  divides; otherwise experts replicate and expert FFNs shard over tp
  (TP-inside-expert; mixtral's 8 experts on a 16-way axis).

The port's trees are not stacked: ``layers`` (and ``cross``, an
encoder's ``layers``) is a list of per-layer dicts.  A layer's leaf gets
the reference's spec of the stacked leaf with the leading ``None`` of
the layer axis removed, so per-device bytes agree to the byte.  A
report names each leaf as the reference does (``layers/attn/wq``; a MoE
model's leading dense layers ``dense_layers/...``) and notes decisions
in the reference's leaf order, so the two reports are equal lists.

The rules read only the mesh's axis sizes: a ``DeviceMesh`` or a mapping
``{axis: size}`` drives them (``launch.mesh.mesh_shape``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

from torch.distributed.tensor import distribute_tensor

from repro_torch.launch.mesh import hbm_bytes
from repro_torch.sharding.spec import MeshAxes, axis_size, spec_placements
from repro_torch.sharding.spec import PartitionSpec as P
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map, tree_map_with_path

STACKS = ("layers", "cross")  # per-layer lists: the reference's stacked leaves


@dataclass(frozen=True)
class ShardingPolicy:
    tp_axis: str = "model"
    fsdp_axes: Tuple[str, ...] = ()
    ep: bool = True

    @property
    def fsdp(self) -> MeshAxes:
        if not self.fsdp_axes:
            return None
        return self.fsdp_axes if len(self.fsdp_axes) > 1 else self.fsdp_axes[0]


@dataclass
class RuleReport:
    """Decisions taken (for the docs and the tests)."""

    fallbacks: List[str] = field(default_factory=list)
    ep_layers: bool = False

    def note(self, msg: str) -> None:
        if msg not in self.fallbacks:
            self.fallbacks.append(msg)


def _maybe(mesh, axes: MeshAxes, dim: int, what: str, report: RuleReport) -> MeshAxes:
    size = axis_size(mesh, axes)
    if axes is None or size == 1:
        return None
    if dim % size == 0 and dim >= size:
        return axes
    report.note(f"{what}: dim {dim} !% {axes}({size}) -> replicated")
    return None


# --------------------------------------------------------------- leaf dispatch
def _leaf_spec(path: Tuple[str, ...], shape: Tuple[int, ...], mesh, pol: ShardingPolicy,
               report: RuleReport) -> P:
    """The reference's ``_leaf_spec`` on a port leaf: ``path`` is the
    reference's (list indices dropped), ``shape`` the port's (no layer
    axis)."""
    tp, fsdp = pol.tp_axis, pol.fsdp
    name = path[-1]
    parent = path[-2] if len(path) >= 2 else ""
    key = "/".join(path)

    def spec(*base) -> P:
        """Pad-left with None to the leaf's rank."""
        return P(*([None] * (len(shape) - len(base)) + list(base)))

    def m(axes, dim):
        return _maybe(mesh, axes, dim, key, report)

    # ---- embeddings / heads -----------------------------------------------
    if name == "embed":
        return P(m(tp, shape[0]), m(fsdp, shape[1]))
    if name == "lm_head":
        return P(m(fsdp, shape[0]), m(tp, shape[1]))
    if name == "pos":
        return spec(None, m(fsdp, shape[-1]))

    # ---- norms / scalars ----------------------------------------------------
    if parent in ("ln1", "ln2", "ln", "ln_f", "q_norm", "kv_norm", "norm_w") or name in (
        "A_log", "D", "dt_bias",
    ):
        return spec()
    if parent == "conv_x":
        if name == "w":
            return spec(None, m(tp, shape[-1]))
        return spec(m(tp, shape[-1]))
    if parent in ("conv_B", "conv_C"):
        return spec()

    # ---- attention ------------------------------------------------------------
    if name in ("wq", "wk", "wv"):
        return spec(m(fsdp, shape[-2]), m(tp, shape[-1]))
    if name == "wo" and parent not in ("mlp", "moe", "shared"):
        # attention output projection (row-parallel) -- mlp/moe handled below
        return spec(m(tp, shape[-2]), m(fsdp, shape[-1]))
    if name in ("bq", "bk", "bv"):
        return spec(m(tp, shape[-1]))

    # ---- MLA ---------------------------------------------------------------------
    if name in ("q_down", "kv_down"):
        return spec(m(fsdp, shape[-2]), None)
    if name in ("q_up", "k_up", "v_up"):
        return spec(None, m(tp, shape[-1]))

    # ---- MoE ----------------------------------------------------------------------
    if name == "router":
        return spec(m(fsdp, shape[-2]), None)
    if parent == "moe":  # expert weights live directly under "moe"
        ep = pol.ep and shape[-3] % axis_size(mesh, tp) == 0
        if name in ("wi", "wg"):  # (E, D, F)
            if ep:
                report.ep_layers = True
                return spec(tp, m(fsdp, shape[-2]), None)
            report.note(f"{key}: EP off (E={shape[-3]} !% tp) -> TP-inside-expert")
            return spec(None, m(fsdp, shape[-2]), m(tp, shape[-1]))
        if name == "wo":  # (E, F, D)
            if ep:
                return spec(tp, None, m(fsdp, shape[-1]))
            return spec(None, m(tp, shape[-2]), m(fsdp, shape[-1]))

    # ---- dense MLP (also moe "shared" expert, zamba "shared" mlp) ------------------
    if name in ("wi", "wg"):
        return spec(m(fsdp, shape[-2]), m(tp, shape[-1]))
    if name == "wo":
        return spec(m(tp, shape[-2]), m(fsdp, shape[-1]))

    # ---- SSM -----------------------------------------------------------------------
    if name in ("w_z", "w_x"):
        return spec(m(fsdp, shape[-2]), m(tp, shape[-1]))
    if name in ("w_B", "w_C", "w_dt"):
        return spec(m(fsdp, shape[-2]), None)
    if name == "out_proj":
        return spec(m(tp, shape[-2]), m(fsdp, shape[-1]))

    # ---- zamba2 shared-block extras ---------------------------------------------------
    if name == "lora_a":  # (n_inv, 2D, r)
        return P(None, m(fsdp, shape[1]), None)
    if name == "lora_b":  # (n_inv, r, HHD)
        return P(None, None, m(tp, shape[2]))
    if name == "down":  # (2D, D)
        return P(m(fsdp, shape[0]), m(tp, shape[1]))

    report.note(f"{key}: no rule -> replicated")
    return spec()


def reference_path(path: Tuple, tree: Any) -> Tuple[Tuple[str, ...], int]:
    """``(the reference's key path, layer index)`` of a port leaf: each
    per-layer list index dropped (its layer axis is stacked there), a MoE
    model's leading dense layers under ``dense_layers``."""
    out, node, layer = [], tree, -1
    i = 0
    while i < len(path):
        k = path[i]
        if k in STACKS and i + 1 < len(path) and isinstance(node[k], list):
            idx = path[i + 1]
            lst = node[k]
            dense = next((j for j, lp in enumerate(lst) if lp.keys() == lst[-1].keys()), 0)
            out.append("dense_layers" if k == "layers" and idx < dense else k)
            node, layer, i = lst[idx], idx, i + 2
            continue
        out.append(str(k))
        node = node[k]
        i += 1
    return tuple(out), layer


# ------------------------------------------------------------------ public API
def param_specs(params_shape: Any, mesh, policy: ShardingPolicy) -> Tuple[Any, RuleReport]:
    """A tree of tensors (meta tensors will do) -> the same tree of
    :class:`PartitionSpec`, and the report of the decisions taken."""
    report = RuleReport()
    leaves = []
    for path, leaf in tree_leaves_with_path(params_shape):
        ref, layer = reference_path(path, params_shape)
        leaves.append((ref, layer, path, tuple(leaf.shape)))
    specs = {}
    for ref, _, path, shape in sorted(leaves, key=lambda t: (t[0], t[1])):
        specs[path] = _leaf_spec(ref, shape, mesh, policy, report)
    return tree_map_with_path(lambda path, _: specs[path], params_shape), report


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the counterpart of ``jax.sharding.NamedSharding``):
    building one checks the spec against the mesh."""

    mesh: Any
    spec: P

    @property
    def placements(self) -> list:
        return spec_placements(self.spec, self.mesh)

    def __post_init__(self):
        spec_placements(self.spec, self.mesh)


def param_shardings(params_shape: Any, mesh, policy: ShardingPolicy):
    specs, report = param_specs(params_shape, mesh, policy)
    return tree_map(lambda s: NamedSharding(mesh, s), specs), report


def distribute_params(params: Any, mesh, specs: Any) -> Any:
    """Every leaf a DTensor on ``mesh`` laid out by its spec (each rank
    keeps its shards of the full tree it holds)."""
    return tree_map(lambda t, s: distribute_tensor(t, mesh, spec_placements(s, mesh)),
                    params, specs)


def bytes_per_device(params_shape: Any, specs: Any, mesh) -> int:
    """Parameter bytes on one device under the given specs."""
    total = 0
    leaves = tree_leaves(params_shape)
    spec_leaves = tree_leaves(specs)
    if len(leaves) != len(spec_leaves):
        raise ValueError(f"{len(leaves)} leaves against {len(spec_leaves)} specs")
    for leaf, spec in zip(leaves, spec_leaves):
        n = 1
        padded = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
        for d, ax in zip(leaf.shape, padded):
            n *= -(-d // axis_size(mesh, ax))
        total += n * leaf.dtype.itemsize
    return total


def choose_policy(
    params_shape: Any,
    mesh,
    *,
    hbm_budget_bytes: Optional[int] = None,
    multi_pod: bool = False,
    state_multiplier: float = 1.0,
) -> ShardingPolicy:
    """Pick FSDP axes so parameters + optimizer state leave room for
    activations.  ``state_multiplier`` scales the param bytes to the full
    training state (e.g. bf16 params + fp32 master + moments + grad
    accumulator ~ 5x); the optimizer state inherits the param specs, so
    the same escalation logic covers it.  The budget defaults to the
    card's memory (:func:`launch.mesh.hbm_bytes`).

    Pure TP first; escalate to FSDP over "data" (and "pod") when the
    per-device state bytes exceed ~half the HBM budget.
    """
    if hbm_budget_bytes is None:
        hbm_budget_bytes = hbm_bytes()
    candidates = [
        ShardingPolicy(fsdp_axes=()),
        ShardingPolicy(fsdp_axes=("data",)),
    ]
    if multi_pod:
        candidates.append(ShardingPolicy(fsdp_axes=("pod", "data")))
    for pol in candidates:
        specs, _ = param_specs(params_shape, mesh, pol)
        state = bytes_per_device(params_shape, specs, mesh) * state_multiplier
        if state <= hbm_budget_bytes // 2:
            return pol
    return candidates[-1]
