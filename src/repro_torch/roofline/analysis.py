"""Three-term roofline of one cell's step, from the dry run's count
(counterpart of the reference package's ``roofline/analysis.py``):

    compute term    = FLOPs_per_device            / peak_flops   (989e12, bf16 dense)
    memory term     = HBM_bytes_per_device        / hbm_bw       (3.35e12 B/s)
    collective term = collective_bytes_per_device / nvlink_bw    (900e9 B/s)

The rates are ``launch.mesh.H100``'s, the data sheet of one NVIDIA H100
80GB HBM3 at 700 W.  ``nvlink_bw`` is the in-node NVLink figure (all 18
links of a card, both directions); a layout of more ranks than one node
holds crosses nodes over slower links, so there the collective term is a
lower bound.

The reference reads XLA's per-device ``cost_analysis()`` of the ENTRY
computation and parses collectives out of HLO text; the port has no XLA.
Its dry run (``launch.cells.trace_cell``) runs the step once on meta
tensors over the fake backend's ranks and records each rank's local ops
below DTensor: FLOPs from ``torch.utils.flop_counter``'s formulas, the
buffer trace ``roofline.hbm`` charges, and every functional collective
as a :class:`CollectiveRecord` (an op, its result bytes, its group
size).  :func:`collective_bytes` applies the reference's ring formulas
to those records.  The port is eager, so nothing hides inside a scan:
the count at full depth is direct, and the reference's differencing
probes (:func:`extrapolate`) stay as its cheaper way to full depth.

Conventions, as in the reference: attention FLOPs are whatever the traced
path computes (the plain paths compute the full S x S rectangle, and the
paged plain version every key of the row's table); ``model_flops`` uses
the causal-optimal count.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, NamedTuple, Tuple

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.launch.mesh import H100

# c10d functional collectives (the ops DTensor issues) -> the reference's
# five HLO collectives
C10D_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
}
OPS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all", "collective-permute")


class CollectiveRecord(NamedTuple):
    """One collective of one rank: its op (a c10d functional name, with or
    without its namespace, or one of the reference's :data:`OPS`), the
    bytes of its result on this rank (a coalesced op's results summed),
    and the ranks of its group."""

    op: str
    result_bytes: int
    group_size: int


def reference_op(op: str) -> str:
    """The reference's HLO name of a collective: ``op`` is a c10d functional
    op (``_c10d_functional.all_reduce``, with or without its namespace and
    overload) or already one of :data:`OPS`."""
    for part in reversed(op.split(".")):
        if part in OPS:
            return part
        if part in C10D_OPS:
            return C10D_OPS[part]
    raise ValueError(f"{op!r} is not a collective the roofline knows")


@dataclass
class CollectiveStats:
    bytes_by_op: Dict[str, float] = field(default_factory=dict)
    count_by_op: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_op.values())

    def __sub__(self, other: "CollectiveStats") -> "CollectiveStats":
        ops = set(self.bytes_by_op) | set(other.bytes_by_op)
        return CollectiveStats(
            {o: self.bytes_by_op.get(o, 0.0) - other.bytes_by_op.get(o, 0.0) for o in ops},
            {o: self.count_by_op.get(o, 0) - other.count_by_op.get(o, 0) for o in ops},
        )

    def scaled_add(self, other: "CollectiveStats", k: float) -> "CollectiveStats":
        ops = set(self.bytes_by_op) | set(other.bytes_by_op)
        return CollectiveStats(
            {o: self.bytes_by_op.get(o, 0.0) + k * other.bytes_by_op.get(o, 0.0) for o in ops},
            {o: self.count_by_op.get(o, 0) + int(k) * other.count_by_op.get(o, 0) for o in ops},
        )


def collective_bytes(records: Iterable[CollectiveRecord], n_devices: int) -> CollectiveStats:
    """Per-device bytes moved between cards, ring-algorithm convention (the
    reference's formulas; ``g`` is the record's group, ``n_devices`` where
    it names none):

        all-gather:         (g-1)/g * result_bytes
        reduce-scatter:     (g-1)   * result_bytes      (input = g * result)
        all-reduce:         2 * (g-1)/g * result_bytes
        all-to-all:         (g-1)/g * result_bytes
        collective-permute: result_bytes
    """
    stats = CollectiveStats()
    for rec in records:
        op, rb, g = reference_op(rec[0]), rec[1], rec[2] or n_devices
        g = max(g, 1)
        if op == "all-gather":
            b = rb * (g - 1) / g
        elif op == "reduce-scatter":
            b = rb * (g - 1)
        elif op == "all-reduce":
            b = 2.0 * rb * (g - 1) / g
        elif op == "all-to-all":
            b = rb * (g - 1) / g
        else:  # collective-permute
            b = float(rb)
        stats.bytes_by_op[op] = stats.bytes_by_op.get(op, 0.0) + b
        stats.count_by_op[op] = stats.count_by_op.get(op, 0) + 1
    return stats


# ---------------------------------------------------------------- roofline core
@dataclass
class ProbeCost:
    flops: float
    bytes: float  # HBM-model bytes with the kernels' own traffic (bytes_flash)
    collectives: CollectiveStats
    bytes_jnp: float = 0.0  # as traced: the plain versions' buffers in HBM
    quadratic_bytes: float = 0.0


@dataclass
class RooflineResult:
    arch: str
    shape: str
    n_layers: int
    probe_layers: Tuple[int, int]
    flops: float  # per device, extrapolated or direct
    bytes: float  # HBM model, kernel-corrected
    collective: CollectiveStats
    model_flops_global: float
    n_devices: int
    bytes_jnp: float = 0.0
    hw: Dict = field(default_factory=lambda: dict(H100))

    @property
    def compute_s(self) -> float:
        return self.flops / self.hw["peak_flops"]

    @property
    def memory_s(self) -> float:
        return self.bytes / self.hw["hbm_bw"]

    @property
    def collective_s(self) -> float:
        return self.collective.total_bytes / self.hw["nvlink_bw"]

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def model_flops_per_device(self) -> float:
        return self.model_flops_global / self.n_devices

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs (remat/masking/redundancy waste)."""
        return self.model_flops_per_device / max(self.flops, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU at the modeled bound: useful compute time over
        the dominating term (perfect overlap assumption)."""
        ideal = self.model_flops_per_device / self.hw["peak_flops"]
        return ideal / max(self.bound_s, 1e-30)

    def to_json(self) -> Dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "n_layers": self.n_layers,
            "probe_layers": list(self.probe_layers),
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes,
            "bytes_per_device_jnp": self.bytes_jnp,
            "collective_bytes_per_device": self.collective.total_bytes,
            "collective_by_op": self.collective.bytes_by_op,
            "collective_counts": self.collective.count_by_op,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops_global": self.model_flops_global,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "n_devices": self.n_devices,
        }


def extrapolate(
    c1: ProbeCost, c2: ProbeCost, l1: int, l2: int, n_layers: int
) -> Tuple[float, float, float, CollectiveStats]:
    """Full depth from two probes: ``per_layer = (cost(l2) - cost(l1)) /
    (l2 - l1)``, ``total = cost(l1) + per_layer * (n_layers - l1)``."""
    span = max(l2 - l1, 1)
    df = (c2.flops - c1.flops) / span
    db = (c2.bytes - c1.bytes) / span
    dbj = (c2.bytes_jnp - c1.bytes_jnp) / span
    dc = c2.collectives - c1.collectives
    dc = CollectiveStats(
        {o: v / span for o, v in dc.bytes_by_op.items()},
        {o: v // span for o, v in dc.count_by_op.items()},
    )
    rem = n_layers - l1
    flops = c1.flops + df * rem
    bytes_ = c1.bytes + db * rem
    bytes_jnp = c1.bytes_jnp + dbj * rem
    coll = c1.collectives.scaled_add(dc, rem)
    return flops, bytes_, bytes_jnp, coll


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """Global MODEL_FLOPS per step: 6·N_active·tokens for training,
    2·N_active·batch (+attention term) per decode step."""
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return cfg.flops_per_token(shape.seq_len, decode=False) * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        # forward only = 1/3 of the 6N convention
        return cfg.flops_per_token(shape.seq_len, decode=False) * tokens / 3.0
    return cfg.flops_per_token(shape.seq_len, decode=True) * shape.global_batch
