"""Buffer-centric HBM-traffic model of a traced step (counterpart of the
reference package's ``roofline/hbm.py``).

The reference parses the ENTRY computation of XLA's optimized HLO, where
every def line is a buffer that materializes, and charges

    traffic(buffer) = bytes x (1 write + n_uses reads)

(parameters reads only; aliases free).  The port is eager: every aten
op a step dispatches is a kernel whose outputs are buffers in HBM.  So
:class:`Recorder` (a ``TorchDispatchMode``) records the step's local ops
(below DTensor: each rank's own, on meta tensors that hold no data) and
applies the same rule to them:

- an op's new output is a buffer: 1 write, plus a read each time a later
  op takes it;
- a tensor no recorded op made (a parameter, the cache, the batch) is an
  input: reads only;
- a view or alias moves nothing; an op that takes a view reads the view's
  bytes (the elements it spans, a broadcast dimension once); a gather
  (``index``, ``embedding``, ``gather``, ``index_select``) reads from its
  source no more than it writes;
- an in-place op writes what it changes: a scatter (``index_put_``, the
  paged cache's K/V writes) the values it scatters, another in-place op
  its operand, which it also reads unless it only overwrites it
  (``copy_``, ``fill_``, ``zero_``).

Two figures come out, as in the reference:

    bytes_jnp   -- as traced: the plain versions' buffers in HBM
    bytes_flash -- the card's hot path: the kernels' own traffic

``bytes_flash`` makes two corrections.  Quadratic attention buffers
(trailing dims S_q x S_kv, both at least ``quad_threshold``) that the
plain attention paths materialize are left out, as the flash kernel keeps
S x S on chip (the reference's rule).  And each call of a kernel's plain
version (:data:`KERNEL_ENTRIES`) is charged as its kernel moves data:
every input read once, every output written once.  For the paged
attention kernel that means the pool's K/V pages (``k_pages``/``v_pages``,
read once a layer), not the plain version's gather of the whole page
table (``B x max_len`` keys) into a copy: the paged kernel reads each
resident page of the pool once, which is what the reference's TPU hot
path reads through its Pallas call.  RMSNorm reads its rows and weight
and writes its rows, where the plain version's eight ops each make a
buffer.

The same trace gives the step's peak of live temporaries: each new
storage an op makes is live from its op until the last tensor on it is
freed (``weakref.finalize``).  That peak is the counterpart of
``memory_analysis().temp_size_in_bytes``, taken as the card runs the
step: a kernel call holds only its outputs, not its plain version's
buffers.
"""

from __future__ import annotations

import contextlib
import importlib
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline.analysis import C10D_OPS, CollectiveRecord

# Each kernel's entry whose plain version the trace charges as the kernel
# moves data: (module, attribute) as ``kernels.ops`` reaches it.
KERNEL_ENTRIES = (
    ("repro_torch.kernels.ops", "paged_flash_attention_folded"),
    ("repro_torch.kernels.rmsnorm", "rmsnorm"),
    ("repro_torch.kernels.ops", "flash_attention_bhsd"),
    ("repro_torch.kernels.ops", "ssd_chunk"),
)

aten = torch.ops.aten
# a tensor's buffer in a recording: (the recorder's id, the buffer's index),
# kept on the tensor itself, whose Python object lives as long as it does
_TAG = "_roofline_buffer"
# in-place ops that overwrite their operand without reading it
_OVERWRITES = {aten.copy_, aten.fill_, aten.zero_, aten.masked_fill_}
# in-place scatters: they write the values they are given, at the indices
_SCATTERS = {aten.index_put_, aten._index_put_impl_, aten.index_copy_, aten.scatter_,
             aten.scatter_add_, aten.index_add_}
# gathers: they read from their source what they write
_GATHERS = {aten.index, aten.index_select, aten.embedding, aten.gather}
# ops that allocate and write nothing
_ALLOCATES = {aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
              aten.new_empty_strided}


def span_bytes(t: torch.Tensor) -> int:
    """The bytes a read of ``t`` touches: its elements, a broadcast
    (stride 0) dimension once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def is_quadratic(shape, threshold: int) -> bool:
    return len(shape) >= 2 and shape[-1] >= threshold and shape[-2] >= threshold


@dataclass
class Buffer:
    """One buffer of the trace: its bytes and dims, whether an op wrote it
    (0 for an input or a view), whether it is an input or a view of one,
    whether a kernel's plain version made it, and the bytes later ops
    read of it, in all and inside kernel calls (``nbytes`` a use, less
    for a gather)."""

    nbytes: int
    shape: Tuple[int, ...]
    writes: int
    input: bool
    in_kernel: bool = False
    reads: int = 0
    reads_in_kernel: int = 0


@dataclass
class Trace:
    """What :class:`Recorder` saw of one step on one rank."""

    buffers: List[Buffer] = field(default_factory=list)
    # in-place writes into buffers already there: (bytes, inside a kernel call)
    inplace_writes: List[Tuple[int, bool]] = field(default_factory=list)
    kernel_bytes: float = 0.0  # the kernels' own traffic: inputs once, outputs once
    flops: float = 0.0
    collectives: List[CollectiveRecord] = field(default_factory=list)
    peak_temp_bytes: int = 0  # as the card runs the step: kernels hold their outputs


@dataclass
class HBMTraffic:
    bytes_jnp: float
    bytes_flash: float
    quadratic_bytes: float
    n_buffers: int


def hbm_traffic(trace: Trace, *, quad_threshold: int = 1024) -> HBMTraffic:
    """The reference's buffer rule over a recorded trace (see the module
    docstring)."""
    total = flash = quad = 0.0
    for b in trace.buffers:
        t = b.nbytes * b.writes + b.reads
        total += t
        if not b.input and not b.in_kernel and is_quadratic(b.shape, quad_threshold):
            quad += t
            continue
        # a plain version's own writes and reads are its kernel's, in kernel_bytes
        flash += (0 if b.in_kernel else b.nbytes * b.writes) + b.reads - b.reads_in_kernel
    for nbytes, in_kernel in trace.inplace_writes:
        total += nbytes
        if not in_kernel:
            flash += nbytes
    return HBMTraffic(
        bytes_jnp=total,
        bytes_flash=flash + trace.kernel_bytes,
        quadratic_bytes=quad,
        n_buffers=len(trace.buffers),
    )


def storage_key(t: torch.Tensor) -> int:
    """The identity of the storage under ``t`` (its views share it)."""
    return t.untyped_storage()._cdata


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


class Recorder(TorchDispatchMode):
    """Records a step's local ops into a :class:`Trace`: FLOPs (the
    formulas of ``torch.utils.flop_counter``), the buffer rule's
    reads and writes, the functional collectives, the live temporaries.

    Over a mesh it defers every op on a ``DTensor`` to DTensor, whose
    dispatch then runs each rank's op on its local shards, which are what
    this mode records: the counts are one rank's, as the reference's
    ``cost_analysis`` is one device's.  The ops DTensor runs to propagate
    placements and global shapes (on fake tensors, or through an op's
    decomposition on meta tensors the first time it meets the op) are not
    the step's and are left out, as are ops on no meta tensor (DTensor's
    index arithmetic on the host: the step runs on meta tensors).  On meta
    tensors ``nonzero`` takes every element as set: the dry run's cells
    write every row they hold."""

    def __init__(self):
        super().__init__()
        self.trace = Trace()
        # storage key -> [live tensors on it, bytes, held on the card's path]
        self._storages: Dict[int, list] = {}
        self._live = 0  # bytes live on the card's path
        self._kernel_depth = 0
        self._paused = 0  # inside DTensor's sharding propagation

    # ------------------------------------------------------------ buffers
    def _buffer(self, t: torch.Tensor, *, writes: int, input_: bool) -> int:
        self.trace.buffers.append(Buffer(span_bytes(t), tuple(t.shape), writes, input_,
                                         in_kernel=self._kernel_depth > 0))
        i = len(self.trace.buffers) - 1
        t.__dict__[_TAG] = (id(self), i)
        return i

    def _index(self, t: torch.Tensor):
        """The buffer ``t`` is, where this recorder has seen it."""
        tag = t.__dict__.get(_TAG)
        return tag[1] if tag is not None and tag[0] == id(self) else None

    def _use(self, t: torch.Tensor, nbytes: int = -1) -> None:
        i = self._index(t)
        if i is None:  # a tensor no recorded op made: an input of the step
            i = self._buffer(t, writes=0, input_=True)
        b = self.trace.buffers[i]
        nbytes = b.nbytes if nbytes < 0 else min(nbytes, b.nbytes)
        b.reads += nbytes
        if self._kernel_depth:
            b.reads_in_kernel += nbytes

    def _track(self, t: torch.Tensor, key: int) -> None:
        entry = self._storages.get(key)
        if entry is None:
            entry = self._storages[key] = [0, t.untyped_storage().nbytes(), False]
            if not self._kernel_depth:
                self._hold(entry)
        entry[0] += 1
        weakref.finalize(t, self._release, key)

    def _hold(self, entry: list) -> None:
        """Count a storage on the card's path (made outside a kernel call,
        or a kernel's output)."""
        if not entry[2]:
            entry[2] = True
            self._live += entry[1]
            self.trace.peak_temp_bytes = max(self.trace.peak_temp_bytes, self._live)

    def _release(self, key: int) -> None:
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[0] -= 1
        if entry[0] == 0:
            if entry[2]:
                self._live -= entry[1]
            del self._storages[key]

    # ------------------------------------------------------------ dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs the local ops, recorded below
        if self._paused or any(issubclass(t, FakeTensor) for t in types):
            return func(*args, **kwargs)  # DTensor's sharding and shape propagation
        if func is aten.nonzero.default and args[0].device.type == "meta":
            x = args[0]
            out = torch.empty((x.numel(), x.dim()), dtype=torch.long, device="meta")
        else:
            out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(isinstance(o, FakeTensor) for o in outs):
            return out  # factory calls of the shape propagation
        if not any(t.device.type == "meta" for t in outs + _tensors((args, kwargs))):
            return out  # DTensor's index arithmetic on the host
        self._record(func, args, kwargs, out, outs)
        return out

    def _record(self, func, args, kwargs, out, outs) -> None:
        tr = self.trace
        packet = func._overloadpacket
        if packet in flop_registry:
            tr.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        schema = func._schema
        named = dict(zip((a.name for a in schema.arguments), args))
        named.update(kwargs)
        written = {}  # id of each tensor the op writes in place -> its argument
        for a in schema.arguments:
            if a.alias_info is not None and a.alias_info.is_write:
                for t in _tensors(named.get(a.name)):
                    written[id(t)] = a.name
        ins = _tensors((args, kwargs))
        in_keys = {storage_key(t) for t in ins}
        # a view or alias (every output on an input's storage, nothing
        # written) reads nothing
        alias_only = not written and bool(outs) and all(storage_key(o) in in_keys for o in outs)
        for t in [] if alias_only else ins:
            if id(t) in written:
                if packet in _SCATTERS:
                    values = named.get("values", named.get("source", named.get("src")))
                    nbytes = sum(span_bytes(v) for v in _tensors(values))
                else:
                    nbytes = span_bytes(t)
                    if packet not in _OVERWRITES and written[id(t)] != "out":
                        self._use(t)
                tr.inplace_writes.append((nbytes, self._kernel_depth > 0))
                continue
            if packet in _GATHERS and t is args[0]:
                self._use(t, sum(span_bytes(o) for o in outs))
            else:
                self._use(t)
        if schema.name.startswith("_c10d_functional::") and packet.__name__ in C10D_OPS:
            tr.collectives.append(CollectiveRecord(str(packet), sum(span_bytes(o) for o in outs),
                                                   self._group_size(named)))
        for o in outs:
            key = storage_key(o)
            if key in in_keys:  # a view, or an in-place op's own operand
                if self._index(o) is None:
                    base = next((self._index(t) for t in ins
                                 if storage_key(t) == key and self._index(t) is not None),
                                None)
                    from_input = base is None or tr.buffers[base].input
                    self._buffer(o, writes=0, input_=from_input)
                if key in self._storages:
                    self._track(o, key)
                continue
            self._buffer(o, writes=0 if packet in _ALLOCATES else 1, input_=False)
            self._track(o, key)

    @staticmethod
    def _group_size(named: dict) -> int:
        if "group_size" in named:
            return int(named["group_size"])
        from torch.distributed.distributed_c10d import _resolve_process_group

        return _resolve_process_group(named["group_name"]).size()

    def paused(self, fn: Callable) -> Callable:
        """``fn`` with the recording paused while it runs."""

        def run(*args, **kwargs):
            self._paused += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self._paused -= 1

        return run

    # ------------------------------------------------------------ kernels
    def kernel_entry(self, fn: Callable) -> Callable:
        """``fn`` (a kernel's entry) recorded as one kernel call: its plain
        version's ops marked as inside it, and its own traffic (every
        tensor argument read once, every output written once) charged to
        ``kernel_bytes``."""

        def entry(*args, **kwargs):
            self._kernel_depth += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                self._kernel_depth -= 1
            if not self._kernel_depth:
                moved = sum(span_bytes(t) for t in _tensors((args, kwargs)))
                for t in _tensors(out):
                    moved += span_bytes(t)
                    entry = self._storages.get(storage_key(t))
                    if entry is not None:
                        self._hold(entry)
                self.trace.kernel_bytes += moved
            return out

        return entry


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """Record every op dispatched inside into ``recorder.trace``, with the
    kernels of :data:`KERNEL_ENTRIES` each recorded as one call and
    DTensor's sharding propagation (``ShardingPropagator``'s uncached
    path, which may run an op's decomposition) left out."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    rec = Recorder()
    patched: List[Tuple[object, str, Callable]] = []
    try:
        for module_name, attr in KERNEL_ENTRIES:
            module = importlib.import_module(module_name)
            fn = getattr(module, attr)
            patched.append((module, attr, fn))
            setattr(module, attr, rec.kernel_entry(fn))
        propagate = getattr(ShardingPropagator, "propagate_op_sharding_non_cached", None)
        if propagate is not None:  # a release without it propagates otherwise
            patched.append((ShardingPropagator, "propagate_op_sharding_non_cached", propagate))
            ShardingPropagator.propagate_op_sharding_non_cached = rec.paused(propagate)
        with rec:
            yield rec
    finally:
        for module, attr, fn in reversed(patched):
            setattr(module, attr, fn)

