"""Per-device counts of one step: FLOPs, HBM bytes, collectives and memory
(the dry run's, ``launch/dryrun.py``; the JAX package reads the same from
the post-SPMD HLO, ``launch/hlo_analysis.py``).

A :class:`Counter` is a ``TorchDispatchMode`` over the step. It counts the
operations one rank runs on its own tensors: an operation on DTensors is
left to DTensor (the mode returns ``NotImplemented``), which runs the
rank's local operations and its collectives under the mode, where they
are counted. DTensor's sharding propagation runs the operation once more
on stand-ins of the global shape, made by ``empty_strided``; those and
everything computed from them are marked and left out. So a rank's count
holds its own work only, whether its tensors are fake (a dry run over a
fake process group) or real (a run on the card, or on a gloo world).

* FLOPs: ``torch.utils.flop_counter``'s formulas for the products (mm,
  bmm, addmm, baddbmm, convolutions); a kernel call counts as the kernel
  (``counts.kernel``: ``ops.flash_attention`` adds 4·D FLOPs per unmasked
  pair and head) and the operations inside it (the plain version's on a
  CPU tensor) count nothing.
* HBM bytes, fused (``hbm_bytes``, the roofline's memory term): the
  reference's ``traffic_bytes_fused``, which counts only at the
  boundaries XLA does not fuse across and at its fusions. A boundary —
  a product, a gather (its table read as at most its output's bytes), a
  scatter or a write into a slice of a larger tensor (the update read
  and written), a copy, a concatenation, a pad, a collective or a kernel
  call — reads its operands and writes its results. Every other
  operation (elementwise, reductions, conversions) joins a fusion that
  ends at the next boundary: it reads a tensor from HBM once a fusion,
  and only one that is in HBM; what it makes stays in the fusion until a
  later fusion or a boundary reads it, when its write counts once, at
  the weight it was made under; a write into a tensor in HBM (an
  optimizer's update of its state) counts once a fusion.
* HBM bytes, unfused (``hbm_bytes_unfused``, the reference's
  ``traffic_bytes``): each counted operation's tensor inputs read once
  and its fresh outputs written once (a view moves nothing; an expanded
  input counts at most its storage); a kernel call its operands and
  outputs.
* Collectives: every ``_c10d_functional`` (DTensor's redistributes) and
  ``c10d`` (the port's own ``dist.all_reduce``) operation, by kind with
  its operand bytes and its group's size, the ring estimate as the
  reference's ``roofline.parse_collectives`` makes it: x (k - 1) for an
  all-gather, x 2 (k - 1) / k for an all-reduce, x (k - 1) / k otherwise.
* Memory: every fresh storage an operation returns is live until it is
  freed (a weak reference on the storage); ``temp_bytes`` is the most
  that is live at once, ``output_bytes`` what the step's result holds.
  The arguments are counted apart (``arg_bytes``).

The counter knows a storage by an id it hands out on first sight, never
by its address: a freed storage's address is soon another's, and an entry
keyed on it would pass to the new storage (a temporary scalar read in a
fusion hid the next one made at its address, so a count depended on the
allocator's state). A weak reference on each storage seen drops every
entry of its id when it is freed. An autograd node is known by an id kept
in its metadata, as its weight is.

Repeated units (``counts.repeat``) are multiplied, not unrolled, when the
counter is made with ``multiply``: of a loop of n > 4 iterations the first
two, a third and the last run, and the third's counts weigh n - 3, as the
HLO walk multiplies a ``while`` body by its trip count. The first two are
run because the first may differ from the rest (an accumulator that
starts as an alias of the first term), the last because it does (its
output leaves the loop, and the gradient that comes back for it is laid
out otherwise). A backward operation takes the weight of the forward
operation whose graph node runs it: every autograd node is tagged with
the weight it was made under (a ``TorchFunctionMode`` walks each result's
new nodes), and a checkpointed unit's recomputation runs under the node
that unpacks it.

Memory is not additive, so the peak is composed. What the weighted
iteration leaves behind is read from the live-storage ledger when the
last iteration ends: the weighted iteration's fresh storages still live
(saved activations, its piece of the loop's output, a checkpoint's saved
state) but the carry it hands on (those the last iteration reads, pieces
of the output aside), which the last one holds for its own backward; and
the carry it was handed (made by the iteration before it, read by it,
still live), which it holds so. A local that the next iteration rebinds
is freed by then and counts nothing. Those bytes L weigh n - 3 from then
until they are freed; with P the weighted iteration's own peak, the
loop's is P + (n - 4)·L, and the last iteration's own peak sits above
the same (n - 4)·L. In the backward, a gradient the weighted iteration
hands to a node made outside the loop, in a slot no other iteration
feeds (a stacked leaf's slice), weighs n - 3 until that node runs: the
full run holds one such gradient for each iteration until the stack,
which makes its own stand-ins for the iterations that did not run; those
stand-ins, and what is computed from them alone (DTensor's layout of
them), count nothing, as the full run has a gradient there.

On the dry run's ``cpu`` mesh DTensor moves a shard from one dim to
another by an all-gather and a chunk (gloo has no all-to-all), where a
CUDA mesh runs an all-to-all (``_dtensor.shard_dim_alltoall``, counted
as one): such a move counts as an all-gather there.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import math
import weakref
from typing import Dict, List, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor, unset_fake_temporarily
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary
from torch.utils.flop_counter import flop_registry

from repro_torch import counts
from repro_torch.distributed import is_dtensor

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")
_KIND = {  # op name -> kind (send, recv and broadcast: point to point)
    "shard_dim_alltoall": "all-to-all",  # DTensor's, on a CUDA mesh
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
    "send": "collective-permute", "recv_": "collective-permute",
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d", "_dtensor")
RUN = 2  # iterations of a multiplied loop run before the weighted one
_TAG = "dryrun_weight"  # autograd node metadata: its weight
_MARKS = "dryrun_iterations"  # ... and the loop iterations that made it
_STANDS_IN = "dryrun_stands_in"  # ... and that it fills missing gradients
_NODE = "dryrun_node"  # ... and its id (``_node_key``)
_NODE_IDS = itertools.count()
_SHAPE_ONLY = torch.ops.aten.empty_strided.default  # DTensor's stand-ins
_NO_TRAFFIC = (torch.ops.aten.empty.memory_format,
               torch.ops.aten.empty_like.default,
               torch.ops.aten.new_empty.default)  # allocations only
# Fused traffic's boundaries (module docstring), by aten op name: the
# reference's dot / convolution, gather / dynamic-slice, scatter /
# dynamic-update-slice, copy, concatenate and pad.
_PRODUCTS = frozenset({
    "mm", "bmm", "addmm", "baddbmm", "addbmm", "addmv", "mv", "dot",
    "vdot", "convolution", "_convolution", "convolution_backward",
    "_scaled_mm"})
_GATHERS = frozenset({"index", "_unsafe_index", "index_select", "gather",
                      "embedding", "take"})
_UPDATES = frozenset({  # in place: the destination is not read
    "copy_", "index_put_", "_index_put_impl_", "scatter_", "scatter_add_",
    "scatter_reduce_", "index_add_", "index_copy_", "masked_scatter_"})
_LAYOUT = frozenset({
    "clone", "copy", "cat", "stack", "constant_pad_nd", "pad",
    "reflection_pad1d", "reflection_pad2d", "reflection_pad3d",
    "replication_pad1d", "replication_pad2d", "replication_pad3d",
    "index_put", "scatter", "scatter_add", "scatter_reduce", "index_add",
    "index_copy", "masked_scatter", "slice_scatter", "select_scatter",
    "diagonal_scatter", "as_strided_scatter"})


@dataclasses.dataclass
class Counts:
    """What a step costs one rank (module docstring)."""

    flops: float = 0.0
    hbm_bytes: float = 0.0  # fused (module docstring)
    hbm_bytes_unfused: float = 0.0
    op_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_KINDS})
    op_counts: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0 for k in COLLECTIVE_KINDS})
    ring_bytes: float = 0.0
    kernel_flops: Dict[str, float] = dataclasses.field(default_factory=dict)
    arg_bytes: int = 0
    temp_bytes: int = 0
    output_bytes: int = 0

    def add_collective(self, kind: str, nbytes: float, k: int,
                       weight: float = 1) -> None:
        """One collective of ``kind`` on ``nbytes`` of operands over a
        group of ``k`` ranks, ``weight`` times."""
        self.op_bytes[kind] += nbytes * weight
        self.op_counts[kind] += weight
        self.ring_bytes += nbytes * ring_factor(kind, k) * weight

    @property
    def collective_bytes(self) -> float:
        return sum(self.op_bytes.values())

    @property
    def peak_bytes(self) -> int:
        return self.arg_bytes + self.temp_bytes

    def to_dict(self) -> dict:
        return {**dataclasses.asdict(self),
                "collective_bytes": self.collective_bytes,
                "peak_bytes": self.peak_bytes}


def ring_factor(kind: str, k: int) -> float:
    """The reference's ring estimate per operand byte (module
    docstring)."""
    if kind == "all-gather":
        return max(k - 1, 1)
    factor = 2.0 if kind == "all-reduce" else 1.0
    return factor * (k - 1) / max(k, 1)


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of a tensor's own part (a DTensor's local shard)."""
    if is_dtensor(t):
        t = t.to_local()
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in torch.utils._pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _storage(t: torch.Tensor):
    if is_dtensor(t):
        t = t._local_tensor
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return None


def _read_bytes(t: torch.Tensor) -> int:
    st = _storage(t)
    n = t.numel() * t.element_size()
    return n if st is None else min(n, st.nbytes())


def _boundary(name: str, ins, outs) -> bool:
    """Whether an aten op ends a fusion (module docstring): a copy into a
    whole tensor is elementwise, into a slice of a larger one an update;
    a conversion (``_to_copy``) is elementwise unless it changes device."""
    if name == "copy_":
        st = _storage(ins[0])
        return st is not None and _read_bytes(ins[0]) < st.nbytes()
    if name == "_to_copy":
        return bool(outs) and outs[0].device != ins[0].device
    return (name in _PRODUCTS or name in _GATHERS or name in _UPDATES
            or name in _LAYOUT)


def _node_key(node) -> int:
    """An autograd node's id, handed out on first sight and kept in its
    metadata (module docstring)."""
    meta = node.metadata
    if _NODE not in meta:
        meta[_NODE] = next(_NODE_IDS)
    return meta[_NODE]


def _group_size(func, args, kwargs) -> int:
    import torch.distributed.distributed_c10d as c10d

    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.ScriptObject):
            try:
                return c10d.ProcessGroup.unbox(a).size()
            except RuntimeError:  # a ReduceOp, a Work
                continue
        if isinstance(a, str):
            try:
                return c10d._resolve_process_group(a).size()
            except (RuntimeError, ValueError, KeyError):
                continue
    raise ValueError(f"no process group in the arguments of {func}")


class _Record:
    __slots__ = ("nbytes", "weight", "seq")

    def __init__(self, nbytes: int, seq: int):
        self.nbytes, self.weight, self.seq = nbytes, 1, seq


class _Tagger(TorchFunctionMode):
    """Tags every autograd node a torch call makes with the counter's
    current weight (module docstring)."""

    def __init__(self, counter: "Counter"):
        super().__init__()
        self.counter = counter

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.counter.tag(out)
        return out


class Counter(TorchDispatchMode):
    """Counts one rank's work in the block (module docstring): ``with
    Counter(multiply) as c: step()``; then ``c.counts``."""

    def __init__(self, multiply: bool = False):
        super().__init__()
        self.multiply = multiply
        self.fake = False  # counting under a FakeTensorMode
        self.counts = Counts()
        # Open loop iterations: (weight, entered in a backward, (loop,
        # 0 for an unweighted iteration or 1 for the weighted one)).
        self._weights: List = []
        self._suppress = 0
        self._next_frame = 0
        self._frame_w: Dict[int, int] = {}
        self._slots: Dict[tuple, set] = {}
        self._held: Dict[int, list] = {}
        self._marked = WeakIdKeyDictionary()
        # Each storage seen: its address -> (its id, a weak reference that
        # drops the id's entries when it is freed); by id, the fresh ones.
        self._ids: Dict[int, tuple] = {}
        self._next_id = 0
        self._storages: Dict[int, _Record] = {}
        self._seq = 0
        self._live = 0
        # Fused traffic: storages a fusion made and no later one has read
        # (key -> (fusion, weight, bytes)); the reads and writes of HBM
        # the current fusion has counted.
        self._pending: Dict[int, tuple] = {}
        self._fusion = 0
        self._in_fusion: Dict[int, set] = {}
        self._reading: List[set] = []  # storages read, per open iteration
        self._stands_in = False  # a stack has made stand-ins
        self._fill = WeakIdKeyDictionary()  # ... these, and from them alone
        self._peak = 0
        self._open = False
        self._tagger = _Tagger(self)

    # ------------------------------------------------------------ the block
    def __enter__(self):
        self._open = True
        self.fake = torch._C._get_dispatch_mode(
            torch._C._TorchDispatchModeKey.FAKE) is not None
        counts.install(self)
        self._tagger.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._tagger.__exit__(*exc)
            counts.install(None)
            self.counts.temp_bytes = self._peak

    def finish(self, result) -> Counts:
        """Close the count on the step's ``result``: its fresh storages
        are the output bytes. Returns the counts."""
        seen = set()
        total = 0
        for t in _tensors(result):
            key = self._key(t)
            rec = self._storages.get(key)
            if rec is not None and key not in seen:
                seen.add(key)
                total += rec.nbytes * rec.weight
        self.counts.output_bytes = total
        self.counts.hbm_bytes += self._materialize(_tensors(result))
        self.counts.temp_bytes = self._peak
        self._open = False
        return self.counts

    # ------------------------------------------------------------- weights
    def weight(self) -> float:
        """The weight of an operation run now: in a backward, its node's
        tag times the loops entered since; else every open loop's."""
        node = torch._C._current_autograd_node()
        base = None if node is None else node.metadata.get(_TAG)
        if base is None:
            return math.prod(w for w, _, _ in self._weights)
        return base * math.prod(w for w, bwd, _ in self._weights if bwd)

    def tag(self, out) -> None:
        """Tag the autograd nodes behind ``out`` that have no tag yet with
        the current weight and loop iterations; a node of a weighted
        iteration whose gradient leaves for a node made outside the loop,
        in a slot no other iteration feeds (a stacked leaf's slice), gets
        the hook that weighs that gradient (:meth:`_outflow`)."""
        todo = [t.grad_fn for t in _tensors(out) if t.grad_fn is not None]
        if not todo:
            return
        w = self.weight()
        marks = tuple(m for _, _, m in self._weights)
        while todo:
            node = todo.pop()
            if node is None:
                continue
            meta = node.metadata
            if _TAG in meta:
                continue
            meta[_TAG] = w
            meta[_MARKS] = marks
            leaving = []
            for i, (nxt, nr) in enumerate(node.next_functions):
                if nxt is None:
                    continue
                outer = nxt.metadata.get(_MARKS)
                if outer is None:
                    todo.append(nxt)
                    continue
                for frame, it in marks:
                    if (frame, 0) not in outer and (frame, 1) not in outer:
                        self._slots.setdefault((frame, _node_key(nxt), nr),
                                               set()).add(it)
                        if it == 1:
                            leaving.append((i, frame, nxt, nr))
            if leaving:
                node.register_hook(functools.partial(self._outflow, leaving))

    def _outflow(self, leaving, grads, _grad_outputs) -> None:
        """A weighted iteration's node has run: each gradient it hands to a
        node outside its loop, in a slot of this iteration alone, stands
        for the n - 1 iterations' gradients the full run holds there until
        that node runs; when it does (a stack of the slices), it makes its
        own stand-ins for the iterations not run, and the weight goes."""
        for i, frame, nxt, nr in leaving:
            g = grads[i]
            if g is None or self._slots.get(
                    (frame, _node_key(nxt), nr)) != {1}:
                continue
            key = self._key(g)
            rec = self._storages.get(key)
            if rec is None:
                continue
            factor = self._frame_w[frame]
            self._live += rec.nbytes * rec.weight * (factor - 1)
            rec.weight *= factor
            self._peak = max(self._peak, self._live)
            held = self._held.setdefault(_node_key(nxt), [])
            if not held:
                nxt.register_prehook(functools.partial(self._stood_in, nxt,
                                                       held))
            held.append((key, rec, factor))

    def _stood_in(self, node, held, _grad_outputs) -> None:
        node.metadata[_STANDS_IN] = True
        self._stands_in = True
        for key, rec, factor in held:
            if self._storages.get(key) is rec:
                before = rec.weight
                rec.weight //= factor
                self._live -= rec.nbytes * (before - rec.weight)
        held.clear()

    @contextlib.contextmanager
    def kernel(self, name: str, flops: float, nbytes: float, inputs=()):
        """One kernel call (``counts.kernel``): a boundary of fused
        traffic, reading ``inputs``."""
        w = self.weight()
        if not self._suppress:
            c = self.counts
            c.flops += flops * w
            c.hbm_bytes += nbytes * w + self._materialize(inputs)
            c.hbm_bytes_unfused += nbytes * w
            c.kernel_flops[name] = c.kernel_flops.get(name, 0) + flops * w
        self._suppress += 1
        try:
            yield
        finally:
            self._suppress -= 1
            if not self._suppress:
                self._end_fusion()

    def repeat(self, n: int, outs=None):
        """The iterations of a repeated unit (module docstring); ``outs``
        the list the loop appends its pieces to."""
        if not self.multiply or n <= RUN + 2:
            yield from range(n)
            return
        frame, w = self._next_frame, n - RUN - 1
        self._next_frame += 1
        self._frame_w[frame] = w
        bwd = torch._C._current_autograd_node() is not None

        def run(i, weight, mark, reads=None):
            self._weights.append((weight, bwd, (frame, mark)))
            if reads is not None:
                self._reading.append(reads)
            try:
                yield i
            finally:
                self._weights.pop()
                if reads is not None:
                    self._reading = [r for r in self._reading
                                     if r is not reads]

        for i in range(RUN):
            before = self._seq  # the iteration before the weighted one
            yield from run(i, 1, 0)
        seq0, outer_peak = self._seq, self._peak
        self._peak = self._live
        read_weighted, read_last = set(), set()
        yield from run(RUN, w, 1, read_weighted)
        seq1, peak = self._seq, self._peak
        self._peak = self._live
        yield from run(n - 1, 1, 0, read_last)
        pieces = (set() if outs is None
                  else {self._key(t) for t in _tensors(outs)})
        left = 0
        for key, rec in self._storages.items():
            made = seq0 <= rec.seq < seq1
            if (made and (key in pieces or key not in read_last)
                    or (before <= rec.seq < seq0 and key in read_weighted
                        and key not in pieces)):
                left += rec.nbytes * rec.weight
                rec.weight *= w
        extra = (w - 1) * left
        self._peak = max(outer_peak, peak + extra, self._peak + extra)
        self._live += extra

    # ------------------------------------------------------------ dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        if any(is_dtensor(a) for a in ins):
            return NotImplemented
        if self.fake and self._real(func, ins):
            with unset_fake_temporarily():
                out = func(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
        self._account(func, args, kwargs, out)
        return out

    @staticmethod
    def _filling() -> bool:
        """Whether the node running now is a stack's (an unbind's backward)
        filling the gradients of the iterations a multiplied count did not
        run: the zeros it makes, and whatever is computed from them alone
        (DTensor's layout of them), are left out as the shape-only
        stand-ins are; the full run has a gradient there."""
        node = torch._C._current_autograd_node()
        return node is not None and node.metadata.get(_STANDS_IN, False)

    @staticmethod
    def _real(func, ins) -> bool:
        """Under fake tensors, whether ``func`` runs on real ones: an
        ``arange`` and whatever is computed from real tensors alone, the
        index arithmetic that reads its values (DTensor's shard offsets, a
        ring's slot positions)."""
        if not ins:
            return func._overloadpacket is torch.ops.aten.arange
        return not any(isinstance(t, FakeTensor) for t in ins)

    def _account(self, func, args, kwargs, out) -> None:
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if self._stands_in and (all(t in self._fill for t in ins) if ins
                                else self._filling()):
            for t in outs:
                self._fill[t] = True
            return
        if func is _SHAPE_ONLY or any(t in self._marked for t in ins):
            for t in outs:
                self._marked[t] = True
            return
        if self._reading:
            keys = {self._key(t) for t in ins}
            for reads in self._reading:
                reads |= keys
        ns = func.namespace
        if ns in _COLLECTIVE_NS:
            kind = _KIND.get(func._opname)
            if kind is not None:
                self._collective(kind, func, args, kwargs, ins, outs)
        elif not self._suppress:
            self._compute(func, args, kwargs, out, ins, outs)
        self._track(func, ins, out, outs)

    def _collective(self, kind, func, args, kwargs, ins, outs) -> None:
        """A collective: counted by kind, and a boundary of fused traffic
        (its operands read, its results written)."""
        w = self.weight()
        operand = sum(_read_bytes(t) for t in ins)
        self.counts.add_collective(kind, operand,
                                   _group_size(func, args, kwargs), w)
        moved = (operand + sum(_read_bytes(t) for t in outs)) * w
        self.counts.hbm_bytes_unfused += moved
        self.counts.hbm_bytes += moved + self._materialize(ins)
        self._end_fusion()

    def _compute(self, func, args, kwargs, out, ins, outs) -> None:
        w = self.weight()
        packet = func._overloadpacket
        if packet in flop_registry:
            self.counts.flops += flop_registry[packet](
                *args, **kwargs, out_val=out) * w
        if func in _NO_TRAFFIC:
            return
        fresh = self._fresh(func, out)
        writes = [t for t, new in fresh if new]
        written = ([t for t, new in fresh if not new]
                   if self._writes(func) else [])
        if not writes and not written:
            return
        self.counts.hbm_bytes_unfused += w * (
            sum(_read_bytes(t) for t in ins)
            + sum(_read_bytes(t) for t in writes + written))
        name = func._opname
        if _boundary(name, ins, outs):
            self._boundary_traffic(name, ins, writes, written, w)
        else:
            self._fused_traffic(ins, writes, written, w)

    # --------------------------------------------------------- fused bytes
    def _boundary_traffic(self, name, ins, writes, written, w) -> None:
        if name in _GATHERS:
            table = min(_read_bytes(ins[0]),
                        sum(_read_bytes(t) for t in writes))
            moved = table + sum(_read_bytes(t) for t in ins[1:] + writes)
        elif name in _UPDATES:  # the update read and written
            update = _read_bytes(ins[-1]) if len(ins) > 1 else 0
            moved = update + sum(_read_bytes(t) for t in ins[1:])
        else:
            moved = (sum(_read_bytes(t) for t in ins)
                     + sum(_read_bytes(t) for t in writes + written))
        self.counts.hbm_bytes += moved * w + self._materialize(ins)
        for t in written:
            self._pending.pop(self._key(t), None)
        self._end_fusion()

    def _fused_traffic(self, ins, writes, written, w) -> None:
        moved = 0
        for t, how in [(t, "r") for t in ins] + [(t, "w") for t in written]:
            key = self._key(t)
            made = self._pending.get(key)
            if made is not None:
                if made[0] == self._fusion:
                    continue  # made in this fusion: never in HBM
                self.counts.hbm_bytes += self._materialize((t,))
            mark = (t.storage_offset(), _read_bytes(t), how)
            marks = self._in_fusion.setdefault(key, set())
            if mark not in marks:
                marks.add(mark)
                moved += _read_bytes(t)
        self.counts.hbm_bytes += moved * w
        for t in writes:
            st = _storage(t)
            if st is not None:
                self._pending[self._key(t)] = (self._fusion, w, st.nbytes())

    def _materialize(self, tensors) -> float:
        """The writes of the storages of ``tensors`` that a fusion made and
        no one has read yet, each at the weight it was made under; they
        are in HBM from now on."""
        total = 0.0
        for t in tensors:
            made = self._pending.pop(self._key(t), None)
            if made is not None:
                total += made[1] * made[2]
        return total

    def _end_fusion(self) -> None:
        self._fusion += 1
        self._in_fusion.clear()

    @staticmethod
    @functools.lru_cache(maxsize=None)
    def _aliases(func) -> tuple:
        return tuple((r.alias_info is not None,
                      r.alias_info is not None and r.alias_info.is_write)
                     for r in func._schema.returns)

    def _writes(self, func) -> bool:
        return any(w for _, w in self._aliases(func))

    def _fresh(self, func, out):
        """(tensor, not an alias of an input) for each tensor result."""
        flags = self._aliases(func)
        if isinstance(out, (tuple, list)) and len(out) == len(flags) > 1:
            pairs = zip(out, flags)
        else:
            pairs = ((t, flags[0] if flags else (False, False))
                     for t in (out if isinstance(out, (tuple, list))
                               else (out,)))
        res = []
        for t, (alias, _) in pairs:
            for leaf in _tensors(t):
                res.append((leaf, not alias))
        return res

    def _track(self, func, ins, out, outs) -> None:
        if not outs:
            return
        in_keys = {self._key(t) for t in ins}
        for t, fresh in self._fresh(func, out):
            if not fresh:
                continue
            st = _storage(t)
            if st is None:
                continue
            key = self._key(t)
            if key in in_keys or key in self._storages:
                continue
            rec = _Record(st.nbytes(), self._seq)
            self._seq += 1
            self._storages[key] = rec
            self._live += rec.nbytes
            if self._live > self._peak:
                self._peak = self._live

    def _key(self, t: torch.Tensor) -> Optional[int]:
        """The id of ``t``'s storage (module docstring)."""
        st = _storage(t)
        if st is None:
            return None
        addr = st._cdata
        seen = self._ids.get(addr)
        if seen is not None and seen[1]() is st:
            return seen[0]
        key = self._next_id
        self._next_id += 1
        self._ids[addr] = (key, weakref.ref(
            st, functools.partial(self._freed, addr, key)))
        return key

    def _freed(self, addr: int, key: int, _ref) -> None:
        """A storage seen is freed: its id's entries go."""
        if self._ids.get(addr, (None,))[0] == key:
            del self._ids[addr]
        self._pending.pop(key, None)
        self._in_fusion.pop(key, None)
        rec = self._storages.pop(key, None)
        if rec is not None and self._open:
            self._live -= rec.nbytes * rec.weight
