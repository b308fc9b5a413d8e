"""Logical-axis sharding and declarative parameter trees (the JAX
package's ``distributed.py``).

Model code names each tensor axis by a *logical* name; a
:class:`ShardingRules` mapping, installed with :func:`use_rules` together
with a mesh, translates the names to a :class:`PartitionSpec` of mesh
axes. The port's mesh is a ``torch.distributed`` ``DeviceMesh`` whose
``mesh_dim_names`` are the axis names (``launch/mesh.py``), and a spec
becomes DTensor placements (:func:`placements`): ``Shard(d)`` on every mesh
dim that tensor dim ``d`` is split over, ``Replicate()`` elsewhere.
:func:`constrain` redistributes a DTensor to its spec's placements (the
reference's ``with_sharding_constraint``). Outside a mesh, or on a mesh of
one rank, tensors stay plain and every constraint is the identity, so the
same model code runs on one card bit for bit as without rules. The
production meshes (``launch/mesh.py::make_production_mesh``) are abstract:
axis names and sizes that the rules and spec derivations read.

A tree of :class:`ParamDef` leaves can be initialized, shape-evaluated,
stacked and given specs without duplicating the model's layout.
``ParamDef.logical`` keeps the reference's logical axis names.

Random leaves are drawn from an explicit ``torch.Generator``, leaf after
leaf in tree order, on the generator's device: a full-width init on the
card costs no host time and repeats bit for bit from the same seed. The
reference splits a JAX key per leaf; the two packages' random streams
differ, so the tests carry weights across (``repro_torch.convert``).
"""
from __future__ import annotations

import contextlib
import functools
import inspect
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.device import DeviceLike
from repro_torch.tree import tree_map

MeshAxes = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """Per leaf axis, the mesh axis name (or tuple of names) it is split
    over, or ``None`` (the JAX ``PartitionSpec``, which also stores a
    one-name tuple as the name)."""

    def __new__(cls, *axes):
        return super().__new__(cls, (
            a[0] if isinstance(a, (tuple, list)) and len(a) == 1
            else tuple(a) if isinstance(a, list) else a for a in axes))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"



class ShardingRules(dict):
    """Maps logical axis name -> mesh axis (or tuple of axes, or None)."""

    def spec_for(self, logical_axes: Sequence[Optional[str]]
                 ) -> PartitionSpec:
        """The spec of a tensor whose axes carry ``logical_axes``. A mesh
        axis already used by an earlier dim is dropped (a mesh axis splits
        at most one dim of a tensor), as in the reference."""
        out = []
        used: set = set()
        for name in logical_axes:
            axes = self.get(name) if name is not None else None
            if isinstance(axes, (tuple, list)):
                axes = tuple(a for a in axes if a not in used)
                used.update(axes)
                axes = axes if axes else None
                if isinstance(axes, tuple) and len(axes) == 1:
                    axes = axes[0]
            elif isinstance(axes, str):
                if axes in used:
                    axes = None
                else:
                    used.add(axes)
            out.append(axes)
        return PartitionSpec(*out)


_STATE = threading.local()


def current_rules() -> Optional[ShardingRules]:
    return getattr(_STATE, "rules", None)


def current_mesh():
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules], mesh=None):
    """Install ``rules`` and ``mesh`` for the calling thread (restored on
    exit). On a ``DeviceMesh`` of more than one rank, plain tensors that
    meet DTensors in an operation (positions, rope tables, masks) count as
    replicated."""
    prev = (getattr(_STATE, "rules", None), getattr(_STATE, "mesh", None),
            getattr(_STATE, "ranks", 1))
    _STATE.rules, _STATE.mesh = rules, mesh
    _STATE.ranks = mesh_size(mesh)
    try:
        if is_device_mesh(mesh) and _STATE.ranks > 1:
            from torch.distributed.tensor.experimental import (
                implicit_replication)
            with implicit_replication():
                yield
        else:
            yield
    finally:
        _STATE.rules, _STATE.mesh, _STATE.ranks = prev


# ------------------------------------------------------------------- meshes
def is_device_mesh(mesh) -> bool:
    from torch.distributed.device_mesh import DeviceMesh

    return isinstance(mesh, DeviceMesh)


def axis_names(mesh) -> Tuple[str, ...]:
    """The axis names of a ``DeviceMesh`` or of an abstract mesh."""
    if is_device_mesh(mesh):
        return tuple(mesh.mesh_dim_names)
    return tuple(mesh.axis_names)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of an abstract mesh."""
    if is_device_mesh(mesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def mesh_axis_size(mesh, axes: MeshAxes) -> int:
    if mesh is None or axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    size = 1
    for a in axes:
        size *= sizes[a]
    return size


def mesh_size(mesh) -> int:
    """Ranks (or devices) of the whole mesh; 1 without one."""
    if mesh is None:
        return 1
    return mesh_axis_size(mesh, axis_names(mesh))


def spec_axes(entry: MeshAxes) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, in order."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: PartitionSpec, mesh) -> List:
    """DTensor placements of ``spec`` over a ``DeviceMesh``, one per mesh
    dim: ``Shard(d)`` where tensor dim d is split over that mesh dim, else
    ``Replicate()``. A tuple entry splits its dim over several mesh dims,
    the first the outermost, which DTensor's order of mesh dims gives only
    when the tuple follows the mesh's order: otherwise this raises. A mesh
    dim of one rank replicates (a split in one piece is the whole)."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        unknown = [a for a in axes if a not in names]
        if unknown:
            raise ValueError(f"{spec} names axes {unknown} that the mesh "
                             f"{names} does not have")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: the axes {axes} of dim {d} are not in "
                             f"the mesh's order {names}")
        for i in idx:
            if mesh.size(i) > 1:
                out[i] = Shard(d)
    return out


_DTENSOR = []  # the DTensor class, imported at first use


def is_dtensor(x) -> bool:
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor

        _DTENSOR.append(DTensor)
    return isinstance(x, _DTENSOR[0])


def full_tensor(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value on every rank (a collective); a plain
    tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def chunk_range(n: int, parts: int, index: int) -> Tuple[int, int]:
    """(offset, length) of piece ``index`` of a dim of ``n`` cut into
    ``parts`` as ``torch.chunk`` cuts it, as DTensor lays a ``Shard``
    out."""
    chunk = -(-n // parts)
    start = min(index * chunk, n)
    return start, min(start + chunk, n) - start


def local_range(x, dim: int) -> Tuple[int, int]:
    """(offset, length) of this rank's part of DTensor ``x`` along
    ``dim``: the mesh dims that shard it split it in mesh order, each in
    ``chunk_range``'s pieces."""
    from torch.distributed.tensor import Shard

    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    offset, size = 0, x.shape[dim]
    for i, pl in enumerate(x.placements):
        if isinstance(pl, Shard) and pl.dim % x.ndim == dim % x.ndim:
            start, size = chunk_range(size, mesh.size(i), coord[i])
            offset += start
    return offset, size


def logical_spec(*logical_axes: Optional[str]) -> PartitionSpec:
    rules = current_rules()
    if rules is None:
        return PartitionSpec()
    return rules.spec_for(logical_axes)


def constrain(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """``x`` laid out as its logical axes say under the current rules and
    mesh: a DTensor is redistributed to the spec's placements. The
    identity without rules or a mesh, and for a plain tensor on a mesh of
    one rank; a plain tensor on a mesh of more ranks raises."""
    rules, mesh = current_rules(), current_mesh()
    if rules is None or mesh is None:
        return x
    if x.ndim != len(logical_axes):
        raise ValueError(f"rank {x.ndim} vs logical axes {logical_axes}")
    if not is_dtensor(x):
        if _STATE.ranks > 1:
            raise TypeError(
                f"constrain{logical_axes}: a plain tensor of shape "
                f"{tuple(x.shape)} under a mesh of {mesh_size(mesh)} ranks; "
                "place it on the mesh first (param_shardings, "
                "runtime.elastic.reshard_tree)")
        return x
    return x.redistribute(x.device_mesh,
                          placements(rules.spec_for(logical_axes), mesh))


FSDP_AXES = ("embed", "expert_in")  # logical axes of a weight's FSDP split


def gathered(w: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """A weight as a layer multiplies by it: its FSDP split (the mesh axes
    of ``FSDP_AXES`` under the current rules) gathered, its tensor-parallel
    split kept, as the reference's partitioner gathers an FSDP weight
    before its product. Left to DTensor, a product of batch-split
    activations with a weight split on its contraction over the same axis
    runs on whole activations (a partial sum of every rank's). The
    identity on a plain tensor or without rules."""
    rules = current_rules()
    if rules is None or not is_dtensor(w):
        return w
    whole = ShardingRules(rules)
    for name in FSDP_AXES:
        whole[name] = None
    want = placements(whole.spec_for(logical_axes), w.device_mesh)
    if tuple(w.placements) == tuple(want):
        return w
    return w.redistribute(w.device_mesh, want)


# ----------------------------------------------------------- per-rank bodies
# A layer that DTensor's own op strategies cannot hold across ranks (the
# MoE's index dispatch, the Mamba / xLSTM chunk loops) runs as a per-rank
# *body*: a plain function of this rank's local tensors, which the layer
# calls through :func:`per_rank`. The body holds its share of every weight
# dim named below ("model"'s part of the channels or experts) and the whole
# of every other dim (gathered over the data axes: FSDP); activations come
# with their batch split as the data axes split it and whole over "model".
# A body that needs a sum over "model" before it can go on is a generator:
# it yields its term and resumes with the sum. :func:`run_serial` runs R
# such bodies one after another on one device, as R ranks of one "model"
# axis would run them, which is how a body is checked on one card.
MODEL_SPLIT = ("ff", "ff2", "expert")  # dims a body holds a share of


def _dim_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def token_placements(x) -> List:
    """Where a body takes activations x [B, ...]: the batch split over
    each mesh dim other than "model" that x splits it over already, whole
    over "model" and elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if name != "model" and isinstance(p, Shard)
            and p.dim == 0 else Replicate()
            for name, p in zip(_dim_names(x.device_mesh), x.placements)]


def rank_placements(mesh, logical: Sequence[Optional[str]]) -> List:
    """Where a body takes a parameter or cache of these logical axes: the
    first dim named in ``MODEL_SPLIT`` split over "model" (where it has
    more than one rank: a split in one piece is the whole, as
    :func:`placements` lays it out), the rest whole (gathered over every
    other mesh dim)."""
    from torch.distributed.tensor import Replicate, Shard

    dims = [d for d, name in enumerate(logical) if name in MODEL_SPLIT]
    return [Shard(dims[0]) if name == "model" and dims and mesh.size(i) > 1
            else Replicate() for i, name in enumerate(_dim_names(mesh))]


def split_dims(tokens: Sequence, mesh) -> Tuple[int, ...]:
    """The mesh dims over which a body's work is split, given its tokens'
    placements (``token_placements``): "model"'s, and every dim that
    splits the batch."""
    from torch.distributed.tensor import Shard

    return tuple(i for i, (name, p) in enumerate(zip(_dim_names(mesh),
                                                      tokens))
                 if name == "model" or isinstance(p, Shard))


def take_local(x: torch.Tensor, placements: Sequence,
               split: Sequence[int]) -> torch.Tensor:
    """DTensor ``x`` laid out by ``placements`` and taken local. Its
    gradient comes back split as ``placements`` split it, and ``Partial``
    on each mesh dim of ``split`` (``split_dims``) that replicates it:
    there every rank adds the gradient of its own part of the work."""
    from torch.distributed.tensor import Partial, Replicate

    if tuple(x.placements) != tuple(placements):
        x = x.redistribute(x.device_mesh, placements)
    grads = [Partial() if i in split and isinstance(p, Replicate) else p
             for i, p in enumerate(placements)]
    return x.to_local(grad_placements=grads)


def give_back(local: torch.Tensor, mesh, placements: Sequence):
    """A DTensor of this rank's ``local`` part (made contiguous) under
    ``placements``."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local.contiguous(), mesh, placements)


def partial_over_model(tokens: Sequence, mesh) -> List:
    """``tokens``' placements with "model" a ``Partial`` sum: a body's
    term of a sum over the model axis."""
    from torch.distributed.tensor import Partial

    return [Partial() if name == "model" else p
            for name, p in zip(_dim_names(mesh), tokens)]


def _sum_over_model(part: torch.Tensor, mesh, tokens) -> torch.Tensor:
    """Every model rank's ``part`` summed (an all-reduce through DTensor,
    so autograd crosses it), local again; its gradient comes back a
    ``Partial`` sum, each rank's use of the sum being its own."""
    if mesh.size(_dim_names(mesh).index("model")) == 1:
        return part
    pls = partial_over_model(tokens, mesh)
    whole = give_back(part, mesh, pls).redistribute(mesh, list(tokens))
    return whole.to_local(grad_placements=pls)


def drive(result, reduce):
    """A body's result: a generator runs to its end, each term it yields
    answered with ``reduce(term)``; anything else is the result."""
    if not inspect.isgenerator(result):
        return result
    answer = None
    try:
        while True:
            answer = reduce(result.send(answer))
    except StopIteration as stop:
        return stop.value


def per_rank(body, mesh, args: Sequence, outs: Sequence, tokens: Sequence):
    """Run a per-rank ``body`` (section comment) on this rank's parts.
    ``args`` are (value, placements) pairs: a DTensor is taken local by
    ``take_local`` (its gradient ``Partial`` over the dims ``split_dims``
    names for ``tokens``), a value with placements None is passed as it
    is. ``body(*locals)`` returns a tuple, or is a generator whose terms
    are summed over "model" (``_sum_over_model``). ``outs`` gives, for
    each output, the placements of the DTensor it becomes (``Partial`` on
    "model" where it is this rank's term of a sum), or None to return it
    as it is (a cache the body wrote, a count)."""
    split = split_dims(tokens, mesh)
    local = [v if pls is None else take_local(v, pls, split)
             for v, pls in args]
    result = drive(body(*local), lambda t: _sum_over_model(t, mesh, tokens))
    return tuple(r if pls is None else give_back(r, mesh, pls)
                 for r, pls in zip(result, outs))


def term(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A rank's term of a contraction over its share of a dim, ``a @ w``
    in fp32: the products of bf16 operands are exact there, so the sum of
    the ranks' terms rounds once to the activations' dtype, as the
    unsharded GEMM (fp32 accumulation, one rounding) does."""
    return a.float() @ w.float()


def model_range(mesh, n: int) -> Tuple[int, int]:
    """(offset, length) of this rank's share of a dim of ``n`` split over
    "model" (``chunk_range``)."""
    i = _dim_names(mesh).index("model")
    return chunk_range(n, mesh.size(i), mesh.get_coordinate()[i])


def run_mixer(body, params, defs, x: torch.Tensor, cache=None,
              cache_defs=None) -> torch.Tensor:
    """A mixer layer across ranks: ``body(params, x, cache=...)`` (a
    per-rank body whose one output is its term of y [B, S, D], fp32) on
    this rank's
    parts: ``params`` laid out as ``rank_placements`` of ``defs``' logical
    axes, x as ``token_placements``, each cache leaf taken local where it
    lies (its model dim as ``rank_placements`` of ``cache_defs`` says, its
    batch as the tokens'; otherwise this raises, since a cache is written
    in place). A cache whole over a mesh dim that splits the tokens' batch
    (serving on two pods: "kv_batch" is "data" alone, "act_batch" ("pod",
    "data")) sets the layout: the layer runs on the tokens gathered over
    that dim, as every rank holding the same cache rows must. Returns y
    summed over "model", laid out as x's tokens, in x's dtype."""
    mesh = x.device_mesh
    out = tokens = token_placements(x)
    if cache is not None:
        from torch.distributed.tensor import Replicate

        lead = next(iter(cache.values())).placements
        tokens = [Replicate() if name != "model" and not c.is_shard() else t
                  for name, t, c in zip(_dim_names(mesh), tokens, lead)]
    keys = list(params)
    args = [(params[k], rank_placements(mesh, defs[k].logical))
            for k in keys] + [(x, tokens)]
    local = None
    if cache is not None:
        local = {}
        for k, leaf in cache.items():
            want = [p if name == "model" else t for name, p, t in zip(
                _dim_names(mesh), rank_placements(
                    mesh, cache_defs[k].logical), tokens)]
            if tuple(leaf.placements) != tuple(want):
                raise ValueError(f"cache {k!r} is laid out as "
                                 f"{leaf.placements}, its layer runs on "
                                 f"{want}")
            local[k] = leaf.to_local()

    def call(*vals):
        return body(dict(zip(keys, vals[:-1])), vals[-1], cache=local)

    (y,) = per_rank(call, mesh, args, [partial_over_model(tokens, mesh)],
                    tokens)
    return y.redistribute(mesh, out).to(x.dtype)


def run_serial(results: Sequence):
    """R per-rank bodies' ``results`` (generators resume; anything else is
    a finished result) run one after another on one device, as R ranks of
    one model axis: each round of terms is summed in rank order and sent
    back to every body. Returns each rank's result, in rank order."""
    done = list(results)
    live = {i: r for i, r in enumerate(done) if inspect.isgenerator(r)}
    answer = None
    while live:
        terms, ranks = {}, len(live)
        for i, gen in list(live.items()):
            try:
                terms[i] = gen.send(answer)
            except StopIteration as stop:
                done[i] = stop.value
                del live[i]
        if terms and len(terms) != ranks:
            raise RuntimeError("per-rank bodies yielded different numbers "
                               "of terms")
        if terms:
            answer = functools.reduce(torch.add, [terms[i]
                                                  for i in sorted(terms)])
    return done


def named_sharding(mesh, *logical_axes: Optional[str]):
    from repro_torch.runtime.elastic import NamedSharding

    rules = current_rules()
    spec = rules.spec_for(logical_axes) if rules else PartitionSpec()
    return NamedSharding(mesh, spec)


class ParamDef:
    """Declares one parameter: shape, logical axes, initializer."""

    __slots__ = ("shape", "logical", "init", "dtype", "scale")

    def __init__(self, shape, logical, init="normal", dtype=torch.float32,
                 scale=None):
        assert len(shape) == len(logical), (shape, logical)
        self.shape = tuple(int(s) for s in shape)
        self.logical = tuple(logical)
        self.init = init
        self.dtype = dtype
        self.scale = scale

    def initialize(self, gen: torch.Generator,
                   device: DeviceLike = None) -> torch.Tensor:
        """The leaf on ``device`` (default: the generator's); a "normal"
        leaf is N(0, 1) drawn in fp32 on the generator's device, times
        ``scale`` (default fan_in ** -0.5, fan_in the leading dim as in
        the reference), cast to ``dtype``."""
        dev = torch.device(gen.device if device is None else device)
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=dev)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=dev)
        if self.init == "const":
            return torch.full(self.shape, self.scale, dtype=self.dtype,
                              device=dev)
        fan_in = self.shape[0] if len(self.shape) > 1 else max(self.shape[0],
                                                                1)
        scale = self.scale if self.scale is not None else fan_in ** -0.5
        x = torch.randn(self.shape, generator=gen, dtype=torch.float32,
                        device=gen.device).mul_(scale)
        return x.to(device=dev, dtype=self.dtype)

    def meta(self) -> torch.Tensor:
        """A storage-free stand-in of the leaf's shape and dtype (the
        reference's ``ShapeDtypeStruct``)."""
        return torch.empty(self.shape, dtype=self.dtype, device="meta")


def is_param_def(x) -> bool:
    return isinstance(x, ParamDef)


def init_params(defs, gen: torch.Generator,
                device: Optional[DeviceLike] = None):
    """Materialize a ParamDef tree into tensors, drawing the random leaves
    from ``gen`` in tree order."""
    return tree_map(lambda d: d.initialize(gen, device), defs,
                    is_leaf=is_param_def)


def param_shapes(defs):
    """The tree of meta tensors: shapes and dtypes, no storage."""
    return tree_map(lambda d: d.meta(), defs, is_leaf=is_param_def)


def param_specs(defs):
    """PartitionSpec tree for a ParamDef tree under the current rules."""
    rules = current_rules() or ShardingRules()
    return tree_map(lambda d: rules.spec_for(d.logical), defs,
                    is_leaf=is_param_def)


def param_shardings(defs, mesh):
    """A tree of ``runtime.elastic.NamedSharding`` on ``mesh``, one per
    ParamDef, under the current rules."""
    from repro_torch.runtime.elastic import shardings_for

    return shardings_for(mesh, param_specs(defs))


def place_tree(tree, defs):
    """``tree`` (tensors like the ParamDef tree ``defs``) laid out by
    ``defs``' specs under the current rules and mesh; unchanged without
    rules or a ``DeviceMesh`` of more than one rank."""
    mesh = current_mesh()
    if (current_rules() is None or not is_device_mesh(mesh)
            or mesh_size(mesh) == 1):
        return tree
    from repro_torch.runtime.elastic import reshard_tree

    return reshard_tree(tree, param_shardings(defs, mesh))


def init_placed(defs, device: DeviceLike = None):
    """The deterministic leaves (zeros, ones, const) of a ParamDef tree,
    laid out by their specs under the current rules and mesh: on a
    ``DeviceMesh`` of more than one rank each rank makes its own part
    alone (``torch.distributed.tensor.full``), never the whole tensor;
    plain tensors on ``device`` otherwise."""
    mesh = current_mesh()
    if (current_rules() is None or not is_device_mesh(mesh)
            or mesh_size(mesh) == 1):
        return tree_map(lambda d: d.initialize(None, device), defs,
                        is_leaf=is_param_def)
    from torch.distributed.tensor import full

    rules = current_rules()

    def leaf(d: ParamDef) -> torch.Tensor:
        value = {"zeros": 0, "ones": 1, "const": d.scale}[d.init]
        return full(d.shape, value, dtype=d.dtype, device_mesh=mesh,
                    placements=placements(rules.spec_for(d.logical), mesh))

    return tree_map(leaf, defs, is_leaf=is_param_def)


def stack_defs(defs_list):
    """Stack N same-structure ParamDef trees along a new leading 'layers'
    axis."""
    n = len(defs_list)

    def _stack(*ds: ParamDef) -> ParamDef:
        d0 = ds[0]
        return ParamDef((n,) + d0.shape, ("layers",) + d0.logical,
                        d0.init, d0.dtype, d0.scale)

    return tree_map(_stack, *defs_list, is_leaf=is_param_def)
