"""Elastic scaling: land live or restored state on a (possibly different)
mesh (the JAX package's ``runtime/elastic.py``).

A :class:`NamedSharding` is the port's record of where a leaf goes: a
:class:`~repro_torch.core.partition.RowMesh` and a :class:`PartitionSpec`
naming, per leaf axis, the mesh axes it is split over. One torch tensor
lives on one device, so a leaf lands on its mesh's device: on one card
every row of ``forced_row_mesh`` is ``cuda:0``, and any spec is a move to
``cuda:0``. A mesh of distinct devices would need the leaf split or
replicated over them (DTensor placements), which the port does not have
(ROADMAP Queue 1, item 10c), and raises ``NotImplementedError``.

``rehome_tree`` is the restore half of a lane migration or an elastic
shrink: a :class:`~repro_torch.core.fleet.LaneSnapshot` holds its student
weights and optimizer state as host numpy arrays, and every leaf comes back
onto the fleet's device (or, with a mesh and a spec tree, onto the mesh's)
as a tensor, so a restored lane computes exactly like a live one.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import tree_map


class PartitionSpec(tuple):
    """Per leaf axis, the mesh axis name (or tuple of names) it is split
    over, or ``None`` (the JAX ``PartitionSpec``)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


def _named_axes(spec: PartitionSpec):
    for entry in spec:
        if entry is None:
            continue
        yield from (entry if isinstance(entry, tuple) else (entry,))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where a leaf goes: ``mesh`` (a ``RowMesh``) and ``spec``."""

    mesh: object
    spec: PartitionSpec

    def __post_init__(self):
        unknown = [a for a in _named_axes(self.spec)
                   if a not in self.mesh.axis_names]
        if unknown:
            raise ValueError(f"{self.spec} names axes {unknown} that the "
                             f"mesh {self.mesh.axis_names} does not have")

    @property
    def device(self) -> torch.device:
        """The one device every position of the mesh holds."""
        devices = set(self.mesh.devices.flat)
        if len(devices) != 1:
            raise NotImplementedError(
                f"placing a leaf over {len(devices)} distinct devices "
                f"({self.spec}) needs DTensor placements, which the port "
                "does not have: ROADMAP Queue 1, item 10c")
        return next(iter(devices))


def shardings_for(mesh, spec_tree):
    """A tree of :class:`NamedSharding` on ``mesh``, one per spec leaf."""
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree,
                    is_leaf=lambda x: isinstance(x, PartitionSpec))


def _as_tensor(x, dev: torch.device):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.from_numpy(np.array(x, copy=True)).to(dev)


def reshard_tree(tree, new_shardings):
    """Every leaf of ``tree`` (numpy arrays or tensors; ``None`` stays) as
    a tensor on its sharding's device; numpy leaves are copied."""
    def leaf(x, sharding):
        if x is None:
            return None
        if len(sharding.spec) > np.ndim(x):
            raise ValueError(f"{sharding.spec} has more axes than a leaf of "
                             f"shape {tuple(np.shape(x))}")
        return _as_tensor(x, sharding.device)

    return tree_map(leaf, tree, new_shardings)


def rehome_tree(tree, mesh=None, spec_tree=None, device: DeviceLike = None):
    """Every leaf of ``tree`` (numpy arrays or tensors) as a tensor on
    ``device`` (default ``cuda``), or, given a ``mesh`` and a ``spec_tree``,
    resharded onto the mesh (:func:`reshard_tree`); numpy leaves are
    copied, so the result shares no memory with the snapshot it came
    from."""
    if mesh is not None and spec_tree is not None:
        return reshard_tree(tree, shardings_for(mesh, spec_tree))
    dev = resolve_device(device)
    return tree_map(lambda x: _as_tensor(x, dev), tree)


def elastic_data_axis(mesh, lost_rows: int):
    """Shrink the data axis by ``lost_rows`` (failed hosts) — returns the
    new mesh built from the surviving rows, keeping the other axes."""
    from repro_torch.core.partition import RowMesh

    ax = 0  # the data-like axis is first by convention ("pod" or "data")
    dev = mesh.devices
    keep = dev.shape[ax] - lost_rows
    if keep <= 0:
        raise ValueError("no surviving rows")
    return RowMesh(np.take(dev, range(keep), axis=ax), mesh.axis_names)
