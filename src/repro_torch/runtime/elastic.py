"""Elastic scaling: land live or restored state on a (possibly different)
mesh (the JAX package's ``runtime/elastic.py``).

A :class:`NamedSharding` is the port's record of where a leaf goes: a mesh
and a :class:`PartitionSpec` naming, per leaf axis, the mesh axes it is
split over. The mesh is one of two kinds:

* a ``torch.distributed`` ``DeviceMesh`` (``launch/mesh.py``): a leaf is
  laid out by ``distribute_tensor`` with its spec's DTensor placements
  (``distributed.placements``), a DTensor leaf is redistributed; on a mesh
  of one rank a leaf stays a plain tensor on the mesh's device;
* a :class:`~repro_torch.core.partition.RowMesh` of the CL side, whose
  rows name devices: a leaf lands on the one device they all hold (on one
  card every row of ``forced_row_mesh`` is ``cuda:0``). A ``RowMesh`` of
  distinct devices raises ``NotImplementedError``: such a layout is a
  ``DeviceMesh``'s.

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
from repro_torch.distributed import (  # noqa: F401 (re-exported)
    PartitionSpec,
    axis_names,
    is_device_mesh,
    is_dtensor,
    mesh_size,
    placements,
)
from repro_torch.tree import tree_map


def _named_axes(spec: PartitionSpec):
    for entry in spec:
        if entry is None:
            continue
        yield from (entry if isinstance(entry, tuple) else (entry,))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where a leaf goes: ``mesh`` (a ``DeviceMesh`` or a ``RowMesh``)
    and ``spec``."""

    mesh: object
    spec: PartitionSpec

    def __post_init__(self):
        names = axis_names(self.mesh)
        unknown = [a for a in _named_axes(self.spec) if a not in names]
        if unknown:
            raise ValueError(f"{self.spec} names axes {unknown} that the "
                             f"mesh {names} does not have")

    @property
    def placements(self) -> list:
        """The spec's DTensor placements over a ``DeviceMesh``."""
        return placements(self.spec, self.mesh)

    @property
    def device(self) -> torch.device:
        """The device a leaf lands on: a ``DeviceMesh``'s device type (the
        current card for ``cuda``), or the one device every position of a
        ``RowMesh`` holds."""
        if is_device_mesh(self.mesh):
            return torch.device(self.mesh.device_type)
        devices = set(self.mesh.devices.flat)
        if len(devices) != 1:
            raise NotImplementedError(
                f"a RowMesh over {len(devices)} distinct devices ({self.spec})"
                ": lay the leaf out over a torch DeviceMesh instead "
                "(launch/mesh.py::make_host_mesh), as a NamedSharding "
                "of that mesh")
        return next(iter(devices))

    def place(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` laid out by this sharding: a DTensor is redistributed to
        the placements, a plain tensor distributed over a ``DeviceMesh``
        of more than one rank, else moved to :attr:`device`."""
        if is_dtensor(x):
            return x.redistribute(self.mesh, self.placements)
        x = x.to(self.device)
        if is_device_mesh(self.mesh) and mesh_size(self.mesh) > 1:
            from torch.distributed.tensor import distribute_tensor

            return distribute_tensor(x, self.mesh, self.placements)
        return x


def shardings_for(mesh, spec_tree):
    """A tree of :class:`NamedSharding` on ``mesh``, one per spec leaf."""
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree,
                    is_leaf=lambda x: isinstance(x, PartitionSpec))


def _as_tensor(x, dev: torch.device):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.from_numpy(np.array(x, copy=True)).to(dev)


def reshard_tree(tree, new_shardings):
    """Every leaf of ``tree`` (numpy arrays or tensors; ``None`` stays)
    laid out by its sharding (:meth:`NamedSharding.place`); numpy leaves
    are copied."""
    def leaf(x, sharding):
        if x is None:
            return None
        ndim = x.dim() if isinstance(x, torch.Tensor) else np.ndim(x)
        if len(sharding.spec) > ndim:
            raise ValueError(f"{sharding.spec} has more axes than a leaf of "
                             f"shape {tuple(np.shape(x))}")
        if not isinstance(x, torch.Tensor):
            x = _as_tensor(x, sharding.device)
        return sharding.place(x)

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
