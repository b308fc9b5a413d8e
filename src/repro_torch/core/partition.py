"""Spatial partitioning: mesh fission into T-SA / B-SA sub-meshes (the JAX
package's ``core/partition.py``).

The paper splits a systolic array's rows into a top (training + labeling)
and bottom (inference) sub-accelerator (§V-A). Here, as in the reference,
a mesh of devices is split along its first axis into two sub-meshes, and
each kernel stages its inputs onto its own sub-mesh's first device. The
port has no ``jax.sharding.Mesh``: a :class:`RowMesh` is the reference's
device grid and axis names and nothing more. On a single device the
partition degenerates to time-sharing (the paper's own fallback when
R_tsa or R_bsa is 0). On a host with one card, ``forced_row_mesh`` repeats
that card, so every sub-mesh holds the same device and the kernels run on
it in issue order, as the reference does on a mesh that repeats one device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class RowMesh:
    """A grid of devices with named axes: ``devices`` is an object array of
    ``torch.device`` (rows along the first axis)."""

    devices: np.ndarray
    axis_names: Tuple[str, ...] = ("data", "model")


@dataclasses.dataclass(frozen=True)
class SpatialPartition:
    t_sa: Optional[RowMesh]  # retraining + labeling (time-shared, Alg. 1)
    b_sa: Optional[RowMesh]  # inference, sized to the input frame rate
    time_shared: bool  # single-resource fallback

    @property
    def t_devices(self):
        return None if self.t_sa is None else self.t_sa.devices

    @property
    def b_devices(self):
        return None if self.b_sa is None else self.b_sa.devices


def partition_mesh(mesh: RowMesh, rows_bsa: int,
                   row_axis: Optional[str] = None) -> SpatialPartition:
    """Split ``mesh`` along ``row_axis`` (default: first axis): the last
    ``rows_bsa`` rows become B-SA, the rest T-SA. Fewer than two rows, or a
    split that leaves either side empty, time-shares the whole mesh."""
    axis = row_axis or mesh.axis_names[0]
    ax_idx = mesh.axis_names.index(axis)
    n_rows = mesh.devices.shape[ax_idx]
    if n_rows < 2 or rows_bsa <= 0 or rows_bsa >= n_rows:
        return SpatialPartition(t_sa=mesh, b_sa=mesh, time_shared=True)
    dev = np.moveaxis(mesh.devices, ax_idx, 0)
    t_dev = np.moveaxis(dev[: n_rows - rows_bsa], 0, ax_idx)
    b_dev = np.moveaxis(dev[n_rows - rows_bsa:], 0, ax_idx)
    return SpatialPartition(t_sa=RowMesh(t_dev, mesh.axis_names),
                            b_sa=RowMesh(b_dev, mesh.axis_names),
                            time_shared=False)


def single_device_partition() -> SpatialPartition:
    return SpatialPartition(t_sa=None, b_sa=None, time_shared=True)


def forced_row_mesh(n_rows: int, device: DeviceLike = None) -> RowMesh:
    """An ``n_rows x 1`` mesh for exercising mesh fission anywhere: on the
    card (the default) the first ``n_rows`` CUDA devices when the host has
    enough, ``cuda:0`` repeated otherwise; with ``device="cpu"`` the CPU
    repeated."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        rows = ([torch.device("cuda", i) for i in range(n_rows)]
                if torch.cuda.device_count() >= n_rows
                else [torch.device("cuda", 0)] * n_rows)
    else:
        rows = [dev] * n_rows
    devices = np.empty((n_rows, 1), dtype=object)
    devices[:, 0] = rows
    return RowMesh(devices, ("data", "model"))
