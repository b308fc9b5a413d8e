"""Meshes (the JAX package's ``launch/mesh.py``).

``make_host_mesh`` is a ``torch.distributed`` ``DeviceMesh`` of shape
(world / model_parallel, model_parallel) named ("data", "model") over the
current process group. Where no group is set it starts one: from the
environment that ``torchrun`` sets (``WORLD_SIZE``, ``MASTER_ADDR``, ...),
else a group of one rank over a ``FileStore`` in a temporary directory, so
a driver runs alone. NCCL serves a mesh on the card, gloo one on the CPU.
:func:`host_mesh` also ends a group it started when its block ends.

``make_production_mesh`` is the reference's 16 x 16 (one pod) or
2 x 16 x 16 ("pod", "data", "model") mesh as an :class:`AbstractMesh`: its
axis names and sizes, no devices, which is all that the sharding rules
(``launch/sharding.py``) and the spec derivations read.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import tempfile
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import axis_sizes


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, with no devices behind them."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


def _start_group(dev: torch.device):
    """Start the process group (module docstring); returns the temporary
    directory of its store, or None for one from the environment."""
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(backend)
        return None
    tmp = tempfile.mkdtemp(prefix="host_mesh_")
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
        rank=0, world_size=1)
    return tmp


def _mesh(model_parallel: int, dev: torch.device):
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"--model-parallel {model_parallel} does not divide "
                         f"the world size {world}: a mesh of "
                         f"{model_parallel}-way model parallelism needs a "
                         "multiple of that many ranks")
    return init_device_mesh(dev.type, (world // model_parallel,
                                       model_parallel),
                            mesh_dim_names=("data", "model"))


def make_host_mesh(model_parallel: int = 1, device: DeviceLike = None):
    """A (world / model_parallel, model_parallel) ``DeviceMesh`` named
    ("data", "model") over the process group, started if none is set
    (module docstring; it lasts as long as the process), on ``device``'s
    type (default ``cuda``)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        _start_group(dev)
    return _mesh(model_parallel, dev)


@contextlib.contextmanager
def host_mesh(model_parallel: int = 1, device: DeviceLike = None):
    """:func:`make_host_mesh` for the block; a group it starts ends with
    the block."""
    dev = resolve_device(device)
    started = not dist.is_initialized()
    tmp = _start_group(dev) if started else None
    try:
        yield _mesh(model_parallel, dev)
    finally:
        if started:
            dist.destroy_process_group()
            if tmp is not None:
                shutil.rmtree(tmp, ignore_errors=True)


def run_mesh(model_parallel: int, device: DeviceLike, on_mesh: bool = True):
    """A driver's mesh: :func:`host_mesh`, or, with ``on_mesh`` False, no
    mesh (a context yielding None: the steps run with no rules)."""
    if on_mesh:
        return host_mesh(model_parallel, device)
    if model_parallel > 1:
        raise ValueError("--model-parallel above 1 needs the host mesh")
    return contextlib.nullcontext(None)


def describe(mesh) -> str:
    return f"mesh{axis_sizes(mesh)}"
