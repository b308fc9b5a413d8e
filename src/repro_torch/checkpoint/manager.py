"""Fault-tolerant checkpointing (the JAX package's ``checkpoint/manager.py``).

Design points, as in the reference:
  * atomic commit — write to ``step_XXXXXXXXXX.tmp`` then rename; a crash
    mid-save never corrupts the latest checkpoint;
  * async save — serialization happens on a background thread off the
    training loop (the device-to-host copy is synchronous, I/O is not);
  * elastic restore — arrays are loaded as full logical arrays and, given
    target shardings (:mod:`repro_torch.runtime.elastic`), land on the
    target mesh's device;
  * clean shutdown — the manager is a context manager; ``close()`` (or the
    ``with`` exit) joins the in-flight async save, and
    ``all_steps``/``latest_step`` ignore step directories without a
    committed ``manifest.json``, so a torn write never crashes ``restore``.

The files are the reference's: ``shard_0.npz`` holds one array per leaf,
keyed by its path as ``jax.tree_util.tree_flatten_with_path`` names it (a
dict key by its name, a list or tuple index by its number, joined with
``/``; ``None`` is an empty subtree), and ``manifest.json`` holds ``step``,
``time``, ``num_processes`` (1), the sorted ``leaves`` and ``metadata``.
So a plain array tree saved by either package restores in the other bit
for bit. Restore rebuilds the tree by path in ``like``'s structure, never
by leaf order.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_map

PROCESS_INDEX = 0  # single-process: one shard file
PROCESS_COUNT = 1


def _path_leaves(tree, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, object]]:
    """(path, leaf) pairs in the order JAX flattens a tree of dicts, lists
    and tuples: dict keys sorted, ``None`` an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _path_leaves(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _path_leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def _key(path: Tuple) -> str:
    return "/".join(str(p) for p in path)


def _flatten_with_paths(tree) -> Dict[str, object]:
    return {_key(path): leaf for path, leaf in _path_leaves(tree)}


def _rebuild(like, values: Dict[str, object], prefix: Tuple = ()):
    """``like``'s structure with each leaf replaced by ``values[path]``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, values, prefix + (k,)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)([_rebuild(v, values, prefix + (i,))
                           for i, v in enumerate(like)])
    return values[_key(prefix)]


def _host(x):
    """A host numpy copy of a leaf that later updates cannot reach: a CUDA
    tensor is copied to the host, a CPU tensor or numpy leaf is copied."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.cpu().numpy() if x.device.type != "cpu" else x.numpy().copy()
    return np.array(x, copy=True)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, state, metadata: Optional[Dict] = None,
             blocking: bool = False) -> None:
        # Device->host copy happens NOW (consistent snapshot); I/O async.
        host_state = tree_map(_host, state)
        self.wait()  # one in-flight save at a time

        def _do_save():
            final = os.path.join(self.directory, f"step_{step:010d}")
            tmp = final + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            arrays = _flatten_with_paths(host_state)
            np.savez(os.path.join(tmp, f"shard_{PROCESS_INDEX}.npz"),
                     **arrays)
            manifest = {
                "step": step,
                "time": time.time(),
                "num_processes": PROCESS_COUNT,
                "leaves": sorted(arrays.keys()),
                "metadata": metadata or {},
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic commit
            self._gc()

        if self.async_save and not blocking:
            self._thread = threading.Thread(target=_do_save, daemon=True)
            self._thread.start()
        else:
            _do_save()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def close(self) -> None:
        """Flush the in-flight async save. Safe to call repeatedly; after
        close the manager can still be used (it is a flush, not a
        shutdown)."""
        self.wait()

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        """Committed steps only: a step directory without a manifest.json
        (torn write, e.g. rename raced a crash) is invisible, so
        ``latest_step``/``restore`` never pick up a partial checkpoint."""
        steps = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.isfile(
                    os.path.join(self.directory, name, "manifest.json")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int], like, shardings=None):
        """Restore into the structure of ``like``: numpy leaves, or with
        ``shardings`` (a tree of :class:`~repro_torch.runtime.elastic
        .NamedSharding`) tensors on their meshes' device."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path,
                                  f"shard_{PROCESS_INDEX}.npz")) as data:
            values = {key: data[key] for key in _flatten_with_paths(like)}
        tree = _rebuild(like, values)
        if shardings is not None:
            from repro_torch.runtime.elastic import reshard_tree

            tree = reshard_tree(tree, shardings)
        return tree, manifest
