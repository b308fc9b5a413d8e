"""Elastic lane state: land a host-restored tree on a device.

``rehome_tree`` is the restore half of a lane migration: a
:class:`~repro_torch.core.fleet.LaneSnapshot` holds its student weights
and optimizer state as host numpy arrays, and ``attach_lane`` moves every
leaf back onto the fleet's device as a tensor, so a restored lane computes
exactly like a live one. Resharding onto a multi-device mesh
(``reshard_tree``, ``shardings_for`` and ``elastic_data_axis`` in the JAX
package) is not ported yet: ROADMAP Queue 1, item 9a.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import tree_map

_MESH_NOT_PORTED = ("rehoming onto a mesh (reshard_tree, shardings_for) is "
                    "not ported yet: ROADMAP Queue 1, item 9a")


def rehome_tree(tree, mesh=None, spec_tree=None, device: DeviceLike = None):
    """Every leaf of ``tree`` (numpy arrays or tensors) as a tensor on
    ``device`` (default ``cuda``); numpy leaves are copied, so the result
    shares no memory with the snapshot it came from. A ``mesh`` with a
    ``spec_tree`` raises ``NotImplementedError``."""
    if mesh is not None and spec_tree is not None:
        raise NotImplementedError(_MESH_NOT_PORTED)
    dev = resolve_device(device)

    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    return tree_map(leaf, tree)
