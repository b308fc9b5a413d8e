"""Carry weights across between the JAX package and the port.

A JAX ResNet parameter tree, handed over as numpy arrays (on the JAX side:
``jax.tree_util.tree_map(np.asarray, tree)``), becomes the port's tree on
a given device, bit for bit: same nesting, same key names, same layouts
(conv weights stay HWIO). JAX's random streams cannot be reproduced in
torch, so this is how both packages compute on the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import tree_map


def params_from_numpy(tree, device: DeviceLike = None):
    """numpy-leaf tree -> tensor-leaf tree on ``device`` (default cuda)."""
    dev = resolve_device(device)
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev), tree)


def params_to_numpy(tree):
    """tensor-leaf tree -> numpy-leaf tree (host copies)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
