"""Carry weights across between the JAX package and the port.

A JAX ResNet or ViT parameter tree, handed over as numpy arrays (on the
JAX side: ``jax.tree_util.tree_map(np.asarray, tree)``), becomes the port's
tree on a given device, bit for bit: same nesting (a ViT's ``blocks`` list
of dicts too), same key names, same shapes and layouts (conv weights stay
HWIO, dense weights [in, out], the ViT's ``cls`` and ``pos`` stay 3-D). JAX's random streams cannot be reproduced in
torch, so this is how both packages compute on the same weights.

An MX representation crosses the same way (``mx_from_numpy`` /
``mx_to_numpy``): a JAX ``MXTensor`` or ``MXLeaf`` with numpy fields
becomes the port's, bit for bit — int8 mantissa, int8 exponent, uint8
micro-exponent bits and the precision — so both packages can serve the
same resident weight.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.mx import MXLeaf
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ref import MXTensor
from repro_torch.tree import tree_map


def params_from_numpy(tree, device: DeviceLike = None):
    """numpy-leaf tree -> tensor-leaf tree on ``device`` (default cuda)."""
    dev = resolve_device(device)
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev), tree)


def params_to_numpy(tree):
    """tensor-leaf tree -> numpy-leaf tree (host copies)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


_MX_FIELDS = (("mantissa", np.int8), ("exponent", np.int8),
              ("mx_bits", np.uint8))


def mx_from_numpy(q, device: DeviceLike = None):
    """A JAX ``MXTensor`` (fields ``mantissa``/``exponent``/``mx_bits`` as
    numpy arrays, ``precision``) or ``MXLeaf`` (``q``, ``shape``,
    ``dtype``, ``k``) -> the port's ``MXTensor`` / ``MXLeaf`` on ``device``
    (default cuda), bit for bit. Raises on a field of the wrong dtype."""
    dev = resolve_device(device)
    if hasattr(q, "mantissa"):
        fields = []
        for name, dtype in _MX_FIELDS:
            a = np.asarray(getattr(q, name))
            if a.dtype != dtype:
                raise TypeError(f"MXTensor.{name}: expected {np.dtype(dtype)}"
                                f", got {a.dtype}")
            fields.append(torch.from_numpy(np.array(a, copy=True)).to(dev))
        return MXTensor(*fields, precision=str(q.precision))
    if hasattr(q, "q"):
        dtype = torch.from_numpy(np.zeros(0, np.dtype(q.dtype))).dtype
        return MXLeaf(mx_from_numpy(q.q, dev), tuple(q.shape), dtype,
                      int(q.k))
    raise TypeError(f"not an MXTensor or MXLeaf: {type(q).__name__}")


def mx_to_numpy(q):
    """The port's ``MXTensor`` / ``MXLeaf`` -> the same with numpy fields
    (host copies; an ``MXLeaf``'s dtype becomes a numpy dtype)."""
    if isinstance(q, MXLeaf):
        dtype = torch.zeros(0, dtype=q.dtype).numpy().dtype
        return MXLeaf(mx_to_numpy(q.q), q.shape, dtype, q.k)
    return MXTensor(*(getattr(q, name).detach().cpu().numpy()
                      for name, _ in _MX_FIELDS), precision=q.precision)
