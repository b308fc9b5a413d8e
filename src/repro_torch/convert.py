"""Carry weights across between the JAX package and the port.

A JAX ResNet or ViT parameter tree, handed over as numpy arrays (on the
JAX side: ``jax.tree_util.tree_map(np.asarray, tree)``), becomes the port's
tree on a given device, bit for bit: same nesting (a ViT's ``blocks`` list
of dicts too), same key names, same shapes and layouts (conv weights stay
HWIO, dense weights [in, out], the ViT's ``cls`` and ``pos`` stay 3-D). JAX's random streams cannot be reproduced in
torch, so this is how both packages compute on the same weights. An LM
tree (a ``blocks`` tuple of stacked dicts) crosses the same way.

bf16 crosses bit for bit both ways. JAX hands a bf16 array over as a numpy
array of the ``bfloat16`` dtype that ``ml_dtypes`` registers with numpy,
which ``torch.from_numpy`` refuses: it is carried as its uint16 bit
patterns and reinterpreted as ``torch.bfloat16``. Back, a bf16 tensor's
bits come out under numpy's ``bfloat16`` dtype, which exists in a process
that has imported ``ml_dtypes`` (every process holding JAX arrays has);
the port itself imports numpy only, so elsewhere that direction raises.

An MX representation crosses the same way (``mx_from_numpy`` /
``mx_to_numpy``): a JAX ``MXTensor`` or ``MXLeaf`` with numpy fields
becomes the port's, bit for bit — int8 mantissa, int8 exponent, uint8
micro-exponent bits and the precision — so both packages can serve the
same resident weight.

A MoE layer's experts cross into the port's layout for expert fission with
``experts_to_virtual``: the reference's (or an init's) r = 1 experts split
into r virtual experts each, a d_ff slice apiece, as ``models/moe.py``
lays them out when the expert axis does not divide the expert count.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.mx import MXLeaf
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ref import MXTensor
from repro_torch.tree import tree_map


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def _to_tensor(a) -> torch.Tensor:
    """One numpy leaf -> a CPU tensor of its own (a copy); a ``bfloat16``
    array becomes a ``torch.bfloat16`` tensor of the same bits."""
    a = np.array(a, copy=True)
    if _is_bf16(a):
        return torch.from_numpy(a.view(np.uint16).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(a)


def _to_array(t: torch.Tensor) -> np.ndarray:
    """One tensor leaf -> a host numpy copy; a ``torch.bfloat16`` tensor
    becomes a numpy ``bfloat16`` array of the same bits."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    try:
        bf16 = np.dtype("bfloat16")
    except TypeError:
        raise TypeError("numpy has no bfloat16 dtype in this process: it "
                        "is registered by ml_dtypes, which JAX imports")
    return t.view(torch.int16).numpy().view(bf16)


def params_from_numpy(tree, device: DeviceLike = None):
    """numpy-leaf tree -> tensor-leaf tree on ``device`` (default cuda)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _to_tensor(a).to(dev), tree)


def params_to_numpy(tree):
    """tensor-leaf tree -> numpy-leaf tree (host copies)."""
    return tree_map(_to_array, tree)


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


_EXPERT_KEYS = ("router", "w_gate", "w_up", "w_down")


def _split_experts(w, r: int, ff_last: bool):
    """[..., e, d, f] (``ff_last``) -> [..., e r, d, f / r], or [..., e,
    f, d] -> [..., e r, f / r, d]: expert j's slice i of d_ff becomes
    virtual expert j r + i. Works on numpy arrays and tensors alike."""
    *lead, e, a, b = w.shape
    if ff_last:
        w = w.reshape(*lead, e, a, r, b // r).swapaxes(-3, -2)
        return w.reshape(*lead, e * r, a, b // r)
    return w.reshape(*lead, e * r, a // r, b)


def experts_to_virtual(tree, r: int):
    """``tree`` with every MoE layer's experts (a dict holding ``router``,
    ``w_gate``, ``w_up`` and ``w_down``, stacked over layers or not, numpy
    or tensors) split into r virtual experts each: ``w_gate`` / ``w_up``
    along d_ff, ``w_down`` along its d_ff dim. SwiGLU is elementwise in
    d_ff, so the split layer computes the same function, its down
    projections summing over the virtual experts (``moe_forward``).
    r = 1 returns ``tree`` itself."""
    if r == 1:
        return tree
    if isinstance(tree, dict):
        if all(k in tree for k in _EXPERT_KEYS):
            return {k: v if k == "router" else _split_experts(
                v, r, ff_last=k != "w_down") for k, v in tree.items()}
        return {k: experts_to_virtual(v, r) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(experts_to_virtual(v, r) for v in tree)
    return tree
