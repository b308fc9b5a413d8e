"""Declarative parameter trees (the parameter-spec half of the JAX package's
``distributed.py``): a tree of :class:`ParamDef` leaves can be initialized,
shape-evaluated and stacked without duplicating the model's layout.

``ParamDef.logical`` keeps the reference's logical axis names, which the
sharding rules of a mesh map to placements. The rules themselves
(``ShardingRules``, ``use_rules``, ``constrain``, the mesh helpers) are
ROADMAP item 10c; on one card every constraint is the identity, so the
model code calls none.

Random leaves are drawn from an explicit ``torch.Generator``, leaf after
leaf in tree order, on the generator's device: a full-width init on the
card costs no host time and repeats bit for bit from the same seed. The
reference splits a JAX key per leaf; the two packages' random streams
differ, so the tests carry weights across (``repro_torch.convert``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import DeviceLike
from repro_torch.tree import tree_map


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


def stack_defs(defs_list):
    """Stack N same-structure ParamDef trees along a new leading 'layers'
    axis."""
    n = len(defs_list)

    def _stack(*ds: ParamDef) -> ParamDef:
        d0 = ds[0]
        return ParamDef((n,) + d0.shape, ("layers",) + d0.logical,
                        d0.init, d0.dtype, d0.scale)

    return tree_map(_stack, *defs_list, is_leaf=is_param_def)
