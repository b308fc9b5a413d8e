"""Unified handles for the vision models of the CL pairs and the LMs of
the assigned archs (the JAX package's ``models/registry.py``)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.dacapo_pairs import VisionConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import resnet as resnet_lib
from repro_torch.models import vit as vit_lib
from repro_torch.models.transformer import LMModel, make_model
from repro_torch.tree import tree_leaves


@dataclasses.dataclass(frozen=True)
class VisionModel:
    cfg: VisionConfig
    device: torch.device

    def init(self, gen: torch.Generator):
        """Random weights from a CPU ``torch.Generator``, on the model's
        device."""
        if self.cfg.kind == "resnet":
            return resnet_lib.init_resnet(gen, self.cfg, self.device)
        return vit_lib.init_vit(gen, self.cfg, self.device)

    def apply(self, params, images) -> torch.Tensor:
        """images [B,H,W,3] (numpy or tensor) -> logits [B,C] on the
        model's device."""
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        x = images.to(device=self.device, dtype=torch.float32)
        if self.cfg.kind == "resnet":
            return resnet_lib.resnet_forward(params, x, self.cfg)
        return vit_lib.vit_forward(params, x, self.cfg)

    def flops(self) -> float:
        if self.cfg.kind == "resnet":
            return resnet_lib.resnet_flops(self.cfg)
        return vit_lib.vit_flops(self.cfg)

    def param_count(self, params) -> int:
        return sum(p.numel() for p in tree_leaves(params))


def make_vision_model(cfg: VisionConfig,
                      device: DeviceLike = None) -> VisionModel:
    """A model handle on ``device`` (default ``cuda``; raises without a
    card)."""
    return VisionModel(cfg, resolve_device(device))


def make_lm_model(cfg: ArchConfig, device: DeviceLike = None) -> LMModel:
    """An LM handle on ``device`` (default ``cuda``; raises without a
    card)."""
    return make_model(cfg, device)
