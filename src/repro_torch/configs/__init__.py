"""Config registry: ``get_arch(name)`` / ``ARCHS`` / shape cells (the JAX
package's ``configs/__init__.py``), and the vision pairs of the CL loop
(``dacapo_pairs``). The LM arch configs are framework-free copies of the
reference's."""
from __future__ import annotations

from repro_torch.configs import (
    dacapo_pairs,
    gemma2_2b,
    granite_20b,
    jamba_v0_1_52b,
    llava_next_mistral_7b,
    mixtral_8x22b,
    mixtral_8x7b,
    musicgen_medium,
    xlstm_125m,
    yi_34b,
    yi_6b,
)
from repro_torch.configs.base import (
    ArchConfig,
    LM_SHAPES,
    SHAPES_BY_NAME,
    ShapeConfig,
    attention_flops,
    flops_per_token,
    supports_shape,
)

_MODULES = (
    llava_next_mistral_7b,
    mixtral_8x22b,
    mixtral_8x7b,
    jamba_v0_1_52b,
    yi_34b,
    granite_20b,
    gemma2_2b,
    yi_6b,
    musicgen_medium,
    xlstm_125m,
)

ARCHS = {m.CONFIG.name: m.CONFIG for m in _MODULES}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES_BY_NAME:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES_BY_NAME)}")
    return SHAPES_BY_NAME[name]


def all_cells(include_skipped: bool = False):
    """Yield (arch, shape, supported) for the 40 assigned cells."""
    for arch in ARCHS.values():
        for shape in LM_SHAPES:
            ok = supports_shape(arch, shape)
            if ok or include_skipped:
                yield arch, shape, ok


__all__ = [
    "ARCHS",
    "ArchConfig",
    "LM_SHAPES",
    "ShapeConfig",
    "all_cells",
    "attention_flops",
    "dacapo_pairs",
    "flops_per_token",
    "get_arch",
    "get_shape",
    "supports_shape",
]
