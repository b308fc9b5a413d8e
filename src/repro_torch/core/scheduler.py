"""Deprecated shim — the scheduler API moved to
``repro_torch.core.allocation`` (the JAX package's ``core/scheduler.py``).

``PhasePlan`` grew into ``AllocationDecision``, itself a facade over the
two-plane decision API (``SpatialPlan`` / ``TemporalPlan`` / ``Decision``
in ``repro_torch.core.decision``), and the scheduler classes became
``AllocationPolicy`` implementations whose decisions the ``CLSession``
engine executes. The legacy names below keep old imports and positional
constructions working; importing this module emits a
``DeprecationWarning``.
"""
import warnings

warnings.warn(
    "repro_torch.core.scheduler is deprecated: import AllocationPolicy/"
    "AllocationDecision from repro_torch.core.allocation (or the two-plane "
    "SpatialPlan/TemporalPlan/Decision API from repro_torch.core.decision)",
    DeprecationWarning, stacklevel=2)

from repro_torch.core.allocation import (  # noqa: F401,E402
    ALLOCATORS as SCHEDULERS,
    AllocationDecision as PhasePlan,
    CLHyperParams,
    EkyaAllocator as EkyaScheduler,
    EOMUAllocator as EOMUScheduler,
    SpatialAllocator as SpatialScheduler,
    SpatiotemporalAllocator as SpatiotemporalScheduler,
)

__all__ = [
    "CLHyperParams",
    "PhasePlan",
    "SCHEDULERS",
    "SpatiotemporalScheduler",
    "SpatialScheduler",
    "EkyaScheduler",
    "EOMUScheduler",
]
