"""Legacy front door — a thin compatibility wrapper over the Kernel/Session
API (the JAX package's ``core/cl_system.py``).

The monolithic ``ContinuousLearningSystem`` of the seed was decomposed
into kernels (core/kernel.py), decisions (core/decision.py), policies
(core/allocation.py) and the engine (core/session.py: ``CLSession``, built
by ``CLSystemSpec``). New code should use ``CLSystemSpec(...).build()``;
this wrapper keeps the seed-era constructor and attribute surface, and
adds the port's ``device`` (the card unless the caller passes ``"cpu"``).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.dacapo_pairs import VisionConfig
from repro_torch.core import mx as mx_lib
from repro_torch.core.allocation import CLHyperParams
from repro_torch.core.session import (  # noqa: F401  (re-exports)
    CLResult,
    CLSession,
    CLSystemSpec,
    pretrain_model,
)
from repro_torch.device import DeviceLike


class ContinuousLearningSystem:
    """Seed-compatible facade delegating to a :class:`CLSession`."""

    def __init__(
        self,
        student_cfg: VisionConfig,
        teacher_cfg: VisionConfig,
        hp: Optional[CLHyperParams] = None,
        estimator=None,
        allocator: str = "dacapo-spatiotemporal",
        precision_policy: mx_lib.PrecisionPolicy = mx_lib.DEFAULT_POLICY,
        apply_mx_numerics: bool = True,
        seed: int = 0,
        eval_fps: float = 2.0,
        device: DeviceLike = None,
    ):
        self._session = CLSystemSpec(
            student=student_cfg,
            teacher=teacher_cfg,
            allocator=allocator,
            estimator=estimator,
            policy=precision_policy,
            hp=hp,
            apply_mx=apply_mx_numerics,
            seed=seed,
            eval_fps=eval_fps,
            device=device,
        ).build()

    @property
    def session(self) -> CLSession:
        return self._session

    @property
    def scheduler(self):  # legacy name for the allocation policy
        return self._session.allocator

    @property
    def apply_mx(self) -> bool:
        return self._session.apply_mx

    def pretrain(self, stream, teacher_steps: int = 300,
                 student_steps: int = 80, batch: int = 64):
        return self._session.pretrain(stream, teacher_steps, student_steps,
                                      batch)

    def set_pretrained(self, teacher_params, student_params):
        return self._session.set_pretrained(teacher_params, student_params)

    def run(self, stream, duration: Optional[float] = None) -> CLResult:
        return self._session.run(stream, duration=duration)

    def __getattr__(self, item):
        # hp, estimator, policy, student/teacher (+cfgs), r_tsa/r_bsa,
        # kernels, params, rng ... all live on the session.
        if item == "_session":  # not yet set (e.g. during unpickling)
            raise AttributeError(item)
        return getattr(self._session, item)
