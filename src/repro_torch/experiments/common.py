"""Shared machinery of the paper's figure experiments (the JAX package's
``benchmarks/common.py``): the system variants of paper §VII-A as
declarative ``CLSystemSpec`` entries, cached pretraining, CSV emission.

The reference reads ``REPRO_BENCH_FAST`` when it is imported; here the
callers pass ``fast`` (the quick sizes) and ``device`` (``cuda`` unless
``"cpu"`` is asked for) instead, and nothing reads the environment.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.dacapo_pairs import VisionConfig
from repro_torch.core.allocation import CLHyperParams
from repro_torch.core.estimator import DaCapoEstimator, TPUEstimator
from repro_torch.core.session import (CLResult, CLSystemSpec, PhaseObserver,
                                      pretrain_model)
from repro_torch.data.stream import DriftStream, scenario
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.registry import make_vision_model


@dataclasses.dataclass(frozen=True)
class OrinEstimator(TPUEstimator):
    """NVIDIA Jetson Orin model (paper Table IV): FP32 only — no MX
    bandwidth/compute benefit; high (60 W, default clocks) or low (30 W,
    624.8 MHz) power envelope. Reuses the roofline in fractional-rows
    mode: rows are shares of one device, not whole chips. The constants
    are the paper's Orin figures, inputs to the virtual clock as in the
    reference, not measurements of the card the port runs on."""

    total_rows: int = 16  # normalized resource units, same split API
    peak_flops: float = 5.3e12 * 0.45  # sustained fp32
    hbm_bw: float = 204.8e9
    fractional_rows: bool = True
    mx_speedup = {"mx4": 1.0, "mx6": 1.0, "mx9": 1.0}  # FP32 everywhere


def orin_estimator(power: str) -> OrinEstimator:
    scale = 1.0 if power == "high" else 0.45
    return OrinEstimator(peak_flops=5.3e12 * 0.45 * scale,
                         hbm_bw=204.8e9 * (1.0 if power == "high" else 0.7))


# Each system variant is a declarative spec; run_system fills in the model
# pair, hyper-parameters, device and scenario-specific bits.
SYSTEMS: Dict[str, CLSystemSpec] = {
    "OrinLow-Ekya": CLSystemSpec(
        estimator=lambda: orin_estimator("low"), allocator="ekya",
        apply_mx=False),
    "OrinHigh-Ekya": CLSystemSpec(
        estimator=lambda: orin_estimator("high"), allocator="ekya",
        apply_mx=False),
    "OrinHigh-EOMU": CLSystemSpec(
        estimator=lambda: orin_estimator("high"), allocator="eomu",
        apply_mx=False),
    "DaCapo-Ekya": CLSystemSpec(
        estimator=DaCapoEstimator, allocator="ekya", apply_mx=True),
    "DaCapo-Spatial": CLSystemSpec(
        estimator=DaCapoEstimator, allocator="dacapo-spatial", apply_mx=True),
    "DaCapo-Spatiotemporal": CLSystemSpec(
        estimator=DaCapoEstimator, allocator="dacapo-spatiotemporal",
        apply_mx=True),
}

POWER_W = {"OrinLow-Ekya": 30.0, "OrinHigh-Ekya": 60.0,
           "OrinHigh-EOMU": 60.0, "DaCapo-Ekya": 0.236,
           "DaCapo-Spatial": 0.236, "DaCapo-Spatiotemporal": 0.236}

_PRETRAIN_CACHE: Dict[Tuple, Tuple] = {}


def default_hp(fast: bool) -> CLHyperParams:
    if fast:
        return CLHyperParams(n_t=48, n_l=24, c_b=192, epochs=1)
    return CLHyperParams(n_t=96, n_l=48, c_b=384, epochs=1)


def make_stream(scen: str, fast: bool) -> DriftStream:
    return DriftStream(scenario(scen, 3 if fast else 5), seed=17, img=24)


def pretrained(student: VisionConfig, teacher: VisionConfig,
               stream_key: str, stream: DriftStream, fast: bool,
               device: DeviceLike = None):
    """Teacher and student weights pretrained on ``stream`` on ``device``,
    once per pair, scenario, size and device."""
    device = resolve_device(device)
    key = (student.name, teacher.name, stream_key, fast, str(device))
    if key not in _PRETRAIN_CACHE:
        rng = np.random.default_rng(0)
        teacher_model = make_vision_model(teacher.reduced(), device)
        student_model = make_vision_model(student.reduced(), device)
        t_steps, s_steps = (30, 20) if fast else (120, 45)
        tp = pretrain_model(teacher_model, stream, t_steps, 48, rng)
        sp = pretrain_model(student_model, stream, s_steps, 48, rng,
                            segments=stream.segments[:1], seed=8)
        _PRETRAIN_CACHE[key] = (tp, sp)
    return _PRETRAIN_CACHE[key]


def forget_pretrained() -> None:
    """Empty the pretraining cache: the next run pretrains afresh."""
    _PRETRAIN_CACHE.clear()


def run_system(name: str, student: VisionConfig, teacher: VisionConfig,
               scen: str, duration: Optional[float] = None,
               observers: Sequence[PhaseObserver] = (), *, fast: bool,
               device: DeviceLike = None) -> CLResult:
    """One session of system ``name`` on ``scen`` (90 virtual s when
    ``fast``, else 180, unless ``duration`` says otherwise)."""
    device = resolve_device(device)
    spec = dataclasses.replace(SYSTEMS[name], student=student,
                               teacher=teacher, hp=default_hp(fast),
                               eval_fps=0.5, device=device)
    stream = make_stream(scen, fast)
    session = spec.build()
    tp, sp = pretrained(student, teacher, scen, stream, fast, device)
    session.set_pretrained(tp, sp)
    dur = duration or (90.0 if fast else 180.0)
    return session.run(stream, duration=dur, observers=observers)


def emit(rows):
    """Print 'name,us_per_call,derived' CSV rows."""
    for name, us, derived in rows:
        print(f"{name},{us:.3f},{derived}")
