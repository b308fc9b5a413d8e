"""Fault tolerance: heartbeats, straggler detection, preemption-safe loops
(the JAX package's ``runtime/fault.py``; framework-free, so the port keeps
its own copy).

On a real multi-host deployment the Heartbeat is fed per host through a
coordination service; here the same logic runs single-process and is
exercised with a FailureInjector. ``resilient_loop`` is the training-loop
wrapper: checkpoint every N steps, restore and continue on failure, give
up after max_restarts.

One deliberate difference from the reference: :meth:`FailureInjector
.maybe_fail` raises :class:`InjectedFailure`, a ``RuntimeError`` of its
own. The fleet manager treats a shard step's exception as an accelerator
loss and re-homes the shard's lanes; in torch a CUDA fault or a failed
kernel launch is a ``RuntimeError`` too, and catching every one would
recover it silently onto a surviving shard of the same card — a fallback
hiding the kernel. So the port's manager catches ``InjectedFailure`` only
and lets anything else propagate. Since it subclasses ``RuntimeError``,
every caller that expects the reference's ``RuntimeError("injected node
failure ...")`` still sees one (``resilient_loop`` restarts on any
exception, as the reference's does).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np


class InjectedFailure(RuntimeError):
    """A failure raised on purpose by :class:`FailureInjector`."""


class Heartbeat:
    """Per-step wall-time tracker with quantile statistics."""

    def __init__(self, window: int = 100):
        self.window = window
        self.durations: List[float] = []
        self._last: Optional[float] = None

    def beat(self) -> float:
        now = time.monotonic()
        dur = 0.0
        if self._last is not None:
            dur = now - self._last
            self.durations.append(dur)
            if len(self.durations) > self.window:
                self.durations.pop(0)
        self._last = now
        return dur

    def median(self) -> float:
        return float(np.median(self.durations)) if self.durations else 0.0


class StragglerDetector:
    """Flags steps slower than ``factor`` x rolling median — the signal a
    scheduler uses to evict or replace a slow host. Mitigation is
    pluggable (default: record)."""

    def __init__(self, factor: float = 3.0, min_samples: int = 8):
        self.factor = factor
        self.min_samples = min_samples
        self.events: List[Dict] = []

    def observe(self, step: int, duration: float, median: float) -> bool:
        is_straggler = (median > 0 and duration > self.factor * median)
        if is_straggler:
            self.events.append(
                {"step": step, "duration": duration, "median": median})
        return is_straggler


class FailureInjector:
    """Deterministic failure injection for restart/recovery tests.

    ``fail_at_steps`` entries are either bare step numbers (fail whoever
    probes that step first — the ``resilient_loop`` contract) or
    ``(step, key)`` pairs targeting one probe site: the fleet manager
    probes with ``key=shard_index`` each round, so ``(3, 1)`` kills shard 1
    at round 3 and nobody else. Each entry fires exactly once — the
    check-then-mark is under a lock, so the exactly-once contract holds
    when shards probe concurrently from a worker pool
    (``FleetManager(parallel_shards=N)``); keyed ``(step, key)`` entries
    stay deterministic there, while bare-step entries fire on whichever
    probe wins the lock first. Raises :class:`InjectedFailure`."""

    def __init__(self, fail_at_steps=()):
        self.fail_at = set(fail_at_steps)
        self.failed = set()
        self._lock = threading.Lock()

    def maybe_fail(self, step: int, key=None) -> None:
        probe = step if key is None else (step, key)
        with self._lock:
            for entry in (step, probe) if key is not None else (step,):
                if entry in self.fail_at and entry not in self.failed:
                    self.failed.add(entry)
                    where = f" (key={key})" if key is not None else ""
                    raise InjectedFailure(
                        f"injected node failure at step {step}{where}")


@dataclasses.dataclass
class LoopReport:
    final_step: int
    restarts: int
    straggler_events: int
    checkpointed_steps: List[int]


def resilient_loop(
    step_fn: Callable,  # (state, step) -> state
    state,
    num_steps: int,
    checkpoint_manager,
    checkpoint_every: int = 50,
    max_restarts: int = 3,
    failure_injector: Optional[FailureInjector] = None,
    straggler_detector: Optional[StragglerDetector] = None,
    state_like: Optional[object] = None,
) -> tuple:
    """Preemption-safe training loop: on failure, restore the last complete
    checkpoint and continue. Returns (state, LoopReport)."""
    hb = Heartbeat()
    sd = straggler_detector or StragglerDetector()
    restarts = 0
    saved_steps: List[int] = []
    step = 0
    # Resume if a checkpoint exists.
    latest = checkpoint_manager.latest_step()
    if latest is not None:
        state, manifest = checkpoint_manager.restore(
            latest, state_like if state_like is not None else state)
        step = int(manifest["step"])

    while step < num_steps:
        try:
            if failure_injector is not None:
                failure_injector.maybe_fail(step)
            state = step_fn(state, step)
            dur = hb.beat()
            sd.observe(step, dur, hb.median())
            step += 1
            if step % checkpoint_every == 0:
                checkpoint_manager.save(step, state, blocking=True)
                saved_steps.append(step)
        except Exception:
            restarts += 1
            if restarts > max_restarts:
                raise
            latest = checkpoint_manager.latest_step()
            if latest is not None:
                state, manifest = checkpoint_manager.restore(
                    latest, state_like if state_like is not None else state)
                step = int(manifest["step"])
            else:
                step = 0
    return state, LoopReport(step, restarts, len(sd.events), saved_steps)
