"""Resource-allocation policies — Algorithm 1 and the §III baselines as data
(the single-stream half of the JAX package's ``core/allocation.py``).

An ``AllocationPolicy`` looks at per-phase feedback (validation vs.
fresh-label accuracy, the engine-side drift flag, the virtual clock) and
emits the decision the engine (core/session.py) executes next: a flat
``AllocationDecision``, the facade over the two planes of
core/decision.py. Every behavioural difference between DaCapo-
Spatiotemporal, DaCapo-Spatial, DC-ST-Online, DaCapo-Replay, Ekya and
EOMU lives here, not in the engine loop. The virtual-clock arithmetic is
the reference's, float for float.

Not ported yet: ``FleetAllocator`` (ROADMAP Queue 1, item 8);
``make_allocator`` raises on its names.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, Optional, Sequence, Tuple, Type

from repro_torch.configs.dacapo_pairs import VisionConfig
from repro_torch.core.decision import Decision
from repro_torch.core.drift import DriftDetector
from repro_torch.core.estimator import spatial_allocation
from repro_torch.core.mx import DEFAULT_POLICY, PrecisionPolicy


@dataclasses.dataclass
class CLHyperParams:
    """Table I notation."""

    n_t: int = 256  # samples per retraining phase
    n_l: int = 128  # samples labeled at usual
    n_ldd_mult: int = 4  # N_ldd = 4 * N_l (paper §VI-B)
    c_b: int = 1024  # sample buffer capacity
    v_thr: float = -0.10  # drift threshold on acc_l - acc_v (tuned offline
    # per paper §VI-D; -0.05 false-positives on n_l=32..48 estimates)
    fps: float = 30.0
    epochs: int = 1
    sgd_batch: int = 16  # paper §VII-A
    lr: float = 1e-3  # paper §VII-A

    @property
    def n_v(self) -> int:  # N_v = N_t / 4 (paper §VI-B)
        return max(1, self.n_t // 4)

    @property
    def n_ldd(self) -> int:
        return self.n_ldd_mult * self.n_l


@dataclasses.dataclass(frozen=True)
class AllocationDecision:
    """One phase of work, flat — the facade over the two decision planes.
    :meth:`split` lifts it into a two-plane
    :class:`~repro_torch.core.decision.Decision` (what the engine consumes);
    ``Decision.to_legacy()`` flattens one back."""

    retrain_samples: int
    valid_samples: int
    label_samples: int
    reset_buffer: bool = False
    extra_label_samples: int = 0  # N_ldd - N_l on drift (Alg. 1 line 13)
    rows_tsa: Optional[int] = None  # None -> engine's offline split
    rows_bsa: Optional[int] = None
    precisions: PrecisionPolicy = DEFAULT_POLICY
    pace_window_s: Optional[float] = None  # fixed-window grid period
    retrain_epochs: Optional[int] = None  # None -> hp.epochs
    profile_cost_s: float = 0.0  # T-SA seconds of profiling overhead

    @property
    def total_label_samples(self) -> int:
        return self.label_samples + self.extra_label_samples

    def split(self) -> Decision:
        """Lift into the two-plane API: (SpatialPlan, TemporalPlan)."""
        return Decision.from_legacy(self)


@dataclasses.dataclass(frozen=True)
class PhaseFeedback:
    """What the engine reports back to the policy after each phase.
    ``drifted`` is the engine-side drift verdict; ``None`` (hand-built
    feedbacks) makes the policy consult its own detector."""

    acc_valid: float
    acc_label: float
    t: float  # virtual clock at phase end
    phase_start: float = 0.0
    retrain_time: float = 0.0
    label_time: float = 0.0
    drifted: Optional[bool] = None  # engine-side drift verdict


class AllocationPolicy:
    """Base policy: fixed Table-I temporal budgets, offline spatial split.
    Subclasses override :meth:`next_decision` (and optionally
    ``pace_window_s``). ``initial_plan``/``next_phase`` are deprecated
    aliases kept for the legacy scheduler API (core/scheduler.py)."""

    name = "base"
    pace_window_s: Optional[float] = None
    # Trace-scored policies set True: the session then creates a
    # TraceRecorder (core/trace.py) and hands it over via attach_trace.
    needs_trace = False

    def __init__(self, hp: CLHyperParams,
                 precision: PrecisionPolicy = DEFAULT_POLICY):
        self.hp = hp
        self.precision = precision
        self.detector = DriftDetector(v_thr=hp.v_thr)
        self._rows: Tuple[Optional[int], Optional[int]] = (None, None)
        self._trace_recorder = None

    def attach_trace(self, recorder) -> None:
        """Receive the session's TraceRecorder (called at construction
        when tracing is on; policies that do not score by replay keep it
        unused)."""
        self._trace_recorder = recorder

    # -------------------------------------------------------------- binding
    def bind(self, estimator, student_cfg: VisionConfig) -> "AllocationPolicy":
        """GetSpatialAllocation (Alg. 1 line 1): compute the offline
        T-SA/B-SA split this policy's decisions will carry."""
        self._rows = spatial_allocation(estimator, student_cfg, self.hp.fps,
                                        self.precision.inference)
        return self

    @property
    def rows(self) -> Tuple[Optional[int], Optional[int]]:
        return self._rows

    # ------------------------------------------------------------ decisions
    def _decision(self, retrain_samples: int, *, reset: bool = False,
                  extra_label: int = 0) -> AllocationDecision:
        r_tsa, r_bsa = self._rows
        return AllocationDecision(
            retrain_samples=retrain_samples,
            valid_samples=self.hp.n_v,
            label_samples=self.hp.n_l,
            reset_buffer=reset,
            extra_label_samples=extra_label,
            rows_tsa=r_tsa,
            rows_bsa=r_bsa,
            precisions=self.precision,
            pace_window_s=self.pace_window_s,
        )

    def initial_decision(self) -> AllocationDecision:
        return self._decision(self.hp.n_t)

    def next_decision(self, feedback: PhaseFeedback) -> AllocationDecision:
        raise NotImplementedError

    # ---------------------------------------------------------------- drift
    def observe_drift(self, acc_label: float, acc_valid: float,
                      t: float) -> bool:
        """The drift verdict for a phase — called once by the engine at the
        phase barrier, and handed to the policy on ``feedback.drifted``."""
        return self.detector.check(acc_label, acc_valid, t)

    def _drift(self, feedback: PhaseFeedback) -> bool:
        """The engine-set drift flag when present, else this policy's own
        detector."""
        if feedback.drifted is not None:
            return feedback.drifted
        return self.observe_drift(feedback.acc_label, feedback.acc_valid,
                                  feedback.t)

    # ------------------------------------------------- legacy scheduler API
    def initial_plan(self) -> AllocationDecision:
        warnings.warn(
            "AllocationPolicy.initial_plan() is deprecated; use "
            "initial_decision() (or the two-plane Decision API via "
            ".split())", DeprecationWarning, stacklevel=2)
        return self.initial_decision()

    def next_phase(self, acc_valid: float, acc_label: float,
                   t: float) -> AllocationDecision:
        warnings.warn(
            "AllocationPolicy.next_phase() is deprecated; use "
            "next_decision(PhaseFeedback(...)) (or the two-plane Decision "
            "API via .split())", DeprecationWarning, stacklevel=2)
        return self.next_decision(
            PhaseFeedback(acc_valid=acc_valid, acc_label=acc_label, t=t))


class SpatiotemporalAllocator(AllocationPolicy):
    """DaCapo-Spatiotemporal (DC-ST): drift-adaptive temporal allocation.

    Alg. 1 lines 11-13: on drift, reset the buffer and extend the labeling
    phase to N_ldd samples."""

    name = "dacapo-spatiotemporal"

    def next_decision(self, feedback: PhaseFeedback) -> AllocationDecision:
        drift = self._drift(feedback)
        if drift:
            return self._decision(self.hp.n_t, reset=True,
                                  extra_label=self.hp.n_ldd - self.hp.n_l)
        return self._decision(self.hp.n_t)


class SpatialAllocator(SpatiotemporalAllocator):
    """DaCapo-Spatial (DC-S): static spatial split, fixed temporal
    alternation — never resets the buffer nor boosts labeling."""

    name = "dacapo-spatial"

    def next_decision(self, feedback: PhaseFeedback) -> AllocationDecision:
        self._drift(feedback)  # logged, unused
        return self._decision(self.hp.n_t)


class OnlineSpatiotemporalAllocator(SpatiotemporalAllocator):
    """DaCapo-Spatiotemporal-Online (DC-ST-Online): drift-reactive *online
    spatial* re-allocation on top of DC-ST's temporal boost.

    On drift, ``boost_rows`` rows move from the B-SA to the T-SA; they stay
    for at least ``hysteresis_phases`` phases and return once
    ``acc_valid`` recovers to its pre-drift EMA within ``recover_margin``.
    ``boost_rows=0`` makes the policy decision-for-decision DC-ST;
    ``boost_rows=None`` picks a quarter of the offline B-SA rows at
    ``bind`` (at least one, never draining the B-SA).
    """

    name = "dacapo-spatiotemporal-online"

    def __init__(self, hp: CLHyperParams,
                 precision: PrecisionPolicy = DEFAULT_POLICY,
                 boost_rows: Optional[int] = None,
                 hysteresis_phases: int = 2,
                 recover_margin: float = 0.05):
        super().__init__(hp, precision)
        self._boost_cfg = boost_rows
        self.hysteresis_phases = hysteresis_phases
        self.recover_margin = recover_margin
        self.boost_rows = 0
        self._boosted = False
        self._hold = 0
        self._acc_ema: Optional[float] = None

    def bind(self, estimator, student_cfg: VisionConfig) -> "AllocationPolicy":
        super().bind(estimator, student_cfg)
        r_tsa, r_bsa = self._rows
        if not r_tsa or not r_bsa:
            # R=0 fallback regime: one side already time-shares the whole
            # array, so shifting rows would *shrink* it. Disable.
            self.boost_rows = 0
            return self
        avail = max(0, r_bsa - 1)  # never drain the B-SA entirely
        want = (max(1, r_bsa // 4) if self._boost_cfg is None
                else self._boost_cfg)
        self.boost_rows = min(want, avail)
        return self

    def _current_rows(self) -> Tuple[Optional[int], Optional[int]]:
        r_tsa, r_bsa = self._rows
        if self._boosted and r_tsa is not None:
            return r_tsa + self.boost_rows, r_bsa - self.boost_rows
        return r_tsa, r_bsa

    def _decision(self, retrain_samples: int, *, reset: bool = False,
                  extra_label: int = 0) -> AllocationDecision:
        base = super()._decision(retrain_samples, reset=reset,
                                 extra_label=extra_label)
        r_tsa, r_bsa = self._current_rows()
        return dataclasses.replace(base, rows_tsa=r_tsa, rows_bsa=r_bsa)

    def next_decision(self, feedback: PhaseFeedback) -> AllocationDecision:
        drift = self._drift(feedback)
        if not self._boosted and not drift:
            # Healthy-state acc_valid baseline the recovery check targets.
            self._acc_ema = (feedback.acc_valid if self._acc_ema is None
                             else 0.5 * self._acc_ema
                             + 0.5 * feedback.acc_valid)
        if drift and self.boost_rows > 0:
            self._boosted = True
            self._hold = self.hysteresis_phases
        elif self._boosted:
            self._hold -= 1
            recovered = (feedback.acc_valid
                         >= (self._acc_ema or 0.0) - self.recover_margin)
            if self._hold <= 0 and recovered:
                self._boosted = False
        if drift:
            return self._decision(self.hp.n_t, reset=True,
                                  extra_label=self.hp.n_ldd - self.hp.n_l)
        return self._decision(self.hp.n_t)


class EkyaAllocator(SpatiotemporalAllocator):
    """Ekya: fixed 120 s retraining window; per-window label quota then
    retraining for the rest of the window (``pace_window_s`` pads the
    virtual clock to the window grid). A positive ``profile_cost`` (seconds
    per window) rides on every decision as ``profile_cost_s`` and is
    charged to the T-SA ledger; the default 0.0 idealizes it away."""

    name = "ekya"
    pace_window_s = 120.0

    def __init__(self, hp: CLHyperParams,
                 precision: PrecisionPolicy = DEFAULT_POLICY,
                 profile_cost: float = 0.0):
        super().__init__(hp, precision)
        self.profile_cost = profile_cost

    def _decision(self, retrain_samples: int, *, reset: bool = False,
                  extra_label: int = 0) -> AllocationDecision:
        base = super()._decision(retrain_samples, reset=reset,
                                 extra_label=extra_label)
        if not self.profile_cost:
            return base
        return dataclasses.replace(base, profile_cost_s=self.profile_cost)

    def next_decision(self, feedback: PhaseFeedback) -> AllocationDecision:
        return self._decision(self.hp.n_t)


class EOMUAllocator(SpatiotemporalAllocator):
    """EOMU-like: short (10 s) windows; retraining triggered by a logged
    accuracy drop, otherwise the window only labels."""

    name = "eomu"
    pace_window_s = 10.0
    drop_eps = 0.02

    def __init__(self, hp: CLHyperParams,
                 precision: PrecisionPolicy = DEFAULT_POLICY):
        super().__init__(hp, precision)
        self._last_acc: Optional[float] = None

    def next_decision(self, feedback: PhaseFeedback) -> AllocationDecision:
        self._drift(feedback)  # logged, unused (EOMU triggers on drops)
        trigger = (self._last_acc is None
                   or feedback.acc_label < self._last_acc - self.drop_eps)
        self._last_acc = feedback.acc_label
        return self._decision(self.hp.n_t if trigger else 0)


class ReplayAllocator(SpatiotemporalAllocator):
    """DaCapo-Replay: DC-ST with replay-scored retraining boosts.

    The allocator whose profiling cost is *measured*, not assumed: each
    phase it builds K candidate decisions (DC-ST's choice with the
    retraining budget boosted by ``boost_factors``, quantized to SGD-batch
    multiples and capped at the buffer capacity), prices each by
    :meth:`~repro_torch.core.replay.TraceReplayer.predict` against the
    just-recorded phase instead of executing it, and picks the largest
    boost whose predicted phase time stays within ``slack_tol`` of the
    unboosted prediction. Under concurrent dispatch that fills the T-SA
    slack of B-SA-bound phases with extra retraining; under sequential
    dispatch (no slack by construction) every boost extends the phase and
    the policy degenerates to DC-ST. The host wall time the replay scoring
    took is charged to the decision's ``profile_cost_s``, so a session
    under this policy does not repeat bit for bit from run to run.

    ``needs_trace`` makes the session create a
    :class:`~repro_torch.core.trace.TraceRecorder` when none is configured.
    """

    name = "dacapo-replay"
    needs_trace = True

    def __init__(self, hp: CLHyperParams,
                 precision: PrecisionPolicy = DEFAULT_POLICY,
                 boost_factors: Sequence[float] = (3.0, 2.0, 1.5),
                 slack_tol: float = 0.02):
        super().__init__(hp, precision)
        self.boost_factors = tuple(sorted(boost_factors, reverse=True))
        self.slack_tol = slack_tol

    def next_decision(self, feedback: PhaseFeedback) -> AllocationDecision:
        from repro_torch.core.replay import TraceReplayer

        base = super().next_decision(feedback)
        recorder = self._trace_recorder
        if recorder is None or len(recorder) == 0:
            return base
        phases = recorder.phases
        last = len(phases) - 1
        if not any(e.label == "retrain" for e in phases[last].events):
            return base  # no retraining recorded: nothing to re-price
        t0 = time.perf_counter()
        replayer = TraceReplayer(recorder.trace, hp=self.hp)
        budget = replayer.predict(last, base) * (1.0 + self.slack_tol)
        pick = base
        for factor in self.boost_factors:  # descending: largest fit wins
            n = self.hp.sgd_batch * int(
                base.retrain_samples * factor // self.hp.sgd_batch)
            n = min(n, self.hp.c_b)
            if n <= base.retrain_samples:
                continue
            cand = dataclasses.replace(base, retrain_samples=n)
            if replayer.predict(last, cand) <= budget:
                pick = cand
                break
        # The replay scoring's measured wall IS the profiling cost.
        return dataclasses.replace(
            pick, profile_cost_s=time.perf_counter() - t0)


ALLOCATORS: Dict[str, Type[AllocationPolicy]] = {
    "dacapo-spatiotemporal": SpatiotemporalAllocator,
    "dacapo-spatiotemporal-online": OnlineSpatiotemporalAllocator,
    "dacapo-spatial": SpatialAllocator,
    "dacapo-replay": ReplayAllocator,
    "ekya": EkyaAllocator,
    "eomu": EOMUAllocator,
}

# The fleet's policies (``"fleet"``, ``"fleet-*"``): not ported yet.
_NOT_PORTED = {"fleet": "ROADMAP Queue 1, item 8 (core/fleet.py)"}


def make_allocator(allocator, hp: CLHyperParams,
                   precision: PrecisionPolicy = DEFAULT_POLICY
                   ) -> AllocationPolicy:
    """Resolve a policy from a registry name, class, or ready instance; a
    fleet policy's name raises ``NotImplementedError`` (not ported yet)."""
    if isinstance(allocator, AllocationPolicy):
        return allocator
    if isinstance(allocator, str):
        if allocator.startswith("fleet"):
            raise NotImplementedError(
                f"allocator {allocator!r} is not ported yet: "
                f"{_NOT_PORTED['fleet']}")
        try:
            cls = ALLOCATORS[allocator]
        except KeyError:
            raise KeyError(
                f"unknown allocator {allocator!r}; "
                f"known: {sorted(ALLOCATORS)}") from None
        return cls(hp, precision)
    return allocator(hp, precision)
