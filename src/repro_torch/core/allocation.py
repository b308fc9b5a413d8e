"""Resource-allocation policies — Algorithm 1 and the §III baselines as data
(the JAX package's ``core/allocation.py`` ported).

An ``AllocationPolicy`` looks at per-phase feedback (validation vs.
fresh-label accuracy, the engine-side drift flag, the virtual clock) and
emits the decision the engine (core/session.py) executes next: a flat
``AllocationDecision``, the facade over the two planes of
core/decision.py. Every behavioural difference between DaCapo-
Spatiotemporal, DaCapo-Spatial, DC-ST-Online, DaCapo-Replay, Ekya and
EOMU lives here, not in the engine loop. The virtual-clock arithmetic is
the reference's, float for float.

Fleets add one more layer: ``FleetAllocator`` wraps a per-stream policy per
camera, re-proportions the fleet's shared T-SA budget across the streams
each phase (``FLEET_MODES``), and emits a
:class:`~repro_torch.core.decision.FleetDecision`: N per-lane temporal
planes plus ONE fleet-wide spatial plane from its
:class:`~repro_torch.core.decision.FleetRowPolicy`.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple, Type

from repro_torch.configs.dacapo_pairs import VisionConfig
from repro_torch.core.decision import (
    Decision,
    FleetDecision,
    FleetRowContext,
    make_fleet_row_policy,
)
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

    @classmethod
    def from_decision(cls, decision: Decision) -> "AllocationDecision":
        """Flatten a two-plane decision back into the legacy layout."""
        return decision.to_legacy()


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


FLEET_MODES = ("uniform", "round-robin", "drift-weighted", "isolated")


class FleetAllocator(AllocationPolicy):
    """Cross-stream T-SA allocator: wraps one per-stream policy per camera
    and splits the fleet's shared labeling/retraining budget across streams
    each phase (Ekya's multi-tenant scheduling problem, ECCO's cross-camera
    budget sharing — PAPERS.md).

    Each stream lane keeps an ordinary :class:`AllocationPolicy` (its own
    drift detector, its own online row state), so DC-ST / DC-ST-Online /
    Ekya / EOMU compose unchanged; the fleet layer *re-proportions* the
    temporal budgets the lane policies emit, and resolves their spatial
    requests into ONE fleet
    :class:`~repro_torch.core.decision.SpatialPlan` via the pluggable
    ``row_policy`` (:class:`~repro_torch.core.decision.FleetRowPolicy`:
    ``resolve-max``, the default, / ``drift-surge`` / ``weighted-vote``),
    emitted together as a per-phase
    :class:`~repro_torch.core.decision.FleetDecision`
    (``initial_fleet_decision`` / ``next_fleet_decision``). The fleet-wide
    budget per phase is ``budget_streams`` sessions' worth of T-SA work
    (default 1.0: an N-stream fleet spends the same per-phase T-SA time a
    single session would, keeping the phase cadence — and thus each
    stream's update latency — independent of N).

    Modes (``FLEET_MODES``):

    * ``uniform`` — every stream gets ``1/N`` of the budget every phase;
    * ``round-robin`` — one focus stream per phase gets the whole budget,
      the rest label at the ``label_floor`` and retrain at the heartbeat
      minimum (drift stays detectable on every camera);
    * ``drift-weighted`` — shares follow each stream's accuracy-loss
      signal: the drift gap ``max(0, acc_valid - acc_label)`` (spikes at
      drift onset, before the buffer reset) plus the *recovery deficit*
      ``max(0, best_acc - acc_label)`` — how far the lane currently runs
      below its own healthy fresh-label accuracy (an EMA-tracked high-water
      mark), which keeps budget on a drifted camera through retraining,
      after the reset has collapsed the gap term — with a ``× drift_bias``
      boost on phases whose lane policy fired drift;
    * ``isolated`` — no re-proportioning at all: every stream keeps its
      full per-session budget, so the fleet phase costs ~N× the T-SA time
      (the naive "N sessions time-sharing one accelerator" baseline the
      fleet bench compares against).

    Per-stream decisions are emitted as ordinary ``AllocationDecision``s
    (scaled via ``dataclasses.replace``), and a weight of exactly 1 returns
    the lane decision object untouched — a 1-stream fleet is decision-for-
    decision identical to the wrapped policy, which the degeneracy golden
    pins. With ``scale_epochs``, retraining depth is proportioned too: a
    lane at ``k×`` its uniform share retrains for ``round(k × hp.epochs)``
    epochs (≥ 1).

    Scaled sample budgets are quantized to multiples of ``bucket`` (labels/
    retraining; validation to ``bucket // 2``), as in the reference: the
    bucketed budgets are part of the decisions both packages must agree
    on (the reference buckets to keep its set of compiled batch shapes
    small).
    """

    name = "fleet"

    def __init__(self, hp: CLHyperParams,
                 precision: PrecisionPolicy = DEFAULT_POLICY,
                 policy="dacapo-spatiotemporal",
                 mode: str = "drift-weighted",
                 budget_streams: float = 1.0,
                 label_floor: float = 0.25,
                 drift_bias: float = 4.0,
                 gap_eps: float = 0.02,
                 gap_ema: float = 0.5,
                 scale_epochs: bool = False,
                 bucket: int = 8,
                 row_policy="resolve-max"):
        super().__init__(hp, precision)
        if mode not in FLEET_MODES:
            raise ValueError(
                f"unknown fleet mode {mode!r}; known: {FLEET_MODES}")
        if isinstance(policy, FleetAllocator) or policy is FleetAllocator:
            raise ValueError("FleetAllocator cannot wrap itself")
        self._policy_spec = policy
        self.mode = mode
        self.row_policy = make_fleet_row_policy(row_policy)
        self.name = f"fleet-{mode}"
        if self.row_policy.name != "resolve-max":
            self.name = f"fleet-{mode}+{self.row_policy.name}"
        self.budget_streams = budget_streams
        self.label_floor = label_floor
        self.drift_bias = drift_bias
        self.gap_eps = gap_eps
        self.gap_ema = gap_ema
        self.scale_epochs = scale_epochs
        self.bucket = max(1, bucket)
        self.policies: List[AllocationPolicy] = []
        self._estimator = None
        self._student_cfg: Optional[VisionConfig] = None
        self._rr = 0  # round-robin focus cursor
        self._gaps: List[float] = []  # per-stream drift-gap EMA
        self._acc_ema: List[Optional[float]] = []  # fresh-label acc EMA
        self._acc_best: List[float] = []  # healthy-acc high-water mark
        self._last_weights: Optional[List[float]] = None  # last split shares
        self._last_base: Optional[List[AllocationDecision]] = None

    # -------------------------------------------------------------- binding
    def bind(self, estimator, student_cfg: VisionConfig) -> "FleetAllocator":
        super().bind(estimator, student_cfg)
        self._estimator, self._student_cfg = estimator, student_cfg
        for p in self.policies:
            p.precision = self.precision
            p.bind(estimator, student_cfg)
        return self

    def lanes(self, n: int) -> List[AllocationPolicy]:
        """(Re)create the per-stream policies for an ``n``-stream run —
        fresh drift detectors and round-robin/EMA state every run."""
        if isinstance(self._policy_spec, AllocationPolicy):
            if n > 1:
                raise ValueError(
                    "FleetAllocator needs a policy name/class for n > 1 "
                    "streams (a shared instance would share detector state)")
            self.policies = [self._policy_spec][:n]
        else:
            self.policies = [make_allocator(self._policy_spec, self.hp,
                                            self.precision)
                             for _ in range(n)]
        for p in self.policies:
            p.precision = self.precision
            if self._estimator is not None:
                p.bind(self._estimator, self._student_cfg)
        self._rr = 0
        self._gaps = [0.0] * n
        self._acc_ema = [None] * n
        self._acc_best = [0.0] * n
        self._last_weights = None
        self._last_base = None
        self.row_policy.reset(n)
        return self.policies

    def begin_empty(self) -> None:
        """Start a zero-lane fleet that ``admit_lane`` will populate — the
        manager's restore path (an empty shard receiving re-homed lanes).
        Fresh fleet-side state, with the base-decision ledger open so the
        first ``rebuild_fleet_decision`` sees the admitted lanes."""
        self.lanes(0)
        self._last_base = []

    # ------------------------------------------------------------ decisions
    _SINGLE_STREAM_MSG = (
        "FleetAllocator emits per-stream decision lists "
        "(initial_decisions/next_decisions) and must run inside a "
        "FleetSession — build one via FleetSpec, not CLSystemSpec")

    def initial_decision(self) -> AllocationDecision:
        raise TypeError(self._SINGLE_STREAM_MSG)

    def next_decision(self, feedback: PhaseFeedback) -> AllocationDecision:
        raise TypeError(self._SINGLE_STREAM_MSG)

    def initial_decisions(self, n: int) -> List[AllocationDecision]:
        self.lanes(n)  # fresh per-lane policies/state every run
        base = [p.initial_decision() for p in self.policies]
        self._last_base = list(base)
        self._last_weights = self._weights(base, None)
        return self._split(base, self._last_weights)

    def next_decisions(self, feedbacks: Sequence[PhaseFeedback]
                       ) -> List[AllocationDecision]:
        if len(feedbacks) != len(self.policies):
            raise ValueError(
                f"{len(feedbacks)} feedbacks for {len(self.policies)} lanes")
        base = [p.next_decision(fb)
                for p, fb in zip(self.policies, feedbacks)]
        self._last_base = list(base)
        self._last_weights = self._weights(base, feedbacks)
        return self._split(base, self._last_weights)

    # ------------------------------------------------------ fleet decisions
    def initial_fleet_decision(self, n: int) -> FleetDecision:
        """The fleet phase as a first-class decision: N per-lane temporal
        planes + ONE fleet spatial plane from the bound row policy."""
        return self._fleet_decision(self.initial_decisions(n), None)

    def next_fleet_decision(self, feedbacks: Sequence[PhaseFeedback]
                            ) -> FleetDecision:
        return self._fleet_decision(self.next_decisions(feedbacks),
                                    feedbacks)

    def _fleet_decision(self, lane_decisions: Sequence[AllocationDecision],
                        feedbacks: Optional[Sequence[PhaseFeedback]]
                        ) -> FleetDecision:
        if self._estimator is None:
            raise RuntimeError(
                "FleetAllocator must be bound (estimator + student config) "
                "before emitting FleetDecisions")
        n = len(lane_decisions)
        total = self._estimator.total_rows
        planes = [d.split() for d in lane_decisions]
        spatials = [p.spatial.resolve(self._rows[0], self._rows[1], total)
                    for p in planes]
        # The fleet executes ONE spatial plane, so one PrecisionPolicy:
        # lane precisions are forced to the fleet's at bind/lanes() time —
        # refuse loudly if a custom lane policy diverged anyway, rather
        # than silently charging every lane at lane 0's precisions.
        first = spatials[0].precisions
        if any(s.precisions != first for s in spatials[1:]):
            raise ValueError(
                "heterogeneous per-lane precisions are not supported at "
                "the fleet level: the FleetDecision carries ONE fleet "
                "SpatialPlan (and ledger) for the whole array")
        # Engine-side drift truth when the feedback carries it; a lane
        # policy's reset flag is the pre-`drifted` fallback (identical for
        # DC-ST-family lanes, where reset fires exactly on drift).
        drifted = tuple(
            (fb.drifted if fb is not None and fb.drifted is not None
             else d.reset_buffer)
            for fb, d in zip(feedbacks or [None] * n, lane_decisions))
        weights = tuple(self._last_weights or [1.0 / n] * n)
        ctx = FleetRowContext(drifted=drifted, weights=weights,
                              total_rows=total)
        return FleetDecision(
            spatial=self.row_policy.fleet_spatial(spatials, ctx),
            temporal=tuple(p.temporal for p in planes),
            lane_decisions=tuple(lane_decisions))

    # ------------------------------------------------------ lane membership
    # The fleet-manager tier changes membership mid-run: a camera is
    # admitted, a lane migrates between shards, a dead shard's lanes are
    # re-homed onto survivors. These hooks keep every per-lane parallel
    # list (policy, drift-gap EMA, fresh-label EMA, high-water mark, last
    # base decision) consistent without resetting the surviving lanes'
    # state the way ``lanes()`` would.

    def lane_policy_state(self, i: int) -> tuple:
        """The fleet-side state of lane ``i``, as ``admit_lane`` re-accepts
        it: (gap EMA, fresh-label EMA, high-water mark, last base
        decision). Part of a lane snapshot — restoring it on the target
        fleet makes the drift-weighted split treat the migrated lane
        exactly as the source fleet would have."""
        base = None if self._last_base is None else self._last_base[i]
        return (self._gaps[i], self._acc_ema[i], self._acc_best[i], base)

    def admit_lane(self, policy: Optional[AllocationPolicy] = None,
                   lane_state: Optional[tuple] = None) -> int:
        """Grow the fleet by one lane mid-run (admission, or a migrated
        lane re-homing here). ``policy`` is the migrating lane's live
        :class:`AllocationPolicy` — carrying its drift detector — or None
        for a fresh camera; ``lane_state`` is :meth:`lane_policy_state`
        from the source fleet. Returns the new lane index."""
        if policy is None:
            if isinstance(self._policy_spec, AllocationPolicy):
                raise ValueError(
                    "cannot admit a fresh lane into a FleetAllocator built "
                    "around a shared policy instance — pass a policy "
                    "name/class, or hand admit_lane the lane's policy")
            policy = make_allocator(self._policy_spec, self.hp,
                                    self.precision)
        policy.precision = self.precision
        if self._estimator is not None:
            policy.bind(self._estimator, self._student_cfg)
        self.policies.append(policy)
        gap, ema, best, base = lane_state or (0.0, None, 0.0, None)
        self._gaps.append(gap)
        self._acc_ema.append(ema)
        self._acc_best.append(best)
        if self._last_base is not None:
            self._last_base.append(base if base is not None
                                   else policy.initial_decision())
        return len(self.policies) - 1

    def remove_lane(self, i: int) -> AllocationPolicy:
        """Shrink the fleet by lane ``i`` (migration out / lane retired),
        returning its live policy so a migration can carry it along."""
        policy = self.policies.pop(i)
        self._gaps.pop(i)
        self._acc_ema.pop(i)
        self._acc_best.pop(i)
        if self._last_base is not None:
            self._last_base.pop(i)
        if self._last_weights is not None and i < len(self._last_weights):
            self._last_weights.pop(i)
        return policy

    def rebuild_fleet_decision(self) -> FleetDecision:
        """Re-emit a :class:`FleetDecision` for the *current* membership
        from the lanes' last base decisions — the phase-boundary refresh
        after ``admit_lane``/``remove_lane``, without advancing any lane
        policy (no feedback is consumed). Drift-weighted fleets degrade to
        a uniform split for this one rebuilt phase (the weights are
        feedback-driven); round-robin keeps its focus cursor unmoved."""
        if self._last_base is None:
            return self.initial_fleet_decision(len(self.policies))
        rr = self._rr  # a rebuild is not a phase: don't advance the focus
        self._last_weights = self._weights(self._last_base, None)
        self._rr = rr
        return self._fleet_decision(
            self._split(self._last_base, self._last_weights), None)

    # -------------------------------------------------------------- weights
    def _weights(self, base: Sequence[AllocationDecision],
                 feedbacks: Optional[Sequence[PhaseFeedback]]
                 ) -> Optional[List[float]]:
        n = len(base)
        if self.mode == "isolated":
            return None  # no re-proportioning
        if self.mode == "round-robin":
            focus = self._rr % n
            self._rr += 1
            return [1.0 if i == focus else 0.0 for i in range(n)]
        if self.mode == "drift-weighted" and feedbacks is not None:
            raw = []
            for i, (d, fb) in enumerate(zip(base, feedbacks)):
                # Drift gap: buffer-vs-fresh mismatch (fires at drift
                # onset, collapses once the buffer resets to fresh data).
                gap = max(0.0, fb.acc_valid - fb.acc_label)
                self._gaps[i] = (self.gap_ema * self._gaps[i]
                                 + (1.0 - self.gap_ema) * gap)
                # Recovery deficit: distance below the lane's own healthy
                # fresh-label accuracy — keeps budget on a drifted camera
                # through retraining, after the gap term has collapsed.
                self._acc_ema[i] = (fb.acc_label
                                    if self._acc_ema[i] is None
                                    else self.gap_ema * self._acc_ema[i]
                                    + (1.0 - self.gap_ema) * fb.acc_label)
                self._acc_best[i] = max(self._acc_best[i],
                                        self._acc_ema[i])
                deficit = max(0.0, self._acc_best[i] - fb.acc_label)
                w = self.gap_eps + self._gaps[i] + deficit
                # Engine-set drift truth (feedback.drifted); the lane's
                # reset flag is the legacy fallback — identical for the
                # DC-ST family, where resets fire exactly on drift.
                if (fb.drifted if fb.drifted is not None
                        else d.reset_buffer):
                    w *= self.drift_bias
                raw.append(w)
            total = sum(raw)
            if total <= 0.0:  # e.g. gap_eps=0 on an all-healthy fleet
                return [1.0 / n] * n
            return [w / total for w in raw]
        # uniform (and drift-weighted's first phase, before any feedback)
        return [1.0 / n] * n

    # -------------------------------------------------------------- scaling
    def _split(self, base: Sequence[AllocationDecision],
               weights: Optional[Sequence[float]]
               ) -> List[AllocationDecision]:
        if weights is None:
            return list(base)
        n = len(base)
        return [self._scale(d, w, n) for d, w in zip(base, weights)]

    def _scale(self, d: AllocationDecision, weight: float,
               n: int) -> AllocationDecision:
        share = weight * self.budget_streams
        if abs(share - 1.0) < 1e-12 and not (self.scale_epochs and n > 1):
            return d  # exact degeneracy: 1-stream fleets reuse the decision

        def q(x: float, b: int) -> int:  # quantize to a shape bucket
            return int(round(x / b)) * b

        b = self.bucket
        label_floor = max(1, int(round(self.label_floor * self.hp.n_l)))
        # Retraining heartbeat: a lane that retrains at all runs at least
        # one SGD batch. Scaling into (0, sgd_batch) would draw data and
        # refresh serving while executing zero steps, and scaling to zero
        # makes the engine report the acc_valid=1.0 sentinel — either way
        # the lane's drift detector sees noise and fires false resets.
        retrain = q(d.retrain_samples * share, b)
        if d.retrain_samples > 0:
            retrain = max(self.hp.sgd_batch, retrain)
        # Validation is detection infrastructure, not adaptation budget:
        # a retraining lane keeps its full N_v (cheap student inference)
        # so acc_valid — half of the drift signal — stays low-variance.
        valid = (d.valid_samples if retrain > 0
                 else q(d.valid_samples * share, max(1, b // 2)))
        label = max(label_floor, q(d.label_samples * share, b))
        extra = q(d.extra_label_samples * share, b)
        epochs = d.retrain_epochs
        if self.scale_epochs and retrain > 0:
            # k× the uniform share -> k× the retraining depth (>= 1 epoch).
            epochs = max(1, int(round((epochs or self.hp.epochs)
                                      * weight * n)))
        return dataclasses.replace(
            d, retrain_samples=retrain, valid_samples=valid,
            label_samples=label, extra_label_samples=extra,
            retrain_epochs=epochs)


ALLOCATORS: Dict[str, Type[AllocationPolicy]] = {
    "dacapo-spatiotemporal": SpatiotemporalAllocator,
    "dacapo-spatiotemporal-online": OnlineSpatiotemporalAllocator,
    "dacapo-spatial": SpatialAllocator,
    "dacapo-replay": ReplayAllocator,
    "ekya": EkyaAllocator,
    "eomu": EOMUAllocator,
}

def make_allocator(allocator, hp: CLHyperParams,
                   precision: PrecisionPolicy = DEFAULT_POLICY
                   ) -> AllocationPolicy:
    """Resolve a policy from a registry name, class, or ready instance."""
    if isinstance(allocator, AllocationPolicy):
        return allocator
    if isinstance(allocator, str):
        try:
            cls = ALLOCATORS[allocator]
        except KeyError:
            raise KeyError(
                f"unknown allocator {allocator!r}; "
                f"known: {sorted(ALLOCATORS)}") from None
        return cls(hp, precision)
    return allocator(hp, precision)
