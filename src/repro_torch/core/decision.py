"""The two-plane decision API: SpatialPlan / TemporalPlan / Decision, the
fleet's FleetDecision with its pluggable row policies, and the manager
tier's ManagerDecision / PlacementAction (the JAX package's
``core/decision.py``).

* :class:`SpatialPlan` — where compute lives for a phase: the T-SA/B-SA
  row split, the per-kernel MX precisions, and the mesh re-fission intent;
* :class:`TemporalPlan` — what the phase does with its time: sample
  budgets (retraining / validation / labeling and the N_ldd drift boost),
  buffer reset, fixed-window pacing, retraining depth, and profiling
  overhead charged to the T-SA ledger.

A frozen :class:`Decision` combines one plane of each and is what the
engine (:class:`~repro_torch.core.session.CLSession`) consumes; the flat
``AllocationDecision`` (core/allocation.py) is a bidirectional facade over
it — ``AllocationDecision.split()`` lifts, ``Decision.to_legacy()``
flattens, and the round trip is the identity.

A :class:`FleetDecision` carries N per-lane :class:`TemporalPlan`s plus ONE
fleet-wide :class:`SpatialPlan` — the array is one, so the fleet has one
row split per phase — produced by a :class:`FleetRowPolicy`:

* ``resolve-max`` — the most T-SA-hungry lane wins (``max`` of the T-SA
  requests, ``min`` of the B-SA ones);
* ``drift-surge`` — when a quorum of lanes drifts in the same phase, grow
  the fleet T-SA by ``surge_rows`` (never draining the B-SA) and hold the
  surge under a hysteresis window;
* ``weighted-vote`` — each lane votes its requested T-SA rows (plus a
  drift boost when its detector fired), and the fleet split is the
  drift-weighted average of the votes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Type

from repro_torch.core.mx import DEFAULT_POLICY, PrecisionPolicy

ROLE_TSA = "t_sa"
ROLE_BSA = "b_sa"


@dataclasses.dataclass(frozen=True)
class SpatialPlan:
    """The *where* of one phase: rows, precisions, re-fission intent.

    ``rows_tsa`` / ``rows_bsa`` follow the legacy encoding: ``None`` defers
    to the engine's offline split, ``0`` means that side time-shares the
    whole array (the paper's R=0 fallback). :meth:`resolve` applies both
    conventions and returns a plan with concrete row counts.
    """

    rows_tsa: Optional[int] = None
    rows_bsa: Optional[int] = None
    precisions: PrecisionPolicy = DEFAULT_POLICY
    refission: bool = True  # may the engine re-fission the mesh for this?

    def resolve(self, default_tsa: Optional[int], default_bsa: Optional[int],
                total_rows: int) -> "SpatialPlan":
        """Concrete rows: ``None`` -> offline default, ``0`` -> whole array."""
        r_tsa = self.rows_tsa if self.rows_tsa is not None else default_tsa
        r_bsa = self.rows_bsa if self.rows_bsa is not None else default_bsa
        return dataclasses.replace(self, rows_tsa=(r_tsa or total_rows),
                                   rows_bsa=(r_bsa or total_rows))

    def rows_for(self, role: str) -> Optional[int]:
        return self.rows_bsa if role == ROLE_BSA else self.rows_tsa


@dataclasses.dataclass(frozen=True)
class TemporalPlan:
    """The *when/how-much* of one phase: budgets, pacing, depth, overhead."""

    retrain_samples: int
    valid_samples: int
    label_samples: int
    reset_buffer: bool = False
    extra_label_samples: int = 0  # N_ldd - N_l on drift (Alg. 1 line 13)
    pace_window_s: Optional[float] = None  # fixed-window grid period
    retrain_epochs: Optional[int] = None  # None -> hp.epochs
    profile_cost_s: float = 0.0  # T-SA seconds of profiling overhead

    @property
    def total_label_samples(self) -> int:
        return self.label_samples + self.extra_label_samples


@dataclasses.dataclass(frozen=True)
class Decision:
    """One phase of work as two composable planes — what the engine runs."""

    spatial: SpatialPlan
    temporal: TemporalPlan

    @classmethod
    def from_legacy(cls, legacy) -> "Decision":
        """Lift a flat legacy ``AllocationDecision`` (duck-typed: anything
        with its fields) into the two planes."""
        return cls(
            spatial=SpatialPlan(rows_tsa=legacy.rows_tsa,
                                rows_bsa=legacy.rows_bsa,
                                precisions=legacy.precisions),
            temporal=TemporalPlan(
                retrain_samples=legacy.retrain_samples,
                valid_samples=legacy.valid_samples,
                label_samples=legacy.label_samples,
                reset_buffer=legacy.reset_buffer,
                extra_label_samples=legacy.extra_label_samples,
                pace_window_s=legacy.pace_window_s,
                retrain_epochs=legacy.retrain_epochs,
                profile_cost_s=legacy.profile_cost_s))

    def to_legacy(self):
        """Flatten back to the legacy facade (the exact inverse of
        ``AllocationDecision.split()``)."""
        from repro_torch.core.allocation import AllocationDecision

        s, t = self.spatial, self.temporal
        return AllocationDecision(
            retrain_samples=t.retrain_samples,
            valid_samples=t.valid_samples,
            label_samples=t.label_samples,
            reset_buffer=t.reset_buffer,
            extra_label_samples=t.extra_label_samples,
            rows_tsa=s.rows_tsa,
            rows_bsa=s.rows_bsa,
            precisions=s.precisions,
            pace_window_s=t.pace_window_s,
            retrain_epochs=t.retrain_epochs,
            profile_cost_s=t.profile_cost_s)


def as_decision(decision) -> Decision:
    """Normalize a policy's output: pass a :class:`Decision` through, lift
    a legacy ``AllocationDecision`` (or any duck-typed flat decision)."""
    if isinstance(decision, Decision):
        return decision
    return Decision.from_legacy(decision)


@dataclasses.dataclass(frozen=True)
class FleetDecision:
    """One fleet phase: N per-lane temporal planes, ONE fleet spatial plane.

    ``spatial`` carries *resolved* rows (the engine executes them as-is);
    ``lane_decisions`` keeps the per-lane legacy facades so records and
    observers stay on the exact objects the lane policies emitted.
    """

    spatial: SpatialPlan
    temporal: Tuple[TemporalPlan, ...]
    lane_decisions: Tuple = ()

    @property
    def n_lanes(self) -> int:
        return len(self.temporal)

    def per_lane(self) -> Tuple[Decision, ...]:
        """Per-lane :class:`Decision` views: the shared fleet spatial plane
        combined with each lane's temporal plane."""
        return tuple(Decision(spatial=self.spatial, temporal=t)
                     for t in self.temporal)


@dataclasses.dataclass(frozen=True)
class PlacementAction:
    """One lane-placement act in a manager round: an admission, a live
    migration, a fault-recovery re-home, or an admission *rejection*
    (the placement policy judged every shard oversubscribed — the camera
    is turned away rather than degrading the whole fleet). ``key`` is the
    lane's stable camera id; ``from_shard`` is ``None`` for admissions
    and rejections, ``to_shard`` is ``None`` for rejections only."""

    kind: str  # "admit" | "migrate" | "recover" | "reject"
    key: object
    to_shard: Optional[int]
    from_shard: Optional[int] = None
    reason: str = ""


@dataclasses.dataclass(frozen=True)
class ManagerDecision:
    """One manager round: :class:`FleetDecision` generalized to a
    per-shard tuple, plus the round's placement actions.

    The manager tier owns N shards (each one
    :class:`~repro_torch.core.fleet.FleetSession`), and each round every
    live shard executes its own :class:`FleetDecision` — there is no
    manager-wide spatial plane because the arrays are disjoint; what the
    manager decides is *where lanes live* (``placements``, emitted by a
    pluggable :class:`~repro_torch.core.manager.PlacementPolicy`).
    ``shards[i]`` is ``None`` for a dead or drained shard.
    """

    shards: Tuple[Optional[FleetDecision], ...]
    placements: Tuple[PlacementAction, ...] = ()

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def n_lanes(self) -> int:
        return sum(d.n_lanes for d in self.shards if d is not None)


@dataclasses.dataclass(frozen=True)
class FleetRowContext:
    """What a :class:`FleetRowPolicy` may condition on, beyond the per-lane
    spatial requests: the engine-side drift flags and the drift-weighted
    temporal shares the :class:`~repro_torch.core.allocation.FleetAllocator`
    computed for the same phase."""

    drifted: Tuple[bool, ...]
    weights: Tuple[float, ...]
    total_rows: int


class FleetRowPolicy:
    """Pluggable fleet-wide row policy: N per-lane spatial requests in, ONE
    fleet :class:`SpatialPlan` out.

    ``FleetRowPolicy("drift-surge", **kwargs)`` dispatches through the
    :data:`FLEET_ROW_POLICIES` registry (subclasses construct directly).
    Policies may be stateful across phases (hysteresis); :meth:`reset` is
    called once per fleet run.
    """

    name = "base"

    def __new__(cls, spec: Optional[str] = None, **kwargs):
        if cls is FleetRowPolicy:
            key = spec or "resolve-max"
            try:
                sub = FLEET_ROW_POLICIES[key]
            except KeyError:
                raise KeyError(
                    f"unknown fleet row policy {key!r}; "
                    f"known: {sorted(FLEET_ROW_POLICIES)}") from None
            return super().__new__(sub)
        return super().__new__(cls)

    def __init__(self, spec: Optional[str] = None, **kwargs):
        # ``spec`` is the registry key consumed by __new__. Unknown kwargs
        # are rejected: a misspelt tuning knob must not measure defaults.
        del spec
        if kwargs:
            raise TypeError(
                f"{type(self).__name__} got unexpected keyword "
                f"arguments: {sorted(kwargs)}")

    def reset(self, n_lanes: int) -> None:
        """Fresh per-run state (hysteresis counters etc.)."""

    def fleet_spatial(self, spatials: Sequence[SpatialPlan],
                      ctx: FleetRowContext) -> SpatialPlan:
        raise NotImplementedError

    @staticmethod
    def _resolve_max(spatials: Sequence[SpatialPlan]) -> SpatialPlan:
        """The most T-SA-hungry lane wins."""
        return dataclasses.replace(
            spatials[0],
            rows_tsa=max(s.rows_tsa for s in spatials),
            rows_bsa=min(s.rows_bsa for s in spatials))


class ResolveMaxRowPolicy(FleetRowPolicy):
    """``max`` of the T-SA requests, ``min`` of the B-SA ones."""

    name = "resolve-max"

    def fleet_spatial(self, spatials: Sequence[SpatialPlan],
                      ctx: FleetRowContext) -> SpatialPlan:
        return self._resolve_max(spatials)


class DriftSurgeRowPolicy(FleetRowPolicy):
    """Grow the fleet T-SA when many lanes drift *simultaneously*.

    When at least ``quorum`` of the lanes drift in one phase, ``surge_rows``
    rows move from the B-SA to the T-SA (never draining the B-SA below one
    row); the surge holds for ``hysteresis_phases`` phases — a fresh quorum
    re-arms the window — and the rows return when the window expires.
    ``surge_rows=None`` defaults to a quarter of the resolved B-SA rows (at
    least one). In the time-shared regime (resolved rows don't sum to the
    array) the policy is ``resolve-max``.
    """

    name = "drift-surge"

    def __init__(self, spec: Optional[str] = None, *,
                 surge_rows: Optional[int] = None,
                 quorum: float = 0.5,
                 hysteresis_phases: int = 2):
        super().__init__(spec)
        self.surge_rows = surge_rows
        self.quorum = quorum
        self.hysteresis_phases = hysteresis_phases
        self._hold = 0

    def reset(self, n_lanes: int) -> None:
        self._hold = 0

    def fleet_spatial(self, spatials: Sequence[SpatialPlan],
                      ctx: FleetRowContext) -> SpatialPlan:
        base = self._resolve_max(spatials)
        if base.rows_tsa + base.rows_bsa != ctx.total_rows:
            return base  # R=0 / time-shared regime: nothing to shift
        n = max(1, len(ctx.drifted))
        if sum(ctx.drifted) / n >= self.quorum:
            self._hold = self.hysteresis_phases  # (re-)arm the window
        elif self._hold > 0:
            self._hold -= 1
        if self._hold <= 0:
            return base
        avail = max(0, base.rows_bsa - 1)
        want = (max(1, base.rows_bsa // 4) if self.surge_rows is None
                else self.surge_rows)
        boost = min(want, avail)
        return dataclasses.replace(base, rows_tsa=base.rows_tsa + boost,
                                   rows_bsa=base.rows_bsa - boost)


class WeightedVoteRowPolicy(FleetRowPolicy):
    """Row shares follow the drift-weighted temporal shares.

    A *drifted* lane votes its ``rows_tsa`` plus ``drift_boost``, a
    *healthy* lane its ``rows_tsa`` minus ``healthy_relief``; the fleet
    T-SA is the vote averaged under the normalized drift-weighted shares
    the ``FleetAllocator`` used to split the temporal budget, clamped to
    keep at least one row on each side. ``drift_boost=None`` defaults to an
    eighth of the array, ``healthy_relief=None`` to a quarter of the base
    T-SA rows (0 pins the healthy-state split to ``resolve-max``).
    """

    name = "weighted-vote"

    def __init__(self, spec: Optional[str] = None, *,
                 drift_boost: Optional[int] = None,
                 healthy_relief: Optional[int] = None):
        super().__init__(spec)
        self.drift_boost = drift_boost
        self.healthy_relief = healthy_relief

    def fleet_spatial(self, spatials: Sequence[SpatialPlan],
                      ctx: FleetRowContext) -> SpatialPlan:
        base = self._resolve_max(spatials)
        if base.rows_tsa + base.rows_bsa != ctx.total_rows:
            return base  # time-shared regime
        boost = (max(1, ctx.total_rows // 8) if self.drift_boost is None
                 else self.drift_boost)
        relief = (max(1, base.rows_tsa // 4) if self.healthy_relief is None
                  else self.healthy_relief)
        votes = [(s.rows_tsa + boost) if d else (s.rows_tsa - relief)
                 for s, d in zip(spatials, ctx.drifted)]
        r_tsa = int(round(sum(w * v for w, v in zip(ctx.weights, votes))))
        r_tsa = max(1, min(ctx.total_rows - 1, r_tsa))
        return dataclasses.replace(base, rows_tsa=r_tsa,
                                   rows_bsa=ctx.total_rows - r_tsa)


FLEET_ROW_POLICIES: Dict[str, Type[FleetRowPolicy]] = {
    "resolve-max": ResolveMaxRowPolicy,
    "drift-surge": DriftSurgeRowPolicy,
    "weighted-vote": WeightedVoteRowPolicy,
}


def make_fleet_row_policy(policy, **kwargs) -> FleetRowPolicy:
    """Resolve a row policy from a registry name, class, or ready
    instance."""
    if isinstance(policy, FleetRowPolicy):
        return policy
    if isinstance(policy, str):
        return FleetRowPolicy(policy, **kwargs)
    return policy(**kwargs)
