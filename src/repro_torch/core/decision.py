"""The two-plane decision API for a single stream: SpatialPlan /
TemporalPlan / Decision (the single-stream half of the JAX package's
``core/decision.py``; the fleet and manager types are not ported yet).

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
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.mx import DEFAULT_POLICY, PrecisionPolicy

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
