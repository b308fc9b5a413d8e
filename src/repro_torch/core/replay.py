"""TraceReplayer — what-if phase-time prediction from recorded traces, the
JAX package's ``core/replay.py`` ported.

The trace spine (core/trace.py) records each phase as the ordered stream
of program/charge :class:`~repro_torch.core.trace.TraceEvent`s the
:class:`~repro_torch.core.dispatch.PhasePlan` executed, plus the phase's
clock boundaries. Because the plan's virtual clock is nothing but two
per-role float accumulators walked in issue order, replaying the same
float-add sequence reconstructs every phase end **bit-exactly** — in both
dispatch semantics (sequential SUM of the T-SA chain; concurrent
``max(t_TSA, t_BSA)``, both floored by pacing). On top of that the
replayer answers *what-if* questions without executing anything:

* :meth:`TraceReplayer.predict` re-prices the decision-dependent events of
  a phase under a **candidate** :class:`~repro_torch.core.decision.Decision`
  — sample budgets re-scale each event by its recorded unit cost
  (``cost_s / units``), row/precision changes re-scale by the estimator's
  time ratios, profiling overhead is replaced outright — and replays the
  re-priced stream through the same clock arithmetic;
* ``from_units=True`` prices events from the trace-wide per-label unit
  costs (:meth:`TraceReplayer.unit_costs`) instead of their recorded costs;
* ``mode=`` replays a trace under the *other* dispatch semantics;
* :meth:`TraceReplayer.calibrate` fits per-label scale factors — the
  Σwall/Σcost ratio of measured host wall time to modeled virtual cost —
  and hands back a :class:`Calibration` that wraps the cycle model in a
  :class:`~repro_torch.core.estimator.CalibratedEstimator` and corrects a
  :class:`~repro_torch.core.estimator.PlacementCostModel`'s seconds.

Replay is host float arithmetic over the recorded events only, the
reference's operation for operation: a trace gives the same floats in
either package. The ``"dacapo-replay"`` allocation policy
(core/allocation.py) drives :meth:`predict` as its scoring oracle.

Not ported yet: candidates that are a fleet's ``FleetDecision`` (ROADMAP
Queue 1, item 8); :meth:`TraceReplayer.predict` raises on one.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.decision import as_decision
from repro_torch.core.estimator import CalibratedEstimator, PlacementCostModel
from repro_torch.core.trace import SessionTrace, TraceEvent, summarize_decision

# Labels whose cost scales with a temporal-plane budget; maps each to the
# candidate-summary key holding the new unit count.
_BUDGET_KEYS = {
    "retrain": None,  # batches — derived from hp (see _candidate_units)
    "label": "total_label_samples",
    "acc_label": "total_label_samples",
    "valid": "valid_samples",
}
# Forward-pass program labels (one model forward per unit).
_FORWARD_LABELS = ("valid", "label", "acc_label", "score")


@dataclasses.dataclass(frozen=True)
class ReplayNode:
    """One node of a phase's dependency DAG: an event + what it waits on.

    ``deps`` holds node ids (indices into the phase's node list); an empty
    tuple means the node starts at the phase start. The phase-end barrier
    joins the chain tails (``"tails"`` in :meth:`TraceReplayer.dag`).
    """

    id: int
    event: TraceEvent
    deps: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Per-kernel scale factors fitted from a trace's measured wall times.

    ``scales[label]`` is Σwall/Σcost over that label's events — how many
    host wall seconds one modeled virtual second actually took;
    ``global_scale`` is the same ratio over every measured event. Use
    :meth:`seconds` to correct a modeled cost, :meth:`estimator` to wrap
    the cycle model, :meth:`placement_model` to correct placement
    economics.
    """

    scales: Dict[str, float]
    global_scale: float = 1.0

    def seconds(self, label: str, cost_s: float) -> float:
        """Corrected (wall-calibrated) seconds for a modeled cost."""
        return cost_s * self.scales.get(label, self.global_scale)

    def estimator(self, base=None) -> CalibratedEstimator:
        """The cycle model wrapped with the fitted forward/train scales
        (forward: pooled over the forward-pass program labels; train:
        the ``"retrain"`` scale; missing fits fall back to global)."""
        fwd = [self.scales[lb] for lb in _FORWARD_LABELS
               if lb in self.scales]
        return CalibratedEstimator(
            base=base if base is not None else CalibratedEstimator().base,
            forward_scale=(sum(fwd) / len(fwd) if fwd else self.global_scale),
            train_scale=self.scales.get("retrain", self.global_scale))

    def placement_model(self, model: PlacementCostModel
                        ) -> PlacementCostModel:
        """``model`` with its migration cost re-expressed in calibrated
        seconds."""
        return dataclasses.replace(
            model,
            migration_cost_s=model.migration_cost_s * self.global_scale)


class TraceReplayer:
    """Replays a recorded :class:`~repro_torch.core.trace.SessionTrace`.

    ``estimator``/``student``/``teacher``/``hp`` are optional context for
    candidate re-pricing: the estimator + model configs enable
    row/precision re-scaling of program costs, ``hp`` (a
    :class:`~repro_torch.core.allocation.CLHyperParams`) enables deriving a
    candidate's retrain batch count from its sample budget. Without them
    :meth:`predict` still re-prices by unit ratios alone.
    """

    def __init__(self, trace: SessionTrace, estimator=None, student=None,
                 teacher=None, hp=None):
        self.trace = trace
        self.estimator = estimator
        self.student = student
        self.teacher = teacher
        self.hp = hp

    def __len__(self) -> int:
        return len(self.trace.phases)

    # ----------------------------------------------------------------- DAG
    def dag(self, index: int) -> Dict[str, object]:
        """The phase's per-role dependency DAG.

        Sequential dispatch is one serial chain (every event waits on the
        previous). Concurrent dispatch is two serial chains — the T-SA
        chain and the B-SA chain, each rooted at the phase start — joined
        by the phase-end barrier. Returns
        ``{"nodes": [ReplayNode...], "tails": [ids the end joins]}``.
        """
        phase = self.trace.phases[index]
        nodes: List[ReplayNode] = []
        if phase.mode == "sequential":
            for i, e in enumerate(phase.events):
                nodes.append(ReplayNode(
                    id=i, event=e, deps=(i - 1,) if i else ()))
            tails = [len(nodes) - 1] if nodes else []
            return {"nodes": nodes, "tails": tails}
        last: Dict[str, int] = {}
        for i, e in enumerate(phase.events):
            deps = (last[e.role],) if e.role in last else ()
            nodes.append(ReplayNode(id=i, event=e, deps=deps))
            last[e.role] = i
        return {"nodes": nodes, "tails": sorted(last.values())}

    # --------------------------------------------------------- exact replay
    def phase_time(self, index: int) -> float:
        """The phase's end clock, reconstructed bit-exactly by replaying
        the recorded event stream through the plan's own float-add
        sequence (see :meth:`predict` with no candidate)."""
        return self.predict(index)

    def durations(self) -> List[float]:
        """Replayed duration (end - start) of every phase."""
        return [self.phase_time(i) - p.start
                for i, p in enumerate(self.trace.phases)]

    # ----------------------------------------------------------- prediction
    def unit_costs(self) -> Dict[str, float]:
        """Trace-wide per-label cost histograms collapsed to unit costs:
        Σcost/Σunits over every event carrying a unit count — the virtual
        seconds one frame/sample/batch of each kernel costs."""
        cost: Dict[str, float] = {}
        units: Dict[str, float] = {}
        for e in self.trace.events():
            if e.units > 0:
                cost[e.label] = cost.get(e.label, 0.0) + e.cost_s
                units[e.label] = units.get(e.label, 0.0) + e.units
        return {lb: cost[lb] / units[lb] for lb in cost if units[lb] > 0}

    def predict(self, index: int, decision=None, mode: Optional[str] = None,
                from_units: bool = False) -> float:
        """Predicted end clock of phase ``index``.

        With every argument at its default this is the exact replay —
        bitwise equal to the recorded ``end``. ``decision`` re-prices the
        decision-dependent events under a candidate
        :class:`~repro_torch.core.decision.Decision` (or flat
        ``AllocationDecision``); ``mode`` replays under the other dispatch
        semantics; ``from_units`` prices unit-carrying events from the
        trace-wide histograms instead of their recorded costs.
        """
        phase = self.trace.phases[index]
        cands = self._candidate_summaries(decision)
        unit = self.unit_costs() if (from_units or cands) else {}
        now = phase.start
        b_sa = 0.0
        for e in phase.events:
            cost = self._event_cost(e, phase, cands, unit, from_units)
            if e.role == "t_sa":
                now += cost
            else:
                b_sa += cost
        end = now
        if (mode or phase.mode) == "concurrent":
            end = max(end, phase.start + b_sa)
        return max(end, phase.floor)

    def predict_duration(self, index: int, decision=None,
                         mode: Optional[str] = None,
                         from_units: bool = False) -> float:
        return (self.predict(index, decision, mode, from_units)
                - self.trace.phases[index].start)

    # ------------------------------------------------------------ repricing
    def _candidate_summaries(self, decision) -> Dict[object, dict]:
        """Candidate decision(s) keyed by lane (``None`` = any lane)."""
        if decision is None:
            return {}
        if hasattr(decision, "per_lane"):
            raise NotImplementedError(
                "replaying a fleet's FleetDecision is not ported yet: "
                "ROADMAP Queue 1, item 8 (core/fleet.py)")
        summary = summarize_decision(as_decision(decision))
        return {None: summary, 0: summary}

    def _candidate_units(self, e: TraceEvent, cand: dict) -> Optional[float]:
        """The candidate's unit count for a budget-scaled event (None:
        the event does not scale with a temporal budget)."""
        if e.label not in _BUDGET_KEYS:
            return None
        if e.label == "retrain":
            if self.hp is None:
                return None  # can't derive a batch count
            epochs = cand.get("retrain_epochs") or self.hp.epochs
            return float(epochs
                         * (cand["retrain_samples"] // self.hp.sgd_batch))
        return float(cand[_BUDGET_KEYS[e.label]])

    def _model_ratio(self, e: TraceEvent, old: dict, cand: dict) -> float:
        """Cost ratio for a candidate's row/precision change, from the
        estimator's time model (1.0 when nothing changed or context is
        missing)."""
        if self.estimator is None or not old:
            return 1.0
        rows_key = "rows_tsa" if e.role == "t_sa" else "rows_bsa"
        prec_key = ("labeling_precision" if e.label == "label"
                    else "inference_precision")
        old_rows, new_rows = old.get(rows_key), cand.get(rows_key)
        old_prec, new_prec = old.get(prec_key), cand.get(prec_key)
        if (old_rows, old_prec) == (new_rows, new_prec):
            return 1.0
        if not old_rows or not new_rows or not old_prec or not new_prec:
            return 1.0  # unresolved rows: the offline split, unchanged
        cfg = self.teacher if e.label == "label" else self.student
        if cfg is None:
            return 1.0
        if e.label == "retrain":
            batch = self.hp.sgd_batch if self.hp is not None else 32
            t_old = self.estimator.train_step_time(cfg, old_rows, old_prec,
                                                   batch)
            t_new = self.estimator.train_step_time(cfg, new_rows, new_prec,
                                                   batch)
        else:
            t_old = self.estimator.forward_time(cfg, old_rows, old_prec)
            t_new = self.estimator.forward_time(cfg, new_rows, new_prec)
        return t_new / t_old if t_old > 0 else 1.0

    def _event_cost(self, e: TraceEvent, phase, cands: Dict[object, dict],
                    unit: Dict[str, float], from_units: bool) -> float:
        cost = e.cost_s
        if from_units and e.units > 0 and e.label in unit:
            cost = unit[e.label] * e.units
        if not cands:
            return cost
        cand = cands.get(e.lane if e.lane is not None else None,
                         cands.get(None))
        if cand is None:
            return cost
        if e.label == "profile":
            return float(cand.get("profile_cost_s") or 0.0)
        new_units = self._candidate_units(e, cand)
        if new_units is not None:
            if e.units > 0:
                cost = cost * (new_units / e.units)
            elif e.label in unit:
                cost = unit[e.label] * new_units
        old = {}
        if phase.decisions:
            lane = e.lane if e.lane is not None else 0
            if lane < len(phase.decisions):
                old = phase.decisions[lane]
        return cost * self._model_ratio(e, old, cand)

    # ---------------------------------------------------------- calibration
    def calibrate(self) -> Calibration:
        """Fit per-kernel wall/cost scale factors from the trace's
        measured wall times (program issue walls; the retrain charge's
        measured ``fit`` wall). Labels with no measured wall or no modeled
        cost are left to the global scale."""
        wall: Dict[str, float] = {}
        cost: Dict[str, float] = {}
        for e in self.trace.events():
            if e.wall_s > 0 and e.cost_s > 0:
                wall[e.label] = wall.get(e.label, 0.0) + e.wall_s
                cost[e.label] = cost.get(e.label, 0.0) + e.cost_s
        scales = {lb: wall[lb] / cost[lb] for lb in wall if cost[lb] > 0}
        total_wall = sum(wall.values())
        total_cost = sum(cost[lb] for lb in wall)
        return Calibration(
            scales=scales,
            global_scale=(total_wall / total_cost if total_cost > 0
                          else 1.0))
