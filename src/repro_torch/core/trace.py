"""Per-program execution tracing for the dispatch layer (trace spine), the
JAX package's ``core/trace.py`` ported.

Every phase the engine executes flows through a
:class:`~repro_torch.core.dispatch.PhasePlan`: device programs are
*dispatched* and bare virtual-time *charges* land on the role ledgers. A
:class:`TraceRecorder` attached to the
:class:`~repro_torch.core.dispatch.KernelDispatcher` observes exactly that
stream and records one :class:`TraceEvent` per device program (and per
bare charge), in issue order, per phase:

* the **virtual-clock cost** the program charged (and to which role),
* the **host wall time** its issue took (``time.perf_counter`` around the
  thunk). PyTorch issues CUDA work asynchronously, as JAX does, so this is
  issue latency on the host, not device time: the host-side cost the phase
  paid. Nothing synchronizes the card to make it look like device time;
* the **kernel path** that served it — the path of
  :func:`repro_torch.kernels.ops.kernel_stats` most incremented while the
  thunk ran: ``"cuda"`` (a hand-written kernel launched) or ``"plain"``
  (the plain PyTorch version, on a CPU tensor), where the reference
  records ``"pallas"``, ``"interpret"`` or ``"ref"``; ``""`` when no
  kernel of ``ops`` was called;
* the **unit count** the cost was computed from (frames scored, samples
  labeled, SGD batches) — what lets the replayer re-scale a recorded cost
  to a *candidate* decision's budgets.

Recording is strictly observational: no numeric state of the plan is
touched, so a traced run is bit-identical to an untraced one, and with no
recorder attached (the default) the dispatch layer takes its untraced code
path, with no clock read and no ``kernel_stats`` snapshot.

The recorded :class:`SessionTrace` is the input to
:class:`~repro_torch.core.replay.TraceReplayer` and round-trips to JSON
losslessly (``save``/``load``: floats survive bit-exactly via their repr).
The document is the reference's: a trace either package saves loads in the
other. ``lane``, ``fan`` and ``shard`` belong to the fleet and manager
tiers, which the port does not run yet; single-stream traces leave them at
their defaults.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

from repro_torch.kernels.ops import kernel_stats

TRACE_FORMAT = "dacapo-trace-v1"


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One dispatched device program (or bare ledger charge) of a phase.

    ``kind`` is ``"program"`` for ``dispatch`` issues (``wall_s``/``path``
    measured) and ``"charge"`` for bare ``charge`` calls (retraining SGD,
    profiling overhead, score windows). ``fan`` is the number of lanes the
    issuing device program served (> 1 only for a fleet's cross-stream
    program).
    """

    kind: str  # "program" | "charge"
    role: str  # "t_sa" | "b_sa"
    label: str  # dispatch label: "valid", "label", "score", "retrain", ...
    cost_s: float  # virtual-clock seconds charged
    lane: Optional[int] = None  # fleet stream lane (None: single-stream)
    wall_s: float = 0.0  # host wall seconds of the issue
    path: str = ""  # kernel_stats() path that served it ("" if none fired)
    units: float = 0.0  # quantity the cost scales with (samples/batches)
    fan: int = 1

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TraceEvent":
        return cls(**d)


@dataclasses.dataclass
class PhaseTrace:
    """One phase's recorded execution: ordered events + clock boundaries.

    ``start``/``end``/``floor`` are the plan's virtual-clock start, its
    ``finish()`` value and its pacing floor; replaying ``events`` through
    the same float-add sequence reconstructs ``end`` bit-exactly (the
    sequential SUM and the concurrent MAX both — see core/replay.py).
    ``decisions`` summarizes the two-plane decision(s) the phase executed;
    ``shard`` is stamped by the reference's manager tier.
    """

    index: int
    mode: str  # dispatch mode: "sequential" | "concurrent"
    start: float
    events: List[TraceEvent] = dataclasses.field(default_factory=list)
    end: float = 0.0
    floor: float = 0.0
    decisions: List[dict] = dataclasses.field(default_factory=list)
    shard: Optional[int] = None

    @property
    def duration(self) -> float:
        return self.end - self.start

    def as_dict(self) -> dict:
        return {"index": self.index, "mode": self.mode, "start": self.start,
                "end": self.end, "floor": self.floor, "shard": self.shard,
                "decisions": self.decisions,
                "events": [e.as_dict() for e in self.events]}

    @classmethod
    def from_dict(cls, d: dict) -> "PhaseTrace":
        return cls(index=d["index"], mode=d["mode"], start=d["start"],
                   end=d["end"], floor=d["floor"], shard=d.get("shard"),
                   decisions=list(d.get("decisions", [])),
                   events=[TraceEvent.from_dict(e) for e in d["events"]])


@dataclasses.dataclass
class SessionTrace:
    """A whole recorded run: the ordered phase traces + free-form meta."""

    phases: List[PhaseTrace] = dataclasses.field(default_factory=list)
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.phases)

    def events(self) -> List[TraceEvent]:
        """All events across phases, in phase/issue order."""
        return [e for ph in self.phases for e in ph.events]

    # ------------------------------------------------------------- JSON I/O
    def as_dict(self) -> dict:
        return {"format": TRACE_FORMAT, "meta": self.meta,
                "phases": [p.as_dict() for p in self.phases]}

    def to_json(self, **kwargs) -> str:
        return json.dumps(self.as_dict(), **kwargs)

    @classmethod
    def from_dict(cls, d: dict) -> "SessionTrace":
        if d.get("format") != TRACE_FORMAT:
            raise ValueError(
                f"not a {TRACE_FORMAT} document: format={d.get('format')!r}")
        return cls(phases=[PhaseTrace.from_dict(p) for p in d["phases"]],
                   meta=dict(d.get("meta", {})))

    @classmethod
    def from_json(cls, text: str) -> "SessionTrace":
        return cls.from_dict(json.loads(text))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json(indent=1))

    @classmethod
    def load(cls, path: str) -> "SessionTrace":
        with open(path) as f:
            return cls.from_json(f.read())


def summarize_decision(decision) -> dict:
    """The replayer-facing summary of one two-plane decision: the spatial
    rows (possibly ``None`` — the engine's offline split) and the temporal
    budgets every decision-dependent cost scales with."""
    if decision is None:
        return {}
    s, t = decision.spatial, decision.temporal
    return {"rows_tsa": s.rows_tsa, "rows_bsa": s.rows_bsa,
            "inference_precision": s.precisions.inference,
            "labeling_precision": s.precisions.labeling,
            "retrain_samples": t.retrain_samples,
            "valid_samples": t.valid_samples,
            "label_samples": t.label_samples,
            "extra_label_samples": t.extra_label_samples,
            "total_label_samples": t.total_label_samples,
            "reset_buffer": t.reset_buffer,
            "retrain_epochs": t.retrain_epochs,
            "pace_window_s": t.pace_window_s,
            "profile_cost_s": t.profile_cost_s}


def _path_totals() -> Dict[str, int]:
    """Aggregate :func:`kernel_stats` counters per serving path (``"cuda"``
    and ``"plain"`` in the port)."""
    totals: Dict[str, int] = {}
    for paths in kernel_stats().values():
        for path, n in paths.items():
            totals[path] = totals.get(path, 0) + n
    return totals


class TraceRecorder:
    """Collects :class:`PhaseTrace`s from the dispatch layer.

    Attach one to a session via ``CLSystemSpec(trace=True)`` (or hand a
    ready recorder instance to share it); the
    :class:`~repro_torch.core.dispatch.KernelDispatcher` opens one
    :class:`PhaseTrace` per ``begin_phase`` and the plan's traced overrides
    append events as programs issue. ``capture_paths=False`` skips the
    (locked) kernel-stats snapshots around each issue when only costs and
    wall times are wanted.
    """

    def __init__(self, capture_paths: bool = True,
                 meta: Optional[dict] = None):
        self.capture_paths = capture_paths
        self.phases: List[PhaseTrace] = []
        self.meta: Dict[str, object] = dict(meta or {})

    def __len__(self) -> int:
        return len(self.phases)

    @property
    def trace(self) -> SessionTrace:
        return SessionTrace(phases=self.phases, meta=self.meta)

    # ------------------------------------------------------------ recording
    def begin_phase(self, start: float, mode: str,
                    decisions: Sequence = ()) -> PhaseTrace:
        phase = PhaseTrace(
            index=len(self.phases), mode=mode, start=start,
            decisions=[summarize_decision(d) for d in decisions])
        self.phases.append(phase)
        return phase

    def paths_before(self) -> Optional[Dict[str, int]]:
        """Kernel-path snapshot before an issue (None when not captured)."""
        return _path_totals() if self.capture_paths else None

    @staticmethod
    def dominant_path(before: Optional[Dict[str, int]]) -> str:
        """The kernel path most incremented since ``before`` ('' if none)."""
        if before is None:
            return ""
        after = _path_totals()
        deltas = {p: n - before.get(p, 0) for p, n in after.items()
                  if n - before.get(p, 0) > 0}
        if not deltas:
            return ""
        return max(sorted(deltas), key=lambda p: deltas[p])

    # ----------------------------------------------------- manager merging
    def drain_since(self, cursor: int) -> List[PhaseTrace]:
        """Completed phases recorded after ``cursor`` — what a manager tier
        pulls at its round barrier, in shard-index order, to build one
        merged trace."""
        return self.phases[cursor:]
