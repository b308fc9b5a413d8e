"""The port's trace spine and replay on its own sessions (plain PyTorch,
CPU): the JAX package's ``tests/test_trace.py`` cases ported — tracing off
by default, traced runs bit-identical to untraced ones in both dispatch
modes, every phase end replayed bit for bit (also after a JSON round
trip), the from-units prediction, the cross-mode what-if, the per-role
DAG, the JSON format check, the event round trip, kernel-path capture,
calibration, and the ``"dacapo-replay"`` policy — plus what only the port
has: the paths a traced MX6 session records, and an untraced plan that
reads no clock and takes no ``kernel_stats`` snapshot.

The fixture is the reference's trace fixture: ``scenario("S1", 2)``, seed
5, 24 px, ``CLHyperParams(n_t=32, n_l=16, c_b=128)``, 30 s, teacher and
student pretrained by the JAX package 10 and 8 steps and carried across
(``_torch_sessions.jax_pretrained``). The comparisons with the reference's
own traces are in ``tests/test_torch_replay.py``.
"""
import numpy as np
import pytest
import torch

from _torch_sessions import (jax_pretrained, one_torch_thread,  # noqa: F401
                             port_session, port_stream)
from repro_torch.configs.dacapo_pairs import RESNET18, WIDERESNET50
from repro_torch.core import dispatch as dispatch_mod
from repro_torch.core import session as session_mod
from repro_torch.core import trace as trace_mod
from repro_torch.core.allocation import (ALLOCATORS, CLHyperParams,
                                         ReplayAllocator)
from repro_torch.core.estimator import CalibratedEstimator, DaCapoEstimator
from repro_torch.core.replay import TraceReplayer
from repro_torch.core.session import CLSystemSpec
from repro_torch.core.trace import SessionTrace, TraceEvent, TraceRecorder
from repro_torch.kernels import ops
from repro_torch.tree import tree_leaves

HP = dict(n_t=32, n_l=16, c_b=128, epochs=1)
MODES = ("sequential", "concurrent")


@pytest.fixture(scope="module")
def golden():
    return jax_pretrained(2, 10, 8)


def _run(golden, dispatch, trace, allocator="dacapo-spatiotemporal",
         duration=30.0, eval_fps=0.5, apply_mx=False):
    session = port_session(golden, HP, allocator=allocator,
                           apply_mx=apply_mx, eval_fps=eval_fps,
                           dispatch=dispatch, trace=trace)
    res = session.run(port_stream(golden), duration=duration)
    return res, session.dispatcher.recorder, session


@pytest.fixture(scope="module")
def traced_runs(golden):
    """One traced + one untraced run per dispatch mode."""
    return {(mode, traced): _run(golden, mode, True if traced else None)
            for mode in MODES for traced in (False, True)}


# ------------------------------------------------------------- off-switch
def test_trace_off_by_default(traced_runs):
    """trace=None leaves the dispatcher recorder-free."""
    for mode in MODES:
        _, recorder, session = traced_runs[mode, False]
        assert recorder is None
        assert session.allocator._trace_recorder is None


def test_trace_spec_forms(golden):
    """True makes a fresh recorder, a ready recorder is shared as it is
    (also with the policy), False is off."""
    shared = TraceRecorder()
    a = port_session(golden, HP, trace=shared)
    b = port_session(golden, HP, trace=True)
    c = port_session(golden, HP, trace=False)
    assert a.dispatcher.recorder is shared
    assert a.allocator._trace_recorder is shared
    assert isinstance(b.dispatcher.recorder, TraceRecorder)
    assert b.dispatcher.recorder is not shared
    assert c.dispatcher.recorder is None


@pytest.mark.parametrize("mode", MODES)
def test_traced_run_bit_identical(traced_runs, mode):
    """Recording is observation-only: accuracy, ledgers, the phase log,
    the timeline and the student's weights are bitwise identical with
    tracing on and off."""
    r_off, _, s_off = traced_runs[mode, False]
    r_on, recorder, s_on = traced_runs[mode, True]
    assert recorder is not None and len(recorder) >= len(r_on.phase_log) > 0
    assert r_off.avg_accuracy == r_on.avg_accuracy
    assert r_off.retrain_time == r_on.retrain_time
    assert r_off.label_time == r_on.label_time
    assert r_off.phase_log == r_on.phase_log
    assert r_off.accuracy_timeline == r_on.accuracy_timeline
    on = tree_leaves(s_on.student_params)
    for i, p in enumerate(tree_leaves(s_off.student_params)):
        assert torch.equal(p, on[i]), i


# ----------------------------------------------------------- exact replay
@pytest.mark.parametrize("mode", MODES)
def test_replay_bitwise_exact(traced_runs, mode):
    """predict() with no candidate reconstructs every phase-end clock
    bit-for-bit in both dispatch semantics — also after a JSON round
    trip, which gives an equal trace."""
    res, recorder, _ = traced_runs[mode, True]
    trace = recorder.trace
    rep = TraceReplayer(trace)
    for i, ph in enumerate(trace.phases):
        assert rep.phase_time(i) == ph.end
        assert ph.mode == mode
    # A phase that reaches the end of the run records no PhaseRecord.
    assert 0 <= len(trace.phases) - len(res.phase_log) <= 1
    for ph, log in zip(trace.phases, res.phase_log):
        assert ph.end == log["t"]
    again = SessionTrace.from_json(trace.to_json())
    assert again.as_dict() == trace.as_dict()
    rep2 = TraceReplayer(again)
    for i, ph in enumerate(trace.phases):
        assert rep2.phase_time(i) == ph.end


def test_replay_from_units_within_mape(traced_runs):
    """Histogram-priced (from_units) predictions stay within 5% MAPE of
    the recorded concurrent phase times."""
    _, recorder, _ = traced_runs["concurrent", True]
    trace = recorder.trace
    rep = TraceReplayer(trace)
    errs = [abs(rep.predict(i, from_units=True) - ph.end) / ph.end
            for i, ph in enumerate(trace.phases) if ph.end > 0]
    assert errs
    assert 100.0 * sum(errs) / len(errs) < 5.0


def test_replay_cross_mode_what_if(traced_runs):
    """Replaying the sequential trace under mode="concurrent" predicts the
    concurrent run's first phase end, and never predicts less than the
    recorded sequential end for any phase."""
    _, rec_seq, _ = traced_runs["sequential", True]
    _, rec_con, _ = traced_runs["concurrent", True]
    rep = TraceReplayer(rec_seq.trace)
    assert rep.predict(0, mode="concurrent") == pytest.approx(
        rec_con.phases[0].end, rel=1e-6)
    for i, ph in enumerate(rec_seq.phases):
        assert rep.predict(i, mode="concurrent") >= ph.end


def test_replay_dag_structure(traced_runs):
    """Sequential: one serial chain. Concurrent: per-role chains joined
    at the phase-end barrier."""
    _, rec_seq, _ = traced_runs["sequential", True]
    d = TraceReplayer(rec_seq.trace).dag(0)
    events = rec_seq.phases[0].events
    assert len(d["nodes"]) == len(events)
    for node in d["nodes"][1:]:
        assert node.deps == (node.id - 1,)
    assert d["tails"] == [len(events) - 1]

    _, rec_con, _ = traced_runs["concurrent", True]
    d = TraceReplayer(rec_con.trace).dag(0)
    roles = {e.role for e in rec_con.phases[0].events}
    assert len(d["tails"]) == len(roles)
    for node in d["nodes"]:
        for dep in node.deps:
            assert d["nodes"][dep].event.role == node.event.role


def test_events_annotated(traced_runs):
    """Every charge and program carries the reference's label, and the
    units its cost was computed from; the retrain charge carries the
    measured fit wall."""
    _, recorder, _ = traced_runs["concurrent", True]
    events = recorder.trace.events()
    labels = {(e.kind, e.label) for e in events}
    assert labels == {("charge", "score"), ("charge", "retrain"),
                      ("program", "valid"), ("program", "label"),
                      ("program", "acc_label")}
    for e in events:
        assert e.lane is None and e.fan == 1
        if e.label == "retrain":  # SGD batches: fewer than n_t / sgd_batch
            # when the buffer holds fewer samples, none when too few
            assert e.units in (0, 1, 2) and e.wall_s > 0
            assert (e.cost_s > 0) == (e.units > 0)
            continue
        assert e.units > 0 and e.cost_s > 0
        assert (e.wall_s > 0) == (e.kind == "program")


# ------------------------------------------------------------ trace model
def test_trace_json_rejects_wrong_format():
    with pytest.raises(ValueError):
        SessionTrace.from_dict({"format": "not-a-trace", "phases": []})


def test_trace_event_round_trip():
    e = TraceEvent(kind="program", role="t_sa", label="valid", cost_s=0.25,
                   lane=3, wall_s=0.01, path="cuda", units=48.0, fan=2)
    assert TraceEvent.from_dict(e.as_dict()) == e


def test_dominant_path_capture():
    """paths_before/dominant_path bracket an issue: the kernel path whose
    counter moved is recorded — the plain version for a CPU tensor."""
    rec = TraceRecorder()
    before = rec.paths_before()
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(8, 32)).astype(np.float32))
    ops.mx_quantize(x, "mx6")
    assert rec.dominant_path(before) == "plain"
    # No movement -> empty path; capture_paths=False -> no snapshots.
    assert rec.dominant_path(rec.paths_before()) == ""
    assert TraceRecorder(capture_paths=False).paths_before() is None


def test_mx6_session_paths(golden):
    """Where a traced MX6 session's kernel calls land: the teacher's
    serving copy is filled inside the first labeling program (the plain
    quantize and dequantize on the CPU), the student's outside any
    program (UpdateWeight before the validation program), and ResNet
    forwards call no kernel of ``ops`` — so exactly the first ``label``
    program has a path."""
    _, recorder, session = _run(golden, "sequential", True, duration=8.0,
                                apply_mx=True)
    programs = [(i, e) for i, ph in enumerate(recorder.phases)
                for e in ph.events if e.kind == "program"]
    assert session.labeling.serving_cache.fills == 1
    assert session.inference.serving_cache.fills >= 2
    first_label = next(i for i, (_, e) in enumerate(programs)
                       if e.label == "label")
    for k, (_, e) in enumerate(programs):
        assert e.path == ("plain" if k == first_label else ""), (k, e)
    assert all(e.path == "" for e in recorder.trace.events()
               if e.kind == "charge")


def test_untraced_plan_reads_no_clock(golden, monkeypatch):
    """With no recorder, neither the dispatch layer nor the session reads
    the host clock, and no kernel_stats snapshot is taken."""
    class NoClock:
        @staticmethod
        def perf_counter():
            raise AssertionError("untraced path read the clock")

    def no_snapshot():
        raise AssertionError("untraced path took a kernel_stats snapshot")

    session = port_session(golden, HP, apply_mx=True)
    monkeypatch.setattr(dispatch_mod, "time", NoClock)
    monkeypatch.setattr(session_mod, "time", NoClock)
    monkeypatch.setattr(trace_mod, "_path_totals", no_snapshot)
    res = session.run(port_stream(golden), duration=8.0)
    assert len(res.phase_log) > 0
    assert any(r.retrain_time > 0 for r in res.records)
    plan = dispatch_mod.KernelDispatcher("concurrent").begin_phase(0.0)
    assert not plan.traced
    plan.dispatch("b_sa", "valid", lambda: torch.zeros(2), cost_s=0.5,
                  units=2)
    plan.charge("t_sa", 0.25, label="retrain", units=1, wall_s=0.1)
    assert plan.finish() == 0.5


# ------------------------------------------------------------- calibration
def test_calibrate_scales_estimator(traced_runs):
    _, recorder, _ = traced_runs["concurrent", True]
    cal = TraceReplayer(recorder.trace).calibrate()
    assert "retrain" in cal.scales and cal.scales["retrain"] > 0
    assert "score" not in cal.scales  # score charges carry no wall
    assert cal.global_scale > 0
    assert cal.seconds("retrain", 2.0) == 2.0 * cal.scales["retrain"]
    est = cal.estimator(DaCapoEstimator())
    assert isinstance(est, CalibratedEstimator)
    base = DaCapoEstimator()
    cfg = RESNET18.reduced()
    assert est.forward_time(cfg, 8, "mx9") == pytest.approx(
        est.forward_scale * base.forward_time(cfg, 8, "mx9"))
    assert est.train_step_time(cfg, 8, "mx9", 16) == pytest.approx(
        est.train_scale * base.train_step_time(cfg, 8, "mx9", 16))
    assert est.total_rows == base.total_rows


# ----------------------------------------------------- replay-scored policy
def test_replay_allocator_registered():
    assert ALLOCATORS["dacapo-replay"] is ReplayAllocator
    assert ReplayAllocator.needs_trace
    session = CLSystemSpec(student=RESNET18, teacher=WIDERESNET50,
                           allocator="dacapo-replay",
                           hp=CLHyperParams(**HP), device="cpu").build()
    assert isinstance(session.allocator, ReplayAllocator)
    assert session.allocator._trace_recorder is session.dispatcher.recorder
    assert isinstance(session.dispatcher.recorder, TraceRecorder)


def test_replay_allocator_runs_and_charges_profile(golden):
    """dacapo-replay creates its recorder, scores candidates by replay,
    charges the measured replay wall to profile_cost_s, and its phases
    still replay bit for bit (the profile charge is on the trace)."""
    res, recorder, _ = _run(golden, "concurrent", None,
                            allocator="dacapo-replay", eval_fps=2.0)
    assert recorder is not None  # needs_trace flipped the default on
    assert len(recorder) >= len(res.phase_log) > 0
    costs = [ph.decisions[0].get("profile_cost_s")
             for ph in recorder.phases if ph.decisions]
    assert any(c and c > 0 for c in costs[1:])
    rep = TraceReplayer(recorder.trace)
    for i, ph in enumerate(recorder.phases):
        assert rep.phase_time(i) == ph.end
        charged = [e.cost_s for e in ph.events if e.label == "profile"]
        want = ph.decisions[0]["profile_cost_s"]
        assert charged == ([want] if want else [])
    assert res.avg_accuracy >= 0.0
    picks = {r.decision.retrain_samples for r in res.records}
    assert picks <= {HP["n_t"], 48, 64, 96}
