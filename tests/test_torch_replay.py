"""The port's trace spine and replay held to the JAX package's, run live on
this host (CPU): a traced port session matches a traced reference session
event for event; a trace the JAX package saves loads in the port and one
the port saves loads in the JAX package; on a JAX-saved trace the port's
``TraceReplayer`` gives the reference's durations, predictions (candidate
budgets, rows and precisions, the other dispatch mode, from units), unit
costs, DAG and calibration bit for bit, and its ``ReplayAllocator`` picks
the reference's decision; ``CalibratedEstimator`` and
``PlacementCostModel`` agree float for float.

Fixture: the reference's trace fixture (``tests/test_trace.py``):
``scenario("S1", 2)``, seed 5, 24 px, ``CLHyperParams(n_t=32, n_l=16,
c_b=128)``, 30 s, ``apply_mx=False``, teacher and student pretrained by
the JAX package 10 and 8 steps and carried across. It ends before the two
packages' accuracies part (ROADMAP Queue 3, item 2), so the two traces
hold the same events. Tolerances: kind, role, label, units and the phase
decisions exactly; ``cost_s`` and phase boundaries within 1e-6, the ledger
tolerance of ``_torch_sessions.assert_parity``. ``wall_s`` (host time) and
``path`` (the reference serves these sessions through no kernel of its
``ops``; the port records ``"plain"`` or ``"cuda"``) are left out.
"""
import dataclasses

import numpy as np
import pytest

from _torch_sessions import (jax_pretrained, one_torch_thread,  # noqa: F401
                             port_stream, session_pair)
from repro.configs import dacapo_pairs as jcfg
from repro.core import allocation as jalloc
from repro.core import estimator as jest
from repro.core import replay as jreplay
from repro.core import trace as jtrace
from repro_torch.configs import dacapo_pairs as tcfg
from repro_torch.core import allocation as talloc
from repro_torch.core import estimator as test_
from repro_torch.core import replay as treplay
from repro_torch.core import trace as ttrace

HP = dict(n_t=32, n_l=16, c_b=128, epochs=1)
MODES = ("sequential", "concurrent")
TOL = 1e-6


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """Per dispatch mode: the reference's traced run, saved by the JAX
    package to a file, and the port's traced run of the same description."""
    golden = jax_pretrained(2, 10, 8)
    out = {}
    for mode in MODES:
        ref, port = session_pair(golden, HP, apply_mx=False, dispatch=mode,
                                 trace=True)
        ref.run(golden[0], duration=30.0)
        port.run(port_stream(golden), duration=30.0)
        path = tmp_path_factory.mktemp("trace") / f"{mode}.json"
        ref.dispatcher.recorder.trace.save(str(path))
        out[mode] = (ref.dispatcher.recorder.trace, path,
                     port.dispatcher.recorder.trace)
    return out


def _virtual(e) -> dict:
    d = e.as_dict()
    del d["wall_s"], d["path"]
    return d


@pytest.mark.parametrize("mode", MODES)
def test_port_session_matches_reference_event_for_event(traces, mode):
    want, _, got = traces[mode]
    assert len(got.phases) == len(want.phases) > 0
    for g, w in zip(got.phases, want.phases):
        assert (g.index, g.mode, g.shard) == (w.index, w.mode, w.shard)
        assert g.decisions == w.decisions
        for key in ("start", "end", "floor"):
            assert abs(getattr(g, key) - getattr(w, key)) < TOL, key
        assert len(g.events) == len(w.events) > 0
        for eg, ew in zip(g.events, w.events):
            dg, dw = _virtual(eg), _virtual(ew)
            assert abs(dg.pop("cost_s") - dw.pop("cost_s")) < TOL
            assert dg == dw
        assert all(e.path == "" for e in w.events)


@pytest.mark.parametrize("mode", MODES)
def test_traces_load_across_packages(traces, mode, tmp_path):
    """A JAX-saved file loads in the port as the same document (floats bit
    for bit), and the port's save loads back in the JAX package."""
    want, path, port_trace = traces[mode]
    got = ttrace.SessionTrace.load(str(path))
    assert got.as_dict() == want.as_dict()
    assert [e.as_dict() for e in got.events()] == [
        e.as_dict() for e in want.events()]
    back = tmp_path / "port.json"
    got.save(str(back))
    assert jtrace.SessionTrace.load(str(back)).as_dict() == want.as_dict()
    assert back.read_text() == path.read_text()
    port_path = tmp_path / "port_session.json"
    port_trace.save(str(port_path))
    assert jtrace.SessionTrace.load(str(port_path)).as_dict() == \
        port_trace.as_dict()


def _replayers(path, context: bool):
    """The JAX package's and the port's replayer on the JAX-saved file,
    with the estimator, configs and hyper-parameters where ``context``."""
    jt = jtrace.SessionTrace.load(str(path))
    tt = ttrace.SessionTrace.load(str(path))
    if not context:
        return jreplay.TraceReplayer(jt), treplay.TraceReplayer(tt)
    return (jreplay.TraceReplayer(jt, jest.DaCapoEstimator(),
                                  jcfg.RESNET18, jcfg.WIDERESNET50,
                                  jalloc.CLHyperParams(**HP)),
            treplay.TraceReplayer(tt, test_.DaCapoEstimator(),
                                  tcfg.RESNET18, tcfg.WIDERESNET50,
                                  talloc.CLHyperParams(**HP)))


def _candidates(pkg):
    """Candidate decisions: other budgets, a drift boost, other rows and
    precisions, a profiling cost, another epoch count."""
    from_alloc = pkg.AllocationDecision
    base = dict(retrain_samples=32, valid_samples=8, label_samples=16)
    out = [from_alloc(**base)]
    for n in (16, 48, 64, 96, 128):
        out.append(from_alloc(**{**base, "retrain_samples": n}))
    out.append(from_alloc(**base, reset_buffer=True, extra_label_samples=48))
    out.append(from_alloc(**base, rows_tsa=12, rows_bsa=4))
    out.append(from_alloc(**base, rows_tsa=4, rows_bsa=12,
                          retrain_epochs=2, profile_cost_s=0.125))
    out.append(from_alloc(**base, rows_tsa=10, rows_bsa=6,
                          precisions=dataclasses.replace(
                              pkg.DEFAULT_POLICY, inference="mx4",
                              labeling="mx9")))
    return out


@pytest.mark.parametrize("mode", MODES)
def test_replay_matches_reference_bitwise(traces, mode):
    _, path, _ = traces[mode]
    for context in (False, True):
        jr, tr = _replayers(path, context)
        assert len(tr) == len(jr) > 0
        assert tr.durations() == jr.durations()
        assert tr.unit_costs() == jr.unit_costs()
        jc, tc = jr.calibrate(), tr.calibrate()
        assert tc.scales == jc.scales and tc.global_scale == jc.global_scale
        cands = list(zip(_candidates(jalloc), _candidates(talloc)))
        for i in range(len(jr)):
            assert tr.phase_time(i) == jr.phase_time(i)
            assert tr.phase_time(i) == tr.trace.phases[i].end
            for other in MODES:
                assert tr.predict(i, mode=other) == jr.predict(i, mode=other)
            assert tr.predict(i, from_units=True) == jr.predict(
                i, from_units=True)
            for jd, td in cands:
                assert tr.predict(i, td) == jr.predict(i, jd), (i, td)
                assert tr.predict(i, td.split(), from_units=True) == \
                    jr.predict(i, jd.split(), from_units=True)
                assert tr.predict_duration(i, td) == jr.predict_duration(
                    i, jd)
            jd, td = jr.dag(i), tr.dag(i)
            assert td["tails"] == jd["tails"]
            assert [(n.id, n.deps, n.event.as_dict()) for n in td["nodes"]] \
                == [(n.id, n.deps, n.event.as_dict()) for n in jd["nodes"]]


@pytest.mark.parametrize("mode", MODES)
def test_calibration_wrappers_match_reference(traces, mode):
    _, path, _ = traces[mode]
    jr, tr = _replayers(path, False)
    jc, tc = jr.calibrate(), tr.calibrate()
    je, te = jc.estimator(jest.DaCapoEstimator()), tc.estimator(
        test_.DaCapoEstimator())
    assert (te.forward_scale, te.train_scale) == (je.forward_scale,
                                                  je.train_scale)
    assert tc.estimator().forward_scale == jc.estimator().forward_scale
    for name, cfg in tcfg.VISION_MODELS.items():
        jcfg_ = jcfg.VISION_MODELS[name]
        assert te.forward_time(cfg, 8, "mx6") == je.forward_time(
            jcfg_, 8, "mx6")
        assert te.train_step_time(cfg, 8, "mx9", 16) == \
            je.train_step_time(jcfg_, 8, "mx9", 16)
    for label in ("retrain", "label", "score", "missing"):
        assert tc.seconds(label, 1.75) == jc.seconds(label, 1.75)
    assert tc.placement_model(test_.PlacementCostModel(
        migration_cost_s=2.5)).migration_cost_s == jc.placement_model(
        jest.PlacementCostModel(migration_cost_s=2.5)).migration_cost_s


@pytest.mark.parametrize("mode", MODES)
def test_replay_allocator_decision_matches_reference(traces, mode):
    """On the JAX-saved trace, cut after each phase that retrained, both
    packages' ReplayAllocator pick the same decision from one feedback
    (all of it but ``profile_cost_s``, the replay's own host wall)."""
    _, path, _ = traces[mode]
    jt = jtrace.SessionTrace.load(str(path))
    tt = ttrace.SessionTrace.load(str(path))
    compared = 0
    for k in range(1, len(tt.phases) + 1):
        if not any(e.label == "retrain" for e in tt.phases[k - 1].events):
            continue
        for drifted in (False, True):
            picks = []
            for pkg, trc, est, cfg in (
                    (jalloc, jt, jest, jcfg), (talloc, tt, test_, tcfg)):
                policy = pkg.ReplayAllocator(pkg.CLHyperParams(**HP))
                policy.bind(est.DaCapoEstimator(), cfg.RESNET18)
                recorder = (jtrace if pkg is jalloc else ttrace
                            ).TraceRecorder()
                recorder.phases = trc.phases[:k]
                policy.attach_trace(recorder)
                d = policy.next_decision(pkg.PhaseFeedback(
                    acc_valid=0.5, acc_label=0.4, t=trc.phases[k - 1].end,
                    drifted=drifted))
                assert d.profile_cost_s > 0
                picks.append(dataclasses.replace(d, profile_cost_s=0.0))
            jd, td = picks
            assert dataclasses.asdict(td) == dataclasses.asdict(jd), k
            compared += 1
    assert compared > 0


def test_estimator_wrappers_match_reference():
    """CalibratedEstimator (over both backends) and PlacementCostModel,
    float for float."""
    rng = np.random.default_rng(0)
    for jbase, tbase in ((jest.DaCapoEstimator(), test_.DaCapoEstimator()),
                         (jest.TPUEstimator(total_rows=4),
                          test_.TPUEstimator(total_rows=4))):
        for fwd, train in ((1.0, 1.0), (0.37, 2.5), (1e-3, 11.0)):
            j = jest.CalibratedEstimator(jbase, fwd, train)
            t = test_.CalibratedEstimator(tbase, fwd, train)
            assert t.total_rows == j.total_rows
            for name, cfg in tcfg.VISION_MODELS.items():
                jc = jcfg.VISION_MODELS[name]
                for rows in (1, 3, 4):
                    for prec in ("mx4", "mx6", "mx9"):
                        assert t.forward_time(cfg, rows, prec, 2) == \
                            j.forward_time(jc, rows, prec, 2)
                        assert t.train_step_time(cfg, rows, prec, 16) == \
                            j.train_step_time(jc, rows, prec, 16)
                        assert t.inference_fps(cfg, rows, prec) == \
                            j.inference_fps(jc, rows, prec)
    assert test_.CalibratedEstimator().base == test_.DaCapoEstimator()
    for _ in range(20):
        n = int(rng.integers(1, 6))
        loads = [float(v) for v in rng.uniform(0.0, 10.0, size=n)]
        src, dst = (int(v) for v in rng.integers(0, n, size=2))
        lane = float(rng.uniform(0.0, 3.0))
        kw = dict(migration_cost_s=float(rng.uniform(0, 5)),
                  horizon_rounds=int(rng.integers(1, 8)),
                  oversub_limit=float(rng.uniform(0.5, 2.0)))
        j, t = jest.PlacementCostModel(**kw), test_.PlacementCostModel(**kw)
        assert t.round_time_s(loads) == j.round_time_s(loads)
        assert t.migration_gain_s(loads, src, dst, lane) == \
            j.migration_gain_s(loads, src, dst, lane)
        assert t.worth_migrating(loads, src, dst, lane) == \
            j.worth_migrating(loads, src, dst, lane)
        phase = float(rng.uniform(0.0, 4.0))
        assert t.utilization(loads[0], phase) == j.utilization(loads[0],
                                                               phase)
        assert t.admits(loads[0], phase, lane) == j.admits(loads[0], phase,
                                                           lane)
    assert test_.PlacementCostModel().round_time_s([]) == 0.0
    assert test_.PlacementCostModel.utilization(1.0, 0.0) == 0.0


def test_fleet_candidate_not_ported(traces):
    """A fleet's FleetDecision (anything with ``per_lane``) is item 8's."""
    class FleetLike:
        def per_lane(self):
            return []

    _, path, _ = traces["concurrent"]
    with pytest.raises(NotImplementedError, match="item 8"):
        treplay.TraceReplayer(ttrace.SessionTrace.load(str(path))).predict(
            0, FleetLike())
