"""The port's fleet decisions held to the JAX package's: ``FleetAllocator``
in each of ``FLEET_MODES`` under each fleet row policy, fed one feedback
script with lanes admitted and removed mid-run, emits the reference's
``FleetDecision``s field for field; the row policies alone agree on a
script of drift patterns and weights; and the assertions of the
reference's allocator and row-policy tests (tests/test_fleet.py,
tests/test_decision.py) hold for the port. Pure Python over the decision
dataclasses: no model runs. Tolerance: none, the decisions are equal.
"""
import dataclasses

import pytest

from repro.configs import dacapo_pairs as jcfg
from repro.core import allocation as jalloc
from repro.core import decision as jdec
from repro.core import estimator as jest
from repro_torch.configs import dacapo_pairs as tcfg
from repro_torch.core import allocation as talloc
from repro_torch.core import decision as tdec
from repro_torch.core import estimator as test_
from repro_torch.core.allocation import (FLEET_MODES, CLHyperParams,
                                         EkyaAllocator, FleetAllocator,
                                         PhaseFeedback)
from repro_torch.core.decision import (FLEET_ROW_POLICIES,
                                       DriftSurgeRowPolicy, FleetRowContext,
                                       FleetRowPolicy, ResolveMaxRowPolicy,
                                       SpatialPlan, TemporalPlan,
                                       WeightedVoteRowPolicy,
                                       make_fleet_row_policy)
from repro_torch.core.estimator import DaCapoEstimator
from repro_torch.core.mx import DEFAULT_POLICY, PrecisionPolicy

ROW_POLICIES = ("resolve-max", "drift-surge", "weighted-vote")


def _flat(d):
    """An AllocationDecision, Decision or FleetDecision as plain data."""
    if d is None:
        return None
    if isinstance(d, (jdec.FleetDecision, tdec.FleetDecision)):
        return (_flat_spatial(d.spatial),
                [dataclasses.astuple(t) for t in d.temporal],
                [_flat(x) for x in d.lane_decisions])
    out = dataclasses.asdict(d)
    out["precisions"] = dataclasses.astuple(d.precisions)
    return out


def _flat_spatial(s):
    return (s.rows_tsa, s.rows_bsa, dataclasses.astuple(s.precisions),
            s.refission)


def _feedback(pkg, script_row, t):
    acc_v, acc_l, drifted = script_row
    return pkg.PhaseFeedback(acc_valid=acc_v, acc_label=acc_l, t=t,
                             drifted=drifted)


# Per phase, one (acc_valid, acc_label, drifted) per lane: healthy phases,
# a cliff on one lane, a two-lane drift (drift-surge's quorum), recovery,
# and detector-derived verdicts (drifted=None).
SCRIPT = [
    [(0.8, 0.82, False)] * 3,
    [(0.8, 0.82, False), (0.9, 0.2, True), (0.8, 0.82, False)],
    [(0.9, 0.3, True), (0.9, 0.25, True), (0.7, 0.72, False)],
    [(0.6, 0.62, False), (0.5, 0.55, False), (0.8, 0.8, False)],
    [(0.7, 0.72, None), (0.85, 0.5, None), (0.8, 0.85, None)],
    [(0.9, 0.9, False), (0.6, 0.62, False), (0.9, 0.3, True)],
    [(0.9, 0.91, False)] * 3,
]


def _pair(mode, row_policy, **kw):
    jhp = jalloc.CLHyperParams(n_t=64, n_l=32, c_b=192)
    thp = talloc.CLHyperParams(n_t=64, n_l=32, c_b=192)
    ja = jalloc.FleetAllocator(jhp, policy="dacapo-spatiotemporal-online",
                               mode=mode, row_policy=row_policy, **kw)
    ta = talloc.FleetAllocator(thp, policy="dacapo-spatiotemporal-online",
                               mode=mode, row_policy=row_policy, **kw)
    ja.bind(jest.DaCapoEstimator(), jcfg.RESNET18)
    ta.bind(test_.DaCapoEstimator(), tcfg.RESNET18)
    return ja, ta


@pytest.mark.parametrize("row_policy", ROW_POLICIES)
@pytest.mark.parametrize("mode", FLEET_MODES)
def test_fleet_decisions_match_reference(mode, row_policy):
    """The feedback script, with a lane admitted (fresh, then carrying a
    live policy and its fleet-side state) and a lane removed between
    phases, each followed by ``rebuild_fleet_decision``."""
    ja, ta = _pair(mode, row_policy, scale_epochs=(mode == "round-robin"))
    assert ta.name == ja.name and ta.rows == ja.rows
    assert _flat(ta.initial_fleet_decision(3)) == _flat(
        ja.initial_fleet_decision(3))
    n = 3
    for i, phase in enumerate(SCRIPT):
        rows = (phase * 2)[:n]
        want = ja.next_fleet_decision([_feedback(jalloc, r, float(i))
                                       for r in rows])
        got = ta.next_fleet_decision([_feedback(talloc, r, float(i))
                                      for r in rows])
        assert _flat(got) == _flat(want), i
        assert ta._last_weights == ja._last_weights
        if i == 1:  # a fresh camera joins
            assert ta.admit_lane() == ja.admit_lane() == 3
            n = 4
        elif i == 3:  # lane 1 leaves, and comes back with its state
            state_j, state_t = (ja.lane_policy_state(1),
                                ta.lane_policy_state(1))
            assert _flat(state_t[3]) == _flat(state_j[3])
            assert state_t[:3] == state_j[:3]
            pol_j, pol_t = ja.remove_lane(1), ta.remove_lane(1)
            assert ta.admit_lane(policy=pol_t, lane_state=state_t) == \
                ja.admit_lane(policy=pol_j, lane_state=state_j) == 3
        elif i == 5:  # lane 0 leaves for good
            ja.remove_lane(0)
            ta.remove_lane(0)
            n = 3
        else:
            continue
        assert _flat(ta.rebuild_fleet_decision()) == _flat(
            ja.rebuild_fleet_decision())
        assert ta._rr == ja._rr


def _ctx(pkg, drifted, weights=None, total=16):
    n = len(drifted)
    return pkg.FleetRowContext(drifted=tuple(drifted),
                               weights=tuple(weights or [1.0 / n] * n),
                               total_rows=total)


ROW_SCRIPT = [
    ([(8, 8), (12, 4), (8, 8)], [False, True, False], None),
    ([(8, 8)] * 3, [True, False, False], None),
    ([(8, 8)] * 3, [True, True, False], [0.45, 0.45, 0.1]),
    ([(8, 8)] * 3, [False, False, False], None),
    ([(8, 8)] * 3, [False, False, False], None),
    ([(8, 8)] * 3, [False, False, False], None),
    ([(6, 10), (9, 7), (8, 8)], [True, False, True], [0.9, 0.05, 0.05]),
    ([(16, 16)], [True], None),  # time-shared: rows do not sum to 16
    ([(8, 8)] * 3, [True] * 3, [0.2, 0.3, 0.5]),
]

ROW_KWARGS = [
    ("resolve-max", {}),
    ("drift-surge", {}),
    ("drift-surge", dict(surge_rows=4, quorum=0.5, hysteresis_phases=2)),
    ("drift-surge", dict(surge_rows=99, quorum=0.3, hysteresis_phases=1)),
    ("weighted-vote", {}),
    ("weighted-vote", dict(drift_boost=8, healthy_relief=0)),
    ("weighted-vote", dict(drift_boost=99)),
    ("weighted-vote", dict(healthy_relief=99)),
]


@pytest.mark.parametrize("name,kwargs", ROW_KWARGS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(ROW_KWARGS)])
def test_row_policies_match_reference(name, kwargs):
    jp = jdec.FleetRowPolicy(name, **kwargs)
    tp = tdec.FleetRowPolicy(name, **kwargs)
    assert type(tp).__name__ == type(jp).__name__ and tp.name == jp.name
    jp.reset(3)
    tp.reset(3)
    for rows, drifted, weights in ROW_SCRIPT:
        js = [jdec.SpatialPlan(rows_tsa=t, rows_bsa=b) for t, b in rows]
        ts = [tdec.SpatialPlan(rows_tsa=t, rows_bsa=b) for t, b in rows]
        want = jp.fleet_spatial(js, _ctx(jdec, drifted, weights))
        got = tp.fleet_spatial(ts, _ctx(tdec, drifted, weights))
        assert _flat_spatial(got) == _flat_spatial(want), (rows, drifted)


# ------------------------------------ the reference's assertions, ported --
def _spatials(rows):
    return [SpatialPlan(rows_tsa=t, rows_bsa=b, precisions=DEFAULT_POLICY)
            for t, b in rows]


def _port_ctx(drifted, weights=None, total=16):
    return _ctx(tdec, drifted, weights, total)


def test_row_policy_registry_and_constructor_dispatch():
    assert set(FLEET_ROW_POLICIES) == set(jdec.FLEET_ROW_POLICIES)
    for name, cls in FLEET_ROW_POLICIES.items():
        inst = FleetRowPolicy(name)
        assert isinstance(inst, cls) and inst.name == name
        assert isinstance(make_fleet_row_policy(name), cls)
    surge = FleetRowPolicy("drift-surge", surge_rows=3, hysteresis_phases=5)
    assert isinstance(surge, DriftSurgeRowPolicy)
    assert surge.surge_rows == 3 and surge.hysteresis_phases == 5
    ready = ResolveMaxRowPolicy()
    assert make_fleet_row_policy(ready) is ready
    assert isinstance(make_fleet_row_policy(WeightedVoteRowPolicy),
                      WeightedVoteRowPolicy)
    with pytest.raises(KeyError):
        FleetRowPolicy("round-rows")
    with pytest.raises(TypeError):
        FleetRowPolicy("resolve-max", surge_rows=2)


def test_resolve_max_matches_the_legacy_rule():
    spatials = _spatials([(8, 8), (12, 4), (8, 8)])
    out = ResolveMaxRowPolicy().fleet_spatial(
        spatials, _port_ctx([False, True, False]))
    assert (out.rows_tsa, out.rows_bsa) == (12, 4)
    assert out.precisions is spatials[0].precisions


def test_drift_surge_quorum_hysteresis_and_release():
    pol = DriftSurgeRowPolicy(surge_rows=4, quorum=0.5, hysteresis_phases=2)
    pol.reset(3)
    spatials = _spatials([(8, 8)] * 3)
    steps = [([True, False, False], (8, 8)),   # below quorum
             ([True, True, False], (12, 4)),   # surge fires
             ([False, False, False], (12, 4)),  # held
             ([False, False, False], (8, 8))]  # released
    for drifted, rows in steps:
        out = pol.fleet_spatial(spatials, _port_ctx(drifted))
        assert (out.rows_tsa, out.rows_bsa) == rows
    out = DriftSurgeRowPolicy(surge_rows=99).fleet_spatial(
        spatials, _port_ctx([True, True, True]))
    assert out.rows_bsa == 1 and out.rows_tsa == 15
    out = pol.fleet_spatial(_spatials([(16, 16)]), _port_ctx([True]))
    assert (out.rows_tsa, out.rows_bsa) == (16, 16)
    pol.fleet_spatial(spatials, _port_ctx([True, True, False]))
    pol.reset(3)
    out = pol.fleet_spatial(spatials, _port_ctx([False, False, False]))
    assert (out.rows_tsa, out.rows_bsa) == (8, 8)


def test_weighted_vote_follows_drift_weighted_shares():
    spatials = _spatials([(8, 8)] * 3)
    cases = [
        (WeightedVoteRowPolicy(), [False] * 3, None, (6, 10)),
        (WeightedVoteRowPolicy(drift_boost=8, healthy_relief=0),
         [False] * 3, None, (8, 8)),
        (WeightedVoteRowPolicy(drift_boost=8, healthy_relief=0),
         [True, False, False], None, (11, 5)),
        (WeightedVoteRowPolicy(drift_boost=8, healthy_relief=0),
         [True, False, False], [0.9, 0.05, 0.05], (15, 1)),
        (WeightedVoteRowPolicy(drift_boost=99), [True] * 3, None, (15, 1)),
        (WeightedVoteRowPolicy(healthy_relief=99), [False] * 3, None,
         (1, 15)),
    ]
    for pol, drifted, weights, rows in cases:
        out = pol.fleet_spatial(spatials, _port_ctx(drifted, weights))
        assert (out.rows_tsa, out.rows_bsa) == rows


def _bound(mode, **kw) -> FleetAllocator:
    alloc = FleetAllocator(CLHyperParams(n_t=64, n_l=32),
                           policy="dacapo-spatiotemporal", mode=mode, **kw)
    return alloc.bind(DaCapoEstimator(), tcfg.RESNET18)


_HEALTHY = PhaseFeedback(acc_valid=0.8, acc_label=0.82, t=1.0)


def test_fleet_allocator_emits_fleet_decisions():
    alloc = FleetAllocator(CLHyperParams(n_t=64, n_l=32),
                           policy="dacapo-spatiotemporal",
                           mode="drift-weighted", row_policy="drift-surge")
    alloc.bind(DaCapoEstimator(), tcfg.RESNET18)
    assert "drift-surge" in alloc.name
    fd = alloc.initial_fleet_decision(3)
    assert fd.n_lanes == 3 and len(fd.lane_decisions) == 3
    assert fd.spatial.rows_tsa + fd.spatial.rows_bsa == \
        DaCapoEstimator().total_rows
    for tp, lane in zip(fd.temporal, fd.lane_decisions):
        assert isinstance(tp, TemporalPlan)
        assert tp.retrain_samples == lane.retrain_samples
        assert tp.total_label_samples == lane.total_label_samples
    assert all(v.spatial is fd.spatial for v in fd.per_lane())
    healthy = PhaseFeedback(acc_valid=0.8, acc_label=0.82, t=1.0,
                            drifted=False)
    cliff = PhaseFeedback(acc_valid=0.9, acc_label=0.2, t=1.0, drifted=True)
    fd2 = alloc.next_fleet_decision([cliff, cliff, healthy])
    assert fd2.spatial.rows_tsa > fd.spatial.rows_tsa
    with pytest.raises(RuntimeError):
        FleetAllocator(CLHyperParams()).initial_fleet_decision(2)
    alloc.policies[1].precision = PrecisionPolicy(inference="mx4")
    with pytest.raises(ValueError, match="heterogeneous"):
        alloc.next_fleet_decision([healthy, healthy, healthy])


def test_fleet_allocator_uniform_split():
    alloc = _bound("uniform")
    decisions = alloc.initial_decisions(4)
    assert len(decisions) == 4 == len(alloc.policies)
    for d in decisions:
        assert d.retrain_samples == round(alloc.hp.n_t / 4)
        assert d.rows_tsa is not None
    decisions = alloc.next_decisions([_HEALTHY] * 4)
    assert sum(d.label_samples for d in decisions) <= alloc.hp.n_l + 4


def test_fleet_allocator_round_robin_rotates_focus():
    alloc = _bound("round-robin")
    focus_order = []
    alloc.initial_decisions(3)
    for _ in range(3):
        decisions = alloc.next_decisions([_HEALTHY] * 3)
        focus = [i for i, d in enumerate(decisions)
                 if d.retrain_samples == alloc.hp.n_t]
        assert len(focus) == 1
        focus_order.append(focus[0])
        for i, d in enumerate(decisions):
            if i != focus[0]:
                assert d.retrain_samples == alloc.hp.sgd_batch
                assert d.valid_samples == alloc.hp.n_v
                assert d.label_samples >= 1
    assert len(set(focus_order)) == 3


def test_fleet_allocator_drift_weighted_follows_drift():
    alloc = _bound("drift-weighted", drift_bias=4.0)
    alloc.initial_decisions(3)
    alloc.next_decisions([_HEALTHY] * 3)
    cliff = PhaseFeedback(acc_valid=0.9, acc_label=0.2, t=2.0)
    decisions = alloc.next_decisions([_HEALTHY, cliff, _HEALTHY])
    assert decisions[1].reset_buffer
    assert decisions[1].retrain_samples > decisions[0].retrain_samples
    assert (decisions[1].total_label_samples
            > decisions[0].total_label_samples)


def test_fleet_allocator_isolated_keeps_full_budgets():
    for d in _bound("isolated").initial_decisions(3):
        assert d.retrain_samples == 64 and d.label_samples == 32


def test_fleet_allocator_one_stream_identity_and_guards():
    alloc = _bound("drift-weighted")
    decisions = alloc.initial_decisions(1)
    assert decisions[0] == alloc.policies[0].initial_decision()
    with pytest.raises(ValueError):
        FleetAllocator(CLHyperParams(), mode="nope")
    with pytest.raises(ValueError):
        FleetAllocator(CLHyperParams(), policy=_bound("uniform"))
    alloc2 = FleetAllocator(CLHyperParams(),
                            policy=EkyaAllocator(CLHyperParams()))
    with pytest.raises(ValueError):
        alloc2.lanes(2)
    with pytest.raises(TypeError):
        alloc.initial_decision()
    with pytest.raises(TypeError):
        alloc.next_decision(_HEALTHY)


def test_fleet_allocator_zero_eps_all_healthy_falls_back_uniform():
    alloc = _bound("drift-weighted", gap_eps=0.0)
    alloc.initial_decisions(2)
    decisions = alloc.next_decisions([_HEALTHY] * 2)
    assert [d.retrain_samples for d in decisions] == [32, 32]


def test_fleet_allocator_scale_epochs():
    alloc = _bound("round-robin", scale_epochs=True)
    alloc.initial_decisions(3)
    decisions = alloc.next_decisions([_HEALTHY] * 3)
    focus = [d for d in decisions if d.retrain_samples == alloc.hp.n_t][0]
    assert focus.retrain_epochs == 3
    for d in decisions:
        if d is not focus:
            assert d.retrain_epochs == 1


def test_row_context_and_decision_types_match_reference():
    """The fleet dataclasses carry the reference's fields."""
    for name in ("FleetDecision", "FleetRowContext"):
        assert [f.name for f in dataclasses.fields(getattr(tdec, name))] == \
            [f.name for f in dataclasses.fields(getattr(jdec, name))]
    assert FleetRowContext((True,), (1.0,), 16).total_rows == 16
