"""The fleet's side of the trace held to the JAX package's, on the CPU: a
traced 3-stream port fleet equals its untraced run bit for bit and the
reference's traced fleet event for event (lanes, fans, per-lane
decisions); every ``dispatch_multi`` group spans the fleet's lanes with one
wall split evenly; a fleet trace the JAX package saves loads in the port
(and the port's in the JAX package), and on it the port's
``TraceReplayer`` replays every phase — with its ``FleetDecision``
candidates matched to events by lane — bit for bit as the reference does.

Fixture: the 3-stream fleet of tests/test_torch_fleet_parity.py (S1 / S3 /
ES1, seeds 5 / 6 / 7, 24 px, drift-weighted, resolve-max, fp32), 30 s, in
both dispatch modes, weights from ``small_setup``. Tolerances: kind, role,
label, lane, fan, units and the phase decisions exactly; ``cost_s`` and
phase boundaries within 1e-6 (the ledger tolerance); replayed floats
exactly. ``wall_s`` and ``path`` (host measurements) are left out.
"""
import dataclasses

import pytest

from _torch_sessions import (fleet_pair, golden_streams,  # noqa: F401
                             jax_pretrained, one_torch_thread, port_fleet)
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
SPEC = dict(fleet_mode="drift-weighted", row_policy="resolve-max",
            apply_mx=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per mode: the reference's traced fleet (its trace saved by the JAX
    package), the port's traced fleet and the port's untraced fleet."""
    golden = jax_pretrained(2, 10, 8)
    out = {}
    for mode in MODES:
        ref, port = fleet_pair(golden, HP, dispatch=mode, trace=True,
                               **SPEC)
        want = ref.run(golden_streams(port=False), duration=30.0)
        got = port.run(golden_streams(port=True), duration=30.0)
        plain = port_fleet(golden, HP, dispatch=mode, **SPEC).run(
            golden_streams(port=True), duration=30.0)
        path = tmp_path_factory.mktemp("fleet") / f"{mode}.json"
        ref.dispatcher.recorder.trace.save(str(path))
        out[mode] = dict(ref_trace=ref.dispatcher.recorder.trace, path=path,
                         trace=port.dispatcher.recorder.trace, want=want,
                         got=got, plain=plain)
    return out


def _virtual(e) -> dict:
    d = e.as_dict()
    del d["wall_s"], d["path"]
    return d


@pytest.mark.parametrize("mode", MODES)
def test_traced_fleet_equals_untraced(runs, mode):
    got, plain = runs[mode]["got"], runs[mode]["plain"]
    assert got.fleet_phase_log == plain.fleet_phase_log
    for a, b in zip(got.streams, plain.streams):
        assert a.accuracy_timeline == b.accuracy_timeline
        assert a.phase_log == b.phase_log


@pytest.mark.parametrize("mode", MODES)
def test_fleet_trace_matches_reference_event_for_event(runs, mode):
    want, got = runs[mode]["ref_trace"], runs[mode]["trace"]
    n_lanes = runs[mode]["got"].n_streams
    fanned = 0
    assert len(got.phases) == len(want.phases) > 0
    for g, w in zip(got.phases, want.phases):
        assert (g.index, g.mode) == (w.index, w.mode)
        assert g.decisions == w.decisions and len(g.decisions) == n_lanes
        for key in ("start", "end", "floor"):
            assert abs(getattr(g, key) - getattr(w, key)) < TOL, key
        assert len(g.events) == len(w.events) > 0
        for eg, ew in zip(g.events, w.events):
            dg, dw = _virtual(eg), _virtual(ew)
            assert abs(dg.pop("cost_s") - dw.pop("cost_s")) < TOL
            assert dg == dw
        # One labeling program per phase (none in a phase cut short at the
        # duration), fanned over every lane, its measured wall split evenly.
        group = [e for e in g.events if e.label == "label"]
        fanned += bool(group)
        if group:
            assert [e.lane for e in group] == list(range(n_lanes))
            assert {e.fan for e in group} == {n_lanes}
            assert len({e.wall_s for e in group}) == 1
    assert fanned >= len(got.phases) - 1


@pytest.mark.parametrize("mode", MODES)
def test_fleet_traces_load_across_packages(runs, mode, tmp_path):
    path, trace = runs[mode]["path"], runs[mode]["trace"]
    assert ttrace.SessionTrace.load(str(path)).as_dict() == \
        runs[mode]["ref_trace"].as_dict()
    port_path = tmp_path / "port.json"
    trace.save(str(port_path))
    assert jtrace.SessionTrace.load(str(port_path)).as_dict() == \
        trace.as_dict()


def _fleet_candidates(alloc_mod):
    """FleetDecisions a FleetAllocator emits for three lanes: each mode's
    first phase, then a phase after one lane drifted."""
    out = []
    hp = alloc_mod.CLHyperParams(**HP)
    est = (jest if alloc_mod is jalloc else test_).DaCapoEstimator()
    cfg = (jcfg if alloc_mod is jalloc else tcfg).RESNET18
    for mode in alloc_mod.FLEET_MODES:
        for row_policy in ("resolve-max", "drift-surge"):
            alloc = alloc_mod.FleetAllocator(hp, mode=mode,
                                             row_policy=row_policy)
            alloc.bind(est, cfg)
            out.append(alloc.initial_fleet_decision(3))
            fb = [alloc_mod.PhaseFeedback(acc_valid=0.9, acc_label=a,
                                          t=1.0, drifted=d)
                  for a, d in ((0.2, True), (0.9, False), (0.3, True))]
            out.append(alloc.next_fleet_decision(fb))
    return out


@pytest.mark.parametrize("mode", MODES)
def test_jax_saved_fleet_trace_replays_in_port(runs, mode):
    path = runs[mode]["path"]
    jt = jtrace.SessionTrace.load(str(path))
    tt = ttrace.SessionTrace.load(str(path))
    jr = jreplay.TraceReplayer(jt, jest.DaCapoEstimator(), jcfg.RESNET18,
                               jcfg.WIDERESNET50, jalloc.CLHyperParams(**HP))
    tr = treplay.TraceReplayer(tt, test_.DaCapoEstimator(), tcfg.RESNET18,
                               tcfg.WIDERESNET50, talloc.CLHyperParams(**HP))
    assert len(tr) == len(jr) > 0
    assert tr.durations() == jr.durations()
    assert tr.unit_costs() == jr.unit_costs()
    jc, tc = jr.calibrate(), tr.calibrate()
    assert tc.scales == jc.scales and tc.global_scale == jc.global_scale
    cands = list(zip(_fleet_candidates(jalloc), _fleet_candidates(talloc)))
    moved = 0
    for i in range(len(jr)):
        assert tr.phase_time(i) == jr.phase_time(i) == tt.phases[i].end
        for other in MODES:
            assert tr.predict(i, mode=other) == jr.predict(i, mode=other)
        assert tr.predict(i, from_units=True) == jr.predict(
            i, from_units=True)
        for jd, td in cands:
            assert [dataclasses.astuple(t) for t in td.temporal] == \
                [dataclasses.astuple(t) for t in jd.temporal]
            got = tr.predict(i, td)
            assert got == jr.predict(i, jd), (i, td)
            assert tr.predict(i, td, from_units=True) == jr.predict(
                i, jd, from_units=True)
            moved += got != tr.phase_time(i)
        jd, td = jr.dag(i), tr.dag(i)
        assert td["tails"] == jd["tails"]
        assert [(n.id, n.deps, n.event.as_dict()) for n in td["nodes"]] \
            == [(n.id, n.deps, n.event.as_dict()) for n in jd["nodes"]]
    assert moved > 0  # the candidates re-priced lanes' events
