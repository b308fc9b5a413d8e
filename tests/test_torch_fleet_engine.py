"""The port's fleet engine on the CPU: a 1-stream fleet equals the port's
own ``CLSession`` bit for bit in every fleet mode (records, accuracy
timeline, speculation counters — the port's counterpart of the reference's
degeneracy golden); a 3-stream fleet conserves its ledgers; batched
serving (``serve_batched``) keeps the per-lane run's ledgers and
accuracies in fewer forwards; the split fleet runs more phases than the
isolated one. Lane membership (snapshot, detach, attach) is in
tests/test_torch_fleet_lanes.py.

Weights: ``small_setup`` (JAX pretraining 10 / 8 steps on
``scenario("S1", 2)``), carried across. Tolerances: exact, but for the
batched-serving accuracies (within 1e-6, as the reference's
``test_fleet_serve_batched_matches_per_lane`` holds its own: a vmapped
convolution with per-lane weights runs as a grouped convolution).
"""
import numpy as np
import pytest

from _torch_sessions import (golden_streams, jax_pretrained,  # noqa: F401
                             one_torch_thread, port_fleet, port_session,
                             port_stream)
from repro_torch.core.allocation import FLEET_MODES
from repro_torch.tree import tree_leaves

HP = dict(n_t=32, n_l=16, c_b=128, epochs=1)
_RECORD_FIELDS = ("index", "t", "acc_valid", "acc_label", "drift",
                  "retrain_time", "label_time", "phase_start", "t_tsa",
                  "t_bsa", "spec_hits", "spec_misses", "stream")


@pytest.fixture(scope="module")
def golden():
    return jax_pretrained(2, 10, 8)


def _assert_records_identical(recs_a, recs_b):
    assert len(recs_a) == len(recs_b) > 0
    for a, b in zip(recs_a, recs_b):
        for field in _RECORD_FIELDS:
            assert getattr(a, field) == getattr(b, field), field
        assert a.decision == b.decision
        assert a.next_decision == b.next_decision


DEGENERATE = [(mode, "sequential", False) for mode in FLEET_MODES] + [
    ("drift-weighted", "concurrent", False),
    ("drift-weighted", "concurrent", True)]


@pytest.mark.parametrize("mode,dispatch,apply_mx", DEGENERATE,
                         ids=[f"{m}-{d}-{'mx6' if x else 'fp32'}"
                              for m, d, x in DEGENERATE])
def test_one_stream_fleet_equals_session(golden, mode, dispatch, apply_mx):
    session = port_session(golden, HP, dispatch=dispatch, apply_mx=apply_mx)
    res = session.run(port_stream(golden), duration=20.0)
    fleet = port_fleet(golden, HP, fleet_mode=mode, dispatch=dispatch,
                       apply_mx=apply_mx)
    fres = fleet.run([port_stream(golden)], duration=20.0)
    assert fres.n_streams == 1
    lane = fres.streams[0]
    assert lane.accuracy_timeline == res.accuracy_timeline
    assert lane.phase_log == res.phase_log
    assert (lane.retrain_time, lane.label_time, lane.drift_events) == (
        res.retrain_time, res.label_time, res.drift_events)
    _assert_records_identical(lane.records, res.records)
    assert fres.fleet_avg_accuracy == lane.avg_accuracy
    if dispatch == "concurrent":
        assert sum(r.spec_hits for r in lane.records) > 0
    # The lanes retrain copies: the fleet's pretrained student is intact.
    for a, b in zip(tree_leaves(fleet.student_params),
                    tree_leaves(golden[4])):
        assert np.array_equal(a.numpy(), b)


def test_three_stream_fleet_ledger_conservation(golden):
    fleet = port_fleet(golden, HP, fleet_mode="drift-weighted")
    seen = []
    fres = fleet.run(golden_streams(port=True), duration=40.0,
                     observers=(seen.append,))
    assert fres.n_streams == 3 and fres.fleet_phase_log
    for entry in fres.fleet_phase_log:
        assert sum(entry["per_stream_t_tsa"]) == pytest.approx(
            entry["t_tsa"], rel=1e-9, abs=1e-12)
        assert sum(entry["per_stream_t_bsa"]) == pytest.approx(
            entry["t_bsa"], rel=1e-9, abs=1e-12)
        assert len(entry["per_stream_t_tsa"]) == 3
    n_phases = len(fres.fleet_phase_log)
    for i, lane in enumerate(fres.streams):
        assert len(lane.records) == n_phases
        for j, rec in enumerate(lane.records):
            assert rec.stream == i and rec.index == j
            assert rec.t_tsa == fres.fleet_phase_log[j]["per_stream_t_tsa"][i]
        assert lane.avg_accuracy > 0.0
        ts = [t for t, _ in lane.accuracy_timeline]
        assert ts == sorted(ts)
    assert {rec.stream for rec in seen} == {0, 1, 2}
    assert len(seen) == 3 * n_phases


def test_fleet_serve_batched_matches_per_lane(golden):
    streams = golden_streams(port=True)[:2]

    def run(batched):
        fleet = port_fleet(golden, HP, dispatch="concurrent",
                           serve_batched=batched)
        return fleet, fleet.run(streams, duration=40.0)

    f0, r0 = run(False)
    f1, r1 = run(True)
    for a, b in zip(r0.streams, r1.streams):
        assert b.avg_accuracy == pytest.approx(a.avg_accuracy, abs=1e-6)
        assert b.retrain_time == a.retrain_time
        assert b.label_time == a.label_time
        assert [t for t, _ in b.accuracy_timeline] == \
            [t for t, _ in a.accuracy_timeline]
    assert r1.fleet_phase_log == r0.fleet_phase_log
    assert f1.inference.n_apply_calls < f0.inference.n_apply_calls


def test_fleet_budget_scales_phase_cost(golden):
    phases = {}
    for mode in ("uniform", "isolated"):
        fleet = port_fleet(golden, HP, fleet_mode=mode)
        phases[mode] = len(fleet.run(golden_streams(port=True),
                                     duration=40.0).fleet_phase_log)
    assert phases["uniform"] > phases["isolated"]
