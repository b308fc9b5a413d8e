"""Fleet lane membership in the port, on the CPU: at a phase boundary a
lane snapshots without touching the live lane, detaches and attaches back
from its snapshot and pipeline (``rehome_tree`` landing its host state on
the device) and resumes bit for bit; a fresh camera joins mid-run; an
empty run is populated by ``attach_lane``; ``rehome_tree`` itself, onto a
device and onto a mesh.

Weights: ``small_setup`` (JAX pretraining 10 / 8 steps on
``scenario("S1", 2)``), carried across. Tolerances: exact.
"""
import numpy as np
import pytest
import torch

from _torch_sessions import (golden_streams, jax_pretrained,  # noqa: F401
                             one_torch_thread, port_fleet)
from repro_torch.core.partition import forced_row_mesh
from repro_torch.runtime import rehome_tree
from repro_torch.runtime.elastic import PartitionSpec
from repro_torch.tree import tree_leaves

HP = dict(n_t=32, n_l=16, c_b=128, epochs=1)


@pytest.fixture(scope="module")
def golden():
    return jax_pretrained(2, 10, 8)


def _assert_lanes_identical(a, b):
    assert a.fleet_phase_log == b.fleet_phase_log
    for la, lb in zip(a.streams, b.streams):
        assert la.accuracy_timeline == lb.accuracy_timeline
        assert la.phase_log == lb.phase_log
        assert (la.retrain_time, la.label_time, la.drift_events) == (
            lb.retrain_time, lb.label_time, lb.drift_events)
        for ra, rb in zip(la.records, lb.records):
            assert (ra.decision, ra.next_decision) == (rb.decision,
                                                       rb.next_decision)


def _stepped(golden, hook=None, steps_before=3):
    """A uniform 2-lane fleet stepped to its end; ``hook(run)`` runs at the
    phase boundary after ``steps_before`` phases."""
    fleet = port_fleet(golden, HP, fleet_mode="uniform")
    run = fleet.open_run(golden_streams(port=True)[:2], duration=30.0)
    try:
        for _ in range(steps_before):
            assert run.step()
        if hook is not None:
            hook(run)
        while run.step():
            pass
        return run.finalize()
    finally:
        run.close()


def test_snapshot_detach_attach_round_trip(golden):
    """A snapshot leaves the live lane untouched; detaching lane 1 and
    attaching its snapshot and pipeline back resumes it bit for bit."""
    want = _stepped(golden)
    snaps = []

    def snapshot_only(run):
        snap = run.snapshot_lane(1)
        lane = run.lanes[1]
        for a, b in zip(tree_leaves(snap.params), tree_leaves(lane.params)):
            assert isinstance(a, np.ndarray) and np.array_equal(a, b.numpy())
        snaps.append(snap)

    _assert_lanes_identical(_stepped(golden, snapshot_only), want)
    assert snaps[0].clock > 0.0 and len(snaps[0].records) == 3

    def migrate(run):
        snap, pipe = run.detach_lane(1)
        assert run.n_lanes == 1 and len(run.session.fleet_allocator.policies) \
            == 1
        lane = run.attach_lane(pipe, snapshot=snap, own=True)
        assert lane.index == 1 and run.n_lanes == 2
        for a, b in zip(tree_leaves(lane.params), tree_leaves(snap.params)):
            assert a.device.type == "cpu" and np.array_equal(a.numpy(), b)
            assert not np.shares_memory(a.numpy(), b)

    _assert_lanes_identical(_stepped(golden, migrate), want)


def test_attach_fresh_lane_and_empty_run(golden):
    """A fresh camera joins mid-run and is scored from its join point; an
    empty run is populated by ``attach_lane``."""
    def admit(run):
        run.attach_lane(golden_streams(port=True)[2], key="cam-2")

    res = _stepped(golden, admit)
    assert res.n_streams == 3
    joined = res.streams[2]
    assert joined.records and joined.records[0].phase_start > 0.0
    assert joined.accuracy_timeline[0][0] > res.streams[0].accuracy_timeline[
        0][0]

    fleet = port_fleet(golden, HP, fleet_mode="uniform")
    run = fleet.open_run(None, duration=10.0)
    try:
        assert not run.step() and run.done
        run.attach_lane(golden_streams(port=True)[0])
        assert not run.done
        while run.step():
            pass
        assert run.finalize().streams[0].records
    finally:
        run.close()
    with pytest.raises(ValueError, match="explicit duration"):
        fleet.open_run(None)


def test_rehome_tree():
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": [np.ones(3, np.float32), torch.zeros(2)]}
    out = rehome_tree(tree, device="cpu")
    assert isinstance(out["w"], torch.Tensor) and out["w"].device.type == \
        "cpu"
    assert np.array_equal(out["w"].numpy(), tree["w"])
    assert not np.shares_memory(out["w"].numpy(), tree["w"])
    assert torch.equal(out["b"][1], tree["b"][1])
    mesh = forced_row_mesh(1, "cpu")
    on_mesh = rehome_tree(tree, mesh=mesh, spec_tree={
        "w": PartitionSpec("data", None), "b": [PartitionSpec(None),
                                                 PartitionSpec()]})
    for got, want in zip(tree_leaves(on_mesh), tree_leaves(tree)):
        assert isinstance(got, torch.Tensor)
        assert got.device == mesh.devices[0, 0]
        assert np.array_equal(got.numpy(), np.asarray(want))
