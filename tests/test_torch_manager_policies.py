"""The manager tier's placement policies and durable lane snapshots in the
port, on the CPU.

* Each placement policy (``static``, ``headroom``, ``drift-pack``,
  ``estimator`` with its knobs) of the port and of the JAX package is fed
  one random sequence of ``ShardView`` / ``LaneView`` sets (ties and dead,
  done, idle and cold shards included): ``place``, ``admit`` and
  ``migrate`` must agree call for call (exactly).
* The reference's unit tests of the registry, the policies and
  ``PlacementCostModel`` (``tests/test_manager.py``), ported;
  ``ManagerSpec.build()`` and its validation.
* ``snapshot_to_state`` / ``state_to_snapshot`` invert each other on a
  port lane, through a real ``CheckpointManager``, and on the empty
  buffer; the ``aux`` blob of a lane written on the CPU unpickles without
  touching ``torch`` (it would need the card otherwise), and
  ``snapshot_to_state`` refuses a tensor there.

Weights: random inits of the reduced pair (no pretraining needed here).
"""
import io
import pickle

import numpy as np
import pytest
import torch

from _torch_sessions import one_torch_thread  # noqa: F401
from repro.core import manager as jmanager
from repro.core.estimator import PlacementCostModel as JPlacementCostModel
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.dacapo_pairs import RESNET18, WIDERESNET50
from repro_torch.core.allocation import CLHyperParams
from repro_torch.core.estimator import PlacementCostModel
from repro_torch.core.fleet import FleetSpec, LaneSnapshot
from repro_torch.core.manager import (
    PLACEMENT_POLICIES,
    DriftPackPlacementPolicy,
    EstimatorPlacementPolicy,
    FleetManager,
    HeadroomPlacementPolicy,
    LaneView,
    ManagerSpec,
    PlacementPolicy,
    ShardView,
    StaticPlacementPolicy,
    make_placement_policy,
    snapshot_to_state,
    state_to_snapshot,
)
from repro_torch.data.stream import DriftStream, scenario
from repro_torch.tree import tree_leaves

HP = CLHyperParams(n_t=32, n_l=16, c_b=128, epochs=1)

POLICIES = [
    ("static", {}),
    ("headroom", {}),
    ("headroom", {"min_gap": 1}),
    ("drift-pack", {}),
    ("estimator", {}),
    ("estimator", {"migration_cost_s": 0.5, "horizon_rounds": 2,
                   "oversub_limit": 0.8}),
]


def _random_round(rng):
    """One round's views, as plain field dicts: 1-4 shards, loads drawn
    from a small set so ties happen."""
    n = int(rng.integers(1, 5))
    loads = (0.0, 0.5, 1.0, 2.5, 4.0)
    shards = []
    for i in range(n):
        alive = bool(rng.random() > 0.15)
        shards.append(dict(
            index=i, alive=alive, done=bool(rng.random() < 0.1),
            n_lanes=int(rng.integers(0, 5)), clock=float(rng.random()),
            t_tsa=float(rng.random() * 10),
            recent_t_tsa=float(rng.choice(loads)),
            drifted_lanes=int(rng.integers(0, 3)),
            recent_phase_s=float(rng.choice((0.0, 2.0, 5.0)))))
    if not any(s["alive"] and not s["done"] for s in shards):
        shards[0].update(alive=True, done=False)
    lanes = []
    for s in shards:
        if not s["alive"]:
            continue
        for j in range(s["n_lanes"]):
            lanes.append(dict(
                shard=s["index"], index=j, key=f"c{s['index']}-{j}",
                drifted=bool(rng.random() < 0.4),
                drift_events=int(rng.integers(0, 3)),
                recent_t_tsa=float(rng.choice(loads))))
    return shards, lanes


def _proposal(got):
    return None if got is None else (got[0].key, got[0].shard,
                                     got[0].index, got[1])


def _outcome(fn, *args):
    """What a policy call returns, or the name of what it raises (the
    manager lists the lanes of every live shard, done ones too, and both
    packages must fail alike where a policy does not expect that)."""
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001 — compared between packages
        return type(e).__name__


@pytest.mark.parametrize("name, kwargs", POLICIES,
                         ids=[f"{n}{k or ''}" for n, k in POLICIES])
def test_policy_agrees_with_reference(name, kwargs):
    rng = np.random.default_rng(17)
    port = make_placement_policy(name, **kwargs)
    ref = jmanager.make_placement_policy(name, **kwargs)
    assert type(port).__name__ == type(ref).__name__
    port.reset(4)
    ref.reset(4)
    decided = {"place": 0, "admit": 0, "reject": 0, "migrate": 0}
    for _ in range(300):
        shards, lanes = _random_round(rng)
        views = [ShardView(**s) for s in shards]
        jviews = [jmanager.ShardView(**s) for s in shards]
        lviews = [LaneView(**ln) for ln in lanes]
        jlviews = [jmanager.LaneView(**ln) for ln in lanes]
        assert port.place(views) == ref.place(jviews)
        admitted = port.admit(views)
        assert admitted == ref.admit(jviews)
        got = _outcome(port.migrate, views, lviews)
        want = _outcome(ref.migrate, jviews, jlviews)
        if isinstance(got, tuple):
            got, want = _proposal(got), _proposal(want)
        assert got == want
        decided["place"] += 1
        decided["reject" if admitted is None else "admit"] += 1
        decided["migrate"] += isinstance(got, tuple)
    if name != "static":
        assert decided["migrate"] > 0
    if name == "estimator":
        assert decided["reject"] > 0


# ------------------------------------- tests/test_manager.py, ported
def test_placement_policy_registry():
    assert set(PLACEMENT_POLICIES) == set(jmanager.PLACEMENT_POLICIES) == {
        "static", "headroom", "drift-pack", "estimator"}
    assert isinstance(PlacementPolicy("static"), StaticPlacementPolicy)
    assert isinstance(PlacementPolicy("drift-pack"),
                      DriftPackPlacementPolicy)
    assert isinstance(PlacementPolicy(), HeadroomPlacementPolicy)
    assert isinstance(make_placement_policy("headroom", min_gap=3),
                      HeadroomPlacementPolicy)
    assert make_placement_policy("headroom", min_gap=3).min_gap == 3
    inst = StaticPlacementPolicy()
    assert make_placement_policy(inst) is inst
    assert isinstance(make_placement_policy(DriftPackPlacementPolicy),
                      DriftPackPlacementPolicy)
    with pytest.raises(KeyError, match="unknown placement policy"):
        PlacementPolicy("nope")
    with pytest.raises(TypeError, match="unexpected keyword"):
        PlacementPolicy("static", bogus=1)


def test_headroom_policy_places_and_migrates():
    def view(i, n, recent, drifted=0, alive=True, done=False):
        return ShardView(index=i, alive=alive, done=done, n_lanes=n,
                         clock=0.0, t_tsa=0.0, recent_t_tsa=recent,
                         drifted_lanes=drifted)

    pol = HeadroomPlacementPolicy(min_gap=2)
    assert pol.place([view(0, 2, 1.0), view(1, 1, 9.0)]) == 1
    assert pol.place([view(0, 1, 5.0), view(1, 1, 2.0)]) == 1
    assert pol.place([view(0, 0, 0.0, alive=False), view(1, 3, 9.0)]) == 1
    lanes = [LaneView(shard=0, index=0, key="a", drifted=True,
                      drift_events=2),
             LaneView(shard=0, index=1, key="b", drifted=False,
                      drift_events=0)]
    got = pol.migrate([view(0, 3, 9.0, drifted=1), view(1, 1, 1.0)], lanes)
    assert got is not None and got[0].key == "a" and got[1] == 1
    assert pol.migrate([view(0, 2, 9.0, drifted=1), view(1, 1, 1.0)],
                       lanes) is None


def _eview(i, n, recent, phase_s=10.0, drifted=0, alive=True, done=False):
    return ShardView(index=i, alive=alive, done=done, n_lanes=n, clock=0.0,
                     t_tsa=0.0, recent_t_tsa=recent, drifted_lanes=drifted,
                     recent_phase_s=phase_s)


def test_estimator_policy_registered_with_knobs():
    pol = PlacementPolicy("estimator", migration_cost_s=1.0,
                          horizon_rounds=2, oversub_limit=1.2)
    assert isinstance(pol, EstimatorPlacementPolicy)
    assert isinstance(pol.model, PlacementCostModel)
    assert pol.model.migration_cost_s == 1.0
    assert pol.model.horizon_rounds == 2
    assert pol.model.oversub_limit == 1.2
    with pytest.raises(TypeError, match="unexpected keyword"):
        PlacementPolicy("estimator", bogus=1)


def test_estimator_places_and_admits_by_seconds():
    pol = EstimatorPlacementPolicy(oversub_limit=1.0)
    assert pol.place([_eview(0, 1, 8.0), _eview(1, 3, 2.0)]) == 1
    assert pol.admit([_eview(0, 0, 0.0, phase_s=0.0),
                      _eview(1, 0, 0.0, phase_s=0.0)]) == 0
    assert pol.admit([_eview(0, 1, 4.0), _eview(1, 1, 6.0)]) == 0
    assert pol.admit([_eview(0, 2, 9.5), _eview(1, 2, 9.0)]) is None


def test_estimator_migrates_on_load_max_gain():
    lanes = [LaneView(shard=0, index=0, key="a", drifted=True,
                      drift_events=1, recent_t_tsa=6.0),
             LaneView(shard=0, index=1, key="b", drifted=False,
                      drift_events=0, recent_t_tsa=2.0),
             LaneView(shard=1, index=0, key="c", drifted=False,
                      drift_events=0, recent_t_tsa=1.0)]
    views = [_eview(0, 2, 8.0), _eview(1, 1, 1.0)]
    pol = EstimatorPlacementPolicy(migration_cost_s=2.0, horizon_rounds=4)
    got = pol.migrate(views, lanes)
    assert got is not None
    assert got[0].key == "b" and got[1] == 1
    dear = EstimatorPlacementPolicy(migration_cost_s=10.0, horizon_rounds=4)
    assert dear.migrate(views, lanes) is None
    solo = [LaneView(shard=0, index=0, key="a", drifted=True,
                     drift_events=1, recent_t_tsa=8.0)]
    assert pol.migrate([_eview(0, 1, 8.0), _eview(1, 1, 0.5)], solo) is None


@pytest.mark.parametrize("cls", [PlacementCostModel, JPlacementCostModel],
                         ids=["port", "reference"])
def test_placement_cost_model_arithmetic(cls):
    model = cls(migration_cost_s=3.0, horizon_rounds=2, oversub_limit=1.5)
    assert model.round_time_s([4.0, 9.0, 1.0]) == 9.0
    assert model.round_time_s([]) == 0.0
    assert model.migration_gain_s([9.0, 1.0], 0, 1, 4.0) \
        == pytest.approx((9.0 - 5.0) * 2)
    assert model.worth_migrating([9.0, 1.0], 0, 1, 4.0)
    assert not model.worth_migrating([9.0, 8.0], 0, 1, 0.5)
    assert model.utilization(12.0, 8.0) == 1.5
    assert model.utilization(1.0, 0.0) == 0.0
    assert model.admits(8.0, 8.0, 4.0)
    assert not model.admits(8.1, 8.0, 4.0)


def test_placement_cost_model_matches_reference():
    rng = np.random.default_rng(4)
    for _ in range(200):
        kw = dict(migration_cost_s=float(rng.random() * 3),
                  horizon_rounds=int(rng.integers(1, 6)),
                  oversub_limit=float(rng.random() * 2))
        port, ref = PlacementCostModel(**kw), JPlacementCostModel(**kw)
        loads = [float(x) for x in rng.random(int(rng.integers(2, 5))) * 9]
        src, dst = rng.choice(len(loads), 2, replace=False)
        cost = float(rng.random() * 4)
        assert port.migration_gain_s(loads, src, dst, cost) == \
            ref.migration_gain_s(loads, src, dst, cost)
        assert port.worth_migrating(loads, src, dst, cost) == \
            ref.worth_migrating(loads, src, dst, cost)
        assert port.admits(loads[0], loads[1], cost) == \
            ref.admits(loads[0], loads[1], cost)


def _fleet_spec(**kw):
    return FleetSpec(student=RESNET18, teacher=WIDERESNET50, hp=HP,
                     fleet_mode="drift-weighted", apply_mx=False, seed=0,
                     eval_fps=0.5, device="cpu", **kw)


def test_manager_spec_builds():
    spec = ManagerSpec(fleet=_fleet_spec(), n_shards=3,
                       placement="drift-pack", migration=False,
                       parallel_shards=3,
                       migration_cost_s=1.0, trace=True)
    mgr = spec.build()
    assert mgr.n_shards == 3
    assert isinstance(mgr.placement, DriftPackPlacementPolicy)
    assert not mgr.migration
    assert mgr.parallel_shards == 3
    assert mgr.migration_cost_s == 1.0
    assert mgr.name == "manager-drift-packx3"
    recorders = [s.session.dispatcher.recorder for s in mgr.shards]
    assert all(r is not None for r in recorders)
    assert len({id(r) for r in recorders}) == 3  # one recorder a shard
    assert spec.fleet.trace is None  # the fleet spec is left as it was
    assert len(mgr.trace.phases) == 0
    assert mgr.trace.meta == {"tier": "manager",
                              "name": "manager-drift-packx3"}
    with pytest.raises(ValueError, match="n_shards"):
        FleetManager(_fleet_spec(), n_shards=0)
    with pytest.raises(KeyError, match="unknown placement policy"):
        ManagerSpec(fleet=_fleet_spec(), placement="nope").build()
    with pytest.raises(TypeError, match="unexpected keyword"):
        ManagerSpec(fleet=_fleet_spec(), placement="static",
                    placement_kwargs={"min_gap": 1}).build()


# --------------------------------------------- durable lane snapshots
@pytest.fixture(scope="module")
def lane_snapshot():
    """A port lane two phases in (random weights of the reduced pair)."""
    fleet = _fleet_spec().build()
    gen = torch.Generator().manual_seed(0)
    fleet.set_pretrained(fleet.teacher.init(gen), fleet.student.init(gen))
    run = fleet.open_run([DriftStream(scenario("S1", 2), seed=5, img=24)],
                         duration=40.0)
    try:
        assert run.step() and run.step()
        snap = run.snapshot_lane(0)
    finally:
        run.close()
    return snap


class _NoTorchUnpickler(pickle.Unpickler):
    """Records every class the blob names; refuses ``torch``'s."""

    def __init__(self, data: bytes):
        super().__init__(io.BytesIO(data))
        self.modules = set()

    def find_class(self, module, name):
        self.modules.add(module)
        if module.split(".")[0] == "torch":
            raise AssertionError(f"aux names {module}.{name}")
        return super().find_class(module, name)


def test_snapshot_state_roundtrip_through_checkpoint(lane_snapshot, tmp_path):
    snap = lane_snapshot
    state = snapshot_to_state(snap)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(3, state)
    restored_state, manifest = mgr.restore(3, state)
    back = state_to_snapshot(restored_state)
    assert manifest["step"] == 3
    for tree_name in ("params", "opt"):
        a, b = getattr(snap, tree_name), getattr(back, tree_name)
        assert list(a) == list(b)
        for la, lb in zip(tree_leaves(a), tree_leaves(b)):
            assert isinstance(lb, np.ndarray)
            np.testing.assert_array_equal(la, lb)
    assert back.key == snap.key
    assert back.rng_state == snap.rng_state
    assert back.buffer["capacity"] == snap.buffer["capacity"]
    assert back.buffer["rng_state"] == snap.buffer["rng_state"]
    assert snap.buffer["x"] is not None  # two phases fill the buffer
    np.testing.assert_array_equal(back.buffer["x"], snap.buffer["x"])
    np.testing.assert_array_equal(back.buffer["y"], snap.buffer["y"])
    assert back.records == snap.records and len(back.records) == 2
    assert back.timeline == snap.timeline
    assert back.decision == snap.decision
    assert back.lane_state == snap.lane_state
    assert (back.eval_cursor, back.retrain_time, back.label_time,
            back.drift_events, back.clock) == (
        snap.eval_cursor, snap.retrain_time, snap.label_time,
        snap.drift_events, snap.clock)
    assert type(back.policy).__name__ == type(snap.policy).__name__
    assert type(back.policy).__module__.startswith("repro_torch.")


def test_aux_unpickles_without_torch(lane_snapshot):
    aux = snapshot_to_state(lane_snapshot)["aux"]
    assert aux.dtype == np.uint8
    loader = _NoTorchUnpickler(aux.tobytes())
    decoded = loader.load()
    assert decoded["clock"] == lane_snapshot.clock
    assert any(m.startswith("repro_torch.") for m in loader.modules)
    assert not any(m.split(".")[0] in ("torch", "jax", "repro")
                   for m in loader.modules)


def test_aux_refuses_a_tensor(lane_snapshot):
    import dataclasses

    bad = dataclasses.replace(lane_snapshot, timeline=[torch.zeros(1)])
    with pytest.raises(TypeError, match="no tensor"):
        snapshot_to_state(bad)


def test_empty_buffer_snapshot_roundtrip():
    snap = LaneSnapshot(
        key="k", params={"w": np.ones((2, 2), np.float32)},
        opt={"m": np.zeros((2, 2), np.float32)},
        buffer={"x": None, "y": None, "capacity": 16, "rng_state": {}},
        rng_state={}, policy=None, lane_state=(), decision=None,
        eval_cursor=1.0, retrain_time=0.0, label_time=0.0,
        drift_events=0, records=[], timeline=[], clock=2.0)
    state = snapshot_to_state(snap)
    assert state["buffer_x"].shape == (0,) and state["buffer_y"].dtype == \
        np.int64
    back = state_to_snapshot(state)
    assert back.buffer["x"] is None and back.buffer["y"] is None
    assert back.key == "k" and back.clock == 2.0
    assert back.buffer["capacity"] == 16
