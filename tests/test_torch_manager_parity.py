"""The port's ``FleetManager`` against the JAX package's, run live on the
CPU from one description, on ``tests/test_manager.py``'s fixture: its
pretrained weights (``jax_pretrained(2, 10, 8)``, carried across), the
S1 / S3 / ES1 streams (seeds 5 / 6 / 7, 24 px), 40 s of virtual time and
``CLHyperParams(n_t=32, n_l=16, c_b=128, epochs=1)``. Two scenarios, each
run once per package in a module fixture:

(a) 2 shards, 3 streams, ``FailureInjector([(3, 1)])`` (shard 1 lost at
    round 3), per-lane checkpoints every 2 rounds under a temporary
    directory, ``recovery_cost_s=2.0``, no migration;
(b) 2 shards, 3 streams, the ``estimator`` placement policy with
    ``migration_cost_s=0.5`` (the policy's and the ledger's) and
    ``oversub_limit=10``, and one camera (ES1, seed 9) due at t=10.

Tolerances: the same ``ManagerEvent`` kinds, rounds, shards, keys and
details, each event's clock within 1e-6; the same ``PlacementAction``
stream and the same live-shard pattern and row split in every
``ManagerDecision``; the manager's and every shard's ledger within 1e-6,
``conservation_gap`` at most 1e-9 in both; per lane the phase count, drift
events and retraining / labeling ledgers within 1e-6, and
``avg_accuracy`` within 0.02 (the fleet parity files' limit).
"""
import dataclasses

import pytest

from _torch_sessions import (golden_streams, jax_pretrained,  # noqa: F401
                             one_torch_thread)
from repro.configs.dacapo_pairs import RESNET18 as J_RESNET18
from repro.configs.dacapo_pairs import WIDERESNET50 as J_WIDERESNET50
from repro.core import allocation as jalloc
from repro.core import fleet as jfleet
from repro.core import manager as jmanager
from repro.data.stream import DriftStream as JDriftStream
from repro.data.stream import scenario as j_scenario
from repro.runtime import fault as jfault
from repro_torch.configs import dacapo_pairs as tcfg
from repro_torch.convert import params_from_numpy
from repro_torch.core import allocation as talloc
from repro_torch.core import fleet as tfleet
from repro_torch.core import manager as tmanager
from repro_torch.data.stream import DriftStream, scenario
from repro_torch.runtime import fault as tfault

HP = dict(n_t=32, n_l=16, c_b=128, epochs=1)
DURATION = 40.0
ACC_TOL = 0.02


@pytest.fixture(scope="module")
def golden():
    return jax_pretrained(2, 10, 8)


def _manager_pair(golden, **kw):
    """The reference's manager and the port's (CPU) from one description;
    ``kw`` goes to both ``FleetManager``s (``failure_injector`` is given
    as its list of entries)."""
    _, tp, sp, tp_np, sp_np = golden
    entries = kw.pop("fail_at", None)
    fleet = dict(fleet_mode="drift-weighted", apply_mx=False, seed=0,
                 eval_fps=0.5)
    ref = jmanager.FleetManager(
        jfleet.FleetSpec(student=J_RESNET18, teacher=J_WIDERESNET50,
                         hp=jalloc.CLHyperParams(**HP), **fleet),
        failure_injector=(None if entries is None
                          else jfault.FailureInjector(entries)),
        **{**kw, "checkpoint_dir": kw.get("checkpoint_dir") and
           str(kw["checkpoint_dir"] / "ref")})
    ref.set_pretrained(tp, sp)
    port = tmanager.FleetManager(
        tfleet.FleetSpec(student=tcfg.RESNET18, teacher=tcfg.WIDERESNET50,
                         hp=talloc.CLHyperParams(**HP), device="cpu",
                         **fleet),
        failure_injector=(None if entries is None
                          else tfault.FailureInjector(entries)),
        **{**kw, "checkpoint_dir": kw.get("checkpoint_dir") and
           str(kw["checkpoint_dir"] / "port")})
    port.set_pretrained(params_from_numpy(tp_np, "cpu"),
                        params_from_numpy(sp_np, "cpu"))
    return ref, port


@pytest.fixture(scope="module")
def failover(golden, tmp_path_factory):
    """Scenario (a), once per package."""
    ckpt = tmp_path_factory.mktemp("ckpt")
    ref, port = _manager_pair(
        golden, n_shards=2, checkpoint_dir=ckpt, checkpoint_every=2,
        fail_at=[(3, 1)], recovery_cost_s=2.0, migration=False)
    want = ref.run(golden_streams(port=False), duration=DURATION)
    got = port.run(golden_streams(port=True), duration=DURATION)
    return got, want, ckpt


@pytest.fixture(scope="module")
def placement(golden):
    """Scenario (b), once per package."""
    cost = 0.5
    ref, port = _manager_pair(
        golden, n_shards=2, placement="estimator",
        placement_kwargs={"migration_cost_s": cost, "oversub_limit": 10.0},
        migration=True, migration_cooldown=2, migration_cost_s=cost)
    want = ref.run(golden_streams(port=False), duration=DURATION,
                   admissions=[(10.0, "late", JDriftStream(
                       j_scenario("ES1", 2), seed=9, img=24))])
    got = port.run(golden_streams(port=True), duration=DURATION,
                   admissions=[(10.0, "late", DriftStream(
                       scenario("ES1", 2), seed=9, img=24))])
    return got, want


def _near(a, b, tol=1e-6):
    return abs(a - b) <= tol


def assert_manager_parity(got, want):
    """The rules of the module docstring."""
    assert got.rounds == want.rounds > 0
    assert len(got.events) == len(want.events)
    for g, w in zip(got.events, want.events):
        assert (g.round, g.kind, g.shard, g.key, g.to_shard, g.detail) == (
            w.round, w.kind, w.shard, w.key, w.to_shard, w.detail), (g, w)
        assert _near(g.t, w.t), (g, w)
    assert len(got.decisions) == len(want.decisions) == got.rounds
    for g, w in zip(got.decisions, want.decisions):
        assert [dataclasses.astuple(p) for p in g.placements] == [
            dataclasses.astuple(p) for p in w.placements]
        assert [None if d is None else (d.spatial.rows_tsa,
                                        d.spatial.rows_bsa, d.n_lanes)
                for d in g.shards] == [
            None if d is None else (d.spatial.rows_tsa, d.spatial.rows_bsa,
                                    d.n_lanes) for d in w.shards]
    assert set(got.ledger) == set(want.ledger)
    for key in want.ledger:
        assert _near(got.ledger[key], want.ledger[key]), key
    assert len(got.shard_ledgers) == len(want.shard_ledgers)
    for g, w in zip(got.shard_ledgers, want.shard_ledgers):
        assert _near(g["t_tsa"], w["t_tsa"]) and _near(g["t_bsa"],
                                                       w["t_bsa"])
    assert got.conservation_gap() <= 1e-9
    assert want.conservation_gap() <= 1e-9
    assert [r is None for r in got.shard_results] == [
        r is None for r in want.shard_results]
    assert set(got.lane_results) == set(want.lane_results)
    for key, w in want.lane_results.items():
        g = got.lane_results[key]
        assert len(g.records) == len(w.records) > 0, key
        assert g.drift_events == w.drift_events, key
        assert _near(g.retrain_time, w.retrain_time), key
        assert _near(g.label_time, w.label_time), key
        for rg, rw in zip(g.records, w.records):
            for field in ("t", "phase_start", "t_tsa", "t_bsa"):
                assert _near(getattr(rg, field), getattr(rw, field)), field
        assert abs(g.avg_accuracy - w.avg_accuracy) < ACC_TOL, key
    assert abs(got.fleet_avg_accuracy - want.fleet_avg_accuracy) < ACC_TOL


def test_failover_matches_reference(failover):
    got, want, _ = failover
    assert_manager_parity(got, want)


def test_failover_recovers_from_checkpoints(failover):
    """The reference's recovery assertions (``tests/test_manager.py::
    test_shard_loss_recovers_from_checkpoints``) on the port's run."""
    got, _, ckpt = failover
    kinds = [e.kind for e in got.events]
    assert kinds.count("fail") == 1 and "recover" in kinds
    assert got.shard_results[1] is None and got.shard_results[0] is not None
    assert set(got.lane_results) == {"cam0", "cam1", "cam2"}
    recoveries = [p for d in got.decisions for p in d.placements
                  if p.kind == "recover"]
    assert recoveries and all(p.from_shard == 1 and p.to_shard == 0
                              and p.reason == "restored from checkpoint"
                              for p in recoveries)
    assert got.ledger["recovery_cost"] == 2.0 * len(recoveries)
    assert got.ledger["total"] == pytest.approx(
        got.ledger["t_tsa"] + got.ledger["recovery_cost"], rel=1e-12)
    lanes = sorted(p.name for p in (ckpt / "port").iterdir())
    assert lanes == ["lane_cam0", "lane_cam1", "lane_cam2"]
    for lane in lanes:  # max_to_keep=2, every step committed
        steps = sorted(p.name for p in (ckpt / "port" / lane).iterdir())
        assert len(steps) <= 2 and all(s.startswith("step_") and
                                       not s.endswith(".tmp") for s in steps)


def test_placement_matches_reference(placement):
    got, want = placement
    assert_manager_parity(got, want)


def test_placement_admits_and_migrates(placement):
    got, _ = placement
    kinds = [p.kind for d in got.decisions for p in d.placements]
    assert kinds.count("admit") == 1 and "migrate" in kinds
    assert "late" in got.lane_results
    late = got.lane_results["late"]
    assert late.records[0].phase_start >= 10.0
    assert got.ledger["migration_cost"] == 0.5 * kinds.count("migrate")
    assert got.ledger["total"] == pytest.approx(
        got.ledger["t_tsa"] + got.ledger["migration_cost"], rel=1e-12)
