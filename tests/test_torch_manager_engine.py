"""The port's manager tier on its own, on the CPU (exact unless said):

* a 1-shard manager, per-lane checkpointing on, is a bare
  ``FleetSession`` bit for bit (sequential dispatch, 2 streams, 24 s);
* ``parallel_shards=3`` equals serial stepping bit for bit — records,
  ``ManagerDecision`` stream, both ledgers, events and every lane's
  student weights — once plain (3 shards, ``static``, 16 s) and once with
  a shard lost at round 3 (2 shards, checkpoints, recovery, 24 s);
* under ``parallel_shards`` the merged trace equals the serial one phase
  for phase and event for event, and tracing changes no result
  (``tests/test_trace.py::test_manager_parallel_trace_deterministic``);
* a lane that detaches, goes through a checkpoint on disk and attaches
  again resumes bit for bit, its MX6 serving copy refilled from the
  restored tree (``test_snapshot_restore_requantizes_serving_copy``);
* a traced program's kernel path counts its own thread's calls only;
* a ``RuntimeError`` that is not an ``InjectedFailure``, raised inside a
  shard's step, propagates out of ``FleetManager.run`` (serial and
  pooled), is not recovered, and leaves no pipeline open.

Weights: the reduced pair pretrained by the port (10 / 8 steps of 32 on
``scenario("S1", 2)``, as ``tests/test_manager.py``'s fixture does).
"""
import dataclasses
import functools
import operator

import numpy as np
import pytest
import torch

from _torch_sessions import golden_streams, one_torch_thread  # noqa: F401
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.dacapo_pairs import RESNET18, WIDERESNET50
from repro_torch.core import mx as mx_lib
from repro_torch.core.allocation import CLHyperParams
from repro_torch.core.decision import ManagerDecision
from repro_torch.core.fleet import FleetSpec
from repro_torch.core.manager import (
    FleetManager,
    ManagerSpec,
    _template_snapshot,
    snapshot_to_state,
    state_to_snapshot,
)
from repro_torch.core.session import pretrain_model
from repro_torch.data.stream import DriftStream, scenario
from repro_torch.models.registry import make_vision_model
from repro_torch.runtime.fault import FailureInjector, InjectedFailure
from repro_torch.tree import tree_leaves

DURATION = 40.0
_RECORD_FIELDS = ("index", "t", "acc_valid", "acc_label", "drift",
                  "retrain_time", "label_time", "phase_start", "t_tsa",
                  "t_bsa", "spec_hits", "spec_misses", "stream")


@pytest.fixture(scope="module")
def pretrained():
    stream = DriftStream(scenario("S1", 2), seed=5, img=24)
    hp = CLHyperParams(n_t=32, n_l=16, c_b=128, epochs=1)
    rng = np.random.default_rng(0)
    tp = pretrain_model(make_vision_model(WIDERESNET50.reduced(), "cpu"),
                        stream, 10, 32, rng)
    sp = pretrain_model(make_vision_model(RESNET18.reduced(), "cpu"),
                        stream, 8, 32, rng, segments=stream.segments[:1],
                        seed=8)
    return hp, tp, sp


def _fleet_spec(hp, **kw):
    kw = {"fleet_mode": "drift-weighted", "apply_mx": False, "seed": 0,
          "eval_fps": 0.5, "device": "cpu", **kw}
    return FleetSpec(student=RESNET18, teacher=WIDERESNET50, hp=hp, **kw)


def _assert_records_identical(recs_a, recs_b):
    assert len(recs_a) == len(recs_b) > 0
    for a, b in zip(recs_a, recs_b):
        for field in _RECORD_FIELDS:
            assert getattr(a, field) == getattr(b, field), field
        assert a.decision == b.decision
        assert a.next_decision == b.next_decision


def _lane_params(mgr):
    """Every surviving lane's final student tree, by camera key."""
    return {lane.key: lane.params for shard in mgr.shards
            if shard.alive and shard.run is not None
            for lane in shard.run.lanes}


def _assert_manager_results_identical(a, b):
    (ra, pa), (rb, pb) = a, b
    assert ra.fleet_avg_accuracy == rb.fleet_avg_accuracy
    assert ra.ledger == rb.ledger
    assert ra.shard_ledgers == rb.shard_ledgers
    assert ra.rounds == rb.rounds
    assert ra.decisions == rb.decisions
    assert ra.events == rb.events
    assert set(ra.lane_results) == set(rb.lane_results) == set(pa) == set(pb)
    for key in ra.lane_results:
        la, lb = ra.lane_results[key], rb.lane_results[key]
        assert la.accuracy_timeline == lb.accuracy_timeline
        _assert_records_identical(la.records, lb.records)
        for x, y in zip(tree_leaves(pa[key]), tree_leaves(pb[key])):
            assert torch.equal(x, y)


def test_one_shard_manager_is_a_bare_fleet(pretrained, tmp_path):
    hp, tp, sp = pretrained
    bare = _fleet_spec(hp).build()
    bare.set_pretrained(tp, sp)
    ref = bare.run(golden_streams(port=True)[:2], duration=24.0)

    mgr = FleetManager(_fleet_spec(hp), n_shards=1,
                       checkpoint_dir=str(tmp_path), checkpoint_every=1)
    mgr.set_pretrained(tp, sp)
    res = mgr.run(golden_streams(port=True)[:2], duration=24.0)

    assert res.n_shards == 1
    got = res.shard_results[0]
    assert got.fleet_phase_log == ref.fleet_phase_log
    assert got.fleet_avg_accuracy == ref.fleet_avg_accuracy
    for lane, lane_ref in zip(got.streams, ref.streams):
        assert lane.accuracy_timeline == lane_ref.accuracy_timeline
        _assert_records_identical(lane.records, lane_ref.records)
    # The ledger adds phase by phase, left to right (Python 3.12's sum()
    # compensates its rounding, so it is not the same float sequence).
    exact = functools.reduce(operator.add,
                             (e["t_tsa"] for e in ref.fleet_phase_log), 0.0)
    assert res.ledger["t_tsa"] == exact
    assert res.shard_ledgers[0]["t_tsa"] == exact
    assert res.conservation_gap() == 0.0
    assert res.ledger["recovery_cost"] == 0.0
    assert all(isinstance(d, ManagerDecision) for d in res.decisions)
    assert [e.kind for e in res.events] == ["checkpoint"] * (res.rounds - 1)


def _run_manager(pretrained, workers, duration=DURATION, **kw):
    hp, tp, sp = pretrained
    mgr = ManagerSpec(fleet=_fleet_spec(hp), parallel_shards=workers,
                      **kw).build()
    mgr.set_pretrained(tp, sp)
    res = mgr.run(golden_streams(port=True), duration=duration)
    return mgr, (res, _lane_params(mgr))


@pytest.fixture(scope="module")
def plain_runs(pretrained):
    """3 shards, ``static``, no migration, 16 s (no event to wait for):
    serial untraced, serial traced and pooled traced (tracing changes no
    result, so the pooled traced run is held to the serial untraced
    one)."""
    out = {}
    for workers, trace in ((0, None), (0, True), (3, True)):
        out[workers, trace] = _run_manager(
            pretrained, workers, duration=16.0, n_shards=3,
            placement="static", migration=False, trace=trace)
    return out


def test_parallel_equals_serial_plain(plain_runs):
    (_, serial), (_, pooled) = plain_runs[0, None], plain_runs[3, True]
    assert serial[0].parallel_rounds == 0
    assert pooled[0].parallel_rounds > 0
    _assert_manager_results_identical(serial, pooled)


def test_parallel_equals_serial_with_failover(pretrained, tmp_path):
    """Scenario (a) of the parity file for 24 s: its failure and recovery
    fall in round 3."""
    runs = {}
    for workers in (0, 3):
        _, runs[workers] = _run_manager(
            pretrained, workers, duration=24.0, n_shards=2,
            checkpoint_dir=str(tmp_path / f"w{workers}"), checkpoint_every=2,
            failure_injector=FailureInjector([(3, 1)]), recovery_cost_s=2.0,
            migration=False)
    res = runs[3][0]
    assert res.parallel_rounds > 0
    kinds = [e.kind for e in res.events]
    assert kinds.count("fail") == 1 and "recover" in kinds
    assert res.shard_results[1] is None
    assert set(res.lane_results) == {"cam0", "cam1", "cam2"}
    _assert_manager_results_identical(runs[0], runs[3])


def test_parallel_trace_equals_serial(plain_runs):
    (mgr_serial, serial), (mgr_par, pooled) = (plain_runs[0, True],
                                               plain_runs[3, True])
    assert pooled[0].parallel_rounds > 0
    # Tracing changes no result.
    _assert_manager_results_identical(plain_runs[0, None][1], serial)
    tr_serial, tr_par = mgr_serial.trace, mgr_par.trace
    assert len(tr_serial.phases) == len(tr_par.phases) > 0
    for a, b in zip(tr_serial.phases, tr_par.phases):
        assert a.shard == b.shard
        assert a.start == b.start and a.end == b.end
        assert len(a.events) == len(b.events)
        for ea, eb in zip(a.events, b.events):
            # wall_s is measured host time; everything else is virtual.
            assert dataclasses.replace(ea, wall_s=0.0) \
                == dataclasses.replace(eb, wall_s=0.0)
    assert {ph.shard for ph in tr_par.phases} == {0, 1, 2}
    assert plain_runs[0, None][0].trace.phases == []


def test_checkpoint_restore_resumes_and_requantizes(pretrained, tmp_path):
    """Detach a lane at a phase boundary, write it to disk, read it back
    into a fresh snapshot and attach it: the rest of the run (24 s in all,
    MX6 serving) is the uninterrupted run's bit for bit, and the restored
    tree gets a fresh MX6 serving copy (a cache miss, never a stale
    hit)."""
    hp, tp, sp = pretrained
    spec = _fleet_spec(hp, apply_mx=True)
    sess_a = spec.build()
    sess_a.set_pretrained(tp, sp)
    run_a = sess_a.open_run(golden_streams(port=True)[:1], 24.0)
    while run_a.step():
        pass
    ref = run_a.finalize()
    run_a.close()

    sess = spec.build()
    sess.set_pretrained(tp, sp)
    run = sess.open_run(golden_streams(port=True)[:1], 24.0)
    try:
        for _ in range(3):
            assert run.step()
        snap, pipe = run.detach_lane(0)
        ckpt = CheckpointManager(str(tmp_path), async_save=True)
        ckpt.save(3, snapshot_to_state(snap))
        ckpt.wait()
        state, _ = ckpt.restore(None, snapshot_to_state(
            _template_snapshot(sess)))
        back = state_to_snapshot(state)
        cache = sess.inference.serving_cache
        misses = cache.stats()["misses"]
        lane = run.attach_lane(pipe, snapshot=back, own=True)
        assert cache.stats()["misses"] == misses + 1
        entry = cache._entries[id(lane.params)]
        assert entry[0] is lane.params
        (prec, slot), = entry[1].items()
        assert prec == "mx6" and lane.serving is slot.value
        expect = mx_lib.quantize_tree(lane.params, prec)
        for a, b in zip(tree_leaves(lane.serving), tree_leaves(expect)):
            assert torch.equal(a, b)
        while run.step():
            pass
        got = run.finalize()
        params = run.lanes[0].params
    finally:
        run.close()
    assert got.fleet_phase_log == ref.fleet_phase_log
    for lane_got, lane_ref in zip(got.streams, ref.streams):
        assert lane_got.accuracy_timeline == lane_ref.accuracy_timeline
        _assert_records_identical(lane_got.records, lane_ref.records)
    for a, b in zip(tree_leaves(params), tree_leaves(run_a.lanes[0].params)):
        assert torch.equal(a, b)


class _DeviceFault:
    """An injector stand-in whose probe of shard 1 at round 2 raises what a
    CUDA fault raises in torch: a plain ``RuntimeError``."""

    def maybe_fail(self, step, key=None):
        if (step, key) == (2, 1):
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")


@pytest.mark.parametrize("workers", [0, 2])
def test_device_error_propagates(pretrained, workers):
    hp, tp, sp = pretrained
    mgr = FleetManager(_fleet_spec(hp), n_shards=2, migration=False,
                       failure_injector=_DeviceFault(),
                       parallel_shards=workers)
    mgr.set_pretrained(tp, sp)
    with pytest.raises(RuntimeError, match="illegal memory access") as err:
        mgr.run(golden_streams(port=True)[:2], duration=DURATION)
    assert not isinstance(err.value, InjectedFailure)
    assert not [e for e in mgr.events if e.kind in ("fail", "recover")]
    assert all(shard.alive for shard in mgr.shards)
    assert all(shard.run._owned == [] for shard in mgr.shards)


def test_trace_paths_are_per_thread():
    """A traced program's kernel path counts only the calls made on the
    thread that issues it: a pooled shard's quantize on another thread
    does not reach this thread's totals (``kernel_stats`` still counts
    every call)."""
    import threading

    from repro_torch.core.trace import TraceRecorder
    from repro_torch.kernels import ops

    before = TraceRecorder.dominant_path(ops.thread_path_totals())
    assert before == ""
    mine = ops.thread_path_totals()
    stats = ops.kernel_stats().get("mx_quantize", {}).get("plain", 0)
    worker = threading.Thread(
        target=lambda: ops.mx_quantize(torch.ones(4, 32), "mx6"))
    worker.start()
    worker.join()
    assert ops.thread_path_totals() == mine
    assert TraceRecorder.dominant_path(mine) == ""
    assert ops.kernel_stats()["mx_quantize"]["plain"] == stats + 1
    ops.mx_quantize(torch.ones(4, 32), "mx6")
    assert TraceRecorder.dominant_path(mine) == "plain"
