"""The port's checkpointing and fault runtime on the CPU:
``tests/test_checkpoint.py`` and ``tests/test_fault.py`` ported case for
case (torch tensors for the JAX arrays; the elastic restore onto
``forced_row_mesh(1, "cpu")``), then what is the port's own:

* a plain array tree crosses between the packages bit for bit in both
  directions — a reduced-ResNet18 params + momentum tree saved by the JAX
  ``CheckpointManager`` restores in the port, and the port's back in the
  JAX package; both write the same manifest ``leaves``;
* ``save`` takes its host copy before it returns: a CPU tensor or numpy
  leaf updated in place while the async writer runs does not reach the
  file;
* ``InjectedFailure`` is a ``RuntimeError``; ``elastic_data_axis`` on a
  2-row ``RowMesh``; a sharding over distinct devices raises.

Tolerances: exact (bitwise).
"""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.partition import RowMesh, forced_row_mesh
from repro_torch.core.sample_buffer import SampleBuffer
from repro_torch.runtime.elastic import (
    NamedSharding,
    PartitionSpec as P,
    elastic_data_axis,
    rehome_tree,
    reshard_tree,
    shardings_for,
)
from repro_torch.runtime.fault import (
    FailureInjector,
    Heartbeat,
    InjectedFailure,
    StragglerDetector,
    resilient_loop,
)
from repro_torch.tree import tree_leaves, tree_map


def _state(v=0.0):
    return {"params": {"w": torch.full((4, 4), v), "b": torch.zeros(4)},
            "step": torch.tensor(int(v), dtype=torch.int32)}


# ------------------------------------------------ tests/test_checkpoint.py
def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    state = _state(3.0)
    mgr.save(7, state)
    restored, manifest = mgr.restore(None, _state())
    assert manifest["step"] == 7
    np.testing.assert_array_equal(restored["params"]["w"],
                                  state["params"]["w"].numpy())
    assert isinstance(restored["params"]["w"], np.ndarray)


def test_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(float(s)))
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_async_save_then_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(5, _state(5.0))
    mgr.wait()
    restored, m = mgr.restore(None, _state())
    assert m["step"] == 5
    assert float(restored["params"]["w"][0, 0]) == 5.0


def test_no_tmp_dirs_left_behind(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, _state())
    leftovers = [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]
    assert leftovers == []


def test_close_flushes_inflight_async_save(tmp_path):
    with CheckpointManager(str(tmp_path), async_save=True) as mgr:
        mgr.save(9, _state(9.0))
    assert mgr.latest_step() == 9  # committed by __exit__ -> close()
    restored, m = mgr.restore(None, _state())  # manager usable after close
    assert m["step"] == 9
    assert float(restored["params"]["w"][0, 0]) == 9.0


def test_incomplete_manifest_is_invisible(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, _state(1.0))
    mgr.save(2, _state(2.0))
    torn = tmp_path / "step_0000000003"
    torn.mkdir()
    (torn / "shard_0.npz").write_bytes(b"garbage")
    assert mgr.all_steps() == [1, 2]
    assert mgr.latest_step() == 2
    restored, m = mgr.restore(None, _state())
    assert m["step"] == 2
    assert float(restored["params"]["w"][0, 0]) == 2.0
    (torn / "manifest.json").mkdir()
    assert mgr.latest_step() == 2


def test_sample_buffer_state_roundtrip():
    rng = np.random.default_rng(0)
    a = SampleBuffer(capacity=8, seed=11)
    for _ in range(5):
        a.update(rng.normal(size=(4, 3)).astype(np.float32),
                 rng.integers(0, 10, size=4))
    a.get_data(4, 2)
    state = a.state_dict()
    b = SampleBuffer(capacity=1, seed=99)
    b.load_state_dict(state)
    np.testing.assert_array_equal(a._x, b._x)
    np.testing.assert_array_equal(a._y, b._y)
    assert b.capacity == a.capacity
    for _ in range(3):
        da, db = a.get_data(6, 2), b.get_data(6, 2)
        for arr_a, arr_b in zip(da, db):
            np.testing.assert_array_equal(arr_a, arr_b)


def test_sample_buffer_state_dict_is_a_snapshot():
    a = SampleBuffer(capacity=4, seed=3)
    a.update(np.ones((2, 3), np.float32), np.zeros(2, np.int64))
    state = a.state_dict()
    a.update(np.full((2, 3), 7.0, np.float32), np.ones(2, np.int64))
    assert state["x"].shape[0] == 2
    b = SampleBuffer(capacity=4, seed=5)
    b.load_state_dict(state)
    assert b._x.shape[0] == 2
    a.reset()
    empty = a.state_dict()
    b.load_state_dict(empty)
    assert len(b) == 0 and b._x is None


def test_resilient_loop_survives_injected_failures(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)

    def step_fn(state, step):
        return {"params": tree_map(lambda x: x + 1.0, state["params"]),
                "step": state["step"] + 1}

    injector = FailureInjector(fail_at_steps=(7, 23))
    state = {"params": {"w": torch.zeros(2)}, "step": torch.tensor(0)}
    final, report = resilient_loop(
        step_fn, state, num_steps=30, checkpoint_manager=mgr,
        checkpoint_every=5, failure_injector=injector)
    assert report.final_step == 30
    assert report.restarts == 2
    assert float(final["params"]["w"][0]) == 30.0


def test_resilient_loop_gives_up_after_max_restarts(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)

    def bad_step(state, step):
        raise RuntimeError("always fails")

    with pytest.raises(RuntimeError):
        resilient_loop(bad_step, _state(), 10, mgr, checkpoint_every=5,
                       max_restarts=2)


def test_straggler_detector():
    sd = StragglerDetector(factor=3.0)
    assert not sd.observe(0, 0.1, 0.1)
    assert sd.observe(1, 1.0, 0.1)
    assert len(sd.events) == 1


def test_heartbeat_median():
    hb = Heartbeat()
    hb.beat()
    time.sleep(0.01)
    hb.beat()
    assert hb.median() > 0


def test_elastic_restore_new_sharding(tmp_path):
    """Saved unsharded, restored onto explicit shardings: tensors on the
    mesh's device."""
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    state = {"w": torch.arange(16.0).reshape(4, 4)}
    mgr.save(1, state)
    mesh = forced_row_mesh(1, "cpu")
    shardings = {"w": NamedSharding(mesh, P(None, None))}
    restored, _ = mgr.restore(None, state, shardings=shardings)
    assert isinstance(restored["w"], torch.Tensor)
    assert torch.equal(restored["w"], state["w"])
    assert restored["w"].device == shardings["w"].device


# ----------------------------------------------------- tests/test_fault.py
def test_injector_bare_step_fires_once():
    inj = FailureInjector(fail_at_steps=(3,))
    inj.maybe_fail(0)
    inj.maybe_fail(2)
    with pytest.raises(RuntimeError, match="step 3"):
        inj.maybe_fail(3)
    inj.maybe_fail(3)
    assert inj.failed == {3}


def test_injector_keyed_entry_targets_one_probe_site():
    inj = FailureInjector(fail_at_steps=[(3, 1)])
    for step in range(3):
        inj.maybe_fail(step, key=0)
        inj.maybe_fail(step, key=1)
    inj.maybe_fail(3, key=0)
    with pytest.raises(RuntimeError, match=r"step 3 \(key=1\)"):
        inj.maybe_fail(3, key=1)
    inj.maybe_fail(3, key=1)
    inj.maybe_fail(4, key=1)
    assert inj.failed == {(3, 1)}


def test_injector_bare_entry_hits_any_keyed_probe():
    inj = FailureInjector(fail_at_steps=(5,))
    with pytest.raises(RuntimeError, match=r"step 5 \(key=2\)"):
        inj.maybe_fail(5, key=2)
    inj.maybe_fail(5, key=0)
    assert inj.failed == {5}


def test_injector_mixed_entries():
    inj = FailureInjector(fail_at_steps=[2, (2, "a")])
    with pytest.raises(RuntimeError):
        inj.maybe_fail(2)
    with pytest.raises(RuntimeError):
        inj.maybe_fail(2, key="a")
    inj.maybe_fail(2, key="a")
    assert inj.failed == {2, (2, "a")}


def test_straggler_observe_needs_positive_median():
    sd = StragglerDetector(factor=2.0)
    assert not sd.observe(0, 10.0, 0.0)
    assert not sd.observe(1, 0.19, 0.1)
    assert sd.observe(2, 0.21, 0.1)
    assert sd.events == [{"step": 2, "duration": 0.21, "median": 0.1}]


def test_heartbeat_feeds_detector_rolling_median():
    hb = Heartbeat(window=4)
    for d in (1.0, 2.0, 3.0, 4.0, 5.0):
        hb.durations.append(d)
    assert len(hb.durations) == 5
    hb2 = Heartbeat(window=4)
    hb2.beat()
    for _ in range(6):
        hb2.beat()
    assert len(hb2.durations) <= 4


def _counting_step():
    calls = []

    def step_fn(state, step):
        calls.append(step)
        return {"w": state["w"] + 1.0}

    return step_fn, calls


def test_resilient_loop_restores_and_replays(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    step_fn, calls = _counting_step()
    inj = FailureInjector(fail_at_steps=(7,))
    final, report = resilient_loop(
        step_fn, {"w": torch.zeros(())}, num_steps=10,
        checkpoint_manager=mgr, checkpoint_every=5, failure_injector=inj)
    assert report.final_step == 10
    assert report.restarts == 1
    assert float(final["w"]) == 10.0
    assert calls == [0, 1, 2, 3, 4, 5, 6, 5, 6, 7, 8, 9]
    assert report.checkpointed_steps == [5, 10]


def test_resilient_loop_failure_before_first_checkpoint(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    step_fn, calls = _counting_step()
    inj = FailureInjector(fail_at_steps=(2,))
    final, report = resilient_loop(
        step_fn, {"w": torch.zeros(())}, num_steps=6,
        checkpoint_manager=mgr, checkpoint_every=4, failure_injector=inj)
    assert report.restarts == 1
    assert calls[:2] == [0, 1] and calls[2] == 0
    assert float(final["w"]) == 8.0
    assert report.final_step == 6


def test_resilient_loop_resumes_from_existing_checkpoint(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    step_fn, _ = _counting_step()
    resilient_loop(step_fn, {"w": torch.zeros(())}, num_steps=4,
                   checkpoint_manager=mgr, checkpoint_every=4)
    step_fn2, calls2 = _counting_step()
    final, report = resilient_loop(
        step_fn2, {"w": torch.zeros(())}, num_steps=8,
        checkpoint_manager=mgr, checkpoint_every=4)
    assert calls2 == [4, 5, 6, 7]
    assert float(final["w"]) == 8.0
    assert report.final_step == 8


# ------------------------------------------------------ the port's own
def test_injected_failure_is_a_runtime_error():
    assert issubclass(InjectedFailure, RuntimeError)
    inj = FailureInjector(fail_at_steps=[(1, 0)])
    with pytest.raises(InjectedFailure, match="injected node failure"):
        inj.maybe_fail(1, key=0)


def _jax_resnet18_state():
    """A reduced-ResNet18 params + momentum tree, made by the JAX package."""
    import jax

    from repro.configs.dacapo_pairs import RESNET18
    from repro.models.registry import make_vision_model

    params = make_vision_model(RESNET18.reduced()).init(
        jax.random.PRNGKey(3))
    momentum = jax.tree_util.tree_map(lambda p: 0.9 * p + 0.25, params)
    return {"params": params, "opt": momentum}


def _port_like():
    """The port's tree of the same model (its own init and key order)."""
    from repro_torch.configs.dacapo_pairs import RESNET18
    from repro_torch.models.registry import make_vision_model

    params = make_vision_model(RESNET18.reduced(), "cpu").init(
        torch.Generator().manual_seed(0))
    return {"params": params, "opt": tree_map(torch.zeros_like, params)}


def _by_path(tree):
    from repro_torch.checkpoint.manager import _flatten_with_paths

    return {k: np.asarray(v) for k, v in _flatten_with_paths(tree).items()}


def _manifest(directory, step):
    with open(os.path.join(directory, f"step_{step:010d}",
                           "manifest.json")) as f:
        return json.load(f)


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    import jax

    from repro.checkpoint import CheckpointManager as JCheckpointManager

    state = _jax_resnet18_state()
    JCheckpointManager(str(tmp_path / "jax"), async_save=False).save(
        4, state, metadata={"who": "jax"})
    like = _port_like()
    got, manifest = CheckpointManager(str(tmp_path / "jax")).restore(
        None, like)
    assert manifest["step"] == 4 and manifest["metadata"] == {"who": "jax"}
    assert list(got["params"]) == list(like["params"])  # the port's order
    want = _by_path(jax.tree_util.tree_map(np.asarray, state))
    have = _by_path(got)
    assert set(have) == set(want) and len(want) == 2 * 62
    for key, arr in want.items():
        assert have[key].dtype == arr.dtype and have[key].shape == arr.shape
        assert have[key].tobytes() == arr.tobytes(), key
    on_mesh, _ = CheckpointManager(str(tmp_path / "jax")).restore(
        4, like, shardings=shardings_for(
            forced_row_mesh(1, "cpu"),
            tree_map(lambda _: P(), like)))
    for a, b in zip(tree_leaves(on_mesh), tree_leaves(got)):
        assert isinstance(a, torch.Tensor) and np.array_equal(a.numpy(), b)


def test_port_checkpoint_restores_in_jax(tmp_path):
    import jax

    from repro.checkpoint import CheckpointManager as JCheckpointManager
    from repro_torch.convert import params_from_numpy

    jstate = _jax_resnet18_state()
    port_state = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), "cpu")
    CheckpointManager(str(tmp_path / "port"), async_save=False).save(
        6, port_state)
    JCheckpointManager(str(tmp_path / "jax"), async_save=False).save(
        6, jstate)
    got, manifest = JCheckpointManager(str(tmp_path / "port")).restore(
        None, jstate)
    assert manifest["step"] == 6 and manifest["num_processes"] == 1
    assert manifest["leaves"] == _manifest(tmp_path / "jax", 6)["leaves"]
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jstate)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    with np.load(tmp_path / "port" / "step_0000000006" / "shard_0.npz") as p, \
            np.load(tmp_path / "jax" / "step_0000000006" / "shard_0.npz") as j:
        assert p.files == j.files  # the same leaves in the same order


def test_save_takes_its_host_copy_before_returning(tmp_path, monkeypatch):
    """The async writer is held until the caller has updated a CPU tensor
    and a numpy leaf in place: the file holds the values at ``save``."""
    gate = threading.Event()
    savez = np.savez

    def held_savez(*args, **kwargs):
        assert gate.wait(30)
        return savez(*args, **kwargs)

    monkeypatch.setattr(np, "savez", held_savez)
    state = {"t": torch.zeros(1000), "a": np.zeros(1000, np.float32),
             "n": [torch.arange(4.0)]}
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, state)
    state["t"].add_(1.0)
    state["a"] += 1.0
    state["n"][0].mul_(0.0)
    gate.set()
    mgr.wait()
    got, _ = mgr.restore(1, state)
    assert not got["t"].any() and not got["a"].any()
    assert np.array_equal(got["n"][0], np.arange(4.0, dtype=np.float32))


def test_none_is_an_empty_subtree(tmp_path):
    """As in JAX, ``None`` holds no leaf and restores as ``None``."""
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    state = {"w": torch.ones(2), "skip": None, "l": [None, torch.zeros(1)]}
    mgr.save(1, state)
    assert _manifest(tmp_path, 1)["leaves"] == ["l/1", "w"]
    got, _ = mgr.restore(1, state)
    assert got["skip"] is None and got["l"][0] is None
    assert np.array_equal(got["l"][1], np.zeros(1, np.float32))


def test_elastic_data_axis_on_two_rows():
    mesh = forced_row_mesh(2, "cpu")
    shrunk = elastic_data_axis(mesh, 1)
    assert isinstance(shrunk, RowMesh)
    assert shrunk.devices.shape == (1, 1)
    assert shrunk.axis_names == mesh.axis_names
    assert shrunk.devices[0, 0] == torch.device("cpu")
    with pytest.raises(ValueError, match="no surviving rows"):
        elastic_data_axis(mesh, 2)


def test_reshard_onto_one_device_and_refusals():
    mesh = forced_row_mesh(2, "cpu")
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": torch.ones(3)}
    out = reshard_tree(tree, shardings_for(
        mesh, {"w": P("data", None), "b": P(None)}))
    assert torch.equal(out["w"], torch.from_numpy(tree["w"]))
    assert not np.shares_memory(out["w"].numpy(), tree["w"])
    assert out["b"].device == torch.device("cpu")
    assert torch.equal(rehome_tree(tree, mesh=mesh, spec_tree={
        "w": P(), "b": P()})["w"], out["w"])
    with pytest.raises(ValueError, match="does not have"):
        NamedSharding(mesh, P("pod"))
    with pytest.raises(ValueError, match="more axes"):
        reshard_tree({"b": torch.ones(3)},
                     {"b": NamedSharding(mesh, P(None, None))})
    devices = np.empty((2, 1), dtype=object)
    devices[:, 0] = [torch.device("cpu"), torch.device("meta")]
    split = NamedSharding(RowMesh(devices), P("data"))
    with pytest.raises(NotImplementedError, match="DeviceMesh"):
        reshard_tree({"w": np.zeros(4)}, {"w": split})
