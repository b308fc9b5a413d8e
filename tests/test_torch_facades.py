"""The port's legacy facades and the engine API around the kernels, held to
the JAX package: ``ContinuousLearningSystem`` (``core/cl_system.py``), the
deprecated ``core/scheduler.py`` shim and its aliases, the policies'
legacy ``initial_plan`` / ``next_phase``, ``partition_mesh`` row splits,
the ``Kernel`` protocol, the synchronous ``predict`` / ``label``, and the
``quantize=`` hook of ``ServingParamsCache`` under racing threads (the
reference's ``tests/test_cl_system.py``, ``tests/test_scheduler.py`` and
``tests/test_session.py`` kernel and cache tests). The facade's session
runs beside the reference's on the reference's dispatch fixture,
tolerances as in ``_torch_sessions.assert_parity``.
"""
import importlib
import sys
import threading

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _torch_sessions import (assert_parity, jax_pretrained,  # noqa: F401
                             one_torch_thread, port_stream)
from repro.configs.dacapo_pairs import RESNET18 as J_RESNET18
from repro.configs.dacapo_pairs import WIDERESNET50 as J_WIDERESNET50
from repro.core import allocation as jalloc
from repro.core.cl_system import ContinuousLearningSystem as JCLS
from repro.core.partition import partition_mesh as j_partition_mesh
from repro_torch.configs import dacapo_pairs as tcfg
from repro_torch.convert import params_from_numpy
from repro_torch.core import Kernel, SCHEDULERS
from repro_torch.core import allocation as talloc
from repro_torch.core.cl_system import ContinuousLearningSystem
from repro_torch.core.estimator import DaCapoEstimator
from repro_torch.core.kernel import (InferenceKernel, LabelingKernel,
                                     RetrainKernel, ServingParamsCache)
from repro_torch.core.partition import (RowMesh, forced_row_mesh,
                                        partition_mesh)
from repro_torch.data.stream import DriftStream, scenario
from repro_torch.models.registry import make_vision_model

HP = dict(n_t=32, n_l=16, c_b=128, epochs=1)


@pytest.fixture(scope="module")
def small_setup():
    return jax_pretrained(2, 10, 8)


def _facades(setup, allocator):
    _, tp, sp, tp_np, sp_np = setup
    ref = JCLS(J_RESNET18, J_WIDERESNET50, hp=jalloc.CLHyperParams(**HP),
               allocator=allocator, apply_mx_numerics=False, eval_fps=0.5)
    ref.set_pretrained(tp, sp)
    port = ContinuousLearningSystem(
        tcfg.RESNET18, tcfg.WIDERESNET50, hp=talloc.CLHyperParams(**HP),
        allocator=allocator, apply_mx_numerics=False, eval_fps=0.5,
        device="cpu")
    port.set_pretrained(params_from_numpy(tp_np, "cpu"),
                        params_from_numpy(sp_np, "cpu"))
    return ref, port


def test_cl_system_facade_matches_reference(small_setup):
    ref, port = _facades(small_setup, "dacapo-spatiotemporal")
    assert port.scheduler is port.session.allocator
    assert port.apply_mx is False
    assert port.student_cfg == tcfg.RESNET18.reduced()  # via the session
    assert (port.r_tsa, port.r_bsa) == (ref.r_tsa, ref.r_bsa)
    assert port.policy is port.session.policy
    want = ref.run(small_setup[0], duration=20.0)
    got = port.run(port_stream(small_setup), duration=20.0)
    assert_parity(got, want)
    ts = [t for t, _ in got.accuracy_timeline]
    assert ts == sorted(ts)
    bare = ContinuousLearningSystem.__new__(ContinuousLearningSystem)
    with pytest.raises(AttributeError):
        bare.anything  # no session yet (e.g. during unpickling)


def test_spatial_allocation_sized_for_fps(small_setup):
    ref, port = _facades(small_setup, "dacapo-spatial")
    assert 1 <= port.r_bsa < port.estimator.total_rows
    assert port.r_tsa + port.r_bsa == port.estimator.total_rows
    assert (port.r_tsa, port.r_bsa) == (ref.r_tsa, ref.r_bsa)


def test_facade_pretrains_on_its_device():
    sys_ = ContinuousLearningSystem(tcfg.RESNET18, tcfg.WIDERESNET50,
                                    apply_mx_numerics=False, device="cpu")
    sys_.pretrain(DriftStream(scenario("S1", 2), seed=0, img=24),
                  teacher_steps=1, student_steps=1, batch=4)
    assert sys_.student_params["head_w"].device == torch.device("cpu")


def _import_shim(name):
    sys.modules.pop(name, None)
    with pytest.warns(DeprecationWarning, match=name):
        return importlib.import_module(name)


def test_legacy_scheduler_shim():
    """Old imports and the legacy next_phase API keep working, but warn,
    and decide as the reference's shim does."""
    shim = _import_shim("repro_torch.core.scheduler")
    ref = _import_shim("repro.core.scheduler")
    assert shim.SCHEDULERS is talloc.ALLOCATORS is SCHEDULERS
    assert set(shim.SCHEDULERS) <= set(ref.SCHEDULERS)
    assert shim.PhasePlan is talloc.AllocationDecision
    assert shim.__all__ == ref.__all__
    for alias in ("SpatiotemporalScheduler", "SpatialScheduler",
                  "EkyaScheduler", "EOMUScheduler"):
        assert getattr(shim, alias).name == getattr(ref, alias).name
    plan = shim.PhasePlan(10, 4, 8, True, 2)  # legacy positional order
    assert plan.retrain_samples == 10 and plan.reset_buffer
    assert plan.total_label_samples == ref.PhasePlan(
        10, 4, 8, True, 2).total_label_samples
    plans = []
    for mod, hp in ((shim, talloc.CLHyperParams(v_thr=-0.05)),
                    (ref, jalloc.CLHyperParams(v_thr=-0.05))):
        sch = mod.SpatiotemporalScheduler(hp)
        with pytest.warns(DeprecationWarning, match="next_phase"):
            drifted = sch.next_phase(acc_valid=0.9, acc_label=0.5, t=1.0)
        with pytest.warns(DeprecationWarning, match="initial_plan"):
            first = sch.initial_plan()
        assert drifted.reset_buffer and first.retrain_samples == hp.n_t
        plans.append((drifted.retrain_samples, drifted.extra_label_samples,
                      first.label_samples))
    assert plans[0] == plans[1]


@pytest.mark.parametrize("shape,axis,rows_bsa",
                         [((8, 1), None, 3), ((8, 1), None, 0),
                          ((8, 1), None, 8), ((8, 1), "data", 7),
                          ((2, 4), "model", 1), ((1, 1), None, 1)])
def test_partition_mesh_row_split(shape, axis, rows_bsa):
    """The reference's row split on a fake mesh (one device repeated), and
    its fallbacks to time-sharing, shape for shape."""
    n = shape[0] * shape[1]
    jmesh = Mesh(np.array(jax.devices()[:1] * n).reshape(shape),
                 ("data", "model"))
    devices = np.empty(shape, dtype=object)
    devices.flat[:] = [torch.device("cpu")] * n
    mesh = RowMesh(devices, ("data", "model"))
    want = j_partition_mesh(jmesh, rows_bsa, row_axis=axis)
    got = partition_mesh(mesh, rows_bsa, row_axis=axis)
    assert got.time_shared == want.time_shared
    assert got.t_devices.shape == want.t_devices.shape
    assert got.b_devices.shape == want.b_devices.shape
    if got.time_shared:
        assert got.t_sa is mesh and got.b_sa is mesh


def test_forced_row_mesh_on_the_cpu():
    mesh = forced_row_mesh(3, "cpu")
    assert mesh.devices.shape == (3, 1)
    assert mesh.axis_names == ("data", "model")
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)


@pytest.fixture(scope="module")
def kernel_setup():
    est = DaCapoEstimator()
    model = make_vision_model(tcfg.RESNET18.reduced(), "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    x = np.random.default_rng(1).normal(size=(12, 24, 24, 3)).astype(
        np.float32)
    return est, model, params, x


def test_kernels_satisfy_the_protocol(kernel_setup):
    est, model, params, x = kernel_setup
    inf = InferenceKernel(model, tcfg.RESNET18, est, apply_mx=False)
    lab = LabelingKernel(model, tcfg.WIDERESNET50, est, apply_mx=False)
    ret = RetrainKernel(model, tcfg.RESNET18, est, talloc.CLHyperParams())
    for k, role in ((inf, "b_sa"), (lab, "t_sa"), (ret, "t_sa")):
        assert isinstance(k, Kernel) and k.role == role
    assert not isinstance(object(), Kernel)
    pred = inf.predict(params, x)
    assert isinstance(pred, np.ndarray) and pred.shape == (12,)
    assert np.all((0 <= pred) & (pred < tcfg.RESNET18.reduced().num_classes))
    y = lab.label(params, x, "mx6")
    assert isinstance(y, np.ndarray) and y.shape == (12,)
    assert y.dtype.kind == "i"
    assert np.array_equal(y, pred)  # one model, no MX: the same forward


def test_serving_cache_quantize_hook_counts_exactly(kernel_setup):
    """8 threads hammering one (tree, precision) through a custom
    ``quantize``: no counter increment lost, the callable run once, its
    return value served and the fill counted."""
    _, _, params, _ = kernel_setup
    cache = ServingParamsCache(maxsize=8)
    n_threads, per_thread = 8, 50
    start = threading.Barrier(n_threads)
    fills, served = [], []

    def fake_quantize(tree, precision):
        fills.append(precision)
        return {"q": precision}

    def worker():
        start.wait(timeout=10.0)
        for _ in range(per_thread):
            served.append(cache.get(params, "mx9", quantize=fake_quantize))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert cache.stats() == {"hits": 399, "misses": 1, "entries": 1}
    assert fills == ["mx9"] and cache.fills == 1
    assert all(s is served[0] for s in served) and served[0] == {"q": "mx9"}


def test_serving_cache_fill_not_under_cache_lock(kernel_setup):
    """A slow fill of one tree does not serialize a lookup of another: only
    the slot's own lock is held across a fill."""
    _, _, params, _ = kernel_setup
    params_b = {k: v for k, v in params.items()}  # another tree
    cache = ServingParamsCache(maxsize=8)
    entered, release = threading.Event(), threading.Event()
    order = []

    def slow_quantize(tree, precision):
        entered.set()
        release.wait(timeout=10.0)
        order.append("a")
        return {"tree": "a"}

    def fast_quantize(tree, precision):
        order.append("b")
        return {"tree": "b"}

    t = threading.Thread(
        target=lambda: cache.get(params, "mx6", quantize=slow_quantize))
    t.start()
    assert entered.wait(timeout=10.0)
    assert cache.get(params_b, "mx6", quantize=fast_quantize) == {
        "tree": "b"}
    assert order == ["b"]
    release.set()
    t.join(timeout=10.0)
    assert not t.is_alive()
    assert order == ["b", "a"]
    assert cache.stats() == {"hits": 0, "misses": 2, "entries": 2}
    assert cache.fills == 2
    assert cache.get(params, "mx6", quantize=slow_quantize) == {"tree": "a"}
    assert cache.stats()["hits"] == 1
