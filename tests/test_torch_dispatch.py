"""The port of the JAX package's dispatch tests (``tests/test_dispatch.py``)
on the port's kernels and sessions (plain PyTorch, CPU): fused and
microbatched kernel entry points and their forward counts, retraining's
charged batches, the concurrent (max) and sequential (sum) phase clocks,
fused scoring, and mesh fission — a 1-row mesh time-shares, and an online
change of the row split re-fissions the mesh and re-binds every kernel
while an unchanged one does not. Where the acceptance is behaviour shared
with the reference (labels, forward counts, mesh splits, bindings,
ledgers), the reference runs beside the port on the same weights: the
reference's dispatch fixture (``scenario("S1", 2)``, seed 5, 24 px,
``CLHyperParams(n_t=32, n_l=16, c_b=128)``, teacher and student
pretrained by the JAX package 10 and 8 steps) carried across. Session
tolerances: ``_torch_sessions.assert_parity``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_sessions import (assert_parity, jax_pretrained,  # noqa: F401
                             one_torch_thread, port_stream, run_pair,
                             session_pair)
from repro.configs.dacapo_pairs import RESNET18 as J_RESNET18
from repro.configs.dacapo_pairs import WIDERESNET50 as J_WIDERESNET50
from repro.core import allocation as jalloc
from repro.core import estimator as jest
from repro.core import kernel as jkernel
from repro.core import session as jsession
from repro.core.partition import forced_row_mesh as j_forced_row_mesh
from repro.models.registry import make_vision_model as j_make_vision_model
from repro_torch.configs import dacapo_pairs as tcfg
from repro_torch.convert import params_from_numpy
from repro_torch.core import allocation as talloc
from repro_torch.core import estimator as test_
from repro_torch.core import session as tsession
from repro_torch.core.kernel import (InferenceKernel, LabelingKernel,
                                     RetrainKernel)
from repro_torch.core.partition import forced_row_mesh
from repro_torch.models.registry import make_vision_model
from repro_torch.tree import tree_leaves

SMALL_HP = dict(n_t=32, n_l=16, c_b=128, epochs=1)


@pytest.fixture(scope="module")
def small_setup():
    return jax_pretrained(2, 10, 8)


@pytest.fixture(scope="module")
def kernel_setup(small_setup):
    """The reduced ResNet18 on the pretrained student weights, 20 frames."""
    est = test_.DaCapoEstimator()
    model = make_vision_model(tcfg.RESNET18.reduced(), "cpu")
    params = params_from_numpy(small_setup[4], "cpu")
    x = np.random.default_rng(1).normal(size=(20, 24, 24, 3)).astype(
        np.float32)
    return est, model, params, x


def test_predict_batched_fuses_windows(kernel_setup):
    est, model, params, x = kernel_setup
    k = InferenceKernel(model, tcfg.RESNET18, est, apply_mx=False)
    windows = [x[:6], x[6:13], x[13:]]
    k.n_apply_calls = 0
    per_window = [k.predict(params, w) for w in windows]
    calls_pw = k.n_apply_calls
    k.n_apply_calls = 0
    fused = [p.numpy() for p in k.predict_batched(params, windows)]
    calls_f = k.n_apply_calls
    assert calls_pw == 3 and calls_f == 1  # fewer forwards, same preds
    for a, b in zip(per_window, fused):
        assert isinstance(a, np.ndarray) and np.array_equal(a, b)
    assert k.predict_batched(params, []) == []


def test_label_microbatch_equivalence(small_setup, kernel_setup):
    """``label`` with and without ``microbatch`` gives the same labels, in
    as many forwards as the reference issues; the labels equal the
    reference's on the same weights."""
    est, model, params, x = kernel_setup
    k = LabelingKernel(model, tcfg.WIDERESNET50, est, apply_mx=False)
    jk = jkernel.LabelingKernel(j_make_vision_model(J_RESNET18.reduced()),
                                J_WIDERESNET50, jest.DaCapoEstimator(),
                                apply_mx=False)
    labels, counts = [], []
    for kern, p in ((k, params), (jk, small_setup[2])):
        kern.n_apply_calls = 0
        full = kern.label(p, x, "mx9")
        one = kern.n_apply_calls
        micro = kern.label(p, x, "mx9", microbatch=8)
        counts.append((one, kern.n_apply_calls))
        assert isinstance(full, np.ndarray) and np.array_equal(full, micro)
        labels.append(full)
    assert counts[0] == counts[1] == (1, 1 + 3)  # ceil(20/8) chunks
    assert np.array_equal(labels[0], labels[1])


def test_retrain_fit_charges_only_executed_batches(kernel_setup):
    est, model, params, x = kernel_setup
    hp = talloc.CLHyperParams(sgd_batch=16, epochs=2)
    k = RetrainKernel(model, tcfg.RESNET18, est, hp)
    opt = k.init_state(params)
    rng = np.random.default_rng(0)
    # D_t smaller than one SGD batch: zero steps execute -> zero charged.
    xt, yt = x[:8], np.zeros(8, np.int32)
    new_params, _, n_batches = k.fit(params, opt, xt, yt, rng)
    assert n_batches == 0
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(new_params),
                                                 tree_leaves(params)))
    xt, yt = x[:16], np.zeros(16, np.int32)
    _, _, n_batches = k.fit(params, opt, xt, yt, rng)
    assert n_batches == 2


def _small_port(setup, **kw):
    _, _, _, tp_np, sp_np = setup
    session = tsession.CLSystemSpec(
        student=tcfg.RESNET18, teacher=tcfg.WIDERESNET50,
        hp=talloc.CLHyperParams(**SMALL_HP),
        allocator="dacapo-spatiotemporal", apply_mx=False, seed=0,
        eval_fps=0.5, device="cpu", **kw).build()
    session.set_pretrained(params_from_numpy(tp_np, "cpu"),
                           params_from_numpy(sp_np, "cpu"))
    return session


def test_concurrent_session_charges_max_per_phase(small_setup):
    """On a forced 2-row mesh, every phase's virtual time is exactly
    max(t_TSA, t_BSA), with both branches of the max exercised."""
    session = _small_port(small_setup, mesh=forced_row_mesh(2, "cpu"),
                          dispatch="concurrent")
    assert session.dispatcher.concurrent
    res = session.run(port_stream(small_setup), duration=20.0)
    assert len(res.records) >= 3
    for rec in res.records:
        dt = rec.t - rec.phase_start
        assert dt == pytest.approx(max(rec.t_tsa, rec.t_bsa), rel=1e-12)
        assert rec.t_tsa > 0.0 and rec.t_bsa > 0.0
    assert any(r.t_bsa > r.t_tsa for r in res.records)
    assert any(r.t_tsa > r.t_bsa for r in res.records)
    # Phase 0: empty buffer -> no retraining; t_TSA is labeling alone.
    rec0 = res.records[0]
    d0 = rec0.decision
    expect_tsa = (d0.total_label_samples
                  * session.labeling.time_per_sample(
                      d0.rows_tsa, d0.precisions.labeling))
    assert rec0.t_tsa == pytest.approx(expect_tsa, rel=1e-12)
    assert res.avg_accuracy > 0.0
    ts = [t for t, _ in res.accuracy_timeline]
    assert ts == sorted(ts)


def test_sequential_session_charges_tsa_chain(small_setup):
    session = _small_port(small_setup)
    assert not session.dispatcher.concurrent
    res = session.run(port_stream(small_setup), duration=20.0)
    for rec in res.records:
        assert rec.t - rec.phase_start == pytest.approx(rec.t_tsa, rel=1e-12)


def test_concurrent_fuses_score_windows(small_setup):
    """Concurrent dispatch batches each phase's score windows into one
    forward: fewer inference forwards than sequential on the same run."""
    counts = {}
    for mode in ("sequential", "concurrent"):
        session = _small_port(small_setup, dispatch=mode)
        session.run(port_stream(small_setup), duration=10.0)
        counts[mode] = session.inference.n_apply_calls
    assert counts["concurrent"] < counts["sequential"]


def test_single_row_mesh_degenerates_to_time_sharing(small_setup):
    """A 1-row mesh cannot be fissioned: both packages fall back to
    time-sharing instead of calling partition_mesh on it, and run alike."""
    ref, port, want, got = run_pair(
        small_setup, 10.0, SMALL_HP, allocator="dacapo-spatiotemporal",
        apply_mx=False, jkw=dict(mesh=j_forced_row_mesh(1)),
        tkw=dict(mesh=forced_row_mesh(1, "cpu")))
    for s in (ref, port):
        assert s._mesh_split(8) == 0
        assert s.partition.time_shared
        assert s.inference.submesh is None and s.labeling.submesh is None
    assert port.inference._device is None
    assert_parity(got, want)


def _scripted_rows_policy(alloc, script):
    """``tests/test_dispatch.py::ScriptedRowsPolicy`` over either package's
    allocation module: replays a script of rows_bsa values."""

    class ScriptedRowsPolicy(alloc.AllocationPolicy):
        name = "scripted-rows"

        def __init__(self, hp):
            super().__init__(hp)
            self._script = list(script)

        def _scripted(self):
            if len(self._script) > 1:
                rows_bsa = self._script.pop(0)
            else:
                rows_bsa = self._script[0]  # hold the last split forever
            d = self._decision(self.hp.n_t)
            total = self._rows[0] + self._rows[1]
            return dataclasses.replace(d, rows_tsa=total - rows_bsa,
                                       rows_bsa=rows_bsa)

        def initial_decision(self):
            return self._scripted()

        def next_decision(self, feedback):
            return self._scripted()

    return ScriptedRowsPolicy(alloc.CLHyperParams(**SMALL_HP))


def test_online_repartition_rebinds_kernels(small_setup, monkeypatch):
    """A policy that moves rows between T-SA and B-SA mid-run re-fissions
    the mesh and re-binds every kernel; an unchanged split does not. The
    port re-partitions exactly where the reference does."""
    calls = {}
    for pkg in (jsession, tsession):
        real = pkg.partition_mesh
        calls[pkg] = []
        monkeypatch.setattr(pkg, "partition_mesh",
                            lambda mesh, want, real=real, log=calls[pkg]:
                            log.append(want) or real(mesh, want))
    # 16 estimator rows onto a 4-row mesh: 8 -> 2 mesh rows, 12 -> 3.
    ref, port = session_pair(
        small_setup, SMALL_HP, apply_mx=False,
        jkw=dict(mesh=j_forced_row_mesh(4),
                 allocator=_scripted_rows_policy(jalloc, [8, 8, 12])),
        tkw=dict(mesh=forced_row_mesh(4, "cpu"),
                 allocator=_scripted_rows_policy(talloc, [8, 8, 12])))
    seen = {}
    for s in (ref, port):
        seen[s] = []
        s.add_observer(lambda rec, s=s: seen[s].append(
            (rec.decision.rows_bsa, s.partition, s.inference.submesh,
             s.labeling.submesh, s.retrain.submesh)))
    n_before = {pkg: len(log) for pkg, log in calls.items()}
    want = ref.run(small_setup[0], duration=16.0)
    got = port.run(port_stream(small_setup), duration=16.0)
    assert len(got.records) == len(want.records) >= 4
    (rows0, part0, inf0, lab0, ret0), (rows1, part1, inf1, lab1, ret1), \
        (rows2, part2, inf2, lab2, ret2) = seen[port][:3]
    assert (rows0, rows1, rows2) == (8, 8, 12)
    # Unchanged split: the exact same partition object, no new fission.
    assert part1 is part0 and inf1 is inf0
    # Changed split: new partition, every kernel re-bound.
    assert part2 is not part1
    assert inf2 is part2.b_sa and lab2 is part2.t_sa and ret2 is part2.t_sa
    assert part0.b_sa.devices.shape[0] == 2  # 8/16 of 4 rows
    assert part2.b_sa.devices.shape[0] == 3  # 12/16 of 4 rows
    assert part2.t_sa.devices.shape[0] == 1

    def layout(s):
        return [(r, p.time_shared, p.t_sa.devices.shape, p.b_sa.devices.shape,
                 i.devices.shape, la.devices.shape, re.devices.shape)
                for r, p, i, la, re in seen[s]]

    assert layout(port) == layout(ref)
    new = {pkg: log[n_before[pkg]:] for pkg, log in calls.items()}
    assert new[tsession] == new[jsession]
    w_offline = port._mesh_split(port.r_bsa)
    assert len(new[tsession]) == (0 if w_offline == 2 else 1) + 1
    assert_parity(got, want)
