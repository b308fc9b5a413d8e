"""The figure experiments (``repro_torch.experiments``) and the quickstart
(``examples/quickstart_torch.py``) against the JAX package's figure scripts
(``benchmarks/``) run live: the system table, the Orin estimators, the
power table, the hyper-parameters and streams at both sizes equal; Fig.
3's rows string for string; Table III's counts from shapes alone (the
reference's ``jax.eval_shape``, the port's ``meta`` device); Figs. 9, 11
and 12 turned into the same rows from the same session results; one live
session per estimator family from JAX-pretrained weights within the
session parity rules (``_torch_sessions.assert_parity``); and the
quickstart on the CPU."""
import dataclasses
import sys
import zlib
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_sessions import assert_parity, one_torch_thread  # noqa: F401
from repro.configs import dacapo_pairs as jcfg
from repro.core import allocation as jalloc
from repro.core import session as jsession
from repro.models.registry import make_vision_model as j_make_vision_model
from repro_torch.configs import dacapo_pairs as tcfg
from repro_torch.convert import params_from_numpy
from repro_torch.core import allocation as talloc
from repro_torch.core import session as tsession
from repro_torch.experiments import common as tcommon
from repro_torch.experiments import (fig3_flops, fig9_accuracy,
                                     fig11_temporal, fig12_extreme,
                                     table3_models)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "examples"))

from benchmarks import bench_fig3_flops  # noqa: E402
from benchmarks import bench_fig9_accuracy  # noqa: E402
from benchmarks import bench_fig11_temporal  # noqa: E402
from benchmarks import bench_fig12_extreme  # noqa: E402
from benchmarks import bench_table3_models  # noqa: E402
from benchmarks import common as bcommon  # noqa: E402

import quickstart_torch  # noqa: E402


def _named(rows):
    """Rows without their times: (name, derived)."""
    return [(name, derived) for name, _, derived in rows]


def _estimator(spec):
    """The spec's estimator instance (a class or factory called, as
    ``CLSystemSpec`` does)."""
    est = spec.estimator
    return (est() if isinstance(est, type) or not hasattr(est, "total_rows")
            else est)


def _same_estimator(got, want):
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert getattr(got, "mx_speedup", None) == getattr(want, "mx_speedup",
                                                       None)


def test_systems_power_and_estimators_equal():
    assert list(tcommon.SYSTEMS) == list(bcommon.SYSTEMS)
    for name, want in bcommon.SYSTEMS.items():
        got = tcommon.SYSTEMS[name]
        for field in dataclasses.fields(want):
            g, w = getattr(got, field.name), getattr(want, field.name)
            if field.name == "estimator":
                _same_estimator(_estimator(got), _estimator(want))
            elif dataclasses.is_dataclass(w):
                assert dataclasses.asdict(g) == dataclasses.asdict(w), field
            else:
                assert g == w, (name, field.name)
        assert got.device is None  # run_system gives it
    for power in ("high", "low"):
        _same_estimator(tcommon.orin_estimator(power),
                        bcommon.orin_estimator(power))
    _same_estimator(tcommon.OrinEstimator(), bcommon.OrinEstimator())
    assert tcommon.POWER_W == bcommon.POWER_W


@pytest.mark.parametrize("fast", [False, True], ids=["full", "fast"])
def test_hyper_parameters_and_streams_equal(fast, monkeypatch):
    monkeypatch.setattr(bcommon, "FAST", fast)
    assert (dataclasses.asdict(tcommon.default_hp(fast))
            == dataclasses.asdict(bcommon.default_hp()))
    for scen in ("S1", "S3", "ES1", "ES2"):
        got, want = tcommon.make_stream(scen, fast), bcommon.make_stream(scen)
        assert [dataclasses.asdict(s) for s in got.segments] == [
            dataclasses.asdict(s) for s in want.segments]
        assert (got.seed, got.img, got.fps) == (want.seed, want.img,
                                                want.fps)
        for g, w in zip(got.frames(37.0, 38.0), want.frames(37.0, 38.0)):
            np.testing.assert_array_equal(g, w)


def test_fig3_rows_equal():
    assert _named(fig3_flops.run()) == _named(bench_fig3_flops.run())


def test_table3_counts_from_shapes(monkeypatch):
    """Both sides count the six models at published widths from shapes
    alone: the reference from ``jax.eval_shape`` of ``init``, the port on
    the ``meta`` device; neither draws a full-width model."""

    class ShapesOnly:
        def __init__(self, cfg):
            self.model = j_make_vision_model(cfg)

        def init(self, key):
            return jax.eval_shape(self.model.init, key)

        def __getattr__(self, name):
            return getattr(self.model, name)

    monkeypatch.setattr(bench_table3_models, "make_vision_model", ShapesOnly)
    want = bench_table3_models.run()
    built = table3_models.build("meta")
    assert _named(table3_models.rows_of(built)) == _named(want)
    for name, (model, params, _) in built.items():
        ref = ShapesOnly(jcfg.VISION_MODELS[name])
        assert model.param_count(params) == ref.param_count(
            ref.init(jax.random.PRNGKey(0)))
        assert model.flops() == ref.flops()
        assert all(p.device.type == "meta"
                   for p in jax.tree_util.tree_leaves(
                       params, is_leaf=lambda x: isinstance(x,
                                                            torch.Tensor)))


def _stub(pkg_session, pkg_alloc):
    """A ``run_system`` stand-in for one package: the same results and
    phase records for the same (system, pair, scenario) in both."""

    def run_system(name, student, teacher, scen, duration=None, hp=None,
                   observers=(), **_):
        key = f"{name}/{student.name}/{teacher.name}/{scen}"
        rng = np.random.default_rng(zlib.crc32(key.encode()))
        records, retrain, label = [], 0.0, 0.0
        for i in range(int(rng.integers(3, 9))):
            retrain += float(rng.uniform(1, 10))
            label += float(rng.uniform(1, 10))
            decision = pkg_alloc.AllocationDecision(
                retrain_samples=48, valid_samples=8, label_samples=24,
                extra_label_samples=int(rng.integers(0, 2)) * 72)
            records.append(pkg_session.PhaseRecord(
                index=i, t=10.0 * (i + 1), acc_valid=float(rng.uniform()),
                acc_label=float(rng.uniform()),
                drift=bool(rng.integers(0, 2)), retrain_time=retrain,
                label_time=label, decision=decision, next_decision=decision))
        for rec in records:
            for observer in observers:
                observer(rec)
        return pkg_session.CLResult(
            name=name, accuracy_timeline=[],
            phase_log=[r.as_log_entry() for r in records],
            avg_accuracy=float(rng.uniform(0.2, 0.95)),
            retrain_time=retrain, label_time=label,
            drift_events=int(rng.integers(0, 6)), records=records)

    return run_system


@pytest.mark.parametrize("fig", ["fig9", "fig11", "fig12"])
def test_figure_rows_from_the_same_sessions(fig, monkeypatch):
    """With ``run_system`` returning the same results and phase records in
    both packages, every row's name and ``derived`` string is equal: the
    accuracy and drift rows, the ordering checks, Fig. 11's label
    fractions and its observer-fed count of boosted phases."""
    port, ref = {"fig9": (fig9_accuracy, bench_fig9_accuracy),
                 "fig11": (fig11_temporal, bench_fig11_temporal),
                 "fig12": (fig12_extreme, bench_fig12_extreme)}[fig]
    monkeypatch.setattr(port, "run_system", _stub(tsession, talloc))
    monkeypatch.setattr(ref, "run_system", _stub(jsession, jalloc))
    got, want = _named(port.run(fast=True, device="cpu")), _named(ref.run())
    assert got == want
    assert len(got) > 0


LIVE_S = 20.0  # virtual seconds of each live session


@pytest.fixture(scope="module")
def live_weights():
    """Teacher and student pretrained by the JAX package on the fast S1
    stream (fewer steps than the figures' own: parity needs the same
    weights, not good ones), and the same trees in the port."""
    fast, bcommon.FAST = bcommon.FAST, True
    try:
        stream = bcommon.make_stream("S1")
    finally:
        bcommon.FAST = fast
    rng = np.random.default_rng(0)
    tp = jsession.pretrain_model(
        j_make_vision_model(jcfg.WIDERESNET50.reduced()), stream, 4, 32, rng)
    sp = jsession.pretrain_model(
        j_make_vision_model(jcfg.RESNET18.reduced()), stream, 3, 32, rng,
        segments=stream.segments[:1], seed=8)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return (tp, sp), (params_from_numpy(as_np(tp), "cpu"),
                      params_from_numpy(as_np(sp), "cpu"))


@pytest.mark.parametrize("system", ["OrinHigh-EOMU", "DaCapo-Spatiotemporal"])
def test_live_run_system_parity(system, live_weights, monkeypatch):
    """One live session per estimator family: the Orin roofline in
    fractional rows with fp32 serving, and the DaCapo cycle model with MX6
    serving, each ``run_system``'s whole path in both packages from the
    same weights: phase count, drift events and ledgers equal (1e-6),
    ``avg_accuracy`` within 0.1."""
    (jtp, jsp), (ttp, tsp) = live_weights
    monkeypatch.setattr(bcommon, "FAST", True)
    monkeypatch.setitem(bcommon._PRETRAIN_CACHE,
                        (jcfg.RESNET18.name, jcfg.WIDERESNET50.name, "S1"),
                        (jtp, jsp))
    monkeypatch.setattr(tcommon, "pretrained", lambda *a, **k: (ttp, tsp))
    want = bcommon.run_system(system, jcfg.RESNET18, jcfg.WIDERESNET50, "S1",
                              duration=LIVE_S)
    got = tcommon.run_system(system, tcfg.RESNET18, tcfg.WIDERESNET50, "S1",
                             duration=LIVE_S, fast=True, device="cpu")
    assert_parity(got, want)


QUICK_S = 10.0  # virtual seconds of the quickstart's session here


def test_quickstart_runs_on_cpu(capsys, monkeypatch):
    """The quickstart's three demos on the CPU, its session cut to
    ``QUICK_S`` virtual seconds from two pretraining steps a model (the
    live parity tests above hold the session's numbers; phase 18 runs it
    whole on the card)."""
    pretrain, run = tsession.CLSession.pretrain, tsession.CLSession.run
    monkeypatch.setattr(
        tsession.CLSession, "pretrain",
        lambda self, stream, teacher_steps, student_steps, batch: pretrain(
            self, stream, 2, 2, batch))
    monkeypatch.setattr(
        tsession.CLSession, "run",
        lambda self, stream, duration=None, observers=(): run(
            self, stream, QUICK_S, observers))
    assert quickstart_torch.main(["--device", "cpu"]) == 0
    text = capsys.readouterr().out
    for line in ("mx4: matmul relative error", "train loss",
                 "prefill(16) + decode(1): logits (2, 256)",
                 "60s of S1: avg accuracy", "done."):
        assert line in text, text


def test_quickstart_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        quickstart_torch.main([])


def test_runner_prints_the_rows_and_fails_on_a_raise(capsys, monkeypatch):
    """``python -m repro_torch.experiments``: the CSV header, every row of
    the figures asked for, a line for each figure done; exit 1 when one
    raises, as ``benchmarks/run.py`` does."""
    from repro_torch.experiments import __main__ as runner

    assert runner.main(["--only", "table3,fig3", "--device", "meta"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    names = [line.split(",")[0] for line in lines[1:]
             if not line.startswith("#")]
    want = [name for name, _ in _named(bench_fig3_flops.run())]
    assert names == [f"table3/{n}" for n in jcfg.VISION_MODELS] + want
    assert "# fig3 done in" in "\n".join(lines)

    def broken(fast, device):
        calls = dict(figures(fast, device))
        calls["fig3"] = lambda: 1 / 0
        return calls

    figures = runner.figures
    monkeypatch.setattr(runner, "figures", broken)
    assert runner.main(["--only", "fig3", "--device", "meta"]) == 1
    assert "# fig3 FAILED" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        runner.main(["--only", "fig10"])
