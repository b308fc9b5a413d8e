"""Parity of the port's CL session (plain PyTorch, CPU) with the JAX
package, run live on this host, plus the framework-free planners.

The session fixture is the JAX package's golden fixture
(tests/test_session.py): ``scenario("S1", 3)``, seed 5, 24 px,
``CLHyperParams(n_t=48, n_l=24, c_b=192, epochs=1)``, ``eval_fps=0.5``,
teacher and student pretrained by the JAX package and carried across.

Tolerances: phase count, drift events and the retraining and labeling
ledgers agree (ledgers within 1e-6), and so does every phase's virtual
clock and drift verdict for as long as both packages observe the same
accuracies: that is the same float arithmetic over the same decisions.
The accuracies themselves part after about ten phases: both retrain their
student in fp32, the reference's jitted SGD step is itself ~2e-4
(relative L2) off its own eager gradient (tests/test_torch_resnet.py),
and over tens of SGD steps borderline frames flip. The reference's
session with its SGD step run eagerly gives the port's drift sequence
(ROADMAP Queue 3). ``avg_accuracy`` agrees within 0.1: with ~45 scored
frames one flip moves it by ~0.02. The first phase, before any
retraining, agrees exactly.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.dacapo_pairs import RESNET18 as J_RESNET18
from repro.configs.dacapo_pairs import VISION_MODELS as J_MODELS
from repro.configs.dacapo_pairs import WIDERESNET50 as J_WIDERESNET50
from repro.core import allocation as jalloc
from repro.core import estimator as jest
from repro.core.session import CLSystemSpec as JCLSystemSpec
from repro.core.session import pretrain_model as j_pretrain_model
from repro.data.stream import DriftStream as JDriftStream
from repro.data.stream import scenario as j_scenario
from repro.models.registry import make_vision_model as j_make_vision_model
from repro_torch.configs import dacapo_pairs as tcfg
from repro_torch.convert import params_from_numpy
from repro_torch.core import allocation as talloc
from repro_torch.core import estimator as test_
from repro_torch.core.kernel import ServingParamsCache
from repro_torch.core.session import CLSystemSpec
from repro_torch.data.stream import DriftStream, scenario


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; one torch
    intra-op thread per worker keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden_setup():
    """JAX-pretrained weights (the golden recipe), carried across once."""
    stream = JDriftStream(j_scenario("S1", 3), seed=5, img=24)
    rng = np.random.default_rng(0)
    tp = j_pretrain_model(j_make_vision_model(J_WIDERESNET50.reduced()),
                          stream, 25, 32, rng)
    sp = j_pretrain_model(j_make_vision_model(J_RESNET18.reduced()),
                          stream, 15, 32, rng, segments=stream.segments[:1],
                          seed=8)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return stream, tp, sp, as_np(tp), as_np(sp)


RUNS = {
    "dcst-90s-fp32": ("dacapo-spatiotemporal", False, 90.0),
    "dcst-45s-mx6": ("dacapo-spatiotemporal", True, 45.0),
    "eomu-90s-fp32": ("eomu", False, 90.0),
}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_live_golden_fixture_parity(golden_setup, run):
    allocator, apply_mx, duration = RUNS[run]
    jstream, tp, sp, tp_np, sp_np = golden_setup
    jhp = jalloc.CLHyperParams(n_t=48, n_l=24, c_b=192, epochs=1)
    ref = JCLSystemSpec(student=J_RESNET18, teacher=J_WIDERESNET50,
                        allocator=allocator, hp=jhp, apply_mx=apply_mx,
                        seed=0, eval_fps=0.5).build()
    ref.set_pretrained(tp, sp)
    want = ref.run(jstream, duration=duration)

    hp = talloc.CLHyperParams(n_t=48, n_l=24, c_b=192, epochs=1)
    port = CLSystemSpec(student=tcfg.RESNET18, teacher=tcfg.WIDERESNET50,
                        allocator=allocator, hp=hp, apply_mx=apply_mx,
                        seed=0, eval_fps=0.5, device="cpu").build()
    port.set_pretrained(params_from_numpy(tp_np, "cpu"),
                        params_from_numpy(sp_np, "cpu"))
    got = port.run(DriftStream(scenario("S1", 3), seed=5, img=24),
                   duration=duration)

    assert len(got.phase_log) == len(want.phase_log) > 0
    assert got.drift_events == want.drift_events
    assert abs(got.retrain_time - want.retrain_time) < 1e-6
    assert abs(got.label_time - want.label_time) < 1e-6
    # While both observe the same accuracies they must make the same
    # decisions at the same virtual times.
    for g, w in zip(got.phase_log, want.phase_log):
        for key in ("t", "phase_start", "t_tsa", "t_bsa", "retrain_time",
                    "label_time"):
            assert abs(g[key] - w[key]) < 1e-6, (key, g, w)
        if (g["acc_valid"], g["acc_label"]) != (w["acc_valid"],
                                                w["acc_label"]):
            break
        assert g["drift"] == w["drift"], (g, w)
    first_g, first_w = got.phase_log[0], want.phase_log[0]
    assert (first_g["acc_valid"], first_g["acc_label"]) == (
        first_w["acc_valid"], first_w["acc_label"])
    assert abs(got.avg_accuracy - want.avg_accuracy) < 0.1


@pytest.mark.parametrize("name", ["resnet18", "resnet34", "wideresnet50",
                                  "wideresnet101"])
def test_estimator_matches_jax(name):
    for j, t in ((J_MODELS[name], tcfg.VISION_MODELS[name]),
                 (J_MODELS[name].reduced(),
                  tcfg.VISION_MODELS[name].reduced())):
        assert test_.vision_gemms(t, 3) == jest.vision_gemms(j, 3)
        je, te = jest.DaCapoEstimator(), test_.DaCapoEstimator()
        for rows in range(1, 17):
            for prec in ("mx4", "mx6", "mx9"):
                assert te.forward_time(t, rows, prec) == je.forward_time(
                    j, rows, prec)
                assert te.train_step_time(t, rows, prec, 16) == \
                    je.train_step_time(j, rows, prec, 16)
        for fps in (1.0, 30.0, 1e4):
            assert test_.spatial_allocation(te, t, fps, "mx6") == \
                jest.spatial_allocation(je, j, fps, "mx6")


def _script():
    """A feedback sequence with drifts, recoveries and accuracy drops."""
    accs = [(0.9, 0.9), (0.9, 0.6), (0.7, 0.7), (0.8, 0.85), (0.85, 0.5),
            (0.6, 0.62), (0.7, 0.72), (0.9, 0.9), (0.9, 0.91)]
    return [(v, label, bool(label - v < -0.1)) for v, label in accs]


@pytest.mark.parametrize("name", sorted(talloc.ALLOCATORS))
def test_allocator_decisions_match_jax(name):
    jhp = jalloc.CLHyperParams(n_t=48, n_l=24, c_b=192)
    thp = talloc.CLHyperParams(n_t=48, n_l=24, c_b=192)
    jp = jalloc.make_allocator(name, jhp).bind(jest.DaCapoEstimator(),
                                               J_RESNET18)
    tp = talloc.make_allocator(name, thp).bind(test_.DaCapoEstimator(),
                                               tcfg.RESNET18)
    assert tp.rows == jp.rows and tp.name == jp.name

    def flat(d):
        out = dataclasses.asdict(d)
        out["precisions"] = dataclasses.astuple(d.precisions)
        return out

    assert flat(tp.initial_decision()) == flat(jp.initial_decision())
    for i, (acc_v, acc_l, drifted) in enumerate(_script()):
        for flag in (drifted, None):  # engine verdict, then detector
            jd = jp.next_decision(jalloc.PhaseFeedback(
                acc_valid=acc_v, acc_label=acc_l, t=float(i), drifted=flag))
            td = tp.next_decision(talloc.PhaseFeedback(
                acc_valid=acc_v, acc_label=acc_l, t=float(i), drifted=flag))
            assert flat(td) == flat(jd)
            assert td.split().to_legacy() == td


# Every spelling of a fleet policy the reference's ``make_allocator``
# takes — the class, or a ready instance in each mode — and the fleet
# names, which its registry does not hold (it raises KeyError on them).
FLEET_SPELLINGS = ["class"] + [f"instance-{m}" for m in talloc.FLEET_MODES] \
    + ["name-fleet", "name-fleet-uniform"]


@pytest.mark.parametrize("spelling", FLEET_SPELLINGS)
def test_fleet_allocator_names_resolve(spelling):
    kind, _, arg = spelling.partition("-")

    def resolve(pkg):
        hp = pkg.CLHyperParams()
        if kind == "class":
            return pkg.make_allocator(pkg.FleetAllocator, hp)
        if kind == "instance":
            return pkg.make_allocator(pkg.FleetAllocator(hp, mode=arg), hp)
        return pkg.make_allocator(arg, hp)

    if kind == "name":
        for pkg in (jalloc, talloc):
            with pytest.raises(KeyError, match="unknown allocator"):
                resolve(pkg)
        return
    want, got = resolve(jalloc), resolve(talloc)
    assert isinstance(want, jalloc.FleetAllocator)
    assert isinstance(got, talloc.FleetAllocator)
    assert (got.mode, got.name) == (want.mode, want.name)


def test_serving_cache_keys_on_tree_identity(golden_setup):
    """A retrained tree is a new key; ``fit`` drops the superseded one."""
    _, _, _, tp_np, sp_np = golden_setup
    session = CLSystemSpec(student=tcfg.RESNET18, teacher=tcfg.WIDERESNET50,
                           hp=talloc.CLHyperParams(sgd_batch=4),
                           device="cpu").build()
    session.set_pretrained(params_from_numpy(tp_np, "cpu"),
                           params_from_numpy(sp_np, "cpu"))
    cache = session.inference.serving_cache
    old = session.student_params
    first = session.inference.serving_params(old, "mx6")
    assert session.inference.serving_params(old, "mx6") is first
    assert cache.stats()["hits"] == 1 and cache.fills == 1
    x, y = DriftStream(scenario("S1", 1), seed=5, img=24).frames(0.0, 1.0)
    new, _, n = session.retrain.fit(old, session._opt, x[:8], y[:8],
                                    np.random.default_rng(0))
    assert n == 2 and new is not old and len(cache) == 0
    second = session.inference.serving_params(new, "mx6")
    assert second is not first and cache.fills == 2
    assert ServingParamsCache(maxsize=0).get(old, "mx6") is not None
