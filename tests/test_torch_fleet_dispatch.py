"""The fleet's side of the port's dispatch and kernels, held to the JAX
package on the CPU: a phase plan's lane ledgers (``charge`` / ``dispatch``
with ``lane=``, ``dispatch_multi``, ``lane_time``, ``collect_all``) and
its traced events against the reference's on one script, in both dispatch
modes; ``label_fleet_async`` against ``label_async`` per burst and the
reference's labels; ``predict_fleet_async`` (one ``torch.func.vmap``
program over per-lane trees) against per-lane ``predict_async`` and the
reference's vmapped apply, for the reduced ResNet18 and ViT-B/32; the
attention kernel's vmap rule against an explicit loop over lanes, forward
and gradient; and ``flush_sinks_batched`` against per-lane flushes.

Weights: the reference's trace fixture recipe (``small_setup``: JAX
pretraining 10 / 8 steps on ``scenario("S1", 2)``), carried across with
``params_from_numpy``. Tolerances: ledgers, clocks and labels exactly;
logits within 1e-4 of the reference (fp32 summation order over a
different lowering) and within 1e-5 between the port's vmapped and
per-lane forwards (a vmapped convolution with per-lane weights runs as a
grouped convolution); the attention vmap rule exactly (it runs the same
function on the folded batch).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_sessions import jax_pretrained, one_torch_thread  # noqa: F401
from repro.configs import dacapo_pairs as jcfg
from repro.core import dispatch as jdispatch
from repro.core import estimator as jest
from repro.core import kernel as jkernel
from repro.core import trace as jtrace
from repro.models.registry import make_vision_model as j_make_vision_model
from repro_torch.configs import dacapo_pairs as tcfg
from repro_torch.convert import params_from_numpy
from repro_torch.core import dispatch as tdispatch
from repro_torch.core import estimator as test_
from repro_torch.core import trace as ttrace
from repro_torch.core.kernel import InferenceKernel, LabelingKernel
from repro_torch.core.session import _ScoreSink, flush_sinks_batched
from repro_torch.kernels import ops
from repro_torch.models.registry import make_vision_model
from repro_torch.tree import tree_map

MODES = ("sequential", "concurrent")


@pytest.fixture(scope="module")
def small_setup():
    return jax_pretrained(2, 10, 8)


def _frames(n, seed=1):
    return np.random.default_rng(seed).normal(size=(n, 24, 24, 3)).astype(
        np.float32)


# ---------------------------------------------------------------- plans --
def _run_script(pkg, trace_pkg, mode, traced):
    recorder = trace_pkg.TraceRecorder() if traced else None
    disp = pkg.KernelDispatcher(mode, recorder=recorder)
    plan = disp.begin_phase(1.5)
    plan.charge("t_sa", 0.25, lane=0, label="profile")
    plan.charge("t_sa", 0.125, lane=1, label="retrain", units=2.0)
    valid = plan.dispatch("b_sa", "valid", lambda: np.arange(3),
                          cost_s=0.1, lane=0, units=3.0)
    labels = plan.dispatch_multi(
        "t_sa", "label",
        lambda: [np.arange(2), np.arange(4), np.arange(1)],
        costs=[0.3, 0.7, 0.11], lanes=[0, 1, 2], units=[2.0, 4.0, 1.0])
    plan.charge("b_sa", 0.05, lane=2, label="score", units=1.0)
    plan.dispatch("b_sa", "acc_label", lambda: np.zeros(2), cost_s=0.2,
                  lane=1, units=2.0)
    plan.charge("t_sa", 0.0625)  # a bare fleet charge: no lane
    plan.pad_to(2.75)
    now = plan.now()
    end = plan.finish()
    lanes = {lane: (plan.lane_time("t_sa", lane), plan.lane_time("b_sa",
                                                                 lane))
             for lane in range(4)}
    plan.collect_all()
    out = dict(
        totals=dict(plan.totals), lane_totals=plan.lane_totals, lanes=lanes,
        now=now, end=end, t_tsa=plan.t_tsa, t_bsa=plan.t_bsa,
        programs=[(p.role, p.label, p.cost_s, p.lane) for p in plan.programs],
        collected=[p.handle.collect().tolist() for p in plan.programs],
        valid=valid.collect().tolist(),
        labels=[h.collect().tolist() for h in labels],
        counters=(disp.phases_dispatched, disp.programs_dispatched,
                  dict(disp.programs_by_label)))
    if traced:
        out["events"] = [
            {k: v for k, v in e.as_dict().items()
             if k not in ("wall_s", "path")}
            for e in recorder.trace.phases[0].events]
        out["phase"] = (recorder.trace.phases[0].end,
                        recorder.trace.phases[0].floor)
    return out


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("mode", MODES)
def test_lane_ledgers_match_reference(mode, traced):
    want = _run_script(jdispatch, jtrace, mode, traced)
    got = _run_script(tdispatch, ttrace, mode, traced)
    assert got == want
    # The fleet ledger is conserved across the lane ledgers (the bare
    # charge has no lane), and a fan of three counts one program.
    assert got["lanes"][3] == (0.0, 0.0)
    assert got["counters"][1] == 3 and got["counters"][2]["label"] == 1
    if traced:
        fans = [e["fan"] for e in got["events"] if e["label"] == "label"]
        assert fans == [3, 3, 3]


def test_dispatch_multi_splits_the_measured_wall(monkeypatch):
    """A fanned program's measured wall is split evenly over its lanes:
    the lanes' walls sum to the wall the clock read."""
    ticks = iter([10.0, 10.9, 0.0, 0.0])
    monkeypatch.setattr(tdispatch.time, "perf_counter", lambda: next(ticks))
    recorder = ttrace.TraceRecorder()
    plan = tdispatch.KernelDispatcher("concurrent",
                                      recorder=recorder).begin_phase(0.0)
    plan.dispatch_multi("t_sa", "label", lambda: [1, 2, 3],
                        costs=[0.1, 0.2, 0.3], lanes=[0, 1, 2])
    events = recorder.trace.phases[0].events
    assert [e.lane for e in events] == [0, 1, 2]
    walls = [e.wall_s for e in events]
    assert walls[0] == walls[1] == walls[2]
    assert sum(walls) == pytest.approx(0.9, abs=1e-12)
    with pytest.raises(ValueError, match="3 lanes"):
        plan.dispatch_multi("t_sa", "label", lambda: [1, 2],
                            costs=[0.1, 0.2, 0.3], lanes=[0, 1, 2])


def test_one_lane_plan_is_a_single_dispatch():
    """``dispatch_multi`` over one lane charges what ``dispatch`` does, and
    the lane ledger of a one-lane plan is the fleet ledger."""
    a = tdispatch.PhasePlan("sequential", 3.0)
    b = tdispatch.PhasePlan("sequential", 3.0)
    a.dispatch("t_sa", "label", lambda: np.ones(2), cost_s=0.7, lane=0)
    b.dispatch_multi("t_sa", "label", lambda: [np.ones(2)], costs=[0.7],
                     lanes=[0])
    assert a.totals == b.totals and a.lane_totals == b.lane_totals
    assert a.lane_time("t_sa", 0) == a.t_tsa and a.finish() == b.finish()


# -------------------------------------------------------------- kernels --
def test_label_fleet_async_matches_per_burst_and_reference(small_setup):
    """One microbatched pass over the combined burst: the labels of each
    burst alone (and the reference's), in fewer forwards."""
    _, tp, _, tp_np, _ = small_setup
    est = test_.DaCapoEstimator()
    kern = LabelingKernel(make_vision_model(tcfg.WIDERESNET50.reduced(),
                                            "cpu"),
                          tcfg.WIDERESNET50, est, apply_mx=True)
    jk = jkernel.LabelingKernel(
        j_make_vision_model(jcfg.WIDERESNET50.reduced()), jcfg.WIDERESNET50,
        jest.DaCapoEstimator(), apply_mx=True)
    params = params_from_numpy(tp_np, "cpu")
    x = _frames(40)
    bursts = [x[:12], x[12:30], x[30:]]
    kern.n_apply_calls = 0
    separate = [kern.label(params, b, "mx6", microbatch=16) for b in bursts]
    assert kern.n_apply_calls == 1 + 2 + 1
    kern.n_apply_calls = 0
    fused = kern.label_fleet_async(params, bursts, "mx6", microbatch=16)
    assert kern.n_apply_calls == 3  # ceil(40 / 16)
    want = jk.label_fleet_async(tp, bursts, "mx6", microbatch=16)
    for a, b, w in zip(separate, fused, want):
        assert np.array_equal(a, b.numpy())
        assert np.array_equal(b.numpy(), np.asarray(w))
    kern.n_apply_calls = 0
    solo = kern.label_fleet_async(params, bursts[:1], "mx6", microbatch=16)
    assert len(solo) == 1 and kern.n_apply_calls == 1
    assert np.array_equal(solo[0].numpy(), separate[0])
    assert kern.label_fleet_async(params, [], "mx6") == []


def _lane_trees(tree_np, n):
    """``n`` distinct student trees: the tree scaled by 1, 1.01, 1.02 …"""
    return [jax.tree_util.tree_map(
        lambda a, s=1.0 + 0.01 * i: (a * np.float32(s)).astype(a.dtype),
        tree_np) for i in range(n)]


@pytest.mark.parametrize("name", ["resnet18", "vit-b32"])
def test_predict_fleet_async_matches_per_lane_and_reference(small_setup,
                                                            name):
    jcfg_, tcfg_ = (jcfg.VISION_MODELS[name].reduced(),
                    tcfg.VISION_MODELS[name].reduced())
    jmodel = j_make_vision_model(jcfg_)
    model = make_vision_model(tcfg_, "cpu")
    if name == "resnet18":
        tree_np = small_setup[4]
    else:
        tree_np = jax.tree_util.tree_map(
            np.asarray, jmodel.init(jax.random.PRNGKey(3)))
    trees_np = _lane_trees(tree_np, 3)
    trees = [params_from_numpy(t, "cpu") for t in trees_np]
    x = _frames(24, seed=2)
    windows = [x[:9], x[9:13], x[13:]]  # ragged: zero-padded to 11
    kern = InferenceKernel(model, tcfg.VISION_MODELS[name],
                           test_.DaCapoEstimator(), apply_mx=False)
    kern.n_apply_calls = 0
    ops.reset_kernel_stats()
    fleet = kern.predict_fleet_async(trees, windows)
    assert kern.n_apply_calls == 1
    if name == "vit-b32":  # one attention call per layer for the fleet
        assert ops.kernel_stats()["flash_attention"] == {
            "plain": tcfg_.num_layers}
    per_lane = [kern.predict_async(p, w) for p, w in zip(trees, windows)]
    for f, p, w in zip(fleet, per_lane, windows):
        assert f.shape == (len(w),) and torch.equal(f, p)
    # Logits: the port's vmapped program against its per-lane forwards
    # and against the reference's vmapped apply.
    n_max = max(len(w) for w in windows)
    padded = np.stack([np.concatenate(
        [w, np.zeros((n_max - len(w),) + w.shape[1:], w.dtype)])
        for w in windows])
    stacked = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *trees_np)
    want = np.asarray(jax.vmap(jmodel.apply)(stacked, padded))
    with torch.no_grad():
        got = kern._apply_fleet[1](
            tree_map(lambda *leaves: torch.stack(leaves), *trees),
            torch.from_numpy(padded)).numpy()
        lanes = np.stack([model.apply(p, torch.from_numpy(w)).numpy()
                          for p, w in zip(trees, padded)])
    np.testing.assert_allclose(got, lanes, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    kern.n_apply_calls = 0
    solo = kern.predict_fleet_async(trees[:1], windows[:1])
    assert kern.n_apply_calls == 1 and torch.equal(solo[0], per_lane[0])
    assert kern.predict_fleet_async([], []) == []


def test_flush_sinks_batched_matches_per_lane_flush(small_setup):
    """Every lane's queued windows through one vmapped program: the same
    predictions per window as each lane's own fused flush."""
    model = make_vision_model(tcfg.RESNET18.reduced(), "cpu")
    kern = InferenceKernel(model, tcfg.RESNET18, test_.DaCapoEstimator(),
                           apply_mx=False)
    trees = [params_from_numpy(t, "cpu")
             for t in _lane_trees(small_setup[4], 3)]
    x = _frames(30, seed=4)
    y = np.zeros(30, np.int64)
    plans = [[(1.0, x[:5]), (2.0, x[5:9])], [(1.0, x[9:20])], []]

    def sinks():
        out = [_ScoreSink(kern, fuse=True) for _ in trees]
        for sink, tree, windows in zip(out, trees, plans):
            for t, w in windows:
                sink.add(t, w, y[:len(w)], 1.0, tree)
        return out

    per_lane = sinks()
    for sink in per_lane:
        sink.flush()
    batched = sinks()
    kern.n_apply_calls = 0
    flush_sinks_batched(kern, batched)
    assert kern.n_apply_calls == 1
    for a, b in zip(per_lane, batched):
        assert len(a._entries) == len(b._entries) and not b._pending
        for ea, eb in zip(a._entries, b._entries):
            assert ea[0] == eb[0] and torch.equal(ea[1], eb[1])
    # One live lane takes that sink's own flush path.
    solo = sinks()[:1]
    kern.n_apply_calls = 0
    flush_sinks_batched(kern, solo)
    assert kern.n_apply_calls == 1


# ------------------------------------------------------ attention vmap --
ATTN_CASES = {
    "vit": ((2, 17, 17, 4, 4, 16), dict(causal=False)),
    "gqa-causal-window": ((2, 12, 20, 4, 2, 8),
                          dict(causal=True, window=6, softcap=30.0,
                               q_offset=8)),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_vmap_rule_matches_a_loop(case):
    """``torch.func.vmap`` over lanes folds the lane axis into the batch
    axis of one call: forward and gradient equal to a loop over lanes, also
    with k / v shared by every lane, and one call counted per vmap."""
    (b, sq, skv, h, kv, d), opts = ATTN_CASES[case]
    gen = torch.Generator().manual_seed(0)
    lanes = 3

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).requires_grad_(True)

    q = rnd(lanes, b, sq, h, d)
    k, v = rnd(lanes, b, skv, kv, d), rnd(lanes, b, skv, kv, d)

    def f(q, k, v):
        return ops.flash_attention(q, k, v, **opts)

    ops.reset_kernel_stats()
    out = torch.func.vmap(f)(q, k, v)
    assert ops.kernel_stats()["flash_attention"] == {"plain": 1}
    loop = torch.stack([f(q[i], k[i], v[i]) for i in range(lanes)])
    assert torch.equal(out, loop)
    g = torch.randn(out.shape, generator=gen)
    got = torch.autograd.grad(out, (q, k, v), g)
    want = torch.autograd.grad(loop, (q, k, v), g)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    shared = torch.func.vmap(f, in_dims=(0, None, None))(q, k[0], v[0])
    assert torch.equal(shared, torch.stack([f(q[i], k[0], v[0])
                                            for i in range(lanes)]))
    inner = torch.func.vmap(f, in_dims=1, out_dims=1)(q, k, v)
    assert torch.equal(inner, torch.stack([f(q[:, j], k[:, j], v[:, j])
                                           for j in range(b)], 1))
