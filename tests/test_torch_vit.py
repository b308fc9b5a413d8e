"""Parity of the port's ViT-B/32 / ViT-B/16 (plain PyTorch, CPU) with the
JAX package, on weights initialized by JAX and carried across as numpy, and
of the DC-ST session with the paper's second Table III pair (ViT-B/32
student, ViT-B/16 teacher) run live by both packages.

Tolerances: the weight converter is bit-exact. Forward logits of the
reduced twins within ``atol = rtol = 1e-4`` (fp32 summation order,
through the attention's plain version; measured ≤ 1.6e-6 on logits of
magnitude ≤ 2.6) with equal argmax. The cross-entropy gradient within
1e-4 relative L2 on every leaf (measured ≤ 1.4e-6). FLOP and parameter counts
equal, and within 2 % of Table III at full width. The sessions: phase
count, drift events and virtual-clock ledgers within 1e-6, and
``avg_accuracy`` within 0.1 (the limit of the ResNet session's parity
test, ``tests/test_torch_session.py``); over 45 s both packages also
observe the same accuracies in every phase on this host.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import dacapo_pairs as jcfg
from repro.core import allocation as jalloc
from repro.core import estimator as jest
from repro.core.session import CLSystemSpec as JCLSystemSpec
from repro.core.session import pretrain_model as j_pretrain_model
from repro.data.stream import DriftStream as JDriftStream
from repro.data.stream import scenario as j_scenario
from repro.models import vit as jvit
from repro.models.registry import make_vision_model as j_make_vision_model
from repro_torch.configs import dacapo_pairs as tcfg
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import allocation as talloc
from repro_torch.core import estimator as test_
from repro_torch.core.session import CLSystemSpec
from repro_torch.data.stream import DriftStream, scenario
from repro_torch.kernels import mx_quantize as tmxq
from repro_torch.kernels import ops as tops
from repro_torch.models import vit as tvit
from repro_torch.models.registry import make_vision_model

NAMES = ["vit-b32", "vit-b16"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread per test worker process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _carried(name, seed=0):
    jc = jcfg.VISION_MODELS[name].reduced()
    tc = tcfg.VISION_MODELS[name].reduced()
    jp = jvit.init_vit(jax.random.PRNGKey(seed), jc)
    return jc, tc, jp, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _batch(cfg, n=6, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, cfg.img_size, cfg.img_size, 3)).astype(
        np.float32)
    return x, rng.integers(0, cfg.num_classes, size=n).astype(np.int64)


@pytest.mark.parametrize("name", NAMES)
def test_tree_round_trips_bit_for_bit(name):
    _, tc, jp, tp = _carried(name)
    want = _paths(jax.tree_util.tree_map(np.asarray, jp))
    got = _paths(params_to_numpy(tp))
    assert want.keys() == got.keys()
    for key, w in want.items():
        assert got[key].dtype == w.dtype and got[key].shape == w.shape
        np.testing.assert_array_equal(got[key].view(np.uint32),
                                      w.view(np.uint32))
    assert isinstance(tp["blocks"], list) and len(tp["blocks"]) == 2
    assert tp["cls"].shape == (1, 1, tc.d_model)
    assert tp["pos"].shape == (1, (tc.img_size // tc.patch) ** 2 + 1,
                               tc.d_model)


@pytest.mark.parametrize("name", NAMES)
def test_init_matches_jax_structure(name):
    """The port's own init has the reference tree's keys and shapes."""
    jc, tc, jp, _ = _carried(name)
    tp = make_vision_model(tc, "cpu").init(torch.Generator().manual_seed(0))
    want = {k: v.shape for k, v in _paths(
        jax.tree_util.tree_map(np.asarray, jp)).items()}
    assert {k: v.shape for k, v in _paths(params_to_numpy(tp)).items()} \
        == want


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(name):
    jc, tc, jp, tp = _carried(name)
    x, _ = _batch(jc)
    want = np.asarray(jax.jit(j_make_vision_model(jc).apply)(jp, x))
    tops.reset_kernel_stats()
    with torch.no_grad():
        got = make_vision_model(tc, "cpu").apply(tp, x).numpy()
    assert tops.kernel_stats() == {
        "flash_attention": {"plain": tc.num_layers}}
    assert got.shape == (6, tc.num_classes)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_gelu_is_the_tanh_approximation():
    """``jax.nn.gelu`` defaults to the tanh form; torch's default is erf,
    which differs by up to ~1e-3."""
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(x))
    got = F.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.abs(F.gelu(torch.from_numpy(x)).numpy() - want).max() > 1e-4


@pytest.mark.parametrize("name", NAMES)
def test_cross_entropy_gradient_matches_jax(name):
    jc, tc, jp, tp = _carried(name)
    x, y = _batch(jc, n=8, seed=2)
    jmodel = j_make_vision_model(jc)

    def jloss(p):
        logp = jax.nn.log_softmax(jmodel.apply(p, x))
        return -jnp.take_along_axis(logp, jnp.asarray(y)[:, None],
                                    axis=-1).mean()

    jl, jgrad = jax.value_and_grad(jloss)(jp)
    leaves = jax.tree_util.tree_leaves(
        tp, is_leaf=lambda t: isinstance(t, torch.Tensor))
    for leaf in leaves:
        leaf.requires_grad_(True)
    logp = F.log_softmax(make_vision_model(tc, "cpu").apply(tp, x), dim=-1)
    loss = -logp.gather(1, torch.from_numpy(y)[:, None]).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    got = _paths(jax.tree_util.tree_map(
        lambda t: t.grad.numpy(), tp,
        is_leaf=lambda t: isinstance(t, torch.Tensor)))
    for key, w in _paths(jgrad).items():
        w64, g64 = w.astype(np.float64), got[key].astype(np.float64)
        assert np.linalg.norm(g64 - w64) <= 1e-4 * np.linalg.norm(w64), key


@pytest.mark.parametrize("name", NAMES)
def test_flops_params_and_gemms_match_jax(name):
    """Full width and reduced: ``vit_flops``, ``vision_gemms`` and the
    parameter count equal the JAX package's; full width within 2 % of
    Table III."""
    counts = []
    for jc, tc in ((jcfg.VISION_MODELS[name], tcfg.VISION_MODELS[name]),
                   (jcfg.VISION_MODELS[name].reduced(),
                    tcfg.VISION_MODELS[name].reduced())):
        assert tvit.vit_flops(tc) == jvit.vit_flops(jc)
        assert test_.vision_gemms(tc, 3) == jest.vision_gemms(jc, 3)
        shapes = jax.eval_shape(lambda k: jvit.init_vit(k, jc),
                                jax.random.PRNGKey(0))
        counts.append(tvit.vit_param_count(
            make_vision_model(tc, "cpu").init(torch.Generator())))
        assert counts[-1] == jvit.vit_param_count(shapes)
    params, _ = tcfg.TABLE_III[name]
    assert abs(counts[0] - params) / params < 0.02


# ------------------------------------------------------------- session
@pytest.fixture(scope="module")
def vit_sessions():
    """Both packages' DC-ST sessions with the ViT pair over
    ``scenario("S1", 3)``, seed 5, 45 s, fp32 and MX6 serving, on
    teacher and student weights pretrained by the JAX package and carried
    across (pretraining runs once)."""
    jstream = JDriftStream(j_scenario("S1", 3), seed=5, img=24)
    rng = np.random.default_rng(0)
    tp = j_pretrain_model(j_make_vision_model(jcfg.VIT_B16.reduced()),
                          jstream, 25, 32, rng)
    sp = j_pretrain_model(j_make_vision_model(jcfg.VIT_B32.reduced()),
                          jstream, 15, 32, rng,
                          segments=jstream.segments[:1], seed=8)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    out = {}
    for apply_mx in (False, True):
        ref = JCLSystemSpec(
            student=jcfg.VIT_B32, teacher=jcfg.VIT_B16,
            allocator="dacapo-spatiotemporal",
            hp=jalloc.CLHyperParams(n_t=48, n_l=24, c_b=192, epochs=1),
            apply_mx=apply_mx, seed=0, eval_fps=0.5).build()
        ref.set_pretrained(tp, sp)
        want = ref.run(jstream, duration=45.0)
        port = CLSystemSpec(
            student=tcfg.VIT_B32, teacher=tcfg.VIT_B16,
            allocator="dacapo-spatiotemporal",
            hp=talloc.CLHyperParams(n_t=48, n_l=24, c_b=192, epochs=1),
            apply_mx=apply_mx, seed=0, eval_fps=0.5, device="cpu").build()
        port.set_pretrained(params_from_numpy(as_np(tp), "cpu"),
                            params_from_numpy(as_np(sp), "cpu"))
        tops.reset_kernel_stats()
        tmxq.reset_launch_counts()
        got = port.run(DriftStream(scenario("S1", 3), seed=5, img=24),
                       duration=45.0)
        out[apply_mx] = (want, got, tops.kernel_stats(),
                         tmxq.launch_counts())
    return out


@pytest.mark.parametrize("apply_mx", [False, True], ids=["fp32", "mx6"])
def test_vit_session_matches_jax(vit_sessions, apply_mx):
    want, got, stats, launches = vit_sessions[apply_mx]
    assert len(got.phase_log) == len(want.phase_log) > 0
    assert got.drift_events == want.drift_events
    assert abs(got.retrain_time - want.retrain_time) < 1e-6
    assert abs(got.label_time - want.label_time) < 1e-6
    for g, w in zip(got.phase_log, want.phase_log):
        for key in ("t", "phase_start", "t_tsa", "t_bsa", "retrain_time",
                    "label_time"):
            assert abs(g[key] - w[key]) < 1e-6, (key, g, w)
        if (g["acc_valid"], g["acc_label"]) != (w["acc_valid"],
                                                w["acc_label"]):
            break
        assert g["drift"] == w["drift"], (g, w)
    assert abs(got.avg_accuracy - want.avg_accuracy) < 0.1
    # Every attention ran through the entry, on its plain path; the MX
    # serving copies only with apply_mx; no kernel launched on the CPU.
    assert stats["flash_attention"].keys() == {"plain"}
    assert stats["flash_attention"]["plain"] > 0
    assert ("mx_quantize" in stats) == apply_mx
    assert not any(launches.values())
