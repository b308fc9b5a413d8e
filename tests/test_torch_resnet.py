"""Parity of the port's ResNet / WideResNet (plain PyTorch, CPU) with the
JAX package, on weights initialized by JAX and carried across as numpy.

Tolerances: the weight converter is bit-exact. Forward logits agree
within fp32 summation order (``rtol=1e-4, atol=1e-5``; measured ≤ 2e-6 on
logits of magnitude ~2) with equal argmax. The SGD step: loss within
1e-5; the whole gradient tree within 1e-3 relative L2 of the reference's
eager gradient (measured ≤ 3e-4; the reference's own eager and jitted
gradients differ by 2e-4); each leaf within 2e-2 of its largest entry —
GroupNorm's backward cancels, and against a float64 gradient every fp32
implementation measured (the port, JAX eager, JAX jitted) reaches 1e-3 to
1.7e-2 of the leaf maximum on its worst leaf; the updated weights within
5e-6 of the reference's jitted step (lr 1e-3 times that gradient gap).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import dacapo_pairs as jcfg
from repro.core.allocation import CLHyperParams as JHyperParams
from repro.core.estimator import DaCapoEstimator as JEstimator
from repro.core.estimator import vision_gemms as jvision_gemms
from repro.core.kernel import RetrainKernel as JRetrainKernel
from repro.models import resnet as jresnet
from repro.models import vit as jvit
from repro.models.registry import make_vision_model as j_make_vision_model
from repro_torch.configs import dacapo_pairs as tcfg
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.allocation import CLHyperParams
from repro_torch.core.estimator import vision_gemms as tvision_gemms
from repro_torch.core.kernel import RetrainKernel
from repro_torch.models import resnet as tresnet
from repro_torch.models import vit as tvit
from repro_torch.models.registry import make_vision_model

# (name, JAX config, port config): both reduced twins at 24 px, plus narrow
# configs above 64 px, which take the 7x7 stride-2 stem, asymmetric "SAME"
# padding and the -inf-padded max-pool.
CONFIGS = {
    "resnet18-24": (jcfg.RESNET18.reduced(), tcfg.RESNET18.reduced()),
    "wrn50-24": (jcfg.WIDERESNET50.reduced(), tcfg.WIDERESNET50.reduced()),
    "resnet18-72": (
        dataclasses.replace(jcfg.RESNET18, base=8, img_size=72,
                            num_classes=8),
        dataclasses.replace(tcfg.RESNET18, base=8, img_size=72,
                            num_classes=8)),
    "wrn50-72": (
        dataclasses.replace(jcfg.WIDERESNET50, base=8, img_size=72,
                            num_classes=8),
        dataclasses.replace(tcfg.WIDERESNET50, base=8, img_size=72,
                            num_classes=8)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; one torch
    intra-op thread per worker keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _carried(name, seed=0):
    jc, tc = CONFIGS[name]
    jp = j_make_vision_model(jc).init(jax.random.PRNGKey(seed))
    return jc, tc, jp, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def test_converter_is_bit_exact():
    _, _, jp, tp = _carried("wrn50-24")
    want = _paths(jax.tree_util.tree_map(np.asarray, jp))
    got = _paths(params_to_numpy(tp))
    assert want.keys() == got.keys()
    for key, w in want.items():
        assert got[key].dtype == w.dtype and got[key].shape == w.shape
        np.testing.assert_array_equal(got[key].view(np.uint32),
                                      w.view(np.uint32))
    assert isinstance(tp["blocks"], list) and "conv1" in tp["blocks"][0]


@pytest.mark.parametrize("name", sorted(jcfg.VISION_MODELS))
def test_block_plan_and_flops_match(name):
    """Full width and reduced; a ViT has no block plan, so its FLOPs and
    its estimator GEMM list are compared instead."""
    jc = jcfg.VISION_MODELS[name]
    for j, t in ((jc, tcfg.VISION_MODELS[name]),
                 (jc.reduced(), tcfg.VISION_MODELS[name].reduced())):
        if jc.kind != "resnet":
            assert tvit.vit_flops(t) == jvit.vit_flops(j)
            assert tvision_gemms(t, 2) == jvision_gemms(j, 2)
            assert make_vision_model(t, device="cpu").flops() == \
                jvit.vit_flops(j)
            continue
        assert tresnet.block_plan(t) == jresnet.block_plan(j)
        assert tresnet.resnet_flops(t) == jresnet.resnet_flops(j)


def test_table3_param_counts():
    """Torch-initialized full configs have the Table III sizes."""
    gen = torch.Generator().manual_seed(0)
    for cfg in (tcfg.RESNET18, tcfg.WIDERESNET50):
        model = make_vision_model(cfg, device="cpu")
        count = model.param_count(model.init(gen))
        assert abs(count - tcfg.TABLE_III[cfg.name][0]) / count < 0.01


@pytest.mark.parametrize("size,ksize,stride,pads", [
    (24, 3, 2, (0, 1)), (24, 3, 1, (1, 1)), (224, 7, 2, (2, 3)),
    (112, 3, 2, (0, 1)), (72, 1, 2, (0, 0)), (9, 3, 2, (1, 1))])
def test_same_padding_is_xla_same(size, ksize, stride, pads):
    assert tresnet._same_pads(size, ksize, stride) == pads


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_jax(name):
    jc, tc, jp, tp = _carried(name)
    x = np.random.default_rng(1).normal(
        size=(6, jc.img_size, jc.img_size, 3)).astype(np.float32)
    want = np.asarray(jax.jit(j_make_vision_model(jc).apply)(jp, x))
    with torch.no_grad():
        got = make_vision_model(tc, device="cpu").apply(tp, x).numpy()
    assert got.shape == (6, tc.num_classes)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def _batch(cfg, n=16, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, cfg.img_size, cfg.img_size, 3)).astype(
        np.float32)
    return x, rng.integers(0, cfg.num_classes, size=n).astype(np.int32)


@pytest.mark.parametrize("name", ["resnet18-24", "wrn50-24"])
def test_sgd_step_matches_jax(name):
    jc, tc, jp, tp = _carried(name)
    x, y = _batch(jc)
    jmodel = j_make_vision_model(jc)
    jk = JRetrainKernel(jmodel, jcfg.RESNET18, JEstimator(), JHyperParams())
    tk = RetrainKernel(make_vision_model(tc, device="cpu"), tcfg.RESNET18,
                       None, CLHyperParams())
    new_tp, new_to, loss = tk._sgd_step(
        tp, tk.init_state(tp), torch.from_numpy(x),
        torch.from_numpy(y).long())
    new_jp, _, jloss = jk._step(jp, jk.init_state(jp), jnp.asarray(x),
                                jnp.asarray(y))

    def eager_loss(p):
        logp = jax.nn.log_softmax(jmodel.apply(p, x))
        return -jnp.take_along_axis(logp, jnp.asarray(y)[:, None],
                                    axis=-1).mean()

    eloss, egrad = jax.value_and_grad(eager_loss)(jp)
    np.testing.assert_allclose(float(loss), float(eloss), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    # After one step from zero momentum, the momentum IS the gradient.
    grads, want = _paths(params_to_numpy(new_to)), _paths(egrad)
    diff2 = sum(float(((grads[k] - g).astype(np.float64) ** 2).sum())
                for k, g in want.items())
    norm2 = sum(float((g.astype(np.float64) ** 2).sum())
                for g in want.values())
    assert (diff2 / norm2) ** 0.5 < 1e-3
    for key, g in want.items():
        np.testing.assert_allclose(grads[key], g, rtol=0,
                                   atol=2e-2 * np.abs(g).max() + 1e-12,
                                   err_msg=key)
    got, want = _paths(params_to_numpy(new_tp)), _paths(new_jp)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=0, atol=5e-6,
                                   err_msg=key)


def test_sgd_step_is_functional():
    """A step returns new tensors and leaves its inputs as they were — the
    serving cache's identity-keyed versioning relies on it."""
    _, tc, _, tp = _carried("resnet18-24")
    before = {k: v.copy() for k, v in _paths(params_to_numpy(tp)).items()}
    x, y = _batch(tc, n=4)
    tk = RetrainKernel(make_vision_model(tc, device="cpu"), tcfg.RESNET18,
                       None, CLHyperParams())
    opt = tk.init_state(tp)
    new_tp, new_opt, _ = tk._sgd_step(tp, opt, torch.from_numpy(x),
                                      torch.from_numpy(y).long())
    assert new_tp is not tp and new_tp["stem"] is not tp["stem"]
    for key, v in _paths(params_to_numpy(tp)).items():
        np.testing.assert_array_equal(v, before[key])
    assert not any(t.requires_grad for t in jax.tree_util.tree_leaves(
        new_tp, is_leaf=lambda t: isinstance(t, torch.Tensor)))
    assert all(float(m.abs().sum()) == 0.0 for m in
               jax.tree_util.tree_leaves(
                   opt, is_leaf=lambda t: isinstance(t, torch.Tensor)))
    del new_opt


def test_group_norm_uses_population_variance():
    x = torch.randn(2, 8, 3, 3, generator=torch.Generator().manual_seed(0))
    p = {"scale": torch.ones(8), "bias": torch.zeros(8)}
    want = F.group_norm(x, 8, eps=1e-5)  # torch's own: biased variance
    torch.testing.assert_close(tresnet._gn(x, p), want, rtol=1e-5,
                               atol=1e-5)
