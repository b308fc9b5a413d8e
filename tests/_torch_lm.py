"""Shared helpers of the LM parity tests (``tests/test_torch_lm_*.py``): the
JAX package's model and the port's on the same weights, carried across as
numpy, and tree comparisons.

Tolerances: both sides compute in fp32 from the same weights and inputs,
so they differ by summation order only (XLA's dots and reductions against
PyTorch's, the kernel's plain attention against the reference's chunked
online softmax). fp32 rounding is 2^-24 relative per operation; over the
reduced models' few layers that grows to ~1e-6 of each tensor's scale, so
every comparison holds the port within RTOL of the reference's largest
magnitude in the tensor (plus RTOL of each element), which a wrong mask,
offset, scale or cache slot misses by orders of magnitude.

Gradients get GRAD_RTOL: the reduced models' reference init (fan-in
scales over the stacked leading axis, as in ``distributed.ParamDef``)
makes the backward ill-conditioned, and the reference's own gradients
move by up to 1.2e-4 of their scale (yi-6b; granite-20b 8.1e-5, gemma2-2b
1.0e-5) when its weights are perturbed by one fp32 rounding, 2^-24
relative. A different summation order is such a perturbation, so the port
is held to 1e-3, 8x that sensitivity.

The MoE, Mamba and xLSTM configs (``MIXER_ARCHS``) are held on
layer-scaled weights (``pair``). At the reference's own init the stacked
leaves' fan-in is the group count, 1 in the reduced jamba and xLSTM, so
their block weights are N(0, 1) and the models chaotic: one rounding of
the weights moves the reference's own gradients by up to 4.3e-2 of a
leaf's scale (jamba; xlstm 1.7e-2) and its prefill logits and caches by
up to 1.6e-4 (mixtral), 1.1e-4 (jamba) and 4.9e-4 (xlstm), beyond what
any second implementation could be held to. Rescaled to each layer's own
fan-in (``chip_smoke.layer_scale_``), the same perturbation moves their
gradients by at most 2.6e-4 and their logits and caches by at most 1.4e-5
(``tests/lm_sensitivity.py``), and the port is held to RTOL and
GRAD_RTOL. The layers alone are held on the reference's own per-layer
init (``tests/test_torch_lm_mixers.py``)."""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models.transformer import make_model as jax_make_model
from repro_torch import configs as port_configs
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models.transformer import make_model as port_make_model
from repro_torch.tree import tree_leaves, tree_map

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)

RTOL = 2e-5  # fp32 summation order over a few layers (module docstring)
GRAD_RTOL = 1e-3  # gradients: 8x the reference's sensitivity (docstring)

ARCH_NAMES = sorted(port_configs.ARCHS)  # all ten assigned archs
# The archs with an MoE FFN, a Mamba or an xLSTM mixer (ROADMAP item 10b).
MIXER_ARCHS = ("jamba-v0.1-52b", "mixtral-8x22b", "mixtral-8x7b",
               "xlstm-125m")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs test files in parallel worker processes; one torch
    intra-op thread per worker keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reduced(name: str, **over):
    """(the reference's reduced config, the port's), with ``over``."""
    return (dataclasses.replace(jax_configs.ARCHS[name].reduced(), **over),
            dataclasses.replace(port_configs.ARCHS[name].reduced(), **over))


def pair(name: str, seed: int = 0, **over):
    """(jax model, jax params, port model, port params): the port on the
    reference's weights, carried across bit for bit. For the MoE, Mamba
    and xLSTM configs the block leaves are rescaled to their layers' own
    init scale first (``chip_smoke.layer_scale_``, module docstring)."""
    jcfg, tcfg = reduced(name, **over)
    jm = jax_make_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = port_make_model(tcfg, "cpu")
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    if name in MIXER_ARCHS:
        chip_smoke.layer_scale_(tm, tp)
        jp = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(tp))
    return jm, jp, tm, tp


def batch(cfg, seed: int, b: int = 2, s: int = 32):
    """numpy inputs and labels from ``seed`` (tokens or embeddings; one
    label per output head)."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        inputs = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    else:
        inputs = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    shape = (b, s) if cfg.num_output_heads == 1 else \
        (b, s, cfg.num_output_heads)
    labels = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    return {"inputs": inputs, "labels": labels}


def port_value_and_grad(loss_fn, params):
    """(loss, metrics, grads) of a port loss, grads as a tree like params."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(live)
    leaves = tree_leaves(live)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, grads))
    return loss.detach(), metrics, tree_map(lambda _: next(it), live)


def close(got, want, rtol: float = RTOL, what: str = "", scale=None):
    """``got`` within rtol·(max|want| + |want|) of ``want`` elementwise
    (``scale``, if given, in place of max|want|)."""
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if scale is None:
        scale = np.abs(want).max() if want.size else 0.0
    err = np.abs(got - want)
    limit = rtol * (scale + np.abs(want))
    assert (err <= limit).all(), (
        f"{what}: max err {err.max()} against the limit {rtol}·(max|ref| "
        f"{scale} + |ref|)")


def trees_close(got_tree, want_tree, rtol: float = RTOL):
    """Every leaf of a port tree within ``close`` of the reference tree's
    leaf at the same path."""
    got = params_to_numpy(got_tree)
    flat_want = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_got) == len(flat_want)
    for path, want in flat_want:
        close(flat_got[path], np.asarray(want, np.float32), rtol,
              jax.tree_util.keystr(path))


def grads_close(got_tree, want_tree, rtol: float = GRAD_RTOL):
    """``trees_close`` for gradients, but for one leaf: an sLSTM mixer's
    input-gate bias ``b_i`` (a dict that also holds ``r_i``). The sLSTM's
    max stabilizer m absorbs a shift of every input-gate preactivation
    (m, and with it c and n, shift and cancel in h = o c / n), so the loss
    does not depend on ``b_i`` and its gradient is 0 but for rounding
    (1.7e-6 against 36 for ``w_i`` in the reduced layer): it is held to the
    scale of the same gate's ``w_i`` gradient instead of its own."""
    got = dict(jax.tree_util.tree_flatten_with_path(
        params_to_numpy(got_tree))[0])
    flat_want = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    want = dict(flat_want)
    assert len(got) == len(flat_want)
    for path, w in flat_want:
        scale = None
        sibling = path[:-1] + (jax.tree_util.DictKey("r_i"),)
        if (isinstance(path[-1], jax.tree_util.DictKey)
                and path[-1].key == "b_i" and sibling in want):
            scale = np.abs(np.asarray(
                want[path[:-1] + (jax.tree_util.DictKey("w_i"),)])).max()
        close(got[path], np.asarray(w, np.float32), rtol,
              jax.tree_util.keystr(path), scale)
