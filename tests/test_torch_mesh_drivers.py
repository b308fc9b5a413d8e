"""The LM drivers and the mesh machinery across ranks: one 2-rank gloo
world on the CPU (``tests/_torch_worlds.py::mesh_drivers``) against
1-rank runs in this process, with reduced gemma2-2b in fp32. The serve
driver at (data, model) = (1, 2) and (2, 1) gives the 1-rank run's greedy
tokens and its logits within ``tests/_torch_lm.py``'s RTOL; one train step
at (1, 2) gives its loss within RTOL and its gradients within GRAD_RTOL,
and the checkpoint the 2-rank run saves restores into the 1-rank run bit
for bit. ``compressed_cross_pod_mean`` is checked bitwise against the JAX
package's ``compress_int8`` on each rank's own gradients."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training.grad import compress_int8 as jax_compress_int8
from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch import serve, train
from repro_torch.launch.sharding import make_rules
from repro_torch.launch.steps import build_train_bundle
from repro_torch.training.train_state import TrainState
from repro_torch.tree import tree_leaves, tree_map

from _torch_lm import GRAD_RTOL, RTOL, close, one_torch_thread  # noqa: F401
from _torch_worlds import (MIXER_DRIVER_ARCHS, SERVE, TRAIN, mixer_argv,
                           run_world, train_grads)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_drivers")
    run_world("mesh_drivers", 2, d)
    return d, dict(np.load(d / "mesh_drivers.npz")), [
        dict(np.load(d / f"pod_{r}.npz")) for r in range(2)]


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """The 1-rank runs: the serve driver, one train step (with its
    checkpoint) and the step's gradients with no mesh."""
    d = tmp_path_factory.mktemp("one_rank")
    res = train.train(TRAIN + ["--checkpoint-dir", str(d)])
    loss, grads = train_grads(None)
    return {"serve": serve.serve(SERVE), "train": res, "grad_loss": loss,
            "grads": grads, "ckpt": d}


@pytest.mark.parametrize("mp", [2, 1])
def test_serve_across_ranks_matches_one_rank(world, one_rank, mp):
    """(1, 2): heads and the KV ring split over "model" (the sharded decode
    merges 2 shards); (2, 1): the batch split over "data"."""
    _, got, _ = world
    want = one_rank["serve"]
    np.testing.assert_array_equal(got[f"serve_mp{mp}_tokens"],
                                  want["tokens"])
    close(got[f"serve_mp{mp}_logits"], want["logits"].numpy(), RTOL,
          f"decode logits at (data, model) = ({2 // mp}, {mp})")


def test_train_step_across_ranks_matches_one_rank(world, one_rank):
    _, got, _ = world
    close(got["grad_loss"], np.float64(one_rank["grad_loss"]), RTOL, "loss")
    close(got["train_loss"], np.array(one_rank["train"]["loss"]), RTOL,
          "driver loss")
    for i, g in enumerate(tree_leaves(one_rank["grads"])):
        close(got[f"grad_{i}"], g, GRAD_RTOL, f"gradient leaf {i}")
    for i, p in enumerate(tree_leaves(one_rank["train"]["params"])):
        close(got[f"param_{i}"], p.numpy(), RTOL, f"param leaf {i}")


def test_zero2_gather_matches_the_plain_step(world):
    """A train bundle of 2 microbatches at (data, model) = (2, 1) with the
    ZeRO-2 gather (FSDP weights gathered once a step, gradients laid out
    sharded again) gives the step without it: its loss and parameters
    within RTOL."""
    _, got, _ = world
    close(got["zero2_True_loss"], got["zero2_False_loss"], RTOL, "loss")
    i = 0
    while f"zero2_False_param_{i}" in got:
        close(got[f"zero2_True_param_{i}"], got[f"zero2_False_param_{i}"],
              RTOL, f"param leaf {i}")
        i += 1
    assert i > 10


def test_two_rank_checkpoint_restores_into_one_rank_run(world, one_rank):
    """Rank 0 saved the gathered state at step 1; it restores into the
    1-rank state's structure with the 2-rank run's parameters bit for bit,
    and the 1-rank train step runs on it."""
    d, got, _ = world
    ckpt = CheckpointManager(str(d / "ckpt"))
    assert ckpt.all_steps() == CheckpointManager(
        str(one_rank["ckpt"])).all_steps() == [1]
    params = one_rank["train"]["params"]
    like = {"params": params, "opt_state": {"mu": params, "nu": params},
            "step": 0}
    restored, _ = ckpt.restore(1, like)
    for i, p in enumerate(tree_leaves(restored["params"])):
        assert np.array_equal(p, got[f"param_{i}"]), i
    arch = dataclasses.replace(configs.get_arch("gemma2-2b").reduced(),
                               dtype="float32")
    shape = ShapeConfig("custom_train", 32, 2, "train")
    bundle = build_train_bundle(arch, shape, None,
                                make_rules(arch, shape, None), device="cpu",
                                num_microbatches=1)
    state = TrainState(tree_map(torch.from_numpy, restored["params"]),
                       tree_map(torch.from_numpy, restored["opt_state"]),
                       int(restored["step"]))
    batch = TokenPipeline(arch.vocab_size, 32, 2, seed=0).batch(1)
    state, metrics = bundle.fn(state, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    assert state.step == 2 and np.isfinite(float(metrics["loss"]))


def test_compressed_cross_pod_mean(world):
    """Each rank's int8 codes, scale and error state are bitwise the JAX
    package's ``compress_int8`` of the same arrays (round half to even);
    the mean is the mean of both ranks' dequantized leaves."""
    _, _, pods = world
    for k in ("w", "b"):
        deq = []
        for r, pod in enumerate(pods):
            q, scale, err = jax_compress_int8(jnp.asarray(pod[f"g_{k}"]),
                                              jnp.asarray(pod[f"err_{k}"]))
            assert np.array_equal(pod[f"q_{k}"], np.asarray(q)), (k, r)
            assert np.array_equal(pod[f"scale_{k}"], np.asarray(scale))
            assert np.array_equal(pod[f"new_err_{k}"], np.asarray(err))
            deq.append(pod[f"q_{k}"].astype(np.float32) * pod[f"scale_{k}"])
        want = (deq[0] + deq[1]) / np.float32(2)
        for pod in pods:
            np.testing.assert_allclose(pod[f"mean_{k}"], want, rtol=1e-6,
                                       atol=0)


def test_reshard_tree_and_constrain_over_device_mesh(world):
    _, got, _ = world
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    shapes = {"rows": (2, 6), "cols": (4, 3), "both": (2, 6),
              "none": (4, 6)}
    for k, shape in shapes.items():
        assert tuple(got[f"local_{k}"]) == shape, k
        assert np.array_equal(got[f"full_{k}"], x), k
    assert tuple(got["constrained_local"]) == (2, 6)
    assert "plain tensor" in str(got["plain_raises"])
    assert "mesh's order" in str(got["order_raises"])


@pytest.fixture(scope="module")
def mixer_one_rank(tmp_path_factory):
    """The serve and train drivers of ``MIXER_DRIVER_ARCHS`` on one rank."""
    d = tmp_path_factory.mktemp("mixer_one_rank")
    return {arch: {"serve": serve.serve(mixer_argv(SERVE, arch)),
                   "train": train.train(mixer_argv(TRAIN, arch) + [
                       "--checkpoint-dir", str(d / arch)])}
            for arch in MIXER_DRIVER_ARCHS}


# The reduced MoE, Mamba-hybrid and xLSTM archs run at the reference's own
# init, where they are chaotic: one fp32 rounding of the weights moves the
# reference's own prefill logits by up to 1.6e-4 (mixtral), 1.1e-4 (jamba)
# and 4.9e-4 (xlstm) of their scale (``tests/_torch_lm.py``, measured by
# ``tests/lm_sensitivity.py``). A second rank's summation order is such a
# perturbation, and each decode step compounds it, so the 2-rank decode
# logits are held to 8x the largest, as GRAD_RTOL is to the gradients'
# sensitivity. A rank that drops or doubles a term is off by O(1).
MIXER_LOGITS_RTOL = 4e-3


@pytest.mark.parametrize("arch", MIXER_DRIVER_ARCHS)
def test_mixer_arch_serve_across_ranks(world, mixer_one_rank, arch):
    """The MoE (experts over "model"), Mamba-hybrid and xLSTM archs'
    serve driver at (data, model) = (1, 2): the 1-rank run's greedy tokens,
    and its decode logits within MIXER_LOGITS_RTOL."""
    _, got, _ = world
    want = mixer_one_rank[arch]["serve"]
    np.testing.assert_array_equal(got[f"{arch}_serve_tokens"],
                                  want["tokens"])
    close(got[f"{arch}_serve_logits"], want["logits"].numpy(),
          MIXER_LOGITS_RTOL, f"{arch} decode logits at (1, 2)")


@pytest.mark.parametrize("arch", MIXER_DRIVER_ARCHS)
def test_mixer_arch_train_across_ranks(world, mixer_one_rank, arch):
    """The same archs' train driver, one step at (1, 2), its per-rank
    bodies' gradients through AdamW: the loss within RTOL of the 1-rank
    run's, and every parameter laid out and finite after the step. (AdamW's
    first step moves each weight by about lr · sign(gradient), so a weight
    whose gradient is rounding alone moves either way on the two runs; the
    gradients are held in ``tests/test_torch_tp_mixers.py`` and
    ``tests/test_torch_expert_parallel.py`` on layers at their own init.)"""
    _, got, _ = world
    want = mixer_one_rank[arch]["train"]
    close(got[f"{arch}_train_loss"], np.array(want["loss"]), RTOL,
          f"{arch} driver loss")
    leaves = tree_leaves(want["params"])
    assert f"{arch}_param_{len(leaves)}" not in got
    for i, p in enumerate(leaves):
        assert got[f"{arch}_param_{i}"].shape == tuple(p.shape), i
        assert np.isfinite(got[f"{arch}_param_{i}"]).all(), i
