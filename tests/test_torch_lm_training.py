"""The port's LM training side against the JAX package's, run live:
``apply_updates`` (SGD and AdamW over several steps, with clipping and
weight decay, fp32 and bf16 leaves), ``schedule``, ``microbatched_grads``
against the full batch and against the reference, ``compress_int8`` and
``TokenPipeline`` bit for bit, one reduced gemma2-2b train step against
the reference's step body, the reference's own optimizer tests
(``tests/test_optimizer.py``) ported, and both LM drivers run small on the
CPU.

Tolerances (``tests/_torch_lm.py``): fp32 element-wise arithmetic in the
same order gives the reference's values to within a rounding or two,
RTOL = 2e-5 of the tensor's scale; gradients of the reduced model
GRAD_RTOL = 1e-3; bitwise where the function is exact (quantization,
numpy copies)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.tokens import TokenPipeline as JaxTokenPipeline
from repro.training import grad as jgrad
from repro.training import optimizer as jopt
from repro_torch.convert import params_to_numpy
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch import serve as serve_lib
from repro_torch.launch import train as train_lib
from repro_torch.training import grad as tgrad
from repro_torch.training import optimizer as topt
from repro_torch.training.train_state import TrainState

from _torch_lm import (GRAD_RTOL, RTOL, batch, close,  # noqa: F401
                       one_torch_thread, pair, trees_close)


def _tree(rng, bf16: bool):
    tree = {"w": rng.normal(size=(8, 4)).astype(np.float32),
            "b": (rng.normal(size=(4,)).astype(np.float32),)}
    if bf16:
        tree["h"] = rng.normal(size=(16,)).astype(np.float32)
    return tree


def _to_port(tree, bf16_keys=("h",)):
    out = {}
    for k, v in tree.items():
        if isinstance(v, tuple):
            out[k] = tuple(torch.from_numpy(x.copy()) for x in v)
        else:
            t = torch.from_numpy(v.copy())
            out[k] = t.bfloat16() if k in bf16_keys else t
    return out


def _to_jax(tree, bf16_keys=("h",)):
    out = {}
    for k, v in tree.items():
        if isinstance(v, tuple):
            out[k] = tuple(jnp.asarray(x) for x in v)
        else:
            out[k] = jnp.asarray(v, jnp.bfloat16 if k in bf16_keys
                                 else jnp.float32)
    return out


@pytest.mark.parametrize("name,clip,wd", [
    ("sgd", 1.0, 0.0), ("sgd", 0.0, 0.0), ("adamw", 1.0, 0.01),
    ("adamw", 0.0, 0.0)])
def test_apply_updates_match_reference(name, clip, wd):
    """Six steps through warmup into the cosine decay, new gradients each
    step: params (a bf16 leaf too) and every moment against the
    reference's."""
    cfg_kw = dict(name=name, lr=0.05, warmup_steps=2, total_steps=6,
                  grad_clip=clip, weight_decay=wd)
    rng = np.random.default_rng(0)
    init = _tree(rng, bf16=True)
    tp, jp = _to_port(init), _to_jax(init)
    tstate = topt.init_opt_state(tp, topt.OptimizerConfig(**cfg_kw))
    jstate = jopt.init_opt_state(jp, jopt.OptimizerConfig(**cfg_kw))
    for step in range(6):
        g = _tree(rng, bf16=True)
        g = {k: (tuple(x * 3 for x in v) if isinstance(v, tuple) else v * 3)
             for k, v in g.items()}
        tp, tstate, tm = topt.apply_updates(
            tp, _to_port(g), tstate, step, topt.OptimizerConfig(**cfg_kw))
        jp, jstate, jm = jopt.apply_updates(
            jp, _to_jax(g), jstate, step, jopt.OptimizerConfig(**cfg_kw))
        close(tm["lr"], jm["lr"], what="lr")
        close(tm["grad_norm"], jm["grad_norm"], what="grad_norm")
        got = params_to_numpy({"p": tp, "s": tstate})
        want = {"p": jp, "s": jstate}
        for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
            gv = dict(jax.tree_util.tree_flatten_with_path(got)[0])[path]
            if w.dtype == jnp.bfloat16:  # one bf16 rounding of fp32 values
                np.testing.assert_allclose(
                    np.asarray(gv, np.float32), np.asarray(w, np.float32),
                    rtol=2.0 ** -8, atol=2.0 ** -8 * float(
                        jnp.abs(w.astype(jnp.float32)).max()))
            else:
                close(gv, w, what=f"step {step} {jax.tree_util.keystr(path)}")
    assert tstate["mu"]["h"].dtype == torch.float32
    assert tp["h"].dtype == torch.bfloat16


def test_schedule_matches_reference():
    cfg = dict(lr=3e-4, warmup_steps=100, total_steps=1000,
               min_lr_ratio=0.1)
    for step in (0, 1, 50, 99, 100, 101, 500, 999, 1000, 5000):
        got = topt.schedule(step, topt.OptimizerConfig(**cfg))
        assert got.dtype == torch.float32
        close(got, jopt.schedule(step, jopt.OptimizerConfig(**cfg)),
              rtol=1e-6, what=f"lr at {step}")


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_optimizer_converges_quadratic(name):
    """``tests/test_optimizer.py``'s convergence test on the port."""
    cfg = topt.OptimizerConfig(name=name, lr=0.1, warmup_steps=0,
                               total_steps=200, grad_clip=0.0,
                               min_lr_ratio=1.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = topt.init_opt_state(params, cfg)
    for step in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = topt.apply_updates(params, grads, state, step,
                                              cfg)
    assert float(params["w"].abs().max()) < 1e-2


def test_grad_clip_and_bf16_master():
    """``tests/test_optimizer.py``'s clipping and bf16 tests on the port."""
    cfg = topt.OptimizerConfig(name="sgd", lr=1.0, grad_clip=1.0,
                               warmup_steps=0, min_lr_ratio=1.0)
    params = {"w": torch.zeros(3)}
    state = topt.init_opt_state(params, cfg)
    new, _, metrics = topt.apply_updates(
        params, {"w": torch.tensor([100.0, 0.0, 0.0])}, state, 0, cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(100.0)
    assert float(new["w"].abs().max()) <= 1.0 + 1e-5
    cfg = topt.OptimizerConfig(name="adamw", lr=0.01, warmup_steps=0,
                               min_lr_ratio=1.0)
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = topt.init_opt_state(params, cfg)
    assert state["mu"]["w"].dtype == torch.float32
    new, _, _ = topt.apply_updates(
        params, {"w": torch.full((4,), 0.1, dtype=torch.bfloat16)}, state, 0,
        cfg)
    assert new["w"].dtype == torch.bfloat16


def _linear_loss(params, b):
    pred = b["x"] @ params
    loss = ((pred - b["y"]) ** 2).mean()
    return loss, {"loss": loss}


def _jlinear_loss(params, b):
    pred = b["x"] @ params
    loss = jnp.mean((pred - b["y"]) ** 2)
    return loss, {"loss": loss}


def test_microbatched_grads_match_full_batch_and_reference():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(8, 4)).astype(np.float32)
    data = {"x": rng.normal(size=(16, 8)).astype(np.float32),
            "y": rng.normal(size=(16, 4)).astype(np.float32)}
    tdata = {k: torch.from_numpy(v) for k, v in data.items()}
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    l1, m1, g1 = tgrad.microbatched_grads(_linear_loss, torch.from_numpy(w),
                                          tdata, 1)
    for n in (2, 4):
        ln, mn, gn = tgrad.microbatched_grads(
            _linear_loss, torch.from_numpy(w), tdata, n)
        assert gn.dtype == torch.float32
        close(ln, l1.numpy(), what=f"loss, {n} microbatches")
        close(gn, g1.numpy(), what=f"grads, {n} microbatches")
        jl, jm, jg = jgrad.microbatched_grads(_jlinear_loss, jnp.asarray(w),
                                              jdata, n)
        close(ln, jl, what="loss vs reference")
        close(mn["loss"], jm["loss"], what="metrics vs reference")
        close(gn, jg, what="grads vs reference")
    with pytest.raises(ValueError, match="divisible"):
        tgrad.microbatched_grads(_linear_loss, torch.from_numpy(w), tdata, 3)


def test_compress_int8_bit_for_bit():
    """q, scale and the error carried over three rounds equal the
    reference's bit for bit (the same fp32 divide, round-half-even and
    clip)."""
    rng = np.random.default_rng(2)
    g = rng.normal(size=(257,)).astype(np.float32)
    g[:4] = [1.0, -0.503, 0.2501, 0.001]
    terr = torch.zeros(257)
    jerr = jnp.zeros(257)
    for _ in range(3):
        tq, ts, terr = tgrad.compress_int8(torch.from_numpy(g), terr)
        jq, js, jerr = jgrad.compress_int8(jnp.asarray(g), jerr)
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert ts.numpy().tobytes() == np.asarray(js).tobytes()
        assert terr.numpy().tobytes() == np.asarray(jerr).tobytes()


def test_token_pipeline_bit_for_bit():
    for kw in (dict(vocab_size=256, seq_len=32, global_batch=4, seed=0),
               dict(vocab_size=1000, seq_len=17, global_batch=6, seed=3,
                    num_hosts=3, host_index=2)):
        a, b = TokenPipeline(**kw), JaxTokenPipeline(**kw)
        for step in (0, 1, 7):
            x, y = a.batch(step), b.batch(step)
            for key in ("inputs", "labels"):
                assert x[key].dtype == y[key].dtype
                np.testing.assert_array_equal(x[key], y[key])


def test_train_step_matches_reference():
    """One AdamW step of reduced gemma2-2b, the train driver's step body
    (``microbatched_grads`` then ``apply_updates``) against the
    reference's: metrics, moments, and the new params. AdamW's first
    update is ±lr wherever |g| >> eps, so where a gradient is within
    its tolerance of 0 its sign may differ: there the params are held to
    2 lr, elsewhere to RTOL."""
    jm, jp, tm, tp = pair("gemma2-2b")
    data = batch(jm.cfg, seed=7, b=2, s=32)
    kw = dict(name="adamw", lr=1e-3, warmup_steps=0, total_steps=10)
    state = TrainState.create(tp, topt.OptimizerConfig(**kw))
    tdata = {k: torch.from_numpy(v) for k, v in data.items()}
    new, metrics = train_lib.train_step(tm, state, tdata,
                                        topt.OptimizerConfig(**kw))
    assert new.step == 1

    jcfg = jopt.OptimizerConfig(**kw)
    jl, jmet, jg = jgrad.microbatched_grads(lambda p, b: jm.loss(p, b), jp,
                                            data, 1)
    jnew, jstate, jom = jopt.apply_updates(
        jp, jg, jopt.init_opt_state(jp, jcfg), 0, jcfg)
    close(metrics["loss"], jl, what="loss")
    close(metrics["grad_norm"], jom["grad_norm"], rtol=GRAD_RTOL,
          what="grad_norm")
    trees_close(new.opt_state["mu"], jstate["mu"], GRAD_RTOL)
    lr = float(jom["lr"])
    got = params_to_numpy(new.params)
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(jg)[0])
    for path, want in jax.tree_util.tree_flatten_with_path(jnew)[0]:
        want = np.asarray(want, np.float64)
        err = np.abs(flat_got[path] - want)
        g = np.abs(np.asarray(flat_g[path], np.float64))
        near_zero = g <= 10 * GRAD_RTOL * g.max()
        limit = np.where(near_zero, 2 * lr,
                         RTOL * (np.abs(want).max() + np.abs(want)))
        assert (err <= limit).all(), jax.tree_util.keystr(path)


def test_serve_driver_runs_on_cpu(capsys):
    out = serve_lib.serve(["--arch", "gemma2-2b", "--reduced", "--device",
                           "cpu", "--batch", "2", "--prompt-len", "12",
                           "--gen", "6"])
    assert out["tokens"].shape == (2, 6)
    assert np.isfinite(out["prefill_s"]) and out["decode_tok_per_s"] > 0
    assert "prefill: 2x12" in capsys.readouterr().out
    with pytest.raises(ValueError, match="world size 1"):
        serve_lib.serve(["--arch", "yi-6b", "--reduced", "--device", "cpu",
                         "--model-parallel", "2"])


def test_train_driver_runs_on_cpu(tmp_path, capsys):
    out = train_lib.train(["--arch", "gemma2-2b", "--reduced", "--device",
                           "cpu", "--steps", "3", "--batch", "2", "--seq",
                           "32", "--log-every", "1", "--checkpoint-every",
                           "2", "--checkpoint-dir", str(tmp_path)])
    assert len(out["loss"]) == 3 and np.isfinite(out["loss"]).all()
    assert (tmp_path / "step_0000000002" / "manifest.json").exists()
    assert "done:" in capsys.readouterr().out
    with pytest.raises(ValueError, match="world size 1"):
        train_lib.train(["--arch", "yi-6b", "--reduced", "--device", "cpu",
                         "--model-parallel", "2"])
