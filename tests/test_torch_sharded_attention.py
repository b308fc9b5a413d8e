"""The port's sequence-sharded attention against the JAX package's, run
live: ``sharded_flash_decode`` (a ring split over the ``kv_seq`` axis,
each rank's kernel output merged by its log-sum-exp) and
``seq_parallel_flash`` (queries split over ``attn_seq``, K/V gathered),
with their gradients, in one 4-rank gloo world; the reference under
``make_host_mesh(4)`` in one JAX subprocess with four forced host devices
(``XLA_FLAGS`` in that process's environment only). Both read the same
numpy inputs. fp32 throughout: the limits are summation order's (2e-5,
``tests/_torch_lm.py``; gradients 1e-4).

A reference caveat is pinned here: the reference's windowed
``seq_parallel_flash`` is wrong on every query row of the shards after the
first, because its windowed branch slices each block's keys from ``start
= i * qb`` (``src/repro/models/attention.py:111``) without the shard's
``q_offset``, while its mask adds it (``:115``); the port's kernel takes
the offset, so it computes the unsharded function."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels import ref

from _torch_lm import one_torch_thread  # noqa: F401
from _torch_worlds import ROOT, run_world

WORLD = 4
B, H, KV, D = 2, 4, 2, 16
SLOTS = 32  # ring slots, 8 a shard
SEQ = 64  # sequence-parallel length, 16 a shard
SCALE = D ** -0.5
SOFTCAP = 50.0
# (t, window given to the reference, softcap): the ring wrapped, the
# window of a layer whose ring it sizes (L = window), a softcap, a partial
# prefix, and t = 5, where shards 1-3 hold no valid slot.
DECODES = ((40, None, 0.0), (40, SLOTS, 50.0), (20, None, 30.0),
           (5, None, 0.0))
WINDOWS = (0, 16, 32)  # 0: no window
TOL = 2e-5
GRAD_TOL = 1e-4

REFERENCE = r'''
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.distributed import ShardingRules, use_rules
from repro.launch.mesh import make_host_mesh
from repro.models import attention as attn

data = dict(np.load(sys.argv[1]))
mesh = make_host_mesh(model_parallel=4)
assert mesh.devices.size == 4, mesh
out = {}
scale = float(data["scale"])
for i in range(int(data["n_decode"])):
    args = [jnp.asarray(data[f"d{i}_{n}"]) for n in ("q", "k", "v", "pos")]
    t = jnp.asarray(int(data[f"d{i}_t"]), jnp.int32)
    window = int(data[f"d{i}_window"]) or None
    cap = float(data[f"d{i}_cap"]) or None
    kw = dict(window=window, logit_softcap=cap, scale=scale)
    with mesh, use_rules(ShardingRules({"kv_seq": "model",
                                        "kv_batch": "data"}), mesh):
        out[f"d{i}"] = np.asarray(attn.sharded_flash_decode(*args, t, **kw))
    out[f"d{i}_local"] = np.asarray(attn.flash_decode(*args, t, **kw))
for i in range(int(data["n_seq"])):
    q, k, v, cot = (jnp.asarray(data[f"s{i}_{n}"])
                    for n in ("q", "k", "v", "cot"))
    kw = dict(window=int(data[f"s{i}_window"]) or None,
              logit_softcap=float(data["softcap"]), scale=scale)
    with mesh, use_rules(ShardingRules({"attn_seq": "model",
                                        "act_batch": "data"}), mesh):
        out[f"s{i}_sp"] = np.asarray(attn.seq_parallel_flash(q, k, v, **kw))

    def full(q, k, v):
        return attn.flash_attention(q, k, v, causal=True, **kw)

    out[f"s{i}_full"] = np.asarray(full(q, k, v))
    grads = jax.grad(lambda q, k, v: jnp.sum(full(q, k, v) * cot),
                     argnums=(0, 1, 2))(q, k, v)
    for n, g in zip(("dq", "dk", "dv"), grads):
        out[f"s{i}_{n}"] = np.asarray(g)
np.savez(sys.argv[2], **out)
'''


def ring_positions(t: int, slots: int) -> np.ndarray:
    """The positions a ring of ``slots`` holds after position t was
    written: p in slot p % slots, the last ``slots`` positions; -1 where
    unfilled."""
    j = np.arange(slots)
    if t + 1 >= slots:
        return (t - (t - j) % slots).astype(np.int32)
    return np.where(j <= t, j, -1).astype(np.int32)


def make_inputs(path) -> dict:
    rng = np.random.default_rng(26)

    def normal(*shape):
        return rng.normal(size=shape).astype(np.float32)

    data = {"scale": np.float32(SCALE), "softcap": np.float32(SOFTCAP),
            "n_decode": len(DECODES), "n_seq": len(WINDOWS)}
    for i, (t, window, cap) in enumerate(DECODES):
        data.update({f"d{i}_q": normal(B, H, D), f"d{i}_k": normal(
            B, KV, SLOTS, D), f"d{i}_v": normal(B, KV, SLOTS, D),
            f"d{i}_pos": ring_positions(t, SLOTS), f"d{i}_t": t,
            f"d{i}_window": window or 0, f"d{i}_cap": cap})
    for i, window in enumerate(WINDOWS):
        data.update({f"s{i}_q": normal(B, SEQ, H, D),
                     f"s{i}_k": normal(B, SEQ, KV, D),
                     f"s{i}_v": normal(B, SEQ, KV, D),
                     f"s{i}_cot": normal(B, SEQ, H, D),
                     f"s{i}_window": window})
    np.savez(path, **data)
    return data


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the reference's outputs, the port's): the JAX subprocess
    and the 4-rank world run at the same time."""
    d = tmp_path_factory.mktemp("sharded_attention")
    inputs = make_inputs(d / "inputs.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(d / "inputs.npz"),
         str(d / "reference.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        run_world("sharded_attention", WORLD, d,
                  inputs=str(d / "inputs.npz"))
    finally:
        log = jax_proc.communicate(timeout=600)[0]
    assert jax_proc.returncode == 0, log[-6000:]
    return (inputs, dict(np.load(d / "reference.npz")),
            dict(np.load(d / "port_attention.npz")))


def within(got, want, tol, what):
    err = np.abs(got - want)
    limit = tol * (np.abs(want).max() + np.abs(want))
    assert got.shape == want.shape and (err <= limit).all(), (
        f"{what}: max err {err.max()} (limit {tol} of the scale)")


@pytest.mark.parametrize("case", range(len(DECODES)))
def test_sharded_decode_matches_reference(runs, case):
    """The port's 4-shard decode equals the reference's sharded decode
    (and its local one) within 2e-5, in every case: wrapped, windowed,
    softcapped, a partial prefix, and shards with no valid slot."""
    _, want, got = runs
    within(got[f"d{case}"], want[f"d{case}"], TOL, f"decode {DECODES[case]}")
    within(got[f"d{case}"], want[f"d{case}_local"], TOL, "local decode")


@pytest.mark.parametrize("case", range(len(WINDOWS)))
def test_seq_parallel_matches_unsharded_attention(runs, case):
    """The port's sequence-parallel attention equals the reference's
    unsharded ``flash_attention`` within 2e-5 at every window, stays
    sequence-sharded, and its q / k / v gradients equal ``jax.grad`` of
    the unsharded attention within 1e-4."""
    _, want, got = runs
    within(got[f"s{case}"], want[f"s{case}_full"], TOL,
           f"window {WINDOWS[case]}")
    # "data" holds one rank (replicated); "model" splits the sequence.
    assert list(got[f"s{case}_shard_dims"]) == [-1, 1]
    for n in ("dq", "dk", "dv"):
        within(got[f"s{case}_{n}"], want[f"s{case}_{n}"], GRAD_TOL, n)


def test_seq_parallel_matches_reference_without_window(runs):
    _, want, got = runs
    within(got["s0"], want["s0_sp"], TOL, "no window")


@pytest.mark.parametrize("case", [1, 2])
def test_reference_windowed_seq_parallel_diverges(runs, case):
    """Pinned reference caveat: with a window, the reference's
    ``seq_parallel_flash`` departs from its own unsharded attention by
    more than 1.0 on the rows of shards 1-3 (its windowed branch slices
    keys from ``i * qb`` without ``q_offset``,
    ``src/repro/models/attention.py:111``), and agrees on shard 0."""
    _, want, _ = runs
    per = SEQ // WORLD
    diff = np.abs(want[f"s{case}_sp"] - want[f"s{case}_full"])
    within(want[f"s{case}_sp"][:, :per], want[f"s{case}_full"][:, :per],
           TOL, "shard 0")
    for shard in range(1, WORLD):
        assert diff[:, shard * per:(shard + 1) * per].max() > 1.0, shard


def test_plain_lse_matches_reference_local_decode():
    """The plain version's row log-sum-exp (``return_lse``) equals m +
    log l of the reference's ``_local_decode`` within 1e-5, over a ring
    prefix, with and without a softcap; a row with no key gives -inf."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, KV, SLOTS, D)).astype(np.float32)
            for _ in range(2))
    for n, cap in ((SLOTS, None), (11, 30.0)):
        valid = jnp.broadcast_to(jnp.arange(SLOTS) < n, (B, SLOTS))
        _, m, l = jattn._local_decode(
            jnp.asarray(q).reshape(B, KV, H // KV, D), jnp.asarray(k),
            jnp.asarray(v), valid, SCALE, cap)
        want = np.asarray(m + jnp.log(l)).reshape(B, H)
        kt, vt = (torch.from_numpy(x[:, :, :n]).transpose(1, 2)
                  for x in (k, v))
        _, lse = ref.flash_attention_ref(
            torch.from_numpy(q)[:, None], kt, vt, causal=False,
            softcap=cap, scale=SCALE, return_lse=True)
        assert lse.dtype == torch.float32 and lse.shape == (B, 1, H)
        np.testing.assert_allclose(lse[:, 0].numpy(), want, rtol=1e-5,
                                   atol=1e-5)
    _, lse = ref.flash_attention_ref(
        torch.from_numpy(q)[:, None].repeat(1, 4, 1, 1),
        torch.from_numpy(k).transpose(1, 2), torch.from_numpy(v).transpose(
            1, 2), causal=True, q_offset=-2, return_lse=True)
    assert torch.isneginf(lse[:, :2]).all() and torch.isfinite(
        lse[:, 2:]).all()
