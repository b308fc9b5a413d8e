"""How far the JAX package's own reduced LMs move when their weights move
by one fp32 rounding: the yardstick the LM parity tolerances
(``tests/_torch_lm.py``) are set against.

    PYTHONPATH=src:tests python tests/lm_sensitivity.py [ARCH ...]

For each arch (default: yi-6b and the MoE, Mamba and xLSTM configs) the
reference runs the parity tests' cases twice, on its weights as ``pair``
builds them and again with every fp32 leaf moved one step to a neighbouring
float (the direction drawn per element): the loss's gradients (each leaf's
largest change as a share of that leaf's largest magnitude, the worst leaf
but an sLSTM's input-gate bias, on which the loss does not depend), and
the prefill logits, prefill caches and 3 decode steps' logits (each
tensor's largest change as a share of its largest magnitude). It prints
the worst share over 3 draws, at the reference's own init and, for the
MoE, Mamba and xLSTM configs, on the layer-scaled weights the tests use
(``chip_smoke.layer_scale_``). CPU only; nothing here is timed.
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _torch_lm as L  # noqa: E402

DRAWS = 3


def _nudge(tree, rng):
    def one(w):
        w = np.asarray(w)
        if w.dtype != np.float32:
            return jnp.asarray(w)
        to = np.where(rng.random(w.shape) < 0.5, -np.inf, np.inf)
        return jnp.asarray(np.nextafter(w, to.astype(np.float32)))
    return jax.tree_util.tree_map(one, tree)


def _share(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(a).max()
    return float(np.abs(a - b).max() / scale) if scale else 0.0


def _forward(jm, p, toks):
    s, extra, capacity = 12, 3, 16
    logits, caches = jm.prefill(p, jnp.asarray(toks[:, :s]),
                                cache_capacity=capacity)
    out = {"prefill logits": [logits],
           "prefill caches": jax.tree_util.tree_leaves(caches)}
    for i in range(extra):
        logits, caches = jm.decode_step(
            p, jnp.asarray(toks[:, s + i:s + i + 1]), jnp.asarray(s + i),
            caches)
        out.setdefault("decode logits", []).append(logits)
    return out


def _grads(jm, p, data):
    flat = jax.tree_util.tree_flatten_with_path(
        jax.grad(lambda q: jm.loss(q, data)[0])(p))[0]
    return {jax.tree_util.keystr(k): v for k, v in flat
            if not (k[-1] == jax.tree_util.DictKey("b_i")
                    and "'r_i'" in str(flat))}


def sensitivity(name: str, scaled: bool) -> dict:
    saved = L.MIXER_ARCHS
    L.MIXER_ARCHS = saved if scaled else ()
    try:
        jm, jp, _, _ = L.pair(name)
    finally:
        L.MIXER_ARCHS = saved
    toks = L.batch(jm.cfg, seed=2, s=15)["inputs"]
    data = L.batch(jm.cfg, seed=1)
    base_f, base_g = _forward(jm, jp, toks), _grads(jm, jp, data)
    slstm_bias = [k for k in base_g if k.endswith("['b_i']")
                  and k.replace("['b_i']", "['r_i']") in base_g]
    worst = {}
    for draw in range(DRAWS):
        p = _nudge(jp, np.random.default_rng(100 + draw))
        f, g = _forward(jm, p, toks), _grads(jm, p, data)
        for key, tensors in base_f.items():
            worst[key] = max([worst.get(key, 0.0)] + [
                _share(a, b) for a, b in zip(tensors, f[key])])
        worst["gradients"] = max([worst.get("gradients", 0.0)] + [
            _share(base_g[k], g[k]) for k in base_g if k not in slstm_bias])
    return worst


def main(names) -> None:
    for name in names:
        inits = [False] + ([True] if name in L.MIXER_ARCHS else [])
        for scaled in inits:
            worst = sensitivity(name, scaled)
            print(f"{name:16s} {'layer-scaled' if scaled else 'own init':12s}"
                  + "".join(f"  {k} {v:.2e}" for k, v in worst.items()),
                  flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["yi-6b", "mixtral-8x7b", "jamba-v0.1-52b",
                          "xlstm-125m"])
