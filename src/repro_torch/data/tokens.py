"""Synthetic LM token pipeline: deterministic, host-sharded batches (a
numpy-only copy of the JAX package's data/tokens.py, so its batches equal
the reference's bit for bit).

Tokens come from a fixed low-entropy bigram chain so cross-entropy has real
structure to learn (quickstart/train examples show loss decreasing). Batches
are generated per (step, host) so multihost data parallelism needs no
coordination — host h materializes only its slice of the global batch.
"""
from __future__ import annotations

import numpy as np


class TokenPipeline:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, branching: int = 4,
                 num_hosts: int = 1, host_index: int = 0):
        assert global_batch % num_hosts == 0
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.local_batch = global_batch // num_hosts
        self.host_index = host_index
        self.seed = seed
        rng = np.random.default_rng(seed)
        # Each token can be followed by `branching` successors, uniformly.
        self._succ = rng.integers(0, vocab_size,
                                  size=(vocab_size, branching))

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng(
            (self.seed, step, self.host_index, 7919))
        b, s = self.local_batch, self.seq_len
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab_size, size=b)
        choices = rng.integers(0, self._succ.shape[1], size=(b, s))
        for t in range(s):
            toks[:, t + 1] = self._succ[toks[:, t], choices[:, t]]
        return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
