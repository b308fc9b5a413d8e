"""Fixed-capacity labeled sample buffer (Algorithm 1 state).

Host-side numpy storage: the buffer lives across retraining/labeling phases
and is the unit the scheduler draws D_t/D_v from and resets on drift. The
buffer is also a unit of lane state the fleet tier checkpoints and
migrates: ``state_dict``/``load_state_dict`` round-trip both the stored
samples and the draw RNG's bit-generator state, so a restored lane's future
``get_data`` permutations and evictions are bit-identical to the lane that
was snapshotted.
"""
from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import numpy as np


class SampleBuffer:
    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = int(capacity)
        self._x: Optional[np.ndarray] = None
        self._y: Optional[np.ndarray] = None
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return 0 if self._x is None else len(self._x)

    @property
    def full(self) -> bool:
        return len(self) >= self.capacity

    def update(self, x: np.ndarray, y: np.ndarray) -> None:
        """UpdateBuffer (Alg. 1 line 14): append, evict oldest beyond C_b."""
        assert len(x) == len(y)
        if self._x is None:
            self._x, self._y = np.asarray(x).copy(), np.asarray(y).copy()
        else:
            self._x = np.concatenate([self._x, x])
            self._y = np.concatenate([self._y, y])
        if len(self._x) > self.capacity:
            self._x = self._x[-self.capacity:]
            self._y = self._y[-self.capacity:]

    def reset(self) -> None:
        """ResetBuffer (Alg. 1 line 12): drop outdated samples on drift."""
        self._x, self._y = None, None

    def state_dict(self) -> Dict[str, object]:
        """Snapshot for lane checkpoint/migration: stored samples plus the
        draw RNG's bit-generator state (a plain dict, deep-copied so later
        mutation of the live buffer can't alias into the snapshot)."""
        return {
            "x": None if self._x is None else self._x.copy(),
            "y": None if self._y is None else self._y.copy(),
            "capacity": self.capacity,
            "rng_state": copy.deepcopy(self._rng.bit_generator.state),
        }

    def load_state_dict(self, state: Dict[str, object]) -> None:
        """Restore a :meth:`state_dict` snapshot bit-exactly — the next
        ``get_data``/``update`` behaves as on the snapshotted buffer."""
        self.capacity = int(state["capacity"])
        x, y = state["x"], state["y"]
        self._x = None if x is None else np.asarray(x).copy()
        self._y = None if y is None else np.asarray(y).copy()
        self._rng.bit_generator.state = copy.deepcopy(state["rng_state"])

    def get_data(self, n_train: int,
                 n_valid: int) -> Tuple[np.ndarray, np.ndarray,
                                        np.ndarray, np.ndarray]:
        """GetData (Alg. 1 line 4): disjoint D_t / D_v draws."""
        n = len(self)
        if n == 0:
            raise ValueError("empty sample buffer")
        idx = self._rng.permutation(n)
        n_valid = min(n_valid, max(1, n // 5))
        n_train = min(n_train, n - n_valid)
        ti, vi = idx[:n_train], idx[n_train:n_train + n_valid]
        return self._x[ti], self._y[ti], self._x[vi], self._y[vi]
