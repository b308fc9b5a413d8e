"""The three concurrent CL kernels as first-class objects (paper Fig. 4) —
the JAX package's ``core/kernel.py`` ported.

* ``InferenceKernel``  — student, every frame, B-SA;
* ``LabelingKernel``   — teacher pseudo-labels on sampled frames, T-SA;
* ``RetrainKernel``    — student SGD on the sample buffer, T-SA.

Each kernel owns its model's forward, its MX serving copy, its
virtual-clock cost on the estimator, its ``device`` and, when a partition
that is not time-shared is bound, its sub-mesh, onto whose first device it
stages its inputs. The ``*_async`` methods return device tensors without a
host sync (CUDA runs on while the host issues the next program); the
session collects at the phase barrier, and ``predict`` / ``label`` are the
host-returning wrappers for callers outside the hot path. Every inference
or labeling forward adds one to ``n_apply_calls``. With ``apply_mx``,
serving copies are MX quantized through ``ServingParamsCache`` →
``core/mx.py`` → ``kernels/ops.py``: on the card a whole tree goes through
one launch of the hand-written quantize kernel and one of the dequantize
kernel. A fleet labels every lane's burst in one microbatched pass
(:meth:`LabelingKernel.label_fleet_async`) and may serve every lane's
student in one ``torch.func.vmap`` program
(:meth:`InferenceKernel.predict_fleet_async`).
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import (List, Optional, Protocol, Sequence, Tuple,
                    runtime_checkable)

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.dacapo_pairs import VisionConfig
from repro_torch.core import mx as mx_lib
from repro_torch.core.partition import SpatialPartition
from repro_torch.device import DeviceLike, resolve_device, same_device
from repro_torch.tree import tree_map


class _CacheSlot:
    """One (tree, precision) cache line: ``quantized`` is the RESIDENT MX
    copy (``mx_lib.MXLeaf`` leaves), ``value`` the memoized fake-quant fp32
    tree the forward consumes. The slot's lock serializes the fill and the
    lazy dequantize for this key only."""

    __slots__ = ("lock", "quantized", "value")

    def __init__(self):
        self.lock = threading.Lock()
        self.quantized = None
        self.value = None


class ServingParamsCache:
    """Version-keyed cache of RESIDENT quantized serving copies.

    Entries key on (source-tree identity, precision) and hold a strong
    reference to the source tree, pinning its ``id`` for the entry's
    lifetime. That makes identity a sound version key because the port
    never mutates a tree it has handed out: retraining builds a NEW tree
    (new dict, new tensors) every SGD step, so a retrained tree can never
    be served a stale copy, and :meth:`RetrainKernel.fit` also invalidates
    the tree it supersedes. ``maxsize=0`` disables caching; eviction is
    LRU. The cache-wide lock covers bookkeeping only; each slot carries its
    own fill lock, and racing getters of one key produce exactly one fill
    (``fills`` counts the whole-tree quantizations executed).
    """

    def __init__(self, maxsize: int = 8):
        self.maxsize = maxsize
        self.hits = 0
        self.misses = 0
        self.fills = 0
        self._lock = threading.RLock()
        # id(source tree) -> (source tree, {precision: _CacheSlot})
        self._entries: "OrderedDict[int, tuple]" = OrderedDict()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def _claim(self, params, precision: str) -> _CacheSlot:
        key = id(params)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and entry[0] is params:
                slot = entry[1].get(precision)
                if slot is not None:
                    self.hits += 1
                    self._entries.move_to_end(key)
                    return slot
            self.misses += 1
            slot = _CacheSlot()
            if self.maxsize <= 0:
                return slot  # unpublished: the uncached baseline refills
            if entry is None or entry[0] is not params:
                entry = (params, {})
                self._entries[key] = entry
            entry[1][precision] = slot
            self._entries.move_to_end(key)
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
            return slot

    def _count_fill(self) -> None:
        with self._lock:
            self.fills += 1

    def get(self, params, precision: str, quantize=None):
        """The fake-quant fp32 serving tree: fill the resident quantized
        copy (once per key), dequantize it lazily (once per key) —
        bit-identical to ``quantize_tree(params, precision)``. A custom
        ``quantize(params, precision)`` callable's return value is stored
        as the served tree instead (a test and bench hook); the fill is
        counted all the same."""
        slot = self._claim(params, precision)
        with slot.lock:
            if slot.quantized is None and slot.value is None:
                self._count_fill()
                if quantize is not None:
                    slot.value = quantize(params, precision)
                else:
                    slot.quantized = mx_lib.quantize_tree_mx(params,
                                                             precision)
            if slot.value is None:
                slot.value = mx_lib.dequantize_tree_mx(slot.quantized)
            return slot.value

    def get_quantized(self, params, precision: str):
        """The RESIDENT copy — weight leaves as ``mx_lib.MXLeaf`` — for
        consumers that feed quantized operands straight to the kernels."""
        slot = self._claim(params, precision)
        with slot.lock:
            if slot.quantized is None:
                self._count_fill()
                slot.quantized = mx_lib.quantize_tree_mx(params, precision)
            return slot.quantized

    def invalidate(self, params=None) -> None:
        """Drop the entries of ``params`` — or everything when ``None``."""
        with self._lock:
            if params is None:
                self._entries.clear()
                return
            entry = self._entries.get(id(params))
            if entry is not None and entry[0] is params:
                del self._entries[id(params)]

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "entries": len(self._entries)}


@runtime_checkable
class Kernel(Protocol):
    """What the engine requires of a kernel."""

    name: str
    role: str  # "t_sa" | "b_sa" — which sub-accelerator it runs on

    def bind_partition(self, partition: SpatialPartition) -> None:
        """Adopt a sub-mesh placement (no-op when time-shared)."""

    def time_per_sample(self, rows: int, precision: str) -> float:
        """Virtual-clock seconds per sample at the given row count."""


class _PlacedKernel:
    """Shared logic: the kernel's device and sub-mesh, staging of host
    inputs onto the bound device, and the spatial-plane view of the cost
    methods (each kernel reads its own rows by ``role`` and precision by
    ``precision_field``)."""

    role = "t_sa"
    precision_field = "retraining"

    def __init__(self, model, device: DeviceLike):
        self.model = model
        self.device = model.device if device is None else resolve_device(
            device)
        self.submesh = None
        self._device = None  # the sub-mesh's first device, when bound
        self.n_apply_calls = 0  # forwards issued (tests and benches)

    def plan_rows(self, spatial, role: Optional[str] = None) -> int:
        role = role or self.role
        return spatial.rows_bsa if role == "b_sa" else spatial.rows_tsa

    def plan_precision(self, spatial) -> str:
        return getattr(spatial.precisions, self.precision_field)

    def plan_time_per_sample(self, spatial,
                             role: Optional[str] = None) -> float:
        return self.time_per_sample(self.plan_rows(spatial, role),
                                    self.plan_precision(spatial))

    def bind_partition(self, partition: SpatialPartition) -> None:
        """Time-shared: no placement. Otherwise the kernel takes its role's
        sub-mesh and stages onto that mesh's first device."""
        if partition.time_shared:
            self.submesh, self._device = None, None
            return
        self.submesh = (partition.b_sa if self.role == "b_sa"
                        else partition.t_sa)
        self._device = (None if self.submesh is None
                        else self.submesh.devices.flat[0])

    def _put(self, x, dtype=None) -> torch.Tensor:
        dev = self.device if self._device is None else self._device
        return torch.as_tensor(x, dtype=dtype, device=dev)

    def _placed(self, params):
        """The model and ``params`` on the bound device: moved there with
        ``.to()`` where it is not the model's own (never on a host whose
        mesh repeats one card)."""
        dev = self._device
        if dev is None or same_device(dev, self.model.device):
            return self.model, params
        return (dataclasses.replace(self.model, device=dev),
                tree_map(lambda p: p.to(dev), params))

    def _run_apply(self, params, x) -> torch.Tensor:
        self.n_apply_calls += 1
        model, params = self._placed(params)
        with torch.no_grad():
            return model.apply(params, self._put(x))


class InferenceKernel(_PlacedKernel):
    """Student inference on the B-SA: serves every frame, scores accuracy."""

    name = "inference"
    role = "b_sa"
    precision_field = "inference"

    def __init__(self, model, full_cfg: VisionConfig, estimator,
                 apply_mx: bool, device: DeviceLike = None):
        super().__init__(model, device)
        self.full_cfg = full_cfg
        self.estimator = estimator
        self.apply_mx = apply_mx
        self._apply_fleet = None  # (model, its vmapped apply), built lazily
        self.serving_cache = ServingParamsCache()

    def serving_params(self, params, precision: str):
        """UpdateWeight (Alg. 1 line 6): the serving copy at the inference
        precision (the retraining master stays fp32), from the
        version-keyed :class:`ServingParamsCache`."""
        if self.apply_mx:
            return self.serving_cache.get(params, precision)
        return params

    def serving_quantized(self, params, precision: str):
        """The RESIDENT quantized serving copy (weight leaves as
        ``mx_lib.MXLeaf``) — for weight-resident consumers that feed
        ``ops.mx_matmul_prequant`` directly instead of ``model.apply``."""
        if self.apply_mx:
            return self.serving_cache.get_quantized(params, precision)
        return params

    def predict_async(self, params, x) -> torch.Tensor:
        """Class ids as a device tensor — no host sync."""
        return torch.argmax(self._run_apply(params, x), -1)

    def predict(self, params, x) -> np.ndarray:
        return self.predict_async(params, x).cpu().numpy()

    def predict_batched(self, params,
                        windows: Sequence[np.ndarray]) -> List[torch.Tensor]:
        """Fuse several frame windows into ONE forward, split back per
        window (GroupNorm has no cross-batch statistics, so the fused
        predictions equal the per-window ones)."""
        if not windows:
            return []
        if len(windows) == 1:
            return [self.predict_async(params, windows[0])]
        sizes = [len(w) for w in windows]
        fused = self.predict_async(params, np.concatenate(windows, axis=0))
        return list(torch.split(fused, sizes))

    def predict_fleet_async(self, params_list: Sequence,
                            windows: Sequence[np.ndarray]
                            ) -> List[torch.Tensor]:
        """Serve several lanes' frame windows in ONE program — the B-SA
        mirror of :meth:`LabelingKernel.label_fleet_async`.

        Each lane serves its own student tree, so the trees are stacked on
        a new leading axis, the windows zero-padded to the longest lane and
        stacked likewise, and one ``torch.func.vmap`` of the model's apply
        serves the whole fleet (the ViT's attention kernel folds the lane
        axis into its batch axis); per-lane predictions come back as
        device-side slices, pad rows dropped. A single lane takes the exact
        ``predict_async`` path. A vmapped convolution with per-lane weights
        runs as a grouped convolution, which may differ from the per-lane
        forwards in the last bits — why ``FleetSpec.serve_batched`` is
        off by default."""
        if not windows:
            return []
        if len(windows) == 1:
            return [self.predict_async(params_list[0], windows[0])]
        sizes = [len(w) for w in windows]
        n_max = max(sizes)
        padded = np.stack([
            w if len(w) == n_max else np.concatenate(
                [w, np.zeros((n_max - len(w),) + w.shape[1:], w.dtype)])
            for w in windows])
        stacked = tree_map(lambda *leaves: torch.stack(leaves), *params_list)
        model, stacked = self._placed(stacked)
        if self._apply_fleet is None or self._apply_fleet[0] is not model:
            self._apply_fleet = (model, torch.func.vmap(model.apply))
        self.n_apply_calls += 1
        with torch.no_grad():
            logits = self._apply_fleet[1](stacked, self._put(padded))
        preds = torch.argmax(logits, -1)
        return [preds[i, :size] for i, size in enumerate(sizes)]

    def time_per_sample(self, rows: int, precision: str) -> float:
        return self.estimator.forward_time(self.full_cfg, rows, precision,
                                           batch=1)

    def fps(self, rows: int, precision: str) -> float:
        return self.estimator.inference_fps(self.full_cfg, rows, precision)

    def keep_frac(self, rows: int, precision: str,
                  target_fps: float) -> float:
        """Fraction of stream frames the B-SA sustains (paper Fig. 2)."""
        return min(1.0, self.fps(rows, precision) / target_fps)

    def plan_keep_frac(self, spatial, target_fps: float) -> float:
        return self.keep_frac(spatial.rows_bsa, spatial.precisions.inference,
                              target_fps)


class LabelingKernel(_PlacedKernel):
    """Teacher pseudo-labeling on the T-SA (time-shared with retraining)."""

    name = "labeling"
    role = "t_sa"
    precision_field = "labeling"

    def __init__(self, model, full_cfg: VisionConfig, estimator,
                 apply_mx: bool, device: DeviceLike = None):
        super().__init__(model, device)
        self.full_cfg = full_cfg
        self.estimator = estimator
        self.apply_mx = apply_mx
        self.serving_cache = ServingParamsCache()

    def label_async(self, params, x, precision: str,
                    microbatch: Optional[int] = None) -> torch.Tensor:
        """Pseudo-labels as a device tensor (no host sync); ``microbatch``
        splits large bursts into chunks. The teacher's serving copy comes
        from the version-keyed cache: its tree never changes, so every
        burst after the first is a hit."""
        if self.apply_mx:
            params = self.serving_cache.get(params, precision)
        if microbatch and len(x) > microbatch:
            parts = [torch.argmax(self._run_apply(params,
                                                  x[i: i + microbatch]), -1)
                     for i in range(0, len(x), microbatch)]
            return torch.cat(parts)
        return torch.argmax(self._run_apply(params, x), -1)

    def label(self, params, x, precision: str,
              microbatch: Optional[int] = None) -> np.ndarray:
        return self.label_async(params, x, precision, microbatch).cpu().numpy()

    def label_fleet_async(self, params, bursts: Sequence[np.ndarray],
                          precision: str,
                          microbatch: Optional[int] = None
                          ) -> List[torch.Tensor]:
        """Label several streams' bursts in ONE pass over the shared T-SA:
        the bursts are concatenated, the *combined* burst microbatched
        (``ceil(sum(n_i) / mb)`` forwards — chunks cross stream
        boundaries), and the labels split back per stream as device-side
        slices. Per-sample models make the result equal to labeling each
        burst alone; a single burst takes the exact ``label_async``
        path."""
        bursts = list(bursts)
        if not bursts:
            return []
        if len(bursts) == 1:
            return [self.label_async(params, bursts[0], precision,
                                     microbatch)]
        sizes = [len(b) for b in bursts]
        fused = self.label_async(params, np.concatenate(bursts, axis=0),
                                 precision, microbatch)
        return list(torch.split(fused, sizes))

    def serving_quantized(self, params, precision: str):
        """The teacher's RESIDENT quantized copy (see
        :meth:`InferenceKernel.serving_quantized`)."""
        if self.apply_mx:
            return self.serving_cache.get_quantized(params, precision)
        return params

    def time_per_sample(self, rows: int, precision: str) -> float:
        return self.estimator.forward_time(self.full_cfg, rows, precision,
                                           batch=1)


def sgd_momentum_step(model, params, opt, x: torch.Tensor, y: torch.Tensor,
                      lr: float):
    """One SGD-with-momentum step on the cross-entropy of ``model``:
    ``m = 0.9 m + g``, ``p = p - lr m``. Functional — returns a NEW params
    tree and momentum tree and the loss; the inputs are not modified. Grad
    mode is per thread, so the step enables it itself: it runs alike on
    the caller's thread and on a manager's worker thread."""
    leaves = []

    def track(p):
        leaf = p.detach().requires_grad_(True)
        leaves.append(leaf)
        return leaf

    with torch.enable_grad():
        live = tree_map(track, params)
        logp = F.log_softmax(model.apply(live, x), dim=-1)
        loss = -logp.gather(1, y[:, None]).mean()
        flat_grads = iter(torch.autograd.grad(loss, leaves))
    grads = tree_map(lambda _: next(flat_grads), params)  # same visit order
    with torch.no_grad():
        new_opt = tree_map(lambda m, g: 0.9 * m + g, opt, grads)
        new_params = tree_map(lambda p, m: p - lr * m, params, new_opt)
    return new_params, new_opt, loss.detach()


class RetrainKernel(_PlacedKernel):
    """Student SGD-with-momentum retraining on the T-SA (fp32; the MX9
    retraining precision only prices the virtual clock, as in the
    reference)."""

    name = "retraining"
    role = "t_sa"
    precision_field = "retraining"

    def __init__(self, model, full_cfg: VisionConfig, estimator, hp,
                 device: DeviceLike = None):
        super().__init__(model, device)
        self.full_cfg = full_cfg
        self.estimator = estimator
        self.hp = hp
        # Serving caches to invalidate when retraining supersedes a tree
        # (the session wires the inference kernel's cache in here).
        self.invalidates: Tuple[ServingParamsCache, ...] = ()

    def _sgd_step(self, params, opt, x: torch.Tensor, y: torch.Tensor):
        model, params = self._placed(params)
        _, opt = self._placed(opt)
        return sgd_momentum_step(model, params, opt, x, y, self.hp.lr)

    def init_state(self, params):
        return tree_map(torch.zeros_like, params)

    def fit(self, params, opt, xt: np.ndarray, yt: np.ndarray,
            rng: np.random.Generator,
            epochs: Optional[int] = None) -> Tuple[object, object, int]:
        """Retrain (Alg. 1 line 5): epochs x minibatch SGD over D_t.
        Returns (params, opt, n_batches); n_batches is exactly the number
        of SGD steps executed. The superseded tree's serving copies are
        invalidated on every registered cache."""
        for cache in self.invalidates:
            cache.invalidate(params)
        hp = self.hp
        n_batches = 0
        for _ in range(epochs if epochs is not None else hp.epochs):
            perm = rng.permutation(len(xt))
            for i in range(0, len(xt) - hp.sgd_batch + 1, hp.sgd_batch):
                idx = perm[i: i + hp.sgd_batch]
                params, opt, _ = self._sgd_step(
                    params, opt, self._put(xt[idx]),
                    self._put(yt[idx], dtype=torch.long))
                n_batches += 1
        return params, opt, n_batches

    def time_per_batch(self, rows: int, precision: str) -> float:
        return self.estimator.train_step_time(self.full_cfg, rows, precision,
                                              self.hp.sgd_batch)

    def plan_time_per_batch(self, spatial) -> float:
        return self.time_per_batch(spatial.rows_tsa,
                                   spatial.precisions.retraining)

    def time_per_sample(self, rows: int, precision: str) -> float:
        return self.time_per_batch(rows, precision) / self.hp.sgd_batch
