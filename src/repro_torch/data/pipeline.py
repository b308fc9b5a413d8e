"""FramePipeline — the session's data plane, with speculative prefetch.

The engine (core/session.py) cannot prefetch its frame windows the way the
dispatch bench does, because window bounds depend on the virtual clock: the
span a score or labeling window covers is only known once the phase's kernel
costs have been charged. This module closes that gap with *speculation*: the
pipeline records the frame requests of each phase as offsets from the phase
start, and when the next phase opens it replays that trace — last phase's
layout as the predicted next-window bounds — synthesizing the predicted
windows on a background thread while the device executes. At each request
the pipeline *reconciles*: a prediction that matches serves its prefetched
frames (a **speculation hit** — host synthesis overlapped device dispatch);
anything else is synthesized inline exactly as before and recorded as a
**speculation miss**. Mispredictions can therefore never change results,
only forfeit overlap.

Bit-identity of hits is structural, not probabilistic: a frame of
:class:`~repro_torch.data.stream.DriftStream` depends on its timestamp only
through ``round(t, 4)`` (the per-frame hash input) and its segment index, so
a predicted window is declared a hit **only if** every predicted timestamp
agrees with the requested one on both — in which case the prefetched arrays
are bit-identical to what inline slicing would synthesize. This also makes
the matcher robust to the float-accumulation jitter inherent in replaying
clock offsets from a different phase start (an ulp of drift almost never
moves the 4-decimal rounding, and when it does, the result is a miss, never
a wrong frame).

``FramePipeline`` is the only frame source the session loop touches; the
dispatch layer binds it into each :class:`~repro_torch.core.dispatch.PhasePlan`
(``plan.fetch``) so concurrent dispatch issues device programs against
prefetched, host-ready windows.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.data.stream import DriftStream

# A window key: one (rounded-time, segment-index) pair per frame.
_WindowKey = Tuple[Tuple[str, int], ...]


def _window_key(stream: DriftStream, t0: float, t1: float,
                max_frames: int) -> _WindowKey:
    """Identity of the frames a request renders, without synthesizing them."""
    times = stream.frame_times(t0, t1, max_frames)
    return tuple((f"{float(t):.4f}", stream.segment_index(float(t)))
                 for t in times)


class _SpecWindow:
    """One predicted window: spec + synthesis rendezvous."""

    __slots__ = ("t0", "t1", "max_frames", "key", "ready", "x", "y",
                 "consumed")

    def __init__(self, t0: float, t1: float, max_frames: int,
                 key: _WindowKey):
        self.t0, self.t1, self.max_frames = t0, t1, max_frames
        self.key = key
        self.ready = threading.Event()
        self.x: Optional[np.ndarray] = None
        self.y: Optional[np.ndarray] = None
        self.consumed = False


class _SpecBatch:
    """The predictions for one phase, synthesized in request order."""

    __slots__ = ("windows", "index", "cancelled")

    def __init__(self, windows: List[_SpecWindow]):
        self.windows = windows
        self.index: Dict[_WindowKey, _SpecWindow] = {}
        for w in windows:
            self.index.setdefault(w.key, w)
        self.cancelled = False


@dataclasses.dataclass
class SpeculationStats:
    """Cumulative speculation counters (see ``FramePipeline.stats``)."""

    hits: int = 0
    misses: int = 0
    windows_speculated: int = 0
    windows_wasted: int = 0  # predicted but never consumed
    windows_hinted: int = 0  # pre-sized by a decision-aware label hint
    phases: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class FramePipeline:
    """Single data plane over a :class:`DriftStream` with speculative
    per-phase window prefetch.

    ``frames(t0, t1, max_frames)`` is a drop-in for ``stream.frames`` — same
    signature, bit-identical output — that additionally serves matching
    speculated windows from the background worker. ``begin_phase(start)``
    (called by the dispatch layer when a phase plan opens) rotates the
    request trace: the finished phase's trace, rebased onto the new phase
    start, becomes the speculation for the phase now beginning.

    With ``speculative=False`` the pipeline degenerates to transparent
    inline slicing (no worker thread, no counters) — the mode sequential
    sessions use, where the golden tests pin the seed numerics.
    """

    def __init__(self, stream: DriftStream, speculative: bool = True,
                 max_prefetch: int = 64, reconcile_timeout_s: float = 5.0):
        self.stream = stream
        self.speculative = speculative
        self.max_prefetch = max_prefetch
        # Anti-stall bound on waiting for a matched window still being
        # synthesized (the worker may be draining a cancelled batch's
        # in-flight window first). Orders of magnitude above any single
        # window's synthesis time, so it only fires pathologically; on
        # timeout the request degrades to an inline miss — never a stall,
        # never a wrong frame.
        self.reconcile_timeout_s = reconcile_timeout_s
        self.stats = SpeculationStats()
        # Request trace: (dt0, dt1, max_frames, tag) offsets from the phase
        # start; ``tag`` marks the window's role ("label" for the labeling
        # burst) so decision-aware hints can pre-size it on rotation.
        self._trace: List[Tuple[float, float, int, Optional[str]]] = []
        self._phase_start: Optional[float] = None
        self._batch: Optional[_SpecBatch] = None
        self._queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._worker: Optional[threading.Thread] = None

    # ------------------------------------------------------------- proxies
    @property
    def duration(self) -> float:
        return self.stream.duration

    @property
    def fps(self) -> float:
        return self.stream.fps

    # ------------------------------------------------------------- stats
    @property
    def hits(self) -> int:
        return self.stats.hits

    @property
    def misses(self) -> int:
        return self.stats.misses

    @property
    def hit_rate(self) -> float:
        return self.stats.hit_rate

    # -------------------------------------------------------------- worker
    def _ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._worker_loop,
                                            daemon=True)
            self._worker.start()

    def _worker_loop(self) -> None:
        while not self._stop.is_set():
            batch = self._queue.get()
            if batch is None:
                return
            try:
                for w in batch.windows:
                    if batch.cancelled or self._stop.is_set():
                        break
                    try:
                        x, y = self.stream.frames(w.t0, w.t1,
                                                  max_frames=w.max_frames)
                    except Exception:
                        break  # surviving windows stay unset -> misses
                    w.x, w.y = x, y
                    w.ready.set()
            finally:
                for w in batch.windows:
                    w.ready.set()  # unset windows reconcile as misses

    # -------------------------------------------------------------- phases
    def begin_phase(self, start: float,
                    label_hint: Optional[Tuple[int, float]] = None) -> None:
        """Open a phase at virtual time ``start``: retire the previous
        phase's speculation, and speculate this phase from its trace.

        ``label_hint`` is the decision-aware predictor (ROADMAP "smarter
        speculation"): at the phase barrier the session already knows the
        next decision's labeling budget, so a ``(n_samples, fps)`` hint
        pre-sizes every ``"label"``-tagged window of the replayed trace to
        the upcoming burst — on drift phases the N_ldd burst prefetches
        whole instead of replaying (and missing on) the last phase's small
        layout. Mis-sized hints behave like any misprediction: a reconcile
        miss, never a wrong frame."""
        prev_trace = self._trace
        self._trace = []
        self._phase_start = start
        if not self.speculative:
            return
        self.stats.phases += 1
        if self._batch is not None:
            self._batch.cancelled = True
            self.stats.windows_wasted += sum(
                1 for w in self._batch.windows if not w.consumed)
            self._batch = None
        if not prev_trace:
            return
        windows = []
        for dt0, dt1, mf, tag in prev_trace[:self.max_prefetch]:
            if (label_hint is not None and tag == "label"
                    and mf != label_hint[0]):
                n, fps = label_hint
                dt1, mf = dt0 + n / fps, int(n)
                self.stats.windows_hinted += 1
            windows.append(
                _SpecWindow(start + dt0, start + dt1, mf,
                            _window_key(self.stream, start + dt0,
                                        start + dt1, mf)))
        self._batch = _SpecBatch(windows)
        self.stats.windows_speculated += len(windows)
        self._ensure_worker()
        self._queue.put(self._batch)

    # -------------------------------------------------------------- frames
    def frames(self, t0: float, t1: float, max_frames: int = 0,
               tag: Optional[str] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Frames in [t0, t1) — bit-identical to ``stream.frames``, served
        from the speculation when the prediction reconciles. ``tag`` names
        the window's role in the phase layout (``"label"`` enables
        decision-aware pre-sizing on the next rotation)."""
        if not self.speculative:
            return self.stream.frames(t0, t1, max_frames=max_frames)
        if self._phase_start is not None:
            self._trace.append((t0 - self._phase_start,
                                t1 - self._phase_start, max_frames, tag))
        batch = self._batch
        if batch is not None and not batch.cancelled:
            w = batch.index.get(_window_key(self.stream, t0, t1, max_frames))
            if w is not None and not w.consumed:
                # ready is set only after both arrays are stored, so it also
                # guards the timeout path against a torn read.
                if w.ready.wait(self.reconcile_timeout_s) and w.x is not None:
                    w.consumed = True
                    self.stats.hits += 1
                    return w.x, w.y
        self.stats.misses += 1
        return self.stream.frames(t0, t1, max_frames=max_frames)

    # --------------------------------------------------------------- close
    def close(self) -> None:
        """Stop the worker; the pipeline keeps serving frames inline."""
        self._stop.set()
        if self._batch is not None:
            self._batch.cancelled = True
            self.stats.windows_wasted += sum(
                1 for w in self._batch.windows if not w.consumed)
            self._batch = None
        self._queue.put(None)  # unblock the queue.get
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        self.speculative = False

    def __del__(self):
        self._stop.set()
        try:
            self._queue.put_nowait(None)
        except Exception:
            pass
