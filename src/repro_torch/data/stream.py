"""Synthetic drifting video-analytics streams (BDD100K stand-in).

Reproduces the paper's drift taxonomy (§VII-A) exactly — three single-drift
attributes plus weather for the extreme scenarios:

* Label Distribution: "traffic" (classes 0-4, skewed) vs "all" (0-7);
* Time of Day: daytime vs night (brightness/contrast/blue shift);
* Location: city (high-frequency clutter) vs highway (smooth gradients);
* Weather: clear / overcast / rainy / snowy (noise overlays).

Scenario tables S1-S6 / ES1-ES2 mirror Table II: 20-minute streams at 30 FPS
built from 60-second segments; each segment flips one (regular) or all four
(extreme) attributes. Frames are generated deterministically from (scenario
seed, time) so every system variant scores the identical stream.
"""
from __future__ import annotations

import dataclasses
import hashlib
import queue
import threading
from typing import Iterator, List, Sequence, Tuple

import numpy as np

N_CLASSES = 8
IMG = 32
TRAFFIC_CLASSES = (0, 1, 2, 3, 4)


@dataclasses.dataclass(frozen=True)
class Segment:
    duration_s: float = 60.0
    label_dist: str = "traffic"  # traffic | all
    time_of_day: str = "day"  # day | night
    location: str = "city"  # city | highway
    weather: str = "clear"  # clear | overcast | rainy | snowy


def _alternate(n: int, **flips) -> List[Segment]:
    """n segments flipping the given attributes every segment."""
    segs = []
    for i in range(n):
        kw = {}
        for attr, (a, b) in flips.items():
            kw[attr] = a if (i // _PERIOD.get(attr, 1)) % 2 == 0 else b
        segs.append(Segment(**kw))
    return segs


# Different flip periods per attribute so drifts don't always coincide.
_PERIOD = {"label_dist": 1, "time_of_day": 2, "location": 3, "weather": 4}

_N_SEG = 20  # 20 x 60 s = 20 minutes (paper §VII-A)

SCENARIOS = {
    # Regular: one drift type at a time (Table II).
    "S1": dict(weather="clear", flips=dict(label_dist=("traffic", "all"))),
    "S2": dict(weather="overcast", flips=dict(label_dist=("traffic", "all"))),
    "S3": dict(weather="clear", flips=dict(label_dist=("traffic", "all"),
                                           time_of_day=("day", "night"))),
    "S4": dict(weather="snowy", flips=dict(label_dist=("traffic", "all"),
                                           time_of_day=("day", "night"))),
    "S5": dict(weather="clear", flips=dict(label_dist=("traffic", "all"),
                                           time_of_day=("day", "night"),
                                           location=("city", "highway"))),
    "S6": dict(weather="rainy", flips=dict(label_dist=("traffic", "all"),
                                           time_of_day=("day", "night"),
                                           location=("city", "highway"))),
    # Extreme: all four drift axes at once.
    "ES1": dict(weather=None, flips=dict(label_dist=("traffic", "all"),
                                         time_of_day=("day", "night"),
                                         location=("city", "highway"),
                                         weather=("clear", "rainy"))),
    "ES2": dict(weather=None, flips=dict(label_dist=("traffic", "all"),
                                         time_of_day=("night", "day"),
                                         location=("highway", "city"),
                                         weather=("snowy", "overcast"))),
}


def scenario(name: str, n_segments: int = _N_SEG) -> List[Segment]:
    spec = SCENARIOS[name]
    segs = _alternate(n_segments, **spec["flips"])
    if spec["weather"] is not None:
        segs = [dataclasses.replace(s, weather=spec["weather"]) for s in segs]
    return segs


class DriftStream:
    """Deterministic frame stream over a scenario."""

    def __init__(self, segments: Sequence[Segment], fps: float = 30.0,
                 seed: int = 0, img: int = IMG, n_classes: int = N_CLASSES):
        self.segments = list(segments)
        self.fps = fps
        self.seed = seed
        self.img = img
        self.n_classes = n_classes
        self._bounds = np.cumsum([s.duration_s for s in self.segments])
        rng = np.random.default_rng(seed + 1234)
        # Smooth per-class base patterns (low-frequency random fields).
        k = img // 4
        low = rng.normal(size=(n_classes, k, k, 3))
        self._class_patterns = np.stack(
            [np.kron(low[c], np.ones((4, 4, 1))) for c in range(n_classes)])
        self._city_tex = rng.normal(size=(img, img, 3)) * 0.6
        gradient = np.linspace(-1, 1, img)[:, None, None]
        self._highway_tex = np.broadcast_to(gradient, (img, img, 3)) * 0.6

    @property
    def duration(self) -> float:
        return float(self._bounds[-1])

    def segment_index(self, t: float) -> int:
        idx = int(np.searchsorted(self._bounds, t, side="right"))
        return min(idx, len(self.segments) - 1)

    def segment_at(self, t: float) -> Segment:
        return self.segments[self.segment_index(t)]

    def frame_times(self, t0: float, t1: float,
                    max_frames: int = 0) -> np.ndarray:
        """The exact frame timestamps ``frames(t0, t1, max_frames)`` renders.

        Split out so consumers (data/pipeline.py) can decide whether two
        requests produce identical frames without synthesizing either: a
        frame depends on its time only through ``round(t, 4)`` (the hash
        input) and its segment index, so matching those per timestamp is a
        bit-identity guarantee."""
        n = max(1, int(round((t1 - t0) * self.fps)))
        if max_frames and n > max_frames:
            return np.linspace(t0, t1, max_frames, endpoint=False)
        return t0 + np.arange(n) / self.fps

    def _label_probs(self, seg: Segment) -> np.ndarray:
        p = np.zeros(self.n_classes)
        if seg.label_dist == "traffic":
            p[list(TRAFFIC_CLASSES)] = (0.35, 0.25, 0.2, 0.12, 0.08)
        else:
            p[:] = 1.0 / self.n_classes
        return p

    def frames(self, t0: float, t1: float,
               max_frames: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """Frames in [t0, t1); optionally uniformly subsampled."""
        times = self.frame_times(t0, t1, max_frames)
        xs, ys = [], []
        for t in times:
            x, y = self._frame(float(t))
            xs.append(x)
            ys.append(y)
        return np.stack(xs), np.asarray(ys, np.int32)

    def _frame(self, t: float) -> Tuple[np.ndarray, int]:
        seg = self.segment_at(t)
        # Deterministic per-frame RNG.
        h = hashlib.blake2b(f"{self.seed}:{t:.4f}".encode(),
                            digest_size=8).digest()
        rng = np.random.default_rng(int.from_bytes(h, "little"))
        y = int(rng.choice(self.n_classes, p=self._label_probs(seg)))
        x = self._class_patterns[y] * 0.55
        x = x + rng.normal(size=x.shape) * 1.0  # instance noise
        # Location background.
        x = x + (self._city_tex if seg.location == "city"
                 else self._highway_tex)
        # Time of day.
        if seg.time_of_day == "night":
            x = x * 0.35
            x[..., 2] += 0.5  # blue shift
        # Weather.
        if seg.weather == "overcast":
            x = x * 0.7 + 0.2
        elif seg.weather == "rainy":
            streaks = (rng.random(x.shape[:2]) < 0.06)[..., None] * 1.5
            x = x * 0.8 + streaks
        elif seg.weather == "snowy":
            flakes = (rng.random(x.shape[:2]) < 0.10)[..., None] * 2.0
            x = x * 0.9 + flakes
        return x.astype(np.float32), y

    def windows(self, t0: float, t1: float, window_s: float,
                max_frames: int = 0,
                prefetch: int = 2) -> "PrefetchingWindowIterator":
        """Iterate ``(t_start, t_end, x, y)`` frame windows of ``window_s``
        seconds over [t0, t1), generated ``prefetch`` windows ahead on a
        background thread — see :class:`PrefetchingWindowIterator`."""
        spans = []
        t = t0
        while t < t1 - 1e-9:
            spans.append((t, min(t + window_s, t1)))
            t += window_s
        return PrefetchingWindowIterator(self, spans, max_frames=max_frames,
                                         depth=prefetch)

    def sample_dataset(self, n: int, rng: np.random.Generator,
                       segments: Sequence[Segment] = None):
        """IID samples across given segments (for pretraining).

        Uses the SAME seed as this stream: the class patterns / textures
        must be the world the CL system is later scored on (the sampler
        only randomizes the timestamps)."""
        segs = list(segments) if segments is not None else self.segments
        xs, ys = [], []
        stream = DriftStream(segs, fps=self.fps, seed=self.seed,
                             img=self.img, n_classes=self.n_classes)
        times = rng.uniform(0, stream.duration, size=n)
        for t in times:
            x, y = stream._frame(float(t))
            xs.append(x)
            ys.append(y)
        return np.stack(xs), np.asarray(ys, np.int32)


class PrefetchingWindowIterator:
    """Frame windows generated ahead of consumption on a background thread.

    Host-side frame synthesis is a serial numpy loop; when the consumer
    dispatches async device work per window (core/dispatch.py), generating
    the *next* window on a worker thread overlaps CPU frame slicing with
    device execution instead of serializing the dispatch stream. Windows are
    yielded strictly in span order as ``(t_start, t_end, x, y)`` — the
    deterministic per-frame RNG makes the output identical to calling
    ``stream.frames`` per span inline.

    ``depth`` bounds how many undelivered windows may be in flight, so a
    slow consumer never accumulates unbounded frames in memory.
    """

    def __init__(self, stream: DriftStream,
                 spans: Sequence[Tuple[float, float]],
                 max_frames: int = 0, depth: int = 2):
        self.spans = list(spans)
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._error_box: list = []  # producer appends; consumer re-raises
        self._stop = threading.Event()
        self._closed = False

        # The producer closes over locals only — never ``self`` — so an
        # abandoned iterator can be garbage-collected, whose __del__ then
        # stops the thread via the shared event.
        spans_, q, stop, error_box = self.spans, self._queue, self._stop, \
            self._error_box

        def _put(item) -> bool:
            """Bounded put that gives up when the consumer went away."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def _producer():
            try:
                for t0, t1 in spans_:
                    if stop.is_set():
                        return
                    x, y = stream.frames(t0, t1, max_frames=max_frames)
                    if not _put((t0, t1, x, y)):
                        return
            except BaseException as exc:  # surfaced on the consumer side
                error_box.append(exc)
            finally:
                _put(None)  # sentinel: exhausted (or failed)

        self._thread = threading.Thread(target=_producer, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator[Tuple[float, float, np.ndarray,
                                         np.ndarray]]:
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        item = self._queue.get()
        if item is None:
            self._closed = True
            self._thread.join()
            if self._error_box:
                raise self._error_box[0]
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the producer early; subsequent ``next()`` raises
        StopIteration (the sentinel may be drained here, so ``__next__``
        must never block on the queue again)."""
        self._closed = True
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._queue.get(timeout=0.05)  # unblock a full-queue put
            except queue.Empty:
                pass
        self._thread.join()

    def __del__(self):
        # Safety net for abandoned iterators: the producer's timeout-put
        # notices _stop and exits, so no thread or frame window leaks.
        self._stop.set()
