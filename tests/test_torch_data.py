"""The port's copies of the numpy-only data plane and sample buffer behave
exactly as the JAX package's: identical frames, labels, speculation
counters and buffer state (tolerance: none, it is the same numpy code)."""
import dataclasses

import numpy as np
import pytest

from repro.core.drift import DriftDetector as JDriftDetector
from repro.core.sample_buffer import SampleBuffer as JSampleBuffer
from repro.data.pipeline import FramePipeline as JFramePipeline
from repro.data.stream import DriftStream as JDriftStream
from repro.data.stream import scenario as j_scenario
from repro_torch.core.drift import DriftDetector
from repro_torch.core.sample_buffer import SampleBuffer
from repro_torch.data.pipeline import FramePipeline
from repro_torch.data.stream import DriftStream, scenario


@pytest.mark.parametrize("name", ["S1", "S4", "ES1"])
def test_stream_frames_match(name):
    kw = dict(seed=5, img=24)
    j, t = JDriftStream(j_scenario(name, 3), **kw), DriftStream(
        scenario(name, 3), **kw)
    for t0, t1, mf in ((0.0, 1.0, 0), (59.5, 61.0, 8), (120.0, 123.0, 5)):
        jx, jy = j.frames(t0, t1, max_frames=mf)
        tx, ty = t.frames(t0, t1, max_frames=mf)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    jx, jy = j.sample_dataset(16, np.random.default_rng(1))
    tx, ty = t.sample_dataset(16, np.random.default_rng(1))
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)


def test_speculative_pipeline_matches():
    """Two phases of the same request layout: the second is served from
    the speculation in both packages, with equal frames and counters."""
    kw = dict(seed=5, img=24)
    pipes = (JFramePipeline(JDriftStream(j_scenario("S1", 3), **kw)),
             FramePipeline(DriftStream(scenario("S1", 3), **kw)))
    try:
        outs = []
        for pipe in pipes:
            frames = []
            for start in (0.0, 7.5, 15.0):
                pipe.begin_phase(start, label_hint=(24, 30.0))
                frames.append(pipe.frames(start, start + 2.0, max_frames=4))
                frames.append(pipe.frames(start + 2.0, start + 2.8,
                                          max_frames=24, tag="label"))
            outs.append((frames, pipe.stats))
        (jf, js), (tf, ts) = outs
        for (jx, jy), (tx, ty) in zip(jf, tf):
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)
        assert dataclasses.asdict(ts) == dataclasses.asdict(js)
        assert ts.hits > 0
    finally:
        for pipe in pipes:
            pipe.close()


def test_sample_buffer_and_detector_match():
    rng = np.random.default_rng(0)
    j, t = JSampleBuffer(40, seed=3), SampleBuffer(40, seed=3)
    for _ in range(4):
        x = rng.normal(size=(15, 2)).astype(np.float32)
        y = rng.integers(0, 8, size=15).astype(np.int32)
        j.update(x, y)
        t.update(x, y)
    for a, b in zip(t.get_data(24, 6), j.get_data(24, 6)):
        np.testing.assert_array_equal(a, b)
    js, ts = j.state_dict(), t.state_dict()
    np.testing.assert_array_equal(ts["x"], js["x"])
    assert ts["rng_state"] == js["rng_state"]
    jd, td = JDriftDetector(v_thr=-0.1), DriftDetector(v_thr=-0.1)
    for acc_l, acc_v in ((0.9, 0.9), (0.5, 0.8), (0.7, 0.75)):
        assert td.check(acc_l, acc_v, 0.0) == jd.check(acc_l, acc_v, 0.0)
    assert td.history == jd.history
