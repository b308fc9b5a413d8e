"""Shared by the port's session parity tests: JAX-pretrained weights
carried across, one session of each package built from one description,
and the parity assertions (tolerances in ``tests/test_torch_session.py``).
"""
import jax
import numpy as np
import pytest

from repro.configs.dacapo_pairs import RESNET18 as J_RESNET18
from repro.configs.dacapo_pairs import WIDERESNET50 as J_WIDERESNET50
from repro.core import allocation as jalloc
from repro.core import session as jsession
from repro.data.stream import DriftStream as JDriftStream
from repro.data.stream import scenario as j_scenario
from repro.models.registry import make_vision_model as j_make_vision_model
from repro_torch.configs import dacapo_pairs as tcfg
from repro_torch.convert import params_from_numpy
from repro_torch.core import allocation as talloc
from repro_torch.core import session as tsession
from repro_torch.data.stream import DriftStream, scenario


def jax_pretrained(segments: int, teacher_steps: int, student_steps: int):
    """The golden recipe on ``scenario("S1", segments)``, seed 5, 24 px:
    teacher and student pretrained by the JAX package. Returns the JAX
    stream, both JAX trees and both as numpy."""
    stream = JDriftStream(j_scenario("S1", segments), seed=5, img=24)
    rng = np.random.default_rng(0)
    tp = jsession.pretrain_model(
        j_make_vision_model(J_WIDERESNET50.reduced()), stream,
        teacher_steps, 32, rng)
    sp = jsession.pretrain_model(
        j_make_vision_model(J_RESNET18.reduced()), stream, student_steps, 32,
        rng, segments=stream.segments[:1], seed=8)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return stream, tp, sp, as_np(tp), as_np(sp)


def port_stream(golden):
    """The port's twin of the fixture's JAX stream."""
    jstream = golden[0]
    return DriftStream(scenario("S1", len(jstream.segments)), seed=5, img=24)


def port_session(golden, hp: dict, **kw):
    """The port's session on the CPU (seed 0, ``eval_fps=0.5`` unless
    ``kw`` says otherwise), with the fixture's weights carried across."""
    _, _, _, tp_np, sp_np = golden
    kw = {"seed": 0, "eval_fps": 0.5, **kw}
    port = tsession.CLSystemSpec(
        student=tcfg.RESNET18, teacher=tcfg.WIDERESNET50,
        hp=talloc.CLHyperParams(**hp), device="cpu", **kw).build()
    port.set_pretrained(params_from_numpy(tp_np, "cpu"),
                        params_from_numpy(sp_np, "cpu"))
    return port


def session_pair(golden, hp: dict, jkw=None, tkw=None, **kw):
    """The reference's and the port's session from one description:
    ``kw`` goes to both specs, ``jkw`` / ``tkw`` to one each."""
    _, tp, sp, _, _ = golden
    ref = jsession.CLSystemSpec(
        student=J_RESNET18, teacher=J_WIDERESNET50,
        hp=jalloc.CLHyperParams(**hp), seed=0, eval_fps=0.5,
        **kw, **(jkw or {})).build()
    ref.set_pretrained(tp, sp)
    return ref, port_session(golden, hp, **kw, **(tkw or {}))


def run_pair(golden, duration: float, hp: dict, **kw):
    ref, port = session_pair(golden, hp, **kw)
    want = ref.run(golden[0], duration=duration)
    got = port.run(port_stream(golden), duration=duration)
    return ref, port, want, got


def assert_parity(got, want):
    """Phase count, drift events and ledgers within 1e-6; per phase the
    virtual clock, speculation counts and drift verdict while both observe
    the same accuracies; the first phase exactly; avg_accuracy within 0.1.
    """
    assert len(got.phase_log) == len(want.phase_log) > 0
    assert got.drift_events == want.drift_events
    assert abs(got.retrain_time - want.retrain_time) < 1e-6
    assert abs(got.label_time - want.label_time) < 1e-6
    for g, w in zip(got.phase_log, want.phase_log):
        for key in ("t", "phase_start", "t_tsa", "t_bsa", "retrain_time",
                    "label_time"):
            assert abs(g[key] - w[key]) < 1e-6, (key, g, w)
        assert (g["spec_hits"], g["spec_misses"]) == (
            w["spec_hits"], w["spec_misses"]), (g, w)
        if (g["acc_valid"], g["acc_label"]) != (w["acc_valid"],
                                                w["acc_label"]):
            break
        assert g["drift"] == w["drift"], (g, w)
    first_g, first_w = got.phase_log[0], want.phase_log[0]
    assert (first_g["acc_valid"], first_g["acc_label"]) == (
        first_w["acc_valid"], first_w["acc_label"])
    assert abs(got.avg_accuracy - want.avg_accuracy) < 0.1


def mesh_shapes(session):
    """Each kernel's sub-mesh shape (None: time-shared)."""
    return [None if k.submesh is None else k.submesh.devices.shape
            for k in session.kernels]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs test files in parallel worker processes; one torch
    intra-op thread per worker keeps them from oversubscribing the cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
