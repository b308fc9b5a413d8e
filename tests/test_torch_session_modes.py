"""Parity of the port's session modes with the JAX package, run live: the
concurrent dispatch (speculative frame pipeline, fused scoring,
microbatched labeling), the DC-S, DC-ST-Online and Ekya policies, a
session on a 2-row mesh (``forced_row_mesh``) and one priced by
``TPUEstimator``.

The fixture is the golden fixture of ``tests/test_torch_session.py``:
``scenario("S1", 3)``, seed 5, 24 px, ``CLHyperParams(n_t=48, n_l=24,
c_b=192, epochs=1)``, teacher and student pretrained by the JAX package
and carried across. Tolerances are that file's: phase count, drift events
and the retraining and labeling ledgers agree within 1e-6, and so does
every phase's virtual clock, drift verdict and speculation count for as
long as both packages observe the same accuracies; ``avg_accuracy``
within 0.1; the first phase exactly (``_torch_sessions.assert_parity``).
Runs stay at or under 30 s of virtual time (Ekya's 120 s windows
excepted): past ~10 phases the reference's jitted SGD step parts the
accuracies (ROADMAP Queue 3, item 2).
"""
import pytest
import torch

from _torch_sessions import (assert_parity, jax_pretrained,  # noqa: F401
                             mesh_shapes, one_torch_thread, port_stream,
                             run_pair, session_pair)
from repro.core import estimator as jest
from repro.core.partition import forced_row_mesh as j_forced_row_mesh
from repro_torch.core import estimator as test_
from repro_torch.core.partition import forced_row_mesh

GOLDEN_HP = dict(n_t=48, n_l=24, c_b=192, epochs=1)


@pytest.fixture(scope="module")
def golden_setup():
    return jax_pretrained(3, 25, 15)


# name: (spec keywords, virtual seconds)
RUNS = {
    "concurrent-fp32": (dict(allocator="dacapo-spatiotemporal",
                             apply_mx=False, dispatch="concurrent"), 30.0),
    "concurrent-mx6": (dict(allocator="dacapo-spatiotemporal",
                            apply_mx=True, dispatch="concurrent"), 30.0),
    "dacapo-spatial": (dict(allocator="dacapo-spatial", apply_mx=False),
                       30.0),
    "dacapo-spatiotemporal-online": (
        dict(allocator="dacapo-spatiotemporal-online", apply_mx=False),
        30.0),
    "ekya": (dict(allocator="ekya", apply_mx=False), 250.0),
}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_session_mode_parity(golden_setup, run):
    kw, duration = RUNS[run]
    ref, port, want, got = run_pair(golden_setup, duration, GOLDEN_HP, **kw)
    assert port.dispatcher.concurrent == ref.dispatcher.concurrent
    assert port.speculative_frames == ref.speculative_frames
    assert port._label_microbatch == ref._label_microbatch
    assert (port.r_tsa, port.r_bsa) == (ref.r_tsa, ref.r_bsa)
    assert_parity(got, want)
    if run == "dacapo-spatiotemporal-online":  # the drift boost moved rows
        assert got.drift_events > 0
        assert len({r.decision.rows_bsa for r in got.records}) > 1
    if port.dispatcher.concurrent:
        assert sum(r.spec_hits for r in got.records) > 0
        for rec in got.records:
            assert rec.t - rec.phase_start == pytest.approx(
                max(rec.t_tsa, rec.t_bsa), rel=1e-12)


def test_two_row_mesh_session_parity(golden_setup):
    """The chip's mesh session at a CPU size: DC-ST-Online, concurrent,
    MX6, on a 2-row mesh. The inference kernel binds to B-SA, labeling and
    retraining to T-SA, as in the reference; the ledgers agree."""
    ref, port = session_pair(golden_setup, GOLDEN_HP,
                             jkw=dict(mesh=j_forced_row_mesh(2)),
                             tkw=dict(mesh=forced_row_mesh(2, "cpu")),
                             allocator="dacapo-spatiotemporal-online",
                             apply_mx=True, dispatch="concurrent")
    for s in (ref, port):
        assert not s.partition.time_shared
        assert s.inference.submesh is s.partition.b_sa
        assert s.labeling.submesh is s.partition.t_sa
        assert s.retrain.submesh is s.partition.t_sa
    assert port._mesh_rows_bsa == ref._mesh_rows_bsa == 1
    assert mesh_shapes(port) == mesh_shapes(ref) == [(1, 1)] * 3
    assert port.inference._device == torch.device("cpu")
    want = ref.run(golden_setup[0], duration=20.0)
    got = port.run(port_stream(golden_setup), duration=20.0)
    assert_parity(got, want)
    assert mesh_shapes(port) == mesh_shapes(ref)


def test_tpu_estimator_session_parity(golden_setup):
    """A session priced by TPUEstimator on a 2-row mesh, under EOMU's 10 s
    windows: mesh split, bindings and ledgers as in the reference. One
    chip: the offline split gives the T-SA no rows, so on the virtual clock
    it time-shares the whole chip; the mesh, though, splits one row to
    each side, since ``_mesh_split`` reads the B-SA's share of
    ``total_rows`` = 1 as all of it and keeps one row for the T-SA."""
    ref, port = session_pair(golden_setup, GOLDEN_HP,
                             jkw=dict(mesh=j_forced_row_mesh(2),
                                      estimator=jest.TPUEstimator()),
                             tkw=dict(mesh=forced_row_mesh(2, "cpu"),
                                      estimator=test_.TPUEstimator()),
                             allocator="eomu", apply_mx=False)
    assert (port.r_tsa, port.r_bsa) == (ref.r_tsa, ref.r_bsa) == (0, 1)
    assert port._mesh_split(port.r_bsa) == ref._mesh_split(ref.r_bsa)
    assert port.partition.time_shared is ref.partition.time_shared is False
    assert mesh_shapes(port) == mesh_shapes(ref) == [(1, 1)] * 3
    spatial = port._resolve_spatial(port.allocator.initial_decision())
    assert (spatial.rows_tsa, spatial.rows_bsa) == (1, 1)
    want = ref.run(golden_setup[0], duration=30.0)
    got = port.run(port_stream(golden_setup), duration=30.0)
    assert_parity(got, want)
