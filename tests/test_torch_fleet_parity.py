"""Parity of the port's 3-stream fleet (plain PyTorch, CPU) with the JAX
package's, run live on this host: the reference fleet tests' heterogeneous
streams (S1 / S3 / ES1, seeds 5 / 6 / 7, 24 px, 40 s), drift-weighted
DC-ST lanes under the ``resolve-max`` row policy, in both dispatch modes,
with fp32 serving (the reference tests' setting) and with MX6 serving
(the setting ``chip_smoke.py`` runs on the card). The other row policies
are in tests/test_torch_fleet_policies.py.

Weights: ``small_setup`` (``scenario("S1", 2)``, seed 5, JAX pretraining
10 / 8 steps), carried across with ``params_from_numpy``; hyper-parameters
``CLHyperParams(n_t=32, n_l=16, c_b=128, epochs=1)``.

Tolerances (``_torch_sessions.assert_fleet_parity``): the same phase
count, drift events and row decisions in every phase; the fleet phase log
and every lane's ledgers within 1e-6; each lane's drift verdicts while
both packages observe the same accuracies; each lane's and the fleet's
average accuracy within 0.02 — about one scored frame of one lane's
timeline. On this host the accuracies agree exactly: both packages
retrain each lane's student through the same few SGD steps, fewer than the
~10 after which single-stream sessions part (ROADMAP Queue 3, item 2).
"""
import pytest

from _torch_sessions import (assert_fleet_parity, fleet_pair,  # noqa: F401
                             golden_streams, jax_pretrained,
                             one_torch_thread)

HP = dict(n_t=32, n_l=16, c_b=128, epochs=1)
ACC_TOL = 0.02


@pytest.fixture(scope="module")
def golden():
    return jax_pretrained(2, 10, 8)


@pytest.mark.parametrize("apply_mx", [False, True], ids=["fp32", "mx6"])
@pytest.mark.parametrize("dispatch", ["sequential", "concurrent"])
def test_three_stream_fleet_matches_reference(golden, dispatch, apply_mx):
    ref, port = fleet_pair(golden, HP, fleet_mode="drift-weighted",
                           row_policy="resolve-max", dispatch=dispatch,
                           apply_mx=apply_mx)
    want = ref.run(golden_streams(port=False), duration=40.0)
    got = port.run(golden_streams(port=True), duration=40.0)
    assert got.name == want.name
    assert_fleet_parity(got, want, ACC_TOL)
    # resolve-max keeps the offline split in every phase.
    for entry in got.fleet_phase_log:
        assert (entry["rows_tsa"], entry["rows_bsa"]) == (port.r_tsa,
                                                          port.r_bsa)
    if apply_mx:  # every lane's MX6 serving copy was filled
        assert port.inference.serving_cache.fills >= got.n_streams
