"""Parity of the port's 3-stream fleet with the JAX package's under the
fleet row policies that move rows: ``drift-surge`` (the fleet T-SA grows
when a quorum of lanes drifts, under a hysteresis window; the reference
test's ``DriftSurgeRowPolicy(surge_rows=1, quorum=0.3,
hysteresis_phases=1)`` and the defaults) and ``weighted-vote`` (rows
follow the drift-weighted shares), in both dispatch modes, fp32 serving.
Fixture, streams and tolerances as in tests/test_torch_fleet_parity.py.
"""
import pytest

from _torch_sessions import (assert_fleet_parity, fleet_pair,  # noqa: F401
                             golden_streams, jax_pretrained,
                             one_torch_thread)
from repro.core import decision as jdec
from repro_torch.core import decision as tdec

HP = dict(n_t=32, n_l=16, c_b=128, epochs=1)
ACC_TOL = 0.02
POLICIES = {
    "drift-surge-tight": dict(surge_rows=1, quorum=0.3, hysteresis_phases=1),
    "weighted-vote": {},
}


@pytest.fixture(scope="module")
def golden():
    return jax_pretrained(2, 10, 8)


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("dispatch", ["sequential", "concurrent"])
def test_row_policy_fleet_matches_reference(golden, dispatch, policy):
    name = policy.replace("-tight", "")
    kwargs = POLICIES[policy]
    ref, port = fleet_pair(golden, HP, fleet_mode="drift-weighted",
                           dispatch=dispatch, row_policy=name)
    # Each package's fleet gets its own policy instance, made alike.
    ref.fleet_allocator.row_policy = jdec.FleetRowPolicy(name, **kwargs)
    port.fleet_allocator.row_policy = tdec.FleetRowPolicy(name, **kwargs)
    want = ref.run(golden_streams(port=False), duration=40.0)
    got = port.run(golden_streams(port=True), duration=40.0)
    assert got.name == want.name and name in got.name
    assert_fleet_parity(got, want, ACC_TOL)
    total = port.estimator.total_rows
    rows = [e["rows_tsa"] for e in got.fleet_phase_log]
    for e in got.fleet_phase_log:  # the array stays whole
        assert e["rows_tsa"] + e["rows_bsa"] == total
        assert e["rows_tsa"] >= 1 and e["rows_bsa"] >= 1
    if name == "drift-surge":
        assert rows[0] == port.r_tsa and port.r_tsa + 1 in rows
    else:
        assert len(set(rows)) > 1  # the votes moved the split
