"""The ported fleet driver (``examples/fleet_drive_torch.py``) on the CPU at
a small size: 3 cameras under a 2-shard manager with shard 1 killed at
phase 2 — a ``recover`` event from a checkpoint, every camera finishing,
the manager's ledger conserved (gap at most 1e-9) and its total the T-SA
ledger plus the recovery and migration charges (relative 1e-12); and the
single-fleet path. ``main`` parses every flag of the reference example,
plus ``--device``."""
import sys
from pathlib import Path

import pytest

from _torch_sessions import one_torch_thread  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
import fleet_drive_torch as example  # noqa: E402

SMALL = dict(seg_s=10.0, n_seg=3, duration=30.0, n_t=32, n_l=16, c_b=64,
             steps=(4, 3), batch=16, device="cpu")


def test_fleet_drive_manager_recovers(capsys):
    res = example.drive(streams=3, shards=2, fail_at=2, **SMALL)
    out = capsys.readouterr().out
    assert "shard 1 killed at phase 2" in out
    assert "restored from checkpoint" in out
    recovers = [e for e in res.events if e.kind == "recover"]
    assert recovers and all(e.shard == 1 and e.to_shard == 0
                            and e.detail == "restored from checkpoint"
                            for e in recovers)
    assert res.shard_results[1] is None
    assert set(res.lane_results) == {"cam0", "cam1", "cam2"}
    assert all(lane.records for lane in res.lane_results.values())
    assert res.conservation_gap() <= 1e-9
    assert res.ledger["recovery_cost"] == 2.0 * len(recovers)
    assert res.ledger["total"] == pytest.approx(
        res.ledger["t_tsa"] + res.ledger["recovery_cost"]
        + res.ledger["migration_cost"], rel=1e-12)


def test_fleet_drive_single_fleet(capsys):
    res = example.drive(streams=2, **{**SMALL, "duration": 12.0})
    out = capsys.readouterr().out
    assert res.n_streams == 2 and "fleet rows over time" in out
    assert "[s1] phase" in out


@pytest.mark.parametrize("argv, want", [
    ([], dict(streams=3, scenario_name="S3", mode="drift-weighted",
              row_policy="resolve-max", dispatch="sequential", shards=1,
              fail_at=None, parallel=0, seg_s=45.0, n_seg=5,
              duration=180.0, n_t=64, n_l=32, steps=(60, 30), device=None)),
    (["--fast", "--streams", "2", "--scenario", "ES1", "--mode", "uniform",
      "--row-policy", "drift-surge", "--dispatch", "concurrent",
      "--shards", "3", "--fail-at", "4", "--parallel", "2", "--device",
      "cpu"],
     dict(streams=2, scenario_name="ES1", mode="uniform",
          row_policy="drift-surge", dispatch="concurrent", shards=3,
          fail_at=4, parallel=2, seg_s=20.0, n_seg=4, duration=60.0,
          n_t=48, n_l=24, steps=(20, 12), device="cpu")),
])
def test_fleet_drive_flags(monkeypatch, argv, want):
    seen = {}
    monkeypatch.setattr(example, "drive", lambda **kw: seen.update(kw))
    monkeypatch.setattr(sys, "argv", ["fleet_drive"] + argv)
    example.main()
    assert seen == want
    monkeypatch.setattr(sys, "argv", ["fleet_drive", "--mode", "nope"])
    with pytest.raises(SystemExit):
        example.main()
