"""The ported drive example (``examples/continuous_learning_drive_torch.py``)
on the CPU at a tiny size: DC-ST against Ekya under concurrent dispatch on
a forced 2-row mesh, ``--trace`` to a file; the file loads as the recorded
trace and every phase end replays from it bit for bit. ``main`` parses the
reference example's flags and nothing else."""
import sys
from pathlib import Path

import pytest

from _torch_sessions import one_torch_thread  # noqa: F401
from repro_torch.core.replay import TraceReplayer
from repro_torch.core.trace import SessionTrace

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
import continuous_learning_drive_torch as example  # noqa: E402


def test_drive_example_traces_and_replays(tmp_path, capsys):
    path = tmp_path / "drive.json"
    results, recorded = example.drive(
        "ES1", n_seg=2, duration=20.0, n_t=32, n_l=16, c_b=64,
        steps=(3, 2), batch=16, dispatch="concurrent", trace=str(path),
        device="cpu")
    out = capsys.readouterr().out
    assert set(results) == {"dacapo-spatiotemporal", "ekya"}
    assert "top-5 programs by host wall time:" in out
    assert "top-5 programs by virtual cost:" in out
    assert "spec-hit-rate=" in out
    loaded = SessionTrace.load(str(path))
    assert loaded.as_dict() == recorded.as_dict()
    assert len(loaded) >= len(results["dacapo-spatiotemporal"].records) > 0
    rep = TraceReplayer(loaded)
    for i, ph in enumerate(loaded.phases):
        assert ph.mode == "concurrent"
        assert rep.phase_time(i) == ph.end
    programs = [e for e in loaded.events() if e.kind == "program"]
    assert programs and all(e.path == "" for e in programs)  # fp32 ResNets


@pytest.mark.parametrize("argv, want", [
    ([], dict(n_seg=5, duration=240.0, n_t=96, n_l=48, steps=(100, 40),
              dispatch="sequential", online=False, trace=None)),
    (["--fast", "--scenario", "S1", "--dispatch", "concurrent", "--online",
      "--trace", "t.json"],
     dict(n_seg=3, duration=90.0, n_t=64, n_l=32, steps=(30, 20),
          dispatch="concurrent", online=True, trace="t.json")),
])
def test_drive_example_flags(monkeypatch, argv, want):
    seen = {}
    monkeypatch.setattr(example, "drive",
                        lambda name, **kw: seen.update(name=name, **kw))
    monkeypatch.setattr(sys, "argv", ["drive"] + argv)
    example.main()
    assert seen.pop("name") == ("S1" if argv else "ES1")
    assert seen == want
    monkeypatch.setattr(sys, "argv", ["drive", "--device", "cpu"])
    with pytest.raises(SystemExit):
        example.main()
