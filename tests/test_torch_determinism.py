"""``chip_smoke.run_differences``, the check that phases 4 and 8 of
``chip_smoke.py`` hold two runs of the session to on the card, on the CPU:
it passes two equal runs and names each kind of difference — phase count,
drift events, a phase's log, average accuracy, one bit of one student
parameter, launch counts."""
import copy
import types

import pytest
import torch

import chip_smoke


def _run(acc=0.5, phases=3, drift=1, launches=5):
    log = [{"t": 15.0 * (i + 1), "acc_valid": acc, "acc_label": acc,
            "drift": i == 1} for i in range(phases)]
    res = types.SimpleNamespace(phase_log=log, drift_events=drift,
                                avg_accuracy=acc)
    gen = torch.Generator().manual_seed(0)
    session = types.SimpleNamespace(student_params={
        "w": torch.randn(4, 3, generator=gen), "b": torch.zeros(3)})
    counts = {"mx_quantize": launches, "mx_dequantize": launches}
    return (session, None, res, 1.0, 1.0, launches, counts, {})


def _flip_one_bit(run):
    w = run[0].student_params["w"]
    w.view(torch.int32)[0, 0] ^= 1
    return run


@pytest.mark.parametrize("change, what", [
    (lambda r: r, None),
    (lambda r: _run(phases=4), "phases"),
    (lambda r: _run(drift=2), "drift events"),
    (lambda r: _run(acc=0.25), "phase 0"),
    (lambda r: _flip_one_bit(r), "student parameters"),
    (lambda r: _run(launches=4), "launches"),
])
def test_run_differences_names_each_difference(change, what):
    first = _run()
    second = change(copy.deepcopy(first))
    diffs = chip_smoke.run_differences(first, second)
    if what is None:
        assert diffs == []
    else:
        assert any(d.startswith(what) for d in diffs), diffs
