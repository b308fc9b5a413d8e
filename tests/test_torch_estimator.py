"""Parity of the port's ``TPUEstimator`` with the JAX package's: the
reference's roofline cost model, whose seconds price the virtual clock of
sessions built on it and of the paper's Jetson Orin baselines (which
subclass it with their own constants). Tolerance: none — every
``forward_time``, ``train_step_time`` and ``inference_fps`` equals the
reference float for float, in both ``fractional_rows`` modes, on every
Table III model at full width and as its reduced twin, and so does the
offline spatial allocation Algorithm 1 derives from it.
"""
import dataclasses

import pytest

from repro.configs.dacapo_pairs import VISION_MODELS as J_MODELS
from repro.core import estimator as jest
from repro_torch.configs import dacapo_pairs as tcfg
from repro_torch.core import TPUEstimator
from repro_torch.core import estimator as test_

PRECISIONS = ("mx4", "mx6", "mx9")


def _pairs(name):
    return ((J_MODELS[name], tcfg.VISION_MODELS[name]),
            (J_MODELS[name].reduced(), tcfg.VISION_MODELS[name].reduced()))


def _assert_same(je, te, name):
    for j, t in _pairs(name):
        for rows in range(1, 17):
            for prec in PRECISIONS:
                for batch in (1, 16):
                    assert te.forward_time(t, rows, prec, batch) == \
                        je.forward_time(j, rows, prec, batch)
                assert te.train_step_time(t, rows, prec, 16) == \
                    je.train_step_time(j, rows, prec, 16)
                assert te.inference_fps(t, rows, prec) == \
                    je.inference_fps(j, rows, prec)
        for fps in (1.0, 30.0, 1e4, 1e7):
            for prec in PRECISIONS:
                assert test_.spatial_allocation(te, t, fps, prec) == \
                    jest.spatial_allocation(je, j, fps, prec)


def test_constants_are_the_reference_inputs():
    assert (test_.TPU_PEAK_FLOPS, test_.TPU_HBM_BW, test_.TPU_ICI_BW) == (
        jest.TPU_PEAK_FLOPS, jest.TPU_HBM_BW, jest.TPU_ICI_BW)
    assert TPUEstimator is test_.TPUEstimator
    fields = lambda cls: [  # noqa: E731
        (f.name, f.default) for f in dataclasses.fields(cls)]
    assert fields(test_.TPUEstimator) == fields(jest.TPUEstimator)
    assert test_.TPUEstimator.mx_speedup == jest.TPUEstimator.mx_speedup


@pytest.mark.parametrize("fractional", [False, True])
@pytest.mark.parametrize("name", sorted(tcfg.VISION_MODELS))
def test_tpu_estimator_matches_jax(name, fractional):
    total = 16 if fractional else 1
    je = jest.TPUEstimator(total_rows=total, fractional_rows=fractional)
    te = test_.TPUEstimator(total_rows=total, fractional_rows=fractional)
    assert te._units(3) == je._units(3)
    _assert_same(je, te, name)


def _orin_like(base):
    """The ``benchmarks/common.py::OrinEstimator`` pattern: a subclass with
    its own constants, in fractional-rows mode, no MX gain."""

    @dataclasses.dataclass(frozen=True)
    class OrinLike(base):
        total_rows: int = 16
        peak_flops: float = 5.3e12 * 0.45
        hbm_bw: float = 204.8e9
        fractional_rows: bool = True
        mx_speedup = {"mx4": 1.0, "mx6": 1.0, "mx9": 1.0}

    return OrinLike


@pytest.mark.parametrize("power", ["high", "low"])
@pytest.mark.parametrize("name", ["resnet18", "vit-b32"])
def test_subclass_with_other_constants_matches_jax(name, power):
    scale = 1.0 if power == "high" else 0.45
    kw = dict(peak_flops=5.3e12 * 0.45 * scale,
              hbm_bw=204.8e9 * (1.0 if power == "high" else 0.7))
    je = _orin_like(jest.TPUEstimator)(**kw)
    te = _orin_like(test_.TPUEstimator)(**kw)
    assert te.total_rows == je.total_rows == 16
    _assert_same(je, te, name)
