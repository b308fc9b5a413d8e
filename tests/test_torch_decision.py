"""The port's two-plane decision API held to the JAX package's, run live:
the tests of tests/test_decision.py that no other port test holds — the
``AllocationDecision`` <-> ``Decision`` round trip (``from_decision``),
``as_decision``, spatial-plane resolution (``rows_for``), the kernels'
rows and precision read from the spatial plane, the label hints of
``KernelDispatcher.begin_phase`` (derived, explicit, and by position) and
the engine-set drift flag. The same arguments go to both packages; the
reference's assertions hold for the port and its results equal the
reference's: decisions field for field, kernel times and keep fractions
to 1e-12, hints tuple for tuple. The row-policy and fleet-allocator tests
are in tests/test_torch_fleet_decisions.py."""
import dataclasses

import pytest

from _hypothesis_compat import given, settings, st
from repro.configs import dacapo_pairs as jcfg
from repro.core import allocation as jalloc
from repro.core import decision as jdec
from repro.core import dispatch as jdisp
from repro.core import estimator as jest
from repro.core import kernel as jkern
from repro.core import mx as jmx
from repro.models import registry as jreg
from repro_torch.configs import dacapo_pairs as tcfg
from repro_torch.core import allocation as talloc
from repro_torch.core import decision as tdec
from repro_torch.core import dispatch as tdisp
from repro_torch.core import estimator as test_
from repro_torch.core import kernel as tkern
from repro_torch.core import mx as tmx
from repro_torch.models import registry as treg

PKGS = ((jalloc, jdec, jmx), (talloc, tdec, tmx))
TOL = 1e-12


def _flat(d):
    """A legacy or two-plane decision as plain data."""
    if isinstance(d, (jdec.Decision, tdec.Decision)):
        return (_flat(d.spatial), _flat(d.temporal))
    out = dataclasses.asdict(d)
    if "precisions" in out:
        out["precisions"] = dataclasses.astuple(d.precisions)
    return out


# ------------------------------------------------------- facade round trip --
@settings(max_examples=60, deadline=None)
@given(
    retrain=st.integers(0, 512),
    valid=st.integers(0, 128),
    label=st.integers(1, 512),
    reset=st.sampled_from([False, True]),
    extra=st.integers(0, 384),
    rows=st.sampled_from([(None, None), (0, 16), (8, 8), (12, 4), (16, 0)]),
    pace=st.sampled_from([None, 10.0, 120.0]),
    epochs=st.sampled_from([None, 1, 3]),
    profile=st.floats(0.0, 9.0))
def test_legacy_split_roundtrip_is_identity(retrain, valid, label, reset,
                                            extra, rows, pace, epochs,
                                            profile):
    """legacy -> .split() -> to_legacy / from_decision is the identity in
    the port, and every step equals the reference's."""
    flats = []
    for alloc, dec_mod, mx in PKGS:
        legacy = alloc.AllocationDecision(
            retrain_samples=retrain, valid_samples=valid,
            label_samples=label, reset_buffer=reset,
            extra_label_samples=extra, rows_tsa=rows[0], rows_bsa=rows[1],
            precisions=mx.PrecisionPolicy(inference="mx9"),
            pace_window_s=pace, retrain_epochs=epochs,
            profile_cost_s=profile)
        dec = legacy.split()
        assert isinstance(dec, dec_mod.Decision)
        assert dec == dec_mod.Decision.from_legacy(legacy)
        back = dec.to_legacy()
        assert back == legacy
        assert alloc.AllocationDecision.from_decision(dec) == legacy
        assert dec.spatial.rows_tsa == rows[0]
        assert dec.spatial.rows_bsa == rows[1]
        assert dec.temporal.total_label_samples == \
            legacy.total_label_samples
        assert back.split() == dec
        flats.append((_flat(legacy), _flat(dec), _flat(back)))
    assert flats[1] == flats[0]


def test_as_decision_normalizes_both_surfaces():
    flats = []
    for alloc, dec_mod, _ in PKGS:
        legacy = alloc.AllocationDecision(10, 4, 8)
        dec = legacy.split()
        assert dec_mod.as_decision(dec) is dec
        assert dec_mod.as_decision(legacy) == dec
        flats.append(_flat(dec_mod.as_decision(legacy)))
    assert flats[1] == flats[0]


def test_spatial_plan_resolution_semantics():
    """None rows -> offline defaults; 0 rows -> whole-array time-share;
    ``rows_for`` reads the rows by role."""
    got = []
    for _, dec_mod, _ in PKGS:
        plan = dec_mod.SpatialPlan(rows_tsa=None, rows_bsa=None)
        a = plan.resolve(6, 10, 16)
        assert a == dataclasses.replace(plan, rows_tsa=6, rows_bsa=10)
        b = dec_mod.SpatialPlan(rows_tsa=0, rows_bsa=16).resolve(None, None,
                                                                16)
        assert (b.rows_tsa, b.rows_bsa) == (16, 16)
        c = dec_mod.SpatialPlan(rows_tsa=12, rows_bsa=4).resolve(8, 8, 16)
        assert c.rows_for("t_sa") == 12 and c.rows_for("b_sa") == 4
        assert c.rows_for(dec_mod.ROLE_TSA) == 12
        assert c.rows_for(dec_mod.ROLE_BSA) == 4
        assert c.refission
        got.append(([_flat(p) for p in (a, b, c)],
                     [c.rows_for(r) for r in ("t_sa", "b_sa", "other")],
                     (dec_mod.ROLE_TSA, dec_mod.ROLE_BSA)))
    assert got[1] == got[0]


# ------------------------------------------------------ kernel plane view --
def _kernel_views(cfg_mod, est_mod, kern_mod, mx, alloc, dec_mod, model):
    est, hp = est_mod.DaCapoEstimator(), alloc.CLHyperParams()
    prec = mx.PrecisionPolicy(inference="mx4", labeling="mx6",
                              retraining="mx9")
    spatial = dec_mod.SpatialPlan(rows_tsa=12, rows_bsa=4, precisions=prec)
    full = cfg_mod.RESNET18
    extra = {} if kern_mod is jkern else {"device": "cpu"}
    inf = kern_mod.InferenceKernel(model, full, est, apply_mx=False, **extra)
    lab = kern_mod.LabelingKernel(model, full, est, apply_mx=False, **extra)
    ret = kern_mod.RetrainKernel(model, full, est, hp, **extra)
    views = (inf.plan_time_per_sample(spatial),
             lab.plan_time_per_sample(spatial),
             ret.plan_time_per_batch(spatial),
             inf.plan_time_per_sample(spatial, role="t_sa"),
             inf.plan_keep_frac(spatial, 30.0))
    direct = (inf.time_per_sample(4, "mx4"), lab.time_per_sample(12, "mx6"),
              ret.time_per_batch(12, "mx9"), inf.time_per_sample(12, "mx4"),
              inf.keep_frac(4, "mx4", 30.0))
    return views, direct


def test_kernels_read_rows_and_precision_from_spatial_plane():
    jviews, jdirect = _kernel_views(
        jcfg, jest, jkern, jmx, jalloc, jdec,
        jreg.make_vision_model(jcfg.RESNET18.reduced()))
    tviews, tdirect = _kernel_views(
        tcfg, test_, tkern, tmx, talloc, tdec,
        treg.make_vision_model(tcfg.RESNET18.reduced(), "cpu"))
    assert jviews == jdirect
    assert tviews == tdirect
    assert tviews == pytest.approx(jviews, rel=TOL, abs=TOL)


# --------------------------------------------------- plan-consuming phase --
class _RecordingPipe:
    def __init__(self):
        self.hints = []

    def begin_phase(self, start, label_hint=None):
        self.hints.append(label_hint)


def _hint_script(disp_mod, alloc):
    disp = disp_mod.KernelDispatcher()
    decs = [alloc.AllocationDecision(10, 4, 8,
                                     extra_label_samples=24).split(),
            alloc.AllocationDecision(10, 4, 16).split()]
    pipes = [_RecordingPipe(), _RecordingPipe()]
    plan = disp.begin_phase(0.0, pipes, decisions=decs, fps=30.0)
    assert pipes[0].hints == [(32, 30.0)] and pipes[1].hints == [(16, 30.0)]
    assert plan.decisions == tuple(decs)
    plan = disp.begin_phase(1.0, pipes, decisions=decs, fps=None)
    assert pipes[0].hints[-1] is None and pipes[1].hints[-1] is None
    assert plan.decisions == tuple(decs)
    plan = disp.begin_phase(2.0, pipes, label_hints=[(7, 1.0), None],
                            decisions=decs, fps=30.0)
    assert (pipes[0].hints[-1], pipes[1].hints[-1]) == ((7, 1.0), None)
    assert plan.decisions == tuple(decs)
    # The reference's positional order: start, pipeline, label_hints,
    # decisions, fps; a short explicit list leaves later lanes unhinted.
    plan = disp.begin_phase(3.0, pipes, [(7, 1.0), None], decs, 30.0)
    assert pipes[0].hints[-1] == (7, 1.0) and pipes[1].hints[-1] is None
    disp.begin_phase(4.0, pipes, [(5, 2.0)])
    assert pipes[0].hints[-1] == (5, 2.0) and pipes[1].hints[-1] is None
    assert disp.phases_dispatched == 5
    return [p.hints for p in pipes], [_flat(d) for d in plan.decisions]


def test_begin_phase_label_hints():
    assert _hint_script(tdisp, talloc) == _hint_script(jdisp, jalloc)


# ------------------------------------------------------- engine drift flag --
def _drift_script(alloc):
    hp = alloc.CLHyperParams(v_thr=-0.05)
    pol = alloc.SpatiotemporalAllocator(hp)
    healthy = dict(acc_valid=0.8, acc_label=0.82, t=1.0)
    d1 = pol.next_decision(alloc.PhaseFeedback(**healthy, drifted=True))
    assert d1.reset_buffer and d1.extra_label_samples == hp.n_ldd - hp.n_l
    d2 = pol.next_decision(alloc.PhaseFeedback(
        acc_valid=0.9, acc_label=0.2, t=2.0, drifted=False))
    assert not d2.reset_buffer
    d3 = pol.next_decision(alloc.PhaseFeedback(acc_valid=0.9, acc_label=0.2,
                                               t=3.0))
    assert d3.reset_buffer
    seen = (pol.observe_drift(0.2, 0.9, 4.0), pol.observe_drift(0.82, 0.8,
                                                                5.0))
    assert seen == (True, False)
    return [_flat(d) for d in (d1, d2, d3)], seen


def test_policy_honors_engine_set_drift_flag():
    assert _drift_script(talloc) == _drift_script(jalloc)
