"""The port's dry run against the JAX package's, where no step is traced:
every cell's plan (status, chips, model FLOPs) computed live from the
reference's configs, the report rendered byte for byte as the
reference's, the collective statistics against the reference's HLO parse,
and the roofline's fields and keys. Also: only the dry-run modules import
``torch.testing._internal`` (the fake process group's store)."""
import ast
import json
from pathlib import Path

import pytest

from repro import configs as jax_configs
from repro.configs.base import flops_per_token as jax_flops_per_token
from repro.configs.base import supports_shape as jax_supports_shape
from repro.launch import report as jax_report
from repro.launch import roofline as jax_roofline
from repro_torch.launch import dryrun, report, roofline
from repro_torch.launch.counting import COLLECTIVE_KINDS, Counts

from _torch_lm import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CELLS = [(arch.name, shape.name)
         for arch, shape, _ in jax_configs.all_cells(include_skipped=True)]
DRY_RUN_MODULES = {"src/repro_torch/launch/dryrun.py"}


def test_forty_cells():
    assert len(CELLS) == 40
    assert sum(jax_supports_shape(jax_configs.get_arch(a),
                                  jax_configs.get_shape(s))
               for a, s in CELLS) == 35


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multipod"])
def test_cell_plan_matches_reference(multi_pod):
    for arch_name, shape_name in CELLS:
        arch = jax_configs.get_arch(arch_name)
        shape = jax_configs.get_shape(shape_name)
        plan = dryrun.cell_plan(arch_name, shape_name, multi_pod)
        mesh = "multipod" if multi_pod else "pod"
        assert (plan["arch"], plan["shape"], plan["mesh"]) == (
            arch_name, shape_name, mesh)
        if not jax_supports_shape(arch, shape):
            assert plan["status"] == "skipped"
            assert plan["reason"] == ("long_500k needs sub-quadratic "
                                      "attention (DESIGN.md §4)")
            continue
        n_tokens = shape.global_batch * (
            shape.seq_len if shape.kind == "train" else
            shape.seq_len if shape.kind == "prefill" else 1)
        want = jax_flops_per_token(arch, shape.kind == "train") * n_tokens
        assert plan["status"] == "ok"
        assert plan["chips"] == (512 if multi_pod else 256)
        assert plan["model_flops"] == want, (arch_name, shape_name)


def _results():
    rf = roofline.Roofline(flops=3.5e14, hbm_bytes=2.25e12,
                           collective_bytes=7.5e10, ring_bytes=1.2e11,
                           chips=1).to_dict()
    ok = {"arch": "yi-6b", "shape": "train_4k", "mesh": "pod",
          "status": "ok", "chips": 256, "lower_s": 12.3, "compile_s": 0.0,
          "bytes_per_device": 37 * 2 ** 30 + 123, "temp_bytes": 1,
          "arg_bytes": 2, "output_bytes": 3, "peak_bytes": 4,
          "roofline": rf, "model_flops": 1.1e18,
          "useful_flops_ratio": 0.4567}
    slow = dict(ok, shape="prefill_32k", mesh="multipod",
                roofline=dict(rf, t_compute=1.23456, t_memory=0.0004,
                              bottleneck="compute"),
                useful_flops_ratio=0.999)
    skipped = {"arch": "yi-6b", "shape": "long_500k", "mesh": "pod",
               "status": "skipped", "reason": dryrun.SKIP_REASON}
    failed = {"arch": "gemma2-2b", "shape": "decode_32k", "mesh": "pod",
              "status": "fail", "error": "x" * 300}
    failed2 = dict(failed, mesh="multipod", error="")
    return json.loads(json.dumps([ok, slow, skipped, failed, failed2]))


@pytest.mark.parametrize("mesh", ["pod", "multipod"])
def test_report_matches_reference(mesh):
    results = _results()
    assert report.render(results, mesh) == jax_report.render(results, mesh)
    assert report.summarize(results) == jax_report.summarize(results)
    assert report.fmt_bytes(5 * 2 ** 30) == jax_report.fmt_bytes(5 * 2 ** 30)


def _hlo(k: int) -> str:
    groups = "{{" + ",".join(str(i) for i in range(k)) + "}}"
    return "\n".join([
        "%p0 = f32[16,128]{1,0} parameter(0)",
        "%p1 = bf16[8,64]{1,0} parameter(1)",
        f"%ag = f32[{16 * k},128]{{1,0}} all-gather(%p0), "
        f"replica_groups={groups}, dimensions={{0}}",
        f"%ar = bf16[8,64]{{1,0}} all-reduce(%p1), replica_groups={groups}, "
        "to_apply=%add",
        f"%rs = f32[{16 // k if k <= 16 else 1},128]{{1,0}} "
        f"reduce-scatter(%p0), replica_groups={groups}, dimensions={{0}}",
        f"%a2a = bf16[8,64]{{1,0}} all-to-all(%p1), "
        f"replica_groups={groups}, dimensions={{0}}",
    ])


@pytest.mark.parametrize("k", [2, 16])
def test_collective_stats_match_reference_parse(k):
    want = jax_roofline.parse_collectives(_hlo(k))
    counts = Counts()
    counts.add_collective("all-gather", 16 * 128 * 4, k)
    counts.add_collective("all-reduce", 8 * 64 * 2, k)
    counts.add_collective("reduce-scatter", 16 * 128 * 4, k)
    counts.add_collective("all-to-all", 8 * 64 * 2, k)
    got = roofline.collective_stats(counts)
    assert set(got.op_bytes) == set(want.op_bytes) == set(COLLECTIVE_KINDS)
    assert got.op_bytes == want.op_bytes
    assert got.op_counts == want.op_counts
    assert got.total_bytes == want.total_bytes
    assert got.ring_bytes == pytest.approx(want.ring_bytes, rel=1e-12)
    assert set(got.to_dict()) == set(want.to_dict())


def test_roofline_fields_and_keys_match_reference():
    kw = dict(flops=2.0e15, hbm_bytes=8.0e12, collective_bytes=3.0e10,
              ring_bytes=5.0e10, chips=2)
    port = roofline.Roofline(**kw)
    ref = jax_roofline.Roofline(**kw)
    port_fields = [f.name for f in roofline.dataclasses.fields(port)]
    ref_fields = [f.name for f in jax_roofline.dataclasses.fields(ref)]
    assert port_fields == ref_fields
    assert list(port.to_dict()) == list(ref.to_dict())
    # The H100's constants (datasheet figures), not the TPU's.
    assert (port.peak_flops, port.hbm_bw, port.ici_bw) == (
        989.4e12, 3.35e12, 50e9)
    assert port.t_compute == kw["flops"] / (2 * 989.4e12)
    assert port.t_memory == kw["hbm_bytes"] / (2 * 3.35e12)
    assert port.t_collective == kw["collective_bytes"] / (2 * 50e9)
    assert port.t_total == max(port.t_compute, port.t_memory,
                               port.t_collective)
    assert port.bottleneck == "memory"
    for name in ("t_compute", "t_memory", "t_collective", "t_total",
                 "bottleneck"):
        assert isinstance(getattr(type(port), name), property)
    counts = Counts(flops=7.0, hbm_bytes=11.0, hbm_bytes_unfused=13.0)
    counts.add_collective("all-reduce", 100.0, 4)
    rf = roofline.analyze(counts, 256)
    # The memory term reads the fused traffic, the unfused count rides in
    # collective_detail, as the reference's analyze does.
    assert (rf.flops, rf.hbm_bytes, rf.collective_bytes, rf.chips) == (
        7.0, 11.0, 100.0, 1)
    assert rf.ring_bytes == 150.0
    assert rf.collective_detail["hbm_bytes_unfused"] == 13.0


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_fake_group_store_only_in_dry_run_modules():
    """``torch.testing._internal`` (the fake process group's store) is
    imported by the dry-run modules alone, never on the main path."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    users = {str(p.relative_to(ROOT)) for p in files
             if any(m.startswith("torch.testing._internal")
                    for m in _imports(p))}
    assert users == DRY_RUN_MODULES
