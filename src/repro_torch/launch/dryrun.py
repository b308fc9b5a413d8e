"""Dry run: trace every (arch x shape) step on the production meshes and
read its per-device memory, FLOPs, bytes and collectives (the JAX
package's ``launch/dryrun.py``).

The reference lowers and compiles each step for 512 forced host devices.
The port runs it instead: once, on fake tensors (``FakeTensorMode``)
laid out as DTensors over a ``DeviceMesh`` of device type ``cpu`` whose
process group is a fake one (``FakeStore``) of the mesh's size, 256 ranks
for the (16, 16) pod or 512 for the (2, 16, 16) multi-pod mesh; the group
starts and ends per mesh size. Nothing is compiled and nothing touches a
card: the counts are one rank's (``steps.trace_bundle``,
``launch/counting.py``), the roofline the H100's (``launch/roofline.py``).
``lower_s`` is the trace's wall time and ``compile_s`` 0.0. The
reference's ``--dump-hlo`` has no counterpart: a torch step has no HLO.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \
      --out dryrun_torch.json
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback

from repro_torch import configs
from repro_torch.configs.base import flops_per_token, supports_shape
from repro_torch.launch import roofline as roofline_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.sharding import make_rules
from repro_torch.launch.steps import build_bundle, trace_bundle

SKIP_REASON = "long_500k needs sub-quadratic attention (DESIGN.md §4)"


def _mesh_name(multi_pod: bool) -> str:
    return "multipod" if multi_pod else "pod"


def cell_plan(arch_name: str, shape_name: str, multi_pod: bool) -> dict:
    """What a cell is before anything is traced: its status ("ok" to
    trace, or "skipped" with the reference's reason), its chips and its
    model FLOPs (``flops_per_token`` x the step's tokens)."""
    arch = configs.get_arch(arch_name)
    shape = configs.get_shape(shape_name)
    row = {"arch": arch_name, "shape": shape_name,
           "mesh": _mesh_name(multi_pod)}
    if not supports_shape(arch, shape):
        return {**row, "status": "skipped", "reason": SKIP_REASON}
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_tokens = shape.global_batch * (
        shape.seq_len if shape.kind in ("train", "prefill") else 1)
    return {**row, "status": "ok", "chips": _size(mesh.sizes),
            "model_flops": flops_per_token(arch, shape.kind == "train")
            * n_tokens}


def _size(sizes) -> int:
    n = 1
    for s in sizes:
        n *= s
    return n


@contextlib.contextmanager
def fake_world(size: int):
    """A fake process group of ``size`` ranks (this process rank 0) for
    the block; an existing group of that size is used as it is."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != size:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks is set; the dry run needs {size}")
        yield
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def device_mesh(multi_pod: bool):
    """The production mesh (``make_production_mesh``) as a ``cpu``
    ``DeviceMesh`` over the current (fake) group."""
    from torch.distributed.device_mesh import init_device_mesh

    abstract = make_production_mesh(multi_pod=multi_pod)
    return init_device_mesh("cpu", abstract.sizes,
                            mesh_dim_names=abstract.axis_names)


def run_cell(arch_name: str, shape_name: str, multi_pod: bool,
             verbose: bool = True) -> dict:
    plan = cell_plan(arch_name, shape_name, multi_pod)
    if plan["status"] != "ok":
        return plan
    arch = configs.get_arch(arch_name)
    shape = configs.get_shape(shape_name)
    chips = plan["chips"]
    t0 = time.time()
    try:
        with fake_world(chips):
            mesh = device_mesh(multi_pod)
            rules = make_rules(arch, shape, mesh)
            bundle = build_bundle(arch, shape, mesh, rules, device="cpu")
            traced = trace_bundle(bundle, mesh, rules, t=shape.seq_len - 1)
        t_lower = time.time() - t0
        rf = roofline_lib.analyze(traced, chips)
        model_flops = plan["model_flops"]
        result = {
            **{k: plan[k] for k in ("arch", "shape", "mesh", "status",
                                    "chips")},
            "lower_s": round(t_lower, 1),
            "compile_s": 0.0,
            "bytes_per_device": traced.temp_bytes + traced.arg_bytes,
            "temp_bytes": traced.temp_bytes,
            "arg_bytes": traced.arg_bytes,
            "output_bytes": traced.output_bytes,
            "peak_bytes": traced.peak_bytes,
            "roofline": rf.to_dict(),
            "model_flops": model_flops,
            # rf.flops is per device: the useful share of all the ranks'
            # counted compute.
            "useful_flops_ratio": (model_flops / (rf.flops * chips))
            if rf.flops else 0,
        }
        if verbose:
            print(f"[{arch_name} x {shape_name} x {plan['mesh']}] OK "
                  f"trace={t_lower:.0f}s "
                  f"mem/dev={result['bytes_per_device']/2**30:.2f}GiB "
                  f"bottleneck={rf.bottleneck} "
                  f"t=({rf.t_compute*1e3:.1f}, {rf.t_memory*1e3:.1f}, "
                  f"{rf.t_collective*1e3:.1f})ms "
                  f"useful={result['useful_flops_ratio']:.2f}",
                  flush=True)
        return result
    except Exception as e:  # noqa: BLE001 (a failed cell is a row)
        if verbose:
            traceback.print_exc()
            print(f"[{arch_name} x {shape_name}] FAIL {e}", flush=True)
        return {"arch": arch_name, "shape": shape_name,
                "mesh": plan["mesh"], "status": "fail",
                "error": str(e)[:2000]}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--all", action="store_true")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--both-meshes", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    cells = []
    if args.all:
        for arch, shape, _ok in configs.all_cells(include_skipped=True):
            cells.append((arch.name, shape.name))
    else:
        if not (args.arch and args.shape):
            p.error("--arch/--shape or --all")
        cells.append((args.arch, args.shape))

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]

    results = []
    for mp in meshes:
        with fake_world(_size(make_production_mesh(multi_pod=mp).sizes)):
            for arch_name, shape_name in cells:
                results.append(run_cell(arch_name, shape_name, mp))
                if args.out:  # incremental flush: a crash loses nothing
                    with open(args.out, "w") as f:
                        json.dump(results, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_fail = sum(r["status"] == "fail" for r in results)
    print(f"dry-run: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
