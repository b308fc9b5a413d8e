"""Gloo worlds on the CPU for ``tests/test_torch_dryrun_counts.py``: ranks
that run real steps under the dry run's counter, and ranks that serve on
a two-pod mesh. Imports no JAX.

:func:`run_world` starts ``world`` processes, each joining a gloo group
over a ``FileStore`` in the test's directory, and runs ``fn`` (this
module's :func:`count_cells` or :func:`pod_serve`) on every rank; each
rank writes what it found there as JSON."""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run_world(world: int, directory, cells, timeout: float = 600,
              fn: str = "count_cells") -> list:
    """Run ``fn`` on ``world`` ranks; returns what each rank found (a list
    per rank, one entry per cell)."""
    directory = str(directory)
    code = ("import sys; sys.path[:0] = [{src!r}, {tests!r}]; "
            "import _torch_count_worlds as w; w._entry()").format(
                src=str(ROOT / "src"), tests=str(ROOT / "tests"))
    procs = []
    for rank in range(world):
        env = dict(os.environ, COUNT_RANK=str(rank), COUNT_WORLD=str(world),
                   COUNT_DIR=directory, COUNT_CELLS=json.dumps(cells),
                   COUNT_FN=fn)
        env.pop("WORLD_SIZE", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"ranks {failed} failed:\n" + "\n".join(
            f"--- rank {r}\n{outs[r][-6000:]}" for r in failed))
    result = []
    for rank in range(world):
        with open(os.path.join(directory, f"counts_{rank}.json")) as f:
            result.append(json.load(f))
    return result


def cell_bundle(mesh, name: str, kind: str, seq: int, batch: int,
                layers: int):
    """(the bundle, its rules) of a reduced arch with ``layers`` layers
    at [batch, seq] on ``mesh``."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.sharding import make_rules
    from repro_torch.launch.steps import build_bundle

    arch = dataclasses.replace(configs.get_arch(name).reduced(),
                               num_layers=layers)
    shape = ShapeConfig("count", seq, batch, kind)
    rules = make_rules(arch, shape, mesh)
    kw = {"num_microbatches": 1} if kind == "train" else {}
    return build_bundle(arch, shape, mesh, rules, device="cpu", **kw), rules


def summary(counts) -> dict:
    return {"flops": counts.flops, "op_bytes": counts.op_bytes,
            "op_counts": counts.op_counts, "ring_bytes": counts.ring_bytes,
            "kernel_flops": counts.kernel_flops}


def count_cells(rank: int, world: int, directory: str, cells) -> None:
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.counting import Counter
    from repro_torch.launch.steps import bundle_args

    found = []
    for name, kind, seq, batch, layers, shape in cells:
        mesh = init_device_mesh("cpu", tuple(shape),
                                mesh_dim_names=("data", "model"))
        bundle, _ = cell_bundle(mesh, name, kind, seq, batch, layers)
        args = bundle_args(bundle, lambda m: torch.zeros(m.shape,
                                                         dtype=m.dtype),
                           seq - 1)
        counter = Counter()
        with counter:
            bundle.fn(*args)
        found.append(summary(counter.counts))
    with open(os.path.join(directory, f"counts_{rank}.json"), "w") as f:
        json.dump(found, f)


def pod_serve(rank: int, world: int, directory: str, cells) -> None:
    """The serve driver (``launch/serve.py``) for each of ``cells``, its
    argument list, on a ("pod", "data", "model") = (world, 1, 1) mesh: the
    decode rules split the tokens over ("pod", "data") and keep the caches
    whole over "pod". Each rank writes its tokens and decode logits."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import serve

    mesh = init_device_mesh("cpu", (world, 1, 1),
                            mesh_dim_names=("pod", "data", "model"))
    found = []
    for argv in cells:
        res = serve._serve(serve.parse_args(argv), torch.device("cpu"), mesh)
        found.append({"tokens": res["tokens"].tolist(),
                      "logits": res["logits"].tolist()})
    with open(os.path.join(directory, f"counts_{rank}.json"), "w") as f:
        json.dump(found, f)


def _entry() -> None:
    import torch
    import torch.distributed as dist

    rank = int(os.environ["COUNT_RANK"])
    world = int(os.environ["COUNT_WORLD"])
    directory = os.environ["COUNT_DIR"]
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(directory, "store"),
                                     world), rank=rank, world_size=world)
    try:
        globals()[os.environ["COUNT_FN"]](
            rank, world, directory, json.loads(os.environ["COUNT_CELLS"]))
    finally:
        dist.destroy_process_group()
