"""Multi-rank ``torch.distributed`` worlds on the CPU for the port's mesh
tests (``tests/test_torch_sharded_attention.py``,
``tests/test_torch_mesh_drivers.py``). Imports no JAX.

:func:`run_world` starts ``world`` processes, one a rank, each joining a
gloo group over a ``FileStore`` in the test's own directory (so parallel
test workers never share a port), and runs one function of this module on
every rank; the function writes what the test reads into that
directory. The world is started once per test file and runs every check
of the file."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run_world(name: str, world: int, directory, timeout: float = 600,
              **kwargs) -> None:
    """Run ``name(rank, world, directory, **kwargs)`` on ``world`` ranks;
    raise with the ranks' output if one fails."""
    directory = str(directory)
    code = ("import sys; sys.path[:0] = [{src!r}, {tests!r}]; "
            "import _torch_worlds as w; w._entry()").format(
                src=str(ROOT / "src"), tests=str(ROOT / "tests"))
    procs = []
    for rank in range(world):
        env = dict(os.environ, WORLD_RANK=str(rank), WORLD_SIZE_=str(world),
                   WORLD_FN=name, WORLD_DIR=directory,
                   WORLD_KW=json.dumps(kwargs))
        env.pop("WORLD_SIZE", None)  # no torchrun environment
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
        raise RuntimeError(f"{name}: ranks {failed} failed:\n" + "\n".join(
            f"--- rank {r}\n{outs[r][-6000:]}" for r in failed))


def _entry() -> None:
    import torch
    import torch.distributed as dist

    rank, world = int(os.environ["WORLD_RANK"]), int(
        os.environ["WORLD_SIZE_"])
    directory = os.environ["WORLD_DIR"]
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(directory, "store"),
                                     world), rank=rank, world_size=world)
    try:
        globals()[os.environ["WORLD_FN"]](
            rank, world, directory, **json.loads(os.environ["WORLD_KW"]))
    finally:
        dist.destroy_process_group()


def _save(directory, name: str, arrays: dict) -> None:
    import numpy as np

    np.savez(os.path.join(directory, name), **arrays)


# ------------------------------------------------ sequence-sharded attention
def sharded_attention(rank, world, directory, inputs: str) -> None:
    """The port's ``sharded_flash_decode`` and ``seq_parallel_flash`` (with
    q / k / v gradients) over a (1, world) mesh on the inputs of
    ``inputs``; rank 0 writes ``port_attention.npz``."""
    import numpy as np
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.distributed import (
        ShardingRules,
        placements,
        use_rules,
    )
    from repro_torch.models import attention as attn

    data = dict(np.load(inputs))
    mesh = init_device_mesh("cpu", (1, world),
                            mesh_dim_names=("data", "model"))
    rep = [Replicate(), Replicate()]
    out = {}
    decode = ShardingRules({"kv_seq": "model", "kv_batch": "data"})
    for i in range(int(data["n_decode"])):
        t = int(data[f"d{i}_t"])
        cap = float(data[f"d{i}_cap"])
        q = distribute_tensor(torch.from_numpy(data[f"d{i}_q"])[:, None],
                              mesh, rep)
        pls = placements(decode.spec_for(("kv_batch", None, "kv_seq",
                                          None)), mesh)
        k, v = (distribute_tensor(torch.from_numpy(data[f"d{i}_{n}"]), mesh,
                                  pls) for n in ("k", "v"))
        with use_rules(decode, mesh):
            o = attn.sharded_flash_decode(
                q, k, v, t, logit_softcap=None if cap == 0 else cap,
                scale=float(data["scale"]))
        out[f"d{i}"] = o.full_tensor()[:, 0].numpy()
    seq = ShardingRules({"attn_seq": "model", "act_batch": "data"})
    for i in range(int(data["n_seq"])):
        window = int(data[f"s{i}_window"]) or None
        leaves = [distribute_tensor(torch.from_numpy(data[f"s{i}_{n}"]),
                                    mesh, rep).requires_grad_()
                  for n in ("q", "k", "v")]
        cot = distribute_tensor(torch.from_numpy(data[f"s{i}_cot"]), mesh,
                                rep)
        with use_rules(seq, mesh):
            o = attn.seq_parallel_flash(
                *leaves, window=window, logit_softcap=float(
                    data["softcap"]), scale=float(data["scale"]))
            (o * cot).sum().backward()
        out[f"s{i}"] = o.full_tensor().detach().numpy()
        out[f"s{i}_shard_dims"] = np.array([getattr(p, "dim", -1)
                                            for p in o.placements])
        for n, leaf in zip(("dq", "dk", "dv"), leaves):
            out[f"s{i}_{n}"] = leaf.grad.full_tensor().numpy()
    if rank == 0:
        _save(directory, "port_attention.npz", out)


# ------------------------------------------------------- the mesh drivers
SERVE = ["--arch", "gemma2-2b", "--reduced", "--device", "cpu", "--batch",
         "2", "--prompt-len", "12", "--gen", "5"]
TRAIN = ["--arch", "gemma2-2b", "--reduced", "--device", "cpu", "--steps",
         "1", "--batch", "2", "--seq", "32", "--log-every", "1",
         "--checkpoint-every", "1"]


def _train_setup(mesh, batch: int = 2, **bundle_kw):
    """(model, rules, params laid out by the bundle, a batch, the train
    bundle): reduced gemma2-2b in fp32 from the driver's seed on the token
    pipeline's first ``batch`` x 32 batch (TRAIN's at 2), under the train
    rules of ``mesh`` (None: no rules)."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.sharding import make_rules
    from repro_torch.launch.steps import build_train_bundle
    from repro_torch.models.transformer import LMModel
    from repro_torch.runtime.elastic import reshard_tree

    arch = dataclasses.replace(configs.get_arch("gemma2-2b").reduced(),
                               dtype="float32")
    shape = ShapeConfig("custom_train", 32, batch, "train")
    rules = make_rules(arch, shape, mesh)
    bundle = build_train_bundle(arch, shape, mesh, rules, device="cpu",
                                **bundle_kw)
    model = LMModel(arch, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    if mesh is not None:
        params = reshard_tree(params, bundle.in_shardings[0].params)
    data = {k: torch.from_numpy(v) for k, v in TokenPipeline(
        arch.vocab_size, 32, batch, seed=0).batch(0).items()}
    return model, rules, params, data, bundle


def zero2_step(mesh, zero2: bool):
    """(loss, full params) after one train bundle step over a batch of 4
    in 2 microbatches (2 rows each, one a rank of "data"), with or
    without the ZeRO-2 gather."""
    from repro_torch.distributed import full_tensor
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_state import TrainState
    from repro_torch.tree import tree_leaves

    opt = OptimizerConfig(name="adamw", lr=1e-3)
    _, _, params, batch, bundle = _train_setup(
        mesh, batch=4, num_microbatches=2, zero2_gather=zero2, opt_cfg=opt)
    state, metrics = bundle.fn(TrainState.create(params, opt), batch)
    return (float(full_tensor(metrics["loss"])),
            [full_tensor(p).numpy() for p in tree_leaves(state.params)])


def train_grads(mesh):
    """(loss, full gradients) of one train-shape step of reduced gemma2-2b
    (``_train_setup``)."""
    from repro_torch.distributed import full_tensor, use_rules
    from repro_torch.training.grad import microbatched_grads
    from repro_torch.tree import tree_map

    model, rules, params, batch, _ = _train_setup(mesh, num_microbatches=1)
    with use_rules(rules, mesh):
        loss, _, grads = microbatched_grads(lambda p, b: model.loss(p, b),
                                            params, batch, 1)
    return float(full_tensor(loss)), tree_map(
        lambda g: full_tensor(g).numpy(), grads)


def mesh_drivers(rank, world, directory) -> None:
    """On a 2-rank world: the serve driver at (data, model) = (1, 2) and
    (2, 1); one train step at (1, 2) (its gradients, the driver's final
    params and checkpoint); ``compressed_cross_pod_mean`` over a ("pod",)
    mesh of 2 with each rank's own gradients; ``reshard_tree`` and
    ``constrain`` over the (1, 2) mesh; a MoE arch above one rank. Rank 0
    writes ``mesh_drivers.npz``, each rank its ``pod_<rank>.npz``."""
    import numpy as np
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import (
        PartitionSpec,
        ShardingRules,
        constrain,
        full_tensor,
        placements,
        use_rules,
    )
    from repro_torch.launch import serve, train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime.elastic import NamedSharding, reshard_tree
    from repro_torch.training.grad import compress_int8
    from repro_torch.training.grad import compressed_cross_pod_mean
    from repro_torch.tree import tree_leaves

    out = {}
    for mp in (2, 1):
        res = serve.serve(SERVE + ["--model-parallel", str(mp)])
        out[f"serve_mp{mp}_tokens"] = res["tokens"]
        out[f"serve_mp{mp}_logits"] = res["logits"].numpy()

    mesh = make_host_mesh(2, "cpu")
    loss, grads = train_grads(mesh)
    out["grad_loss"] = np.float64(loss)
    for i, g in enumerate(tree_leaves(grads)):
        out[f"grad_{i}"] = g
    res = train.train(TRAIN + ["--model-parallel", "2", "--checkpoint-dir",
                               os.path.join(directory, "ckpt")])
    out["train_loss"] = np.array(res["loss"])
    for i, p in enumerate(tree_leaves(res["params"])):
        out[f"param_{i}"] = full_tensor(p).numpy()
    data_mesh = make_host_mesh(1, "cpu")  # (2, 1): FSDP over "data"
    for zero2 in (False, True):
        loss, params = zero2_step(data_mesh, zero2)
        out[f"zero2_{zero2}_loss"] = np.float64(loss)
        for i, p in enumerate(params):
            out[f"zero2_{zero2}_param_{i}"] = p

    # reshard_tree / NamedSharding / constrain over the (1, 2) mesh.
    x = torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6)
    specs = {"rows": PartitionSpec("model", None),
             "cols": PartitionSpec(None, "model"),
             "both": PartitionSpec(("data", "model"), None),
             "none": PartitionSpec()}
    placed = reshard_tree({k: x for k in specs},
                          {k: NamedSharding(mesh, s) for k, s in
                           specs.items()})
    for k, dt in placed.items():
        out[f"local_{k}"] = np.array(dt.to_local().shape)
        out[f"full_{k}"] = dt.full_tensor().numpy()
    rules = ShardingRules({"a": "model", "b": None})
    with use_rules(rules, mesh):
        moved = constrain(placed["none"], "a", "b")
        out["constrained_local"] = np.array(moved.to_local().shape)
        try:
            constrain(x, "a", "b")
            out["plain_raises"] = np.array("")
        except TypeError as e:
            out["plain_raises"] = np.array(str(e))
    try:
        placements(PartitionSpec(("model", "data")), mesh)
        out["order_raises"] = np.array("")
    except ValueError as e:
        out["order_raises"] = np.array(str(e))
    try:
        serve.serve(["--arch", "mixtral-8x7b", "--reduced", "--device", "cpu",
                     "--model-parallel", "2"])
        out["moe_raises"] = np.array("")
    except NotImplementedError as e:
        out["moe_raises"] = np.array(str(e))

    # compressed_cross_pod_mean over ("pod",) of 2, distinct per rank.
    pods = init_device_mesh("cpu", (2,), mesh_dim_names=("pod",))
    rng = np.random.default_rng(100 + rank)
    g = {"w": rng.normal(size=(5, 7)).astype(np.float32),
         "b": (rng.normal(size=(9,)) * 1e-3).astype(np.float32)}
    err = {k: (rng.normal(size=v.shape) * 1e-2).astype(np.float32)
           for k, v in g.items()}
    mean, new_err = compressed_cross_pod_mean(
        {k: torch.from_numpy(v) for k, v in g.items()},
        {k: torch.from_numpy(v) for k, v in err.items()}, pods)
    mine = {}
    for k in g:
        q, scale, _ = compress_int8(torch.from_numpy(g[k]),
                                    torch.from_numpy(err[k]))
        mine.update({f"g_{k}": g[k], f"err_{k}": err[k],
                     f"q_{k}": q.numpy(), f"scale_{k}": scale.numpy(),
                     f"mean_{k}": mean[k].numpy(),
                     f"new_err_{k}": new_err[k].numpy()})
    _save(directory, f"pod_{rank}.npz", mine)
    if rank == 0:
        _save(directory, "mesh_drivers.npz", out)
