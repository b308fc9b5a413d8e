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

# The MoE, Mamba-hybrid and xLSTM archs' driver runs across ranks: SERVE's
# and TRAIN's setups with the arch replaced.
MIXER_DRIVER_ARCHS = ("mixtral-8x7b", "jamba-v0.1-52b", "xlstm-125m")


def mixer_argv(argv: list, arch: str) -> list:
    """``argv`` (SERVE or TRAIN) with ``--arch`` set to ``arch``."""
    out = list(argv)
    out[out.index("--arch") + 1] = arch
    return out


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
    ``constrain`` over the (1, 2) mesh; the serve and train drivers of
    ``MIXER_DRIVER_ARCHS`` at (1, 2) (``mixer_argv``). Rank 0
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
    for arch in MIXER_DRIVER_ARCHS:
        res = serve.serve(mixer_argv(SERVE, arch) + ["--model-parallel", "2"])
        out[f"{arch}_serve_tokens"] = res["tokens"]
        out[f"{arch}_serve_logits"] = res["logits"].numpy()
        res = train.train(mixer_argv(TRAIN, arch) + [
            "--model-parallel", "2", "--checkpoint-dir",
            os.path.join(directory, f"ckpt_{arch}")])
        out[f"{arch}_train_loss"] = np.array(res["loss"])
        for i, p in enumerate(tree_leaves(res["params"])):
            out[f"{arch}_param_{i}"] = full_tensor(p).numpy()

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


# ------------------------------------------------ the MoE / mixer layers
def _layer_mesh(world: int, model: int):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", (world // model, model),
                            mesh_dim_names=("data", "model"))


def _record_rank_shapes(seen: list):
    """Wrap the per-rank bodies of ``models/moe.py`` and ``models/ssm.py``
    so each call records the shapes it was handed: the experts of its
    ``w_gate`` / ``w_down`` and the channels of its Mamba leaves and
    caches."""
    from repro_torch.models import moe, ssm

    moe_rank, mamba_rank = moe.moe_rank, ssm.mamba_rank

    def moe_recording(x, router, w_gate, w_up, w_down, cfg, **kw):
        seen.append(("moe", tuple(w_gate.shape), tuple(w_down.shape),
                     kw["first"]))
        return moe_rank(x, router, w_gate, w_up, w_down, cfg, **kw)

    def mamba_recording(params, x, cfg, **kw):
        cache = kw.get("cache") or {}
        seen.append(("mamba", tuple(params["w_in_x"].shape),
                     tuple(params["w_out"].shape),
                     tuple(cache["ssm"].shape) if "ssm" in cache else ()))
        return mamba_rank(params, x, cfg, **kw)

    moe.moe_rank, ssm.mamba_rank = moe_recording, mamba_recording


def _moe_cfg(experts=None):
    import dataclasses

    from repro_torch import configs

    cfg = configs.get_arch("mixtral-8x7b").reduced()
    return cfg if experts is None else dataclasses.replace(
        cfg, num_experts=experts)


def _moe_run(cfg, params, data, mesh, kind: str, out: dict, tag: str):
    """The MoE layer on ``mesh`` under ``kind``'s rules (train: forward
    and the gradients of sum(y·w) + aux; decode: one token a row, no
    drop): y, aux and the gradients, whole, into ``out``."""
    import numpy as np
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import placements, place_tree, use_rules
    from repro_torch.launch.sharding import make_rules
    from repro_torch.models import moe
    from repro_torch.tree import tree_map

    x = torch.from_numpy(data["x"] if kind == "train" else data["x"][:, :1])
    rules = make_rules(cfg, ShapeConfig(kind, x.shape[1], x.shape[0], kind),
                       mesh)
    with use_rules(rules, mesh):
        live = tree_map(lambda t: t.detach().requires_grad_(True),
                        place_tree(params, moe.moe_defs(cfg)))
        xd = distribute_tensor(x, mesh, placements(rules.spec_for(
            ("act_batch", None, None)), mesh))
        y, aux = moe.moe_forward(live, xd, cfg, no_drop=kind == "decode")
        if kind == "train":
            ((y * torch.from_numpy(data["w"])).sum() + aux).backward()
            for k, v in live.items():
                out[f"{tag}_g_{k}"] = v.grad.full_tensor().numpy()
                out[f"{tag}_local_{k}"] = np.array(v.to_local().shape)
    out[f"{tag}_y"] = y.full_tensor().detach().numpy()
    out[f"{tag}_aux"] = aux.full_tensor().detach().numpy()


def expert_parallel(rank, world, directory, inputs: str) -> None:
    """Reduced mixtral-8x7b's MoE layer on a (2, 2) mesh, under the train
    and decode rules (``_moe_run``) from the inputs of ``inputs``, each
    rank's body recording its shapes; rank 0 writes ``port_ep.npz``, every
    rank ``ep_<rank>.npz`` with its recorded shapes."""
    import numpy as np
    import torch

    from repro_torch.models import moe

    data = dict(np.load(inputs))
    moe.MOE_GROUP = int(data["group"])
    seen = []
    _record_rank_shapes(seen)
    cfg = _moe_cfg()
    params = {k[2:]: torch.from_numpy(v) for k, v in data.items()
              if k.startswith("p_")}
    mesh = _layer_mesh(world, 2)
    out = {}
    for kind in ("train", "decode"):
        _moe_run(cfg, params, data, mesh, kind, out, kind)
    _save(directory, f"ep_{rank}.npz", {
        "seen": np.array([s[1] + s[2] + (s[3],) for s in seen]),
        "coord": np.array(mesh.get_coordinate())})
    if rank == 0:
        _save(directory, "port_ep.npz", out)


def _mixer_chain(layer: str, cfg, params, data, mesh, out: dict) -> None:
    """One Mamba / mLSTM / sLSTM layer on ``mesh`` (None: plain tensors):
    under the train rules the output and the gradients of sum(y·w); under
    the decode rules a prefill of ``data["x"]`` into a zero cache laid out
    by the cache defs, then a decode step for each row of ``data["steps"]``
    against it; outputs and the final cache, whole, into ``out``."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import (full_tensor, is_param_def,
                                         place_tree, placements, use_rules)
    from repro_torch.launch.sharding import make_rules
    from repro_torch.models import ssm, xlstm
    from repro_torch.tree import tree_map

    defs, fwd, cdefs = {
        "mamba": (ssm.mamba_defs, ssm.mamba_forward, ssm.mamba_cache_defs),
        "mlstm": (xlstm.mlstm_defs, xlstm.mlstm_forward,
                  xlstm.mlstm_cache_defs),
        "slstm": (xlstm.slstm_defs, xlstm.slstm_forward,
                  xlstm.slstm_cache_defs)}[layer]
    x = torch.from_numpy(data["x"])
    steps = torch.from_numpy(data["steps"])
    b, s, _ = x.shape

    def lay(t, rules):
        if mesh is None:
            return t
        return distribute_tensor(t, mesh, placements(rules.spec_for(
            ("act_batch", None, None)), mesh))

    for kind in ("train", "decode"):
        rules = None if mesh is None else make_rules(
            cfg, ShapeConfig(kind, s + steps.shape[1], b, kind), mesh)
        with use_rules(rules, mesh):
            p = place_tree(params, defs(cfg))
            if kind == "train":
                live = tree_map(lambda t: t.detach().requires_grad_(True), p)
                y, _ = fwd(live, lay(x, rules), cfg, mode="train")
                (y * torch.from_numpy(data["w"])).sum().backward()
                out["train_y"] = full_tensor(y).detach().numpy()
                for k, v in live.items():
                    out[f"g_{k}"] = full_tensor(v.grad).numpy()
                continue
            cache = place_tree(tree_map(
                lambda d: d.initialize(None, "cpu"), cdefs(cfg, b),
                is_leaf=is_param_def), cdefs(cfg, b))
            with torch.no_grad():
                y, _ = fwd(p, lay(x, rules), cfg, mode="prefill",
                           cache=cache)
                out["prefill_y"] = full_tensor(y).numpy()
                for t in range(steps.shape[1]):
                    y, _ = fwd(p, lay(steps[:, t:t + 1], rules), cfg,
                               mode="decode", cache=cache)
                    out[f"decode_y{t}"] = full_tensor(y).numpy()
            for k, v in cache.items():
                out[f"cache_{k}"] = full_tensor(v).numpy()


def tp_mixers(rank, world, directory, inputs: str) -> None:
    """On a (1, 2) mesh: reduced jamba-v0.1-52b's Mamba layer and reduced
    xlstm-125m's mLSTM and sLSTM layers (``_mixer_chain``), and the MoE
    layer of reduced mixtral-8x7b with 3 experts, which the 2-way expert
    axis splits into 6 virtual experts (the reference's r = 1 weights
    carried across by ``convert.experts_to_virtual``); each rank's bodies
    record their shapes. Rank 0 writes ``port_tp.npz``, every rank
    ``tp_<rank>.npz``."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.convert import experts_to_virtual
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import use_rules
    from repro_torch.launch.sharding import make_rules
    from repro_torch.models import moe, ssm, xlstm

    data = dict(np.load(inputs))
    moe.MOE_GROUP = ssm.MAMBA_CHUNK = xlstm.MLSTM_CHUNK = int(data["piece"])
    seen = []
    _record_rank_shapes(seen)
    mesh = _layer_mesh(world, 2)
    out = {}
    for layer, arch in (("mamba", "jamba-v0.1-52b"), ("mlstm", "xlstm-125m"),
                        ("slstm", "xlstm-125m")):
        sub = {k.split("/", 1)[1]: v for k, v in data.items()
               if k.startswith(layer + "/")}
        params = {k[2:]: torch.from_numpy(v) for k, v in sub.items()
                  if k.startswith("p_")}
        got = {}
        _mixer_chain(layer, configs.get_arch(arch).reduced(), params, sub,
                     mesh, got)
        out.update({f"{layer}/{k}": v for k, v in got.items()})
    cfg = _moe_cfg(3)
    rules = make_rules(cfg, ShapeConfig("train", 8, 2, "train"), mesh)
    with use_rules(rules, mesh):
        r = moe.expert_split_factor(cfg)
    sub = {k.split("/", 1)[1]: v for k, v in data.items()
           if k.startswith("fission/")}
    virtual = experts_to_virtual({k[2:]: v for k, v in sub.items()
                                  if k.startswith("p_")}, r)
    got = {"r": np.array(r)}
    _moe_run(cfg, {k: torch.from_numpy(v) for k, v in virtual.items()},
             sub, mesh, "train", got, "train")
    out.update({f"fission/{k}": v for k, v in got.items()})
    _save(directory, f"tp_{rank}.npz", {
        "moe": np.array([s[1] + s[2] + (s[3],) for s in seen
                         if s[0] == "moe"]),
        "mamba": np.array([s[1] + s[2] + s[3] for s in seen
                           if s[0] == "mamba" and s[3]])})
    if rank == 0:
        _save(directory, "port_tp.npz", out)
