"""Step builders: the train, prefill and decode steps per (arch, shape)
under a mesh and its rules (the JAX package's ``launch/steps.py``).

A :class:`StepBundle` holds a step's function, the ``NamedSharding``
trees (``runtime/elastic.py``) of its arguments and results, and
``abstract_args``: meta tensors (``ParamDef.meta``) of the arguments,
shapes and dtypes with no storage, for the dry run. ``fn`` runs eagerly
on real tensors laid out by ``in_shardings`` (plain tensors on one rank,
DTensors over more) inside ``use_rules(rules, mesh)``; it updates the
train state and the caches in place, where the reference donates them.
:func:`trace_bundle` is the dry run's counterpart of the reference's
``lower_bundle`` (jit + lower): it runs ``fn`` once on fake tensors laid
out by ``in_shardings`` and returns what one rank's step costs
(``launch/counting.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.convert import experts_to_virtual
from repro_torch.distributed import (
    PartitionSpec,
    ShardingRules,
    is_device_mesh,
    mesh_axis_size,
    param_shapes,
    param_specs,
    use_rules,
)
from repro_torch.device import DeviceLike
from repro_torch.models.moe import expert_split_factor
from repro_torch.models.transformer import LMModel
from repro_torch.runtime.elastic import reshard_tree, shardings_for
from repro_torch.training.grad import microbatched_grads
from repro_torch.training.optimizer import OptimizerConfig, apply_updates
from repro_torch.training.train_state import TrainState, train_state_specs
from repro_torch.tree import tree_leaves, tree_map

DEFAULT_MICROBATCHES = {"train": 16}

P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class StepBundle:
    """Everything needed to run or lower one (arch x shape) cell."""

    fn: Any  # the step function
    in_shardings: Any
    out_shardings: Any
    abstract_args: Tuple  # meta tensors matching fn's signature
    donate_argnums: Tuple = ()  # train: state; decode: caches (in place)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _shardings(mesh, specs):
    """``NamedSharding`` trees of ``specs`` on ``mesh``; None without a
    mesh (a step run with no rules)."""
    return None if mesh is None else shardings_for(mesh, specs)


def _device(mesh, device: DeviceLike):
    """The model's device: ``device``, else a ``DeviceMesh``'s type, else
    (an abstract mesh) the meta device."""
    if device is not None:
        return device
    return mesh.device_type if is_device_mesh(mesh) else "meta"


def place_params(arch: ArchConfig, params, shardings, mesh,
                 rules: ShardingRules):
    """An init's ``params`` laid out by ``shardings`` (a ``NamedSharding``
    tree) on ``mesh``: where the mesh's expert axis asks for expert
    fission (``expert_split_factor``), each MoE layer's experts are first
    split into their virtual experts (``convert.experts_to_virtual``), so
    the model computes the same function as the unsplit init."""
    with use_rules(rules, mesh):
        r = expert_split_factor(arch) if arch.num_experts else 1
    return reshard_tree(experts_to_virtual(params, r), shardings)


# ------------------------------------------------------------------- inputs
def input_specs(arch: ArchConfig, shape: ShapeConfig,
                rules: ShardingRules) -> Dict[str, Any]:
    """Meta stand-ins for the step inputs and their specs."""
    b, s = shape.global_batch, shape.seq_len
    batch_axes = rules.get("batch")
    embeds = arch.input_mode == "embeddings"

    def inputs(seq):
        if embeds:
            return (_meta((b, seq, arch.d_model), torch.bfloat16),
                    P(batch_axes, None, None))
        return _meta((b, seq), torch.int32), P(batch_axes, None)

    if shape.kind == "train":
        x, in_spec = inputs(s)
        if arch.num_output_heads > 1:
            labels = _meta((b, s, arch.num_output_heads), torch.int32)
            lbl_spec = P(batch_axes, None, None)
        else:
            labels = _meta((b, s), torch.int32)
            lbl_spec = P(batch_axes, None)
        return {"batch": {"inputs": x, "labels": labels},
                "specs": {"inputs": in_spec, "labels": lbl_spec}}
    if shape.kind == "prefill":
        x, in_spec = inputs(s)
        return {"batch": {"inputs": x}, "specs": {"inputs": in_spec}}
    x, in_spec = inputs(1)  # decode: one new token against the cache
    return {"batch": {"inputs": x, "t": _meta((), torch.int32)},
            "specs": {"inputs": in_spec, "t": P()}}


# -------------------------------------------------------------------- train
def train_step(model: LMModel, state: TrainState, batch,
               opt_cfg: OptimizerConfig, num_microbatches: int = 1,
               params=None, constrain_grads=None):
    """One step: ``microbatched_grads`` of ``model.loss`` at ``params``
    (default the state's), then ``apply_updates`` of the state (params and
    moments updated in place)."""
    loss, metrics, grads = microbatched_grads(
        lambda p, b: model.loss(p, b),
        state.params if params is None else params, batch,
        num_microbatches, constrain_grads=constrain_grads)
    params, opt, om = apply_updates(state.params, grads, state.opt_state,
                                    state.step, opt_cfg)
    del grads
    return TrainState(params, opt, state.step + 1), {**metrics, **om}


def build_train_bundle(arch: ArchConfig, shape: ShapeConfig, mesh,
                       rules: ShardingRules,
                       opt_cfg: Optional[OptimizerConfig] = None,
                       num_microbatches: Optional[int] = None,
                       zero2_gather: bool = False,
                       device: DeviceLike = None) -> StepBundle:
    """The train step ``fn(state, batch) -> (state, metrics)``. With
    ``zero2_gather`` (off by default, as in the reference) and more than
    one microbatch, the FSDP-sharded weights are gathered once a step and
    the gradients laid out sharded again (ZeRO-2)."""
    model = LMModel(arch, _device(mesh, device))
    opt_cfg = opt_cfg or OptimizerConfig(name="adamw", lr=3e-4)
    if num_microbatches is None:
        # >100B models need small microbatches to fit gathered weights.
        num_microbatches = 16 if arch.param_count() > 8e10 \
            else DEFAULT_MICROBATCHES["train"] // 2
    nmb = num_microbatches
    dp = mesh_axis_size(mesh, rules.get("batch"))
    nmb = max(1, min(nmb, shape.global_batch // max(dp, 1)))
    while shape.global_batch % nmb:
        nmb -= 1

    gather_rules = ShardingRules(rules)
    gather_rules["embed"] = None
    gather_rules["expert_in"] = None
    with use_rules(rules, mesh):
        defs = model.param_defs()
        state_specs = train_state_specs(defs)
        p_shapes = param_shapes(defs)
        io = input_specs(arch, shape, rules)
    with use_rules(gather_rules, mesh):
        gathered = _shardings(mesh, param_specs(defs))
    fsdp = _shardings(mesh, state_specs.params)

    def fn(state: TrainState, batch):
        with use_rules(rules, mesh):
            if zero2_gather and nmb > 1 and mesh is not None:
                return train_step(
                    model, state, batch, opt_cfg, nmb,
                    params=reshard_tree(state.params, gathered),
                    constrain_grads=lambda g: reshard_tree(g, fsdp))
            return train_step(model, state, batch, opt_cfg, nmb)

    opt_shapes = {k: _moments(p_shapes) for k in ("mu", "nu")}
    state_sh = None if mesh is None else state_shardings(mesh, state_specs)
    return StepBundle(
        fn=fn,
        in_shardings=(state_sh, _shardings(mesh, io["specs"])),
        out_shardings=(state_sh, None),
        abstract_args=(TrainState(p_shapes, opt_shapes,
                                  _meta((), torch.int32)), io["batch"]),
        donate_argnums=(0,),
    )


def _moments(p_shapes):
    return tree_map(lambda m: _meta(m.shape, torch.float32), p_shapes)


def state_shardings(mesh, specs: TrainState) -> TrainState:
    """A TrainState of spec trees -> one of ``NamedSharding`` trees."""
    return TrainState(*(shardings_for(mesh, s) for s in (
        specs.params, specs.opt_state, specs.step)))


# ------------------------------------------------------------------ prefill
def build_prefill_bundle(arch: ArchConfig, shape: ShapeConfig, mesh,
                         rules: ShardingRules,
                         device: DeviceLike = None) -> StepBundle:
    """``fn(params, batch) -> (last logits, caches of seq_len slots)``."""
    model = LMModel(arch, _device(mesh, device))

    def fn(params, batch):
        with use_rules(rules, mesh):
            return model.prefill(params, batch["inputs"],
                                 cache_capacity=shape.seq_len)

    with use_rules(rules, mesh):
        defs = model.param_defs()
        p_specs = param_specs(defs)
        cache_specs = param_specs(model.cache_defs(shape.global_batch,
                                                   shape.seq_len))
        io = input_specs(arch, shape, rules)
    return StepBundle(
        fn=fn,
        in_shardings=(_shardings(mesh, p_specs),
                      _shardings(mesh, io["specs"])),
        out_shardings=(None, _shardings(mesh, cache_specs)),
        abstract_args=(param_shapes(defs), io["batch"]),
    )


# ------------------------------------------------------------------- decode
def build_decode_bundle(arch: ArchConfig, shape: ShapeConfig, mesh,
                        rules: ShardingRules,
                        device: DeviceLike = None) -> StepBundle:
    """``fn(params, caches, batch) -> (logits, caches)``: one token at
    ``batch["t"]`` (an int), the caches updated in place."""
    model = LMModel(arch, _device(mesh, device))

    def fn(params, caches, batch):
        with use_rules(rules, mesh):
            return model.decode_step(params, batch["inputs"],
                                     int(batch["t"]), caches)

    with use_rules(rules, mesh):
        defs = model.param_defs()
        p_specs = param_specs(defs)
        cache_defs = model.cache_defs(shape.global_batch, shape.seq_len)
        cache_specs = param_specs(cache_defs)
        io = input_specs(arch, shape, rules)
    cache_sh = _shardings(mesh, cache_specs)
    return StepBundle(
        fn=fn,
        in_shardings=(_shardings(mesh, p_specs), cache_sh,
                      _shardings(mesh, io["specs"])),
        out_shardings=(None, cache_sh),
        abstract_args=(param_shapes(defs), param_shapes(cache_defs),
                       io["batch"]),
        donate_argnums=(1,),
    )


def build_bundle(arch: ArchConfig, shape: ShapeConfig, mesh,
                 rules: ShardingRules, **kw) -> StepBundle:
    if shape.kind == "train":
        return build_train_bundle(arch, shape, mesh, rules, **kw)
    if shape.kind == "prefill":
        return build_prefill_bundle(arch, shape, mesh, rules, **kw)
    return build_decode_bundle(arch, shape, mesh, rules, **kw)


# ------------------------------------------------------------------ dry run
def bundle_args(bundle: StepBundle, make, t: Optional[int] = None):
    """The step's arguments: each meta leaf of ``abstract_args`` made whole
    by ``make(meta)`` and laid out by its ``in_shardings`` leaf (as it
    stands where the bundle has no shardings); the train state's step is
    0 and a decode batch's ``t`` the int ``t``."""
    def leaf(meta, sharding):
        return make(meta) if sharding is None else sharding.place(make(meta))

    def tree(abstract, shardings):
        if shardings is None:
            return tree_map(make, abstract)
        return tree_map(leaf, abstract, shardings)

    args = []
    for i, abstract in enumerate(bundle.abstract_args):
        sh = None if bundle.in_shardings is None else bundle.in_shardings[i]
        if isinstance(abstract, TrainState):
            sh = sh or TrainState(None, None, None)
            args.append(TrainState(tree(abstract.params, sh.params),
                                   tree(abstract.opt_state, sh.opt_state),
                                   0))
        elif isinstance(abstract, dict) and "t" in abstract:
            rest = {k: v for k, v in abstract.items() if k != "t"}
            placed = tree(rest, None if sh is None else {
                k: sh[k] for k in rest})
            args.append({**placed, "t": t})
        else:
            args.append(tree(abstract, sh))
    return tuple(args)


def trace_bundle(bundle: StepBundle, mesh, rules: ShardingRules, *,
                 t: Optional[int] = None, multiply: bool = True):
    """One rank's counts of the step (``counting.Counts``): ``fn`` run once
    under ``FakeTensorMode`` on fake tensors laid out by
    ``in_shardings`` over ``mesh`` (a ``DeviceMesh`` over a fake process
    group of the mesh's size, ``launch/dryrun.py``; or of one rank),
    inside ``use_rules(rules, mesh)``. The repeated units are multiplied
    (``counts.repeat``) unless ``multiply`` is False. Nothing runs on a
    device; a decode step is traced at position ``t``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.counting import Counter, tensor_bytes

    with FakeTensorMode(allow_non_fake_inputs=True), use_rules(rules, mesh):
        args = bundle_args(bundle, lambda m: torch.empty(
            m.shape, dtype=m.dtype), t)
        counter = Counter(multiply)
        with counter:
            result = bundle.fn(*args)
        found = counter.finish(result)
        found.arg_bytes = sum(tensor_bytes(x) for x in arg_leaves(args))
    return found


def arg_leaves(args):
    """The tensors among a step's arguments (a train state's leaves)."""
    leaves = []
    for a in args:
        tree = a.as_tree() if isinstance(a, TrainState) else a
        leaves += [x for x in tree_leaves(tree)
                   if isinstance(x, torch.Tensor)]
    return leaves
