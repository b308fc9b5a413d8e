"""The sharding rules and spec derivations of the port against the JAX
package's, run live: ``tests/test_sharding.py``'s framework-free tests
ported, and for every arch config at full width (param defs only, nothing
allocated) x every LM shape x the one-pod and two-pod production meshes,
the param, cache, input, train-state and bundle spec trees and
``expert_split_factor``. The reference runs on a fake mesh of repeated
host devices, the port on ``launch/mesh.py``'s abstract production mesh:
both carry the axis names and sizes the rules read. Each ``PartitionSpec``
is compared as a tuple."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

from repro import configs as jax_configs
from repro import distributed as jdist
from repro.launch import sharding as jsharding
from repro.launch import steps as jsteps
from repro.models import moe as jmoe
from repro.models import resnet as jresnet
from repro.models import transformer as jtransformer
from repro.training import train_state as jtrain_state
from repro_torch import configs as port_configs
from repro_torch import distributed as tdist
from repro_torch import models as port_models
from repro_torch.configs.base import LM_SHAPES
from repro_torch.convert import params_from_numpy
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsharding
from repro_torch.launch import steps as tsteps
from repro_torch.models import moe as tmoe
from repro_torch.models import resnet as tresnet
from repro_torch.models.transformer import LMModel
from repro_torch.runtime.elastic import NamedSharding as TNamedSharding
from repro_torch.tree import tree_leaves
from repro_torch.training import train_state as ttrain_state

from _torch_lm import ARCH_NAMES, RTOL, close, one_torch_thread  # noqa: F401

MESHES = {"one pod": (False, (16, 16), ("data", "model")),
          "two pods": (True, (2, 16, 16), ("pod", "data", "model"))}


def _fake_mesh(shape, axes):
    devs = np.array(jax.devices() * int(np.prod(shape)))[: int(np.prod(shape))]
    return Mesh(devs.reshape(shape), axes)


def meshes(name):
    """(the reference's fake mesh, the port's abstract mesh) of ``name``."""
    multi_pod, shape, axes = MESHES[name]
    return (_fake_mesh(shape, axes),
            tmesh.make_production_mesh(multi_pod=multi_pod))


def norm(tree):
    """A spec, sharding or stand-in tree of either package as plain
    Python: dicts, tuples, a TrainState as a dict, each spec as a tuple,
    each sharding as its spec's tuple, each shape stand-in as (shape,
    dtype name)."""
    if isinstance(tree, (jtrain_state.TrainState, ttrain_state.TrainState)):
        return {"params": norm(tree.params),
                "opt_state": norm(tree.opt_state), "step": norm(tree.step)}
    if isinstance(tree, (JNamedSharding, TNamedSharding)):
        return ("sharding", norm(tree.spec))
    if isinstance(tree, (JP, tdist.PartitionSpec)):
        return ("spec",) + tuple(tree)
    if isinstance(tree, dict):
        return {k: norm(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(norm(v) for v in tree)
    if isinstance(tree, (jax.ShapeDtypeStruct, torch.Tensor)):
        return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))
    return tree


# ------------------------------------- tests/test_sharding.py, ported live
def test_spec_dedups_reused_axes():
    spec = {"a": "model", "b": "model", "c": ("pod", "data")}
    for axes in (("a", "b"), ("c", "a"), ("c", "c", "b"), (None, "a")):
        got = tdist.ShardingRules(spec).spec_for(axes)
        assert tuple(got) == tuple(jdist.ShardingRules(spec).spec_for(axes))
    assert tdist.ShardingRules(spec).spec_for(("a", "b")) == \
        tdist.PartitionSpec("model", None)
    assert tdist.ShardingRules(spec).spec_for(("c", "a")) == \
        tdist.PartitionSpec(("pod", "data"), "model")


def _rules(arch, shape, mesh_name="one pod"):
    jmesh, tm = meshes(mesh_name)
    return (jsharding.make_rules(jax_configs.get_arch(arch),
                                 jax_configs.get_shape(shape), jmesh),
            tsharding.make_rules(port_configs.get_arch(arch),
                                 port_configs.get_shape(shape), tm))


def test_rules_train_vs_serve():
    jtrain, train = _rules("yi-6b", "train_4k")
    jserve, serve = _rules("yi-6b", "decode_32k")
    assert dict(train) == dict(jtrain) and dict(serve) == dict(jserve)
    assert train["embed"] == "data"  # FSDP in training
    assert serve["embed"] is None  # replicated weights when serving
    assert serve["kv_seq"] == "model"  # sequence-sharded KV


def test_long_context_rules_shard_seq_everywhere():
    jrules, rules = _rules("jamba-v0.1-52b", "long_500k")
    assert dict(rules) == dict(jrules)
    assert rules["kv_seq"] == ("data", "model")
    assert rules["kv_batch"] is None


def test_seq_parallel_attention_for_non_divisible_heads():
    jm, tm = meshes("one pod")
    for name, divisible in (("gemma2-2b", False), ("yi-6b", True)):
        arch = port_configs.get_arch(name)
        assert tsharding.heads_divisible(arch, tm) is divisible
        assert jsharding.heads_divisible(jax_configs.get_arch(name),
                                         jm) is divisible
        jrules, rules = _rules(name, "train_4k")
        assert dict(rules) == dict(jrules)
        assert rules.get("attn_seq") == (None if divisible else "model")


def test_param_defs_roundtrip():
    defs = {"w": tdist.ParamDef((8, 16), ("embed", "ff")),
            "b": tdist.ParamDef((16,), ("ff",), init="zeros")}
    params = tdist.init_params(defs, torch.Generator().manual_seed(0))
    assert params["w"].shape == (8, 16)
    assert float(params["b"].abs().max()) == 0.0
    assert tdist.param_shapes(defs)["w"].shape == (8, 16)
    with tdist.use_rules(tdist.ShardingRules({"ff": "model"})):
        specs = tdist.param_specs(defs)
    assert specs["w"] == tdist.PartitionSpec(None, "model")
    with jdist.use_rules(jdist.ShardingRules({"ff": "model"})):
        jspecs = jdist.param_specs({
            "w": jdist.ParamDef((8, 16), ("embed", "ff")),
            "b": jdist.ParamDef((16,), ("ff",), init="zeros")})
    assert norm(specs) == norm(jspecs)
    stacked = tdist.stack_defs([defs, defs])
    assert stacked["w"].shape == (2, 8, 16)
    assert stacked["w"].logical == ("layers", "embed", "ff")


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_lm_model_param_shapes_and_specs(name):
    """``LMModel.param_shapes()`` and ``param_specs()`` at full width (meta
    tensors, nothing allocated): the reference's stand-ins leaf for leaf,
    shape and dtype, and its specs under the one-pod mesh's train rules."""
    jm, tm = meshes("one pod")
    jrules, rules = _rules(name, "train_4k")
    jmodel = jtransformer.LMModel(jax_configs.get_arch(name))
    model = LMModel(port_configs.get_arch(name), "cpu")
    shapes = model.param_shapes()
    assert {m.device.type for m in tree_leaves(shapes)} == {"meta"}
    assert norm(shapes) == norm(jmodel.param_shapes())
    with jdist.use_rules(jrules, jm):
        want = jmodel.param_specs()
    with tdist.use_rules(rules, tm):
        got = model.param_specs()
    assert norm(got) == norm(want)


def test_expert_fission_divisibility():
    jm, tm = meshes("one pod")
    rules = tsharding.make_rules(port_configs.get_arch("mixtral-8x7b"),
                                 port_configs.get_shape("train_4k"), tm)
    jrules = jsharding.make_rules(jax_configs.get_arch("mixtral-8x7b"),
                                  jax_configs.get_shape("train_4k"), jm)
    for name, r in (("mixtral-8x7b", 2), ("jamba-v0.1-52b", 1)):
        with tdist.use_rules(rules, tm):
            assert tmoe.expert_split_factor(port_configs.get_arch(name)) == r
        with jdist.use_rules(jrules, jm):
            assert jmoe.expert_split_factor(jax_configs.get_arch(name)) == r
    assert tmoe.expert_split_factor(
        port_configs.get_arch("mixtral-8x7b")) == 1  # no mesh, no fission


def test_moe_fission_numerically_exact():
    """r-way virtual experts == the unsplit experts (same routing): the
    port's MoE on the reference's weights, split as the reference's test
    splits them, against the reference's unsplit output."""
    jcfg = dataclasses.replace(
        jax_configs.get_arch("mixtral-8x7b").reduced(), capacity_factor=16.0)
    tcfg = dataclasses.replace(
        port_configs.get_arch("mixtral-8x7b").reduced(), capacity_factor=16.0)
    x = jax.random.normal(jax.random.PRNGKey(0), (2, 8, jcfg.d_model))
    params = jdist.init_params(jmoe.moe_defs(jcfg), jax.random.PRNGKey(1))
    y_ref, aux_ref = jmoe.moe_forward(params, x, jcfg)
    r = 2
    e, d, f = params["w_gate"].shape

    def split(w):  # [e, d, f] -> [e*r, d, f/r]
        return w.reshape(e, d, r, f // r).transpose(0, 2, 1, 3) \
            .reshape(e * r, d, f // r)

    params_v = {"router": params["router"], "w_gate": split(params["w_gate"]),
                "w_up": split(params["w_up"]),
                "w_down": params["w_down"].reshape(e * r, f // r, d)}
    xt = torch.from_numpy(np.array(x))
    for tree in (params, params_v):
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                               "cpu")
        y, aux = tmoe.moe_forward(tp, xt, tcfg)
        close(y, np.asarray(y_ref), 2e-4, "moe fission")
        close(aux, np.asarray(aux_ref), RTOL, "aux")


# -------------------------------- every arch x shape x production mesh
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch_name", ARCH_NAMES)
def test_spec_trees_match_reference(arch_name, mesh_name):
    """Param, cache, input and train-state specs, each bundle's shardings
    and stand-ins, and ``expert_split_factor`` equal the reference's for
    every LM shape (train, prefill, two decodes) on the mesh."""
    jm, tm = meshes(mesh_name)
    jarch, arch = jax_configs.get_arch(arch_name), \
        port_configs.get_arch(arch_name)
    for shape in LM_SHAPES:
        jshape = jax_configs.get_shape(shape.name)
        jrules = jsharding.make_rules(jarch, jshape, jm)
        rules = tsharding.make_rules(arch, shape, tm)
        assert dict(rules) == dict(jrules), shape.name
        jmodel, model = jtransformer.LMModel(jarch), LMModel(arch, "meta")
        with jdist.use_rules(jrules, jm):
            jdefs = jmodel.param_defs()
            want = {
                "params": jdist.param_specs(jdefs),
                "caches": jdist.param_specs(jmodel.cache_defs(
                    shape.global_batch, shape.seq_len)),
                "inputs": jsteps.input_specs(jarch, jshape, jrules),
                "state": jtrain_state.train_state_specs(jdefs),
                "state_sgd": jtrain_state.train_state_specs_sgd(jdefs),
                "split": jmoe.expert_split_factor(jarch)}
        with tdist.use_rules(rules, tm):
            defs = model.param_defs()
            got = {
                "params": tdist.param_specs(defs),
                "caches": tdist.param_specs(model.cache_defs(
                    shape.global_batch, shape.seq_len)),
                "inputs": tsteps.input_specs(arch, shape, rules),
                "state": ttrain_state.train_state_specs(defs),
                "state_sgd": ttrain_state.train_state_specs_sgd(defs),
                "split": tmoe.expert_split_factor(arch)}
        for key in want:
            assert norm(got[key]) == norm(want[key]), (shape.name, key)
        jb = jsteps.build_bundle(jarch, jshape, jm, jrules)
        tb = tsteps.build_bundle(arch, shape, tm, rules)
        for field in ("in_shardings", "out_shardings", "abstract_args",
                      "donate_argnums"):
            assert norm(getattr(tb, field)) == norm(getattr(jb, field)), (
                shape.name, field)


# ------------------------------------------------------- the models API
def test_models_exports_and_helpers():
    import repro.models as jmodels

    for name in ("LMModel", "init_cache_defs", "make_model"):
        assert hasattr(port_models, name) and hasattr(jmodels, name)
    assert port_models.LMModel is LMModel
    for name in ("gemma2-2b", "jamba-v0.1-52b", "xlstm-125m"):
        got = port_models.init_cache_defs(port_configs.get_arch(name), 2, 64)
        want = jtransformer.init_cache_defs(jax_configs.get_arch(name), 2, 64)
        assert norm(tdist.param_shapes(got)) == norm(jdist.param_shapes(want))
        assert [d.logical for d in jax.tree_util.tree_leaves(
            want, is_leaf=jdist.is_param_def)] == [
            d.logical for d in jax.tree_util.tree_leaves(
                got, is_leaf=tdist.is_param_def)]
    cfg = port_configs.dacapo_pairs.RESNET18.reduced()
    jcfg = jax_configs.dacapo_pairs.RESNET18.reduced()
    jp = jresnet.init_resnet(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    assert tresnet.resnet_param_count(tp) == jresnet.resnet_param_count(jp)
    assert tresnet.resnet_param_count(tresnet.init_resnet(
        torch.Generator().manual_seed(0), cfg, "cpu")) == \
        jresnet.resnet_param_count(jp)
