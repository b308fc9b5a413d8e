"""The port's public surface held to the JAX package's, module by module.

For each module of ``src/repro/`` (one case each), read from source with
``ast`` and never imported — ``launch/dryrun.py`` sets ``XLA_FLAGS`` when
it is imported, which would change the device count of every later JAX
test on the same worker — the port's module at the same path under
``repro_torch`` is imported and must have:

* every public top-level ``def``, ``class`` and assignment, and every name
  a package ``__init__`` (or an ``__all__``) exports;
* every public method, property, class attribute and dataclass field of
  each reference class;
* every parameter of each public function, method and constructor, with
  the positional parameters at the reference's positions (so a positional
  call the reference accepts binds the same way); and no required
  parameter the reference's signature lacks.

``SUBSTITUTES`` records each deliberate difference: its key names the
reference's side (``module``, ``module:name`` or ``module:name(param)``),
its value the port's counterpart as a dotted path — resolved by the test,
with ``(param)`` naming a parameter of the resolved callable, which then
stands in for the reference's in the order checks — or ``None`` for a
TPU-only constant, and one line of reason. An entry that no longer
matches a difference fails the test, as does a counterpart that no longer
resolves.
"""
import ast
import dataclasses
import importlib
import inspect
import warnings
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = "repro_torch"

_TILE = "a Pallas block size; the CUDA kernels plan their own tiles"
_KEY = "random init draws from a torch.Generator instead of a JAX key"
_RING = ("the port's ring cache keeps the filled prefix [0, min(t + 1, L)) "
         "and is sized by its defs, so no slot positions, window or "
         "capacity travel with a call")
_HLO = "torch has no XLA HLO text: the port counts a traced step instead"

SUBSTITUTES = {
    # kernels: the Pallas entries and their TPU tiling
    "kernels/mx_quantize.py:mx_quantize": (
        "repro_torch.kernels.mx_quantize.mx_quantize_cuda",
        "the Pallas entry is the sm_90a kernel's wrapper"),
    "kernels/mx_quantize.py:DEFAULT_BM": (None, _TILE),
    "kernels/mx_quantize.py:DEFAULT_BK": (None, _TILE),
    "kernels/mx_matmul.py:mx_matmul": (
        "repro_torch.kernels.mx_matmul.mx_matmul_cuda",
        "the Pallas entry is the sm_90a kernel's wrapper"),
    "kernels/mx_matmul.py:DEFAULT_BM": (None, _TILE),
    "kernels/mx_matmul.py:DEFAULT_BN": (None, _TILE),
    "kernels/mx_matmul.py:DEFAULT_BK": (None, _TILE),
    "kernels/mx_matmul.py:SUBBLOCK_SAFE": (
        None, "the Pallas kernel's uint8 sub-block unpacking factor"),
    "kernels/mx_fused.py:mx_matmul_fused": (
        "repro_torch.kernels.mx_fused.mx_matmul_fused_cuda",
        "the Pallas entry is the sm_90a kernel's wrapper"),
    "kernels/mx_fused.py:mx_matmul_bwd_pair": (
        "repro_torch.kernels.mx_fused.mx_matmul_bwd_pair_cuda",
        "the Pallas entry is the sm_90a kernels' wrapper"),
    "kernels/mx_fused.py:mx_matmul_prequant": (
        "repro_torch.kernels.mx_fused.mx_matmul_prequant_cuda",
        "the Pallas entry is the sm_90a kernel's wrapper"),
    "kernels/mx_fused.py:DEFAULT_BM": (None, _TILE),
    "kernels/mx_fused.py:DEFAULT_BN": (None, _TILE),
    "kernels/mx_fused.py:DEFAULT_BK": (None, _TILE),
    "kernels/flash_attention.py:flash_attention": (
        "repro_torch.kernels.flash_attention.flash_attention_cuda",
        "the Pallas entry is the sm_90a kernel's wrapper"),
    "kernels/flash_attention.py:DEFAULT_QB": (None, _TILE),
    "kernels/flash_attention.py:DEFAULT_KVB": (None, _TILE),
    "kernels/flash_attention.py:NEG_INF": (
        "repro_torch.kernels.ref.NEG_INF",
        "the mask value lives beside the plain attention"),
    "kernels/ops.py:kernel_mode": (
        "repro_torch.kernels.ops.kernel_stats",
        "the path follows the tensor's device, never a setting; "
        "kernel_stats() says which path served each call"),
    "kernels/ops.py:ROW_ALIGN": (None, "TPU (8, 128) tile padding"),
    "kernels/ops.py:LANE_ALIGN": (None, "TPU (8, 128) tile padding"),
    # models: the jnp attention and the ring cache
    "models/attention.py:flash_attention": (
        "repro_torch.kernels.ops.flash_attention",
        "the jnp blocked attention is the kernel's entry in the port"),
    "models/attention.py:NEG_INF": (
        "repro_torch.kernels.ref.NEG_INF",
        "the mask value lives beside the plain attention"),
    "models/attention.py:flash_decode(kv_pos)": (
        "repro_torch.models.attention.ring_positions", _RING),
    "models/attention.py:flash_decode(window)": (
        "repro_torch.models.attention.ring_capacity", _RING),
    "models/attention.py:flash_decode(axis_names)": (
        "repro_torch.models.attention.sharded_flash_decode",
        "a sharded ring's cross-shard combine is sharded_flash_decode's"),
    "models/attention.py:sharded_flash_decode(kv_pos)": (
        "repro_torch.models.attention.ring_positions", _RING),
    "models/attention.py:sharded_flash_decode(window)": (
        "repro_torch.models.attention.ring_capacity", _RING),
    "models/attention.py:attention_forward(cache_capacity)": (
        "repro_torch.models.attention.attn_cache_defs", _RING),
    "models/attention.py:prefill_cache(capacity)": (
        "repro_torch.models.attention.prefill_cache(out)",
        "the cache is filled in place, sized by attn_cache_defs"),
    # random init: a generator for a key
    "distributed.py:init_params(key)": (
        "repro_torch.distributed.init_params(gen)", _KEY),
    "distributed.py:ParamDef.initialize(key)": (
        "repro_torch.distributed.ParamDef.initialize(gen)", _KEY),
    "models/transformer.py:LMModel.init(key)": (
        "repro_torch.models.transformer.LMModel.init(gen)", _KEY),
    "models/registry.py:VisionModel.init(key)": (
        "repro_torch.models.registry.VisionModel.init(gen)", _KEY),
    "models/resnet.py:init_resnet(key)": (
        "repro_torch.models.resnet.init_resnet(gen)", _KEY),
    "models/vit.py:init_vit(key)": (
        "repro_torch.models.vit.init_vit(gen)", _KEY),
    "models/registry.py:VisionModel(device)": (
        "repro_torch.models.registry.make_vision_model(device)",
        "a vision model is placed on a device (cuda unless asked)"),
    "distributed.py:ParamDef.shape_struct": (
        "repro_torch.distributed.ParamDef.meta",
        "a meta tensor stands in for jax.ShapeDtypeStruct"),
    # the manager's emulated pacing
    "core/manager.py:ManagerSpec.shard_pace": (
        "repro_torch.core.manager.ManagerSpec.parallel_shards",
        "shards step concurrently on the card instead of sleeping "
        "through modeled device time"),
    "core/manager.py:FleetManager(shard_pace)": (
        "repro_torch.core.manager.FleetManager(parallel_shards)",
        "shards step concurrently on the card instead of sleeping "
        "through modeled device time"),
    # the dry run: XLA HLO text becomes a traced step's counts
    "launch/hlo_analysis.py": ("repro_torch.launch.counting", _HLO),
    "launch/roofline.py:parse_collectives": (
        "repro_torch.launch.roofline.collective_stats", _HLO),
    "launch/roofline.py:COLLECTIVE_KINDS": (
        "repro_torch.launch.counting.COLLECTIVE_KINDS", _HLO),
    "launch/roofline.py:analyze(compiled)": (
        "repro_torch.launch.roofline.analyze(traced)", _HLO),
    "launch/roofline.py:analyze(hlo_text)": (
        "repro_torch.launch.steps.trace_bundle", _HLO),
    "launch/steps.py:lower_bundle": (
        "repro_torch.launch.steps.trace_bundle", _HLO),
    "launch/dryrun.py:run_cell(dump_hlo)": (
        "repro_torch.launch.steps.trace_bundle", _HLO),
}

REF_FILES = sorted(
    str(p.relative_to(REF)) for p in REF.rglob("*.py")
    if "__pycache__" not in p.parts and p.name != "__main__.py")
_CTOR_SKIP = ("__init__", "__post_init__", "__new__", "__init_subclass__")


def _file_of(key: str) -> str:
    return key.split(":", 1)[0]


def _port_name(rel: str) -> str:
    parts = rel[:-len(".py")].split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join([PORT] + parts)


def _import(name: str):
    with warnings.catch_warnings():  # core/scheduler.py is a deprecated shim
        warnings.simplefilter("ignore", DeprecationWarning)
        return importlib.import_module(name)


def _resolve(path: str):
    """A dotted path -> its object, ``(param)`` checked on the callable."""
    param = None
    if path.endswith(")"):
        path, param = path[:-1].split("(")
    parts = path.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = _import(".".join(parts[:i]))
        except ModuleNotFoundError:
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        break
    if param is not None:
        assert param in inspect.signature(obj).parameters, (path, param)
    return obj


def _renames(rel: str, qual: str):
    """The reference's parameters of ``qual`` that SUBSTITUTES maps: a
    name -> the port's parameter, or -> None (it has none)."""
    out = {}
    for key, (counterpart, _) in SUBSTITUTES.items():
        if key.startswith(f"{rel}:{qual}(") and key.endswith(")"):
            new = None
            if counterpart and counterpart.endswith(")"):
                new = counterpart[:-1].split("(")[1]
            out[key[:-1].split("(")[1]] = new
    return out


class _Diff:
    """The differences of one reference module from its port."""

    def __init__(self, rel: str):
        self.rel = rel
        self.keys = set()

    def add(self, what: str):
        self.keys.add(f"{self.rel}:{what}")

    def params(self, qual: str, ref_pos, ref_kwo, port_sig, drop_self):
        """Hold one callable's port signature to the reference's positional
        (``ref_pos``) and keyword-only (``ref_kwo``) parameter names."""
        renames = _renames(self.rel, qual)
        ps = list(port_sig.parameters.values())
        if drop_self and ps and ps[0].name in ("self", "cls"):
            ps = ps[1:]
        port_pos = [p.name for p in ps
                    if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
        port_all = {p.name for p in ps
                    if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)}
        for name in ref_pos + ref_kwo:
            if name not in port_all:
                self.add(f"{qual}({name})")
        shared = [(n, renames.get(n, n)) for n in ref_pos
                  if renames.get(n, n) is not None]
        for i, (name, port_name) in enumerate(shared):
            if i >= len(port_pos) or port_pos[i] != port_name:
                self.add(f"{qual}({name})")
        known = {port_name for _, port_name in shared} | {
            renames.get(n, n) for n in ref_kwo}
        for p in ps:
            if (p.default is p.empty and p.name not in known
                    and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)):
                self.add(f"{qual}({p.name})")


def _ref_args(fn: ast.FunctionDef, drop_self: bool):
    pos = [a.arg for a in fn.args.posonlyargs + fn.args.args]
    if drop_self:
        pos = pos[1:]
    return pos, [a.arg for a in fn.args.kwonlyargs]


def _decorators(node) -> set:
    return {ast.unparse(d).split("(")[0] for d in node.decorator_list}


def _members(cls) -> set:
    names = set(dir(cls))
    for klass in inspect.getmro(cls):
        names |= set(vars(klass).get("__annotations__", {}))
    return names


def _top_level(body):
    """Module statements, through ``if`` / ``try`` but not a ``__main__``
    block."""
    for st in body:
        if isinstance(st, ast.If):
            if "__name__" not in ast.unparse(st.test):
                yield from _top_level(st.body)
                yield from _top_level(st.orelse)
        elif isinstance(st, ast.Try):
            yield from _top_level(st.body)
            for handler in st.handlers:
                yield from _top_level(handler.body)
        else:
            yield st


def _assigned(st):
    targets = st.targets if isinstance(st, ast.Assign) else [st.target]
    for t in targets:
        for node in (t.elts if isinstance(t, ast.Tuple) else [t]):
            if isinstance(node, ast.Name):
                yield node.id


def _check_class(diff: _Diff, node: ast.ClassDef, cls):
    members = _members(cls)
    fields = []
    for st in node.body:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            name = st.name
            dunder = name.startswith("__") and name.endswith("__")
            if name in _CTOR_SKIP or (name.startswith("_") and not dunder):
                continue
            if name not in members:
                diff.add(f"{node.name}.{name}")
                continue
            decs = _decorators(st)
            raw = inspect.getattr_static(cls, name)
            if (dunder or isinstance(raw, property)
                    or decs & {"property", "functools.cached_property",
                               "cached_property"}
                    or any(d.endswith((".setter", ".deleter"))
                           for d in decs)):
                continue
            static = "staticmethod" in decs
            if isinstance(raw, (staticmethod, classmethod)):
                raw = raw.__func__
            pos, kwo = _ref_args(st, drop_self=not static)
            diff.params(f"{node.name}.{name}", pos, kwo,
                        inspect.signature(raw), drop_self=not static)
        elif isinstance(st, ast.AnnAssign) and isinstance(st.target,
                                                          ast.Name):
            if "ClassVar" in ast.unparse(st.annotation):
                continue
            fields.append(st.target.id)
            if not st.target.id.startswith("_") \
                    and st.target.id not in members:
                diff.add(f"{node.name}.{st.target.id}")
        elif isinstance(st, ast.Assign):
            for name in _assigned(st):
                if not name.startswith("_") and name not in members:
                    diff.add(f"{node.name}.{name}")
        elif isinstance(st, ast.ClassDef) and not st.name.startswith("_"):
            if st.name not in members:
                diff.add(f"{node.name}.{st.name}")
    # The constructor: a dataclass's own fields, or an explicit __init__.
    init = next((st for st in node.body if isinstance(st, ast.FunctionDef)
                 and st.name == "__init__"), None)
    if init is not None:
        pos, kwo = _ref_args(init, drop_self=True)
        diff.params(node.name, pos, kwo, inspect.signature(cls),
                    drop_self=False)
    elif any("dataclass" in d for d in _decorators(node)) \
            and dataclasses.is_dataclass(cls):
        own = set(vars(cls).get("__annotations__", {}))
        params = inspect.signature(cls).parameters.values()
        shared = [p.name for p in params if p.name in fields]
        if shared != [n for n in fields if n in shared]:
            diff.add(f"{node.name}({shared[0]})")
        for p in params:
            if (p.name in own and p.name not in fields
                    and p.default is p.empty):
                diff.add(f"{node.name}({p.name})")


def differences(rel: str):
    """The set of difference keys of reference module ``rel``."""
    diff = _Diff(rel)
    try:
        mod = _import(_port_name(rel))
    except ModuleNotFoundError:
        return {rel}
    tree = ast.parse((REF / rel).read_text(), filename=rel)
    is_init = rel.endswith("__init__.py")
    for st in _top_level(tree.body):
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            if st.name.startswith("_"):
                continue
            if not hasattr(mod, st.name):
                diff.add(st.name)
            elif isinstance(st, ast.ClassDef):
                _check_class(diff, st, getattr(mod, st.name))
            else:
                pos, kwo = _ref_args(st, drop_self=False)
                diff.params(st.name, pos, kwo,
                            inspect.signature(getattr(mod, st.name)),
                            drop_self=False)
        elif isinstance(st, (ast.Assign, ast.AnnAssign)):
            for name in _assigned(st):
                if name == "__all__":
                    names = [e.value for e in st.value.elts]
                elif not name.startswith("_"):
                    names = [name]
                else:
                    names = []
                for n in names:
                    if not hasattr(mod, n):
                        diff.add(n)
        elif is_init and isinstance(st, (ast.Import, ast.ImportFrom)):
            for alias in st.names:
                name = alias.asname or alias.name.split(".")[0]
                if not name.startswith("_") and not hasattr(mod, name):
                    diff.add(name)
    return diff.keys


def test_reference_has_seventy_modules():
    assert len(REF_FILES) == 70


@pytest.mark.parametrize("rel", REF_FILES)
def test_module_matches_reference(rel):
    found = differences(rel)
    recorded = {k for k in SUBSTITUTES if _file_of(k) == rel}
    assert not found - recorded, (
        f"the port differs from src/repro/{rel} beyond SUBSTITUTES: "
        f"{sorted(found - recorded)}")
    assert not recorded - found, (
        f"SUBSTITUTES entries that no longer match a difference: "
        f"{sorted(recorded - found)}")
    for key in sorted(recorded):
        counterpart, reason = SUBSTITUTES[key]
        assert reason, key
        if counterpart is not None:
            _resolve(counterpart)


def test_substitutes_name_reference_modules():
    assert {_file_of(k) for k in SUBSTITUTES} <= set(REF_FILES)
