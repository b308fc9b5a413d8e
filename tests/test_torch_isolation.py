"""The port stands alone: ``src/repro_torch``, ``chip_smoke.py``,
``attention_mutants.py``, ``gemm_ablation.py``, ``pair_per_gemm.py``,
``examples/continuous_learning_drive_torch.py``,
``examples/fleet_drive_torch.py``, ``examples/serve_lm_torch.py``,
``examples/train_lm_torch.py`` and ``examples/quickstart_torch.py``
import neither ``jax`` nor the JAX package, and its entry points default
to the card and refuse to run without one."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "attention_mutants.py",
    ROOT / "gemm_ablation.py", ROOT / "pair_per_gemm.py",
    ROOT / "mesh_overhead.py",
    ROOT / "examples" / "continuous_learning_drive_torch.py",
    ROOT / "examples" / "fleet_drive_torch.py",
    ROOT / "examples" / "serve_lm_torch.py",
    ROOT / "examples" / "train_lm_torch.py",
    ROOT / "examples" / "quickstart_torch.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_session_import_pulls_in_no_jax():
    code = ("import sys; import repro_torch.core, chip_smoke; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); assert not bad")
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=ROOT, env={"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}",
                       "PATH": "/usr/bin:/bin"}, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_drive_example_pulls_in_no_jax():
    """The ported drive example, imported and its body's imports run, loads
    no module of JAX or of the JAX package."""
    code = ("import sys, continuous_learning_drive_torch as d; "
            "import repro_torch.core, repro_torch.core.partition, "
            "repro_torch.data.stream, repro_torch.models.registry; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); assert not bad")
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=ROOT, env={"PYTHONPATH": f"{ROOT / 'src'}:{ROOT / 'examples'}",
                       "PATH": "/usr/bin:/bin"}, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_fleet_drive_example_pulls_in_no_jax():
    """The ported fleet driver and the manager tier it runs (checkpoints,
    fault injection, elastic re-homing) load nothing of JAX."""
    code = ("import sys, fleet_drive_torch; "
            "import repro_torch.core.manager, repro_torch.checkpoint, "
            "repro_torch.runtime.fault, repro_torch.runtime.elastic; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); assert not bad")
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=ROOT, env={"PYTHONPATH": f"{ROOT / 'src'}:{ROOT / 'examples'}",
                       "PATH": "/usr/bin:/bin"}, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _require_no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")


def test_default_device_raises_without_a_card():
    _require_no_card()
    from repro_torch.configs.dacapo_pairs import RESNET18, WIDERESNET50
    from repro_torch.core.session import CLSystemSpec
    from repro_torch.models.registry import make_vision_model

    with pytest.raises(RuntimeError, match="cuda"):
        CLSystemSpec(student=RESNET18, teacher=WIDERESNET50).build()
    with pytest.raises(RuntimeError, match="cuda"):
        make_vision_model(RESNET18.reduced())


def test_fleet_default_device_raises_without_a_card():
    """``FleetSpec(...).build()`` runs on the card by default, and on the
    CPU only when asked; ``rehome_tree`` lands state on the card too."""
    _require_no_card()
    import numpy as np

    from repro_torch.configs.dacapo_pairs import RESNET18, WIDERESNET50
    from repro_torch.core.fleet import FleetSpec
    from repro_torch.runtime import rehome_tree

    with pytest.raises(RuntimeError, match="cuda"):
        FleetSpec(student=RESNET18, teacher=WIDERESNET50).build()
    with pytest.raises(RuntimeError, match="cuda"):
        rehome_tree({"w": np.zeros(2, np.float32)})
    fleet = FleetSpec(student=RESNET18, teacher=WIDERESNET50,
                      device="cpu").build()
    assert fleet.device == torch.device("cpu")


def test_manager_default_device_raises_without_a_card():
    """``ManagerSpec(...).build()`` and ``FleetManager(...)`` build their
    shards on the card by default, and on the CPU only when the fleet
    spec asks."""
    _require_no_card()
    from repro_torch.configs.dacapo_pairs import RESNET18, WIDERESNET50
    from repro_torch.core.fleet import FleetSpec
    from repro_torch.core.manager import FleetManager, ManagerSpec

    fleet = FleetSpec(student=RESNET18, teacher=WIDERESNET50)
    with pytest.raises(RuntimeError, match="cuda"):
        ManagerSpec(fleet=fleet, n_shards=2).build()
    with pytest.raises(RuntimeError, match="cuda"):
        FleetManager(fleet, n_shards=2)
    cpu = FleetSpec(student=RESNET18, teacher=WIDERESNET50, device="cpu")
    mgr = ManagerSpec(fleet=cpu, n_shards=2).build()
    assert [s.session.device for s in mgr.shards] == [torch.device("cpu")] * 2
    assert FleetManager(cpu, n_shards=1).shards[0].session.device == \
        torch.device("cpu")


def test_lm_side_pulls_in_no_jax():
    """The LM side (configs, models with the MoE, Mamba and xLSTM layers,
    training, the token pipeline, both drivers and their example wrappers)
    loads nothing of JAX."""
    code = ("import sys; import repro_torch.configs, "
            "repro_torch.models.registry, repro_torch.models.transformer, "
            "repro_torch.models.moe, repro_torch.models.ssm, "
            "repro_torch.models.xlstm, serve_lm_torch, train_lm_torch, "
            "repro_torch.training.grad, repro_torch.training.train_state, "
            "repro_torch.data.tokens, repro_torch.launch.serve, "
            "repro_torch.launch.train; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); assert not bad")
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=ROOT, env={"PYTHONPATH": f"{ROOT / 'src'}:{ROOT / 'examples'}",
                       "PATH": "/usr/bin:/bin"}, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_lm_default_device_raises_without_a_card():
    """``LMModel``, ``make_lm_model`` and both LM drivers run on the card
    unless the caller asks for the CPU."""
    _require_no_card()
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve, train
    from repro_torch.models.registry import make_lm_model
    from repro_torch.models.transformer import LMModel

    cfg = get_arch("gemma2-2b").reduced()
    with pytest.raises(RuntimeError, match="cuda"):
        LMModel(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        make_lm_model(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.serve(["--arch", "gemma2-2b", "--reduced"])
    with pytest.raises(RuntimeError, match="cuda"):
        train.train(["--arch", "gemma2-2b", "--reduced", "--steps", "1"])
    assert make_lm_model(cfg, "cpu").device == torch.device("cpu")
    assert LMModel(cfg, "cpu").device == torch.device("cpu")


def test_chip_smoke_refuses_without_a_card():
    _require_no_card()
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, cwd=ROOT,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_fp32_precision_is_pinned():
    from repro_torch.device import resolve_device

    torch.backends.cudnn.allow_tf32 = True
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_cudnn_is_pinned_deterministic():
    """resolve_device sets deterministic cuDNN without benchmarking for
    every device it returns, whatever the process had set before."""
    from repro_torch.device import resolve_device

    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    try:
        assert resolve_device("cpu") == torch.device("cpu")
        assert torch.backends.cudnn.deterministic is True
        assert torch.backends.cudnn.benchmark is False
    finally:
        resolve_device("cpu")
