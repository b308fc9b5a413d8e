"""The port stands alone: ``src/repro_torch``, ``chip_smoke.py``,
``attention_mutants.py``, ``gemm_ablation.py``, ``pair_per_gemm.py`` and
``examples/continuous_learning_drive_torch.py`` import neither ``jax`` nor
the JAX package, and its entry points default to the card and refuse to
run without one."""
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
    ROOT / "examples" / "continuous_learning_drive_torch.py"]
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
