"""The port's LM example drivers, ``examples/serve_lm_torch.py`` and
``examples/train_lm_torch.py`` (the reference's ``serve_lm.py`` /
``train_lm.py`` on ``repro_torch``), run small on the CPU: the serve
example at its defaults (reduced mixtral-8x7b) as a script, exiting 0
and printing its numbers; the train example at reduced xlstm-125m for 3
steps; both raising without a card when no ``--device`` is given; and
the ``--device`` flag kept apart from the defaults it does not replace;
and both drivers on the four MoE, Mamba and xLSTM configs, the train
step's metrics carrying the MoE ``aux``."""
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_lm import MIXER_ARCHS, one_torch_thread  # noqa: F401
from repro_torch.configs import get_arch
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch import serve as serve_lib
from repro_torch.launch import train as train_lib
from repro_torch.models.registry import make_lm_model
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_state import TrainState

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))

import serve_lm_torch  # noqa: E402
import train_lm_torch  # noqa: E402


def test_serve_example_runs_at_its_defaults_on_cpu():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "serve_lm_torch.py"),
         "--device", "cpu"], capture_output=True, text=True, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"}, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "prefill: 4x32 in" in proc.stdout
    assert "decode:  15 steps x 4 seqs" in proc.stdout
    assert "tok/s" in proc.stdout


def test_train_example_runs_on_cpu(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    out = train_lm_torch.main(["--reduced", "--steps", "3", "--device",
                               "cpu"])
    assert out == 0
    text = capsys.readouterr().out
    losses = [float(line.split()[3]) for line in text.splitlines()
              if line.startswith("step")]
    assert len(losses) == 2 and np.isfinite(losses).all()  # steps 0, 2
    assert "done:" in text and "tok/s" in text


def test_split_device_keeps_the_defaults():
    split = serve_lm_torch.split_device
    assert split(["--device", "cpu"]) == ([], ["--device", "cpu"])
    assert split(["--reduced", "--device=cpu", "--steps", "3"]) == (
        ["--reduced", "--steps", "3"], ["--device=cpu"])


def test_examples_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        serve_lm_torch.main([])
    with pytest.raises(RuntimeError, match="cuda"):
        train_lm_torch.main(["--reduced", "--steps", "1"])


@pytest.mark.parametrize("name", MIXER_ARCHS)
def test_serve_and_train_run_the_mixer_configs(name, capsys):
    """The serve driver at each reduced config (4 tokens of prompt, 3
    generated), and one train-driver step whose metrics carry the loss's
    ``aux``: positive with MoE layers, 0 without."""
    out = serve_lib.serve(["--arch", name, "--reduced", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "4", "--gen",
                           "3"])
    assert out["tokens"].shape == (2, 3)
    assert "prefill: 2x4" in capsys.readouterr().out
    cfg = get_arch(name).reduced()
    model = make_lm_model(cfg, "cpu")
    opt = OptimizerConfig(name="adamw", lr=1e-3, warmup_steps=0,
                          total_steps=2)
    state = TrainState.create(model.init(torch.Generator().manual_seed(0)),
                              opt)
    data = {k: torch.from_numpy(v) for k, v in TokenPipeline(
        cfg.vocab_size, 16, 2, seed=0).batch(0).items()}
    state, metrics = train_lib.train_step(model, state, data, opt)
    loss, aux = float(metrics["loss"]), float(metrics["aux"])
    assert np.isfinite(loss) and state.step == 1
    assert (aux > 0) == bool(cfg.num_experts)
    assert loss == pytest.approx(float(metrics["nll"]) + aux, rel=1e-6)
