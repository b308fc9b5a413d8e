"""Train xlstm-125m, the full assigned config, for a few hundred steps on
one card with the port's training substrate: AdamW in place, the token
pipeline, checkpoints, heartbeat and straggler detection
(``examples/train_lm.py`` on ``repro_torch``).

Run:  PYTHONPATH=src python examples/train_lm_torch.py     (full xlstm-125m)
      PYTHONPATH=src python examples/train_lm_torch.py --reduced --steps 50

With no flags but ``--device`` it runs the reference example's defaults
(300 steps of 8 x 128 tokens, lr 3e-3); any other flag replaces those
defaults, as in the reference example (``repro_torch.launch.train``'s
flags). The device defaults to ``cuda`` and the run raises without a card.
"""
import sys

from repro_torch.launch.train import train
from serve_lm_torch import split_device

DEFAULT_ARGV = ["--arch", "xlstm-125m", "--steps", "300", "--batch", "8",
                "--seq", "128", "--lr", "3e-3", "--log-every", "20",
                "--checkpoint-every", "100"]


def run(argv=None) -> dict:
    """Run the example on ``argv`` (default: the command line); returns
    ``repro_torch.launch.train.train``'s numbers."""
    rest, device = split_device(sys.argv[1:] if argv is None else argv)
    return train((rest or DEFAULT_ARGV) + device)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
