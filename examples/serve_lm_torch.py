"""Serve a small LM with batched requests on the PyTorch port: prefill,
then batched greedy decode against ring-buffer / recurrent-state caches
(``examples/serve_lm.py`` on ``repro_torch``).

Run:  PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]

With no flags but ``--device`` it serves the reference example's default,
reduced mixtral-8x7b (batch 4, a 32-token prompt, 16 tokens); any other
flag replaces those defaults, as in the reference example
(``repro_torch.launch.serve``'s flags). The device defaults to ``cuda``
and the run raises without a card.
"""
import sys

from repro_torch.launch.serve import serve

DEFAULT_ARGV = ["--arch", "mixtral-8x7b", "--reduced", "--batch", "4",
                "--prompt-len", "32", "--gen", "16"]


def split_device(argv):
    """(argv without ``--device X`` / ``--device=X``, those flags)."""
    rest, device, it = [], [], iter(argv)
    for arg in it:
        if arg == "--device":
            device += [arg, next(it)]
        elif arg.startswith("--device="):
            device.append(arg)
        else:
            rest.append(arg)
    return rest, device


def run(argv=None) -> dict:
    """Run the example on ``argv`` (default: the command line); returns
    ``repro_torch.launch.serve.serve``'s numbers."""
    rest, device = split_device(sys.argv[1:] if argv is None else argv)
    return serve((rest or DEFAULT_ARGV) + device)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
