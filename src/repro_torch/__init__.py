"""PyTorch/CUDA port of the DaCapo reproduction (the JAX package ``repro``
is the reference).

The port mirrors ``repro``'s layout and names; its MX quantize/dequantize
kernels are hand-written CUDA for Hopper (``kernels/csrc``). Entry points
run on ``cuda`` unless the caller passes ``device="cpu"`` (see
:mod:`repro_torch.device`). The package imports torch, numpy and the
standard library only — never ``jax`` and nothing of ``repro``.
"""
