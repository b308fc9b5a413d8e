"""The port's kernels.

  csrc/mx_quantize.cu — hand-written Hopper (sm_90a) MX quantize and
    dequantize kernels (replacing the Pallas ``_quantize_kernel``)
  mx_quantize.py — their build (nvcc at first use), ctypes binding,
    wrappers and launch counters
  ref.py — the plain PyTorch versions the kernels are held to
  ops.py — the public entries: the tensor's device picks the path
    ("cuda" kernel or "plain"), ``kernel_stats()`` records it
"""
