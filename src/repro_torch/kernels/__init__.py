"""The port's kernels.

  csrc/mx_quantize.cu — hand-written Hopper (sm_90a) MX quantize and
    dequantize kernels (replacing the Pallas ``_quantize_kernel``)
  csrc/mx_gemm.cu — the four MX GEMMs (replacing the Pallas
    ``mx_matmul``, ``mx_matmul_fused``, ``mx_matmul_bwd_pair`` and
    ``mx_matmul_prequant``), on the block arithmetic of ``mx_common.cuh``
  csrc/flash_attention.cu — forward flash attention (replacing the
    Pallas ``flash_attention``)
  mx_quantize.py — the build (nvcc at first use), ctypes binding, the
    quantize wrappers and the launch counters of every kernel
  mx_matmul.py, mx_fused.py, flash_attention.py — the other wrappers
  ref.py — the plain PyTorch versions the kernels are held to
  ops.py — the public entries: the tensor's device picks the path
    ("cuda" kernel or "plain"), ``kernel_stats()`` records it
"""
