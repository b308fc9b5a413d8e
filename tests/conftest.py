import os

# Smoke tests and benches see the single real CPU device; ONLY the dry-run
# launcher sets xla_force_host_platform_device_count (see launch/dryrun.py).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

jax.config.update("jax_default_matmul_precision", "float32")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the hand-written kernels); "
        "skips without one")
