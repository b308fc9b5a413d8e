"""The port's models: the vision models of the CL pairs (ResNet /
WideResNet, ViT) over parameter dicts, and the decoder LMs
(``transformer.py``), whose handles are exported here as in the JAX
package's ``models/__init__.py``."""
from repro_torch.models.transformer import (  # noqa: F401
    LMModel,
    init_cache_defs,
    make_model,
)
