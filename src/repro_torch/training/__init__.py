"""Optimizers, train state and gradient machinery of the LM side (the JAX
package's ``training/``)."""
from repro_torch.training.optimizer import (  # noqa: F401
    OptimizerConfig,
    apply_updates,
    init_opt_state,
)
from repro_torch.training.train_state import TrainState  # noqa: F401
