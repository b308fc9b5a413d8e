"""Train state container (the JAX package's ``training/train_state.py``).
The sharding-spec derivations (``train_state_specs`` and its SGD twin) need
a mesh's rules and are ROADMAP item 10c."""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.training.optimizer import OptimizerConfig, init_opt_state


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int

    @classmethod
    def create(cls, params, opt_cfg: OptimizerConfig) -> "TrainState":
        return cls(params=params,
                   opt_state=init_opt_state(params, opt_cfg),
                   step=0)

    def as_tree(self) -> dict:
        """The state as a plain tree (for ``CheckpointManager.save``)."""
        return {"params": self.params, "opt_state": self.opt_state,
                "step": self.step}
