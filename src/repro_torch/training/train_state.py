"""Train state container and its sharding specs (the JAX package's
``training/train_state.py``): the moments shard like the params, the step
is replicated."""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.distributed import PartitionSpec, param_specs
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


def train_state_specs(param_defs) -> TrainState:
    """PartitionSpec tree mirroring TrainState under the current rules
    (AdamW: moments mu and nu shard like the params)."""
    p_specs = param_specs(param_defs)
    return TrainState(params=p_specs,
                      opt_state={"mu": p_specs, "nu": p_specs},
                      step=PartitionSpec())


def train_state_specs_sgd(param_defs) -> TrainState:
    p_specs = param_specs(param_defs)
    return TrainState(params=p_specs, opt_state={"mu": p_specs},
                      step=PartitionSpec())
