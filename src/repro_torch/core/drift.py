"""Data-drift detection (Algorithm 1, line 11).

Drift is flagged when the freshly-labeled stream accuracy falls below the
buffer-validation accuracy by more than V_thr: the model fits its buffer but
the world moved.
"""
from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass
class DriftDetector:
    v_thr: float = -0.05  # acc_l - acc_v < v_thr  ==>  drift
    history: List[dict] = dataclasses.field(default_factory=list)

    def check(self, acc_label: float, acc_valid: float, t: float) -> bool:
        drift = (acc_label - acc_valid) < self.v_thr
        self.history.append(
            {"t": t, "acc_label": acc_label, "acc_valid": acc_valid,
             "drift": drift})
        return drift
