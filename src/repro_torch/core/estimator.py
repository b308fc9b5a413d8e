"""Performance estimators feeding the resource allocator (paper §IV step
2) — the JAX package's ``core/estimator.py``.

In trace vocabulary (core/trace.py): an estimator is the *prior* over
program costs — it predicts the virtual-clock seconds each device program
the engine dispatches should charge for a given row split and MX
precision. The trace records what those programs cost the host (per-event
``wall_s``), and :meth:`~repro_torch.core.replay.TraceReplayer.calibrate`
fits per-kernel scale factors from it, which :class:`CalibratedEstimator`
applies to the prior; :class:`PlacementCostModel` is the manager tier's
placement economics, which a calibration re-expresses in measured seconds.

Two model backends, whose seconds drive the session's virtual clock; the
arithmetic of both, and of the two wrappers, is the reference's, float for
float:

* ``DaCapoEstimator`` — the paper's accelerator: an R x 16 array of DPEs at
  500 MHz, each computing one 16-wide dot product in 1 (MX4) / 4 (MX6) /
  16 (MX9) cycles (§V-B), with output-stationary tiling and pipeline fill.
* ``TPUEstimator`` — the reference's roofline model of a TPU chip, whose
  resources are chips instead of DPE rows, or shares of one device in
  ``fractional_rows`` mode (the paper's Jetson Orin baselines subclass it
  with their own constants).

``TPU_PEAK_FLOPS``, ``TPU_HBM_BW`` and ``TPU_ICI_BW`` are copied from the
reference (``src/repro/core/estimator.py:35-39``) as inputs to that cost
model, so that the port's virtual clock equals the reference's. They are
not measurements of anything the port runs on.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

from repro_torch.configs.dacapo_pairs import VisionConfig
from repro_torch.models.resnet import block_plan

MX_CYCLES = {"mx4": 1, "mx6": 4, "mx9": 16}

# The reference's cost-model constants (per chip), copied for parity.
TPU_PEAK_FLOPS = 197e12
TPU_HBM_BW = 819e9
TPU_ICI_BW = 50e9


def vision_gemms(cfg: VisionConfig,
                 batch: int = 1) -> List[Tuple[int, int, int]]:
    """(M, N, K) GEMM list for one forward pass (convs via im2col)."""
    gemms: List[Tuple[int, int, int]] = []
    if cfg.kind == "vit":
        n = (cfg.img_size // cfg.patch) ** 2 + 1
        d, f = cfg.d_model, cfg.d_ff
        gemms.append((batch * n, d, cfg.patch * cfg.patch * 3))
        for _ in range(cfg.num_layers):
            gemms.append((batch * n, 3 * d, d))
            gemms.append((batch * n, n, d))  # QK^T (per-head K folded)
            gemms.append((batch * n, d, n))  # AV
            gemms.append((batch * n, d, d))
            gemms.append((batch * n, f, d))
            gemms.append((batch * n, d, f))
        gemms.append((batch, cfg.num_classes, d))
        return gemms
    # ResNet.
    h = w = cfg.img_size
    stem_k = 7 if cfg.img_size > 64 else 3
    stride0 = 2 if cfg.img_size > 64 else 1
    h, w = h // stride0, w // stride0
    gemms.append((batch * h * w, 64, stem_k * stem_k * 3))
    if cfg.img_size > 64:
        h, w = h // 2, w // 2
    for kind, cin, mid, cout, stride in block_plan(cfg):
        h2, w2 = h // stride, w // stride
        if kind == "basic":
            gemms.append((batch * h2 * w2, mid, 9 * cin))
            gemms.append((batch * h2 * w2, cout, 9 * mid))
        else:
            gemms.append((batch * h * w, mid, cin))
            gemms.append((batch * h2 * w2, mid, 9 * mid))
            gemms.append((batch * h2 * w2, cout, mid))
        if stride != 1 or cin != cout:
            gemms.append((batch * h2 * w2, cout, cin))
        h, w = h2, w2
    gemms.append((batch, cfg.num_classes, block_plan(cfg)[-1][3]))
    return gemms


@dataclasses.dataclass(frozen=True)
class DaCapoEstimator:
    """Cycle-level model of the paper's 16x16 DPE prototype (Table IV)."""

    total_rows: int = 16
    cols: int = 16
    dot_width: int = 16
    freq_hz: float = 500e6

    def gemm_cycles(self, m: int, n: int, k: int, rows: int,
                    precision: str) -> float:
        """Output-stationary: tiles of rows x cols outputs; each output needs
        ceil(K/16) dot-steps at MX_CYCLES each; + pipeline fill per tile."""
        cyc_per_dot = MX_CYCLES[precision]
        k_steps = math.ceil(k / self.dot_width)
        tiles = math.ceil(m / rows) * math.ceil(n / self.cols)
        fill = rows + self.cols
        return tiles * (k_steps * cyc_per_dot + fill)

    def forward_time(self, cfg: VisionConfig, rows: int, precision: str,
                     batch: int = 1) -> float:
        cycles = sum(self.gemm_cycles(m, n, k, rows, precision)
                     for m, n, k in vision_gemms(cfg, batch))
        return cycles / self.freq_hz

    def train_step_time(self, cfg: VisionConfig, rows: int, precision: str,
                        batch: int) -> float:
        # fwd + 2 backward GEMMs per forward GEMM (dX and dW).
        return 3.0 * self.forward_time(cfg, rows, precision, batch)

    def inference_fps(self, cfg: VisionConfig, rows: int,
                      precision: str) -> float:
        return 1.0 / self.forward_time(cfg, rows, precision, batch=1)


@dataclasses.dataclass(frozen=True)
class TPUEstimator:
    """The reference's roofline cost model; ``rows`` == chips for the
    allocator.

    ``fractional_rows`` switches the meaning of ``rows`` from whole chips
    (peak scales linearly with row count) to fractions of a single fixed
    device (peak scales with rows/total_rows) — the mode device-sharing
    estimators like the paper's Jetson Orin model use.
    """

    total_rows: int = 1  # chips available to the CL system
    peak_flops: float = TPU_PEAK_FLOPS
    hbm_bw: float = TPU_HBM_BW
    fractional_rows: bool = False
    mx_speedup = {"mx4": 4.0, "mx6": 2.0, "mx9": 1.0}  # bandwidth-side gain

    def _units(self, rows: int) -> float:
        return rows / self.total_rows if self.fractional_rows else rows

    def forward_time(self, cfg: VisionConfig, rows: int, precision: str,
                     batch: int = 1) -> float:
        flops = sum(2 * m * n * k for m, n, k in vision_gemms(cfg, batch))
        bytes_moved = sum(m * k + k * n + m * n
                          for m, n, k in vision_gemms(cfg, batch)) * 4
        bytes_moved /= self.mx_speedup[precision]
        units = self._units(rows)
        t_c = flops / (units * self.peak_flops)
        t_m = bytes_moved / (units * self.hbm_bw)
        return max(t_c, t_m)

    def train_step_time(self, cfg, rows, precision, batch):
        return 3.0 * self.forward_time(cfg, rows, precision, batch)

    def inference_fps(self, cfg, rows, precision):
        return 1.0 / self.forward_time(cfg, rows, precision, batch=1)


@dataclasses.dataclass(frozen=True)
class CalibratedEstimator:
    """An estimator prior corrected by measured trace wall times.

    Wraps any backend with the same surface (``forward_time`` /
    ``train_step_time`` / ``inference_fps`` / ``total_rows``) and scales
    its predictions by per-kernel factors — typically the Σwall/Σcost
    ratios a :meth:`~repro_torch.core.replay.TraceReplayer.calibrate` fit
    from a recorded trace (``forward_scale`` from the forward-pass
    programs, ``train_scale`` from the retraining charges). Scale 1.0 is
    the uncorrected prior; the wrapper stays frozen and hashable like the
    backends, so allocators can hold it where they held the base.
    """

    base: object = dataclasses.field(default_factory=DaCapoEstimator)
    forward_scale: float = 1.0
    train_scale: float = 1.0

    @property
    def total_rows(self) -> int:
        return self.base.total_rows

    def forward_time(self, cfg: VisionConfig, rows: int, precision: str,
                     batch: int = 1) -> float:
        return self.forward_scale * self.base.forward_time(
            cfg, rows, precision, batch)

    def train_step_time(self, cfg: VisionConfig, rows: int, precision: str,
                        batch: int) -> float:
        return self.train_scale * self.base.train_step_time(
            cfg, rows, precision, batch)

    def inference_fps(self, cfg: VisionConfig, rows: int,
                      precision: str) -> float:
        return 1.0 / self.forward_time(cfg, rows, precision, batch=1)


@dataclasses.dataclass(frozen=True)
class PlacementCostModel:
    """Manager-tier placement economics on the overlapped execution model.

    With overlapped shard stepping the manager's wall per round is ``max``
    over shards of the per-shard phase load — not the sum — so placement
    quality is measured in seconds shaved off that max:

    * a candidate **migration**'s value is the per-round reduction of the
      load maximum it buys, amortized over ``horizon_rounds`` (a lane's
      cost is its last phase's T-SA seconds); the move itself costs
      ``migration_cost_s`` (virtual seconds);
    * **admission** control compares a shard's predicted T-SA
      *utilization* — T-SA seconds per phase over the phase's modeled
      wall — against ``oversub_limit``: above it, the shard's T-SA cannot
      keep up with real time and a new lane would degrade every tenant,
      so the fleet turns the camera away instead
      (``PlacementAction(kind="reject")``).
    """

    migration_cost_s: float = 0.0
    horizon_rounds: int = 4
    oversub_limit: float = 1.5

    @staticmethod
    def round_time_s(loads: Sequence[float]) -> float:
        """Modeled manager wall per round: the slowest shard's load."""
        return max(loads) if len(loads) else 0.0

    def migration_gain_s(self, loads: Sequence[float], src: int, dst: int,
                         lane_cost_s: float) -> float:
        """T-SA seconds the move saves over ``horizon_rounds`` rounds."""
        after = list(loads)
        after[src] -= lane_cost_s
        after[dst] += lane_cost_s
        return (self.round_time_s(loads)
                - self.round_time_s(after)) * self.horizon_rounds

    def worth_migrating(self, loads: Sequence[float], src: int, dst: int,
                        lane_cost_s: float) -> bool:
        return (self.migration_gain_s(loads, src, dst, lane_cost_s)
                > self.migration_cost_s)

    @staticmethod
    def utilization(t_tsa_s: float, phase_s: float) -> float:
        """T-SA occupancy of one phase window (>1: can't keep up)."""
        return t_tsa_s / phase_s if phase_s > 0 else 0.0

    def admits(self, t_tsa_s: float, phase_s: float,
               lane_cost_s: float) -> bool:
        """Would a shard at (t_tsa_s, phase_s) absorb one more lane?"""
        return (self.utilization(t_tsa_s + lane_cost_s, phase_s)
                <= self.oversub_limit)


def spatial_allocation(estimator, student: VisionConfig, fps: float,
                       precision: str) -> Tuple[int, int]:
    """GetSpatialAllocation (Alg. 1 line 1): minimum B-SA rows sustaining the
    input frame rate for student inference; the rest go to T-SA.

    Always returns (R_tsa, R_bsa) with R_tsa + R_bsa == total_rows. When no
    proper split sustains the frame rate, rows == total is considered before
    falling back: if the whole array is needed (or it is a single-row array),
    B-SA takes every row and T-SA time-shares (R_tsa = 0, the paper's R=0
    fallback); only when even the full array misses the frame rate does one
    row stay with T-SA so retraining is never starved entirely.
    """
    total = estimator.total_rows
    for rows in range(1, total):
        if estimator.inference_fps(student, rows, precision) >= fps:
            return total - rows, rows  # (R_tsa, R_bsa)
    if total == 1 or estimator.inference_fps(student, total,
                                             precision) >= fps:
        return 0, total  # whole array to inference; T-SA time-shares
    return 1, total - 1  # overloaded even at full width
