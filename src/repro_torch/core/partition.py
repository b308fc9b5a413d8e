"""Spatial partitioning (the single-device half of the JAX package's
``core/partition.py``).

The paper splits the array's rows into a T-SA (retraining + labeling) and
a B-SA (inference). On one device the partition degenerates to
time-sharing — the paper's own fallback — which is all the port has so
far: fission of several GPUs into sub-accelerators is ROADMAP Queue 1,
item 6, and a session given a mesh raises until it lands.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SpatialPartition:
    t_sa: Optional[object]  # retraining + labeling devices (None: shared)
    b_sa: Optional[object]  # inference devices (None: shared)
    time_shared: bool  # single-resource fallback


def single_device_partition() -> SpatialPartition:
    return SpatialPartition(t_sa=None, b_sa=None, time_shared=True)
