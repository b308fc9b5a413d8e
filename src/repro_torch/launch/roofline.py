"""Roofline terms of a dry-run step on the NVIDIA H100 (the JAX package's
``launch/roofline.py``, whose constants are the TPU's).

compute    = flops / (chips x 989.4 TFLOP/s)
memory     = hbm_bytes / (chips x 3.35 TB/s)   (fused traffic)
collective = collective_bytes / (chips x 50 GB/s)

The counts are one rank's (``launch/counting.py``: the post-SPMD program
of the reference), so :func:`analyze` gives ``chips=1``, as the reference
does. ``hbm_bytes`` is the fused traffic, as the reference's memory term
(``traffic_bytes_fused``): bytes move only at products, gathers,
scatters, copies, concatenations, pads, collectives and kernel calls, and
at the edges of the elementwise chains between them; the unfused count
rides along as ``collective_detail["hbm_bytes_unfused"]``, as in the
reference. ``collective_bytes`` sums the operand bytes of every
collective the rank issues; ``ring_bytes`` is the per-op ring estimate
beside it.

The constants are datasheet figures of the H100 SXM5 (80 GB HBM3), not
measurements: 989.4 TFLOP/s dense BF16 on the tensor cores, 3.35 TB/s of
HBM3, and 50 GB/s a card for a collective, the one 400 Gb/s NDR
InfiniBand NIC each card of a DGX H100 has: a 16-wide mesh axis does not
fit inside one 8-card NVLink domain, so its ring runs over the network.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

H100_PEAK_FLOPS = 989.4e12  # dense BF16, H100 SXM5 datasheet
H100_HBM_BW = 3.35e12  # HBM3, H100 SXM5 datasheet
H100_NET_BW = 50e9  # one 400 Gb/s NDR NIC per card (DGX H100)


@dataclasses.dataclass
class CollectiveStats:
    op_bytes: Dict[str, float]
    op_counts: Dict[str, int]
    total_bytes: float
    ring_bytes: float  # refined: x (k-1)/k per op

    def to_dict(self):
        return dataclasses.asdict(self)


def collective_stats(counts) -> CollectiveStats:
    """The collectives a trace recorded (``counting.Counts``)."""
    return CollectiveStats(dict(counts.op_bytes), dict(counts.op_counts),
                           counts.collective_bytes, counts.ring_bytes)


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    collective_bytes: float
    ring_bytes: float
    chips: int
    peak_flops: float = H100_PEAK_FLOPS
    hbm_bw: float = H100_HBM_BW
    ici_bw: float = H100_NET_BW
    collective_detail: Optional[dict] = None

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * self.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * self.hbm_bw)

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / (self.chips * self.ici_bw)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_total(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def to_dict(self):
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "ring_bytes": self.ring_bytes, "chips": self.chips,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "collective_detail": self.collective_detail,
        }


def analyze(traced, chips: int) -> Roofline:
    """Roofline terms of one rank's counts (``steps.trace_bundle``): per
    device, so the denominators see ``chips=1`` whatever ``chips`` the
    mesh has, as in the reference."""
    stats = collective_stats(traced)
    rf = Roofline(flops=traced.flops, hbm_bytes=traced.hbm_bytes,
                  collective_bytes=stats.total_bytes,
                  ring_bytes=stats.ring_bytes, chips=1)
    rf.collective_detail = {
        "by_kind": stats.op_bytes,
        "counts": stats.op_counts,
        "hbm_bytes_unfused": traced.hbm_bytes_unfused,
        "kernel_flops": dict(traced.kernel_flops),
        "mesh_chips": chips,
    }
    return rf
