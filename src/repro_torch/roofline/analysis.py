"""Three-term roofline on the H100's data-sheet constants (the port of
``repro.roofline.analysis``).

  compute    = FLOPs / peak FLOP/s
  memory     = bytes / HBM bandwidth
  collective = wire bytes / link bandwidth

All three are per device: the op walk (``roofline.op_walk``) tallies one
rank's program, and every rank of a placed run runs the same shapes.
The collectives' wire bytes follow the reference's ring-cost factors
(``wire_bytes``), applied to the port's collectives (``models.
collectives``) as they report their results.

The constants are NVIDIA's data sheet for the H100 SXM5 at its 700 W
limit, not measurements: 989 TFLOP/s dense bf16 on the tensor cores,
3.35 TB/s HBM3, and NVLink 4's 900 GB/s per GPU counted as 450 GB/s each
way.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

PEAK_FLOPS = 989e12      # H100 SXM5 data sheet: dense bf16, 700 W
HBM_BW = 3.35e12         # H100 SXM5 data sheet: HBM3 bytes/s
LINK_BW = 450e9          # H100 SXM5 data sheet: NVLink 4, bytes/s each way


def wire_bytes(op: str, result_bytes: float, n: int) -> float:
    """Per-device bytes on the wire for one collective of a group of n
    ranks (ring costs; ``result_bytes`` is one rank's result):

      all-reduce      2·B·(n-1)/n
      all-gather      B·(n-1)/n
      reduce-scatter  B·n·(n-1)/n   (B·n = the full operand)
      all-to-all      B·(n-1)/n
      collective-permute  B
    """
    frac = (n - 1) / n if n > 1 else 0.0
    if op == "all-reduce":
        return 2.0 * result_bytes * frac
    if op == "reduce-scatter":
        return result_bytes * n * frac
    if op == "collective-permute":
        return float(result_bytes)
    return result_bytes * frac


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    wire_bytes: float
    chips: int
    collectives: Dict[str, dict]
    dot_flops: float = 0.0
    hbm_bytes_min: float = 0.0  # the fused-boundary lower bound

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        """The fused-boundary bound when present: eager op-by-op bytes
        overstate what fused kernels move; ``hbm_bytes`` keeps the upper
        bound."""
        return (self.hbm_bytes_min or self.hbm_bytes) / HBM_BW

    @property
    def memory_upper_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.wire_bytes / LINK_BW

    @property
    def bound_s(self) -> float:
        """The least time: the largest of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    def to_dict(self) -> dict:
        return {
            "dot_flops": self.dot_flops,
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "hbm_bytes_min": self.hbm_bytes_min,
            "memory_upper_s": self.memory_upper_s,
            "wire_bytes_per_device": self.wire_bytes,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "collectives": self.collectives,
        }


def analyze(tally, chips: int) -> Roofline:
    """The roofline of one rank's op walk (``op_walk.Tally``)."""
    collectives = {
        op: {"count": tally.collective_counts.get(op, 0),
             "wire_bytes": tally.collective_wire.get(op, 0.0)}
        for op in set(tally.collective_counts) | set(tally.collective_wire)
    }
    return Roofline(flops=tally.flops, hbm_bytes=tally.bytes,
                    hbm_bytes_min=tally.bytes_min,
                    wire_bytes=tally.wire_bytes, chips=chips,
                    collectives=collectives, dot_flops=tally.dot_flops)
