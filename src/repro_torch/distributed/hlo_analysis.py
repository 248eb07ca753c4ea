"""Roofline terms of a traced step (counterpart of
``repro/distributed/hlo_analysis.py``).

The reference reads FLOPs and bytes from ``compiled.cost_analysis()`` and
the collectives from the SPMD-partitioned HLO text.  The port has no
HLO: the step cost walker (``distributed/hlo_cost.py``) runs one rank's
step on meta tensors and a ``launch/mesh.py::CountingMesh``, whose record
of calls gives the collective traffic (:func:`collective_bytes`), and
:func:`roofline_from_step` turns the walker's report into the three
roofline terms.

Byte accounting per collective (ring algorithms, factor (n-1)/n ≈ 1
folded in):
  all-reduce         2 × result bytes        (reduce-scatter + all-gather)
  all-gather         1 × result bytes
  reduce-scatter     1 × operand bytes (≈ result × n)
  all-to-all         1 × result bytes
  collective-permute 1 × result bytes
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from .hlo_cost import StepCost

# NVIDIA H100 80GB HBM3, 700 W: dense bf16 tensor-core peak (spec sheet)
PEAK_FLOPS = 989e12
# NVIDIA H100 80GB HBM3, 700 W: HBM3 bandwidth (spec sheet)
HBM_BW = 3.35e12
# NVIDIA H100 80GB HBM3, 700 W: the per-GPU network rate a 16x16 mesh
# spanning 32 eight-GPU nodes is bound by, one 400 Gb/s NDR port per GPU
# (50e9 B/s); NVLink inside a node gives 450e9 B/s a direction
ICI_BW = 50e9


def collective_bytes(mesh) -> Dict[str, float]:
    """Per-device collective traffic by HLO kind (bytes) of the calls a
    counting mesh recorded, with ``total`` and ``counts`` (the
    reference's keys over its HLO text)."""
    cost = StepCost()
    cost.add_collectives(mesh.calls)
    out: Dict[str, float] = dict(cost.coll)
    out["total"] = sum(cost.coll.values())
    out["counts"] = {k: int(v) for k, v in cost.coll_counts.items()}  # type: ignore[assignment]
    return out


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float           # optimistic (fusion-like) byte count
    coll_bytes_per_device: float
    chips: int
    bytes_per_device_max: float = 0.0  # pessimistic (every dispatched op)

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def memory_s_max(self) -> float:
        return self.bytes_per_device_max / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes_per_device / ICI_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "memory_s_max": self.memory_s_max,
            "collective_s": self.collective_s, "bottleneck": self.bottleneck,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "bytes_per_device_max": self.bytes_per_device_max,
            "coll_bytes_per_device": self.coll_bytes_per_device,
        }


def roofline_from_step(report: dict, mesh_devices: int) -> Roofline:
    """The roofline of a walker report (``hlo_cost.analyze_step``): its
    FLOPs, its fusion-like ``bytes_min`` (``bytes`` as the pessimistic
    term) and its collective bytes, per device."""
    return Roofline(report["flops"], report["bytes_min"],
                    report["collectives"]["total"], mesh_devices,
                    bytes_per_device_max=report["bytes"])
