"""DRAM command-count latency/energy model (Secs. 2.5–2.6 methodology).

This container has no DRAM (or TPU); like the paper we charge each μProgram
by its command sequences:

  AP       = TRA → PRECHARGE                       (1 TRA activation)
  AAP      = ACTIVATE → ACTIVATE → PRECHARGE       (2 single activations)
  AAP_maj  = TRA → ACTIVATE → PRECHARGE            (Case-2 coalesced copy)

Timing uses DDR4-2400-class constants; energy uses the paper's observation
that every *additional* simultaneously-activated row costs +22% activation
energy (Sec. 2.6.2), so a TRA costs 1.44× a single ACTIVATE.

Throughput follows Sec. 2.5: one 8 kB row buffer = 65536 SIMD lanes per
subarray; SIMDRAM:X scales linearly with X banks (bank-level parallelism).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from .operations import OPS, get_uprogram
from .subarray import ROW_BITS
from .uprogram import UProgram

T_RAS_NS = 35.0
T_RP_NS = 15.0
AP_NS = T_RAS_NS + T_RP_NS                  # TRA + precharge
AAP_NS = 2 * T_RAS_NS + T_RP_NS             # two ACTs + precharge

E_ACT_NJ = 2.0                              # one-row activation (incl. PRE)
TRA_FACTOR = 1.0 + 2 * 0.22                 # +22% per extra activated row


@dataclasses.dataclass(frozen=True)
class OpCost:
    name: str
    n_bits: int
    style: str
    commands: int
    latency_ns: float
    energy_nj: float                        # per subarray-row invocation
    lanes: int = ROW_BITS

    @property
    def throughput_gops(self) -> float:
        """Giga element-operations/s for ONE bank (one active subarray)."""
        return self.lanes / self.latency_ns

    @property
    def gops_per_watt(self) -> float:
        # energy per lane-op = energy_nj / lanes ; 1/(J/op) = op/s/W
        return self.lanes / self.energy_nj


def uprogram_cost(prog: UProgram, style: str = "simdram") -> OpCost:
    cc = prog.command_count()
    latency = cc["AAP"] * AAP_NS + cc["AAP_maj"] * AAP_NS + cc["AP"] * AP_NS
    energy = (cc["AAP"] * 2 * E_ACT_NJ
              + cc["AAP_maj"] * (TRA_FACTOR + 1) * E_ACT_NJ
              + cc["AP"] * TRA_FACTOR * E_ACT_NJ)
    return OpCost(prog.name, prog.n_bits, style, cc["total"], latency, energy)


def op_cost(name: str, n: int, style: str = "simdram") -> OpCost:
    return uprogram_cost(get_uprogram(name, n, style), style)


def compare_to_ambit(names=None, n: int = 32) -> Dict[str, dict]:
    """SIMDRAM:1 vs Ambit-equivalent (Fig. 2.9/2.10 headline ratios)."""
    names = names or list(OPS)
    out = {}
    for name in names:
        s = op_cost(name, n, "simdram")
        a = op_cost(name, n, "ambit")
        out[name] = {
            "simdram_cmds": s.commands, "ambit_cmds": a.commands,
            "throughput_ratio": a.latency_ns / s.latency_ns,
            "energy_ratio": a.energy_nj / s.energy_nj,
        }
    return out


def kernel_cost(op_sequence, n: int, n_elems: int, banks: int = 1,
                style: str = "simdram") -> dict:
    """Latency/energy of a sequence of (op_name, count) bbops over arrays of
    ``n_elems`` elements, with bank-level parallelism (SIMDRAM:X)."""
    import math
    seg_trips = math.ceil(n_elems / ROW_BITS)          # Loop Counter
    par_trips = math.ceil(seg_trips / banks)           # banks run in parallel
    lat = 0.0
    en = 0.0
    cmds = 0
    for op_name, count in op_sequence:
        cst = op_cost(op_name, n, style)
        lat += cst.latency_ns * par_trips * count
        en += cst.energy_nj * seg_trips * count
        cmds += cst.commands * seg_trips * count
    return {"latency_ns": lat, "energy_nj": en, "commands": cmds,
            "elems": n_elems, "banks": banks}
