"""Data-aware placement in heterogeneous memory (Sec. 3.6.3, Figs. 3.9–3.10;
the port's copy of the reference's numpy model).

VBI conveys per-VB hotness/sensitivity (property bitvector) to the MTL,
which maps hot VBs to the fast region.  We model two systems from the paper:

  * PCM–DRAM : 64 ms/2 GB DRAM cache in front of PCM (fast=DRAM, slow=PCM)
  * TL-DRAM  : tiered-latency DRAM (near segment fast, far segment slow)

and compare hotness-aware mapping (VBI) against hotness-unaware (baseline
maps pages round-robin / by allocation order).  First-order AMAT model over
a zipf page-heat distribution; reported as speedup of memory-bound runtime.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class HeteroSystem:
    name: str
    fast_lat: float          # ns
    slow_lat: float          # ns
    fast_frac: float         # fraction of capacity that is fast


PCM_DRAM = HeteroSystem("PCM-DRAM", fast_lat=50.0, slow_lat=150.0,
                        fast_frac=0.25)
TL_DRAM = HeteroSystem("TL-DRAM", fast_lat=35.0, slow_lat=55.0,
                       fast_frac=0.20)


def page_heat(n_pages: int, zipf_a: float = 1.4, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    heat = 1.0 / np.arange(1, n_pages + 1) ** zipf_a
    rng.shuffle(heat)
    return heat / heat.sum()


def amat(system: HeteroSystem, heat: np.ndarray, aware: bool) -> float:
    n_fast = int(len(heat) * system.fast_frac)
    if aware:
        idx = np.argsort(heat)[::-1]          # hottest pages → fast region
        fast = np.zeros(len(heat), bool)
        fast[idx[:n_fast]] = True
    else:
        fast = np.zeros(len(heat), bool)      # allocation order (heat-blind)
        fast[:n_fast] = True
    lat = np.where(fast, system.fast_lat, system.slow_lat)
    return float((heat * lat).sum())


def speedup(system: HeteroSystem, mem_bound_frac: float = 0.6,
            n_pages: int = 4096, seed: int = 0) -> dict:
    heat = page_heat(n_pages, seed=seed)
    unaware = amat(system, heat, aware=False)
    aware = amat(system, heat, aware=True)
    mem_speedup = unaware / aware
    # Amdahl over the memory-bound fraction of runtime
    total = 1.0 / ((1 - mem_bound_frac) + mem_bound_frac / mem_speedup)
    return {"system": system.name, "amat_unaware_ns": unaware,
            "amat_aware_ns": aware, "amat_ratio": mem_speedup,
            "runtime_speedup": total}
