"""Trace-driven address-translation simulator (Sec. 3.6.2, Figs. 3.6–3.8;
the port's copy of the reference's numpy model).

Compares, on the same synthetic access trace:

  * ``Native``      — x86-64 4 KB pages, 4-level radix walk, L1/L2 TLBs + PWC.
  * ``Native-2M``   — 2 MB pages everywhere (3-level walk, bigger reach).
  * ``Virtual``     — VM guest: two-dimensional nested walk (up to 24 refs).
  * ``VBI``         — translation only on LLC miss, per-VB flexible tables
                      (direct-mapped VBs hit in 0 table refs; enter/level
                      counts follow mtl.py), CVT-cache protection check off
                      the critical path, delayed allocation zero-fills.

This is a first-order cycle model (cache hits, TLB reach, walk memory
references × DRAM latency) meant to reproduce the paper's *trends*:
VBI ≈ 2.18× native / 3.8× VM at 4 KB; 77%/89% with large pages.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

DRAM_LAT = 50           # cycles per memory reference during a walk
LLC_LAT = 30
L1_TLB = 64
L2_TLB = 512
PWC_ENTRIES = 32


@dataclasses.dataclass
class TraceConfig:
    n_accesses: int = 200_000
    working_set_pages: int = 1 << 20     # 4 GB of 4K pages (big-memory apps)
    zipf_a: float = 1.2
    llc_mr: float = 0.35                 # LLC miss rate (memory-bound apps)
    seed: int = 0


def synth_trace(cfg: TraceConfig) -> np.ndarray:
    rng = np.random.default_rng(cfg.seed)
    ranks = rng.zipf(cfg.zipf_a, cfg.n_accesses)
    pages = (ranks - 1) % cfg.working_set_pages
    perm = rng.permutation(cfg.working_set_pages)
    return perm[pages]


class _TLB:
    def __init__(self, entries: int):
        self.entries = entries
        self.slots: Dict[int, int] = {}
        self.clock = 0

    def access(self, tag: int) -> bool:
        self.clock += 1
        if tag in self.slots:
            self.slots[tag] = self.clock
            return True
        if len(self.slots) >= self.entries:
            lru = min(self.slots, key=self.slots.get)
            del self.slots[lru]
        self.slots[tag] = self.clock
        return False


def simulate(pages: np.ndarray, mode: str, cfg: TraceConfig,
             vb_translation: str = "direct") -> dict:
    """Returns cycles attributable to translation + memory access."""
    rng = np.random.default_rng(cfg.seed + 1)
    is_llc_miss = rng.random(len(pages)) < cfg.llc_mr

    if mode in ("native", "virtual"):
        page_shift = 0
        walk_refs = 4
    elif mode == "native2m":
        page_shift = 9          # 2M = 512 x 4K
        walk_refs = 3
    elif mode == "vbi":
        page_shift = 0
        walk_refs = {"direct": 0, "single": 1, "multi": 3}[vb_translation]
    else:
        raise ValueError(mode)
    if mode == "virtual":
        # 2D nested walk: up to (4+1)^2-1 = 24 refs; nested PWC/page-table
        # caches absorb roughly the guest-level upper levels in steady state.
        walk_refs = 10

    l1 = _TLB(L1_TLB)
    l2 = _TLB(L2_TLB)
    pwc = _TLB(PWC_ENTRIES)
    cycles = 0
    walks = 0
    for pg, miss in zip(pages, is_llc_miss):
        tag = int(pg) >> page_shift
        if mode == "vbi":
            # VBI: no translation to reach on-chip caches (VIVT); translation
            # happens only on an LLC miss, inside the MTL, over small per-VB
            # tables cached in the MTL's TLB (model: L1-sized).
            if miss:
                cycles += DRAM_LAT           # the data access itself
                if not l1.access(tag):
                    walks += 1
                    refs = walk_refs
                    if refs and pwc.access(tag >> 9):
                        refs -= 1
                    cycles += refs * DRAM_LAT
            else:
                cycles += LLC_LAT
            continue
        # conventional: TLB lookup precedes every access
        if not l1.access(tag):
            if not l2.access(tag):
                walks += 1
                refs = walk_refs
                if refs and pwc.access(tag >> 9):
                    refs -= 1
                cycles += refs * DRAM_LAT
        cycles += DRAM_LAT if miss else LLC_LAT
    return {"cycles": int(cycles), "walks": walks, "mode": mode}


def run_comparison(cfg: Optional[TraceConfig] = None) -> dict:
    """Paper's two configurations: VBI-4K maps VBs at 4 KB granularity
    (single-level per-VB tables) — compared against Native/Virtual at 4 KB
    (Fig. 3.6); VBI-Full adds early reservation → direct-mapped VBs —
    compared against Native-2M (Fig. 3.7)."""
    cfg = cfg or TraceConfig()
    pages = synth_trace(cfg)
    native = simulate(pages, "native", cfg)
    native2m = simulate(pages, "native2m", cfg)
    virtual = simulate(pages, "virtual", cfg)
    vbi_4k = simulate(pages, "vbi", cfg, vb_translation="single")
    vbi_full = simulate(pages, "vbi", cfg, vb_translation="direct")
    return {
        "native_cycles": native["cycles"],
        "virtual_cycles": virtual["cycles"],
        "vbi_4k_cycles": vbi_4k["cycles"],
        "vbi_full_cycles": vbi_full["cycles"],
        "speedup_native": native["cycles"] / vbi_4k["cycles"],
        "speedup_vm": virtual["cycles"] / vbi_4k["cycles"],
        "speedup_native_2m": native2m["cycles"] / vbi_full["cycles"],
        "walks": {m["mode"]: m["walks"] for m in (native, virtual, vbi_4k)},
    }
