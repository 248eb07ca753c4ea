"""Quickstart: the SIMDRAM framework end to end (Fig. 2.3 / 2.5), on torch.

1. Describe a NEW operation in AND/OR/NOT logic (AOIG).
2. Step 1: synthesize an optimized MAJ/NOT MIG.
3. Step 2: allocate compute rows + generate the μProgram (shown like
   Fig. 2.5c), with coalescing.
4. Step 3: execute it on vertically-laid-out data — on the card through the
   pack, μProgram-VM and unpack kernels, on the CPU through their plain
   versions.
5. Compare its cost against the Ambit-style AND/OR/NOT baseline.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Union

import numpy as np
import torch

from ..core import (Aoig, BitPlaneArray, aoig_to_mig, apply_op, op_cost,
                    pack_np, unpack_np, uprogram_cost)
from ..core.allocator import allocate_cell
from ..core.subarray import d
from ..core.uprogram import Segment, UProgram, coalesce
from ..device import resolve_device
from ..kernels import from_bitplanes, to_bitplanes
from ..kernels.simdram_vm import run_uprogram


def main(device: Union[str, torch.device] = "cuda") -> dict:
    """Run the walk-through on ``device``; returns what it computed."""
    dev = resolve_device(device)
    print("=" * 70)
    print("1-2) user-defined op:  out = (a XOR b) AND mask   (per bit)")
    g = Aoig()
    a, b, m = g.input("a"), g.input("b"), g.input("m")
    out = g.and_(g.xor_(a, b), m)
    mig, outs = aoig_to_mig(g, [out], optimize=True)
    mig_naive, outs_n = aoig_to_mig(g, [out], optimize=False)
    print(f"   AOIG gates: {g.num_gates()}  naive MIG: "
          f"{mig_naive.size(outs_n)} MAJ  optimized MIG: "
          f"{mig.size(outs)} MAJ (depth {mig.depth(outs)})")

    print("=" * 70)
    print("2) row allocation + μProgram (cf. Fig 2.5c):")
    uops, n_tmp = allocate_cell(
        mig, {d("OUT", 1, 0): outs[0]},
        {"a": d("A", 1, 0), "b": d("B", 1, 0), "m": d("M", 1, 0)})
    n = 8
    prog = UProgram("xor_mask", n, [Segment(coalesce(uops), trips=n,
                                            comment="per-bit cell")])
    print(prog.listing())
    cost = uprogram_cost(prog)
    print(f"   {cost.commands} command sequences, {cost.latency_ns:.0f} ns "
          f"per 65536-lane row, {cost.throughput_gops:.2f} GOps/s/bank")

    print("=" * 70)
    print(f"3) execution on vertical (bit-plane) data on {dev}:")
    rng = np.random.default_rng(0)
    A = rng.integers(0, 256, 16)
    B = rng.integers(0, 256, 16)
    M = rng.integers(0, 256, 16)
    planes = [to_bitplanes(torch.from_numpy(v).to(dev), n,
                           signed=False).planes for v in (A, B, M)]
    res = run_uprogram(prog, planes, ("A", "B", "M"), out_bits=n)
    got = from_bitplanes(BitPlaneArray(res, 16, False)).cpu().numpy()
    print(f"   A={A[:6]}...\n   B={B[:6]}...\n   M={M[:6]}...")
    print(f"   out={got[:6]}...  (numpy: {((A ^ B) & M)[:6]}...)")
    assert np.array_equal(got, (A ^ B) & M)

    print("=" * 70)
    print("4) library ops + Ambit comparison (Sec 2.6.1):")
    x = pack_np(rng.integers(-1000, 1000, 32), 16, device=dev)
    y = pack_np(rng.integers(-1000, 1000, 32), 16, device=dev)
    s = unpack_np(apply_op("max", x, y))
    print(f"   max() via engine: {s[:6]}")
    ratios = {}
    for op in ("add", "mul", "gt", "relu"):
        c = op_cost(op, 16)
        ca = op_cost(op, 16, "ambit")
        ratios[op] = ca.latency_ns / c.latency_ns
        print(f"   {op:6s}: SIMDRAM {c.commands:5d} cmds vs Ambit "
              f"{ca.commands:5d} → {ratios[op]:.2f}x")
    print("   (paper: 2.0x throughput / 2.6x energy avg across 16 ops)")
    return {"mig_size": mig.size(outs), "mig_depth": mig.depth(outs),
            "naive_size": mig_naive.size(outs_n), "uops": uops,
            "n_tmp": n_tmp, "program": prog, "xor_mask": got,
            "inputs": (A, B, M), "max": s, "ambit_ratio": ratios}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
