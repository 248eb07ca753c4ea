#!/usr/bin/env python3
"""Time the paged-attention kernel of one source tree on the card.

    python3 tools/time_paged_attention.py [--src DIR] [--label NAME] [--sweep]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (default:
this checkout's), so that two versions of the kernel can be compared on
one card: unpack the other version with ``git archive`` into an ignored
directory and run, in turn, old, new, new, old.  Each run builds
that tree's kernel, then times its default launch at the shapes of
``chip_smoke.py``'s phase 3 (``PA_TIMED``: the serve's 4 slots x 8 kv heads,
g 2, d 128, pages of 8, at seq_len 19, 256, 2,048 and mixed lengths) with
the same CUDA-event timer, and prints one JSON line per shape with the
card's name and power limit.  ``--sweep`` (a tree with ``split_plan``) also
times the planned launch with P forced to 1, 2, 4, 8, 16 blocks per (kv
head, slot) and 4, 8 or 16 warps per block, and adds two shapes that show
the kernel's fixed cost: every seq_len 0 (launch, one round trip for
seq_len, q and page ids, zeros written) and every seq_len 1, and two
yardsticks at 2,048 tokens: the same call with each slot's pages in order
in the pool, and one ``torch.sum`` over as many bytes as the call must read
(a streaming read).  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default=None)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("time_paged_attention: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels.paged_attention import build_kernel, ops

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    build_kernel()
    dev = torch.device("cuda", 0)
    pa = ops.paged_attention
    shapes = list(cs.PA_TIMED)
    if args.sweep:
        shapes += [("0", [0] * 4, 32, 129), ("1", [1] * 4, 32, 129)]
    plan = getattr(ops, "split_plan", None)
    for label, lens, max_pages, n_pages in shapes:
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        q, k, v, pt, ln = cs._pool(torch, gen, len(lens), 8, 2, 128, 8,
                                   n_pages, max_pages, lens, dev)
        row = {"tree": args.label or args.src, "shape": label,
               "seq_lens": lens, "max_pages": max_pages, "card": card}
        ms, call_ms = cs._time_ms(torch,
                                  lambda: pa(q, k, v, pt, ln, max_pages))
        print(json.dumps({**row, "kernel_ms": ms, "call_ms": call_ms}))
        if not args.sweep:
            continue
        for P in (1, 2, 4, 8, 16):
            # the planned launch (64-token chunks) with P blocks per column
            ops.split_plan = lambda *_, P=P: P
            for W in (4, 8, 16):
                ms, _ = cs._time_ms(torch, lambda: pa(q, k, v, pt, ln,
                                                      max_pages, splits=W))
                print(json.dumps({**row, "blocks": P, "warps": W,
                                  "kernel_ms": ms}))
        ops.split_plan = plan
        if label == "2048":
            in_order = (torch.arange(pt.numel(), device=dev, dtype=torch.int32)
                        .view(pt.shape) + 1) % k.shape[0]
            ms, _ = cs._time_ms(torch, lambda: pa(q, k, v, in_order, ln,
                                                  max_pages))
            print(json.dumps({**row, "pages": "in order", "kernel_ms": ms}))
            flat = torch.randn(2 * 2048 * 4 * 8 * 128, device=dev)
            ms, _ = cs._time_ms(torch, lambda: flat.sum())
            print(json.dumps({**row, "yardstick": "torch.sum",
                              "bytes": flat.numel() * 4, "kernel_ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
