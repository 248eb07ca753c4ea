#!/usr/bin/env python3
"""Time the bit-plane pack and unpack kernels of one source tree on the card.

    python3 tools/time_bitplane_transpose.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (default:
this checkout's), so that two versions of the kernels can be compared on
one card: unpack the other version with ``git archive`` into an ignored
directory (``build/``) and run, in turn, old, new, new, old.  Each run
builds that tree's kernels, then times pack (``to_bitplanes``) and unpack
(``from_bitplanes``) at 8 and 32 bits on 2^20 and 2^26 int32 elements (the
shapes of ``chip_smoke.py``'s phase 8, the same inputs and the same
CUDA-event timer), and prints one JSON line per shape with the card's name
and power limit, the byte bound (the int32 input and the planes, once) and
a streaming yardstick: one ``copy_`` between two buffers of half those
bytes each.  Where the tree names its tiles (``ops.PACK_TILE``,
``ops.unpack_tile``) the line gives the tile and grid.  Needs one CUDA
card.
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
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("time_bitplane_transpose: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import numpy as np

    import chip_smoke as cs
    from repro_torch.kernels import bitplane_transpose as tt

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    tt.build_kernel()
    dev = torch.device("cuda", 0)
    pack_tile = getattr(tt.ops, "PACK_TILE", None)
    for size in (cs.FULL, cs.LARGE):
        nw = -(-size // 32)
        rng = np.random.default_rng(3)             # phase 8's operand a
        a = torch.from_numpy(rng.integers(-2**30, 2**30, size,
                                          dtype=np.int32)).to(dev)
        for n_bits in (8, 32):
            io = 4 * size + 4 * n_bits * nw
            bound_ms, _ = cs._bound(io, 0)
            copy_ms = cs._copy_ms(torch, io, dev)
            bp = tt.to_bitplanes(a, n_bits)
            row = {"tree": args.label or args.src, "elems": size,
                   "n_bits": n_bits, "bytes": io, "bound_ms": bound_ms,
                   "copy_ms": copy_ms, "card": card}
            unpack_tile = (None if pack_tile is None
                           else tt.ops.unpack_tile(n_bits))
            for kernel, fn, tw in (
                    ("pack", lambda: tt.to_bitplanes(a, n_bits), pack_tile),
                    ("unpack", lambda: tt.from_bitplanes(bp), unpack_tile)):
                ms = cs._kernel_ms(torch, fn)
                print(json.dumps({
                    **row, "kernel": kernel,
                    **({} if tw is None else
                       {"tile_words": tw, "blocks": -(-nw // tw)}),
                    "kernel_ms": ms}), flush=True)
        del a
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
