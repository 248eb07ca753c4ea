#!/usr/bin/env python3
"""Time the unmeshed serve engine's decode horizon of one source tree on
the card.

    python3 tools/time_serve_horizon.py [--src DIR] [--label NAME] [--reps N]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (default:
this checkout's), so that two versions of the serve path can be compared
on one card: unpack the other version with ``git archive`` into an
ignored directory and run, in turn, old, new, new, old.  Each run serves
``chip_smoke.py``'s phase 4 through that tree's launcher (``SERVE_ARGV``:
qwen3-0.6b at its published config, random weights from seed 0, the
paged-attention kernel, no mesh), then times ``decode_many(K=8)`` over
every slot of that engine on the host clock, synchronised after each, for
``--reps`` horizons after one warm one (``chip_smoke._horizon_turns``'s
setting: 4 prompt tokens, then token 7 in every slot), and prints one
JSON line with the card's name and power limit, every reading and their
median.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default=None)
    ap.add_argument("--reps", type=int, default=16)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("time_serve_horizon: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels.paged_attention import build_kernel
    from repro_torch.launch import serve

    dev, card = cs._setup_card(torch)
    build_kernel()
    _, eng, _ = serve.main(cs.SERVE_ARGV)
    S, k = eng.max_seqs, 8
    for s in range(S):
        eng.alloc.reserve_span(eng.alloc.alloc(s), 4, k * (args.reps + 1))
    eng.prefill_chunk(
        torch.arange(1, 5, dtype=torch.int32, device=dev).repeat(S, 1),
        torch.full((S,), 4, dtype=torch.int32, device=dev))
    horizon = (torch.full((S,), 7, dtype=torch.int32, device=dev),
               torch.ones((S,), dtype=torch.bool, device=dev),
               torch.full((S,), k, dtype=torch.int32, device=dev), k)
    eng.decode_many(*horizon)
    torch.cuda.synchronize()
    ms = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        eng.decode_many(*horizon)
        torch.cuda.synchronize()
        ms.append(round((time.perf_counter() - t0) * 1e3, 3))
    print(json.dumps({"card": card, "label": args.label or args.src,
                      "engine": f"{eng.cfg.name}, {S} slots, attn_impl "
                                f"{eng.attn_impl}, no mesh",
                      "horizon_k": k, "ms": ms,
                      "median_ms": statistics.median(ms)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
