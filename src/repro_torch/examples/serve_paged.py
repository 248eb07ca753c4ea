"""VBI-paged serving demo on the port: continuous batching over the paged
engine with device-side delayed page allocation — the MTL managing the KV
address space — cross-request KV prefix sharing, property-typed cache
blocks for heterogeneous layer stacks, the disaggregated prefill/decode
topology and the fault plane.  A thin ``main`` over
``repro_torch.launch.serve``; every flag of the launcher works here.

    PYTHONPATH=src python -m repro_torch.examples.serve_paged \\
        --requests 6 --max-new 16                       # on the card
    PYTHONPATH=src python -m repro_torch.examples.serve_paged --device cpu \\
        --requests 8 --shared-prefix 32 --max-new 8     # prefix-cache hits

A non-uniform stack through the same engine — gemma3's 5-local:1-global
pattern (windowed layers on capped RING frames, global layers paged) and
recurrentgemma's RG-LRU hybrid (constant-size RECURRENT state, zero page
budget), fused decode horizon on:

    PYTHONPATH=src python -m repro_torch.examples.serve_paged --device cpu \\
        --arch gemma3-12b --requests 6 --max-new 24 --decode-horizon 8
    PYTHONPATH=src python -m repro_torch.examples.serve_paged --device cpu \\
        --arch recurrentgemma-9b --requests 6 --max-new 24

Two engines and seeded faults at every allocator boundary, every fault
recovered exactly and the two-pool trace checked:

    PYTHONPATH=src python -m repro_torch.examples.serve_paged --device cpu \\
        --disagg --faults --fault-rate 0.1 --trace t.jsonl --metrics

Pass ``--no-prefix-cache`` to disable sharing (off by itself for
RING/RECURRENT stacks) and ``--no-smoke`` for the published widths (on
the card).  Attention runs through the hand-written paged-attention
kernel on the card and its plain twin on the CPU.
"""
from __future__ import annotations

from ..launch.serve import main

if __name__ == "__main__":
    main()
