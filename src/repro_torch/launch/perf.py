"""§Perf hillclimbing driver (counterpart of ``repro/launch/perf.py``):
trace one dry-run cell with config overrides (``launch/dryrun.py``),
report the roofline delta against the baseline artifact of the same cell
and record the iteration.  Needs no card and no JAX.

    PYTHONPATH=src python -m repro_torch.launch.perf --arch qwen3-0.6b \\
        --shape train_4k --tag remat-dots --set remat_policy=dots \\
        --hypothesis "keeping the 2-D matmul outputs trades memory for FLOPs"

The baseline is ``<out>/<arch>_<shape>_<mesh>.json``, as
``python -m repro_torch.launch.dryrun`` writes it.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..configs import ARCH_IDS
from .dryrun import lower_cell
from .specs import SHAPES


def _coerce(v: str):
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--tag", required=True)
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=value (repeatable)")
    ap.add_argument("--quantized", action="store_true")
    ap.add_argument("--hypothesis", default="")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = _coerce(v)
    rec = lower_cell(args.arch, args.shape, args.mesh == "multi",
                     quantized=args.quantized, overrides=overrides)
    rec["tag"] = args.tag
    rec["hypothesis"] = args.hypothesis
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{args.arch}_{args.shape}_{args.mesh}_{args.tag}.json"
    path.write_text(json.dumps(rec, indent=1))
    base_path = out / f"{args.arch}_{args.shape}_{args.mesh}.json"
    if not rec.get("ok"):
        print("FAIL:", rec.get("error"))
        raise SystemExit(1)
    r = rec["roofline"]
    print(f"[{args.tag}] compute={r['compute_s']:.4f}s "
          f"memory={r['memory_s']:.4f}s collective={r['collective_s']:.4f}s "
          f"bottleneck={r['bottleneck']} "
          f"mem/dev={rec['bytes_per_device_live']/1e9:.2f}GB "
          f"trace={rec['lower_s']}s")
    if base_path.exists():
        b = json.loads(base_path.read_text())
        if b.get("ok") and not b.get("skipped"):
            br = b["roofline"]
            for t in ("compute_s", "memory_s", "collective_s"):
                ratio = br[t] / r[t] if r[t] else float("inf")
                print(f"   {t}: {br[t]:.4f} -> {r[t]:.4f}  ({ratio:.2f}x)")
            bstep = max(br["compute_s"], br["memory_s"], br["collective_s"])
            step = max(r["compute_s"], r["memory_s"], r["collective_s"])
            print(f"   step: {bstep:.4f} -> {step:.4f} ({bstep/step:.2f}x); "
                  f"mem/dev {b['bytes_per_device_live']/1e9:.2f} -> "
                  f"{rec['bytes_per_device_live']/1e9:.2f} GB")


if __name__ == "__main__":
    main()
