"""Serving launcher: continuous batching over the paged engine on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --no-prefix-cache \\
        --arch qwen3-0.6b --requests 6 --max-new 16              # smoke
    PYTHONPATH=src python -m repro_torch.launch.serve --no-prefix-cache \\
        --no-smoke --arch qwen3-0.6b                             # full width

Counterpart of ``repro/launch/serve.py``, default (closed-loop) path only:
``serve/engine.py`` driven by ``serve/scheduler.py`` — admission, chunked
prefill, the fused decode horizon, eviction and preemption — with page
lifecycle through ``core/vbi/blocks.py::VBIAllocator``.  Weights are
random, drawn from ``--seed``.  ``--device`` defaults to ``cuda`` and
raises when there is no card.

The prefix cache is not ported yet (ROADMAP.md § A7): the launcher
refuses to run without ``--no-prefix-cache``, so that a run never silently
differs from the reference's default.  ``--smoke``/``--no-smoke`` selects
the reduced or the published width (the reference's ``--smoke`` flag
cannot be switched off; here it can).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from ..configs import ARCH_IDS, get_config, smoke_config
from ..models.model import init_params
from ..serve.engine import PagedEngine
from ..serve.scheduler import Scheduler


def serve_config(arch: str, smoke: bool = True):
    """Float32 serve config for the paged serve paths (shared by the
    launcher and the tests).  Encoder-decoder archs fall back to the dense
    qwen3 stand-in, as in the reference."""
    cfg = smoke_config(arch) if smoke else get_config(arch)
    if cfg.is_encdec:
        cfg = dataclasses.replace(
            smoke_config("qwen3-0.6b"), name=cfg.name + "-as-dense")
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32", n_vis_tokens=0)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="closed-loop paged serving on the PyTorch port")
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reduced widths (default); --no-smoke serves the "
                         "published configuration")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--prefill-chunk", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=4)
    ap.add_argument("--decode-horizon", type=int, default=8,
                    help="fused decode horizon K: decoding slots advance K "
                         "tokens per engine call with sampling and stopping "
                         "on the device; the host reads one [K, S] block")
    ap.add_argument("--attn-impl", default="kernel",
                    choices=("gather", "kernel"),
                    help="'kernel' (default): the hand-written CUDA kernel "
                         "on the card, its plain twin on the CPU; 'gather': "
                         "the plain batched twin (CPU only)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="required: the prefix cache is not ported yet")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    return ap


def main(argv=None):
    """Run the closed-loop serve and return ``(finished_requests,
    engine)``."""
    ap = _parser()
    args = ap.parse_args(argv)
    if not args.no_prefix_cache:
        ap.error("the prefix cache is not ported yet (ROADMAP.md § A7): "
                 "pass --no-prefix-cache")
    cfg = serve_config(args.arch, args.smoke)
    params = init_params(cfg, seed=args.seed, device=args.device)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab, args.prompt_len).tolist()
               for _ in range(args.requests)]
    page_size = 8
    engine = PagedEngine(
        cfg, params, page_size=page_size, max_seqs=args.batch_slots,
        n_pages=1 + args.batch_slots * 32, attn_impl=args.attn_impl,
        device=args.device)
    print(f"[serve] {cfg.name}: {engine.geom.n_full} full-attention layers "
          f"on {engine.device} — attn_impl={args.attn_impl}")
    sched = Scheduler(engine, prefill_chunk=args.prefill_chunk,
                      decode_horizon=args.decode_horizon)
    t0 = time.perf_counter()
    for p in prompts:
        sched.add_request(p, max_new=args.max_new)
    finished = sched.run()
    dt = time.perf_counter() - t0
    for req in finished:
        print(f"[serve] req {req.rid} done: {req.prompt[-4:]} -> "
              f"{req.out[:8]}...")
    n_out = sum(len(r.out) for r in finished)
    print(f"[serve] engine stats {engine.stats} allocator stats "
          f"{engine.alloc.stats} sched stats {sched.stats}")
    print(f"[serve] {len(finished)} requests, {n_out} generated tokens in "
          f"{dt:.3f}s on {engine.device} ({n_out / dt:.1f} tok/s)")
    return finished, engine


if __name__ == "__main__":
    main()
