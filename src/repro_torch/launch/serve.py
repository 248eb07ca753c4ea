"""Serving launcher: continuous batching over the paged engine on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --no-prefix-cache \\
        --arch qwen3-0.6b --requests 6 --max-new 16              # smoke
    PYTHONPATH=src python -m repro_torch.launch.serve --no-prefix-cache \\
        --no-smoke --arch qwen3-0.6b                             # full width
    PYTHONPATH=src python -m repro_torch.launch.serve --no-prefix-cache \\
        --arch gemma3-12b --device cpu             # local/global, on the CPU

Counterpart of ``repro/launch/serve.py``, default (closed-loop) path only:
``serve/engine.py`` driven by ``serve/scheduler.py`` — admission, chunked
prefill, the fused decode horizon, eviction and preemption — with page
lifecycle through ``core/vbi/blocks.py::VBIAllocator``.  Every
decoder-only arch is served: uniform, local/global and sliding-window
attention, RG-LRU and Mamba-2 recurrent layers, top-k MoE; the launcher
prints the stack's geometry (full, ring, RG-LRU and SSM layers, the
window and its ring pages).  Weights are random, drawn from ``--seed``.
``--device`` defaults to ``cuda`` and raises when there is no card;
``--device cpu`` serves the smoke configs on the CPU.

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
    return serve(cfg, params, requests=args.requests, max_new=args.max_new,
                 batch_slots=args.batch_slots,
                 prefill_chunk=args.prefill_chunk,
                 prompt_len=args.prompt_len,
                 decode_horizon=args.decode_horizon,
                 attn_impl=args.attn_impl, seed=args.seed,
                 device=args.device)


def serve(cfg, params, *, requests: int = 6, max_new: int = 16,
          batch_slots: int = 4, prefill_chunk: int = 8, prompt_len: int = 4,
          decode_horizon: int = 8, attn_impl: str = "kernel", seed: int = 0,
          device="cuda"):
    """The launcher's serve on given params (on ``device``): ``requests``
    prompts of ``prompt_len`` tokens drawn from ``seed``, each decoding
    ``max_new`` tokens, through the engine (pages of 8 tokens, 32 pages a
    slot) and the scheduler.  Returns ``(finished_requests, engine)``."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, prompt_len).tolist()
               for _ in range(requests)]
    page_size = 8
    engine = PagedEngine(
        cfg, params, page_size=page_size, max_seqs=batch_slots,
        n_pages=1 + batch_slots * 32, attn_impl=attn_impl, device=device)
    geom = engine.geom
    print(f"[serve] {cfg.name} on {engine.device} — attn_impl={attn_impl}; "
          f"geometry: n_full {geom.n_full}, n_ring {geom.n_ring}, n_rg "
          f"{geom.n_rg}, n_ssm {geom.n_ssm}, window {geom.window}, ring "
          f"pages {geom.ring_pages} of {page_size} tokens")
    sched = Scheduler(engine, prefill_chunk=prefill_chunk,
                      decode_horizon=decode_horizon)
    t0 = time.perf_counter()
    for p in prompts:
        sched.add_request(p, max_new=max_new)
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
