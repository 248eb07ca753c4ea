"""Serving launcher: continuous batching over the paged engine on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen3-0.6b --requests 6 --max-new 16              # smoke
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --no-smoke --arch qwen3-0.6b --shared-prefix 252 --overlap
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch gemma3-12b --device cpu             # local/global, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --prompt-len 60 --max-new 40 --n-pages 33 --max-pages-per-seq 16 \\
        --host-swap-pages 64                       # preemption to host swap
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --traffic poisson --trace t.jsonl --metrics    # open loop, traced
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --disagg --faults --trace t.jsonl --metrics    # two engines, chaos
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --no-smoke --disagg --faults --trace OUT --metrics      # on the card

Counterpart of ``repro/launch/serve.py``: the closed-loop batch, the
open-loop and observability modes (``--traffic``, ``--trace``,
``--metrics``), the disaggregated topology (``--disagg``) and the fault
plane (``--faults``).  The reference's ``--legacy`` (the per-sequence
path) waits for ROADMAP.md § A15 and ``--mesh-shape`` for § A14.
``serve/engine.py`` is driven by ``serve/scheduler.py`` —
admission, chunked prefill, the fused decode horizon, eviction and
preemption — with page lifecycle through
``core/vbi/blocks.py::VBIAllocator`` and, as in the reference,
cross-request page sharing through the prefix cache
(``serve/prefix_cache.py``) on by default: ``--no-prefix-cache`` turns it
off, and it turns itself off for stacks with RING or RECURRENT layers.
``--shared-prefix N`` puts one N-token system prompt, drawn from the seed
before the prompts, in front of every request; ``--overlap`` stages the
next tick on the host while the device runs the current decode horizon.
``--host-swap-pages N`` gives the allocator a host swap tier of N pages:
a preempted request's KV (and ring frames and recurrent rows) is demoted
to host memory and restored by one device scatter instead of being
prefilled again; the launcher prints the swap traffic.  ``--n-pages`` and
``--max-pages-per-seq`` size the pool and a slot's row (by default 32
pages a slot plus the shared prefix's).
Every decoder-only arch is served: uniform, local/global and
sliding-window attention, RG-LRU and Mamba-2 recurrent layers, top-k MoE;
the launcher prints the stack's geometry (full, ring, RG-LRU and SSM
layers, the window and its ring pages).  Weights are random, drawn from
``--seed``.  ``--device`` defaults to ``cuda`` and raises when there is
no card; ``--device cpu`` serves the smoke configs on the CPU.
``--smoke``/``--no-smoke`` selects the reduced or the published width
(the reference's ``--smoke`` flag cannot be switched off; here it can).

``--traffic {poisson,bursty}`` replaces the closed-loop batch with
open-loop serving: ``--requests`` requests of a seeded mixed workload
(chat, RAG, agent, summarization; ``serve/traffic.py``) arrive at
``--rate`` requests/s on the wall clock, and the run prints TTFT and TPOT
percentiles, throughput, SLO attainment against ``--slo-ttft`` and
``--slo-tpot``, and goodput under that SLO.  ``--trace OUT`` records the
telemetry trace (request lifecycle, tick spans, every block op with its
declared properties, per-tick gauges) and checks it against the
allocator's conservation invariants on exit; ``--trace-format chrome``
writes Chrome ``trace_event`` JSON instead, and ``--metrics`` prints the
metrics-registry snapshot.  Offline: ``python -m
repro_torch.serve.telemetry OUT [--chrome OUT.json]``.

``--disagg`` serves on two engines over one set of device weights: prompts
prefill on a prefill engine of ``--prefill-slots`` slots and ``1 + slots x
(8 + shared prefix / 8)`` pages; at prompt completion each request's exact
state moves as one sealed ``BlockImage`` (one ``export_image``, one
``import_image`` scatter) to a decode engine of ``--decode-slots`` slots
and ``1 + slots x (32 + shared prefix / 8)`` pages (``--n-pages`` and
``--max-pages-per-seq`` size it instead when given) and the host tier of
``--host-swap-pages``; decode-pool pressure stalls the handoff, never
prefill.  Both pools record
into one trace.  ``--faults`` injects seeded faults at every allocator
boundary of every engine and at the decode tick (``--fault-rate`` per
crossing, ``--fault-seed``; ``--fault-model simdram:node=22`` takes the
rate from the SIMDRAM reliability model instead) and recovers each
exactly — bounded retry, exact fallback or an accounted shed; the run
prints the plan's counts and raises if a fault stays unresolved.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional

import numpy as np

from ..configs import ARCH_IDS, get_config, smoke_config
from ..models.model import init_params
from ..serve.disagg import DisaggScheduler
from ..serve.engine import PagedEngine
from ..serve.faults import plan_from_args
from ..serve.prefix_cache import PrefixCache
from ..serve.scheduler import Scheduler
from ..serve.telemetry import Telemetry, check_trace
from ..serve.traffic import LatencyAccountant, TrafficDriver, make_trace


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
        description="paged serving on the PyTorch port: a closed-loop "
                    "batch, or open-loop traffic with --traffic")
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reduced widths (default); --no-smoke serves the "
                         "published configuration")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--disagg", action="store_true",
                    help="disaggregated prefill/decode: prompts prefill on "
                         "one engine, each request's exact state hands off "
                         "as one BlockImage to a second engine for decode")
    ap.add_argument("--prefill-slots", type=int, default=6,
                    help="prefill-engine slots for --disagg")
    ap.add_argument("--decode-slots", type=int, default=3,
                    help="decode-engine slots for --disagg")
    ap.add_argument("--prefill-chunk", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=4)
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="shared system-prompt tokens prepended to every "
                         "request (exercises the prefix cache)")
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
                    help="disable cross-request KV page sharing")
    ap.add_argument("--overlap", action="store_true",
                    help="double-buffered dispatch: stage the next tick on "
                         "the host while the device runs the current "
                         "decode horizon (same tokens)")
    ap.add_argument("--host-swap-pages", type=int, default=0,
                    help="host swap tier capacity in pages (0 = off); "
                         "SWAPPABLE preemption victims demote to host "
                         "memory and resume without re-prefilling")
    ap.add_argument("--n-pages", type=int, default=None,
                    help="KV pool pages, page 0 included (default: 1 + "
                         "slots x (32 + shared prefix / 8))")
    ap.add_argument("--max-pages-per-seq", type=int, default=None,
                    help="pages in one slot's page-table row (default: "
                         "the pool split evenly over the slots)")
    ap.add_argument("--traffic", default=None,
                    choices=("poisson", "bursty"),
                    help="open-loop traffic: a seeded mixed workload "
                         "arrives at --rate req/s on the wall clock; reports "
                         "TTFT/TPOT percentiles and goodput under the SLO")
    ap.add_argument("--rate", type=float, default=2.0,
                    help="offered load for --traffic, requests per second")
    ap.add_argument("--slo-ttft", type=float, default=float("inf"),
                    help="TTFT SLO in seconds (for goodput accounting)")
    ap.add_argument("--slo-tpot", type=float, default=float("inf"),
                    help="TPOT SLO in seconds (for goodput accounting)")
    ap.add_argument("--trace", metavar="OUT", default=None,
                    help="record the telemetry trace (request lifecycle, "
                         "tick spans, block ops, per-tick gauges) and check "
                         "it on exit; offline: python -m "
                         "repro_torch.serve.telemetry OUT")
    ap.add_argument("--trace-format", default="jsonl",
                    choices=("jsonl", "chrome"),
                    help="'jsonl' (one event per line, the checker's input) "
                         "or 'chrome' (trace_event JSON for Perfetto)")
    ap.add_argument("--metrics", action="store_true",
                    help="print the metrics-registry snapshot (counters, "
                         "gauges with high-water marks, latency histograms)")
    ap.add_argument("--faults", action="store_true",
                    help="chaos mode: seeded faults at every allocator "
                         "boundary (alloc, swap I/O, image loss and "
                         "corruption) and at the decode tick, each recovered "
                         "exactly (retry, re-prefill, the degradation "
                         "ladder); tokens equal the fault-free run's")
    ap.add_argument("--fault-rate", type=float, default=0.05,
                    help="per-crossing fault probability for --faults, the "
                         "same for every class")
    ap.add_argument("--fault-seed", type=int, default=7,
                    help="seed of the rate-independent fault streams")
    ap.add_argument("--fault-model", default=None,
                    help="take the fault rate from the SIMDRAM reliability "
                         "model instead of --fault-rate, e.g. "
                         "'simdram:node=22' (implies --faults)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    return ap


def main(argv=None):
    """Run the serve (closed-loop, or open-loop with ``--traffic``) and
    return ``(finished_requests, engine, scheduler)``."""
    args = _parser().parse_args(argv)
    cfg = serve_config(args.arch, args.smoke)
    params = init_params(cfg, seed=args.seed, device=args.device)
    return serve(cfg, params, requests=args.requests, max_new=args.max_new,
                 batch_slots=args.batch_slots,
                 prefill_chunk=args.prefill_chunk,
                 prompt_len=args.prompt_len,
                 shared_prefix=args.shared_prefix,
                 decode_horizon=args.decode_horizon,
                 attn_impl=args.attn_impl,
                 prefix_cache=not args.no_prefix_cache,
                 overlap=args.overlap, host_swap_pages=args.host_swap_pages,
                 n_pages=args.n_pages,
                 max_pages_per_seq=args.max_pages_per_seq, seed=args.seed,
                 device=args.device, traffic=args.traffic, rate=args.rate,
                 slo_ttft=args.slo_ttft, slo_tpot=args.slo_tpot,
                 trace=args.trace, trace_format=args.trace_format,
                 metrics=args.metrics, disagg=args.disagg,
                 prefill_slots=args.prefill_slots,
                 decode_slots=args.decode_slots,
                 faults=args.faults or args.fault_model is not None,
                 fault_rate=args.fault_rate, fault_seed=args.fault_seed,
                 fault_model=args.fault_model)


def serve(cfg, params, *, requests: int = 6, max_new: int = 16,
          batch_slots: int = 4, prefill_chunk: int = 8, prompt_len: int = 4,
          shared_prefix: int = 0, decode_horizon: int = 8,
          attn_impl: str = "kernel", prefix_cache: bool = True,
          overlap: bool = False, host_swap_pages: int = 0,
          n_pages: Optional[int] = None,
          max_pages_per_seq: Optional[int] = None, seed: int = 0,
          device="cuda", traffic: Optional[str] = None, rate: float = 2.0,
          slo_ttft: float = float("inf"), slo_tpot: float = float("inf"),
          trace: Optional[str] = None, trace_format: str = "jsonl",
          metrics: bool = False, disagg: bool = False,
          prefill_slots: int = 6, decode_slots: int = 3,
          faults: bool = False, fault_rate: float = 0.05,
          fault_seed: int = 7, fault_model: Optional[str] = None):
    """The launcher's serve on given params (on ``device``): ``requests``
    prompts of ``shared_prefix`` system tokens (drawn first, shared by
    all) and ``prompt_len`` tokens of their own, drawn from ``seed``, each
    decoding ``max_new`` tokens, through the engine (pages of 8 tokens;
    ``n_pages`` in the pool, by default ``32 + shared_prefix // 8`` a slot;
    a host swap tier of ``host_swap_pages``) and the scheduler, with the
    prefix cache unless ``prefix_cache`` is False or the stack cannot
    share pages.  With ``traffic`` ('poisson' or 'bursty') the requests
    are instead ``make_trace``'s seeded mixed workload, arriving open-loop
    at ``rate`` per second on the wall clock.  ``trace`` (a path) records
    and checks the telemetry trace; ``metrics`` prints the registry.
    ``disagg`` serves on a prefill engine (``prefill_slots``) and a decode
    engine (``decode_slots``, ``n_pages``, the host tier) sharing
    ``params``; ``faults`` installs a seeded fault plan (``fault_rate``
    or ``fault_model``, ``fault_seed``) on every allocator.  Returns
    ``(finished_requests, engine, scheduler)``: under ``disagg`` the
    decode engine and the ``DisaggScheduler`` (its ``prefill.engine`` is
    the prefill engine)."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, cfg.vocab, shared_prefix).tolist()
    prompts = [system + rng.integers(0, cfg.vocab, prompt_len).tolist()
               for _ in range(requests)]
    page_size = 8
    slots = decode_slots if disagg else batch_slots
    if n_pages is None:
        n_pages = 1 + slots * (32 + shared_prefix // page_size)
    engine = PagedEngine(
        cfg, params, page_size=page_size, max_seqs=slots,
        n_pages=n_pages, max_pages_per_seq=max_pages_per_seq,
        attn_impl=attn_impl, host_swap_pages=host_swap_pages, device=device)
    p_eng = None
    if disagg:
        # a prompt-sized pool on many slots, on the same weights
        p_eng = PagedEngine(
            cfg, params, page_size=page_size, max_seqs=prefill_slots,
            n_pages=1 + prefill_slots * (8 + shared_prefix // page_size),
            attn_impl=attn_impl, device=device)
    geom = engine.geom
    print(f"[serve] {cfg.name} on {engine.device} — attn_impl={attn_impl}; "
          f"geometry: n_full {geom.n_full}, n_ring {geom.n_ring}, n_rg "
          f"{geom.n_rg}, n_ssm {geom.n_ssm}, window {geom.window}, ring "
          f"pages {geom.ring_pages} of {page_size} tokens")
    cache = PrefixCache(page_size=page_size) if prefix_cache else None
    if cache is not None and not engine.supports_prefix_sharing:
        print("[serve] prefix cache disabled: RING/RECURRENT layers are "
              "ineligible for cross-request page sharing")
        cache = None
    telem = (Telemetry(trace=trace is not None)
             if trace is not None or metrics else None)
    plan = None
    if faults:
        plan = plan_from_args(fault_rate, fault_seed, model=fault_model)
        print(f"[serve] chaos mode: fault rates "
              f"{ {k: f'{v:g}' for k, v in plan.rates.items()} } "
              f"seed={fault_seed}")
    if disagg:
        print(f"[serve] disagg topology: prefill {prefill_slots} slots/"
              f"{p_eng.n_pages} pages -> decode {decode_slots} slots/"
              f"{engine.n_pages} pages (BlockImage handoff)")
        sched = DisaggScheduler(p_eng, engine, prefill_chunk=prefill_chunk,
                                decode_horizon=decode_horizon,
                                overlap=overlap, prefix_cache=cache,
                                telemetry=telem, faults=plan)
    else:
        sched = Scheduler(engine, prefill_chunk=prefill_chunk,
                          prefix_cache=cache, decode_horizon=decode_horizon,
                          overlap=overlap, telemetry=telem, faults=plan)
    t0 = time.perf_counter()
    if traffic is not None:
        finished = _run_traffic(cfg, sched, traffic, requests, rate, seed,
                                slo_ttft, slo_tpot, overlap)
    else:
        for p in prompts:
            sched.add_request(p, max_new=max_new)
        finished = sched.run()
    dt = time.perf_counter() - t0
    for req in finished:
        print(f"[serve] req {req.rid} done: {req.prompt[-4:]} -> "
              f"{req.out[:8]}...")
    n_out = sum(len(r.out) for r in finished)
    if p_eng is not None:
        print(f"[serve] prefill engine stats {p_eng.stats} allocator stats "
              f"{p_eng.alloc.stats}")
        print(f"[serve] disagg stats {dict(sched.stats)} — prefill sched "
              f"{dict(sched.prefill.stats)} / decode sched "
              f"{dict(sched.decode.stats)}")
    print(f"[serve] engine stats {engine.stats} allocator stats "
          f"{engine.alloc.stats} sched stats {sched.stats}")
    if cache is not None:
        print(f"[serve] prefix cache: hit_rate={cache.hit_rate:.2f} "
              f"stats {cache.stats}")
    if engine.alloc.swap is not None:
        a = engine.alloc.stats
        print(f"[serve] host swap tier: {engine.alloc.swap.capacity_pages} "
              f"pages; preemptions {sched.stats['preemptions']}, swap-outs "
              f"{a['swap_outs']} ({a['swapped_out_pages']} pages, "
              f"{a['swap_bytes_out']} B), swap-ins {a['swap_ins']} "
              f"({a['swapped_in_pages']} pages, {a['swap_bytes_in']} B), "
              f"rejects {a['swap_rejects']}; prefill tokens "
              f"{sched.stats['prefill_tokens']}")
    if plan is not None:
        print(f"[serve] fault plan: {plan.stats}")
        if plan.stats["unresolved"]:
            raise RuntimeError(f"the chaos run left {plan.stats['unresolved']}"
                               f" injected fault(s) unresolved")
    if telem is not None:
        _emit_telemetry(telem, trace, trace_format, metrics)
    print(f"[serve] {len(finished)} requests, {n_out} generated tokens in "
          f"{dt:.3f}s on {engine.device} ({n_out / dt:.1f} tok/s)")
    return finished, engine, sched


def _run_traffic(cfg, sched, process: str, requests: int, rate: float,
                 seed: int, slo_ttft: float, slo_tpot: float,
                 overlap: bool):
    """Open-loop serving on the wall clock: requests arrive whether or not
    the engine has capacity, and the user-visible numbers are latency
    percentiles and goodput under the SLO.  Returns the finished
    requests."""
    trace = make_trace(cfg.vocab, requests, rate=rate, seed=seed,
                       process=process)
    mix = {}
    for tr in trace:
        mix[tr.profile] = mix.get(tr.profile, 0) + 1
    print(f"[serve] open-loop {process} traffic: {requests} requests @ "
          f"{rate:g} req/s, mix {mix}, overlap "
          f"{'on' if overlap else 'off'}")
    # wall clock; the latency histograms join the scheduler's registry
    drv = TrafficDriver(sched, trace,
                        accountant=LatencyAccountant(sched.metrics))
    finished = drv.run()
    s = drv.acct.summary(slo_ttft=slo_ttft, slo_tpot=slo_tpot)
    print(f"[serve] ttft p50={s['ttft_p50'] * 1e3:.1f}ms "
          f"p99={s['ttft_p99'] * 1e3:.1f}ms | "
          f"tpot p50={s['tpot_p50'] * 1e3:.1f}ms "
          f"p99={s['tpot_p99'] * 1e3:.1f}ms")
    print(f"[serve] throughput={s['throughput_req_s']:.2f}req/s "
          f"({s['throughput_tok_s']:.1f}tok/s) "
          f"slo_attainment={s['slo_attainment']:.2f} "
          f"goodput={s['goodput_req_s']:.2f}req/s")
    return finished


def _emit_telemetry(telem, trace: Optional[str], trace_format: str,
                    metrics: bool) -> None:
    """Write the recorded trace (JSONL or Chrome ``trace_event``), check
    it against the allocator's conservation invariants, and print the
    metrics snapshot when asked."""
    if telem.tracer is not None:
        rec = telem.tracer
        if trace_format == "chrome":
            rec.write_chrome(trace)
        else:
            rec.write_jsonl(trace)
        summary = check_trace(rec.events)
        print(f"[serve] trace: {len(rec.events)} events -> {trace} "
              f"({trace_format}); checker OK — {summary}")
    if metrics:
        print("[serve] metrics snapshot:")
        print(json.dumps(telem.metrics.snapshot(), indent=2, sort_keys=True))


if __name__ == "__main__":
    main()
