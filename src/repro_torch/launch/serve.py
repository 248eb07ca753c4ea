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
plane (``--faults``), and the device mesh (``--mesh-shape``,
``--kv-layout``), and the legacy per-sequence path (``--legacy``).
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

``--mesh-shape DATAxMODEL`` serves on a device mesh (``launch/mesh.py``,
``PagedEngine(mesh=)``): one process per device, each running this
launcher (``torchrun --nproc-per-node N``, which sets ``RANK``,
``WORLD_SIZE`` and the rendezvous; gloo for ``--device cpu``, nccl for
``cuda``).  The weights' FSDP dim is cut over ``data`` and their heads,
hidden and vocab dims over ``model``; each rank runs its block of the
slots over ``data`` and gathers the new K/V and recurrent rows whole
before they reach the pools.  The pools shard over ``model``
(``--kv-layout shard``) or stay whole on every rank (``replicate``);
over ``data`` they are always whole, and the page table, allocator and
scheduler are host-global, the same on every rank.  On any mesh of more
than one device attention takes the plain batched path (``--attn-impl``
defaults to ``gather`` there; the kernel is refused, as in the
reference); MoE layers dispatch expert-parallel over ``model``
(``distributed/moe_ep.py``); ``--kv-layout auto`` (the default) keeps
``shard`` on a 1-wide ``model`` axis and on a wider one traces a token
step under both layouts on meta and keeps the one that moves fewer
collective bytes (``serve/engine.py::pick_layout``).  Both ``--disagg``
engines get the mesh and share one cut tree of weights.  On a mesh of
more than one device the weights are drawn on the host and each rank
copies only its blocks to its device (``shard_params``), so the device
never holds the whole model; the draws are then the CPU generator's,
which on ``--device cuda`` differ from a one-card run's.  Only rank 0
prints and writes ``--trace``; the run prints the mesh, its layout and
placement, and the collectives each rank made.

``--legacy`` serves the same prompts through the per-sequence oracle
(``serve/paged.py::PagedServer``: one token of every active request per
call, per-sequence K/V writes, the paged-attention kernel on the card),
``--batch-slots`` slots on ``1 + slots x 32`` pages of 8 tokens; its
generations equal the engine's token for token at the same seed.  It
serves uniform dense GQA stacks only and refuses every flag that needs
the engine (``--traffic``, ``--overlap``, ``--trace``, ``--metrics``,
``--disagg``, ``--faults``, ``--fault-model``, ``--mesh-shape``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..configs import ARCH_IDS, get_config, smoke_config
from ..distributed.sharding import shard_params
from ..launch.mesh import init_distributed, make_host_mesh
from ..models.model import init_params
from ..serve.disagg import DisaggScheduler
from ..serve.engine import PagedEngine
from ..serve.faults import plan_from_args
from ..serve.prefix_cache import PrefixCache
from ..serve.paged import PagedServer
from ..serve.scheduler import Request, Scheduler
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
    ap.add_argument("--attn-impl", default=None,
                    choices=("gather", "kernel"),
                    help="'kernel' (default): the hand-written CUDA kernel "
                         "on the card, its plain twin on the CPU; 'gather': "
                         "the plain batched twin (CPU only, and the default "
                         "and only choice on a mesh of more than one "
                         "device)")
    ap.add_argument("--mesh-shape", default=None, metavar="DATAxMODEL",
                    help="serve on a device mesh, e.g. '1x4' = 4-way "
                         "'model'-axis sharding, '2x2' = 2 'data' ranks of 2 "
                         "'model' ranks: one process per device (torchrun "
                         "--nproc-per-node DATA*MODEL); each 'data' rank "
                         "runs its block of the slots on weights FSDP-cut "
                         "over 'data'; KV pools, ring frames and recurrent "
                         "state shard over 'model' and are whole over "
                         "'data'; the page table, allocator and scheduler "
                         "stay host-global")
    ap.add_argument("--kv-layout", default="auto",
                    choices=("auto", "shard", "replicate"),
                    help="pool layout on the mesh: 'shard' over 'model' or "
                         "'replicate' on every rank ('auto': the layout a "
                         "traced token step counts fewer collective bytes "
                         "for; 'shard' on a 1-wide 'model' axis)")
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
    ap.add_argument("--legacy", action="store_true",
                    help="per-sequence reference path (serve/paged.py)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    return ap


def main(argv=None):
    """Run the serve (closed-loop, or open-loop with ``--traffic``) and
    return ``(finished_requests, engine, scheduler)``; under ``--legacy``
    ``(finished_requests, PagedServer, None)``."""
    ap = _parser()
    args = ap.parse_args(argv)
    if args.legacy and (args.traffic or args.overlap):
        ap.error("--traffic/--overlap need the engine path (drop --legacy)")
    if args.legacy and (args.trace or args.metrics):
        ap.error("--trace/--metrics need the engine path (drop --legacy)")
    if args.legacy and args.disagg:
        ap.error("--disagg needs the engine path (drop --legacy)")
    if args.legacy and (args.faults or args.fault_model):
        ap.error("--faults needs the VBI allocator boundaries "
                 "(drop --legacy)")
    if args.legacy and args.mesh_shape is not None:
        ap.error("--mesh-shape needs the engine path (drop --legacy)")
    mesh, device = None, args.device
    attn_impl = args.attn_impl or "kernel"
    if args.mesh_shape is not None:
        try:
            data, model = (int(x) for x in args.mesh_shape.split("x"))
        except ValueError:
            ap.error(f"--mesh-shape must look like '1x4', got "
                     f"{args.mesh_shape!r}")
        if data * model > 1:
            if args.attn_impl == "kernel":
                ap.error("--attn-impl kernel is not supported on a mesh of "
                         "more than one device: the paged-attention kernel "
                         "assumes a single-device page pool and slot batch. "
                         "Use --attn-impl gather, or --mesh-shape 1x1.")
            attn_impl = "gather"
            # every rank of `torchrun --nproc-per-node N` runs this
            try:
                device = init_distributed(args.device)
            except RuntimeError as e:
                ap.error(f"--mesh-shape {args.mesh_shape} runs "
                         f"{data * model} processes, one per device: {e}")
            if dist.get_world_size() != data * model:
                ap.error(f"--mesh-shape {args.mesh_shape} needs "
                         f"{data * model} processes but "
                         f"{dist.get_world_size()} were launched: use "
                         f"torchrun --nproc-per-node {data * model}")
        mesh = make_host_mesh(data, model, device=str(device))
    cfg = serve_config(args.arch, args.smoke)
    if args.legacy and (cfg.family not in ("dense", "vlm")
                        or cfg.local_global_period or cfg.rglru_period
                        or cfg.window):
        ap.error(f"--legacy (serve/paged.py) only supports uniform dense "
                 f"GQA stacks; {cfg.name} needs the property-typed engine "
                 f"(drop --legacy)")
    if args.legacy:
        params = init_params(cfg, seed=args.seed, device=device)
        t0 = time.perf_counter()
        finished, srv = _run_legacy(
            cfg, params, _prompts(cfg, args.requests, args.prompt_len,
                                  args.shared_prefix, args.seed),
            args.batch_slots, args.max_new, device)
        dt = time.perf_counter() - t0
        n_out = sum(len(r.out) for r in finished)
        print(f"[serve] {len(finished)} requests, {n_out} generated tokens "
              f"in {dt:.3f}s on {srv.device} ({n_out / dt:.1f} tok/s, "
              f"legacy)")
        return finished, srv, None
    if mesh is not None and mesh.size > 1:
        # drawn on the host, so the card holds only this rank's blocks
        params = shard_params(cfg, init_params(cfg, seed=args.seed,
                                               device="cpu"), mesh, device)
    else:
        params = init_params(cfg, seed=args.seed, device=device)
    return serve(cfg, params, requests=args.requests, max_new=args.max_new,
                 batch_slots=args.batch_slots,
                 prefill_chunk=args.prefill_chunk,
                 prompt_len=args.prompt_len,
                 shared_prefix=args.shared_prefix,
                 decode_horizon=args.decode_horizon,
                 attn_impl=attn_impl,
                 prefix_cache=not args.no_prefix_cache,
                 overlap=args.overlap, host_swap_pages=args.host_swap_pages,
                 n_pages=args.n_pages,
                 max_pages_per_seq=args.max_pages_per_seq, seed=args.seed,
                 device=device, traffic=args.traffic, rate=args.rate,
                 slo_ttft=args.slo_ttft, slo_tpot=args.slo_tpot,
                 trace=args.trace, trace_format=args.trace_format,
                 metrics=args.metrics, disagg=args.disagg,
                 prefill_slots=args.prefill_slots,
                 decode_slots=args.decode_slots,
                 faults=args.faults or args.fault_model is not None,
                 fault_rate=args.fault_rate, fault_seed=args.fault_seed,
                 fault_model=args.fault_model, mesh=mesh,
                 kv_layout=args.kv_layout)


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
          fault_seed: int = 7, fault_model: Optional[str] = None,
          mesh=None, kv_layout: str = "auto"):
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
    or ``fault_model``, ``fault_seed``) on every allocator.  ``mesh`` and
    ``kv_layout`` serve on a device mesh (every engine; only rank 0 prints
    and writes the trace).  Returns ``(finished_requests, engine,
    scheduler)``: under ``disagg`` the decode engine and the
    ``DisaggScheduler`` (its ``prefill.engine`` is the prefill engine)."""
    rank0 = mesh is None or mesh.rank == 0
    echo: Callable = print if rank0 else (lambda *a, **k: None)
    prompts = _prompts(cfg, requests, prompt_len, shared_prefix, seed)
    page_size = 8
    slots = decode_slots if disagg else batch_slots
    if n_pages is None:
        n_pages = 1 + slots * (32 + shared_prefix // page_size)
    engine = PagedEngine(
        cfg, params, page_size=page_size, max_seqs=slots,
        n_pages=n_pages, max_pages_per_seq=max_pages_per_seq,
        attn_impl=attn_impl, host_swap_pages=host_swap_pages, device=device,
        mesh=mesh, kv_layout=kv_layout)
    p_eng = None
    if disagg:
        # a prompt-sized pool on many slots, on the same weights
        p_eng = PagedEngine(
            cfg, params, page_size=page_size, max_seqs=prefill_slots,
            n_pages=1 + prefill_slots * (8 + shared_prefix // page_size),
            attn_impl=attn_impl, device=device, mesh=mesh,
            kv_layout=kv_layout)
    geom = engine.geom
    echo(f"[serve] {cfg.name} on {engine.device} — attn_impl={attn_impl}; "
          f"geometry: n_full {geom.n_full}, n_ring {geom.n_ring}, n_rg "
          f"{geom.n_rg}, n_ssm {geom.n_ssm}, window {geom.window}, ring "
          f"pages {geom.ring_pages} of {page_size} tokens")
    if mesh is not None:
        echo(f"[serve] mesh {dict(mesh.shape)}: kv_layout="
             f"{engine.kv_layout}, placement={engine.placement}")
        if engine.layout_report is not None:
            echo(f"[serve] layout probe: {engine.layout_report}")
        mesh.reset_collectives()
    cache = PrefixCache(page_size=page_size) if prefix_cache else None
    if cache is not None and not engine.supports_prefix_sharing:
        echo("[serve] prefix cache disabled: RING/RECURRENT layers are "
              "ineligible for cross-request page sharing")
        cache = None
    telem = (Telemetry(trace=trace is not None)
             if trace is not None or metrics else None)
    plan = None
    if faults:
        plan = plan_from_args(fault_rate, fault_seed, model=fault_model)
        echo(f"[serve] chaos mode: fault rates "
              f"{ {k: f'{v:g}' for k, v in plan.rates.items()} } "
              f"seed={fault_seed}")
    if disagg:
        echo(f"[serve] disagg topology: prefill {prefill_slots} slots/"
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
                                slo_ttft, slo_tpot, overlap, echo)
    else:
        for p in prompts:
            sched.add_request(p, max_new=max_new)
        finished = sched.run()
    dt = time.perf_counter() - t0
    for req in finished:
        echo(f"[serve] req {req.rid} done: {req.prompt[-4:]} -> "
              f"{req.out[:8]}...")
    n_out = sum(len(r.out) for r in finished)
    if p_eng is not None:
        echo(f"[serve] prefill engine stats {p_eng.stats} allocator stats "
              f"{p_eng.alloc.stats}")
        echo(f"[serve] disagg stats {dict(sched.stats)} — prefill sched "
              f"{dict(sched.prefill.stats)} / decode sched "
              f"{dict(sched.decode.stats)}")
    echo(f"[serve] engine stats {engine.stats} allocator stats "
          f"{engine.alloc.stats} sched stats {sched.stats}")
    if cache is not None:
        echo(f"[serve] prefix cache: hit_rate={cache.hit_rate:.2f} "
              f"stats {cache.stats}")
    if engine.alloc.swap is not None:
        a = engine.alloc.stats
        echo(f"[serve] host swap tier: {engine.alloc.swap.capacity_pages} "
              f"pages; preemptions {sched.stats['preemptions']}, swap-outs "
              f"{a['swap_outs']} ({a['swapped_out_pages']} pages, "
              f"{a['swap_bytes_out']} B), swap-ins {a['swap_ins']} "
              f"({a['swapped_in_pages']} pages, {a['swap_bytes_in']} B), "
              f"rejects {a['swap_rejects']}; prefill tokens "
              f"{sched.stats['prefill_tokens']}")
    if plan is not None:
        echo(f"[serve] fault plan: {plan.stats}")
        if plan.stats["unresolved"]:
            raise RuntimeError(f"the chaos run left {plan.stats['unresolved']}"
                               f" injected fault(s) unresolved")
    if telem is not None:
        _emit_telemetry(telem, trace, trace_format, metrics, rank0)
    if mesh is not None:
        echo(f"[serve] mesh collectives (rank 0, this run): "
             f"{mesh.collectives}")
    echo(f"[serve] {len(finished)} requests, {n_out} generated tokens in "
          f"{dt:.3f}s on {engine.device} ({n_out / dt:.1f} tok/s)")
    return finished, engine, sched


def _prompts(cfg, requests: int, prompt_len: int, shared_prefix: int,
             seed: int):
    """The closed-loop prompts: one ``shared_prefix``-token system prompt
    drawn from ``seed`` first, then ``prompt_len`` tokens per request."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, cfg.vocab, shared_prefix).tolist()
    return [system + rng.integers(0, cfg.vocab, prompt_len).tolist()
            for _ in range(requests)]


def _run_legacy(cfg, params, prompts, batch_slots: int, max_new: int,
                device):
    """The reference's legacy loop: admit into free slots, feed each
    active request one token per call (its prompt, then its own greedy
    tokens), evict when ``max_new`` are out.  Returns (finished requests
    in finishing order, the server)."""
    srv = PagedServer(cfg, params, n_pages=1 + batch_slots * 32,
                      page_size=8, max_seqs=batch_slots, device=device)
    pending = [Request(i, p, max_new) for i, p in enumerate(prompts)]
    active, fed, finished = {}, {}, []
    while pending or active:
        while pending and len(active) < batch_slots:
            slot = next(s for s in range(batch_slots) if s not in active)
            srv.admit(slot)
            active[slot], fed[slot] = pending.pop(0), 0
        slots = sorted(active)
        toks = [active[s].tokens[fed[s]] for s in slots]
        logits = srv.decode(torch.tensor(toks, dtype=torch.int32)[:, None],
                            slots)
        nxt = logits[:, 0].argmax(-1).tolist()
        for i, s in enumerate(slots):
            req = active[s]
            fed[s] += 1
            if fed[s] >= len(req.prompt):
                req.out.append(int(nxt[i]))
            if len(req.out) >= req.max_new:
                srv.evict(s)
                finished.append(active.pop(s))
                print(f"[serve] req {req.rid} done: {req.prompt} -> "
                      f"{req.out[:8]}...")
    print(f"[serve] legacy VBI stats {srv.kv.stats}")
    return finished, srv


def _run_traffic(cfg, sched, process: str, requests: int, rate: float,
                 seed: int, slo_ttft: float, slo_tpot: float,
                 overlap: bool, echo: Callable = print):
    """Open-loop serving on the wall clock: requests arrive whether or not
    the engine has capacity, and the user-visible numbers are latency
    percentiles and goodput under the SLO.  Returns the finished
    requests."""
    trace = make_trace(cfg.vocab, requests, rate=rate, seed=seed,
                       process=process)
    mix = {}
    for tr in trace:
        mix[tr.profile] = mix.get(tr.profile, 0) + 1
    echo(f"[serve] open-loop {process} traffic: {requests} requests @ "
          f"{rate:g} req/s, mix {mix}, overlap "
          f"{'on' if overlap else 'off'}")
    # wall clock; the latency histograms join the scheduler's registry
    drv = TrafficDriver(sched, trace,
                        accountant=LatencyAccountant(sched.metrics))
    finished = drv.run()
    s = drv.acct.summary(slo_ttft=slo_ttft, slo_tpot=slo_tpot)
    echo(f"[serve] ttft p50={s['ttft_p50'] * 1e3:.1f}ms "
          f"p99={s['ttft_p99'] * 1e3:.1f}ms | "
          f"tpot p50={s['tpot_p50'] * 1e3:.1f}ms "
          f"p99={s['tpot_p99'] * 1e3:.1f}ms")
    echo(f"[serve] throughput={s['throughput_req_s']:.2f}req/s "
          f"({s['throughput_tok_s']:.1f}tok/s) "
          f"slo_attainment={s['slo_attainment']:.2f} "
          f"goodput={s['goodput_req_s']:.2f}req/s")
    return finished


def _emit_telemetry(telem, trace: Optional[str], trace_format: str,
                    metrics: bool, rank0: bool = True) -> None:
    """Write the recorded trace (JSONL or Chrome ``trace_event``), check
    it against the allocator's conservation invariants, and print the
    metrics snapshot when asked.  On a mesh only rank 0 writes and
    prints; every rank checks its trace."""
    echo: Callable = print if rank0 else (lambda *a, **k: None)
    if telem.tracer is not None:
        rec = telem.tracer
        if rank0:
            if trace_format == "chrome":
                rec.write_chrome(trace)
            else:
                rec.write_jsonl(trace)
        summary = check_trace(rec.events)
        echo(f"[serve] trace: {len(rec.events)} events -> {trace} "
              f"({trace_format}); checker OK — {summary}")
    if metrics:
        echo("[serve] metrics snapshot:")
        echo(json.dumps(telem.metrics.snapshot(), indent=2, sort_keys=True))


if __name__ == "__main__":
    main()
