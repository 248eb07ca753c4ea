"""Continuous-batching scheduler over the PagedEngine (host policy;
counterpart of ``repro/serve/scheduler.py``).

The device owns translation and allocation mechanics (``core/vbi/
kvcache.py``), the VBIAllocator (``core/vbi/blocks.py``) owns the memory
interface — every page-lifecycle mutation (reserve, share, COW, custody,
release) — and this module owns policy only: which request, which slot,
which victim, when.  The host never reads device state on the token path;
the allocator mirrors page accounting arithmetically.

Policies:

  * **admission** — a queued request is admitted when a slot is free and
    the allocator's mirrored budget covers its prompt plus its first decode
    horizon (falling back to one decode page); the budget is reserved at
    admission, so concurrent prefills never oversubscribe the device free
    stack.  With a :class:`~repro_torch.serve.prefix_cache.PrefixCache`
    attached, admission first maps the longest cached prefix read-only
    (no recompute), COW-clones a partially matching page, and budgets
    only the uncached suffix;
  * **chunked prefill** — admitted prompts are fed ``prefill_chunk``
    tokens per engine call, ragged across slots; finished prompts hand
    their full pages to the prefix cache (custody moves through the
    allocator — the mirror stays exact).  The next-token argmax runs on
    the device and the host reads the [S] int32 only on chunks where some
    slot finished its prompt;
  * **the decode horizon** — decoding slots advance up to
    ``decode_horizon`` tokens per ``PagedEngine.decode_many`` call with
    sampling, feedback and stopping on the device, and the host reads the
    ``[K, S]`` token block once per horizon.  The worst-case span is
    reserved through the allocator first; under pressure cold cached
    prefixes are evicted, then the horizon is truncated, before anything
    is preempted; commits/unreserves are reconciled from the returned
    block;
  * **eviction** — finished requests free their block; the device frees
    only refcount-zero pages, so cached prompt pages survive.  Cold cached
    prefixes are evicted LRU when admission or decode needs pages;
  * **preemption** — if a decode horizon cannot be covered even at K=1,
    the youngest running non-PINNED request is preempted and re-enters
    the queue head with its generated tokens.  The victim's declared
    properties pick the placement: a SWAPPABLE block whose full-span
    restore budget fits the pool is demoted to the allocator's host swap
    tier and re-admitted, into any free slot, by ``swap_in`` — one device
    scatter restores its exact KV (and ring frames and recurrent rows),
    with no re-prefill.  Otherwise its fed prefix is offered to the prefix
    cache and its pages are discarded, to be restored from the cache and
    re-prefilled on re-admission (greedy decode makes both exact);
  * **double-buffered dispatch** (``overlap=True``) — the horizon-N token
    block is left in flight at the end of the tick and read at the start
    of the next, after admission (slot and span reservation, prefix-cache
    lookup, map and COW) and the next prefill chunk's host staging, which
    all run while the device still computes horizon N.  Staging only
    charges the allocator's host mirror and only touches slots outside the
    in-flight decode set, so the reconciliation at the deferred read is
    the non-overlapped one: per-request tokens are equal with overlap on
    or off.

Host staging: every tick builds fresh numpy buffers and copies each into a
fresh device tensor (``device.py::stage``: on CUDA through a fresh pinned
buffer, without waiting on the device), so no in-flight transfer can read
a buffer the host refills on the next tick.

Streaming: ``on_tokens(req, n_new)`` fires whenever host-visible tokens
are appended to a request (the first token at prefill finish, up to K at
each horizon read) and ``on_finish(req)`` at eviction — the hooks the
open-loop traffic driver (``serve/traffic.py``) timestamps for TTFT and
TPOT, closed-loop or open-loop alike.

Telemetry (``telemetry=``, a :class:`~repro_torch.serve.telemetry.
Telemetry`): counters always live in a metrics registry (``stats`` is a
dict-compatible :class:`~repro_torch.serve.telemetry.StatsView` over it);
with a bundle passed in, the engine's counters join the registry, each
tick ends with a gauge sample, and a trace recorder, if the bundle has
one, receives tick spans, request events and the allocator's block
events.  Recording only appends to lists and reads host mirrors and
``time.perf_counter``: it adds no host sync and changes no decision.

The fault plane (``faults=``, a :class:`~repro_torch.serve.faults.
FaultPlan`, installed on the allocator): every allocator boundary the
scheduler crosses — the admission reserve, swap-in, ``import_image``,
swap-out, the horizon reserve and the prefill-chunk reserve — runs under
the bounded retry of ``retry=`` (a :class:`~repro_torch.serve.recovery.
RetryPolicy`; backoff accounted, never slept), and an exhausted retry
takes an exact fallback: shrink the horizon to 1 for ``DEGRADE_TICKS``
ticks then load-shed one queued request (``shed_policy``, ``on_shed``),
re-prefill, discard, skip the slot's horizon, or stall its prefill chunk.
The ``decode_tick`` class fires and is resolved before a horizon is
planned, so nothing is ever dispatched twice.  Every fault and its
resolution land in the trace, which the checker replays.

Disaggregation: ``handoff(req, block)`` is called at eviction; when it
returns True the hook took custody (it exported the block as a
``BlockImage``) and the request continues on another engine.  A request
carrying an ``image`` is admitted by ``import_image`` — one staged device
scatter, no re-prefill — so it can be admitted under the overlap's
in-flight horizon.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.vbi.address_space import VBProps
from ..core.vbi.blocks import (DEFAULT_BLOCK_PROPS, ImageIntegrityError,
                               VirtualBlock)
from ..core.vbi.kvcache import tier_nbytes
from ..device import stage
from .engine import PagedEngine
from .faults import install_faults
from .prefix_cache import PrefixCache, PrefixMatch, _Node
from .recovery import RetryExhausted, RetryPolicy, retry_call
from .telemetry import MetricsRegistry, StatsView, Telemetry

#: ``Scheduler.stats`` keys, pinned (the reference's): the dict-compatible
#: face over the registry's ``sched.*`` counters
_STAT_KEYS = ("preemptions", "steps", "prefix_hits",
              "prefix_tokens_reused", "cache_evicted_pages", "swap_outs",
              "swap_ins", "prefill_tokens", "host_syncs",
              "prefill_host_reads", "prefill_reads_skipped",
              "horizon_truncations", "overlap_staged_ticks",
              "sync_device_ready", "sync_device_wait", "image_imports",
              "fault_retries", "fault_fallbacks", "fault_sheds",
              "horizon_shrinks", "decode_tick_retries")

#: ticks the degradation ladder holds the horizon at 1 after an
#: admission-path retry exhaustion, before restoring ``decode_horizon``;
#: a second exhaustion inside the window escalates to load-shedding
DEGRADE_TICKS = 8


def check_request_fits(engine: PagedEngine, alloc, prompt_len: int,
                       max_new: int, shareable_pages: int = 0) -> None:
    """Intake impossibility check, shared by the unified scheduler and the
    disaggregated topology (which checks against the decode engine, where
    the request's full lifetime lives): refuse now what no schedule could
    ever place.  Only full-attention layers consume pool pages, so the
    checks bind only when the stack has any."""
    if not engine.has_full:
        return
    lifetime = prompt_len + max_new
    # the lifetime must fit one slot's page-table row
    cap = engine.max_pages * engine.page_size
    if lifetime > cap:
        raise ValueError(
            f"request needs {lifetime} tokens > per-slot capacity "
            f"{cap} (max_pages_per_seq={engine.max_pages} × "
            f"page_size={engine.page_size})")
    # ... and its page budget must fit the pool at all.  Pages the prefix
    # cache could share cut the budget, so only reject what no amount of
    # sharing can save (full prompt pages shareable at best).
    pool = engine.n_pages - 1
    min_budget = alloc.pages_for(lifetime) + 1 - shareable_pages
    if min_budget > pool:
        raise ValueError(
            f"request needs {min_budget} pages over its lifetime > "
            f"pool capacity {pool} (n_pages={engine.n_pages} "
            f"incl. null page) — it can never be scheduled")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    preemptions: int = 0
    # a block demoted to the host swap tier at preemption rides along here
    # and is restored (swap_in) at re-admission
    block: Optional[VirtualBlock] = None
    # an exported BlockImage riding a disaggregated handoff (or a crash
    # recovery): admission adopts it by import_image instead of prefilling
    image: Optional[object] = None

    @property
    def tokens(self) -> List[int]:
        return self.prompt + self.out


@dataclasses.dataclass
class _SlotState:
    req: Request
    block: VirtualBlock
    prefill_len: int        # tokens to prefill (snapshot at admission)
    fed: int = 0            # tokens written/mapped into the KV so far
    admit_seq: int = 0      # admission order (preemption picks the youngest)
    inserted: bool = False  # prompt pages already offered to the cache
    pinned: List[_Node] = dataclasses.field(default_factory=list)

    @property
    def prefilling(self) -> bool:
        return self.fed < self.prefill_len


class Scheduler:
    def __init__(self, engine: PagedEngine, prefill_chunk: int = 8,
                 prefix_cache: Optional[PrefixCache] = None,
                 block_props: VBProps = DEFAULT_BLOCK_PROPS,
                 decode_horizon: int = 1, overlap: bool = False,
                 on_tokens=None, on_finish=None,
                 telemetry: Optional[Telemetry] = None,
                 handoff=None, faults=None,
                 retry: Optional[RetryPolicy] = None):
        if prefix_cache is not None:
            if prefix_cache.page_size != engine.page_size:
                raise ValueError(
                    f"prefix cache page_size {prefix_cache.page_size} != "
                    f"engine page_size {engine.page_size}")
            # RING frames are position-recycled and RECURRENT state is not
            # page-addressed: neither survives outside its slot, so
            # cross-request page sharing exists only for uniform
            # full-attention stacks
            if not engine.supports_prefix_sharing:
                raise ValueError(
                    f"{engine.cfg.name}: prefix cache requires a uniform "
                    f"full-attention stack (RING/RECURRENT layers are "
                    f"ineligible for sharing)")
        if decode_horizon < 1:
            raise ValueError("decode_horizon must be >= 1")
        self.engine = engine
        self.alloc = engine.alloc          # the one memory API
        self.prefill_chunk = prefill_chunk
        self.prefix_cache = prefix_cache
        self.block_props = block_props
        self.decode_horizon = decode_horizon
        self.overlap = overlap
        self.on_tokens = on_tokens        # streaming hooks (serve/traffic.py)
        self.on_finish = on_finish
        # the disaggregation hook: called at eviction with (req, block);
        # True means the hook took custody (the request continues on
        # another engine) — not finished here
        self.handoff = handoff
        self.queue: Deque[Request] = deque()
        self.slots: Dict[int, _SlotState] = {}
        self.finished: List[Request] = []
        self._next_rid = 0
        self._admit_seq = 0
        # the fault plane: the plan interposes on the allocator's
        # boundaries; this scheduler owns retry and fallback policy, the
        # degradation ladder (horizon -> 1 before shedding) and the
        # decode-tick fault class.  faults=None costs one check per site
        self.faults = faults
        self.retry = retry or RetryPolicy()
        self._degrade_until = 0            # tick the horizon cap lifts at
        self.shed_policy = None            # callable(queued) -> victim
        self.on_shed = None                # streaming hook (traffic.py)
        self.shed: List[Request] = []
        if faults is not None:
            install_faults(self.alloc, faults)
        # the in-flight horizon (overlap mode): the un-read [K, S] device
        # token block, the event recorded at its dispatch, and the slot ids
        # and per-slot step budgets it was dispatched with, reconciled at
        # the NEXT tick's read
        self._pending: Optional[tuple] = None
        # telemetry: counters always live in a registry; the engine's
        # counters, the gauge sample and the tracer only with a bundle
        self.telemetry = telemetry
        self.metrics = (telemetry.metrics if telemetry is not None
                        else MetricsRegistry())
        self.tracer = telemetry.tracer if telemetry is not None else None
        self.stats = StatsView(self.metrics, prefix="sched.",
                               keys=_STAT_KEYS)
        if telemetry is not None:
            engine.attach_metrics(self.metrics)
        if self.tracer is not None:
            self.alloc.attach_tracer(self.tracer)
            self.tracer.meta(
                model=engine.cfg.name, decode_horizon=decode_horizon,
                overlap=overlap, prefill_chunk=prefill_chunk,
                tier_nbytes=tier_nbytes(engine.state))

    def _to_device(self, buf: np.ndarray) -> torch.Tensor:
        """A fresh device tensor holding a copy of ``buf`` (the host may
        refill ``buf`` as soon as this returns)."""
        return stage(buf, self.engine.device)

    # -- telemetry emit sites (each one `is None` check when disabled) -------
    def _span(self, name: str, **args):
        """Tick-timeline span context (a no-op without a trace recorder):
        reads ``time.perf_counter`` only, never the device."""
        if self.tracer is None:
            return contextlib.nullcontext({})
        return self.tracer.span(name, tick=self.stats["steps"], **args)

    def _req_ev(self, ev: str, req: Request, **fields) -> None:
        if self.tracer is not None:
            self.tracer.req_event(ev, req.rid, **fields)

    def _sample_gauges(self) -> None:
        """End-of-tick gauge sample: pool occupancy, host-swap traffic,
        slot usage per tier, prefix-cache share depth.  Every value comes
        from a host mirror (``alloc.free_pages``, never the engine's
        ``free_pages``, which reads the device), so the sample adds no
        sync.  The ``alloc.free_pages`` and ``swap.pages_used`` names are
        load-bearing: the offline checker holds each sample against its
        replay."""
        if self.telemetry is None:
            return
        al, geom = self.alloc, self.engine.geom
        a_stats = al.stats
        n_pre = sum(1 for st in self.slots.values() if st.prefilling)
        used = self.engine.n_pages - 1 - al.free_pages
        vals = {
            "alloc.free_pages": al.free_pages,
            "alloc.pages_used": used,
            "swap.pages_used": al.swap.used_pages if al.swap else 0,
            "swap.bytes_held": al.swap.bytes_held if al.swap else 0,
            "swap.bytes_out": a_stats.get("swap_bytes_out", 0),
            "swap.bytes_in": a_stats.get("swap_bytes_in", 0),
            "slots.active": len(self.slots),
            "slots.prefilling": n_pre,
            "slots.decoding": len(self.slots) - n_pre,
            "queue.depth": len(self.queue),
            "tier.ring_slots": len(self.slots) if geom.n_ring else 0,
            "tier.recurrent_slots": (len(self.slots)
                                     if geom.n_recurrent else 0),
            "cache.pages": (self.prefix_cache.n_pages
                            if self.prefix_cache else 0),
            "cache.pinned_pages": (
                self.prefix_cache.n_pages
                - self.prefix_cache.evictable_pages
                if self.prefix_cache else 0),
        }
        # the pool's used page slots, per device of its placement set
        for dev in al.placement:
            vals[f"placement.{dev}.pages_used"] = used
        for k, v in vals.items():
            self.metrics.gauge(k).set(v)
        if self.tracer is not None:
            self.tracer.gauge_sample(self.stats["steps"], vals)

    # -- request intake ------------------------------------------------------
    def add_request(self, prompt: List[int], max_new: int,
                    rid: Optional[int] = None) -> int:
        shareable = (len(prompt) // self.engine.page_size
                     if self.prefix_cache is not None else 0)
        check_request_fits(self.engine, self.alloc, len(prompt), max_new,
                           shareable_pages=shareable)
        rid = self._next_rid if rid is None else rid
        self._next_rid = max(self._next_rid, rid) + 1
        req = Request(rid, list(prompt), max_new)
        self.queue.append(req)
        # the arrive event carries the prompt itself (the reference's
        # trace doubles as the crash-recovery journal)
        self._req_ev("arrive", req, prompt_len=len(prompt), max_new=max_new,
                     prompt=list(prompt))
        return rid

    # -- fault plane: retry, degradation ladder, shedding -------------------
    @property
    def effective_horizon(self) -> int:
        """``decode_horizon``, unless the degradation ladder is holding
        the engine at K=1 after an admission-path retry exhaustion."""
        if self.stats["steps"] < self._degrade_until:
            return 1
        return self.decode_horizon

    def _call_vbi(self, fn):
        """One allocator boundary op under the bounded-retry policy:
        transient injected faults are retried (backoff recorded, never
        slept) and resolved ``retry_ok``; exhaustion raises
        :class:`~repro_torch.serve.recovery.RetryExhausted` to the site's
        fallback.  Without a fault plan this is exactly ``fn()``."""
        if self.faults is None:
            return fn()
        out, fired = retry_call(fn, policy=self.retry)
        if fired:
            self.faults.resolve(fired, "retry_ok", tracer=self.tracer,
                                attempts=len(fired),
                                backoff=sum(f.backoff for f in fired))
            self.stats["fault_retries"] += len(fired)
        return out

    def _resolve_fallback(self, faults, detail: str) -> None:
        """Close out exhausted or terminal faults whose recovery is an
        exact fallback (skip, discard, re-prefill)."""
        faults = [f for f in (faults or []) if f is not None]
        if self.faults is not None and faults:
            self.faults.resolve(faults, "fallback", tracer=self.tracer,
                                detail=detail)
            self.stats["fault_fallbacks"] += len(faults)

    def _fault_fallback_admit(self, faults) -> None:
        """The degradation ladder for an admission-path retry exhaustion:
        first hold the decode horizon at 1 for ``DEGRADE_TICKS`` ticks
        (frees span headroom, keeps every request); a second exhaustion
        inside the window load-sheds one queued request.  The request at
        the queue head stays there in the shrink case and tries again next
        tick with fresh draws."""
        if self.stats["steps"] >= self._degrade_until:
            self._degrade_until = self.stats["steps"] + DEGRADE_TICKS
            self.stats["horizon_shrinks"] += 1
            self._resolve_fallback(faults, detail="horizon_shrink")
        else:
            self._shed_one(faults)

    def _shed_one(self, faults) -> None:
        """Load-shed one queued request — the ladder's last rung.  The
        victim comes from ``shed_policy`` (the traffic driver installs the
        SLO-aware one) or is the queue head; its block or image custody is
        released, and the shed is accounted in the trace (``recover``
        outcome ``shed`` and a ``shed`` request event), never silent."""
        victim = (self.shed_policy(list(self.queue)) if self.shed_policy
                  else self.queue[0])
        self.queue.remove(victim)
        if victim.block is not None:
            self.alloc.free(victim.block)
            victim.block = None
        if victim.image is not None:
            self.alloc.drop_image(victim.image)
            victim.image = None
        self.shed.append(victim)
        self.stats["fault_sheds"] += 1
        if self.faults is not None and faults:
            self.faults.resolve(faults, "shed", tracer=self.tracer,
                                rid=victim.rid)
        self._req_ev("shed", victim, n_out=len(victim.out))
        if self.on_shed is not None:
            self.on_shed(victim)

    # -- page budgeting (delegated to the allocator's host mirror) -----------
    def _budget_for(self, req: Request, n_shared: int = 0,
                    horizon: int = 1) -> int:
        """Current span extended by the decode horizon (capped at what the
        request can still generate), plus one page of headroom, less the
        pages mapped from the prefix cache (not the block's to allocate).
        ``horizon=1`` is the minimum viable budget."""
        if not self.engine.has_full:
            return 0
        rem = max(1, req.max_new - len(req.out))
        span = len(req.tokens) + min(horizon, rem) - 1
        return self.alloc.pages_for(span) + 1 - n_shared

    def _degraded_budget(self, req: Request, n_shared: int = 0) -> int:
        """Admission budget: the full-horizon span first (evicting cold
        cache on shortfall); if it still does not fit, the minimum viable
        budget — the first horizon gets truncated, which beats leaving
        the slot idle.  Shared by every admission path (fresh, swap-resume,
        image)."""
        budget = self._budget_for(req, n_shared, self.effective_horizon)
        if budget > self.alloc.free_pages:
            self._evict_cache(budget - self.alloc.free_pages)
        if budget > self.alloc.free_pages:
            budget = self._budget_for(req, n_shared)
        return budget

    # -- prefix cache custody ------------------------------------------------
    def _evict_cache(self, want_pages: int) -> int:
        """LRU-drop cold cached prefixes to reclaim ``want_pages``.  Only
        unpinned nodes are dropped, so each page's device refcount is
        exactly 1 and the allocator mirror counts it freed without a
        read."""
        if self.prefix_cache is None or want_pages <= 0:
            return 0
        pages = self.prefix_cache.evict(want_pages)
        if pages:
            self.alloc.release(pages)
            self.stats["cache_evicted_pages"] += len(pages)
        return len(pages)

    def _cache_insert(self, st: _SlotState) -> None:
        """Offer the block's fully written pages (prompt, or fed prefix at
        preemption) to the cache.  Newly cached pages change custody from
        the block's reservation to the cache ledger via the allocator."""
        if self.prefix_cache is None:
            return
        n_full = st.fed // self.engine.page_size
        if n_full == 0:
            return
        pages = self.alloc.page_row(st.block, n_full)   # control-path read
        new_nodes = self.prefix_cache.insert(st.req.tokens, pages)
        if new_nodes:
            self.alloc.retain([n.page for n in new_nodes],
                              from_block=st.block)
            self.prefix_cache.pin(new_nodes)
            st.pinned.extend(new_nodes)

    def _unpin(self, st: _SlotState) -> None:
        if self.prefix_cache is not None and st.pinned:
            self.prefix_cache.unpin(st.pinned)
            st.pinned = []

    # -- policy: admission / eviction / preemption ---------------------------
    def _admit(self) -> None:
        free_slots = [s for s in range(self.engine.max_seqs)
                      if s not in self.slots]
        if not (self.queue and free_slots):
            return
        with self._span("tick.admit") as ext:
            n0 = len(self.slots)
            self._admit_loop(free_slots)
            ext["admitted"] = len(self.slots) - n0

    def _admit_loop(self, free_slots: List[int]) -> None:
        while self.queue and free_slots:
            req = self.queue[0]
            if req.image is not None:
                if not self._admit_image(req, free_slots):
                    break
                continue
            if req.block is not None:
                if not self._admit_swapped(req, free_slots):
                    break
                continue
            match: Optional[PrefixMatch] = None
            if self.prefix_cache is not None:
                match = self.prefix_cache.lookup(req.tokens)
                # pin before any eviction so the matched pages cannot be
                # reclaimed out from under the mapping about to be made
                self.prefix_cache.pin(match.all_nodes())
            budget = self._degraded_budget(
                req, len(match.pages) if match else 0)
            if budget > self.alloc.free_pages and match is not None \
                    and match.partial_node is not None:
                # the pinned COW source may itself be the page needed
                # back: losing a < page_size prefill shortcut beats never
                # admitting (and run()'s impossibility check counts this
                # page as evictable, so holding it would livelock)
                self.prefix_cache.unpin([match.partial_node])
                self.prefix_cache.drop_partial(match)
                self._evict_cache(budget - self.alloc.free_pages)
            if budget > self.alloc.free_pages:
                if match is not None:
                    self.prefix_cache.unpin(match.all_nodes())
                break
            self.queue.popleft()
            slot = free_slots.pop(0)
            blk = self.alloc.alloc(slot, props=self.block_props)
            st = _SlotState(req, blk, prefill_len=len(req.tokens),
                            admit_seq=self._admit_seq)
            self._admit_seq += 1
            try:
                self._call_vbi(
                    lambda: self.alloc.reserve_pages(blk, budget))
            except RetryExhausted as e:
                # nothing committed yet: undo the admission and climb the
                # degradation ladder; the request keeps its place at the
                # queue head and tries again with fresh draws
                if match is not None:
                    self.prefix_cache.unpin(match.all_nodes())
                self.alloc.free(blk)
                free_slots.insert(0, slot)
                self.queue.appendleft(req)
                self._fault_fallback_admit(e.faults)
                break
            if match is not None and match.n_tokens:
                ps = self.engine.page_size
                if match.pages:
                    self.alloc.map_shared(blk, match.pages,
                                          len(match.pages) * ps)
                if match.partial_len:
                    self.alloc.cow_break(blk, len(match.pages),
                                         match.partial_page, match.n_tokens)
                st.fed = match.n_tokens
                self.stats["prefix_hits"] += 1
                self.stats["prefix_tokens_reused"] += match.n_tokens
            if match is not None:
                self.prefix_cache.record(match, len(req.tokens))
                st.pinned.extend(match.all_nodes())
            self.slots[slot] = st
            self._req_ev("admit", req, slot=slot, bid=blk.bid,
                         cached_tokens=st.fed, budget_pages=budget)

    def _admit_swapped(self, req: Request, free_slots: List[int]) -> bool:
        """Re-admit a host-swapped request: budget its full span (with the
        decode horizon's headroom if it fits), then restore its exact KV
        into the first free slot with one device scatter (no re-prefill).
        The tokens past the restored span (the prompt's unfed rest, or the
        last output token) go through the prefill path.  Enqueues device
        work only, so it can run under the overlap's in-flight horizon."""
        budget = self._degraded_budget(req)
        if budget > self.alloc.free_pages:
            return False
        self.queue.popleft()
        slot = free_slots.pop(0)
        blk, req.block = req.block, None
        try:
            self._call_vbi(
                lambda: self.alloc.swap_in(blk, slot, reserve_pages=budget))
        except RetryExhausted as e:
            # the tier read keeps failing: give up the host image and
            # re-prefill the committed tokens (exact, as discard is).
            # swap_in raised before any change, so the block just frees
            self.alloc.free(blk)
            free_slots.insert(0, slot)
            self.queue.appendleft(req)
            self._resolve_fallback(e.faults, detail="reprefill")
            return True                 # fresh-admission path, same tick
        st = _SlotState(req, blk, prefill_len=len(req.tokens),
                        fed=blk.n_tokens, admit_seq=self._admit_seq)
        self._admit_seq += 1
        self.slots[slot] = st
        self.stats["swap_ins"] += 1
        self._req_ev("admit", req, slot=slot, bid=blk.bid, resume="swap",
                     restored_tokens=st.fed, budget_pages=budget)
        return True

    def _admit_image(self, req: Request, free_slots: List[int]) -> bool:
        """Adopt a handed-off (or recovered) BlockImage: budget the full
        span like any admission, then scatter the image's exact state into
        a fresh block of this pool — no re-prefill.  The checksum is
        verified on the host image before any page is charged, and the
        scatter only enqueues device work, so this runs under the
        overlap's in-flight horizon.  False applies backpressure at the
        handoff boundary: the image waits at the queue head."""
        budget = self._degraded_budget(req)
        if budget > self.alloc.free_pages:
            return False
        slot = free_slots[0]
        img = req.image
        try:
            blk = self._call_vbi(
                lambda: self.alloc.import_image(img, slot,
                                                reserve_pages=budget))
        except RetryExhausted as e:
            # the image keeps getting lost in transit: drop it and
            # re-prefill the committed tokens (exact under greedy decode)
            self.alloc.drop_image(img)
            req.image = None
            self._resolve_fallback(e.faults, detail="reprefill")
            return True                 # fresh-admission path, same tick
        except ImageIntegrityError as e:
            # a corrupt image is terminal, not transient: the same bits
            # cannot verify on a retry.  import_image raised before any
            # charge; drop it and re-prefill
            self.alloc.drop_image(img)
            req.image = None
            faults = list(getattr(e, "pending_faults", []))
            if e.fault_id is not None:
                faults.append(e.fault_id)
            self._resolve_fallback(faults, detail="reprefill")
            return True
        self.queue.popleft()
        free_slots.pop(0)
        req.image = None
        # fed = the committed tokens the image covers; anything past them
        # (the handoff's first decode token) goes through the prefill path
        st = _SlotState(req, blk, prefill_len=len(req.tokens),
                        fed=blk.n_tokens, admit_seq=self._admit_seq)
        self._admit_seq += 1
        self.slots[slot] = st
        self.stats["image_imports"] += 1
        self._req_ev("admit", req, slot=slot, bid=blk.bid, resume="image",
                     restored_tokens=st.fed, budget_pages=budget)
        return True

    def _evict(self, slot: int) -> None:
        st = self.slots.pop(slot)
        self._unpin(st)
        if self.handoff is not None and self.handoff(st.req, st.block):
            # custody moved with the export: the request continues on
            # another engine — not finished here
            self._req_ev("handoff", st.req, slot=slot,
                         n_out=len(st.req.out))
            return
        self.alloc.free(st.block)
        self.finished.append(st.req)
        self._req_ev("finish", st.req, slot=slot, n_out=len(st.req.out),
                     preemptions=st.req.preemptions)
        if self.on_finish is not None:
            self.on_finish(st.req)

    def _preempt_one(self) -> bool:
        """Release the youngest running non-PINNED slot back to the queue
        head.  Its declared properties pick the placement: a SWAPPABLE
        block is demoted to the host tier (exact restore later); otherwise,
        or when the tier refuses it, the fed prefix is offered to the
        prefix cache and the pages are discarded."""
        victims = [s for s, st in self.slots.items() if not st.block.pinned]
        if not victims:
            return False
        slot = max(victims, key=lambda s: self.slots[s].admit_seq)
        st = self.slots.pop(slot)
        # swap only if the full-span restore budget can ever fit the pool:
        # a swap image re-admits without the shared-page discount, so a
        # block admitted mostly through the cache could otherwise wait in
        # the queue forever; the discard path keeps the discount
        fits = self._budget_for(st.req) <= self.engine.n_pages - 1
        if fits:
            try:
                fits = self._call_vbi(lambda: self.alloc.swap_out(st.block))
            except RetryExhausted as e:
                # the tier write keeps failing: demote to the discard path
                # below (re-admission re-prefills, exactly).  swap_out
                # raised before any change
                fits = False
                self._resolve_fallback(e.faults, detail="discard")
        if fits:
            self._unpin(st)
            st.req.block = st.block
            self.stats["swap_outs"] += 1
            placement = "swap"
        else:
            self._cache_insert(st)
            self._unpin(st)
            self.alloc.free(st.block)
            placement = "discard"
        self._req_ev("preempt", st.req, slot=slot, placement=placement,
                     fed=st.fed)
        st.req.preemptions += 1
        self.queue.appendleft(st.req)    # keeps its generated prefix
        self.stats["preemptions"] += 1
        return True

    def _plan_horizon(self, dec_slots: List[int]
                      ) -> Tuple[int, Dict[int, int]]:
        """Pick this tick's horizon K and span-reserve it.  Shrinks only
        under pressure, in escalating order: evict cold cached prefixes,
        then truncate the horizon, then preempt.  Returns ``(K, wants)``
        where ``wants[slot]`` is the per-slot step budget whose worst-case
        span was reserved — exactly the ``steps_left`` the device must
        get."""
        def want(s: int, k: int) -> int:
            st = self.slots[s]
            return min(k, st.req.max_new - len(st.req.out))

        def deficit(k: int) -> int:
            need = 0
            for s in dec_slots:
                if s in self.slots:
                    st = self.slots[s]
                    need += max(0, self.alloc.pages_for(st.fed + want(s, k))
                                - st.block.shared_pages
                                - st.block.reserved_pages)
            return need - self.alloc.free_pages

        k = self.effective_horizon
        # near the tail of generation shrink K along the halving ladder so
        # fully masked steps don't burn model compute
        want_max = max(want(s, k) for s in dec_slots)
        while k > 1 and k // 2 >= want_max:
            k //= 2
        while (short := deficit(k)) > 0:
            if self._evict_cache(short):
                continue
            if k > 1:
                k = max(1, k // 2)
                self.stats["horizon_truncations"] += 1
                continue
            if not self._preempt_one():
                raise RuntimeError(
                    f"decode needs {short + self.alloc.free_pages} new "
                    f"pages, pool has {self.alloc.free_pages} free, and "
                    f"every resident block is PINNED — nothing can be "
                    f"preempted")
        wants = {}
        for s in dec_slots:
            if s in self.slots:
                st = self.slots[s]
                w = want(s, k)
                try:
                    self._call_vbi(
                        lambda b=st.block, f=st.fed, n=w:
                        self.alloc.reserve_span(b, f, n))
                except RetryExhausted as e:
                    # leave this slot out of the horizon for one tick
                    # (masked in the dispatch): nothing changed, it
                    # resumes next tick — an exact stall
                    self._resolve_fallback(e.faults, detail="skip_horizon")
                    continue
                wants[s] = w
        return k, wants

    # -- one scheduler tick ---------------------------------------------------
    def _prefill_stage(self) -> Optional[tuple]:
        """Host half of a chunked-prefill step: pick the slots still
        consuming their prompt, charge the allocator mirror and fill fresh
        numpy buffers.  Touches no device state, so in overlap mode it runs
        entirely under the in-flight decode horizon."""
        pre = {s: st for s, st in self.slots.items() if st.prefilling}
        if not pre:
            return None
        with self._span("tick.prefill_stage") as ext:
            S, C = self.engine.max_seqs, self.prefill_chunk
            toks = np.zeros((S, C), np.int32)
            counts = np.zeros((S,), np.int32)
            for s, st in pre.items():
                n = min(C, st.prefill_len - st.fed)
                try:
                    self._call_vbi(
                        lambda b=st.block, t=st.fed + n:
                        self.alloc.reserve(b, t))
                except RetryExhausted as e:
                    # skip this slot's chunk for one tick (its count stays
                    # 0: the dispatch writes nothing for the lane) — a
                    # pure stall, exact by construction
                    self._resolve_fallback(e.faults, detail="stall_chunk")
                    continue
                toks[s, :n] = st.req.tokens[st.fed:st.fed + n]
                counts[s] = n
            ext["slots"] = len(pre)
            ext["tokens"] = int(counts.sum())
        return pre, toks, counts

    def _prefill_launch(self, staged: Optional[tuple]) -> Optional[tuple]:
        """Device half: copy the staged buffers to the device and dispatch
        the chunk."""
        if staged is None:
            return None
        pre, toks, counts = staged
        with self._span("tick.prefill_launch", slots=len(pre)):
            nxt_dev = self.engine.prefill_chunk(self._to_device(toks),
                                                self._to_device(counts))
        self.stats["prefill_tokens"] += int(counts.sum())
        return pre, counts, nxt_dev

    def _prefill_finish(self, handle: Optional[tuple]) -> None:
        """Reconcile a dispatched chunk: the [S] int32 of next tokens is
        read only if some slot finished its prompt this chunk; a finished
        prompt offers its pages to the cache and takes its first token."""
        if handle is None:
            return
        pre, counts, nxt_dev = handle
        with self._span("tick.prefill_finish") as ext:
            finishing = [s for s, st in pre.items()
                         if st.fed + counts[s] >= st.prefill_len]
            nxt = None
            if finishing:
                nxt = nxt_dev.cpu().numpy()
                self.stats["host_syncs"] += 1
                self.stats["prefill_host_reads"] += 1
            else:
                self.stats["prefill_reads_skipped"] += 1
            ext["host_read"] = bool(finishing)
            for s, st in pre.items():
                st.fed += int(counts[s])
                self.alloc.commit(st.block, st.fed)
                self._req_ev("prefill_chunk", st.req, slot=s,
                             n=int(counts[s]), fed=st.fed)
                if not st.prefilling:      # prompt done → first token
                    if not st.inserted:    # share the prompt's KV pages
                        self._cache_insert(st)
                        st.inserted = True
                    st.req.out.append(int(nxt[s]))
                    self._req_ev("first_token", st.req, slot=s)
                    if self.on_tokens is not None:
                        self.on_tokens(st.req, 1)

    def _decode_dispatch(self, pre_ids) -> None:
        """Plan and dispatch one fused decode horizon for slots past their
        prompt, leaving the [K, S] token block in flight (``_pending``)
        with an event recorded right behind it.  The worst-case span is
        reserved before the dispatch, so the reconciliation can be
        deferred a whole tick without oversubscribing the free stack."""
        dec_ids = [s for s, st in self.slots.items()
                   if not st.prefilling and s not in pre_ids]
        if not dec_ids:
            return
        if self.faults is not None:
            # the decode-tick fault class: a poisoned or timed-out horizon
            # dispatch, fired and resolved here, BEFORE anything is
            # reserved or dispatched — a dispatch that already ran would
            # commit its tokens and pages twice.  Each is re-dispatched
            # within the tick (bounded by the retry budget), so it
            # resolves retry_ok at once; only latency is lost (accounted)
            fired = []
            while (len(fired) < self.retry.max_attempts
                   and self.faults.fires("decode_tick")):
                fired.append(self.faults.fire(
                    "decode_tick", tracer=self.tracer,
                    tick=self.stats["steps"]))
            if fired:
                self.faults.resolve(fired, "retry_ok", tracer=self.tracer,
                                    attempts=len(fired))
                self.stats["decode_tick_retries"] += len(fired)
        k, wants = self._plan_horizon(dec_ids)
        dec_ids = [s for s in dec_ids if s in self.slots and s in wants]
        if not dec_ids:
            return
        with self._span("tick.decode_dispatch", k=k, slots=len(dec_ids)):
            S = self.engine.max_seqs
            toks = np.zeros((S,), np.int32)
            mask = np.zeros((S,), bool)
            steps = np.zeros((S,), np.int32)
            for s in dec_ids:
                toks[s] = self.slots[s].req.tokens[-1]
                mask[s] = True
                steps[s] = wants[s]     # exactly the span reserved above
            block_dev = self.engine.decode_many(
                self._to_device(toks), self._to_device(mask),
                self._to_device(steps), k)
            self._pending = (block_dev, self.engine.ready_event(block_dev),
                             dec_ids, wants)

    def _decode_reconcile(self) -> None:
        """THE one host read of the horizon: pull the [K, S] int32 token
        block and reconcile commits/unreserves from it.  In overlap mode
        this runs a tick after the dispatch; the slots it touches are
        exactly the dispatched ``dec_ids`` (admission in between only
        fills other slots), so the arithmetic is the non-overlapped one."""
        if self._pending is None:
            return
        block_dev, event, dec_ids, wants = self._pending
        self._pending = None
        with self._span("tick.decode_reconcile", slots=len(dec_ids)) as ext:
            ready = self.engine.block_ready(block_dev, event)
            self.stats["sync_device_ready" if ready
                       else "sync_device_wait"] += 1
            ext["sync"] = "ready" if ready else "wait"
            block = block_dev.cpu().numpy()
            self.stats["host_syncs"] += 1
            for s in dec_ids:
                st = self.slots[s]
                col = block[:, s]
                produced = col[col >= 0]          # -1 = masked lane
                st.fed += len(produced)
                self.alloc.commit(st.block, st.fed)
                if len(produced) < wants[s]:      # stopped on device (EOS)
                    self.alloc.unreserve(st.block, st.fed)
                st.req.out.extend(int(t) for t in produced)
                if len(produced):
                    self._req_ev("tokens", st.req, slot=s,
                                 n=int(len(produced)))
                    if self.on_tokens is not None:
                        self.on_tokens(st.req, len(produced))

    def _evict_finished(self) -> None:
        """Eviction: max_new reached, or the device emitted EOS."""
        eos = self.engine.eos_id
        for s in [s for s, st in self.slots.items()
                  if len(st.req.out) >= st.req.max_new
                  or (eos >= 0 and st.req.out and st.req.out[-1] == eos)]:
            self._evict(s)

    def step(self) -> List[Request]:
        """Admit, prefill one chunk, decode one horizon; returns the
        requests that finished this tick.

        ``overlap=False``: dispatch, read and reconcile within the tick.
        ``overlap=True``: the read of horizon N is deferred to the start of
        tick N+1, after admission and the prefill chunk's host staging, so
        the host stages while the device runs horizon N.  Per-request
        tokens are equal either way; only when a queued request is
        admitted can shift by one tick."""
        self.stats["steps"] += 1
        done_before = len(self.finished)
        if self.overlap and self._pending is not None:
            self.stats["overlap_staged_ticks"] += 1
            self._admit()                      # staged under horizon N ...
            staged = self._prefill_stage()     # ... host half only
            self._decode_reconcile()           # horizon N's deferred read
            handle = self._prefill_launch(staged)
        else:
            self._admit()
            handle = self._prefill_launch(self._prefill_stage())
        self._prefill_finish(handle)
        if self.overlap:
            # evict before dispatching horizon N+1: a slot finished at the
            # deferred read must not ride into the next in-flight horizon
            self._evict_finished()
            if self.queue:
                # refill pass: the staged _admit ran before the deferred
                # read could free any slot; no horizon is in flight here,
                # so this is plain admission, and the refilled slot joins
                # the next tick's prefill chunk
                self._admit()
        pre_ids = handle[0].keys() if handle else ()
        self._decode_dispatch(pre_ids)
        if not self.overlap:
            self._decode_reconcile()
            self._evict_finished()
        self._sample_gauges()
        return self.finished[done_before:]

    def run(self, max_steps: int = 100_000) -> List[Request]:
        """Drain queue + slots; returns all finished requests."""
        for _ in range(max_steps):
            if not self.queue and not self.slots:
                break
            self.step()
            if self.queue and not self.slots:
                # nothing running and the head request still could not be
                # admitted by step()'s _admit pass (which already tried
                # cache eviction) — it can never fit this pool
                evictable = (self.prefix_cache.evictable_pages
                             if self.prefix_cache else 0)
                if self._budget_for(self.queue[0]) > \
                        self.alloc.free_pages + evictable:
                    raise RuntimeError(
                        f"request {self.queue[0].rid} needs "
                        f"{self._budget_for(self.queue[0])} pages; pool has "
                        f"{self.alloc.free_pages} free + {evictable} "
                        f"evictable cached")
        if self.queue or self.slots:
            raise RuntimeError(
                f"run() exhausted {max_steps} steps with "
                f"{len(self.queue)} queued and {len(self.slots)} running "
                f"requests still unfinished")
        if self._pending is not None:
            raise RuntimeError("a drained run left a decode horizon in "
                               "flight")
        return self.finished
