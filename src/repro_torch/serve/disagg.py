"""Disaggregated prefill/decode serving — two engines, one block image
(the port's counterpart of ``repro/serve/disagg.py``).

Production serving splits compute-bound prefill from latency-bound decode
onto separately-provisioned engines; what makes the split cheap is the
VBI contract: a request's entire state — KV pages, ring frames, recurrent
rows, committed length, declared ``VBProps`` — already travels as ONE
self-describing :class:`~repro_torch.core.vbi.blocks.BlockImage`, so
migrating a request is ``export_image`` on one allocator and
``import_image`` on another, with nothing re-derived and nothing
recomputed on the consumer side (the paper's data-centric move: ship the
computation's state once, in bulk).

:class:`DisaggScheduler` composes two ordinary :class:`Scheduler` s over
two independently sized :class:`~repro_torch.serve.engine.PagedEngine` s
that share one set of device weights (each has its own pool, page table
and free stack):

  * the **prefill engine** — many slots, large prefill chunks, no decode
    horizon to speak of (requests run with ``max_new=1``, so the prompt's
    argmax IS the first token and the slot frees immediately), and a pool
    sized for prompts only;
  * the **decode engine** — fewer slots, a deep fused decode horizon, a
    page pool sized for full lifetimes, optionally a host swap tier.

Steering: the prefill scheduler's eviction path calls the ``handoff``
hook; if the request still has tokens to generate, the hook exports its
block as a ``BlockImage`` and enqueues an image-carrying request on the
decode scheduler, whose admission adopts it with one staged device
scatter (it only enqueues work, so it runs under an in-flight horizon
with ``overlap=True``).  The export runs at the prefill engine's
eviction, after that tick's host read, and copies only the block's
pages to the host with a blocking copy.  Backpressure is asymmetric by
design: decode-pool pressure stalls the *handoff admission* (images wait
at the decode queue head; the prefill engine keeps chewing through
prompts), never the prefill engine itself.

Both engines tick under the same driver clock (``step()`` runs one
prefill tick then one decode tick, so a handoff lands the same tick it
exports); :class:`~repro_torch.serve.traffic.TrafficDriver` drives this
class unchanged through the duck-typed scheduler surface
(``add_request`` / ``step`` / ``queue`` / ``slots`` / ``finished`` +
streaming hooks).
Telemetry: each engine gets a pool-scoped view (``prefill``, ``decode``)
of ONE shared trace, so the offline checker replays both pools'
conservation invariants and matches every export to its import.  One
:class:`~repro_torch.serve.faults.FaultPlan` covers both allocators.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

from ..core.vbi.address_space import VBProps
from ..core.vbi.blocks import DEFAULT_BLOCK_PROPS
from .engine import PagedEngine
from .prefix_cache import PrefixCache
from .scheduler import Request, Scheduler, check_request_fits
from .telemetry import MetricsRegistry, StatsView, Telemetry

#: ``DisaggScheduler.stats`` keys, pinned like the scheduler's
_DISAGG_STAT_KEYS = ("steps", "handoffs", "handoff_bytes",
                     "handoff_stalled_ticks", "direct_finishes")


class DisaggScheduler:
    """Two-engine prefill/decode topology behind the one-scheduler duck
    type.  ``prefill_engine`` and ``decode_engine`` must share a model
    config and page size (the image checks page size and layer kinds at
    import); everything else about their geometry — slot count, pool
    size, row width, swap tier — may differ."""

    def __init__(self, prefill_engine: PagedEngine,
                 decode_engine: PagedEngine, prefill_chunk: int = 8,
                 decode_horizon: int = 8, overlap: bool = False,
                 prefix_cache: Optional[PrefixCache] = None,
                 block_props: VBProps = DEFAULT_BLOCK_PROPS,
                 on_tokens=None, on_finish=None,
                 telemetry: Optional[Telemetry] = None,
                 faults=None, retry=None):
        if prefill_engine is decode_engine:
            raise ValueError("disaggregation needs two engines")
        if prefill_engine.page_size != decode_engine.page_size:
            raise ValueError("prefill/decode engines must agree on page "
                             "size")
        if prefill_engine.cfg.name != decode_engine.cfg.name:
            raise ValueError("prefill/decode engines must serve the same "
                             "model")
        self.on_tokens = on_tokens
        self.on_finish = on_finish
        self.finished: List[Request] = []
        self.telemetry = telemetry
        self.tracer = telemetry.tracer if telemetry is not None else None
        self.metrics = (telemetry.metrics if telemetry is not None
                        else MetricsRegistry())
        self.stats = StatsView(self.metrics, prefix="disagg.",
                               keys=_DISAGG_STAT_KEYS)
        # the requested decode budget, by rid: prefill-side requests run
        # with max_new=1 (prompt argmax = first token), the remainder is
        # granted on the decode side at handoff
        self._max_new: Dict[int, int] = {}
        p_tel = telemetry.scoped("prefill") if telemetry is not None else None
        d_tel = telemetry.scoped("decode") if telemetry is not None else None
        # ONE FaultPlan interposes on BOTH allocators (serve/faults.py):
        # every VBI boundary on either engine — and the
        # image handoff between them — draws from the same seeded streams,
        # so a chaos run over the two-engine topology is reproducible
        self.faults = faults
        self.prefill = Scheduler(
            prefill_engine, prefill_chunk=prefill_chunk,
            prefix_cache=prefix_cache, block_props=block_props,
            decode_horizon=1, telemetry=p_tel, handoff=self._handoff,
            on_tokens=self._fwd_tokens, on_finish=self._finish,
            faults=faults, retry=retry)
        self.decode = Scheduler(
            decode_engine, prefill_chunk=prefill_chunk,
            decode_horizon=decode_horizon, overlap=overlap,
            block_props=block_props, telemetry=d_tel,
            on_tokens=self._fwd_tokens, on_finish=self._finish,
            faults=faults, retry=retry)

    # -- the duck-typed scheduler surface (serve/traffic.py) ------------------
    @property
    def queue(self) -> List[Request]:
        return list(self.prefill.queue) + list(self.decode.queue)

    @property
    def slots(self) -> Dict[tuple, object]:
        merged = {("prefill", s): st for s, st in self.prefill.slots.items()}
        merged.update(
            {("decode", s): st for s, st in self.decode.slots.items()})
        return merged

    @property
    def shed(self) -> List[Request]:
        """Requests load-shed by either engine's degradation ladder."""
        return list(self.prefill.shed) + list(self.decode.shed)

    @property
    def shed_policy(self):
        return self.prefill.shed_policy

    @shed_policy.setter
    def shed_policy(self, fn) -> None:
        self.prefill.shed_policy = fn
        self.decode.shed_policy = fn

    @property
    def on_shed(self):
        return self.prefill.on_shed

    @on_shed.setter
    def on_shed(self, fn) -> None:
        self.prefill.on_shed = fn
        self.decode.on_shed = fn

    def add_request(self, prompt: List[int], max_new: int,
                    rid: Optional[int] = None) -> int:
        # the full lifetime lives on the DECODE engine — check against its
        # geometry up front so a handed-off image can never wedge there
        check_request_fits(self.decode.engine, self.decode.alloc,
                           len(prompt), max_new)
        rid = self.prefill.add_request(prompt, 1, rid=rid)
        self._max_new[rid] = max_new
        return rid

    def step(self) -> List[Request]:
        """One driver tick = one tick of EACH engine, prefill first so an
        export lands in the decode queue in time for the same tick's
        decode admission pass."""
        self.stats["steps"] += 1
        done_before = len(self.finished)
        if self.prefill.queue or self.prefill.slots:
            self.prefill.step()
        if self.decode.queue or self.decode.slots:
            self.decode.step()
        # backpressure telemetry: a handoff image parked at the decode
        # queue head means decode-pool pressure is stalling admission —
        # and ONLY admission: the prefill engine above ran regardless
        head = self.decode.queue[0] if self.decode.queue else None
        if head is not None and head.image is not None:
            self.stats["handoff_stalled_ticks"] += 1
        return self.finished[done_before:]

    def run(self, max_steps: int = 100_000) -> List[Request]:
        """Drain both engines; returns all finished requests."""
        for _ in range(max_steps):
            if not (self.prefill.queue or self.prefill.slots
                    or self.decode.queue or self.decode.slots):
                break
            self.step()
        if self.queue or self.slots:
            raise RuntimeError(
                f"run() exhausted {max_steps} steps with "
                f"{len(self.queue)} queued and {len(self.slots)} running "
                f"requests still unfinished")
        if self.decode._pending is not None:
            raise RuntimeError("a drained run left a decode horizon in "
                               "flight")
        return self.finished

    # -- steering: the handoff boundary --------------------------------------
    def _handoff(self, req: Request, block) -> bool:
        """Prefill-side eviction hook.  The prompt's argmax already gave
        the request its first token; if that satisfied it (``max_new=1``
        requested, or EOS), let the normal eviction finish it here.
        Otherwise export the block as a BlockImage and steer an
        image-carrying continuation into the decode queue."""
        total = self._max_new.pop(req.rid, 1)
        eos = self.prefill.engine.eos_id
        if len(req.out) >= total or (eos >= 0 and req.out
                                     and req.out[-1] == eos):
            self.stats["direct_finishes"] += 1
            return False
        with self._span("handoff", rid=req.rid) as ext:
            img = self.prefill.alloc.export_image(
                block, tokens=req.tokens,
                lineage={"src_bid": block.bid,
                         "preemptions": req.preemptions,
                         "prompt_len": len(req.prompt)})
            ext["n_pages"] = img.n_pages
            ext["bytes"] = img.nbytes
        cont = Request(req.rid, list(req.prompt), total,
                       out=list(req.out), preemptions=req.preemptions,
                       image=img)
        self.decode.queue.append(cont)
        self.stats["handoffs"] += 1
        self.stats["handoff_bytes"] += img.nbytes
        if self.tracer is not None:
            self.tracer.req_event("handoff_export", req.rid,
                                  n_pages=img.n_pages, bytes=img.nbytes,
                                  decode_queue_depth=len(self.decode.queue))
        return True

    # -- plumbing -------------------------------------------------------------
    def _span(self, name: str, **args):
        if self.tracer is None:
            return contextlib.nullcontext({})
        return self.tracer.span(name, tick=self.stats["steps"], **args)

    def _fwd_tokens(self, req: Request, n: int) -> None:
        if self.on_tokens is not None:
            self.on_tokens(req, n)

    def _finish(self, req: Request) -> None:
        self.finished.append(req)
        if self.on_finish is not None:
            self.on_finish(req)
