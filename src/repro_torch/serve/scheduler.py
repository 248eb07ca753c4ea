"""Closed-loop continuous-batching scheduler over the PagedEngine (host
policy; counterpart of ``repro/serve/scheduler.py``).

The device owns translation and allocation mechanics (``core/vbi/
kvcache.py``), the VBIAllocator (``core/vbi/blocks.py``) owns the memory
interface, and this module owns policy only: which request, which slot,
which victim, when.  The host never reads device state on the token path;
the allocator mirrors page accounting arithmetically.

Policies:

  * **admission** — a queued request is admitted when a slot is free and
    the allocator's mirrored budget covers its prompt plus its first decode
    horizon (falling back to one decode page); the budget is reserved at
    admission, so concurrent prefills never oversubscribe the device free
    stack;
  * **chunked prefill** — admitted prompts are fed ``prefill_chunk``
    tokens per engine call, ragged across slots; the next-token argmax runs
    on the device and the host reads the [S] int32 only on chunks where
    some slot finished its prompt;
  * **the decode horizon** — decoding slots advance up to
    ``decode_horizon`` tokens per ``PagedEngine.decode_many`` call with
    sampling, feedback and stopping on the device, and the host reads the
    ``[K, S]`` token block once per horizon.  The worst-case span is
    reserved through the allocator first; under pressure the horizon is
    truncated before anything is preempted, and commits/unreserves are
    reconciled from the returned block;
  * **eviction** — finished requests free their block;
  * **preemption** — if a decode horizon cannot be covered even at K=1,
    the youngest running non-PINNED request is preempted: its pages are
    discarded and it re-enters the queue head with its generated tokens,
    to be re-prefilled on re-admission (greedy decode makes this exact).

Host staging: every tick builds fresh numpy buffers and copies them into
fresh device tensors with a blocking copy, so no in-flight transfer can
read a buffer the host refills on the next tick.

Not in this slice (ROADMAP.md § A7-A9): the prefix cache, telemetry,
double-buffered overlap, the fault plane, host-swap resume and disagg
handoff.  Asking for any of them raises.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.vbi.address_space import VBProps
from ..core.vbi.blocks import DEFAULT_BLOCK_PROPS, VirtualBlock
from .engine import PagedEngine


def check_request_fits(engine: PagedEngine, alloc, prompt_len: int,
                       max_new: int, shareable_pages: int = 0) -> None:
    """Intake impossibility check: refuse now what no schedule could ever
    place.  Only full-attention layers consume pool pages, so the checks
    bind only when the stack has any."""
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
    # ... and its page budget must fit the pool at all
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

    @property
    def tokens(self) -> List[int]:
        return self.prompt + self.out


@dataclasses.dataclass
class _SlotState:
    req: Request
    block: VirtualBlock
    prefill_len: int        # tokens to prefill (snapshot at admission)
    fed: int = 0            # tokens written into the KV so far
    admit_seq: int = 0      # admission order (preemption picks the youngest)

    @property
    def prefilling(self) -> bool:
        return self.fed < self.prefill_len


class Scheduler:
    def __init__(self, engine: PagedEngine, prefill_chunk: int = 8,
                 prefix_cache=None,
                 block_props: VBProps = DEFAULT_BLOCK_PROPS,
                 decode_horizon: int = 1, overlap: bool = False,
                 telemetry=None, faults=None):
        unported = {"prefix_cache": prefix_cache, "telemetry": telemetry,
                    "faults": faults}
        for name, value in unported.items():
            if value is not None:
                raise NotImplementedError(
                    f"{name} is not ported yet (ROADMAP.md § A7-A9); pass "
                    f"{name}=None")
        if overlap:
            raise NotImplementedError(
                "double-buffered overlap is not ported yet (ROADMAP.md "
                "§ A7); pass overlap=False")
        if decode_horizon < 1:
            raise ValueError("decode_horizon must be >= 1")
        self.engine = engine
        self.alloc = engine.alloc          # the one memory API
        self.prefill_chunk = prefill_chunk
        self.block_props = block_props
        self.decode_horizon = decode_horizon
        self.queue: Deque[Request] = deque()
        self.slots: Dict[int, _SlotState] = {}
        self.finished: List[Request] = []
        self._next_rid = 0
        self._admit_seq = 0
        self.stats = {k: 0 for k in (
            "preemptions", "steps", "prefill_tokens", "host_syncs",
            "prefill_host_reads", "prefill_reads_skipped",
            "horizon_truncations", "sync_device_ready", "sync_device_wait")}

    def _to_device(self, buf: np.ndarray) -> torch.Tensor:
        """A fresh device tensor holding a copy of ``buf`` (blocking copy:
        the host may refill ``buf`` as soon as this returns)."""
        return torch.tensor(buf, device=self.engine.device)

    # -- request intake ------------------------------------------------------
    def add_request(self, prompt: List[int], max_new: int,
                    rid: Optional[int] = None) -> int:
        check_request_fits(self.engine, self.alloc, len(prompt), max_new)
        rid = self._next_rid if rid is None else rid
        self._next_rid = max(self._next_rid, rid) + 1
        self.queue.append(Request(rid, list(prompt), max_new))
        return rid

    # -- page budgeting (delegated to the allocator's host mirror) -----------
    def _budget_for(self, req: Request, horizon: int = 1) -> int:
        """Current span extended by the decode horizon (capped at what the
        request can still generate), plus one page of headroom."""
        if not self.engine.has_full:
            return 0
        rem = max(1, req.max_new - len(req.out))
        span = len(req.tokens) + min(horizon, rem) - 1
        return self.alloc.pages_for(span) + 1

    # -- policy: admission / eviction / preemption ---------------------------
    def _admit(self) -> None:
        free_slots = [s for s in range(self.engine.max_seqs)
                      if s not in self.slots]
        while self.queue and free_slots:
            req = self.queue[0]
            budget = self._budget_for(req, self.decode_horizon)
            if budget > self.alloc.free_pages:
                budget = self._budget_for(req)
            if budget > self.alloc.free_pages:
                break
            self.queue.popleft()
            slot = free_slots.pop(0)
            blk = self.alloc.alloc(slot, props=self.block_props)
            self.alloc.reserve_pages(blk, budget)
            self.slots[slot] = _SlotState(req, blk,
                                          prefill_len=len(req.tokens),
                                          admit_seq=self._admit_seq)
            self._admit_seq += 1

    def _evict(self, slot: int) -> None:
        st = self.slots.pop(slot)
        self.alloc.free(st.block)
        self.finished.append(st.req)

    def _preempt_one(self) -> bool:
        """Release the youngest running non-PINNED slot back to the queue
        head (discard placement: re-admission re-prefills its tokens)."""
        victims = [s for s, st in self.slots.items() if not st.block.pinned]
        if not victims:
            return False
        slot = max(victims, key=lambda s: self.slots[s].admit_seq)
        st = self.slots.pop(slot)
        self.alloc.free(st.block)
        st.req.preemptions += 1
        self.queue.appendleft(st.req)    # keeps its generated prefix
        self.stats["preemptions"] += 1
        return True

    def _plan_horizon(self, dec_slots: List[int]
                      ) -> Tuple[int, Dict[int, int]]:
        """Pick this tick's horizon K and span-reserve it.  Shrinks only
        under pressure: truncate the horizon before preempting.  Returns
        ``(K, wants)`` where ``wants[slot]`` is the per-slot step budget
        whose worst-case span was reserved — exactly the ``steps_left`` the
        device must get."""
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

        k = self.decode_horizon
        # near the tail of generation shrink K along the halving ladder so
        # fully masked steps don't burn model compute
        want_max = max(want(s, k) for s in dec_slots)
        while k > 1 and k // 2 >= want_max:
            k //= 2
        while (short := deficit(k)) > 0:
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
                wants[s] = want(s, k)
                self.alloc.reserve_span(st.block, st.fed, wants[s])
        return k, wants

    # -- one scheduler tick ---------------------------------------------------
    def _prefill(self) -> List[int]:
        """Stage, dispatch and reconcile one chunked-prefill step for the
        slots still consuming their prompt; returns those slots."""
        pre = {s: st for s, st in self.slots.items() if st.prefilling}
        if not pre:
            return []
        S, C = self.engine.max_seqs, self.prefill_chunk
        toks = np.zeros((S, C), np.int32)
        counts = np.zeros((S,), np.int32)
        for s, st in pre.items():
            n = min(C, st.prefill_len - st.fed)
            self.alloc.reserve(st.block, st.fed + n)
            toks[s, :n] = st.req.tokens[st.fed:st.fed + n]
            counts[s] = n
        nxt_dev = self.engine.prefill_chunk(self._to_device(toks),
                                            self._to_device(counts))
        self.stats["prefill_tokens"] += int(counts.sum())
        finishing = [s for s, st in pre.items()
                     if st.fed + counts[s] >= st.prefill_len]
        nxt = None
        if finishing:
            nxt = nxt_dev.cpu().numpy()
            self.stats["host_syncs"] += 1
            self.stats["prefill_host_reads"] += 1
        else:
            self.stats["prefill_reads_skipped"] += 1
        for s, st in pre.items():
            st.fed += int(counts[s])
            self.alloc.commit(st.block, st.fed)
            if not st.prefilling:          # prompt done → first token
                st.req.out.append(int(nxt[s]))
        return list(pre)

    def _decode(self, pre_ids: List[int]) -> None:
        """Plan, dispatch and reconcile one fused decode horizon for slots
        past their prompt.  The token block is THE one host read of the
        horizon."""
        dec_ids = [s for s, st in self.slots.items()
                   if not st.prefilling and s not in pre_ids]
        if not dec_ids:
            return
        k, wants = self._plan_horizon(dec_ids)
        dec_ids = [s for s in dec_ids if s in self.slots and s in wants]
        if not dec_ids:
            return
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
        ready = self.engine.block_ready(block_dev)
        self.stats["sync_device_ready" if ready else "sync_device_wait"] += 1
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

    def _evict_finished(self) -> None:
        """Eviction: max_new reached, or the device emitted EOS."""
        eos = self.engine.eos_id
        for s in [s for s, st in self.slots.items()
                  if len(st.req.out) >= st.req.max_new
                  or (eos >= 0 and st.req.out and st.req.out[-1] == eos)]:
            self._evict(s)

    def step(self) -> List[Request]:
        """Admit, prefill one chunk, decode one horizon; returns the
        requests that finished this tick."""
        self.stats["steps"] += 1
        done_before = len(self.finished)
        self._admit()
        pre_ids = self._prefill()
        self._decode(pre_ids)
        self._evict_finished()
        return self.finished[done_before:]

    def run(self, max_steps: int = 100_000) -> List[Request]:
        """Drain queue + slots; returns all finished requests."""
        for _ in range(max_steps):
            if not self.queue and not self.slots:
                break
            self.step()
            if self.queue and not self.slots:
                # nothing running and the head request still couldn't be
                # admitted — it can never fit this pool
                if self._budget_for(self.queue[0]) > self.alloc.free_pages:
                    raise RuntimeError(
                        f"request {self.queue[0].rid} needs "
                        f"{self._budget_for(self.queue[0])} pages; pool has "
                        f"{self.alloc.free_pages} free")
        if self.queue or self.slots:
            raise RuntimeError(
                f"run() exhausted {max_steps} steps with "
                f"{len(self.queue)} queued and {len(self.slots)} running "
                f"requests still unfinished")
        return self.finished
