"""Exact recovery over the VBI fault plane (the port's counterpart of
``repro/serve/recovery.py``).

Two halves:

**Bounded retry.**  :func:`retry_call` re-runs an allocator boundary op
through :class:`~repro_torch.serve.faults.TransientFault` s up to
``RetryPolicy.max_attempts`` times, recording an exponential backoff per
attempt (virtual ticks — the serve clock is simulated, so the backoff is
*accounted*, never slept: a sleep would slow the wall-clock launcher and
move TTFT).  Every fault the plan fired on the way to a
success is resolved ``retry_ok``; exhaustion raises
:class:`RetryExhausted` carrying the fired faults so the caller's
fallback can resolve them (``fallback``/``shed``) — the extended trace
checker refuses a replay with any fault left dangling.

Every fallback in the scheduler is chosen to be **output-exact**: skip
the tick (nothing mutated), discard-and-re-prefill (greedy decode over
recomputed KV is bit-identical — the invariant the preemption tests
already prove), or drop a damaged image and re-prefill.  That is what
keeps a chaos run's tokens equal to the fault-free run's at every fault
intensity.

**Crash recovery.**  :class:`ServeSnapshotter` periodically captures
every resident block as a sealed, non-destructive
:class:`~repro_torch.core.vbi.blocks.BlockImage`
(``VBIAllocator.snapshot_image`` — custody never moves; a blocking copy
to the host) plus the scheduler's request ledger, written through the
port's ``checkpoint/`` (crash-atomic dirs, corruption-tolerant restore,
the reference's on-disk format).  :func:`recover_scheduler` rebuilds a
FRESH engine + scheduler from the newest intact snapshot plus the
telemetry journal (the JSONL trace: ``arrive`` events carry the
prompt, so requests that arrived after the last snapshot are replayed
too), re-imports live blocks via ``import_image`` (checksum-verified —
a corrupt snapshot leg falls back to re-prefill), and re-queues the
rest.  Greedy decode over exact-or-recomputed KV makes the restarted
engine's remaining outputs bit-identical to the uninterrupted run —
the same exactness argument as the disaggregated handoff.
"""
from __future__ import annotations

import json
import re
from typing import Dict, List, Optional

import numpy as np

from ..checkpoint.checkpoint import (CheckpointCorruptError,
                                     CheckpointManager, latest_step,
                                     load_leaves)
from ..core.vbi.address_space import VBProps
from ..core.vbi.blocks import BlockImage
from .faults import TransientFault


class RetryPolicy:
    """Bounded retry with recorded exponential backoff: attempt ``i``
    waits ``base_backoff * 2**i`` virtual ticks (recorded on the fault
    and in the ``recover`` event, not slept — serve time is simulated).
    With per-attempt fault probability ``r``, exhaustion probability is
    ``r**(max_attempts+1)`` — the chaos sweep picks ``max_attempts`` so
    sheds are vanishingly rare while unit tests force them."""

    def __init__(self, max_attempts: int = 6, base_backoff: float = 1.0):
        if max_attempts < 0:
            raise ValueError("max_attempts must be >= 0")
        self.max_attempts = max_attempts
        self.base_backoff = base_backoff

    def backoff(self, attempt: int) -> float:
        return self.base_backoff * (2.0 ** attempt)


class RetryExhausted(RuntimeError):
    """The bounded retry burned every attempt on transient faults.  The
    caller owns the fallback AND must resolve ``faults`` (the fired
    :class:`TransientFault` s, in order) so the trace replays clean."""

    def __init__(self, faults: List[TransientFault]):
        kinds = [f.kind for f in faults]
        super().__init__(f"retry exhausted after {len(faults)} fault(s): "
                         f"{kinds}")
        self.faults = faults


def retry_call(fn, policy: Optional[RetryPolicy] = None):
    """Run ``fn`` through transient faults: returns ``(result, fired)``
    where ``fired`` lists the faults cleared on the way (resolve them
    ``retry_ok``).  Raises :class:`RetryExhausted` when the policy's
    attempts run out; a non-transient exception propagates immediately
    with any already-fired faults attached as ``pending_faults`` so the
    handler can resolve those too."""
    policy = policy or RetryPolicy()
    pending: List[TransientFault] = []
    for attempt in range(policy.max_attempts + 1):
        try:
            out = fn()
        except TransientFault as f:
            f.backoff = policy.backoff(attempt)
            pending.append(f)
            continue
        except Exception as e:
            if pending:
                e.pending_faults = pending
            raise
        return out, pending
    raise RetryExhausted(pending)


# --------------------------------------------------------------------------
# crash recovery: periodic BlockImage snapshots + journal replay
# --------------------------------------------------------------------------
_KEY_RE = re.compile(r"[A-Za-z0-9_.]+")


def _leaf_name(key: str) -> str:
    """``keystr`` renders a dict leaf path as ``['name']``; recover the
    bare name (our leaf names are [A-Za-z0-9_.]+ by construction)."""
    m = _KEY_RE.search(key)
    if not m:
        raise ValueError(f"unparseable checkpoint leaf key {key!r}")
    return m.group(0)


class ServeSnapshotter:
    """Periodic crash-consistent snapshots of a running Scheduler.

    Every ``every`` calls to :meth:`tick` (typically one per scheduler
    step), captures: each resident slot's block as a sealed non-destructive
    BlockImage, each queued request's token ledger (a queued block's host
    swap image dies with the engine, so queued legs restore by exact
    re-prefill), and the finished requests' outputs — all through
    ``checkpoint.save_pytree`` (atomic dirs, ``keep`` retention).  Skips
    a tick when a horizon is in flight (``overlap=True`` mid-dispatch):
    the snapshot must see committed state only.  Each image is copied to
    the host before the writer runs, so the writer never holds a view of
    live device state."""

    def __init__(self, sched, directory, every: int = 8, keep: int = 2):
        self.sched = sched
        self.mgr = CheckpointManager(directory, keep=keep)
        self.every = max(1, every)
        self._count = 0
        self.snapshots = 0

    def tick(self) -> bool:
        self._count += 1
        if self._count % self.every:
            return False
        return self.snapshot()

    def _entry(self, req, state: str, extra: Optional[dict] = None) -> dict:
        e = {"rid": req.rid, "prompt": list(req.prompt),
             "out": list(req.out), "max_new": req.max_new,
             "preemptions": req.preemptions, "state": state}
        if extra:
            e.update(extra)
        return e

    def snapshot(self) -> bool:
        sched = self.sched
        if getattr(sched, "_pending", None) is not None:
            return False            # horizon in flight; try next tick
        leaves: Dict[str, np.ndarray] = {}
        meta = {"tick": int(sched.stats["steps"]), "requests": []}
        for slot, st in sorted(sched.slots.items()):
            req = st.req
            img = sched.alloc.snapshot_image(
                st.block, tokens=req.tokens,
                lineage={"rid": req.rid, "snapshot": True})
            im = {"n_tokens": img.n_tokens, "props": int(img.props),
                  "page_size": img.page_size, "n_pages": img.n_pages,
                  "charge": img.charge, "checksum": img.checksum,
                  "tokens": list(img.tokens),
                  "n_aux": len(img.aux) if img.aux is not None else 0,
                  "src_bid": img.src_bid, "src_pool": img.src_pool}
            meta["requests"].append(self._entry(req, "slot", {"img": im}))
            leaves[f"r{req.rid}_k"] = img.k
            leaves[f"r{req.rid}_v"] = img.v
            for i, a in enumerate(img.aux or ()):
                leaves[f"r{req.rid}_a{i}"] = a
        for req in sched.queue:
            # a queued request's swapped block / in-flight image lives in
            # the crashing process — restore is exact re-prefill instead
            meta["requests"].append(self._entry(req, "queued"))
        for req in sched.finished:
            meta["requests"].append(self._entry(req, "finished"))
        leaves["snapmeta"] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8).copy()
        self.snapshots += 1
        self.mgr.save(leaves, step=self._count, blocking=True)
        return True


def _rebuild_image(entry: dict, leaves: Dict[str, np.ndarray]
                   ) -> BlockImage:
    m = entry["img"]
    rid = entry["rid"]
    aux = tuple(leaves[f"r{rid}_a{i}"] for i in range(m["n_aux"])) or None
    return BlockImage(
        tokens=list(m["tokens"]), n_tokens=m["n_tokens"],
        props=VBProps(m["props"]), page_size=m["page_size"],
        n_pages=m["n_pages"], charge=m["charge"],
        k=leaves[f"r{rid}_k"], v=leaves[f"r{rid}_v"], aux=aux,
        lineage={"rid": rid, "snapshot": True},
        src_bid=m["src_bid"], src_pool=m["src_pool"],
        checksum=m["checksum"])


def recover_scheduler(sched, directory,
                      journal: Optional[List[dict]] = None
                      ) -> Dict[int, List[int]]:
    """Rebuild a crashed engine's serving state INTO ``sched`` — a fresh
    Scheduler over a fresh engine (same model/params/geometry).

    Restores from the newest INTACT snapshot under ``directory``
    (``latest_step`` skips torn/corrupt steps): live slots re-enter the
    queue as image-resumed requests (``import_image`` verifies each
    sealed snapshot leg; a failed checksum degrades that leg to exact
    re-prefill), queued legs re-enter with their token ledger, and
    ``journal`` (the telemetry JSONL event list) contributes requests
    that arrived after the snapshot — their ``arrive`` events carry the
    prompt.  Returns ``{rid: out}`` for requests that had already
    finished, to merge with ``sched.run()``'s results; the combined
    outputs are bit-identical to the uninterrupted run."""
    from .scheduler import Request

    step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no intact snapshot under {directory}")
    raw = load_leaves(directory, step)
    leaves = {_leaf_name(k): v for k, v in raw.items()}
    meta = json.loads(bytes(leaves["snapmeta"].tobytes()).decode())

    finished: Dict[int, List[int]] = {}
    known = set()
    live: List[Request] = []
    for entry in meta["requests"]:
        rid = entry["rid"]
        known.add(rid)
        if entry["state"] == "finished":
            finished[rid] = list(entry["out"])
            continue
        req = Request(rid, list(entry["prompt"]), entry["max_new"],
                      out=list(entry["out"]),
                      preemptions=entry["preemptions"])
        if entry["state"] == "slot":
            try:
                req.image = _rebuild_image(entry, leaves)
            except (KeyError, CheckpointCorruptError):
                req.image = None        # damaged leg → exact re-prefill
            if req.image is not None and not req.image.verify():
                req.image = None
        live.append(req)

    for req in live:                    # snapshot order = admission order
        sched.queue.append(req)
        sched._next_rid = max(sched._next_rid, req.rid + 1)
        sched._req_ev("arrive", req, prompt_len=len(req.prompt),
                      max_new=req.max_new, recovered=True)
    for ev in journal or []:            # post-snapshot arrivals
        if (ev.get("type") == "req" and ev.get("ev") == "arrive"
                and ev["rid"] not in known and "prompt" in ev):
            sched.add_request(list(ev["prompt"]), ev["max_new"],
                              rid=ev["rid"])
            known.add(ev["rid"])
    return finished
