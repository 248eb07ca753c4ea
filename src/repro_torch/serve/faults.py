"""Deterministic fault injection over the VBI block lifecycle (the port's
copy of ``repro/serve/faults.py``: numpy and pure Python, and draw ``n`` of
class ``c`` equals the reference's for every ``(seed, c, n)``).

The thesis's reliability argument (the SIMDRAM Monte-Carlo model in
``core/reliability.py``) says failure is a property of the memory system,
not an afterthought — and the VBI makes the *unit* of failure concrete: a
``VirtualBlock`` / ``BlockImage`` carries everything needed to recover it,
so every fault this module injects lands on a VBI boundary and every
recovery path (serve/recovery.py) operates on declared block state.

:class:`FaultPlan` interposes on the allocator through the same
duck-typed hook pattern as the trace recorder: ``install_faults`` (the
only caller of ``VBIAllocator.attach_faults``) parks the plan on the
allocator, whose boundary methods consult it:

  ========================  ==============================================
  fault class               boundary
  ========================  ==============================================
  ``alloc``                 ``reserve_pages`` growth (transient pool
                            exhaustion — the reservation is refused)
  ``swap_out``              host-tier write I/O failure (before any state
                            moves, so a retry is always safe)
  ``swap_in``               host-tier read I/O failure (before the image
                            is popped)
  ``image_loss``            a BlockImage vanishes in transit to
                            ``import_image`` (retransmission territory)
  ``image_corrupt``         the image arrives damaged: a bit-flipped K/V
                            payload or a falsified page charge — caught by
                            the integrity checksum, never by luck
  ``decode_tick``           a poisoned / timed-out fused-horizon dispatch
                            (consulted by the scheduler, not the allocator)
  ========================  ==============================================

Every fault is drawn from a **rate-independent seeded stream**: draw ``n``
of class ``c`` is a pure function of ``(seed, c, n)`` (a splitmix64 hash),
and the rate only sets the firing threshold — the same trick
``serve/traffic.py`` plays with arrivals, so one seed sweeps fault
intensities over identical traffic and a higher rate fires a superset of
the lower rate's faults (modulo the control-flow divergence recovery
itself introduces).

Accounting: every fired fault gets a unique ``fault_id`` and lands in the
telemetry trace as a ``fault`` event; recovery resolves it with a
``recover`` event (outcome ``retry_ok`` / ``fallback`` / ``shed``).  The
extended offline checker (``serve/telemetry.py::check_trace``) fails any
trace with an unresolved fault — silent drops cannot replay clean.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional

import numpy as np

#: every fault class, in stream-index order (the index feeds the hash, so
#: the order is part of the trace format — append, never reorder)
FAULT_KINDS = ("alloc", "swap_out", "swap_in", "image_loss",
               "image_corrupt", "decode_tick")
_KIND_IDX = {k: i for i, k in enumerate(FAULT_KINDS)}

_M64 = (1 << 64) - 1


def _u01(seed: int, kind_idx: int, n: int) -> float:
    """Draw ``n`` of stream ``(seed, kind)`` as a uniform in [0, 1) — a
    splitmix64 finalizer over the tuple, so the stream is stateless:
    rate changes can never shift which value draw ``n`` sees."""
    x = (seed * 0x9E3779B97F4A7C15 + kind_idx * 0xBF58476D1CE4E5B9
         + (n + 1) * 0x94D049BB133111EB) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    x ^= x >> 31
    return x / 2.0 ** 64


class FaultError(RuntimeError):
    """Base of every injected fault; carries the class and the unique id
    the matching ``recover`` event must reference."""

    def __init__(self, kind: str, fault_id: int, msg: str = ""):
        super().__init__(msg or f"injected {kind} fault #{fault_id}")
        self.kind = kind
        self.fault_id = fault_id


class TransientFault(FaultError):
    """A fault a bounded retry may clear (alloc exhaustion, swap I/O,
    image loss): nothing was mutated before the raise, so re-running the
    boundary op is always safe."""


class ImageLost(TransientFault):
    """The BlockImage never arrived — the retry IS the retransmission
    (safe because ``import_image`` is idempotent by (pool, bid, lineage))."""


def install_faults(alloc, plan: Optional["FaultPlan"]) -> None:
    """Park ``plan`` on the allocator (None detaches).  This is the ONLY
    caller of ``attach_faults``, so fault injection stays pinned to this
    module and no scheduler or bench grows a private fault hook."""
    alloc.attach_faults(plan)


class FaultPlan:
    """Seeded, rate-independent fault schedule over the VBI boundaries.

    ``rates`` maps fault class → firing probability per boundary crossing
    (a bare float applies to every class).  ``force(kind, n)`` queues
    ``n`` unconditional faults for deterministic tests — forced faults
    fire before any stream draw and consume no draw index."""

    def __init__(self, rates=None, seed: int = 0):
        if rates is None:
            rates = {}
        if isinstance(rates, (int, float)):
            rates = {k: float(rates) for k in FAULT_KINDS}
        unknown = set(rates) - set(FAULT_KINDS)
        if unknown:
            raise ValueError(f"unknown fault class(es): {sorted(unknown)}")
        self.rates: Dict[str, float] = {k: float(rates.get(k, 0.0))
                                        for k in FAULT_KINDS}
        self.seed = int(seed)
        self._n = {k: 0 for k in FAULT_KINDS}       # per-class draw index
        self._forced = {k: 0 for k in FAULT_KINDS}
        self._next_id = 0
        self.fired: Dict[str, int] = {k: 0 for k in FAULT_KINDS}
        self.resolved: Dict[str, int] = {"retry_ok": 0, "fallback": 0,
                                         "shed": 0}
        self.unresolved: Dict[int, str] = {}        # fault_id -> kind

    # -- the stream ----------------------------------------------------------
    def force(self, kind: str, n: int = 1) -> None:
        if kind not in _KIND_IDX:
            raise ValueError(f"unknown fault class {kind!r}")
        self._forced[kind] += n

    def fires(self, kind: str) -> bool:
        """Consume one boundary crossing of ``kind``; True if it faults."""
        if self._forced[kind] > 0:
            self._forced[kind] -= 1
            return True
        rate = self.rates[kind]
        n = self._n[kind]
        self._n[kind] += 1
        if rate <= 0.0:
            return False
        return _u01(self.seed, _KIND_IDX[kind], n) < rate

    # -- firing + accounting -------------------------------------------------
    def fire(self, kind: str, tracer=None, **ctx) -> int:
        """Record one fired fault (already decided); returns its id and
        emits the ``fault`` trace event the checker will demand a
        resolution for."""
        fid = self._next_id
        self._next_id += 1
        self.fired[kind] += 1
        self.unresolved[fid] = kind
        if tracer is not None:
            tracer.emit("fault", kind=kind, fault_id=fid, **ctx)
        return fid

    def check(self, kind: str, tracer=None, **ctx) -> None:
        """The allocator-boundary hook: raise a :class:`TransientFault`
        when the stream says this crossing fails.  Always raises BEFORE
        the boundary op mutates anything, so retries are safe."""
        if self.fires(kind):
            fid = self.fire(kind, tracer=tracer, **ctx)
            raise TransientFault(kind, fid)

    def deliver(self, img, tracer=None, **ctx):
        """The transit hook ``import_image`` passes every arriving
        BlockImage through: may raise :class:`ImageLost`, or return a
        corrupted COPY (bit-flipped payload or falsified charge — the
        integrity checksum must catch it; the original is untouched, so
        the retransmission fallback stays exact)."""
        if self.fires("image_loss"):
            fid = self.fire("image_loss", tracer=tracer,
                            img_bid=img.src_bid, img_pool=img.src_pool,
                            **ctx)
            raise ImageLost("image_loss", fid)
        if self.fires("image_corrupt"):
            fid = self.fire("image_corrupt", tracer=tracer,
                            img_bid=img.src_bid, img_pool=img.src_pool,
                            **ctx)
            bad = dataclasses.replace(img)
            # alternate damage modes off the stream so one seed exercises
            # both: flip one payload bit, or falsify the page charge
            mode_u = _u01(self.seed, _KIND_IDX["image_corrupt"] + 8, fid)
            if mode_u < 0.5 and bad.k.size:
                k = np.array(bad.k, copy=True)
                flat = k.view(np.uint8)
                pos = int(_u01(self.seed, _KIND_IDX["image_corrupt"] + 16,
                               fid) * flat.size)
                flat.reshape(-1)[min(pos, flat.size - 1)] ^= 0x01
                bad.k = k
            else:
                bad.charge = img.charge + 1
            bad.lineage = copy.deepcopy(img.lineage)
            bad._fault_id = fid                     # rides to the rejection
            return bad
        return img

    def resolve(self, fault_ids, outcome: str, tracer=None, **ctx) -> None:
        """Close out fired faults with their recovery outcome; emits the
        ``recover`` events the checker matches against the ``fault``
        events.  ``fault_ids`` may be ids or :class:`FaultError` s."""
        if outcome not in self.resolved:
            raise ValueError(f"unknown outcome {outcome!r}")
        if isinstance(fault_ids, (int, FaultError)):
            fault_ids = [fault_ids]
        for f in fault_ids:
            fid = f.fault_id if isinstance(f, FaultError) else int(f)
            kind = self.unresolved.pop(fid, None)
            if kind is None:
                raise RuntimeError(f"fault #{fid} resolved twice (or never "
                                   f"fired)")
            self.resolved[outcome] += 1
            if tracer is not None:
                tracer.emit("recover", fault_id=fid, kind=kind,
                            outcome=outcome, **ctx)

    @property
    def stats(self) -> Dict[str, object]:
        return {"fired": dict(self.fired),
                "resolved": dict(self.resolved),
                "unresolved": len(self.unresolved)}


# --------------------------------------------------------------------------
# rate sources: flat CLI rate, or the SIMDRAM reliability model
# --------------------------------------------------------------------------
def simdram_rates(spec: str, scale: float = 1.0) -> Dict[str, float]:
    """Seed fault probabilities from the thesis's PuM reliability model
    (``core/reliability.py``, Table 2.3): ``spec`` is
    ``simdram:node=22`` (optionally ``,rows=5,var=0.2``) and the
    QRA-style multi-row activation failure rate at that node becomes the
    per-boundary fault probability, uniformly across classes (scaled by
    ``scale`` so a sweep can amplify a realistic-but-tiny base rate)."""
    from ..core.reliability import activation_failure_rate
    if not spec.startswith("simdram"):
        raise ValueError(f"unknown fault model {spec!r}")
    params = {"node": 22, "rows": 5, "var": 0.2}
    _, _, tail = spec.partition(":")
    for part in filter(None, tail.split(",")):
        key, _, val = part.partition("=")
        if key not in params:
            raise ValueError(f"unknown fault-model param {key!r}")
        params[key] = float(val) if key == "var" else int(val)
    rate = activation_failure_rate(params["rows"], params["var"],
                                   params["node"])
    return {k: min(1.0, rate * scale) for k in FAULT_KINDS}


def plan_from_args(rate: float, seed: int,
                   model: Optional[str] = None,
                   scale: float = 1.0) -> FaultPlan:
    """Build the launcher/bench FaultPlan: a flat per-boundary ``rate``,
    or — with ``model`` — rates derived from the SIMDRAM reliability
    sweep (``--fault-model simdram:node=22``)."""
    rates = simdram_rates(model, scale=scale) if model else rate
    return FaultPlan(rates, seed=seed)
