"""VBI telemetry: metrics registry, block-lifecycle tracing, trace checker
(the port's copy of ``repro/serve/telemetry.py``; pure Python, and its
trace schema is the reference's byte for byte, so either side's
:func:`check_trace` replays the other's traces).

The thesis' claim is that a memory system should *understand and convey*
data properties — yet until this module the serve stack's only window
into block placement, swap traffic and scheduler overlap was an ad-hoc
``stats`` dict and whatever a bench happened to print.  Both
"Memory-Centric Computing" and "Processing Data Where It Makes Sense"
argue that data movement is the bottleneck you must *measure* before you
can eliminate it; this module is that measurement spine (DESIGN.md §10).

Three pieces, each usable alone:

  * :class:`MetricsRegistry` — named :class:`Counter` / :class:`Gauge` /
    :class:`Histogram` instruments.  The histogram keeps pinned bucket
    edges *and* the raw samples, so percentile math has exactly one
    implementation (:func:`percentile`, the linear-interpolation rule the
    hand-computed SLO tests read against).  ``Scheduler.stats`` and
    friends stay dict-compatible through :class:`StatsView`, a mutable
    mapping over a registry's counters — existing tests and
    ``BENCH_serving.json`` keys are unchanged;

  * :class:`TraceRecorder` — an event log of typed records: per-request
    lifecycle events (arrive → admit → prefill → horizon → preempt /
    swap → finish), per-tick host timeline spans (admit, stage, launch,
    reconcile — with the sync-ready/sync-wait verdict), every VBI block
    op carrying its declared
    :class:`~repro_torch.core.vbi.address_space.VBProps` (so *why* a
    block was placed where it was is visible in the trace), and per-tick gauge samples.  Exports JSONL (one event per line) and
    Chrome ``trace_event`` JSON loadable in Perfetto / ``chrome://tracing``;

  * :func:`check_trace` — the offline checker: replays a recorded trace
    against the allocator's conservation invariants (no leaked pages,
    ledger references balanced, swap charge symmetric, the mirrored
    free-page count re-derivable from the event deltas and equal to every
    sampled gauge).  The trace format itself becomes a correctness tool:
    a trace that replays clean *proves* the run conserved pages.

Telemetry is off by default and near-zero-cost when disabled: every
emit site is guarded by a single ``is None`` check, no instrument ever
reads device state (all sampled values come from host mirrors), and a
tier-1 test asserts bit-identical outputs and identical ``host_syncs``
with tracing on vs off.

CLI: ``python -m repro_torch.serve.telemetry trace.jsonl`` runs the checker;
``--chrome out.json`` converts a JSONL trace to Chrome format.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import time
from collections.abc import MutableMapping
from typing import Callable, Dict, Iterable, List, Optional, Sequence

from ..core.vbi.address_space import VBProps

# --------------------------------------------------------------------------
# percentiles: ONE implementation, shared by histograms and the SLO math
# --------------------------------------------------------------------------


def percentile(xs: Sequence[float], q: float) -> float:
    """Linear-interpolation percentile on the sorted sample (the numpy
    default), pinned here so the SLO math and every histogram read
    against one definition (tests/test_torch_traffic.py holds it to the
    reference's)."""
    assert 0.0 <= q <= 100.0
    s = sorted(float(x) for x in xs)
    if not s:
        return float("nan")
    if len(s) == 1:
        return s[0]
    pos = q / 100.0 * (len(s) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (pos - lo) * (s[hi] - s[lo])


def props_str(props: VBProps) -> str:
    """Human-readable ``VBProps`` ('KV_CACHE|EVICTABLE|SWAPPABLE') for
    trace events — the paper's point made legible: every block op in a
    trace shows the declared properties that drove its placement."""
    if not props:
        return "NONE"
    return "|".join(f.name for f in VBProps if f and props & f)


# --------------------------------------------------------------------------
# the metrics registry
# --------------------------------------------------------------------------
class Counter:
    """Monotone event count (may be reset/assigned for dict-compat)."""
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Point-in-time level; remembers its high-water mark."""
    __slots__ = ("value", "max")

    def __init__(self) -> None:
        self.value = 0.0
        self.max = 0.0

    def set(self, v: float) -> None:
        self.value = v
        if v > self.max:
            self.max = v


#: default latency bucket edges in seconds (sub-ms .. minutes); pinned so
#: bucket counts are comparable across runs and PRs
LATENCY_EDGES_S = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1,
                   1.0, 3.0, 10.0, 30.0, 120.0)


class Histogram:
    """Distribution instrument with pinned bucket edges AND retained raw
    samples: bucket counts give cheap cross-run comparability, the samples
    give exact percentiles through :func:`percentile` — one implementation
    for every latency number the serve stack reports."""

    __slots__ = ("edges", "buckets", "samples")

    def __init__(self, edges: Sequence[float] = LATENCY_EDGES_S) -> None:
        assert list(edges) == sorted(edges), "bucket edges must ascend"
        self.edges = tuple(float(e) for e in edges)
        self.buckets = [0] * (len(self.edges) + 1)   # last = overflow
        self.samples: List[float] = []

    def observe(self, x: float) -> None:
        x = float(x)
        self.buckets[bisect.bisect_left(self.edges, x)] += 1
        self.samples.append(x)

    def observe_many(self, xs: Iterable[float]) -> None:
        for x in xs:
            self.observe(x)

    @property
    def count(self) -> int:
        return len(self.samples)

    @property
    def sum(self) -> float:
        return float(sum(self.samples))

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.samples else float("nan")

    def percentile(self, q: float) -> float:
        return percentile(self.samples, q)

    def snapshot(self) -> Dict[str, object]:
        out: Dict[str, object] = {"count": self.count}
        if self.samples:
            out.update(sum=self.sum, mean=self.mean,
                       min=min(self.samples), max=max(self.samples),
                       p50=self.percentile(50), p99=self.percentile(99))
        out["buckets"] = {f"le_{e:g}": n
                          for e, n in zip(self.edges, self.buckets)}
        out["buckets"]["inf"] = self.buckets[-1]
        return out


class MetricsRegistry:
    """Named instruments, get-or-create by kind.  Registration order is
    preserved so snapshots and stats views iterate deterministically."""

    def __init__(self) -> None:
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge()
        return g

    def histogram(self, name: str,
                  edges: Sequence[float] = LATENCY_EDGES_S) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(edges)
        return h

    def snapshot(self) -> Dict[str, object]:
        """JSON-ready view: counters as ints, gauges as value/max pairs,
        histograms as bucket+percentile summaries."""
        return {
            "counters": {k: c.value for k, c in self.counters.items()},
            "gauges": {k: {"value": g.value, "max": g.max}
                       for k, g in self.gauges.items()},
            "histograms": {k: h.snapshot()
                           for k, h in self.histograms.items()},
        }


class StatsView(MutableMapping):
    """Dict-compatible face over a registry's counters under a prefix.

    ``sched.stats["preemptions"] += 1`` keeps working verbatim while the
    storage moves into the shared :class:`MetricsRegistry` — the
    backward-compatibility satellite: every existing test and
    ``BENCH_serving.json`` key reads exactly what it read before."""

    __slots__ = ("_m", "_prefix", "_keys")

    def __init__(self, metrics: MetricsRegistry, prefix: str = "",
                 keys: Sequence[str] = ()) -> None:
        self._m = metrics
        self._prefix = prefix
        self._keys: List[str] = []
        for k in keys:
            self[k] = 0

    def __getitem__(self, key: str) -> int:
        if key not in self._keys:
            raise KeyError(key)
        return self._m.counter(self._prefix + key).value

    def __setitem__(self, key: str, value: int) -> None:
        if key not in self._keys:
            self._keys.append(key)
        self._m.counter(self._prefix + key).value = value

    def __delitem__(self, key: str) -> None:
        self._keys.remove(key)
        del self._m.counters[self._prefix + key]

    def __iter__(self):
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)

    def __repr__(self) -> str:
        return repr(dict(self))


# --------------------------------------------------------------------------
# the trace recorder
# --------------------------------------------------------------------------
class TraceRecorder:
    """Event-sourced trace of a serve run.

    Events are plain dicts with ``type`` ∈ {meta, span, req, block,
    gauge} and a monotonically non-decreasing ``ts`` (seconds; wall by
    default, injectable for deterministic tests).  Emission is
    synchronous and allocation-light — a dict append per event, never a
    device read — so recording cannot perturb scheduling decisions.
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None) -> None:
        t0 = time.perf_counter()
        self._now = clock or (lambda: time.perf_counter() - t0)
        self.events: List[dict] = []

    def now(self) -> float:
        return self._now()

    def emit(self, type: str, **fields) -> None:
        ev = {"ts": self.now(), "type": type}
        ev.update(fields)
        self.events.append(ev)

    # -- typed emitters ------------------------------------------------------
    def meta(self, **fields) -> None:
        """Pool/run geometry the offline checker replays against."""
        self.emit("meta", **fields)

    def block_op(self, op: str, **fields) -> None:
        """One VBI block-lifecycle op.  Callers attach the block's declared
        properties (``props``/``props_s``) so placement decisions are
        visible, plus the redundant accounting fields (pages charged,
        reservation totals, swap charges) :func:`check_trace` verifies."""
        self.emit("block", op=op, **fields)

    def req_event(self, ev: str, rid: int, **fields) -> None:
        self.emit("req", ev=ev, rid=rid, **fields)

    def gauge_sample(self, tick: int, values: Dict[str, float]) -> None:
        self.emit("gauge", tick=tick, values=dict(values))

    @contextlib.contextmanager
    def span(self, name: str, **args):
        """Record a complete host timeline span around a ``with`` body."""
        t0 = self.now()
        ext: Dict[str, object] = {}
        try:
            yield ext
        finally:
            args.update(ext)
            self.events.append({"ts": t0, "type": "span", "name": name,
                                "dur": self.now() - t0, **args})

    # -- export --------------------------------------------------------------
    def write_jsonl(self, path: str) -> None:
        import os
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            for ev in self.events:
                f.write(json.dumps(ev) + "\n")

    def chrome_trace(self) -> dict:
        """Chrome ``trace_event`` JSON (the Trace Event Format), loadable
        in Perfetto or ``chrome://tracing``:

          * host tick spans → complete events (``ph="X"``) on the
            scheduler track;
          * request lifecycle → one async span per request (``ph="b"/"e"``,
            id = rid) plus instant events for admit/preempt/tokens;
          * block ops → instant events on a per-slot VBI track, with the
            declared properties in ``args``;
          * gauge samples → counter events (``ph="C"``), one counter track
            per gauge name — the occupancy timelines.
        """
        tev: List[dict] = []

        def us(t: float) -> float:
            return t * 1e6

        tev.append({"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
                    "args": {"name": "host scheduler"}})
        tev.append({"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
                    "args": {"name": "requests"}})
        tev.append({"name": "process_name", "ph": "M", "pid": 2, "tid": 0,
                    "args": {"name": "vbi blocks"}})
        open_reqs = set()
        for ev in self.events:
            t = ev["ts"]
            if ev["type"] == "span":
                args = {k: v for k, v in ev.items()
                        if k not in ("ts", "type", "name", "dur")}
                tev.append({"name": ev["name"], "ph": "X", "ts": us(t),
                            "dur": us(max(ev["dur"], 0.0)), "pid": 0,
                            "tid": 0, "cat": "tick", "args": args})
            elif ev["type"] == "req":
                rid = ev["rid"]
                args = {k: v for k, v in ev.items()
                        if k not in ("ts", "type", "ev", "rid")}
                if ev["ev"] == "arrive":
                    open_reqs.add(rid)
                    tev.append({"name": f"req {rid}", "ph": "b",
                                "cat": "request", "id": rid, "ts": us(t),
                                "pid": 1, "tid": rid, "args": args})
                elif ev["ev"] == "finish":
                    tev.append({"name": f"req {rid}", "ph": "e",
                                "cat": "request", "id": rid, "ts": us(t),
                                "pid": 1, "tid": rid, "args": args})
                    open_reqs.discard(rid)
                else:
                    tev.append({"name": ev["ev"], "ph": "i", "s": "t",
                                "cat": "request", "ts": us(t), "pid": 1,
                                "tid": rid, "args": args})
            elif ev["type"] == "block":
                args = {k: v for k, v in ev.items()
                        if k not in ("ts", "type", "op")}
                if "props" in args:
                    args["props_s"] = props_str(VBProps(int(args["props"])))
                tev.append({"name": ev["op"], "ph": "i", "s": "t",
                            "cat": "vbi", "ts": us(t), "pid": 2,
                            "tid": int(ev.get("slot", -1)) + 1,
                            "args": args})
            elif ev["type"] == "gauge":
                for name, v in ev["values"].items():
                    tev.append({"name": name, "ph": "C", "ts": us(t),
                                "pid": 0, "tid": 0,
                                "args": {"value": v}})
        # close any request span left open so the JSON stays well-formed
        t_end = self.events[-1]["ts"] if self.events else 0.0
        for rid in sorted(open_reqs):
            tev.append({"name": f"req {rid}", "ph": "e", "cat": "request",
                        "id": rid, "ts": us(t_end), "pid": 1, "tid": rid,
                        "args": {"note": "unfinished at trace end"}})
        return {"traceEvents": tev, "displayTimeUnit": "ms"}

    def write_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)

    def scoped(self, pool: str) -> "_ScopedTracer":
        """A view of this recorder that stamps ``pool=<label>`` on every
        event it emits.  The disaggregated topology (DESIGN.md §11) gives
        each engine's allocator a scoped view so one trace file holds both
        engines' event streams and :func:`check_trace` can replay each
        pool's conservation invariants separately — and match block-image
        exports against their imports across pools."""
        return _ScopedTracer(self, pool)


class _ScopedTracer:
    """Pool-labelled proxy over a :class:`TraceRecorder` (one per engine
    in a disaggregated run).  Duck-type-compatible with the recorder for
    everything the allocator and scheduler emit."""

    __slots__ = ("_rec", "pool")

    def __init__(self, rec: TraceRecorder, pool: str) -> None:
        self._rec = rec
        self.pool = pool

    @property
    def events(self) -> List[dict]:
        return self._rec.events

    def now(self) -> float:
        return self._rec.now()

    def emit(self, type: str, **fields) -> None:
        fields.setdefault("pool", self.pool)
        self._rec.emit(type, **fields)

    def meta(self, **fields) -> None:
        self.emit("meta", **fields)

    def block_op(self, op: str, **fields) -> None:
        self.emit("block", op=op, **fields)

    def req_event(self, ev: str, rid: int, **fields) -> None:
        self.emit("req", ev=ev, rid=rid, **fields)

    def gauge_sample(self, tick: int, values: Dict[str, float]) -> None:
        self.emit("gauge", tick=tick, values=dict(values))

    @contextlib.contextmanager
    def span(self, name: str, **args):
        args.setdefault("pool", self.pool)
        with self._rec.span(name, **args) as ext:
            yield ext

    def write_jsonl(self, path: str) -> None:
        self._rec.write_jsonl(path)


def read_jsonl(path: str) -> List[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# --------------------------------------------------------------------------
# the telemetry bundle threaded through the serve stack
# --------------------------------------------------------------------------
class Telemetry:
    """What the scheduler/launcher/bench pass around: a metrics registry
    (always on — counters are as cheap as the dict they replace) plus an
    optional trace recorder (off by default)."""

    def __init__(self, trace: bool = False,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self.metrics = MetricsRegistry()
        self.tracer: Optional[TraceRecorder] = (
            TraceRecorder(clock) if trace else None)

    def scoped(self, pool: str) -> "Telemetry":
        """Per-engine view for the disaggregated topology (DESIGN.md §11):
        a FRESH metrics registry — two schedulers sharing one registry
        would collide on their ``sched.*`` counter names — whose trace
        events land in the SAME underlying recorder, tagged
        ``pool=<label>``."""
        sub = Telemetry()
        if self.tracer is not None:
            sub.tracer = self.tracer.scoped(pool)
        return sub


# --------------------------------------------------------------------------
# the offline trace checker: the trace format as a correctness tool
# --------------------------------------------------------------------------
class TraceCheckError(AssertionError):
    """A recorded trace violates an allocator conservation invariant."""


def _fail(i: int, ev: dict, msg: str) -> None:
    raise TraceCheckError(f"event {i} ({ev.get('type')}/"
                          f"{ev.get('op', ev.get('ev', '?'))}): {msg}")


def check_trace(events: Sequence[dict]) -> Dict[str, int]:
    """Replay a recorded trace and re-verify the allocator's conservation
    invariants purely from the events:

      * the mirrored free-page count, re-derived from reserve/unreserve/
        retain/release/swap/free deltas, never leaves ``[0, n_pages-1]``
        and matches every sampled ``alloc.free_pages`` gauge;
      * block lifecycle is a valid state machine (alloc → resident ⇄
        swapped → freed; no op ever lands on a freed block) and the
        redundant per-event accounting fields (reservation totals, freed
        pages, swap charges) agree with the replayed state — a tampered
        or truncated trace cannot replay clean;
      * ledger (prefix-cache custody) references balance: retains ≥
        releases at all times;
      * swap charge is symmetric: each swap-in/free releases exactly the
        charge its swap-out paid, the tier never exceeds its capacity,
        and a drained run ends with zero pages held everywhere;
      * the placement axis (DESIGN.md §13): ``place`` ops accumulate the
        device set each block's pages were put on, and any op with a
        ``gathered_from`` field (swap_out / export_image /
        snapshot_image) must name only devices in that set — a gather
        from a device the block never lived on cannot replay clean.

    A trace may hold SEVERAL pools' event streams (the disaggregated
    topology records both engines through pool-scoped tracer views,
    DESIGN.md §11): every event carries an optional ``pool`` label, each
    pool replays its own mirror/ledger/tier against its own meta geometry,
    and block-image handoffs are matched across pools — an export charges
    custody out of its pool, the matching import (same source pool + bid,
    same charge) charges it into the destination, and a drained run must
    leave no image in flight.

    The fault plane (DESIGN.md §12) extends the contract: every ``fault``
    event (unique ``fault_id``) must be matched by exactly one ``recover``
    event with a valid outcome (``retry_ok`` / ``fallback`` / ``shed``) —
    a trace with an injected fault left unresolved, or a resolution for a
    fault that never fired, cannot replay clean, so silent drops are
    structurally impossible.  Imports marked ``img_external`` (crash-
    recovery snapshots, whose export happened in a previous process) skip
    the cross-pool inflight match; ``drop_image`` retires an in-flight
    image without importing it (an accounted shed/fallback).

    Returns a summary dict (event/block/op counts, peak occupancy,
    fault/recovery counts).  Raises :class:`TraceCheckError` on the first
    violation."""
    metas: Dict[object, dict] = {}          # pool label -> first geometry meta
    for e in events:
        if e.get("type") == "meta" and "n_pages" in e:
            metas.setdefault(e.get("pool"), e)
    if not metas:
        raise TraceCheckError("no pool meta event: nothing to check against")
    pools: Dict[object, dict] = {}
    for label, meta in metas.items():
        n_pages = int(meta["n_pages"])
        pools[label] = {
            "n_pages": n_pages,
            "swap_cap": int(meta.get("swap_capacity", 0)),
            "free": n_pages - 1,            # page 0 is the null page
            "ledger": 0,                    # pages on the cache ledger
            "tier_used": 0,
            "blocks": {},                   # bid -> {status, reserved, charge}
            "peak": 0,
        }
    inflight: Dict[tuple, int] = {}         # (src pool, src bid) -> charge
    faults_open: Dict[int, str] = {}        # fault_id -> kind, unresolved
    fault_ids_seen: set = set()
    n_faults = 0
    n_recovered = {"retry_ok": 0, "fallback": 0, "shed": 0}
    n_ops = 0
    for i, ev in enumerate(events):
        label = ev.get("pool")
        if ev.get("type") == "fault":
            fid = int(ev["fault_id"])
            if fid in fault_ids_seen:
                _fail(i, ev, f"fault id {fid} fired twice")
            fault_ids_seen.add(fid)
            faults_open[fid] = ev.get("kind", "?")
            n_faults += 1
            continue
        if ev.get("type") == "recover":
            fid = int(ev["fault_id"])
            outcome = ev.get("outcome")
            if outcome not in n_recovered:
                _fail(i, ev, f"unknown recovery outcome {outcome!r}")
            if fid not in faults_open:
                _fail(i, ev, f"recovery for fault id {fid} that never "
                      f"fired (or was already resolved)")
            del faults_open[fid]
            n_recovered[outcome] += 1
            continue
        if ev.get("type") == "gauge":
            st = pools.get(label)
            if st is None:
                _fail(i, ev, f"gauge for unknown pool {label!r}")
            free = st["free"]
            tier_used = st["tier_used"]
            vals = ev.get("values", {})
            if "alloc.free_pages" in vals \
                    and int(vals["alloc.free_pages"]) != free:
                _fail(i, ev, f"sampled free_pages="
                      f"{vals['alloc.free_pages']} but replay says {free}")
            if "swap.pages_used" in vals \
                    and int(vals["swap.pages_used"]) != tier_used:
                _fail(i, ev, f"sampled swap.pages_used="
                      f"{vals['swap.pages_used']} but replay says "
                      f"{tier_used}")
            continue
        if ev.get("type") != "block":
            continue
        st = pools.get(label)
        if st is None:
            _fail(i, ev, f"block op for unknown pool {label!r}")
        n_pages = st["n_pages"]
        swap_cap = st["swap_cap"]
        blocks = st["blocks"]
        n_ops += 1
        op = ev["op"]
        bid = ev.get("bid")
        blk = blocks.get(bid)
        # the placement axis (DESIGN.md §13): a gather must only read
        # devices the block was actually placed on — a forged
        # ``gathered_from`` cannot replay clean
        gf = ev.get("gathered_from")
        if gf is not None:
            placed = blk.get("placed", set()) if blk is not None else set()
            bad = sorted(d for d in gf if d not in placed)
            if bad:
                _fail(i, ev, f"gather from device(s) {bad} that bid {bid} "
                      f"was never placed on (placed: {sorted(placed)})")
        if op == "alloc":
            if blk is not None and blk["status"] != "freed":
                _fail(i, ev, f"bid {bid} allocated twice")
            blocks[bid] = {"status": "resident", "reserved": 0, "charge": 0,
                           "placed": set()}
        elif op in ("reserve", "unreserve", "commit", "map_shared",
                    "cow_break", "swap_out", "export_image", "free"):
            if blk is None:
                _fail(i, ev, f"op on unknown bid {bid}")
            if op == "free":
                was = blk["status"]
                if was == "freed":
                    _fail(i, ev, f"bid {bid} freed twice")
                if was == "swapped":
                    st["tier_used"] -= blk["charge"]
                else:
                    if int(ev["freed_reserved"]) != blk["reserved"]:
                        _fail(i, ev, f"free returned "
                              f"{ev['freed_reserved']} pages but replayed "
                              f"reservation is {blk['reserved']}")
                    st["free"] += blk["reserved"]
                blk.update(status="freed", reserved=0, charge=0)
            elif blk["status"] != "resident":
                _fail(i, ev, f"{op} on {blk['status']} bid {bid}")
            elif op == "reserve":
                grow = int(ev["grow"])
                if grow <= 0:
                    _fail(i, ev, "non-positive reservation growth")
                st["free"] -= grow
                blk["reserved"] += grow
                if blk["reserved"] != int(ev["reserved"]):
                    _fail(i, ev, f"reservation total {ev['reserved']} "
                          f"disagrees with replay {blk['reserved']}")
            elif op == "unreserve":
                ret = int(ev["returned"])
                if not 0 < ret <= blk["reserved"]:
                    _fail(i, ev, f"returning {ret} of {blk['reserved']} "
                          f"reserved pages")
                st["free"] += ret
                blk["reserved"] -= ret
                if blk["reserved"] != int(ev["reserved"]):
                    _fail(i, ev, f"reservation total {ev['reserved']} "
                          f"disagrees with replay {blk['reserved']}")
            elif op == "swap_out":
                charge = int(ev["charge"])
                freed = int(ev["freed_reserved"])
                if freed != blk["reserved"]:
                    _fail(i, ev, f"swap-out freed {freed} but replayed "
                          f"reservation is {blk['reserved']}")
                st["free"] += freed
                st["tier_used"] += charge
                blk.update(status="swapped", reserved=0, charge=charge)
            elif op == "export_image":
                # custody leaves the pool entirely: the reservation comes
                # home, the charge rides with the in-flight image until a
                # matching import claims it in some pool
                freed = int(ev["freed_reserved"])
                if freed != blk["reserved"]:
                    _fail(i, ev, f"export freed {freed} but replayed "
                          f"reservation is {blk['reserved']}")
                st["free"] += freed
                inflight[(label, bid)] = int(ev["charge"])
                blk.update(status="exported", reserved=0, charge=0)
            # commit / map_shared / cow_break: placement metadata only —
            # mirror motion for them happens via reserve/retain events
        elif op == "swap_in":
            if blk is None or blk["status"] != "swapped":
                _fail(i, ev, f"swap-in of non-swapped bid {bid}")
            need = int(ev["reserve"])
            if need > st["free"]:
                _fail(i, ev, f"swap-in reserves {need} > {st['free']} free")
            if int(ev["charge"]) != blk["charge"]:
                _fail(i, ev, f"swap-in releases charge {ev['charge']} but "
                      f"swap-out paid {blk['charge']}")
            st["free"] -= need
            st["tier_used"] -= blk["charge"]
            blk.update(status="resident", reserved=need, charge=0)
        elif op == "import_image":
            if blk is not None and blk["status"] != "freed":
                _fail(i, ev, f"bid {bid} allocated twice")
            if ev.get("img_external"):
                # a crash-recovery snapshot image (DESIGN.md §12): its
                # "export" was a non-destructive snapshot in a previous
                # process, so there is no in-trace export to match
                pass
            else:
                key = (ev.get("img_pool"), ev.get("img_bid"))
                if key not in inflight:
                    _fail(i, ev, f"import of never-exported image "
                          f"(pool {key[0]!r}, bid {key[1]})")
                if int(ev["charge"]) != inflight[key]:
                    _fail(i, ev, f"import claims charge {ev['charge']} but "
                          f"export paid {inflight[key]}")
                del inflight[key]
            need = int(ev["reserve"])
            if need > st["free"]:
                _fail(i, ev, f"import reserves {need} > {st['free']} free")
            st["free"] -= need
            blocks[bid] = {"status": "resident", "reserved": need,
                           "charge": 0, "placed": set()}
        elif op == "import_dedup":
            # retransmission of an already-imported image resolved against
            # the idempotency ledger: the live block must really be
            # resident, and NO accounting moves (no double charge)
            if blk is None or blk["status"] != "resident":
                _fail(i, ev, f"import_dedup against non-resident bid {bid}")
        elif op == "snapshot_image":
            # non-destructive capture for crash recovery: custody does not
            # move, the block stays resident, nothing charges
            if blk is None or blk["status"] != "resident":
                _fail(i, ev, f"snapshot_image of non-resident bid {bid}")
        elif op == "drop_image":
            # an in-flight image retired without import (lost in transit /
            # rejected corrupt / shed) — its custody charge is abandoned
            # with it; dropping an external snapshot image has no in-trace
            # export to retire
            inflight.pop((ev.get("img_pool"), ev.get("img_bid")), None)
        elif op == "place":
            # placement stamp (VBIAllocator.place_block): the block's
            # pages now live on these devices; the placed set accumulates
            # so a later gather can name any device ever placed on
            if blk is None or blk["status"] != "resident":
                _fail(i, ev, f"place on non-resident bid {bid}")
            blk.setdefault("placed", set()).update(ev.get("placement", ()))
        elif op == "retain":
            n = int(ev["n_pages"])
            fb = ev.get("from_bid")
            if fb is not None:
                src = blocks.get(fb)
                if src is None or src["status"] != "resident":
                    _fail(i, ev, f"retain from non-resident bid {fb}")
                if src["reserved"] < n:
                    _fail(i, ev, f"retain moves {n} pages but bid {fb} "
                          f"reserves only {src['reserved']}")
                src["reserved"] -= n
            st["ledger"] += n
        elif op == "release":
            n = int(ev["n_pages"])
            if n > st["ledger"]:
                _fail(i, ev, f"releasing {n} ledger pages, only "
                      f"{st['ledger']} retained")
            st["ledger"] -= n
            st["free"] += n
        else:
            _fail(i, ev, f"unknown block op {op!r}")
        if not 0 <= st["free"] <= n_pages - 1:
            _fail(i, ev, f"mirror out of range: free={st['free']} "
                  f"(pool {n_pages - 1})")
        if not 0 <= st["tier_used"] <= max(swap_cap, 0):
            _fail(i, ev, f"swap tier out of range: used={st['tier_used']} "
                  f"(capacity {swap_cap})")
        st["peak"] = max(st["peak"], n_pages - 1 - st["free"])
    n_blocks = n_live = ledger_total = tier_total = peak_total = 0
    all_drained = True
    for label, st in pools.items():
        tag = f" (pool {label})" if label is not None else ""
        live = [b for b in st["blocks"].values()
                if b["status"] not in ("freed", "exported")]
        reserved = sum(b["reserved"] for b in live
                       if b["status"] == "resident")
        if st["free"] != st["n_pages"] - 1 - reserved - st["ledger"]:
            raise TraceCheckError(
                f"leaked pages at end of trace{tag}: free={st['free']}, "
                f"but {reserved} reserved + {st['ledger']} on ledger of "
                f"{st['n_pages'] - 1}")
        if not live and st["ledger"] == 0:
            if st["tier_used"] != 0:
                raise TraceCheckError(
                    f"swap charge asymmetric{tag}: {st['tier_used']} "
                    f"pages still held by a drained run")
            if st["free"] != st["n_pages"] - 1:
                raise TraceCheckError(
                    f"drained run leaked pages{tag}: free={st['free']} "
                    f"of {st['n_pages'] - 1}")
        else:
            all_drained = False
        n_blocks += len(st["blocks"])
        n_live += len(live)
        ledger_total += st["ledger"]
        tier_total += st["tier_used"]
        peak_total += st["peak"]
    if all_drained and inflight:
        raise TraceCheckError(
            f"{len(inflight)} exported block image(s) never imported "
            f"by a drained run: {sorted(inflight)}")
    if faults_open:
        by_kind: Dict[str, int] = {}
        for kind in faults_open.values():
            by_kind[kind] = by_kind.get(kind, 0) + 1
        raise TraceCheckError(
            f"{len(faults_open)} injected fault(s) never resolved "
            f"(silent drop): {by_kind} — every fault event needs a "
            f"matching recover event (retry_ok / fallback / shed)")
    return {"n_events": len(events), "n_block_ops": n_ops,
            "n_blocks": n_blocks, "live_blocks": n_live,
            "ledger_pages": ledger_total, "swap_pages_held": tier_total,
            "peak_pages_used": peak_total, "n_pools": len(pools),
            "images_in_flight": len(inflight), "n_faults": n_faults,
            "n_retry_ok": n_recovered["retry_ok"],
            "n_fallback": n_recovered["fallback"],
            "n_shed": n_recovered["shed"], "faults_unresolved": 0}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="Verify a recorded VBI serve trace (JSONL) against the "
                    "allocator conservation invariants; optionally convert "
                    "it to Chrome trace_event JSON for Perfetto.")
    ap.add_argument("trace", help="JSONL trace (launch/serve.py --trace)")
    ap.add_argument("--chrome", metavar="OUT.json", default=None,
                    help="also write the Chrome trace_event conversion")
    args = ap.parse_args(argv)
    events = read_jsonl(args.trace)
    summary = check_trace(events)
    print(f"[telemetry] {args.trace}: OK — {summary}")
    if args.chrome:
        rec = TraceRecorder()
        rec.events = list(events)
        rec.write_chrome(args.chrome)
        print(f"[telemetry] wrote Chrome trace_event JSON to {args.chrome}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
