"""The port's telemetry (``repro_torch/serve/telemetry.py`` and the
scheduler's emit sites) against the JAX package:

  * the metrics registry, ``Histogram``, ``StatsView``, ``percentile`` and
    ``props_str`` give the reference's values on seeded inputs;
  * trace parity: the tight open-loop run of ``tests/test_telemetry.py``
    (9 pages of 4, 4 slots, 5-page rows, a 16-page host tier, overlap on,
    the virtual clock; preemption and swap guaranteed) recorded through
    the port's scheduler and through the reference's gives the same event
    list, event for event, leaving out the host times ``ts``, ``dur`` and
    the span field ``sync`` (whether a read found its horizon done).  The
    schedule does not depend on the tokens (no EOS), so the reference's
    staging race (ROADMAP.md § C1) cannot move it; the untraced run's
    tokens are held against each request's own ``jax_greedy`` in
    ``tests/test_torch_traffic.py`` (the same run);
  * both checkers accept the port's trace with equal summaries, and the
    port's checker accepts the reference's trace;
  * tracing on and off: equal tokens, equal ``host_syncs``, equal
    counters except the ready-or-wait verdicts;
  * a tampered trace (a reservation, a free dropped, a gauge, a swap
    charge) makes both checkers raise;
  * JSONL round trip, the Chrome ``trace_event`` export and the CLI."""
import json
import math

import numpy as np
import pytest

from _torch_parity import bridged, one_torch_thread
from repro.core.vbi.address_space import VBProps as JProps
from repro.serve import telemetry as jt
from repro.serve.engine import PagedEngine as JEngine
from repro.serve.scheduler import Scheduler as JScheduler
from repro.serve.traffic import TrafficDriver as JDriver
from repro.serve.traffic import VirtualClock as JClock
from repro.serve.traffic import make_trace as j_make_trace
from repro_torch.core.vbi.address_space import VBProps
from repro_torch.serve import telemetry as tt
from repro_torch.serve.engine import PagedEngine
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.traffic import TrafficDriver, VirtualClock, make_trace

#: what may differ between two recordings of one schedule: host times and
#: whether the deferred read found its horizon already done
VOLATILE = ("ts", "dur", "sync")
TIMING = ("sync_device_ready", "sync_device_wait")


# --------------------------------------------------------------------------
# the metrics registry against the reference's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(3))
def test_histogram_and_percentile_match_reference(seed):
    rng = np.random.default_rng(seed)
    xs = rng.lognormal(-4, 2.5, size=int(rng.integers(1, 60))).tolist()
    xs += [1e-3, 0.3, 120.0]                       # samples on the edges
    edges = np.sort(rng.uniform(0, 1, 5)).tolist()
    for args in ((), (edges,)):
        th, jh = tt.Histogram(*args), jt.Histogram(*args)
        th.observe_many(xs)
        jh.observe_many(xs)
        assert th.buckets == jh.buckets
        assert th.snapshot() == jh.snapshot()
        assert th.mean == jh.mean and th.count == jh.count
    for q in (0, 1, 25, 50, 90, 99, 99.9, 100):
        assert tt.percentile(xs, q) == jt.percentile(xs, q)
        assert tt.percentile(xs[:1], q) == jt.percentile(xs[:1], q)
    assert math.isnan(tt.percentile([], 50))
    assert tt.LATENCY_EDGES_S == jt.LATENCY_EDGES_S


@pytest.mark.parametrize("seed", range(3))
def test_registry_and_stats_view_match_reference(seed):
    rng = np.random.default_rng(seed)
    regs = (tt.MetricsRegistry(), jt.MetricsRegistry())
    views = [mod.StatsView(m, prefix="sched.", keys=("a", "b"))
             for m, mod in zip(regs, (tt, jt))]
    for _ in range(50):
        op = rng.choice(["counter", "gauge", "hist", "view", "del"])
        name = f"x{int(rng.integers(0, 4))}"
        v = float(rng.normal())
        for m, sv in zip(regs, views):
            if op == "counter":
                m.counter(name).inc(int(abs(v) * 3))
            elif op == "gauge":
                m.gauge(name).set(v)
            elif op == "hist":
                m.histogram(name).observe(abs(v))
            elif op == "view":
                sv[name] = sv.get(name, 0) + 1
            elif op == "del" and name in sv:
                del sv[name]
    assert regs[0].snapshot() == regs[1].snapshot()
    assert dict(views[0]) == dict(views[1])
    assert list(views[0]) == list(views[1]) and repr(views[0]) == repr(
        views[1])
    with pytest.raises(KeyError):
        views[0]["nope"]


def test_props_str_matches_reference():
    rng = np.random.default_rng(0)
    masks = [0, int(VBProps.KV_CACHE | VBProps.SWAPPABLE)] + [
        int(x) for x in rng.integers(0, 1 << 18, 64)]
    for m in masks:
        m &= int(sum(VBProps))
        assert tt.props_str(VBProps(m)) == jt.props_str(JProps(m))


# --------------------------------------------------------------------------
# the tight traced run, through the port and through the reference
# --------------------------------------------------------------------------
TIGHT = dict(n_pages=9, page_size=4, max_seqs=4, max_pages_per_seq=5,
             host_swap_pages=16)


def _trace_args(cfg):
    return dict(vocab=cfg.vocab, n_requests=8, rate=2.0, seed=9,
                max_prompt=8, max_new_cap=12)


def _port_run(cfg, tp, telemetry):
    eng = PagedEngine(cfg, tp, device="cpu", **TIGHT)
    sched = Scheduler(eng, prefill_chunk=4, decode_horizon=4, overlap=True,
                      telemetry=telemetry)
    fin = TrafficDriver(sched, make_trace(**_trace_args(cfg)),
                        clock=VirtualClock()).run()
    assert sched.stats["preemptions"] >= 1 and sched.stats["swap_ins"] >= 1
    assert eng.pages_in_use == 0 and eng.alloc.swap.used_pages == 0
    return {r.rid: r.out for r in fin}, dict(sched.stats), eng


@pytest.fixture(scope="module")
def tight():
    """The port's run traced and untraced, and the reference's traced."""
    cfg, jp, tp = bridged("qwen3-0.6b")
    telem = tt.Telemetry(trace=True, clock=VirtualClock().now)
    out_on, stats_on, eng = _port_run(cfg, tp, telem)
    out_off, stats_off, _ = _port_run(cfg, tp, None)
    jtelem = jt.Telemetry(trace=True, clock=JClock().now)
    jeng = JEngine(cfg, jp, **TIGHT)
    jsched = JScheduler(jeng, prefill_chunk=4, decode_horizon=4,
                        overlap=True, telemetry=jtelem)
    JDriver(jsched, j_make_trace(**_trace_args(cfg)), clock=JClock()).run()
    return dict(telem=telem, out_on=out_on,
                stats_on=stats_on, out_off=out_off, stats_off=stats_off,
                eng=eng, jevents=jtelem.tracer.events)


def _strip(events):
    return [{k: v for k, v in e.items() if k not in VOLATILE}
            for e in events]


def test_trace_equals_reference_event_for_event(tight):
    mine, ref = _strip(tight["telem"].tracer.events), _strip(
        tight["jevents"])
    assert len(mine) == len(ref)
    for i, (a, b) in enumerate(zip(mine, ref)):
        assert a == b, f"event {i}"
    # every field is a plain Python value, as json writes it
    assert json.loads(json.dumps(tight["telem"].tracer.events)) == \
        tight["telem"].tracer.events


def test_both_checkers_accept_the_ports_trace(tight):
    events = tight["telem"].tracer.events
    summary = tt.check_trace(events)
    assert summary == jt.check_trace(events)
    assert summary["live_blocks"] == 0 and summary["swap_pages_held"] == 0
    assert summary["peak_pages_used"] > 0
    # and the port's checker reads the reference's trace
    assert tt.check_trace(tight["jevents"]) == jt.check_trace(
        tight["jevents"])
    ops = [e["op"] for e in events if e["type"] == "block"]
    assert "swap_out" in ops and "swap_in" in ops
    evs = [e["ev"] for e in events if e["type"] == "req"]
    assert evs.count("arrive") == evs.count("finish") == 8
    assert {"admit", "prefill_chunk", "first_token", "tokens",
            "preempt"} <= set(evs)
    assert any(e.get("resume") == "swap" for e in events
               if e["type"] == "req" and e["ev"] == "admit")
    names = {e["name"] for e in events if e["type"] == "span"}
    assert names == {"tick.admit", "tick.prefill_stage",
                     "tick.prefill_launch", "tick.prefill_finish",
                     "tick.decode_dispatch", "tick.decode_reconcile"}
    meta = [e for e in events if e["type"] == "meta"]
    assert meta[1]["tier_nbytes"]["full"] > 0 and meta[1]["overlap"]


def test_tracing_on_off_same_tokens_and_syncs(tight):
    assert tight["out_on"] == tight["out_off"]
    assert sorted(tight["out_on"]) == list(range(8))
    on, off = tight["stats_on"], tight["stats_off"]
    assert on["host_syncs"] == off["host_syncs"]
    assert {k: v for k, v in on.items() if k not in TIMING} == \
        {k: v for k, v in off.items() if k not in TIMING}


def test_engine_stats_join_the_registry(tight):
    eng, telem = tight["eng"], tight["telem"]
    assert isinstance(eng.stats, tt.StatsView)
    snap = telem.metrics.snapshot()
    assert snap["counters"]["engine.token_steps"] == \
        eng.stats["token_steps"] > 0
    assert snap["counters"]["sched.steps"] == tight["stats_on"]["steps"]
    assert snap["gauges"]["alloc.free_pages"]["value"] == TIGHT[
        "n_pages"] - 1
    assert snap["gauges"]["swap.pages_used"]["max"] > 0


def _corrupt(events, how):
    bad = [dict(e) for e in events]
    if how == "reserve":
        i = next(i for i, e in enumerate(bad)
                 if e["type"] == "block" and e["op"] == "reserve")
        bad[i]["grow"] += 1
    elif how == "free":
        bad = [e for e in bad
               if not (e["type"] == "block" and e["op"] == "free")]
    elif how == "gauge":
        i = next(i for i, e in enumerate(bad) if e["type"] == "gauge")
        bad[i]["values"] = dict(bad[i]["values"])
        bad[i]["values"]["alloc.free_pages"] += 1
    else:
        i = next(i for i, e in enumerate(bad)
                 if e["type"] == "block" and e["op"] == "swap_in")
        bad[i]["charge"] += 1
    return bad


@pytest.mark.parametrize("how", ["reserve", "free", "gauge", "swap_in"])
def test_corrupted_trace_fails_both_checkers(tight, how):
    bad = _corrupt(tight["telem"].tracer.events, how)
    with pytest.raises(tt.TraceCheckError):
        tt.check_trace(bad)
    with pytest.raises(jt.TraceCheckError):
        jt.check_trace(bad)


def test_jsonl_round_trip_and_chrome_export(tight, tmp_path):
    rec = tight["telem"].tracer
    p = tmp_path / "trace.jsonl"
    rec.write_jsonl(str(p))
    events = tt.read_jsonl(str(p))
    assert events == jt.read_jsonl(str(p)) == json.loads(json.dumps(
        rec.events))
    assert tt.check_trace(events) == tt.check_trace(rec.events)
    c = tmp_path / "trace.json"
    rec.write_chrome(str(c))
    doc = json.loads(c.read_text())
    ref = jt.TraceRecorder()
    ref.events = list(rec.events)
    assert doc == json.loads(json.dumps(ref.chrome_trace()))
    begins, ends = {}, {}
    for ev in doc["traceEvents"]:
        assert ev["ph"] in ("X", "b", "e", "i", "C", "M")
        if ev["ph"] in "be":
            side = begins if ev["ph"] == "b" else ends
            side[ev["id"]] = side.get(ev["id"], 0) + 1
    assert begins and begins == ends
    assert all("props_s" in ev["args"] for ev in doc["traceEvents"]
               if ev.get("cat") == "vbi" and "props" in ev["args"])


def test_cli_checks_and_converts(tight, tmp_path, capsys):
    p, c = tmp_path / "t.jsonl", tmp_path / "t.json"
    tight["telem"].tracer.write_jsonl(str(p))
    assert tt.main([str(p), "--chrome", str(c)]) == 0
    out = capsys.readouterr().out
    assert "OK" in out and "'live_blocks': 0" in out
    assert json.loads(c.read_text())["traceEvents"]
    p.write_text("".join(json.dumps(e) + "\n" for e in _corrupt(
        tight["telem"].tracer.events, "free")))
    with pytest.raises(tt.TraceCheckError):
        tt.main([str(p)])


def test_recorder_span_scoped_and_injected_clock():
    t = {"now": 0.0}
    rec = tt.TraceRecorder(clock=lambda: t["now"])
    with rec.span("tick.test", tick=3) as ext:
        t["now"] = 0.25
        ext["sync"] = "ready"
    sub = rec.scoped("decode")
    sub.req_event("arrive", 7, prompt_len=2)
    with sub.span("tick.admit") as ext:
        ext["admitted"] = 1
    assert rec.events == [
        {"ts": 0.0, "type": "span", "name": "tick.test", "dur": 0.25,
         "tick": 3, "sync": "ready"},
        {"ts": 0.25, "type": "req", "ev": "arrive", "rid": 7,
         "prompt_len": 2, "pool": "decode"},
        {"ts": 0.25, "type": "span", "name": "tick.admit", "dur": 0.0,
         "pool": "decode", "admitted": 1}]
    tel = tt.Telemetry(trace=True).scoped("p")
    assert tel.tracer.pool == "p" and tel.metrics is not None
    assert tt.Telemetry().tracer is None
