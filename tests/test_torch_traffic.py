"""The port's open-loop traffic (``repro_torch/serve/traffic.py``, the
scheduler's streaming hooks and the launcher's ``--traffic``, ``--trace``
and ``--metrics``) against the JAX package:

  * ``make_trace``, ``poisson_arrivals`` and ``bursty_arrivals`` give the
    reference's traces field for field, for both processes and several
    seeds; ``LatencyAccountant.summary`` gives the reference's numbers on
    the hand-computed trace of ``tests/test_traffic.py`` and on seeded
    random traces; ``make_slo_shed_policy`` picks the reference's victim;
  * open-loop replay on the virtual clock equals the closed-loop run of
    the same requests, each request equal to its own ``jax_greedy`` (not
    to the reference scheduler's output: ROADMAP.md § C1), for qwen3,
    gemma3 and recurrentgemma smoke; the pool drains and the accountant's
    token counts equal each request's ``len(out)``;
  * two replays agree down to every accountant number; overlap on and off
    give equal tokens, under preemption and swap too, and the pool and
    the host tier drain;
  * the launcher's ``--traffic poisson --trace t.jsonl --metrics`` exits
    cleanly, its trace passes both checkers and its summary is finite."""
import dataclasses
import math
import re

import numpy as np
import pytest

from _torch_parity import bridged, jax_greedy, one_torch_thread
from repro.serve import telemetry as jt
from repro.serve import traffic as jtr
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import telemetry as tt
from repro_torch.serve import traffic as ttr
from repro_torch.serve.engine import PagedEngine
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.traffic import (LatencyAccountant, TrafficDriver,
                                       VirtualClock, make_trace)


def _fields(trace):
    return [dataclasses.asdict(r) for r in trace]


# --------------------------------------------------------------------------
# trace generation against the reference's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("process", ["poisson", "bursty"])
@pytest.mark.parametrize("seed", [0, 7, 21])
def test_make_trace_matches_reference(process, seed):
    kw = dict(vocab=151936, n_requests=48, rate=2.0, seed=seed,
              process=process)
    mine = make_trace(**kw)
    assert _fields(mine) == _fields(jtr.make_trace(**kw))
    assert all(type(t) is int for r in mine for t in r.prompt)
    clipped = dict(kw, max_prompt=8, max_new_cap=12, vocab=256)
    assert _fields(make_trace(**clipped)) == _fields(
        jtr.make_trace(**clipped))
    disagg = dict(kw, rate=0.5)
    assert _fields(make_trace(profiles=ttr.DISAGG_PROFILES, **disagg)) == \
        _fields(jtr.make_trace(profiles=jtr.DISAGG_PROFILES, **disagg))
    assert [dataclasses.asdict(p) for p in ttr.MIXED_PROFILES + (
        ttr.LONGDOC,)] == [dataclasses.asdict(p) for p in
                           jtr.MIXED_PROFILES + (jtr.LONGDOC,)]


def test_arrival_processes_match_reference():
    for seed in range(3):
        a = ttr.poisson_arrivals(500, 3.0, np.random.default_rng(seed))
        b = jtr.poisson_arrivals(500, 3.0, np.random.default_rng(seed))
        np.testing.assert_array_equal(a, b)
        a = ttr.bursty_arrivals(500, 3.0, np.random.default_rng(seed), 2.5)
        b = jtr.bursty_arrivals(500, 3.0, np.random.default_rng(seed), 2.5)
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# the latency accountant and the shed policy against the reference's
# --------------------------------------------------------------------------
def _hand_trace(acct):
    """tests/test_traffic.py's four hand-timed requests."""
    acct.on_arrival(0, 0.0)
    for t in (0.2, 0.4, 0.6, 0.8, 1.0):
        acct.on_tokens(0, t)
    acct.on_finish(0, 1.0)
    acct.on_arrival(1, 1.0)
    acct.on_tokens(1, 1.1)
    acct.on_finish(1, 1.2)
    acct.on_arrival(2, 2.0)
    acct.on_tokens(2, 3.0, n=2)
    acct.on_tokens(2, 3.4)
    acct.on_finish(2, 3.4)
    acct.on_arrival(3, 3.0)
    acct.on_tokens(3, 3.5)
    acct.on_tokens(3, 4.0)
    acct.on_finish(3, 4.0)


def test_accountant_hand_computed_trace_matches_reference():
    mine, ref = LatencyAccountant(), jtr.LatencyAccountant()
    assert mine.summary() == ref.summary() == {"n_finished": 0}
    _hand_trace(mine)
    _hand_trace(ref)
    s = mine.summary(slo_ttft=0.5, slo_tpot=0.3)
    assert s == ref.summary(slo_ttft=0.5, slo_tpot=0.3)
    assert s["ttft_p50"] == pytest.approx(0.35)
    assert s["tpot_p99"] == pytest.approx(0.491)
    assert s["slo_attainment"] == pytest.approx(0.5)
    assert mine.metrics.snapshot() == ref.metrics.snapshot()


def _random_run(acct, rng, n):
    for rid in range(n):
        t = float(rng.uniform(0, 50))
        acct.on_arrival(rid, t)
        r = rng.random()
        if r < 0.1:
            continue                       # never finishes
        if r < 0.15:
            acct.on_shed(rid, t + 1.0)
            continue
        t += float(rng.exponential(1.0))
        for _ in range(int(rng.integers(1, 8))):
            acct.on_tokens(rid, t, int(rng.integers(0, 3)))
            t += float(rng.exponential(0.3))
        acct.on_finish(rid, t)


@pytest.mark.parametrize("seed", range(4))
def test_accountant_random_traces_match_reference(seed):
    n = int(np.random.default_rng(seed).integers(1, 40))
    mine, ref = LatencyAccountant(), jtr.LatencyAccountant()
    _random_run(mine, np.random.default_rng(seed), n)
    _random_run(ref, np.random.default_rng(seed), n)
    slo = dict(slo_ttft=float(seed % 3) + 0.2, slo_tpot=0.3)
    s = mine.summary(**slo)
    assert s == ref.summary(**slo)
    if s["n_finished"]:
        assert s["goodput_req_s"] <= s["throughput_req_s"] + 1e-12
        assert s["ttft_p50"] <= s["ttft_p99"] + 1e-12


class _Req:
    def __init__(self, rid):
        self.rid = rid


def test_slo_shed_policy_picks_the_reference_victim():
    rng = np.random.default_rng(3)
    mine, ref = LatencyAccountant(), jtr.LatencyAccountant()
    for rid in range(12):
        t = float(rng.uniform(0, 5))
        for acct in (mine, ref):
            acct.on_arrival(rid, t)
            if rid % 3 == 0:
                acct.on_tokens(rid, t + 0.5)
    for now in (1.0, 3.0, 6.0, 9.0):
        clock, jclock = VirtualClock(), jtr.VirtualClock()
        clock.wait_until(now)
        jclock.wait_until(now)
        queued = [_Req(r) for r in rng.permutation(13)]   # 12 unseen
        for slo in (0.5, 2.0):
            got = ttr.make_slo_shed_policy(mine, clock, slo)(queued)
            want = jtr.make_slo_shed_policy(ref, jclock, slo)(queued)
            assert got is want


# --------------------------------------------------------------------------
# open-loop replay through the port's scheduler
# --------------------------------------------------------------------------
_GREEDY = {}


def _greedy(arch, prompt, max_new):
    key = (arch, tuple(prompt), max_new)
    if key not in _GREEDY:
        cfg, jp, _ = bridged(arch)
        _GREEDY[key] = jax_greedy(cfg, jp, prompt, max_new)
    return _GREEDY[key]


def _mk_sched(arch, overlap=False, cache=False, **eng_kw):
    cfg, _, tp = bridged(arch)
    kw = dict(n_pages=33, page_size=8, max_seqs=2, max_pages_per_seq=8)
    kw.update(eng_kw)
    eng = PagedEngine(cfg, tp, device="cpu", **kw)
    pc = PrefixCache(page_size=kw["page_size"]) if cache else None
    sched = Scheduler(eng, prefill_chunk=4, decode_horizon=4,
                      prefix_cache=pc, overlap=overlap)
    return eng, sched


def _replay(arch, trace, dt=1.0, **kw):
    eng, sched = _mk_sched(arch, **kw)
    drv = TrafficDriver(sched, trace, clock=VirtualClock(dt=dt))
    out = {r.rid: r.out for r in drv.run()}
    return out, drv, eng, sched


@pytest.fixture(scope="module")
def replays():
    """Per arch, one seeded trace served closed loop, and open loop on the
    virtual clock with overlap off (False) and on (True): ``(trace,
    {mode: (tokens by rid, driver, engine, scheduler)})``, built on first
    use (the closed loop has no driver)."""
    built = {}

    def get(arch):
        if arch not in built:
            cfg = bridged(arch)[0]
            trace = make_trace(cfg.vocab, n_requests=8, rate=0.5, seed=3,
                               max_prompt=12, max_new_cap=8)
            eng, sched = _mk_sched(arch)
            for tr in trace:
                sched.add_request(tr.prompt, tr.max_new, rid=tr.rid)
            runs = {"closed": ({r.rid: r.out for r in sched.run()}, None,
                               eng, sched)}
            for ov in (False, True):
                runs[ov] = _replay(arch, trace, overlap=ov)
            built[arch] = trace, runs
        return built[arch]
    return get


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma3-12b",
                                  "recurrentgemma-9b"])
def test_open_loop_replay_matches_closed_loop_and_greedy(replays, arch):
    trace, runs = replays(arch)
    closed, (out, drv, eng, _) = runs["closed"][0], runs[False]
    assert out == closed
    assert eng.pages_in_use == 0 and eng.alloc.free_pages == 32
    for tr in trace:
        assert out[tr.rid] == _greedy(arch, tr.prompt, tr.max_new), tr.rid
        assert drv.acct.reqs[tr.rid].n_tokens == len(out[tr.rid])
    s = drv.acct.summary()
    assert s["n_finished"] == len(trace) and s["n_shed"] == 0


def test_open_loop_replay_is_reproducible(replays):
    """Two replays agree on tokens and on every accountant number (the
    virtual clock makes latencies deterministic); the cache on and a
    finer clock make the SLOs bind."""
    trace, runs = replays("qwen3-0.6b")
    again = []
    for _ in range(2):
        out, drv, _, _ = _replay("qwen3-0.6b", trace, dt=0.25, cache=True)
        again.append((out, drv.acct.summary(slo_ttft=0.25, slo_tpot=0.09),
                      drv.acct.metrics.snapshot()))
    assert again[0] == again[1]
    assert again[0][0] == runs["closed"][0]
    assert 0 < again[0][1]["slo_attainment"] < 1


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma3-12b"])
def test_overlap_on_off_equal_tokens(replays, arch):
    _, runs = replays(arch)
    for ov in (False, True):
        out, drv, eng, sched = runs[ov]
        assert eng.pages_in_use == 0 and sched._pending is None
        assert (sched.stats["overlap_staged_ticks"] > 0) == ov
        assert all(drv.acct.reqs[r].n_tokens == len(o)
                   for r, o in out.items())
    assert runs[True][0] == runs[False][0] == runs["closed"][0]


def test_overlap_exact_under_preemption_and_swap():
    """The hard case (``tests/test_traffic.py:255``): a pool small enough
    that requests are preempted to the host swap tier while arrivals,
    swap-ins and staging race the in-flight horizon."""
    cfg = bridged("qwen3-0.6b")[0]
    trace = make_trace(cfg.vocab, n_requests=8, rate=2.0, seed=9,
                       max_prompt=8, max_new_cap=12)
    tight = dict(n_pages=9, page_size=4, max_seqs=4, max_pages_per_seq=5,
                 host_swap_pages=16)
    outs = {}
    for ov in (False, True):
        outs[ov], drv, eng, sched = _replay("qwen3-0.6b", trace,
                                            overlap=ov, **tight)
        assert (sched.stats["overlap_staged_ticks"] > 0) == ov
        assert sched.stats["preemptions"] >= 1
        assert sched.stats["swap_ins"] == sched.stats["swap_outs"] >= 1
        assert eng.pages_in_use == 0 and eng.alloc.swap.used_pages == 0
        assert eng.free_pages == eng.alloc.free_pages
        assert all(drv.acct.reqs[r].n_tokens == len(o)
                   for r, o in outs[ov].items())
    assert outs[True] == outs[False]
    for tr in trace:
        assert outs[True][tr.rid] == _greedy("qwen3-0.6b", tr.prompt,
                                             tr.max_new)


def test_streaming_hooks_fire_in_closed_loop():
    """``on_tokens`` and ``on_finish`` without the driver: every token is
    announced once, every request finishes once."""
    cfg = bridged("qwen3-0.6b")[0]
    seen, done = {}, []
    eng, sched = _mk_sched("qwen3-0.6b", overlap=True)
    sched.on_tokens = lambda req, n: seen.__setitem__(
        req.rid, seen.get(req.rid, 0) + n)
    sched.on_finish = lambda req: done.append(req.rid)
    rng = np.random.default_rng(1)
    for n in (3, 9, 5):
        sched.add_request(rng.integers(0, cfg.vocab, n).tolist(), 6)
    fin = sched.run()
    assert sorted(done) == [0, 1, 2]
    assert seen == {r.rid: len(r.out) for r in fin}


def test_launcher_traffic_trace_metrics_on_cpu(tmp_path, capsys):
    path = tmp_path / "t.jsonl"
    fin, eng, sched = launch_serve.main([
        "--traffic", "poisson", "--requests", "5", "--rate", "4",
        "--trace", str(path), "--metrics", "--overlap", "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(fin) == 5 and eng.pages_in_use == sched.prefix_cache.n_pages
    events = tt.read_jsonl(str(path))
    assert tt.check_trace(events) == jt.check_trace(events)
    evs = [e["ev"] for e in events if e["type"] == "req"]
    assert evs.count("arrive") == evs.count("finish") == 5
    m = re.search(r"ttft p50=([\d.]+)ms p99=([\d.]+)ms \| "
                  r"tpot p50=([\d.]+)ms p99=([\d.]+)ms", out)
    assert m and all(math.isfinite(float(x)) for x in m.groups())
    assert "goodput=" in out and "checker OK" in out
    assert '"traffic.ttft_s"' in out and '"sched.steps"' in out
    # the chrome format, and --metrics alone (no trace file)
    chrome = tmp_path / "t.json"
    launch_serve.main(["--traffic", "bursty", "--requests", "3", "--rate",
                       "8", "--trace", str(chrome), "--trace-format",
                       "chrome", "--device", "cpu"])
    assert chrome.read_text().startswith('{"traceEvents"')
    _, _, sched = launch_serve.main(["--requests", "2", "--max-new", "3",
                                     "--metrics", "--device", "cpu"])
    assert sched.tracer is None and sched.telemetry is not None


def test_launcher_traffic_flags():
    ap = launch_serve._parser()
    args = ap.parse_args([])
    assert args.traffic is None and args.trace is None and not args.metrics
    assert args.rate == 2.0 and args.trace_format == "jsonl"
    assert math.isinf(args.slo_ttft) and math.isinf(args.slo_tpot)
    with pytest.raises(SystemExit):
        ap.parse_args(["--traffic", "uniform"])
