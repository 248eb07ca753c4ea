"""The port's fault plane and exact recovery (``repro_torch/serve/
faults.py``, ``serve/recovery.py`` and the scheduler's fault sites)
against the JAX package:

  * ``_u01`` gives the reference's draw for every class; the port's and
    the reference's ``FaultPlan`` fire the same sequence over the same
    crossings, a higher rate fires a superset, ``force`` consumes no
    draw, and ``simdram_rates`` gives the reference's rates;
  * ``retry_call`` is bounded, records its backoff, carries every fired
    fault through ``RetryExhausted``/``pending_faults``, and the plan
    refuses a double resolution;
  * the port's plan on the port's allocator raises the port's own
    ``TransientFault``/``ImageLost`` before anything changes; image
    transit at the pool level: a lost image is cleared by retransmission
    (no double charge), a corrupt one fails its checksum with nothing
    charged and its drop is accounted;
  * unified chaos (4 slots, 33 pages of 8, 8 requests, rates 0.05 and
    0.1, the virtual clock, traced): each request's tokens equal its
    ``jax_greedy`` and the port's fault-free run, faults fire and all
    resolve, the pool drains, both checkers accept the trace with
    ``n_faults`` equal to the faults fired, and the trace equals the
    reference scheduler's run of the same schedule event for event
    (leaving out host times).  The schedule does not depend on the tokens
    (no EOS), so the reference's staging race (ROADMAP.md § C1) cannot
    move it; tokens are never held against the reference scheduler;
  * a poisoned decode tick retries with nothing committed twice;
  * the degradation ladder shrinks the horizon, then sheds one request,
    accounted."""
import numpy as np
import pytest
import torch

from _torch_parity import bridged, jax_greedy, one_torch_thread
from repro.serve import faults as jf
from repro.serve import telemetry as jt
from repro.serve.engine import PagedEngine as JEngine
from repro.serve.scheduler import Scheduler as JScheduler
from repro.serve.traffic import TrafficDriver as JDriver
from repro.serve.traffic import VirtualClock as JClock
from repro.serve.traffic import make_trace as j_make_trace
from repro_torch.core.vbi import kvcache as tk
from repro_torch.core.vbi.blocks import (ImageIntegrityError, PagePool,
                                         VBIAllocator)
from repro_torch.serve import faults as tf
from repro_torch.serve import telemetry as tt
from repro_torch.serve.engine import PagedEngine
from repro_torch.serve.faults import (FAULT_KINDS, FaultPlan, ImageLost,
                                      TransientFault, install_faults,
                                      simdram_rates)
from repro_torch.serve.recovery import (RetryExhausted, RetryPolicy,
                                        retry_call)
from repro_torch.serve.scheduler import DEGRADE_TICKS, Scheduler
from repro_torch.serve.traffic import TrafficDriver, VirtualClock, make_trace

#: what may differ between two recordings of one schedule: host times and
#: whether the deferred read found its horizon already done
VOLATILE = ("ts", "dur", "sync")


# --------------------------------------------------------------------------
# the seeded streams and the retry primitive (no engine)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 7, 2 ** 40 + 3])
def test_u01_matches_reference(seed):
    for c in range(len(FAULT_KINDS) + 17):      # the classes, and the
        for n in range(1000):                   # corruption-mode streams
            assert tf._u01(seed, c, n) == jf._u01(seed, c, n), (c, n)
    assert tf.FAULT_KINDS == jf.FAULT_KINDS


def test_fault_streams_match_reference_and_are_monotone():
    rates = {"alloc": 0.3, "swap_in": 0.1, "image_loss": 0.05,
             "decode_tick": 0.2}
    mine, ref = FaultPlan(rates, seed=3), jf.FaultPlan(rates, seed=3)
    order = np.random.default_rng(0).choice(FAULT_KINDS, 3000)
    assert [mine.fires(k) for k in order] == [ref.fires(k) for k in order]
    assert mine.fired == ref.fired and mine._n == ref._n
    lo, hi = FaultPlan(0.05, seed=3), FaultPlan(0.2, seed=3)
    fire_lo = [lo.fires("alloc") for _ in range(500)]
    fire_hi = [hi.fires("alloc") for _ in range(500)]
    assert 0 < sum(fire_lo) < sum(fire_hi)
    assert all(h for l, h in zip(fire_lo, fire_hi) if l)
    # draw n of (seed, kind) ignores other streams' consumption
    a = FaultPlan(0.1, seed=3)
    seq = [a.fires("swap_in") for _ in range(200)]
    b = FaultPlan(0.1, seed=3)
    for _ in range(57):
        b.fires("alloc")
    assert [b.fires("swap_in") for _ in range(200)] == seq
    # force() fires unconditionally and consumes NO draw index
    c = FaultPlan(0.1, seed=3)
    c.force("swap_in")
    assert c.fires("swap_in") is True
    assert [c.fires("swap_in") for _ in range(200)] == seq
    with pytest.raises(ValueError, match="unknown fault class"):
        FaultPlan({"bogus": 0.1})


@pytest.mark.parametrize("spec,scale", [("simdram:node=22", 1.0),
                                        ("simdram:node=45,rows=3", 4.0),
                                        ("simdram:node=32,var=0.1", 2.0)])
def test_simdram_rates_match_reference(spec, scale):
    rates = simdram_rates(spec, scale=scale)
    assert rates == jf.simdram_rates(spec, scale=scale)
    assert set(rates) == set(FAULT_KINDS)
    assert all(0.0 < r <= 1.0 for r in rates.values())
    plan = tf.plan_from_args(0.5, 9, model=spec, scale=scale)
    assert plan.rates == rates and plan.seed == 9
    assert tf.plan_from_args(0.25, 1).rates == {k: 0.25 for k in FAULT_KINDS}
    with pytest.raises(ValueError):
        simdram_rates("simdram:bogus=1")


def test_retry_call_bounded_backoff_and_accounting():
    plan = FaultPlan({}, seed=0)
    pol = RetryPolicy(max_attempts=3, base_backoff=0.5)
    plan.force("alloc", 2)
    calls = []

    def op():
        calls.append(1)
        plan.check("alloc")
        return "ok"

    out, fired = retry_call(op, policy=pol)
    assert out == "ok" and len(fired) == 2 and len(calls) == 3
    assert [f.backoff for f in fired] == [0.5, 1.0]    # recorded, not slept
    plan.resolve(fired, "retry_ok")
    plan.force("alloc", pol.max_attempts + 1)
    with pytest.raises(RetryExhausted) as ei:
        retry_call(op, policy=pol)
    assert len(ei.value.faults) == pol.max_attempts + 1
    plan.resolve(ei.value.faults, "fallback")
    plan.force("alloc", 1)

    def op_bad():
        plan.check("alloc")
        raise ValueError("boom")

    with pytest.raises(ValueError) as ev:
        retry_call(op_bad, policy=pol)
    assert len(ev.value.pending_faults) == 1
    plan.resolve(ev.value.pending_faults, "fallback")
    assert plan.stats == {"fired": dict(plan.fired),
                          "resolved": {"retry_ok": 2, "fallback": 5,
                                       "shed": 0}, "unresolved": 0}
    with pytest.raises(RuntimeError, match="resolved twice"):
        plan.resolve(ev.value.pending_faults, "fallback")


# --------------------------------------------------------------------------
# the port's plan on the port's allocator; image transit (pool level)
# --------------------------------------------------------------------------
def _mk_pool(n_pages=17, page_size=2, max_seqs=3, rowP=8, swap=0):
    pool = PagePool(n_layers=1, n_pages=n_pages, page_size=page_size,
                    n_kv=1, head_dim=2, max_seqs=max_seqs,
                    max_pages_per_seq=rowP, device="cpu")
    return pool, VBIAllocator(pool, host_swap_pages=swap)


def _feed(pool, al, blk, n=1):
    for _ in range(n):
        al.reserve(blk, blk.n_tokens + 1)
        mask = torch.zeros(pool.max_seqs, dtype=torch.bool)
        mask[blk.slot] = True
        tk.reserve_positions(pool.state, mask, has_full=pool.has_full)
        al.commit(blk, blk.n_tokens + 1)


def test_port_plan_raises_port_faults_before_any_change():
    pool, al = _mk_pool(swap=16)
    plan = FaultPlan({}, seed=0)
    install_faults(al, plan)
    blk = al.alloc(0)
    _feed(pool, al, blk, 3)
    free0, stats0 = al.free_pages, dict(al.stats)
    for kind, op in (("alloc", lambda: al.reserve_pages(blk, 4)),
                     ("swap_out", lambda: al.swap_out(blk))):
        plan.force(kind)
        with pytest.raises(TransientFault) as ei:
            op()
        assert type(ei.value) is TransientFault and ei.value.kind == kind
        assert al.free_pages == free0 and al.stats == stats0
    assert al.swap_out(blk)
    plan.force("swap_in")
    with pytest.raises(TransientFault):
        al.swap_in(blk, 1)
    assert blk.status == "swapped" and 1 not in al.blocks
    al.swap_in(blk, 1)
    img = al.export_image(blk, tokens=[1, 2, 3])
    plan.force("image_loss")
    with pytest.raises(ImageLost):
        al.import_image(img, 2)
    assert 2 not in al.blocks
    plan.resolve(list(plan.unresolved), "retry_ok")
    assert not isinstance(ei.value, jf.FaultError)


def test_image_transit_faults_lost_corrupt_dedup():
    rec = tt.TraceRecorder(clock=lambda: 0.0)
    pool, al = _mk_pool()
    al.attach_tracer(rec)
    plan = FaultPlan({}, seed=0)
    install_faults(al, plan)
    blk = al.alloc(0)
    _feed(pool, al, blk, 5)
    img = al.export_image(blk, tokens=list(range(5)))
    free0 = al.free_pages
    # a lost image: the retry IS the retransmission
    plan.force("image_loss")
    blk2, fired = retry_call(lambda: al.import_image(img, 1))
    plan.resolve(fired, "retry_ok", tracer=rec)
    assert len(fired) == 1 and blk2.n_tokens == 5
    # re-delivery while resident: same block, no new charge, no draw
    assert al.import_image(img, 0) is blk2
    assert al.free_pages == free0 - img.n_pages
    assert al.stats["image_imports_deduped"] == 1
    # corruption on the next delivery: caught with nothing charged
    img2 = al.export_image(blk2, tokens=img.tokens)
    free1 = al.free_pages
    plan.force("image_corrupt")
    with pytest.raises(ImageIntegrityError) as ei:
        al.import_image(img2, 1)
    assert ei.value.fault_id is not None
    assert al.free_pages == free1 and 1 not in al.blocks
    assert img2.verify()                         # the original untouched
    al.drop_image(img2)
    plan.resolve([ei.value.fault_id], "fallback", tracer=rec,
                 detail="dropped")
    assert plan.stats["unresolved"] == 0 and al.stats["image_drops"] == 1
    al.attach_tracer(None)
    summary = tt.check_trace(rec.events)
    assert summary == jt.check_trace(rec.events)
    assert summary["faults_unresolved"] == 0 and summary["n_faults"] == 2
    assert summary["images_in_flight"] == 0 and summary["live_blocks"] == 0


def test_corruption_damages_both_ways_as_the_reference():
    """``deliver`` flips a payload bit or falsifies the charge, choosing
    by its own stream: the reference's choice and position per fault."""
    pool, al = _mk_pool()
    blk = al.alloc(0)
    _feed(pool, al, blk, 5)
    img = al.export_image(blk, tokens=list(range(5)))
    mine, ref = FaultPlan({"image_corrupt": 1.0}, seed=5), \
        jf.FaultPlan({"image_corrupt": 1.0}, seed=5)
    modes = set()
    for _ in range(12):
        a, b = mine.deliver(img), ref.deliver(img)
        assert not a.verify() and a.charge == b.charge
        np.testing.assert_array_equal(a.k, b.k)
        modes.add("charge" if a.charge != img.charge else "bit")
    assert modes == {"charge", "bit"} and img.verify()


# --------------------------------------------------------------------------
# chaos runs through the scheduler
# --------------------------------------------------------------------------
GEO = dict(n_pages=33, page_size=8, max_seqs=4, max_pages_per_seq=8)
TRACE = dict(n_requests=8, rate=2.0, seed=3, max_prompt=12, max_new_cap=8)
RATES = (0.05, 0.1)


def _port_run(tp, cfg, plan, telemetry=None):
    eng = PagedEngine(cfg, tp, device="cpu", **GEO)
    sched = Scheduler(eng, prefill_chunk=8, decode_horizon=8,
                      telemetry=telemetry, faults=plan)
    fin = TrafficDriver(sched, make_trace(cfg.vocab, **TRACE),
                        clock=VirtualClock()).run()
    return {r.rid: r.out for r in fin}, eng, sched


@pytest.fixture(scope="module")
def chaos():
    """The port's fault-free run, its traced chaos run at each rate, the
    reference scheduler's traced chaos run at each rate, and each
    request's ``jax_greedy``."""
    cfg, jp, tp = bridged("qwen3-0.6b")
    clean, _, _ = _port_run(tp, cfg, None)
    runs, jevents = {}, {}
    for r in RATES:
        telem = tt.Telemetry(trace=True, clock=VirtualClock().now)
        plan = FaultPlan(r, seed=7)
        out, eng, sched = _port_run(tp, cfg, plan, telem)
        install_faults(eng.alloc, None)
        eng.alloc.attach_tracer(None)
        runs[r] = dict(out=out, eng=eng, sched=sched, plan=plan,
                       events=telem.tracer.events)
        jtelem = jt.Telemetry(trace=True, clock=JClock().now)
        jeng = JEngine(cfg, jp, **GEO)
        jsched = JScheduler(jeng, prefill_chunk=8, decode_horizon=8,
                            telemetry=jtelem, faults=jf.FaultPlan(r, seed=7))
        JDriver(jsched, j_make_trace(cfg.vocab, **TRACE),
                clock=JClock()).run()
        jevents[r] = jtelem.tracer.events
    greedy = {tr.rid: jax_greedy(cfg, jp, tr.prompt, tr.max_new)
              for tr in make_trace(cfg.vocab, **TRACE)}
    return dict(clean=clean, runs=runs, jevents=jevents, greedy=greedy)


@pytest.mark.parametrize("rate", RATES)
def test_unified_chaos_exact_and_drained(chaos, rate):
    run = chaos["runs"][rate]
    assert chaos["clean"] == chaos["greedy"]
    assert run["out"] == chaos["clean"], f"rate {rate} changed tokens"
    plan = run["plan"]
    # the chaos is real at the top rate (at 0.05 this schedule's draws
    # all pass, as in the reference's run of it)
    assert sum(plan.fired.values()) > 0 or rate < max(RATES)
    assert plan.stats["unresolved"] == 0
    assert run["eng"].pages_in_use == 0 and run["eng"].alloc.free_pages == 32
    st = run["sched"].stats
    assert st["fault_retries"] + st["decode_tick_retries"] == \
        plan.resolved["retry_ok"]
    assert st["fault_fallbacks"] == plan.resolved["fallback"]
    summary = tt.check_trace(run["events"])
    assert summary == jt.check_trace(run["events"])
    assert summary["n_faults"] == sum(plan.fired.values())
    assert summary["faults_unresolved"] == 0
    assert summary["live_blocks"] == 0


@pytest.mark.parametrize("rate", RATES)
def test_unified_chaos_trace_equals_reference(chaos, rate):
    mine = [{k: v for k, v in e.items() if k not in VOLATILE}
            for e in chaos["runs"][rate]["events"]]
    ref = [{k: v for k, v in e.items() if k not in VOLATILE}
           for e in chaos["jevents"][rate]]
    pick = ("fault_id", "kind", "outcome", "detail")
    plane = [[{k: e.get(k) for k in pick} for e in evs
              if e["type"] in ("fault", "recover")] for evs in (mine, ref)]
    assert plane[0] == plane[1]
    assert plane[0] or rate < max(RATES)
    assert len(mine) == len(ref)
    for i, (a, b) in enumerate(zip(mine, ref)):
        assert a == b, f"event {i}"


def test_decode_tick_poison_retries_exact():
    cfg, jp, tp = bridged("qwen3-0.6b")
    prompt = np.random.default_rng(4).integers(0, cfg.vocab, 6).tolist()

    def run(plan):
        eng = PagedEngine(cfg, tp, n_pages=33, page_size=8, max_seqs=2,
                          max_pages_per_seq=8, device="cpu")
        sched = Scheduler(eng, prefill_chunk=8, decode_horizon=4,
                          faults=plan)
        sched.add_request(prompt, 6, rid=0)
        return {r.rid: r.out for r in sched.run()}, sched, eng

    ref, _, eng0 = run(None)
    plan = FaultPlan({}, seed=0)
    plan.force("decode_tick", 3)
    out, sched, eng = run(plan)
    assert out == ref == {0: jax_greedy(cfg, jp, prompt, 6)}
    assert sched.stats["decode_tick_retries"] == 3
    assert plan.resolved["retry_ok"] == 3 and plan.stats["unresolved"] == 0
    # nothing dispatched twice: the same token steps as the clean run
    assert eng.stats == eng0.stats


def test_degradation_ladder_shrinks_horizon_then_sheds():
    cfg, jp, tp = bridged("qwen3-0.6b")
    rng = np.random.default_rng(6)
    telem = tt.Telemetry(trace=True)
    plan = FaultPlan({}, seed=0)
    eng = PagedEngine(cfg, tp, device="cpu", **GEO)
    sched = Scheduler(eng, prefill_chunk=8, decode_horizon=8,
                      telemetry=telem, faults=plan)
    shed_seen = []
    sched.on_shed = shed_seen.append
    sched.shed_policy = lambda queued: queued[-1]    # victim: youngest
    prompts = [rng.integers(0, cfg.vocab, 6).tolist() for _ in range(2)]
    for i, p in enumerate(prompts):
        sched.add_request(p, 12, rid=i)
    exhaust = sched.retry.max_attempts + 1
    plan.force("alloc", exhaust)                 # rung 1: horizon -> 1
    sched.step()
    assert sched.stats["horizon_shrinks"] == 1
    assert sched.effective_horizon == 1 and sched.decode_horizon == 8
    assert len(sched.shed) == 0 and len(sched.queue) == 2
    plan.force("alloc", exhaust)                 # rung 2: shed ONE
    sched.step()
    assert sched.stats["fault_sheds"] == 1
    assert [r.rid for r in sched.shed] == [1] == [r.rid for r in shed_seen]
    assert plan.resolved["shed"] == exhaust
    # the engine runs K = 1 while the ladder holds, then K = 8 again
    ks = []
    decode_many = eng.decode_many

    def spy(tokens, mask, steps, k):
        ks.append(k)
        return decode_many(tokens, mask, steps, k)
    eng.decode_many = spy
    out = {r.rid: r.out for r in sched.run()}
    assert ks[0] == 1 and 8 in ks
    assert sched._degrade_until == 1 + DEGRADE_TICKS
    assert out == {0: jax_greedy(cfg, jp, prompts[0], 12)}
    assert eng.pages_in_use == 0 and plan.stats["unresolved"] == 0
    install_faults(eng.alloc, None)
    eng.alloc.attach_tracer(None)
    summary = tt.check_trace(telem.tracer.events)
    assert summary == jt.check_trace(telem.tracer.events)
    assert summary["faults_unresolved"] == 0
    assert summary["n_shed"] == exhaust
    evs = [e["ev"] for e in telem.tracer.events if e["type"] == "req"]
    assert evs.count("shed") == 1


def test_launcher_fault_model_prints_reference_rates(capsys):
    from repro_torch.launch import serve as launch_serve
    fin, eng, sched = launch_serve.main([
        "--device", "cpu", "--requests", "2", "--max-new", "4",
        "--fault-model", "simdram:node=22"])
    out = capsys.readouterr().out
    want = {k: f"{v:g}" for k, v in
            jf.simdram_rates("simdram:node=22").items()}
    assert f"chaos mode: fault rates {want} seed=7" in out
    assert sched.faults.rates == jf.simdram_rates("simdram:node=22")
    assert len(fin) == 2 and "fault plan:" in out
