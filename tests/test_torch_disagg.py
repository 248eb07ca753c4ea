"""The port's disaggregated prefill/decode serving (``repro_torch/serve/
disagg.py``, the scheduler's handoff hook and image admission):

  * a ``BlockImage`` round trip is a pool-level property: export from one
    allocator, adopt on another of another geometry, re-export — payload
    bit-exact, for uniform, hetero (full + RING + RECURRENT) and
    no-full-layer pools;
  * the import guards hold: page-size and layer-kind disagreement,
    custody terminal at export, oversubscription;
  * one trace over two pool-scoped views replays through both checkers,
    every export matched to its import; a dropped export or a falsified
    import charge is rejected;
  * two engines equal the unified engine per request, and each request its
    ``jax_greedy``, on the same open-loop trace (virtual clock), for
    qwen3-0.6b and recurrentgemma-9b (ring frames and recurrent rows in
    the image); also under decode-side preemption into the host tier;
  * backpressure stalls the handoff, not prefill; a direct finish skips
    the handoff; the two-pool trace replays clean (``n_pools == 2``);
  * disaggregated chaos under swap pressure: one plan over both
    allocators, every fault resolved, tokens equal, pools and tier
    drained."""
import numpy as np
import pytest
import torch

from _torch_parity import bridged, jax_greedy, one_torch_thread
from repro.serve import telemetry as jt
from repro_torch.core.vbi import kvcache as tk
from repro_torch.core.vbi.blocks import PagePool, VBIAllocator
from repro_torch.serve import telemetry as tt
from repro_torch.serve.disagg import DisaggScheduler
from repro_torch.serve.engine import PagedEngine
from repro_torch.serve.faults import FaultPlan, install_faults
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.traffic import TrafficDriver, VirtualClock, make_trace


# --------------------------------------------------------------------------
# pool level: BlockImage round trip across geometries
# --------------------------------------------------------------------------
def _mk(n_pages=17, page_size=2, max_seqs=2, rowP=8, swap=0, n_layers=1,
        ring=0, rg=0):
    pool = PagePool(n_layers=n_layers, n_pages=n_pages, page_size=page_size,
                    n_kv=1, head_dim=2, max_seqs=max_seqs,
                    max_pages_per_seq=rowP, ring_layers=ring, ring_pages=2,
                    rg_layers=rg, rnn_width=4, device="cpu")
    return pool, VBIAllocator(pool, host_swap_pages=swap)


def _feed(pool, al, blk, n=1):
    for _ in range(n):
        al.reserve(blk, blk.n_tokens + 1)
        mask = torch.zeros(pool.max_seqs, dtype=torch.bool)
        mask[blk.slot] = True
        tk.reserve_positions(pool.state, mask, has_full=pool.has_full)
        al.commit(blk, blk.n_tokens + 1)


def _randomize(pool, rng):
    """Noise in every payload tensor, so a round trip compares data."""
    for f in ("k_pages", "v_pages", "k_ring", "v_ring", "rg_h", "rg_conv",
              "ssm_state", "ssm_conv"):
        a = getattr(pool.state, f)
        if a.numel():
            a.copy_(torch.from_numpy(
                rng.standard_normal(tuple(a.shape)).astype(np.float32)))


KINDS = {"uniform": dict(),
         "hetero": dict(ring=2, rg=1),
         "ring-recurrent": dict(n_layers=0, ring=2, rg=1)}


@pytest.mark.parametrize("flavor", sorted(KINDS))
def test_block_image_round_trip_cross_geometry(flavor):
    kinds = KINDS[flavor]
    src_pool, src = _mk(n_pages=17, max_seqs=2, rowP=8, **kinds)
    dst_pool, dst = _mk(n_pages=9, max_seqs=4, rowP=4, **kinds)
    blk = src.alloc(1)
    _feed(src_pool, src, blk, 7)                 # 4 pages at ps=2
    _randomize(src_pool, np.random.default_rng(0))

    img = src.export_image(blk, tokens=list(range(7)), lineage={"hop": 1})
    assert blk.status == "exported" and src.pages_in_use == 0
    assert img.n_tokens == 7 and img.tokens == list(range(7))
    assert img.n_pages == (4 if src_pool.has_full else 0)
    assert (img.aux is not None) == bool(kinds.get("ring") or
                                         kinds.get("rg"))
    src.free(blk)                                # custody no-op post-export
    assert src.free_pages == src_pool.n_pages - 1

    blk2 = dst.import_image(img, 3)              # new slot, new block
    assert blk2.n_tokens == 7 and blk2 is not blk
    assert dst.blocks[3] is blk2 and blk2.status == "resident"
    img2 = dst.export_image(blk2, tokens=img.tokens, lineage={"hop": 2})
    np.testing.assert_array_equal(img.k, img2.k)
    np.testing.assert_array_equal(img.v, img2.v)
    if img.aux is not None:
        for a, b in zip(img.aux, img2.aux):
            np.testing.assert_array_equal(a, b)
    assert img2.props == img.props and img2.charge == img.charge
    assert dst.pages_in_use == 0 and int(dst_pool.state.free_top) == 8

    blk3 = src.import_image(img2, 0)             # ... and home again
    src.free(blk3)
    assert src.free_pages == src_pool.n_pages - 1
    assert src.stats["image_exports"] == src.stats["image_imports"] == 1


def test_import_image_guards():
    src_pool, src = _mk()
    blk = src.alloc(0)
    _feed(src_pool, src, blk, 3)
    img = src.export_image(blk)
    _, wrong_ps = _mk(page_size=4)
    with pytest.raises(ValueError, match="page-size mismatch"):
        wrong_ps.import_image(img, 0)
    _, wrong_kind = _mk(ring=2, rg=1)
    with pytest.raises(ValueError, match="layer kinds"):
        wrong_kind.import_image(img, 0)
    with pytest.raises(ValueError, match="needs a resident block"):
        src.export_image(blk)                    # custody already moved
    home_pool, home = _mk(n_pages=5, rowP=4)     # 4 free pages
    with pytest.raises(RuntimeError, match="oversubscribed"):
        home.import_image(img, 0, reserve_pages=5)
    assert home.free_pages == 4 and int(home_pool.state.free_top) == 4
    home.free(home.import_image(img, 0))         # within budget: lands
    assert home.free_pages == 4


def test_cross_pool_trace_checks_and_tamper_detected():
    rec = tt.TraceRecorder(clock=lambda: 0.0)
    src_pool, src = _mk(ring=1, rg=1)
    _, dst = _mk(n_pages=9, max_seqs=4, rowP=4, ring=1, rg=1)
    src.attach_tracer(rec.scoped("prefill"))
    dst.attach_tracer(rec.scoped("decode"))
    blk = src.alloc(0)
    _feed(src_pool, src, blk, 5)
    blk2 = dst.import_image(src.export_image(blk), 2)
    dst.free(blk2)
    summary = tt.check_trace(rec.events)
    assert summary == jt.check_trace(rec.events)
    assert summary["n_pools"] == 2 and summary["images_in_flight"] == 0
    assert summary["live_blocks"] == 0

    no_export = [e for e in rec.events if e.get("op") != "export_image"]
    tampered = [dict(e) for e in rec.events]
    for e in tampered:
        if e.get("op") == "import_image":
            e["charge"] = int(e["charge"]) + 1
    for check in (tt.check_trace, jt.check_trace):
        with pytest.raises(Exception, match="never-exported"):
            check(no_export)
        with pytest.raises(Exception, match="claims charge"):
            check(tampered)


# --------------------------------------------------------------------------
# engine level: two engines replay the unified engine's tokens
# --------------------------------------------------------------------------
_GREEDY = {}


def _greedy(arch, prompt, max_new):
    key = (arch, tuple(prompt), max_new)
    if key not in _GREEDY:
        cfg, jp, _ = bridged(arch)
        _GREEDY[key] = jax_greedy(cfg, jp, prompt, max_new)
    return _GREEDY[key]


def _closed(arch, trace, page_size=8):
    cfg, _, tp = bridged(arch)
    eng = PagedEngine(cfg, tp, n_pages=33, page_size=page_size, max_seqs=4,
                      max_pages_per_seq=8, device="cpu")
    sched = Scheduler(eng, prefill_chunk=8, decode_horizon=8)
    for tr in trace:
        sched.add_request(tr.prompt, tr.max_new, rid=tr.rid)
    return {r.rid: r.out for r in sched.run()}


def _mk_disagg(arch, p_kw=None, d_kw=None, **sch_kw):
    cfg, _, tp = bridged(arch)
    p = dict(n_pages=25, page_size=8, max_seqs=6, max_pages_per_seq=4)
    d = dict(n_pages=33, page_size=8, max_seqs=3, max_pages_per_seq=8,
             host_swap_pages=32)
    p.update(p_kw or {})
    d.update(d_kw or {})
    p_eng = PagedEngine(cfg, tp, device="cpu", **p)
    d_eng = PagedEngine(cfg, tp, device="cpu", **d)
    sch_kw.setdefault("prefill_chunk", 8)
    sch_kw.setdefault("decode_horizon", 8)
    return p_eng, d_eng, DisaggScheduler(p_eng, d_eng, **sch_kw)


def _replay(dsch, trace):
    drv = TrafficDriver(dsch, trace, clock=VirtualClock())
    return {r.rid: r.out for r in drv.run()}


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "recurrentgemma-9b"])
def test_disagg_replay_matches_unified_and_greedy(arch):
    cfg = bridged(arch)[0]
    trace = make_trace(cfg.vocab, n_requests=8, rate=1.0, seed=3,
                       max_prompt=12, max_new_cap=8)
    ref = _closed(arch, trace)
    p_eng, d_eng, dsch = _mk_disagg(arch)
    out = _replay(dsch, trace)
    assert out == ref, f"{arch}: disagg replay diverged"
    for tr in trace:
        assert out[tr.rid] == _greedy(arch, tr.prompt, tr.max_new), tr.rid
    assert dsch.stats["handoffs"] > 0
    assert dsch.stats["handoffs"] + dsch.stats["direct_finishes"] == \
        len(trace)
    assert p_eng.alloc.stats["image_exports"] == dsch.stats["handoffs"]
    assert d_eng.alloc.stats["image_imports"] == dsch.stats["handoffs"]
    assert dsch.decode.stats["image_imports"] == dsch.stats["handoffs"]
    assert p_eng.pages_in_use == 0 and d_eng.pages_in_use == 0
    if arch == "recurrentgemma-9b":         # ring frames + recurrent rows
        assert p_eng.geom.n_ring and p_eng.geom.n_rg
        assert dsch.stats["handoff_bytes"] > 0


def _pressure(**sch_kw):
    """Decode pool too small for every adopted lifetime: preemption into
    the decode engine's host tier (page size 4)."""
    return _mk_disagg(
        "qwen3-0.6b",
        p_kw=dict(page_size=4, n_pages=13, max_seqs=4, max_pages_per_seq=3),
        d_kw=dict(page_size=4, n_pages=8, max_seqs=4, max_pages_per_seq=5,
                  host_swap_pages=16), **sch_kw)


@pytest.fixture(scope="module")
def pressure_trace():
    cfg = bridged("qwen3-0.6b")[0]
    trace = make_trace(cfg.vocab, n_requests=8, rate=2.0, seed=9,
                       max_prompt=8, max_new_cap=12)
    return trace, _closed("qwen3-0.6b", trace, page_size=4)


def test_disagg_exact_under_decode_preemption_and_swap(pressure_trace):
    trace, ref = pressure_trace
    p_eng, d_eng, dsch = _pressure()
    out = _replay(dsch, trace)
    assert out == ref
    for tr in trace:
        assert out[tr.rid] == _greedy("qwen3-0.6b", tr.prompt, tr.max_new)
    assert dsch.decode.stats["preemptions"] >= 1     # pressure was real
    assert dsch.decode.stats["swap_ins"] >= 1
    assert p_eng.pages_in_use == 0 and d_eng.pages_in_use == 0
    assert d_eng.alloc.swap.used_pages == 0          # tier drained


def test_disagg_chaos_under_swap_pressure(pressure_trace):
    """Two engines, one plan, swap pressure on the decode side: alloc,
    swap and image faults draw from the same seeded streams, and the
    two-pool trace still replays clean."""
    trace, ref = pressure_trace
    plan = FaultPlan(0.1, seed=7)
    telem = tt.Telemetry(trace=True)
    p_eng, d_eng, dsch = _pressure(telemetry=telem, faults=plan)
    out = _replay(dsch, trace)
    assert out == ref
    assert sum(plan.fired.values()) > 0
    assert plan.stats["unresolved"] == 0
    assert p_eng.pages_in_use == 0 and d_eng.pages_in_use == 0
    assert d_eng.alloc.swap.used_pages == 0
    for e in (p_eng, d_eng):
        install_faults(e.alloc, None)
        e.alloc.attach_tracer(None)
    summary = tt.check_trace(telem.tracer.events)
    assert summary == jt.check_trace(telem.tracer.events)
    assert summary["n_pools"] == 2 and summary["faults_unresolved"] == 0
    assert summary["n_faults"] == sum(plan.fired.values())
    assert summary["images_in_flight"] == 0 and summary["live_blocks"] == 0


def test_backpressure_stalls_handoff_not_prefill():
    cfg = bridged("qwen3-0.6b")[0]
    trace = make_trace(cfg.vocab, n_requests=8, rate=5.0, seed=2,
                       max_prompt=12, max_new_cap=8)
    ref = _closed("qwen3-0.6b", trace)
    p_eng, d_eng, dsch = _mk_disagg("qwen3-0.6b", d_kw=dict(max_seqs=1))
    assert _replay(dsch, trace) == ref
    assert dsch.stats["handoff_stalled_ticks"] > 0
    # prompt ingestion ran on: every prompt prefilled before the decode
    # engine finished its first handed-off request
    assert dsch.prefill.stats["steps"] < dsch.decode.stats["steps"]
    assert p_eng.pages_in_use == 0 and d_eng.pages_in_use == 0


def test_direct_finish_skips_the_handoff():
    cfg = bridged("qwen3-0.6b")[0]
    p_eng, d_eng, dsch = _mk_disagg("qwen3-0.6b")
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, 6).tolist()
    dsch.add_request(prompt, max_new=1)
    fin = dsch.run()
    assert len(fin) == 1 and fin[0].out == _greedy("qwen3-0.6b", prompt, 1)
    assert dsch.stats["direct_finishes"] == 1
    assert dsch.stats["handoffs"] == 0
    assert d_eng.alloc.stats["image_imports"] == 0
    # intake is checked against the DECODE geometry, where lifetimes live
    with pytest.raises(ValueError, match="per-slot capacity"):
        dsch.add_request(rng.integers(0, cfg.vocab, 12).tolist(),
                         max_new=64)
    with pytest.raises(ValueError, match="two engines"):
        DisaggScheduler(p_eng, p_eng)


def test_disagg_two_pool_trace_replays_clean():
    cfg = bridged("qwen3-0.6b")[0]
    trace = make_trace(cfg.vocab, n_requests=6, rate=1.0, seed=7,
                       max_prompt=12, max_new_cap=8)
    telem = tt.Telemetry(trace=True)
    p_eng, d_eng, dsch = _mk_disagg("qwen3-0.6b", telemetry=telem,
                                    overlap=True)
    out = _replay(dsch, trace)
    assert out == _closed("qwen3-0.6b", trace)
    p_eng.alloc.attach_tracer(None)
    d_eng.alloc.attach_tracer(None)
    events = telem.tracer.events
    summary = tt.check_trace(events)
    assert summary == jt.check_trace(events)
    assert summary["n_pools"] == 2
    assert summary["images_in_flight"] == 0
    assert summary["live_blocks"] == 0 and summary["ledger_pages"] == 0
    assert summary["swap_pages_held"] == 0
    assert {e.get("pool") for e in events if e["type"] == "block"} == \
        {"prefill", "decode"}
    evs = [e["ev"] for e in events if e["type"] == "req"]
    assert evs.count("handoff") == evs.count("handoff_export") == \
        dsch.stats["handoffs"]


# --------------------------------------------------------------------------
# the launcher's --disagg --faults on the CPU
# --------------------------------------------------------------------------
def test_launcher_disagg_faults_trace_metrics_on_cpu(tmp_path, capsys):
    from repro_torch.launch import serve as launch_serve
    path = tmp_path / "t.jsonl"
    fin, eng, dsch = launch_serve.main([
        "--device", "cpu", "--disagg", "--faults", "--fault-rate", "0.1",
        "--trace", str(path), "--metrics"])
    out = capsys.readouterr().out
    assert isinstance(dsch, DisaggScheduler) and len(fin) == 6
    assert dsch.stats["handoffs"] == 6
    p_eng = dsch.prefill.engine
    assert (p_eng.max_seqs, p_eng.n_pages) == (6, 49)
    assert (eng.max_seqs, eng.n_pages) == (3, 97)
    assert p_eng.params is eng.params            # one set of weights
    assert eng.pages_in_use == 0 and p_eng.pages_in_use == 0
    plan = dsch.faults
    assert sum(plan.fired.values()) > 0 and plan.stats["unresolved"] == 0
    events = tt.read_jsonl(str(path))
    summary = tt.check_trace(events)
    assert summary == jt.check_trace(events)
    assert summary["n_pools"] == 2 and summary["faults_unresolved"] == 0
    assert summary["n_faults"] == sum(plan.fired.values())
    assert "disagg stats" in out and "fault plan:" in out
    assert '"disagg.handoffs"' in out and "checker OK" in out
    # the same serve without faults gives the same tokens
    fin0, _, _ = launch_serve.main(["--device", "cpu", "--disagg"])
    assert {r.rid: r.out for r in fin0} == {r.rid: r.out for r in fin}


def test_launcher_disagg_fault_flags():
    from repro_torch.launch import serve as launch_serve
    args = launch_serve._parser().parse_args([])
    assert not args.disagg and not args.faults and args.fault_model is None
    assert (args.prefill_slots, args.decode_slots) == (6, 3)
    assert (args.fault_rate, args.fault_seed) == (0.05, 7)
