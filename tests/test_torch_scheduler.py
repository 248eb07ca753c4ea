"""The port's closed-loop scheduler and launcher, end to end on the CPU.

Each request the port's scheduler serves (engine + allocator + scheduler,
params bridged from the reference) is held against the reference model's
own greedy decode of that request — including a run whose pool is too
small for both requests, which forces discard-and-re-prefill preemption.
The reference scheduler is not the yardstick: its staging buffers race
with asynchronous dispatch (ROADMAP.md § C1).  Greedy tokens: equal."""
import numpy as np
import pytest
import torch

from _torch_parity import bridged, jax_greedy, one_torch_thread
from repro_torch.launch import serve
from repro_torch.models import model as tm
from repro_torch.serve.engine import PagedEngine
from repro_torch.serve.scheduler import Scheduler


def _serve(eng, prompts, max_new, K, prefill_chunk=4):
    sched = Scheduler(eng, prefill_chunk=prefill_chunk, decode_horizon=K)
    for p in prompts:
        sched.add_request(p, max_new=max_new)
    return {r.rid: r for r in sched.run()}, sched


@pytest.mark.parametrize("K", [1, 4, 8])
def test_scheduler_outputs_match_reference_greedy(K):
    cfg, jp, tp = bridged("qwen3-0.6b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (5, 3, 9, 6)]
    eng = PagedEngine(cfg, tp, n_pages=65, page_size=4, max_seqs=2,
                      max_pages_per_seq=16, device="cpu")
    done, sched = _serve(eng, prompts, max_new=9, K=K)
    for rid, p in enumerate(prompts):
        assert done[rid].out == jax_greedy(cfg, jp, p, 9), rid
    assert eng.alloc.free_pages == eng.free_pages == 64
    # one host read per horizon, plus one per prompt-finishing chunk
    assert sched.stats["host_syncs"] == (eng.stats["decode_dispatches"]
                                         + sched.stats["prefill_host_reads"])


def test_preemption_under_pool_pressure_matches_reference_greedy():
    """5 usable pages, 2 slots, each request growing to 4 pages (8 tokens at
    ps=2): the younger request is preempted mid-decode, re-prefilled from
    its tokens later, and still decodes exactly."""
    cfg, jp, tp = bridged("qwen3-0.6b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 2).tolist() for _ in range(2)]
    eng = PagedEngine(cfg, tp, n_pages=6, page_size=2, max_seqs=2,
                      max_pages_per_seq=4, device="cpu")
    done, sched = _serve(eng, prompts, max_new=6, K=1)
    assert sched.stats["preemptions"] >= 1
    assert sum(r.preemptions for r in done.values()) >= 1
    for rid, p in enumerate(prompts):
        assert done[rid].out == jax_greedy(cfg, jp, p, 6), rid
    assert eng.free_pages == eng.alloc.free_pages == 5


def test_scheduler_rejects_oversized_requests():
    cfg, _, tp = bridged("qwen3-0.6b")
    eng = PagedEngine(cfg, tp, n_pages=4, page_size=2, max_seqs=2,
                      max_pages_per_seq=4, device="cpu")
    sched = Scheduler(eng, prefill_chunk=4)
    with pytest.raises(ValueError, match="per-slot capacity"):
        sched.add_request(list(range(12)), max_new=2)
    with pytest.raises(ValueError, match="pool capacity"):
        sched.add_request(list(range(6)), max_new=2)


def test_launcher_serves_smoke_config_on_cpu(capsys):
    argv = ["--arch", "qwen3-0.6b", "--requests", "3", "--max-new", "5",
            "--batch-slots", "2", "--prompt-len", "4", "--decode-horizon",
            "4", "--no-prefix-cache", "--device", "cpu", "--attn-impl",
            "kernel"]
    finished, engine, _ = serve.main(argv)
    assert sorted(r.rid for r in finished) == [0, 1, 2]
    assert engine.device == torch.device("cpu")
    cfg, params = engine.cfg, engine.params
    for r in finished:          # the port's own plain greedy decode
        logits, caches = tm.prefill(cfg, params, {"tokens": torch.tensor(
            [r.prompt])}, len(r.prompt) + 5)
        out = [int(logits[0, 0].argmax())]
        for pos in range(len(r.prompt), len(r.prompt) + 4):
            logits, caches = tm.decode_step(cfg, params, caches,
                                            torch.tensor([[out[-1]]]), pos)
            out.append(int(logits[0, 0].argmax()))
        assert r.out == out
    assert "3 requests, 15 generated tokens" in capsys.readouterr().out


def test_launcher_flags():
    ap = serve._parser()
    assert ap.parse_args([]).smoke and ap.parse_args([]).device == "cuda"
    assert not ap.parse_args(["--no-smoke"]).smoke
    # the reference's defaults: the prefix cache on, overlap off
    args = ap.parse_args([])
    assert not args.no_prefix_cache and not args.overlap
    assert args.shared_prefix == 0
    assert ap.parse_args(["--no-prefix-cache"]).no_prefix_cache
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--no-prefix-cache"])
