"""The port's serve engine on the mixed stacks, against the reference
(``tests/test_hetero_serve.py``'s matrix): property-typed cache blocks for
windowed (ring), local/global, MoE-SWA and recurrent stacks.

  * greedy decode through ``PagedEngine`` + ``Scheduler`` equals the JAX
    model's greedy decode (``prefill`` + ``decode_step``) for gemma3-12b
    (5 local : 1 global) and recurrentgemma-9b (RG-LRU, RG-LRU, local) at
    decode horizons K in {1, 4, 8}, and for mamba2-1.3b (Mamba-2 only) and
    mixtral-8x7b (sliding window, top-2 MoE) at K in {1, 8}, with
    attention through the plain twin (``gather``) and through the
    kernel's wrapper (on CPU tensors, its one-sequence oracle); the prompts'
    outputs cross the smoke window of 16; the pool drains afterwards;
  * decode steps' logits, ring frames and recurrent state equal the JAX
    ``PagedEngine``'s (gather) step for step, across the window's wrap;
  * the windowed footprint is capped: (n_full, n_ring, window) = (1, 5,
    16), 2 ring frames per slot, while the global layer's pages grow; the
    recurrent stacks use zero pool pages;
  * discard-and-re-prefill preemption under pool pressure stays exact for
    a ring stack and for a recurrent stack (RG-LRU with a full-attention
    layer, so that its pool can run short);
  * a window that the page size does not divide is refused, and so are
    ring layers with two windows (the reference's messages).

Logits and state: 1e-4 absolute and relative (float32 through two
frameworks); greedy tokens: equal."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import bridged, jax_greedy
from repro.serve.engine import PagedEngine as JEngine
from repro.serve.engine import build_stack_geom as j_build_stack_geom
from repro_torch.models.config import LayerSpec, ModelConfig, Stage
from repro_torch.serve.engine import PagedEngine, build_stack_geom
from repro_torch.serve.scheduler import Scheduler

TOL = dict(atol=1e-4, rtol=1e-4)
GEOM = dict(n_pages=33, page_size=8, max_seqs=2, max_pages_per_seq=8)


def _engine_decode(cfg, params, prompts, max_new, k, attn_impl="kernel",
                   **eng_kw):
    kw = dict(GEOM, **eng_kw)
    eng = PagedEngine(cfg, params, attn_impl=attn_impl, device="cpu", **kw)
    sched = Scheduler(eng, prefill_chunk=4, decode_horizon=k)
    for p in prompts:
        sched.add_request(p, max_new=max_new)
    fin = sched.run()
    return [r.out for r in sorted(fin, key=lambda r: r.rid)], eng, sched


@pytest.mark.parametrize("attn_impl", ["gather", "kernel"])
@pytest.mark.parametrize("arch,horizons", [
    ("gemma3-12b", (1, 4, 8)), ("recurrentgemma-9b", (1, 4, 8)),
    ("mamba2-1.3b", (1, 8)), ("mixtral-8x7b", (1, 8))])
def test_hetero_engine_matches_reference_decode(arch, horizons, attn_impl):
    cfg, jp, tp = bridged(arch)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, 5).tolist() for _ in range(2)]
    max_new = 20                          # crosses the window of 16
    ref = [jax_greedy(cfg, jp, p, max_new) for p in prompts]
    for k in horizons:
        out, eng, _ = _engine_decode(cfg, tp, prompts, max_new, k,
                                     attn_impl)
        assert out == ref, f"{arch} K={k} diverged from the reference"
        assert eng.free_pages == eng.alloc.free_pages == 32   # drained


@pytest.mark.parametrize("arch", ["gemma3-12b", "recurrentgemma-9b",
                                  "mamba2-1.3b", "mixtral-8x7b"])
def test_decode_steps_match_reference_engine(arch):
    cfg, jp, tp = bridged(arch)
    geom = dict(GEOM, page_size=4)
    je = JEngine(cfg, jp, **geom)
    te = PagedEngine(cfg, tp, attn_impl="kernel", device="cpu", **geom)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab, (2, 4)).astype(np.int32)
    for s in range(2):
        je.alloc.alloc(s)
        te.alloc.alloc(s)
    n = np.array([4, 3], np.int32)
    j_nxt = np.asarray(je.prefill_chunk(jnp.asarray(prompt), jnp.asarray(n)))
    t_nxt = te.prefill_chunk(torch.from_numpy(prompt), torch.from_numpy(n))
    np.testing.assert_array_equal(t_nxt.numpy(), j_nxt)
    mask = np.ones(2, bool)
    for step in range(15):                # past the window of 16
        toks = rng.integers(0, cfg.vocab, 2).astype(np.int32)
        jl = np.asarray(je.decode(jnp.asarray(toks), jnp.asarray(mask)))
        tl = te.decode(torch.from_numpy(toks), torch.from_numpy(mask))
        np.testing.assert_allclose(tl.numpy(), jl, **TOL,
                                   err_msg=f"{arch} step {step}")
    for f in ("seq_lens", "page_table", "free_top"):
        np.testing.assert_array_equal(getattr(te.state, f).numpy(),
                                      np.asarray(getattr(je.state, f)), f)
    for f in ("k_ring", "v_ring", "rg_h", "rg_conv", "ssm_state",
              "ssm_conv"):
        t, j = getattr(te.state, f).numpy(), np.asarray(getattr(je.state, f))
        if f in ("k_ring", "v_ring"):     # page 0 is the null scratch page
            t, j = t[:, 1:], j[:, 1:]
        assert t.shape == j.shape, f
        np.testing.assert_allclose(t, j, **TOL, err_msg=f)


def test_windowed_footprint_capped():
    cfg, _, tp = bridged("gemma3-12b")
    geom = build_stack_geom(cfg, page_size=8)
    assert (geom.n_full, geom.n_ring, geom.window) == (1, 5, 16)
    eng = PagedEngine(cfg, tp, n_pages=33, page_size=8, max_seqs=1,
                      max_pages_per_seq=16, device="cpu")
    sched = Scheduler(eng, prefill_chunk=8, decode_horizon=8)
    sched.add_request([1, 2, 3, 4], max_new=92)           # T = 96 >> 16
    peak = 0
    while sched.queue or sched.slots:
        sched.step()
        if sched.slots:
            peak = max(peak, eng.pages_in_use)
    # 95 tokens fed at ps 8: 12 pool pages for the ONE global layer; the
    # five ring layers hold 2 static frames per slot, forever
    assert peak == 12
    assert eng.geom.ring_pages == 2
    assert eng.state.k_ring.shape[:2] == (5, 1 + 1 * 2)
    assert eng.free_pages == eng.alloc.free_pages == 32
    for arch in ("recurrentgemma-9b", "mamba2-1.3b"):
        cfg2, _, tp2 = bridged(arch)
        eng2 = PagedEngine(cfg2, tp2, n_pages=9, page_size=8, max_seqs=1,
                           max_pages_per_seq=2, device="cpu")
        assert not eng2.has_full
        sched2 = Scheduler(eng2, prefill_chunk=8, decode_horizon=8)
        # a 70-token lifetime on an 8-page pool: impossible for full
        # attention, constant-footprint for ring and recurrent stacks
        sched2.add_request([1, 2, 3, 4, 5, 6], max_new=64)
        fin = sched2.run()
        assert len(fin[0].out) == 64
        assert eng2.pages_in_use == 0 and eng2.alloc.free_pages == 8


@pytest.mark.parametrize("arch", ["gemma3-12b", "recurrentgemma-9b"])
def test_preemption_under_pool_pressure_stays_exact(arch):
    """Discard and re-prefill: a preempted request re-enters with its
    generated tokens and its ring frames or recurrent rows are rebuilt from
    zero.  recurrentgemma's local layer is made a full-attention one
    (``local_window=0``) so that the pool can run short."""
    cfg, jp, tp = bridged(arch)
    if arch == "recurrentgemma-9b":
        cfg = dataclasses.replace(cfg, local_window=0)
        geom = build_stack_geom(cfg, page_size=4)
        assert (geom.n_rg, geom.n_full, geom.n_ring) == (2, 1, 0)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, 4).tolist() for _ in range(2)]
    ref = [jax_greedy(cfg, jp, p, 12) for p in prompts]
    roomy, _, s_r = _engine_decode(cfg, tp, prompts, 12, 4, page_size=4)
    tight, eng, s_t = _engine_decode(cfg, tp, prompts, 12, 4, page_size=4,
                                     n_pages=8)
    assert s_r.stats["preemptions"] == 0
    assert s_t.stats["preemptions"] >= 1
    assert roomy == tight == ref
    assert eng.free_pages == eng.alloc.free_pages == 7


def test_window_must_be_page_aligned():
    cfg, _, tp = bridged("gemma3-12b")           # local window 16
    with pytest.raises(ValueError, match="multiple"):
        PagedEngine(cfg, tp, n_pages=17, page_size=5, max_seqs=2,
                    device="cpu")



class _TwoWindows(ModelConfig):
    """A stack whose ring layers disagree on the window."""

    def stages(self):
        return [Stage((LayerSpec("local", window=16),
                       LayerSpec("local", window=32)), 1)]


def test_ring_layers_must_share_one_window():
    cfg = _TwoWindows(**dataclasses.asdict(bridged("gemma3-12b")[0]))
    for build in (build_stack_geom, j_build_stack_geom):
        with pytest.raises(ValueError, match=r"one window, got \[16, 32\]"):
            build(cfg, 8)
