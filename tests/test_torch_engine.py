"""``repro_torch/serve/engine.py::PagedEngine`` against the reference
``PagedEngine`` (its plain ``gather`` attention) and the reference model
on the qwen3-0.6b smoke config, same params bridged through numpy.

Both of the port's attention forms are driven: ``gather`` (the plain
batched twin) and ``kernel`` (on CPU tensors, the one-sequence oracle
behind the kernel's wrapper).  Logits: 1e-4 absolute and relative
(float32 through two frameworks); page tables, lengths, free stack and
refcounts: exact; greedy token blocks: equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import bridged, jax_decode_step
from repro.models import model as jm
from repro.serve.engine import PagedEngine as JEngine
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.serve.engine import PagedEngine

TOL = dict(atol=1e-4, rtol=1e-4)
INT_FIELDS = ("page_table", "seq_lens", "slot_active", "free_stack",
              "free_top", "page_refcounts")
GEOM = dict(n_pages=64, page_size=4, max_seqs=4, max_pages_per_seq=8)
PROMPTS = np.array([[3, 1, 4, 1, 5], [0, 0, 0, 0, 0], [9, 2, 6, 0, 0],
                    [0, 0, 0, 0, 0]], np.int32)
N_TOKENS = np.array([5, 0, 3, 0], np.int32)
MASK = np.array([True, False, True, False])


def _same_state(je, te):
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(te.state, f).numpy(),
                                      np.asarray(getattr(je.state, f)),
                                      err_msg=f)
    for f in ("k_pages", "v_pages"):        # page 0 is the null scratch page
        np.testing.assert_allclose(getattr(te.state, f).numpy()[:, 1:],
                                   np.asarray(getattr(je.state, f))[:, 1:],
                                   atol=1e-5, rtol=1e-5, err_msg=f)


def _engines(attn_impl):
    cfg, jp, tp = bridged("qwen3-0.6b")
    je = JEngine(cfg, jp, **GEOM)
    te = PagedEngine(cfg, tp, attn_impl=attn_impl, device="cpu", **GEOM)
    for s in (0, 2):
        je.alloc.alloc(s)
        te.alloc.alloc(s)
    return je, te


@pytest.fixture(scope="module")
def reference():
    """The reference engine's results for every scenario, computed once."""
    cfg, jp, _ = bridged("qwen3-0.6b")
    je, _ = _engines("gather")
    rng = np.random.default_rng(1)
    steps = []
    for _ in range(7):                  # crosses page boundaries (ps=4)
        toks = np.zeros(4, np.int32)
        toks[[0, 2]] = rng.integers(0, cfg.vocab, 2)
        steps.append((toks, np.asarray(je.decode(jnp.asarray(toks),
                                                 jnp.asarray(MASK)))))
    out = {"decode": (steps, je)}
    for K in (1, 4, 8):
        je, _ = _engines("gather")
        nxt = je.prefill_chunk(jnp.asarray(PROMPTS), jnp.asarray(N_TOKENS))
        left = np.array([K, 0, max(1, K - 2), 0], np.int32)
        blk = je.decode_many(nxt, jnp.asarray(MASK), jnp.asarray(left), K)
        out[("many", K)] = (np.asarray(nxt), left, np.asarray(blk), je)
    return out


@pytest.mark.parametrize("attn_impl", ["gather", "kernel"])
def test_decode_matches_reference_engine(reference, attn_impl):
    steps, je = reference["decode"]
    _, te = _engines(attn_impl)
    for i, (toks, ref) in enumerate(steps):
        got = te.decode(torch.from_numpy(toks), torch.from_numpy(MASK))
        np.testing.assert_allclose(got.numpy()[[0, 2]], ref[[0, 2]], **TOL,
                                   err_msg=f"step {i}")
    _same_state(je, te)
    assert te.stats["decode_steps"] == te.stats["token_steps"] == 7


@pytest.mark.parametrize("K", [1, 4, 8])
@pytest.mark.parametrize("attn_impl", ["gather", "kernel"])
def test_prefill_chunk_and_decode_many_match_reference_engine(
        reference, attn_impl, K):
    nxt_ref, left, blk_ref, je = reference[("many", K)]
    _, te = _engines(attn_impl)
    nxt = te.prefill_chunk(torch.from_numpy(PROMPTS),
                           torch.from_numpy(N_TOKENS))
    assert nxt.dtype == torch.int32 and nxt.shape == (4,)
    np.testing.assert_array_equal(nxt.numpy()[[0, 2]], nxt_ref[[0, 2]])
    blk = te.decode_many(nxt, torch.from_numpy(MASK), torch.from_numpy(left),
                         K)
    np.testing.assert_array_equal(blk.numpy(), blk_ref)
    _same_state(je, te)
    assert te.stats["token_steps"] == PROMPTS.shape[1] + K
    assert te.stats["decode_dispatches"] == te.stats["prefill_chunks"] == 1


@pytest.mark.parametrize("attn_impl", ["gather", "kernel"])
def test_engine_matches_reference_model(attn_impl):
    """Chunked prefill + decode through the pool equals the reference
    model's prefill + decode_step on each slot's own sequence."""
    cfg, jp, _ = bridged("qwen3-0.6b")
    _, te = _engines(attn_impl)
    toks = te.prefill_chunk(torch.from_numpy(PROMPTS),
                            torch.from_numpy(N_TOKENS))
    ref = {}
    for s in (0, 2):
        n = int(N_TOKENS[s])
        jl, jc = jm.prefill(cfg, jp, {"tokens": jnp.asarray(
            PROMPTS[None, s, :n])}, n + 4)
        assert int(jnp.argmax(jl[0, 0])) == int(toks[s])
        ref[s] = (jc, n)
    for step in range(3):
        logits = te.decode(toks, torch.from_numpy(MASK))
        for s in (0, 2):
            jc, pos = ref[s]
            jl, jc = jax_decode_step(cfg, jp, jc, jnp.asarray(
                [[int(toks[s])]], jnp.int32), jnp.int32(pos))
            np.testing.assert_allclose(logits.numpy()[s], np.asarray(jl)[0],
                                       **TOL, err_msg=f"slot {s} step {step}")
            ref[s] = (jc, pos + 1)
        toks = logits[:, 0].argmax(-1).to(torch.int32)


def test_engine_counts_and_checks():
    cfg, _, tp = bridged("qwen3-0.6b")
    with pytest.raises(ValueError, match="attn_impl"):
        PagedEngine(cfg, tp, attn_impl="pallas", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        PagedEngine(cfg, tp, host_swap_pages=4, device="cpu")
    meta = dict(tp, embed=tp["embed"].to("meta"))
    with pytest.raises(ValueError, match="params live on"):
        PagedEngine(cfg, meta, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PagedEngine(cfg, tp)                 # device defaults to cuda
    _, te = _engines("kernel")
    before = paged_attention.launches
    te.decode(torch.zeros(4, dtype=torch.int32), torch.from_numpy(MASK))
    assert paged_attention.launches == before    # CPU tensors: no kernel
    assert PagedEngine.block_ready(torch.zeros(1))
    assert te.placement == ("cpu:0",)
    assert te.alloc.blocks[0].placement == ("cpu:0",)
    assert te.free_pages == 63 - 2 and te.pages_in_use == 2
