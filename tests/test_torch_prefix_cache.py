"""Cross-request prefix sharing in the port against the JAX package:

  * the radix trie (``repro_torch/serve/prefix_cache.py``): the same
    operations on the reference's ``PrefixCache`` and the port's give equal
    matches, evictions, counters and stats;
  * the device sharing ops (``core/vbi/kvcache.py``: ``map_prefix``,
    ``clone_page_cow``, ``retain_pages``, ``release_pages`` and
    ``release_slot`` on shared pages, a double release included) and the
    allocator's sharing face (``core/vbi/blocks.py``) leave page tables,
    lengths, refcounts, free stack, free top and the COW copy's K/V equal
    to the reference's after every op — exactly, since these are integer
    ops and copies;
  * engine level: a mapped prefix plus a COW clone gives the decode logits
    of a full prefill (1e-5 between the port's slots; 1e-4 absolute and
    relative against the JAX engine, the engine tests' tolerance);
  * scheduler level, cache on and off and overlap on and off: each
    request's greedy tokens equal the reference model's greedy decode of
    that request (not the JAX scheduler's: ROADMAP.md § C1), under
    partial-match eviction, cache eviction under pressure and preemption
    that resumes from the cache; the host page mirror is exact after every
    tick and the pool drains to zero;
  * the refusals for RING/RECURRENT stacks, and the launcher's defaults."""
import dataclasses
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import Pool, bridged, jax_greedy, one_torch_thread
from repro.core.vbi import kvcache as jk
from repro.core.vbi.blocks import PagePool, VBIAllocator as JAlloc
from repro.serve.engine import PagedEngine as JEngine
from repro.serve.prefix_cache import PrefixCache as JCache
from repro_torch.core.vbi import kvcache as tk
from repro_torch.core.vbi.address_space import VBProps
from repro_torch.core.vbi.blocks import VBIAllocator
from repro_torch.launch import serve
from repro_torch.models import model as tm
from repro_torch.serve.engine import PagedEngine
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.scheduler import Scheduler

TOL = dict(atol=1e-4, rtol=1e-4)
INT_FIELDS = ("page_table", "seq_lens", "slot_active", "free_stack",
              "free_top", "page_refcounts")


# --------------------------------------------------------------------------
# the host trie
# --------------------------------------------------------------------------
def _match(m):
    return (m.pages, m.n_tokens, m.partial_page, m.partial_len,
            [n.page for n in m.nodes],
            m.partial_node.page if m.partial_node else None)


def _same_cache(jc, tc):
    assert tc.n_pages == jc.n_pages
    assert tc.evictable_pages == jc.evictable_pages
    assert tc.stats == jc.stats
    assert tc.hit_rate == jc.hit_rate


def test_trie_lookup_insert_and_cap():
    """The reference's trie test, run on both tries side by side."""
    caches = (JCache(page_size=4), PrefixCache(page_size=4))
    toks = [1, 2, 3, 4, 5, 6, 7, 8, 9]
    got = []
    for c in caches:
        new = c.insert(toks, [10, 11])
        got.append([
            [n.page for n in new], c.n_pages, _match(c.lookup(toks)),
            _match(c.lookup(toks[:8])),
            _match(c.lookup([1, 2, 3, 4, 5, 6, 99, 99, 99])),
            c.lookup([9, 9, 9, 9, 9]).n_tokens, c.insert(toks, [20, 21]),
            c.lookup(toks).pages])
    assert got[1] == got[0]
    assert got[1][0] == [10, 11] and got[1][2][:2] == ([10, 11], 8)
    assert got[1][3][:4] == ([10], 7, 11, 3)
    _same_cache(*caches)


def test_trie_eviction_lru_pins_and_cascade():
    caches = (JCache(page_size=2), PrefixCache(page_size=2))
    got = []
    for c in caches:
        c.insert([1, 2, 3, 4], [5, 6])
        c.insert([7, 8], [9])
        m = c.lookup([1, 2, 3, 4, 0])
        c.pin(m.all_nodes())
        first = c.evict(10)
        pinned = c.evictable_pages
        c.unpin(m.all_nodes())
        got.append((first, pinned, c.evict(10), c.n_pages))
    assert got[1] == got[0] == ([9], 0, [6, 5], 0)
    _same_cache(*caches)


@pytest.mark.parametrize("seed", range(6))
def test_trie_random_operations_match_reference(seed):
    """Random lookups, records, pins, unpins, partial drops, inserts and
    evictions over a small alphabet (so prefixes collide and partial
    matches happen): every result and counter equal."""
    rng = np.random.default_rng(seed)
    ps = int(rng.integers(2, 5))
    jc, tc = JCache(page_size=ps), PrefixCache(page_size=ps)
    pinned = []                         # (reference nodes, port nodes)
    next_page = 1
    for step in range(60):
        op = rng.choice(["lookup", "insert", "insert", "evict", "unpin"])
        toks = rng.integers(0, 3, int(rng.integers(1, 4 * ps))).tolist()
        if op == "lookup":
            jm, tm_ = jc.lookup(toks), tc.lookup(toks)
            assert _match(tm_) == _match(jm), step
            if rng.random() < 0.3 and jm.partial_node is not None:
                jc.drop_partial(jm)
                tc.drop_partial(tm_)
                assert _match(tm_) == _match(jm)
            jc.record(jm, len(toks))
            tc.record(tm_, len(toks))
            if rng.random() < 0.5:
                jc.pin(jm.all_nodes())
                tc.pin(tm_.all_nodes())
                pinned.append((jm.all_nodes(), tm_.all_nodes()))
        elif op == "insert":
            n = len(toks) // ps
            pages = list(range(next_page, next_page + n))
            next_page += n
            jn, tn = jc.insert(toks, pages), tc.insert(toks, pages)
            assert [x.page for x in tn] == [x.page for x in jn]
        elif op == "evict":
            want = int(rng.integers(0, 4))
            assert tc.evict(want) == jc.evict(want), step
        elif pinned:
            jn, tn = pinned.pop(int(rng.integers(len(pinned))))
            jc.unpin(jn)
            tc.unpin(tn)
        _same_cache(jc, tc)


def test_trie_refuses_bad_input():
    with pytest.raises(ValueError, match="page_size"):
        PrefixCache(page_size=0)
    c = PrefixCache(page_size=2)
    with pytest.raises(ValueError, match="tokens"):
        c.insert([1, 2, 3], [5, 6])
    (node,) = c.insert([1, 2], [5])
    with pytest.raises(RuntimeError, match="unpinned"):
        c.unpin([node])


# --------------------------------------------------------------------------
# device sharing ops (pure PagedServeState ops)
# --------------------------------------------------------------------------
L, N_PAGES, PS, S, P = 2, 16, 4, 3, 4
#: pages 1..FREE stay on the free stack; FREE+1.. count as already popped
FREE = 8


def _states(seed):
    """The same state on both sides: random K/V, and ``free_top`` cut so
    that the pages the ops below map count as popped (as in the
    reference's ``_tiny_state``)."""
    kw = dict(n_layers=L, n_pages=N_PAGES, page_size=PS, n_kv=1,
              head_dim=2, max_seqs=S, max_pages_per_seq=P)
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((L, N_PAGES, PS, 1, 2)).astype(np.float32)
    v = rng.standard_normal((L, N_PAGES, PS, 1, 2)).astype(np.float32)
    js = dataclasses.replace(jk.init_serve_state(**kw),
                             k_pages=jnp.asarray(k), v_pages=jnp.asarray(v),
                             free_top=jnp.asarray(FREE, jnp.int32))
    ts = tk.init_serve_state(device="cpu", **kw)
    ts.k_pages.copy_(torch.from_numpy(k))
    ts.v_pages.copy_(torch.from_numpy(v))
    ts.free_top.fill_(FREE)
    return js, ts


def _same_state(js, ts, where):
    for f in INT_FIELDS + ("k_pages", "v_pages"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)),
                                      err_msg=f"{f} after {where}")


def _ids(pages):
    ids = np.zeros(P, np.int32)
    ids[:len(pages)] = pages
    return jnp.asarray(ids), torch.from_numpy(ids)


class _Both:
    """Applies each sharing op to the reference state and the port's and
    checks the two equal after it."""

    def __init__(self, seed):
        self.js, self.ts = _states(seed)

    def map(self, slot, pages, n_tokens):
        j, t = _ids(pages)
        self.js = jk.map_prefix(self.js, jnp.int32(slot), j,
                                jnp.int32(len(pages)), jnp.int32(n_tokens))
        tk.map_prefix(self.ts, slot, t, len(pages), n_tokens)
        _same_state(self.js, self.ts, f"map_prefix({slot}, {pages})")

    def cow(self, slot, page_idx, src, new_len):
        self.js = jk.clone_page_cow(self.js, jnp.int32(slot),
                                    jnp.int32(page_idx), jnp.int32(src),
                                    jnp.int32(new_len))
        tk.clone_page_cow(self.ts, slot, page_idx, src, new_len)
        _same_state(self.js, self.ts, f"clone_page_cow({slot}, {src})")

    def retain(self, pages):
        j, t = _ids(pages)
        self.js = jk.retain_pages(self.js, j, jnp.int32(len(pages)))
        tk.retain_pages(self.ts, t, len(pages))
        _same_state(self.js, self.ts, f"retain_pages({pages})")

    def release(self, pages):
        j, t = _ids(pages)
        self.js = jk.release_pages(self.js, j, jnp.int32(len(pages)))
        tk.release_pages(self.ts, t, len(pages))
        _same_state(self.js, self.ts, f"release_pages({pages})")

    def release_slot(self, slot):
        self.js = jk.release_slot(self.js, jnp.int32(slot))
        tk.release_slot(self.ts, slot)
        _same_state(self.js, self.ts, f"release_slot({slot})")

    def refc(self, pages):
        return self.ts.page_refcounts[list(pages)].tolist()


def test_shared_pages_freed_only_at_refcount_zero():
    b = _Both(0)
    b.map(0, [13, 11], 8)
    b.map(1, [13, 11], 8)
    assert b.refc([13, 11]) == [2, 2]
    b.release_slot(0)
    assert int(b.ts.free_top) == FREE and b.refc([13, 11]) == [1, 1]
    b.release_slot(1)
    assert int(b.ts.free_top) == FREE + 2
    assert b.ts.free_stack[FREE:FREE + 2].tolist() == [13, 11]


def test_double_release_slot_is_noop():
    b = _Both(1)
    b.map(0, [15], 4)
    b.release_slot(0)
    top, refc = int(b.ts.free_top), b.ts.page_refcounts.clone()
    b.release_slot(0)
    assert int(b.ts.free_top) == top
    assert torch.equal(b.ts.page_refcounts, refc)


@pytest.mark.parametrize("seed", range(4))
def test_share_cow_retain_release_cycle_matches_reference(seed):
    """Cache custody, two read-only mappers, a COW clone, releases in a
    random order with one double release, then eviction: equal to the
    reference after every op, and every page back on the stack."""
    rng = np.random.default_rng(seed)
    b = _Both(seed)
    cached = rng.choice(np.arange(FREE + 1, N_PAGES), 3,
                        replace=False).tolist()
    partial = int(rng.integers(1, PS))
    a, c, d = rng.permutation(S).tolist()
    b.retain(cached)                                   # cache custody
    b.map(a, cached[:2], 2 * PS)
    b.map(c, cached[:2], 2 * PS)
    b.map(d, cached[:1], PS)
    b.cow(d, 1, cached[1], PS + partial)               # pops page FREE
    assert b.ts.page_table[d, :2].tolist() == [cached[0], FREE]
    assert b.refc(cached) == [4, 3, 1] and b.refc([FREE]) == [1]
    assert torch.equal(b.ts.k_pages[:, FREE], b.ts.k_pages[:, cached[1]])
    order = rng.permutation([a, c, d]).tolist()
    order.insert(int(rng.integers(1, 4)), order[0])    # a double release
    for slot in order:
        b.release_slot(slot)
    assert b.refc(cached) == [1, 1, 1]                 # the cache's
    b.release(cached)
    assert int(b.ts.free_top) == FREE + 3
    assert not b.ts.page_refcounts.any()


# --------------------------------------------------------------------------
# the allocator's sharing face against the reference allocator
# --------------------------------------------------------------------------
def test_allocator_sharing_matches_reference():
    """Hand 6 popped pages from a block's reservation to the cache
    (``retain`` in chunks of a row), map them into two more blocks, COW
    one, free the blocks and evict:
    mirror, block fields, properties, stats and device state equal to the
    reference allocator's after every call."""
    geo = dict(n_pages=24, page_size=2, max_seqs=3)
    jal = JAlloc(PagePool(n_layers=1, n_kv=1, head_dim=2,
                          max_pages_per_seq=4, **geo))
    tal = VBIAllocator(Pool(max_pages=4, **geo))

    def same(blocks):
        assert tal.free_pages == jal.free_pages
        assert tal.device_free_pages == jal.device_free_pages
        for f in INT_FIELDS:
            np.testing.assert_array_equal(
                getattr(tal.pool.state, f).numpy(),
                np.asarray(getattr(jal.pool.state, f)), err_msg=f)
        for jb, tb in blocks:
            for f in ("slot", "n_tokens", "reserved_pages", "shared_pages",
                      "status"):
                assert getattr(tb, f) == getattr(jb, f), f
            assert int(tb.props) == int(jb.props)
        assert {k: tal.stats[k] for k in tal.stats} == \
            {k: jal.stats[k] for k in tal.stats}

    # pages handed to the cache: 6 ids counted as popped (above the cut
    # free top), more than one row of 4, so retain and release run in two
    # chunks
    held = [18, 20, 22, 19, 21, 23]
    jal.pool.state = dataclasses.replace(jal.pool.state,
                                         free_top=jnp.asarray(17, jnp.int32))
    tal.pool.state.free_top.fill_(17)
    jb0, tb0 = jal.alloc(0), tal.alloc(0)
    jal.reserve_pages(jb0, 6)
    tal.reserve_pages(tb0, 6)
    jal.retain(held, from_block=jb0)
    tal.retain(held, from_block=tb0)
    same([(jb0, tb0)])
    jb1, tb1 = jal.alloc(1), tal.alloc(1)
    jal.map_shared(jb1, held[:3], 6)
    tal.map_shared(tb1, held[:3], 6)
    assert tal.page_row(tb1, 3) == jal.page_row(jb1, 3) == held[:3]
    jb2, tb2 = jal.alloc(2), tal.alloc(2)
    jal.reserve_pages(jb2, 1)
    tal.reserve_pages(tb2, 1)
    jal.map_shared(jb2, held[:1], 2)
    tal.map_shared(tb2, held[:1], 2)
    jal.cow_break(jb2, 1, held[1], 3)
    tal.cow_break(tb2, 1, held[1], 3)
    assert tb2.props & VBProps.SHARED_RO and tb2.props & VBProps.COW
    same([(jb0, tb0), (jb1, tb1), (jb2, tb2)])
    for jb, tb in ((jb1, tb1), (jb2, tb2), (jb0, tb0)):
        jal.free(jb)
        tal.free(tb)
        same([(jb, tb)])
    jal.release(held)
    tal.release(held)
    same([])
    with pytest.raises(ValueError, match="resident"):
        tal.map_shared(tb1, held[:1], 2)
    with pytest.raises(ValueError, match="row"):
        tal._padded_ids(list(range(1, 6)))
    blk = tal.alloc(0)
    with pytest.raises(RuntimeError, match="cannot hand"):
        tal.retain([3], from_block=blk)


# --------------------------------------------------------------------------
# engine level: mapped prefix + COW == full prefill
# --------------------------------------------------------------------------
PROMPT = np.asarray([3, 1, 4, 1, 5, 9, 2, 6, 5, 3], np.int32)    # 10 tokens


def _cached_prefill(eng, to_dev, decode):
    """The reference test's sequence: slot 0 prefills the prompt and its 2
    full pages are cached; slot 1 maps both and prefills the 2-token
    suffix; slot 2 maps page 0, COW-clones page 1 at 3 of 4 tokens and
    prefills the rest.  Returns (decode logits [3, vocab], cached
    pages)."""
    C = len(PROMPT)

    def feed(slot, toks):
        t = np.zeros((3, C), np.int32)
        n = np.zeros((3,), np.int32)
        t[slot, :len(toks)] = toks
        n[slot] = len(toks)
        eng.prefill_chunk(to_dev(t), to_dev(n))

    blocks = [eng.alloc.alloc(0)]
    feed(0, PROMPT)
    pages = eng.alloc.page_row(blocks[0], 2)
    eng.alloc.retain(pages)
    blocks.append(eng.alloc.alloc(1))
    eng.alloc.map_shared(blocks[1], pages, 8)
    feed(1, PROMPT[8:])
    blocks.append(eng.alloc.alloc(2))
    eng.alloc.map_shared(blocks[2], pages[:1], 4)
    eng.alloc.cow_break(blocks[2], 1, pages[1], 7)
    feed(2, PROMPT[7:])
    logits = decode(np.full((3,), 7, np.int32), np.ones((3,), bool))
    return np.asarray(logits)[:, 0], pages, blocks


@pytest.fixture(scope="module")
def jax_cached_prefill():
    cfg, jp, _ = bridged("qwen3-0.6b")
    eng = JEngine(cfg, jp, n_pages=32, page_size=4, max_seqs=3,
                  max_pages_per_seq=4)
    logits, pages, _ = _cached_prefill(
        eng, jnp.asarray,
        lambda t, m: eng.decode(jnp.asarray(t), jnp.asarray(m)))
    return logits, pages, {f: np.asarray(getattr(eng.state, f))
                           for f in INT_FIELDS}


@pytest.mark.parametrize("attn_impl", ["gather", "kernel"])
def test_cached_prefill_logits_match_full_prefill(jax_cached_prefill,
                                                  attn_impl):
    cfg, _, tp = bridged("qwen3-0.6b")
    eng = PagedEngine(cfg, tp, n_pages=32, page_size=4, max_seqs=3,
                      max_pages_per_seq=4, attn_impl=attn_impl,
                      device="cpu")
    out, pages, blocks = _cached_prefill(
        eng, torch.from_numpy,
        lambda t, m: eng.decode(torch.from_numpy(t), torch.from_numpy(m)))
    j_out, j_pages, j_state = jax_cached_prefill
    assert pages == j_pages
    assert eng.state.seq_lens.tolist() == [11, 11, 11]
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(eng.state, f).numpy(),
                                      j_state[f], err_msg=f)
    np.testing.assert_allclose(out[1], out[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out[2], out[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, j_out, **TOL)
    # shared pages survive one slot's release and die with the cache
    for blk in blocks:
        eng.alloc.free(blk)
    assert eng.pages_in_use == len(pages) == 2
    eng.alloc.release(pages)
    assert eng.pages_in_use == 0


# --------------------------------------------------------------------------
# scheduler level: every request against its own reference greedy decode
# --------------------------------------------------------------------------
@lru_cache(maxsize=None)
def _greedy(prompt, max_new):
    cfg, jp, _ = bridged("qwen3-0.6b")
    return jax_greedy(cfg, jp, list(prompt), max_new)


def _check_mirror(sched):
    """The host mirror is exact: the device's free pages are the mirror's
    plus, per resident block, the reserved pages it has not popped yet
    (pages it maps from the cache are not its own)."""
    eng, al = sched.engine, sched.alloc
    lens = eng.state.seq_lens.tolist()
    unpopped = sum(blk.reserved_pages
                   - (al.pages_for(lens[s]) - blk.shared_pages)
                   for s, blk in al.blocks.items())
    assert eng.free_pages == al.free_pages + unpopped


def _run(prompts, max_new, *, cache, overlap, K=1, n_pages=64,
         page_size=4, max_seqs=2, max_pages_per_seq=8, prefill_chunk=4):
    cfg, _, tp = bridged("qwen3-0.6b")
    eng = PagedEngine(cfg, tp, n_pages=n_pages, page_size=page_size,
                      max_seqs=max_seqs, max_pages_per_seq=max_pages_per_seq,
                      device="cpu")
    pc = PrefixCache(page_size=page_size) if cache else None
    sched = Scheduler(eng, prefill_chunk=prefill_chunk, prefix_cache=pc,
                      decode_horizon=K, overlap=overlap)
    for p in prompts:
        sched.add_request(p, max_new=max_new)
    done = []
    while sched.queue or sched.slots:
        done += sched.step()
        _check_mirror(sched)
    assert sched._pending is None
    for r in done:
        assert r.out == _greedy(tuple(r.prompt), max_new), r.rid
    assert sorted(r.rid for r in done) == list(range(len(prompts)))
    if overlap:
        assert sched.stats["overlap_staged_ticks"] > 0
    else:
        assert sched.stats["overlap_staged_ticks"] == 0
    # drained: only cache custody left, the mirror exact, then all pages
    assert eng.free_pages == sched.alloc.free_pages
    assert eng.pages_in_use == (pc.n_pages if pc else 0)
    if pc is not None:
        eng.alloc.release(pc.evict(pc.n_pages))
        assert eng.pages_in_use == 0 and pc.n_pages == 0
    return eng, sched


def _system_prompts(seed, n_system, n_own, n):
    cfg, _, _ = bridged("qwen3-0.6b")
    rng = np.random.default_rng(seed)
    system = rng.integers(0, cfg.vocab, n_system).tolist()
    return [system + rng.integers(0, cfg.vocab, n_own).tolist()
            for _ in range(n)]


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("cache", [False, True])
def test_scheduler_cache_and_overlap_match_reference_greedy(cache, overlap,
                                                            K):
    prompts = _system_prompts(0, 10, 3, 5)          # 2.5 pages at ps=4
    eng, sched = _run(prompts, 4, cache=cache, overlap=overlap, K=K)
    if cache:
        assert sched.prefix_cache.hit_rate > 0
        assert sched.stats["prefix_hits"] >= 1
        assert sched.stats["prefix_tokens_reused"] > 0
        assert eng.alloc.stats["cow_clones"] > 0      # 10 % 4 != 0
    else:
        assert sched.stats["prefix_hits"] == 0
        assert eng.alloc.stats["prefix_maps"] == 0


@pytest.mark.parametrize("overlap", [False, True])
def test_partial_match_does_not_block_its_own_eviction(overlap):
    """Pool of 3 pages at ps=2, one slot: the second request only
    partially matches the first's cached page and needs all 3 pages (its
    prompt, its first decoded token and a page of headroom), so
    admission must drop the partial match and evict the page it pinned
    (no livelock)."""
    eng, sched = _run([[1, 2, 3], [1, 9, 9]], 2, cache=True,
                      overlap=overlap, n_pages=4, page_size=2, max_seqs=1,
                      max_pages_per_seq=3)
    assert sched.stats["cache_evicted_pages"] >= 1


@pytest.mark.parametrize("overlap", [False, True])
def test_cache_eviction_under_memory_pressure(overlap):
    """Two 8-token system prompts in turn on a pool that holds one cached
    prefix and one running request: cold prefixes are evicted LRU."""
    cfg, _, _ = bridged("qwen3-0.6b")
    rng = np.random.default_rng(1)
    sys_a = rng.integers(0, cfg.vocab, 8).tolist()
    sys_b = rng.integers(0, cfg.vocab, 8).tolist()
    prompts = [(sys_a if i % 2 == 0 else sys_b)
               + rng.integers(0, cfg.vocab, 2).tolist() for i in range(4)]
    _, sched = _run(prompts, 3, cache=True, overlap=overlap, n_pages=10,
                    page_size=2, max_seqs=1, max_pages_per_seq=8)
    assert sched.stats["cache_evicted_pages"] > 0


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("cache", [False, True])
def test_preemption_resumes_from_cache(cache, overlap):
    """A pool too small for both running requests' lifetimes: the younger
    is preempted; with the cache its fed prefix is cached and re-admission
    maps it instead of re-prefilling from token zero."""
    prompts = _system_prompts(3, 6, 2, 3)
    _, sched = _run(prompts, 6, cache=cache, overlap=overlap, n_pages=14,
                    page_size=2, max_seqs=2, max_pages_per_seq=8)
    assert sched.stats["preemptions"] >= 1
    if cache:
        assert sched.stats["prefix_tokens_reused"] > 0


def test_overlap_under_preemption_with_cache():
    """Horizon 4 over 4 slots on 8 pages of 4 tokens: requests admit on
    their prompt + horizon budget (4 pages) but cannot both reach their
    20-token lifetime (5 pages each), so preemption, cache insertion of
    the victim's prefix, eviction and re-admission all race the in-flight
    horizon."""
    prompts = _system_prompts(9, 5, 3, 6)
    _, sched = _run(prompts, 12, cache=True, overlap=True, K=4, n_pages=9,
                    page_size=4, max_seqs=4, max_pages_per_seq=5)
    assert sched.stats["preemptions"] >= 1
    assert sched.stats["prefix_tokens_reused"] > 0


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["gemma3-12b", "recurrentgemma-9b",
                                  "mamba2-1.3b"])
def test_ring_and_recurrent_blocks_refuse_prefix_cache(arch):
    """RING/RECURRENT blocks never enter the sharing machinery: the
    scheduler refuses the combination at construction, and the
    allocator's map_shared guards the API itself."""
    cfg = serve.serve_config(arch)
    params = tm.init_params(cfg, seed=0, device="cpu")
    eng = PagedEngine(cfg, params, n_pages=17, page_size=8, max_seqs=2,
                      max_pages_per_seq=4, device="cpu")
    assert not eng.supports_prefix_sharing
    with pytest.raises(ValueError, match="prefix"):
        Scheduler(eng, prefix_cache=PrefixCache(page_size=8))
    blk = eng.alloc.alloc(0)
    with pytest.raises(ValueError, match="RING/RECURRENT"):
        eng.alloc.map_shared(blk, [1], 8)


def test_scheduler_refuses_cache_of_another_page_size():
    cfg, _, tp = bridged("qwen3-0.6b")
    eng = PagedEngine(cfg, tp, n_pages=9, page_size=4, max_seqs=2,
                      device="cpu")
    with pytest.raises(ValueError, match="page_size"):
        Scheduler(eng, prefix_cache=PrefixCache(page_size=8))


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------
LAUNCH = ["--device", "cpu", "--requests", "4", "--max-new", "5",
          "--batch-slots", "2", "--prompt-len", "4", "--decode-horizon",
          "4", "--shared-prefix", "20"]


def _plain_greedy(cfg, params, prompt, max_new):
    """The port's own plain greedy decode (launcher weights come from the
    port's init_params)."""
    logits, caches = tm.prefill(cfg, params, {"tokens": torch.tensor(
        [prompt])}, len(prompt) + max_new)
    out = [int(logits[0, 0].argmax())]
    for pos in range(len(prompt), len(prompt) + max_new - 1):
        logits, caches = tm.decode_step(cfg, params, caches,
                                        torch.tensor([[out[-1]]]), pos)
        out.append(int(logits[0, 0].argmax()))
    return out


@lru_cache(maxsize=None)
def _launch(extra):
    finished, eng, sched = serve.main(LAUNCH + list(extra))
    return {r.rid: (r.prompt, r.out) for r in finished}, eng, sched


@pytest.mark.parametrize("extra", [(), ("--no-prefix-cache",),
                                   ("--overlap",)])
def test_launcher_shared_prefix_modes_match_plain_greedy(extra):
    """Cache on (the default), off, and on with overlap: each request's
    tokens equal the plain greedy decode and the other modes'; with the
    cache, requests 3 and 4 hit (2 slots fill before anything is cached):
    20 system tokens are 2 full pages mapped and one COW clone each."""
    got, eng, sched = _launch(extra)
    cfg, params = eng.cfg, eng.params
    for rid, (prompt, out) in got.items():
        assert len(prompt) == 24 and prompt[:20] == got[0][0][:20]
        assert out == _plain_greedy(cfg, params, prompt, 5), rid
    if extra:
        assert got == _launch(())[0]
    cache = sched.prefix_cache
    if "--no-prefix-cache" in extra:
        assert cache is None and sched.stats["prefix_hits"] == 0
    else:
        hits = sched.stats["prefix_hits"]
        assert hits == 2 and cache.hit_rate == hits / 4
        assert sched.stats["prefix_tokens_reused"] == 20 * hits
        assert eng.alloc.stats["cow_clones"] == hits
        assert eng.alloc.stats["prefix_pages_mapped"] == 2 * hits
        assert eng.free_pages == eng.alloc.free_pages
        eng.alloc.release(cache.evict(cache.n_pages))
        assert eng.pages_in_use == 0
    assert (sched.stats["overlap_staged_ticks"] > 0) == \
        ("--overlap" in extra)
    assert eng.n_pages == 1 + 2 * (32 + 20 // 8)


def test_launcher_cache_saves_prefill_steps():
    on, off = _launch(())[1], _launch(("--no-prefix-cache",))[1]
    assert on.stats["token_steps"] < off.stats["token_steps"]


def test_launcher_turns_cache_off_for_ring_and_recurrent(capsys):
    finished, eng, sched = serve.main(
        ["--arch", "recurrentgemma-9b", "--device", "cpu", "--requests",
         "2", "--max-new", "3", "--shared-prefix", "8"])
    assert sched.prefix_cache is None and len(finished) == 2
    assert "prefix cache disabled" in capsys.readouterr().out


def test_shared_prefix_zero_keeps_the_prompt_draw():
    """A draw of 0 system tokens leaves the generator where it was, so
    without ``--shared-prefix`` the prompts are those drawn before the
    flag existed."""
    cfg, _, tp = bridged("qwen3-0.6b")
    rng = np.random.default_rng(5)
    old = [rng.integers(0, cfg.vocab, 4).tolist() for _ in range(3)]
    finished, _, _ = serve.serve(cfg, tp, requests=3, max_new=2,
                                 batch_slots=2, seed=5, device="cpu")
    assert [r.prompt for r in sorted(finished, key=lambda r: r.rid)] == old
