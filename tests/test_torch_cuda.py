"""Port tests that need an NVIDIA GPU (marker ``cuda``; they skip without
one).  This file imports only torch, numpy and ``repro_torch``, so it also
runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

  * the hand-written paged-attention kernel agrees with both plain twins
    on the test grid (warps per block and forced page splits crossed) and
    the main path's shape up to 2,048 tokens (fp32, 1e-5: the same math
    summed in another order); two calls are bit-equal, and the split
    launches leave their counters at 0;
  * junk pages past seq_len, out-of-range ids included, cannot change the
    output or fault; seq_len 0 gives 0;
  * the wrapper refuses what the kernel does not take, and a CUDA engine
    refuses the plain twin;
  * the engine's decode horizon enqueues work only: no host sync under
    ``torch.cuda.set_sync_debug_mode("error")``, and its logits match the
    CPU engine's, for qwen3 and for the mixed stacks (gemma3, recurrentgemma,
    mamba2, mixtral smoke);
  * the kernel on ring-table rows at the ring pool's shapes (d 256 with g
    2 and g 16, d 128 with g 4; 128- to 512-page rows; empty, partly
    filled and full rings) agrees with both plain twins;
  * the mixed stacks' smoke configs served on the card give the plain
    model's greedy decode, with (full + ring layers) x token steps kernel
    launches;
  * prefix sharing: the kernel on page tables whose rows share pages (one
    a COW copy) is bit-equal to the kernel on private copies; the launcher
    with a shared system prompt, cache on and overlap off and on, gives
    the plain greedy decode with hits and COW clones and drains its pool;
    the overlap's staged half (cache eviction, admission with a hit,
    prefill staging) runs under ``set_sync_debug_mode("error")`` while a
    decode horizon's event is pending;
  * open-loop traffic on the virtual clock under pool pressure, traced
    and untraced, overlap off and on: the port's checker accepts the
    trace, tokens and host reads are equal, tokens the plain greedy
    decode;
  * the host swap tier on the card: a block's pages, ring frames and
    recurrent rows round-trip ``swap_out``/``swap_in`` (into another slot)
    bit-exact, with the same image checksum; ``swap_in`` (``restore_block``
    and ``restore_aux`` behind pinned staging) runs under
    ``set_sync_debug_mode("error")`` while earlier work is still running
    on the card and never waits for it; the kernel on the restored row and
    ring row is bit-equal to the kernel on the original ones;
  * the fault plane and disaggregation on the card: the qwen3 smoke
    serve on two engines with faults at 0.1 gives the unified serve's
    tokens with no fault left unresolved; the recurrentgemma smoke serve
    on two engines (ring frames and recurrent rows in each image) gives
    the unified serve's tokens; ``import_image`` under pending work is
    sync-free and lands the image bit for bit; a checkpoint of CUDA
    tensors restores with their dtype and device;
  * the SIMDRAM pack, unpack and μProgram-VM kernels agree bit for bit with
    their plain versions (ragged tails, both styles, every block size, 1,
    2 and 4 words per thread, div at 32 bits in blocks of 1,024); the
    transpose kernels at every n_bits 1..32, on either side of each tile,
    on input 4 or 8 bytes off 16-byte alignment, on plane rows off it
    (n_words % 4 of 1, 2, 3), on int64 with its high word set, and at
    2^20 and 2^26 elements;
    their wrappers refuse what the kernels do not take, and a CUDA
    ``apply_op`` goes through the VM kernel and never through ``execute``;
  * the bit-serial matmul kernel, on packed planes, agrees bit for bit with
    its plain version (the test grid, ragged and unaligned shapes, decode
    batches, the main path's shapes, with and without split-K), its
    wrapper refuses what it does not take, and the
    quantized layers, ``qmm`` (``torch._int_mm``) and the quantized model
    on the card agree with the CPU (1e-6 relative for one layer: the same
    int32 sums, float32 scales; 1e-4 for logits: float32 layers summed in
    another order on the card);
  * training: three train steps of the qwen3 smoke config at float32
    compute on the card and on the CPU from the same params and batches
    agree (loss and grad norm 1e-5 relative; params 4e-5 absolute: Adam
    moves an element by up to its learning rate whatever the size of its
    gradient, so one whose gradient is at rounding level may step either
    way, and the three steps' rates, 3e-6, 6e-6 and 9e-6, bound that at
    2 x 1.8e-5); a train step at the configs' own bfloat16 compute (qwen3,
    the MoE of mixtral, internvl2's vision slice with its 4 microbatches,
    whisper's encoder) runs under ``set_sync_debug_mode("error")``, its
    batch staged through pinned memory; whisper-small's prefill and two
    decode steps on the card give the CPU's logits (1e-4) and the CPU's
    greedy tokens;
  * serving on a device mesh: the engine on a 1x1 mesh with the kernel
    serves qwen3, gemma3, recurrentgemma and mamba2 smoke with the
    unmeshed engine's tokens and kernel launches, no collective, and a
    horizon free of host syncs, and so does it for the MoE stacks
    (mixtral, qwen3-moe) through ``moe_ep``; a 1x2 mesh on two cards over
    nccl gives the unmeshed tokens for qwen3 and mixtral (skipped on a
    machine with one card);
  * the legacy path: ``paged_decode_attention`` on the kernel gives its
    plain twin's output on out-of-order rows, and ``--legacy`` gives the
    engine launcher's tokens with one launch per layer per decode call.
"""
import numpy as np
import pytest
import torch

from repro_torch import core as tc
from repro_torch.core import bitplane as tbp
from repro_torch.examples import quickstart
from repro_torch.examples import simdram_quantized_lm
from repro_torch.kernels import bitplane_transpose as tt
from repro_torch.kernels.bitserial_matmul import ops as bs
from repro_torch.kernels.bitserial_matmul import ref as bs_ref
from repro_torch.kernels.paged_attention import ops, paged_attention
from repro_torch.checkpoint.checkpoint import restore_pytree, save_pytree
from repro_torch.core.vbi import kvcache as tk
from repro_torch.core.vbi.blocks import PagePool, VBIAllocator
from repro_torch.core.vbi.kvcache import make_ring_table
from repro_torch.kernels.simdram_vm import ops as vm
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import serve_config
from repro_torch.models import model as tm
from repro_torch.models.model import init_params
from repro_torch.models.quantized import qmm, quantize_serving_params
from repro_torch.configs import smoke_config
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.device import stage
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import init_train_state, make_train_step
from repro_torch.tree import leaves
from repro_torch.serve.engine import PagedEngine, batched_paged_attention
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.telemetry import Telemetry, check_trace
from repro_torch.serve.traffic import TrafficDriver, VirtualClock, make_trace

from _torch_simdram_cases import alias_program, hand_program

pytestmark = pytest.mark.cuda

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


def _inputs(S, n_kv, g, d, ps, n_pages, width, lens, seed, device):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((S, n_kv, g, d)) / np.sqrt(d)).astype(np.float32)
    k = rng.standard_normal((n_pages, ps, n_kv, d)).astype(np.float32)
    v = rng.standard_normal((n_pages, ps, n_kv, d)).astype(np.float32)
    pt = np.stack([rng.choice(np.arange(1, n_pages), width, replace=False)
                   for _ in range(S)]).astype(np.int32)
    ln = np.asarray(lens, np.int32)
    return [torch.from_numpy(x).to(device) for x in (q, k, v, pt, ln)]


@pytest.mark.parametrize("blocks", [None, 1, 2, 5])
@pytest.mark.parametrize("splits", [None, 1, 3])
@pytest.mark.parametrize("ps", [2, 4])
@pytest.mark.parametrize("d", [8, 16])
@pytest.mark.parametrize("gqa", [(2, 3), (1, 4), (4, 1), (2, 2)])
def test_kernel_matches_plain_on_grid(dev, gqa, d, ps, splits, blocks):
    n_kv, g = gqa
    q, k, v, pt, ln = _inputs(5, n_kv, g, d, ps, 12, 10, [0, 1, 5, 16, 31],
                              seed=d * 10 + ps, device=dev)
    out = paged_attention(q, k, v, pt, ln, 8, splits=splits, blocks=blocks)
    torch.testing.assert_close(out, ops._plain(q, k, v, pt, ln, 8), **TOL)
    torch.testing.assert_close(
        out, batched_paged_attention(q, k, v, pt, ln, 8), **TOL)
    assert out[0].abs().max().item() == 0.0          # seq_len 0 → zeros


#: (seq_lens, max_pages) at the serve's widths (4 slots, 8 kv heads, g 2,
#: d 128, pages of 8): its 32-page rows, and 256-page rows for 2,048 tokens
MAIN_CASES = [([0, 1, 7, 8], 32), ([9, 255, 256, 17], 32),
              ([19, 2048, 0, 700], 256)]


def _main_inputs(lens, max_pages, seed=3):
    # distinct pages within each row, a pool of 4 rows' worth
    return _inputs(4, 8, 2, 128, 8, 4 * max_pages + 9, max_pages + 2, lens,
                   seed=seed, device=torch.device("cuda", 0))


@pytest.mark.parametrize("lens,max_pages", MAIN_CASES)
def test_kernel_matches_plain_at_main_path_shape(dev, lens, max_pages):
    q, k, v, pt, ln = _main_inputs(lens, max_pages)
    out = paged_attention(q, k, v, pt, ln, max_pages)
    torch.testing.assert_close(
        out, batched_paged_attention(q, k, v, pt, ln, max_pages), **TOL)
    torch.testing.assert_close(
        out, ops._plain(q, k, v, pt, ln, max_pages), **TOL)
    assert not out[[i for i, n in enumerate(lens) if n == 0]].any()


@pytest.mark.parametrize("lens,max_pages", MAIN_CASES)
def test_kernel_is_bit_equal_twice_and_leaves_counters_at_zero(
        dev, lens, max_pages):
    q, k, v, pt, ln = _main_inputs(lens, max_pages, seed=4)
    for kw in ({}, {"blocks": 3}, {"blocks": 8, "splits": 5}):
        a = paged_attention(q, k, v, pt, ln, max_pages, **kw)
        b = paged_attention(q, k, v, pt, ln, max_pages, **kw)
        torch.cuda.synchronize()
        assert torch.equal(a, b), kw
    for _, counters in ops._scratch.values():
        assert not counters.any()


@pytest.mark.parametrize("lens,max_pages", MAIN_CASES)
def test_kernel_simplest_form_agrees_with_default(dev, lens, max_pages):
    """``blocks=1, splits=1``: one warp walks the whole sequence, no merge
    at all; the second reference for the split and merged forms."""
    q, k, v, pt, ln = _main_inputs(lens, max_pages, seed=5)
    one = paged_attention(q, k, v, pt, ln, max_pages, blocks=1, splits=1)
    for kw in ({}, {"blocks": 4}, {"blocks": 7, "splits": 16}):
        torch.testing.assert_close(
            paged_attention(q, k, v, pt, ln, max_pages, **kw), one, **TOL)


def test_kernel_ignores_garbage_pages(dev):
    q, k, v, pt, ln = _inputs(1, 1, 2, 4, 2, 6, 4, [3], seed=0, device=dev)
    pt2 = pt.clone()
    pt2[0, 2:] = torch.tensor([0, 5], dtype=torch.int32, device=dev)
    assert torch.equal(paged_attention(q, k, v, pt, ln, 4),
                       paged_attention(q, k, v, pt2, ln, 4))


@pytest.mark.parametrize("blocks", [None, 1, 3])
def test_kernel_never_dereferences_pages_past_seq_len(dev, blocks):
    """Page-table entries past seq_len set to ids outside the pool (-1,
    n_pages + 1000) neither fault nor change the output."""
    lens, max_pages = [19, 2048, 0, 700], 256
    q, k, v, pt, ln = _main_inputs(lens, max_pages, seed=6)
    n_pages = k.shape[0]
    want = paged_attention(q, k, v, pt, ln, max_pages, blocks=blocks)
    bad = pt.clone()
    for s, n in enumerate(lens):
        used = -(-n // 8)
        bad[s, used:] = torch.where(
            torch.arange(bad.shape[1] - used, device=dev) % 2 == 0,
            -1, n_pages + 1000).to(torch.int32)
    got = paged_attention(q, k, v, bad, ln, max_pages, blocks=blocks)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_kernel_counts_launches_and_rejects_bad_inputs(dev):
    q, k, v, pt, ln = _inputs(2, 2, 2, 16, 4, 12, 8, [3, 9], seed=1,
                              device=dev)
    before = paged_attention.launches
    paged_attention(q, k, v, pt, ln, 8)
    assert paged_attention.launches == before + 1
    with pytest.raises(TypeError):
        paged_attention(q.double(), k, v, pt, ln, 8)
    with pytest.raises(TypeError):
        paged_attention(q, k, v, pt.long(), ln, 8)
    with pytest.raises(ValueError):
        paged_attention(q.transpose(1, 2), k, v, pt, ln, 8)
    with pytest.raises(ValueError):
        paged_attention(q, k, v, pt, ln, 9)               # wider than pt
    with pytest.raises(ValueError):
        paged_attention(q, k, v, pt, ln.cpu(), 8)
    with pytest.raises(ValueError):
        paged_attention(q, k, v, pt, ln, 8, splits=17)    # > 16 warps
    with pytest.raises(ValueError):
        paged_attention(q, k, v, pt, ln, 8, blocks=0)
    with pytest.raises(ValueError):                       # d % 4 != 0
        paged_attention(q[..., :14].contiguous(), k[..., :14].contiguous(),
                        v[..., :14].contiguous(), pt, ln, 8)
    assert paged_attention.launches == before + 1


def test_cuda_engine_refuses_the_plain_twin(dev):
    cfg = serve_config("qwen3-0.6b")
    params = init_params(cfg, seed=0, device=dev)
    with pytest.raises(ValueError, match="gather"):
        PagedEngine(cfg, params, n_pages=9, page_size=4, max_seqs=2,
                    attn_impl="gather", device=dev)


def test_decode_horizon_is_sync_free_and_matches_cpu(dev):
    _horizon_sync_free_and_as_cpu(serve_config("qwen3-0.6b"), dev)


def _horizon_sync_free_and_as_cpu(cfg, dev):
    """A fused horizon on the card under set_sync_debug_mode("error"),
    its tokens and a following step's logits against the CPU engine on
    the same params."""
    params = init_params(cfg, seed=0, device=dev)
    cpu_params = _to(params, torch.device("cpu"))
    engines = {
        "cuda": PagedEngine(cfg, params, n_pages=17, page_size=4,
                            max_seqs=2, max_pages_per_seq=8, device=dev),
        "cpu": PagedEngine(cfg, cpu_params, n_pages=17, page_size=4,
                           max_seqs=2, max_pages_per_seq=8, device="cpu")}
    blocks, logits = {}, {}
    for name, eng in engines.items():
        d = eng.device
        for s in range(2):
            eng.alloc.reserve_span(eng.alloc.alloc(s), 5, 8)
        eng.prefill_chunk(
            torch.tensor([[3, 1, 4, 1, 5], [9, 2, 6, 5, 3]],
                         dtype=torch.int32, device=d),
            torch.full((2,), 5, dtype=torch.int32, device=d))
        toks = torch.tensor([7, 8], dtype=torch.int32, device=d)
        mask = torch.ones(2, dtype=torch.bool, device=d)
        steps = torch.tensor([8, 5], dtype=torch.int32, device=d)
        if d.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            blocks[name] = eng.decode_many(toks, mask, steps, 8)
        finally:
            if d.type == "cuda":
                torch.cuda.set_sync_debug_mode("default")
        blocks[name] = blocks[name].cpu()
        logits[name] = eng.decode(toks, mask).cpu()
    torch.testing.assert_close(logits["cuda"], logits["cpu"], atol=1e-4,
                               rtol=1e-4)
    assert torch.equal(blocks["cuda"], blocks["cpu"])
    assert (blocks["cuda"][5:, 1] == -1).all()


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


# -- the mixed stacks: ring pool, recurrent state, MoE -----------------------
#: the ring pool's kernel shapes at page size 8 (configs/*.py): (n_kv, g,
#: d, ring pages) of gemma3-12b (window 1,024), recurrentgemma-9b (2,048)
#: and mixtral-8x7b (4,096)
RING_SHAPES = [(8, 2, 256, 128), (1, 16, 256, 256), (8, 4, 128, 512)]
MIXED = ["gemma3-12b", "recurrentgemma-9b", "mamba2-1.3b", "mixtral-8x7b"]


@pytest.mark.parametrize("kw", [{}, {"blocks": 1, "splits": 1},
                                {"blocks": 3}, {"blocks": 8, "splits": 5},
                                {"splits": 16}])
@pytest.mark.parametrize("shape", RING_SHAPES)
def test_kernel_on_ring_rows_matches_plain(dev, shape, kw):
    """Ring-table rows (static, contiguous) at lengths 0, 1, a partly
    filled ring and a full ring (seq_len = window); two calls bit-equal."""
    n_kv, g, d, rp = shape
    ps, S = 8, 4
    W = rp * ps
    rng = np.random.default_rng(rp + d)
    q = (rng.standard_normal((S, n_kv, g, d)) / np.sqrt(d)).astype(np.float32)
    k, v = (rng.standard_normal((1 + S * rp, ps, n_kv, d)).astype(np.float32)
            for _ in range(2))
    q, k, v = (torch.from_numpy(x).to(dev) for x in (q, k, v))
    table = torch.from_numpy(make_ring_table(S, rp)).to(dev)
    ln = torch.tensor([0, 1, W // 2 + 3, W], dtype=torch.int32, device=dev)
    out = paged_attention(q, k, v, table, ln, rp, **kw)
    again = paged_attention(q, k, v, table, ln, rp, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    torch.testing.assert_close(out, ops._plain(q, k, v, table, ln, rp), **TOL)
    torch.testing.assert_close(
        out, batched_paged_attention(q, k, v, table, ln, rp), **TOL)
    assert not out[0].any()


def _plain_greedy_agrees(cfg, params, req, dev, tie_gap=1e-4):
    """The request's tokens against the plain model's greedy decode on the
    card, up to the first near tie (top-two gap under ``tie_gap``)."""
    toks = torch.tensor([req.prompt], dtype=torch.long, device=dev)
    logits, caches = tm.prefill(cfg, params, {"tokens": toks},
                                len(req.prompt) + req.max_new)
    for i, t in enumerate(req.out):
        top2 = torch.topk(logits[0, 0], 2)
        if (top2.values[0] - top2.values[1]).item() < tie_gap:
            return
        assert int(top2.indices[0]) == t, f"token {i}"
        logits, caches = tm.decode_step(
            cfg, params, caches, torch.tensor([[t]], device=dev),
            len(req.prompt) + i)


@pytest.mark.parametrize("arch", MIXED)
def test_mixed_stack_serves_on_card_as_plain_greedy(dev, arch):
    cfg = serve_config(arch)
    params = init_params(cfg, seed=0, device=dev)
    eng = PagedEngine(cfg, params, n_pages=33, page_size=8, max_seqs=2,
                      max_pages_per_seq=8, device=dev)
    sched = Scheduler(eng, prefill_chunk=4, decode_horizon=8)
    rng = np.random.default_rng(5)
    for _ in range(3):
        sched.add_request(rng.integers(0, cfg.vocab, 5).tolist(), max_new=20)
    before = paged_attention.launches
    fin = sched.run()
    geom = eng.geom
    assert (paged_attention.launches - before
            == (geom.n_full + geom.n_ring) * eng.stats["token_steps"])
    assert eng.free_pages == eng.alloc.free_pages == 32
    for req in fin:
        assert len(req.out) == 20
        _plain_greedy_agrees(cfg, params, req, dev)


@pytest.mark.parametrize("arch", MIXED)
def test_mixed_stack_horizon_is_sync_free_and_matches_cpu(dev, arch):
    _horizon_sync_free_and_as_cpu(serve_config(arch), dev)


# -- SIMDRAM: transposition unit and μProgram VM -----------------------------
def test_kernel_on_shared_page_tables_equals_private_copies(dev):
    """Rows 0 and 1 on the same pages, row 2 on them but a COW copy of the
    last: bit-equal to the same launch on private copies of each row's
    pages, within 1e-5 of the plain twin, at seq_len 19 and 256."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    n_kv, g, d, ps, width = 8, 2, 128, 8, 32
    for seq_len in (19, 256):
        n_used = -(-seq_len // ps)
        n_pages = 2 + n_used
        q = torch.randn((3, n_kv, g, d), generator=gen, device=dev)
        q[1] = q[0]
        k = torch.randn((n_pages, ps, n_kv, d), generator=gen, device=dev)
        v = torch.randn((n_pages, ps, n_kv, d), generator=gen, device=dev)
        base = torch.randperm(n_pages - 2, generator=gen, device=dev) + 1
        cow = n_pages - 1
        k[cow, :4], v[cow, :4] = k[base[-1], :4], v[base[-1], :4]
        pt = torch.zeros((3, width), dtype=torch.int32, device=dev)
        pt[:, :n_used] = base.to(torch.int32)
        pt[2, n_used - 1] = cow
        ppt = torch.zeros_like(pt)
        ppt[:, :n_used] = (1 + torch.arange(3 * n_used, device=dev)
                           .view(3, n_used)).to(torch.int32)
        src = pt[:, :n_used].reshape(-1).long()
        pk = torch.zeros((1 + 3 * n_used, ps, n_kv, d), device=dev)
        pv = torch.zeros_like(pk)
        pk[1:], pv[1:] = k[src], v[src]
        ln = torch.full((3,), seq_len, dtype=torch.int32, device=dev)
        plain = batched_paged_attention(q, k, v, pt, ln, width)
        for splits, blocks in ((None, None), (1, 1), (None, 2), (3, 5)):
            got = paged_attention(q, k, v, pt, ln, width, splits=splits,
                                  blocks=blocks)
            priv = paged_attention(q, pk, pv, ppt, ln, width,
                                   splits=splits, blocks=blocks)
            assert torch.equal(got, priv) and torch.equal(got[0], got[1])
            torch.testing.assert_close(got, plain, **TOL)


@pytest.mark.parametrize("overlap", [False, True])
def test_prefix_cache_serves_on_card_as_plain_greedy(dev, overlap):
    cfg = serve_config("qwen3-0.6b")
    params = init_params(cfg, seed=0, device=dev)
    before = paged_attention.launches
    fin, eng, sched = launch_serve.serve(
        cfg, params, requests=6, max_new=5, decode_horizon=4,
        shared_prefix=20, overlap=overlap, device=dev)
    assert (paged_attention.launches - before
            == eng.geom.n_full * eng.stats["token_steps"])
    assert sched.stats["prefix_hits"] == eng.alloc.stats["cow_clones"] == 2
    assert sched.stats["prefix_tokens_reused"] == 40
    assert (sched.stats["overlap_staged_ticks"] > 0) == overlap
    for req in fin:
        _plain_greedy_agrees(cfg, params, req, dev)
    assert eng.free_pages == eng.alloc.free_pages
    cache = sched.prefix_cache
    eng.alloc.release(cache.evict(cache.n_pages))
    assert eng.pages_in_use == 0


def test_prefix_staged_half_is_sync_free(dev):
    """Cache eviction, admission with a hit (map_shared + cow_break) and
    prefill staging, with every host sync an error, while the event of
    the horizon in flight is pending (a spin kernel queued behind it)."""
    cfg = serve_config("qwen3-0.6b")
    params = init_params(cfg, seed=0, device=dev)
    eng = PagedEngine(cfg, params, n_pages=65, page_size=8, max_seqs=4,
                      max_pages_per_seq=16, device=dev)
    sched = Scheduler(eng, prefill_chunk=8, decode_horizon=4, overlap=True,
                      prefix_cache=PrefixCache(8))
    rng = np.random.default_rng(2)
    system = rng.integers(0, cfg.vocab, 20).tolist()
    sched.add_request(rng.integers(0, cfg.vocab, 16).tolist(), max_new=2)
    sched.run()                          # 2 cold cached pages
    sched.add_request(system + [5, 6], max_new=30)
    while sched.prefix_cache.n_pages <= 2 or sched._pending is None:
        sched.step()
    decode_many = eng.decode_many

    def spun(*args):
        block = decode_many(*args)
        torch.cuda._sleep(int(400e6))
        return block
    eng.decode_many = spun
    sched.step()
    eng.decode_many = decode_many
    sched.add_request(system[:12] + [9, 9, 9], max_new=4)
    reconcile, pending = sched._decode_reconcile, []

    def reconcile_after_staging():
        torch.cuda.set_sync_debug_mode("default")
        pending.append(not sched._pending[1].query())
        return reconcile()
    sched._decode_reconcile = reconcile_after_staging
    hits = sched.stats["prefix_hits"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        assert sched._evict_cache(2) == 2
        sched.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sched._decode_reconcile = reconcile
    assert pending == [True] and sched.stats["prefix_hits"] == hits + 1
    done = sched.run()
    assert sorted(len(r.out) for r in done) == [2, 4, 30]
    eng.alloc.release(sched.prefix_cache.evict(sched.prefix_cache.n_pages))
    assert eng.pages_in_use == 0 and eng.free_pages == eng.alloc.free_pages


@pytest.mark.parametrize("overlap", [False, True])
def test_traced_open_loop_serve_on_card(dev, overlap):
    """Open-loop traffic on the virtual clock under pool pressure (host
    swap tier), traced and untraced: the port's checker accepts the
    trace, the tokens are equal, and so are the host reads."""
    cfg = serve_config("qwen3-0.6b")
    params = init_params(cfg, seed=0, device=dev)
    trace = make_trace(cfg.vocab, n_requests=8, rate=2.0, seed=9,
                       max_prompt=8, max_new_cap=12)
    runs = []
    for traced in (True, False):
        eng = PagedEngine(cfg, params, n_pages=9, page_size=4, max_seqs=4,
                          max_pages_per_seq=5, host_swap_pages=16,
                          device=dev)
        telem = Telemetry(trace=True) if traced else None
        sched = Scheduler(eng, prefill_chunk=4, decode_horizon=4,
                          overlap=overlap, telemetry=telem)
        before = paged_attention.launches
        fin = TrafficDriver(sched, trace, clock=VirtualClock()).run()
        assert (paged_attention.launches - before
                == eng.geom.n_full * eng.stats["token_steps"])
        assert sched.stats["swap_ins"] >= 1
        assert eng.pages_in_use == 0 and eng.alloc.swap.used_pages == 0
        runs.append(({r.rid: r.out for r in fin},
                     sched.stats["host_syncs"]))
        if traced:
            summary = check_trace(telem.tracer.events)
            assert summary["live_blocks"] == 0
            evs = [e["ev"] for e in telem.tracer.events if e["type"] == "req"]
            assert evs.count("arrive") == evs.count("finish") == 8
            for req in fin:
                _plain_greedy_agrees(cfg, params, req, dev)
    assert runs[0] == runs[1]


def _swap_pool(dev, seed=0):
    """A pool with two full, two ring (3 frames) and one RG-LRU layer on
    the card, its payload seeded, a host tier of 64 pages, and one block
    of 13 tokens (4 pages of 4) on slot 0."""
    pool = PagePool(n_layers=2, n_pages=33, page_size=4, n_kv=2, head_dim=8,
                    max_seqs=4, max_pages_per_seq=8, ring_layers=2,
                    ring_pages=3, rg_layers=1, rnn_width=16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for name in ("k_pages", "v_pages", "k_ring", "v_ring", "rg_h",
                 "rg_conv"):
        t = getattr(pool.state, name)
        t.copy_(torch.randn(t.shape, generator=gen, device=dev))
    al = VBIAllocator(pool, host_swap_pages=64)
    blk = al.alloc(0)
    for n in range(13):
        al.reserve(blk, n + 1)
        tk.reserve_positions(pool.state, torch.arange(4, device=dev) == 0)
        al.commit(blk, n + 1)
    return pool, al, blk


def _same_payload(a, b):
    np.testing.assert_array_equal(a.k, b.k)
    np.testing.assert_array_equal(a.v, b.v)
    for x, y in zip(a.aux, b.aux):
        np.testing.assert_array_equal(x, y)


def test_swap_round_trip_is_bit_exact(dev):
    pool, al, blk = _swap_pool(dev)
    snap = al.snapshot_image(blk)
    assert al.swap_out(blk) and al.pages_in_use == 0
    _same_payload(al.swap.images[blk.bid], snap)
    al.swap_in(blk, 2)
    back = al.snapshot_image(blk)
    _same_payload(back, snap)
    assert back.checksum == snap.checksum and back.n_pages == 4
    assert torch.equal(pool.state.rg_h[:, 2].cpu(),
                       torch.from_numpy(snap.aux[2]))
    al.free(blk)
    assert al.pages_in_use == 0 and al.swap.used_pages == 0
    assert al.free_pages == pool.n_pages - 1


def test_swap_in_is_sync_free_under_pending_work(dev):
    """``swap_in`` stages the image through fresh pinned buffers and
    enqueues ``restore_block`` and ``restore_aux``: no host sync, and the
    event behind a 0.2 s spin (a horizon in flight) is still pending when
    it returns."""
    pool, al, blk = _swap_pool(dev)
    assert al.swap_out(blk)
    img = al.swap.images[blk.bid]
    torch.cuda.synchronize()
    torch.cuda._sleep(int(400e6))
    ev = torch.cuda.Event()
    ev.record()
    torch.cuda.set_sync_debug_mode("error")
    try:
        al.swap_in(blk, 3, reserve_pages=6)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert not ev.query()
    torch.cuda.synchronize()
    _same_payload(al.snapshot_image(blk), img)
    assert al.free_pages == pool.n_pages - 1 - 6


def _serve_tokens(argv):
    fin, eng, sched = launch_serve.main(argv + ["--device", "cuda"])
    return {r.rid: r.out for r in fin}, eng, sched


def test_disagg_with_faults_on_card_equals_unified(dev):
    unified, _, _ = _serve_tokens([])
    out, eng, dsch = _serve_tokens(["--disagg", "--faults", "--fault-rate",
                                    "0.1"])
    assert out == unified and dsch.stats["handoffs"] == 6
    assert sum(dsch.faults.fired.values()) > 0
    assert dsch.faults.stats["unresolved"] == 0
    assert eng.pages_in_use == 0 and dsch.prefill.engine.pages_in_use == 0


def test_disagg_recurrentgemma_on_card_equals_unified(dev):
    arch = ["--arch", "recurrentgemma-9b"]
    unified, _, _ = _serve_tokens(arch)
    out, eng, dsch = _serve_tokens(arch + ["--disagg"])
    assert out == unified and dsch.stats["handoffs"] == 6
    assert eng.geom.n_ring and eng.geom.n_rg
    assert eng.alloc.stats["image_imports"] == 6


def test_import_image_is_sync_free_under_pending_work(dev):
    """``import_image`` verifies the sealed image on the host, stages it
    through fresh pinned buffers and enqueues the scatter: no host sync,
    and the event behind a 0.2 s spin is still pending when it
    returns."""
    pool, al, blk = _swap_pool(dev)
    img = al.export_image(blk, tokens=list(range(13)))
    assert img.verify() and al.pages_in_use == 0
    torch.cuda.synchronize()
    torch.cuda._sleep(int(400e6))
    ev = torch.cuda.Event()
    ev.record()
    torch.cuda.set_sync_debug_mode("error")
    try:
        blk2 = al.import_image(img, 3, reserve_pages=6)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert not ev.query()
    torch.cuda.synchronize()
    _same_payload(al.snapshot_image(blk2), img)
    assert al.free_pages == pool.n_pages - 1 - 6


def test_checkpoint_of_cuda_tensors_keeps_dtype_and_device(dev, tmp_path):
    tree = {"w": torch.randn(3, 4, device=dev).to(torch.bfloat16),
            "ids": [torch.arange(5, device=dev, dtype=torch.int32)]}
    save_pytree(tree, tmp_path, step=1)
    back = restore_pytree({"w": torch.zeros(3, 4, dtype=torch.bfloat16,
                                            device=dev),
                           "ids": [torch.zeros(5, dtype=torch.int32,
                                               device=dev)]}, tmp_path, 1)
    assert back["w"].device == dev and back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"], tree["w"])
    assert back["ids"][0].device == dev and torch.equal(back["ids"][0],
                                                        tree["ids"][0])


def test_kernel_on_restored_rows_equals_original(dev):
    pool, al, blk = _swap_pool(dev, seed=1)
    st = pool.state
    gen = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn((4, 2, 2, 8), generator=gen, device=dev)

    def attend(q):
        ring_lens = torch.clamp(st.seq_lens, max=12)
        return (paged_attention(q, st.k_pages[1], st.v_pages[1],
                                st.page_table, st.seq_lens, 8),
                paged_attention(q, st.k_ring[0], st.v_ring[0],
                                pool.ring_table, ring_lens, 3))

    before = attend(q)
    assert al.swap_out(blk)
    al.swap_in(blk, 2)
    q2 = q.clone()
    q2[2] = q[0]
    after = attend(q2)
    for a, b in zip(before, after):
        assert torch.equal(a[0], b[2]) and a[0].abs().max() > 0


def _ints(n_bits, n, seed):
    rng = np.random.default_rng(seed)
    lo = -(1 << (n_bits - 1))
    return rng.integers(lo, -lo, n)


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n_elems", [1, 31, 32, 33, 1000, 4097])
@pytest.mark.parametrize("n_bits", [1, 4, 8, 16, 32])
def test_transpose_kernels_match_plain(dev, n_bits, n_elems, dtype, signed):
    x = torch.from_numpy(_ints(max(n_bits, 2), n_elems, n_bits * n_elems))
    if dtype == torch.int64:
        x = x + (7 << 40)                       # high word must not matter
    xc = x.to(dtype).to(dev)
    bp = tt.to_bitplanes(xc, n_bits, signed)
    ref = tbp.pack(x, n_bits, signed)
    assert torch.equal(bp.planes.cpu(), ref.planes)
    np.testing.assert_array_equal(
        bp.to_numpy(),
        tbp.pack_np(x.numpy(), n_bits, signed, "cpu").to_numpy())
    back = tt.from_bitplanes(bp)
    assert torch.equal(back.cpu(), tbp.unpack(ref))
    if n_bits == 32 and dtype == torch.int32:
        assert torch.equal(back, xc)            # round trip


def _transpose_exact(x, n_bits, signed=True):
    """Pack ``x`` (on the card) and unpack it again through the kernels,
    each bit-exact against the plain version on the CPU."""
    bp = tt.to_bitplanes(x, n_bits, signed)
    ref = tbp.pack(x.cpu(), n_bits, signed)
    assert torch.equal(bp.planes.cpu(), ref.planes)
    back = tt.from_bitplanes(bp)
    assert torch.equal(back.cpu(), tbp.unpack(ref))
    return bp, back


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("n_bits", range(1, 33))
def test_transpose_kernels_at_every_width(dev, n_bits, signed):
    x = torch.from_numpy(_ints(max(n_bits, 2), 4133, n_bits)).to(dev)
    _transpose_exact(x.to(torch.int32), n_bits, signed)


@pytest.mark.parametrize("kernel", ["pack", "unpack"])
@pytest.mark.parametrize("n_bits", [3, 8, 16, 32])
def test_transpose_kernels_around_each_tile(dev, n_bits, kernel):
    """One tile +- 1 element and +- 1 word, and 2 tiles + 1, at the pack
    and at the unpack tile: ragged last tiles and last words."""
    tw = tt.ops.PACK_TILE if kernel == "pack" else tt.ops.unpack_tile(n_bits)
    t = 32 * tw
    for n in (t - 32, t - 1, t, t + 1, t + 32, 2 * t + 1):
        x = torch.from_numpy(_ints(n_bits, n, n)).to(dev).to(torch.int32)
        _transpose_exact(x, n_bits)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_transpose_kernels_on_unaligned_input(dev, dtype):
    """x[1:] is 4 (int32) or 8 (int64) bytes off 16-byte alignment; the
    kernel takes it with 4-byte loads, with no copy and no refusal."""
    base = torch.from_numpy(_ints(32, 5001, 7)).to(dtype).to(dev)
    for off in (1, 2, 3):
        x = base[off:]
        assert x.data_ptr() % 16 != 0 or dtype == torch.int64
        for n_bits in (8, 32):
            _transpose_exact(x, n_bits)


@pytest.mark.parametrize("rem", [1, 2, 3])
@pytest.mark.parametrize("n_bits", [5, 8, 16, 32])
def test_transpose_kernels_on_unaligned_plane_rows(dev, n_bits, rem):
    """n_words % 4 != 0: plane rows 1.. start off 16-byte alignment, so
    their chunks go by 4-byte loads and stores."""
    nw = 4 * 37 + rem
    for n in (32 * nw, 32 * nw - 5):
        x = torch.from_numpy(_ints(n_bits, n, rem * n_bits)).to(dev)
        bp, _ = _transpose_exact(x.to(torch.int32), n_bits)
        assert bp.n_words % 4 == rem
        # the same planes 4 bytes past a 16-byte boundary: a contiguous
        # view into a larger buffer, as another caller may hold them
        flat = torch.zeros(n_bits * nw + 1, dtype=torch.int32, device=dev)
        view = flat[1:].view(n_bits, nw)
        view.copy_(bp.planes)
        assert view.is_contiguous() and view.data_ptr() % 16 == 4
        for signed in (True, False):
            moved = tbp.BitPlaneArray(view, n, signed)
            assert torch.equal(tt.from_bitplanes(moved).cpu(), tbp.unpack(
                tbp.BitPlaneArray(bp.planes.cpu(), n, signed)))


def test_transpose_kernels_cut_int64_to_its_low_word(dev):
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, 70001)).to(dev)
    assert (x >> 32).abs().min().item() > 0         # every high word set
    for n_bits in (1, 8, 31, 32):
        bp, _ = _transpose_exact(x, n_bits)
        low = _transpose_exact((x & 0xFFFFFFFF).to(torch.int64), n_bits)[0]
        assert torch.equal(bp.planes, low.planes)


def _plain_chunked(x, n_bits, signed, chunk=1 << 22):
    """The plain pack and unpack of ``x`` on the card, a slice of whole
    words at a time (the plain pack holds 8 n_bits bytes per element)."""
    planes = torch.cat([tbp.pack(x[i:i + chunk], n_bits, signed).planes
                        for i in range(0, x.shape[0], chunk)], dim=1)
    back = torch.cat([tbp.unpack(tbp.BitPlaneArray(
        planes[:, i // 32:(i + chunk) // 32],
        min(chunk, x.shape[0] - i), signed))
        for i in range(0, x.shape[0], chunk)])
    return planes, back


@pytest.mark.parametrize("n,n_bits", [(1 << 20, 8), (1 << 20, 32),
                                      ((1 << 20) + 17, 13), (1 << 26, 8),
                                      (1 << 26, 32)])
def test_transpose_kernels_at_main_path_sizes(dev, n, n_bits):
    gen = torch.Generator(device=dev)
    gen.manual_seed(n_bits)
    x = torch.randint(-2**31, 2**31, (n,), generator=gen, device=dev,
                      dtype=torch.int64).to(torch.int32)
    for signed in (True, False):
        bp = tt.to_bitplanes(x, n_bits, signed)
        planes, back = _plain_chunked(x, n_bits, signed)
        assert torch.equal(bp.planes, planes)
        assert torch.equal(tt.from_bitplanes(bp), back)


def _case(op, n, size, seed):
    spec = tc.OPS[op]
    rng = np.random.default_rng(seed)
    lo = -(1 << (n - 1))
    ins = [rng.integers(lo, -lo, size) for _ in range(spec.n_inputs)]
    if spec.n_inputs == 3:
        ins[0] = rng.integers(0, 2, size)
    return ins


@pytest.mark.parametrize("style", ["simdram", "ambit"])
@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("op", ["add", "gt", "relu", "bitcount", "if_else",
                                "mul", "div"])
def test_vm_kernel_matches_execute(dev, op, n, style):
    spec = tc.OPS[op]
    ins = _case(op, n, 1000, seed=n)
    bps = [tc.pack_np(x, n, device=dev) for x in ins]
    prog = tc.get_uprogram(op, n, style)
    planes = [bp.planes for bp in bps]
    ref = tc.execute(prog, dict(zip(spec.input_names, planes)),
                     bps[0].n_words, out_bits=spec.out_bits(n))
    for bw in (1, 32, 128, 1024):
        got = vm.run_uprogram(prog, planes, spec.input_names,
                              spec.out_bits(n), block_words=bw)
        assert torch.equal(got, ref), f"block_words={bw}"
    for bp, x in zip(bps, ins):                 # inputs never written
        np.testing.assert_array_equal(tc.unpack_np(bp), x)


def test_vm_kernel_at_64_bits_and_on_a_hand_program(dev):
    ins = _case("add", 64, 300, seed=64)
    bps = [tc.pack_np(x, 64, device=dev) for x in ins]
    out = tc.apply_op("add", *bps)
    np.testing.assert_array_equal(
        tc.unpack_np(out).astype(np.uint64),
        tc.ORACLES["add"](*ins, 64).astype(np.uint64))
    # six-row copies, ~DCC writes, reads past an input's width, an input
    # row overwritten and an OUT bit never written
    prog = hand_program()
    a = torch.from_numpy(np.random.default_rng(1).integers(
        0, 1 << 32, (2, 3), dtype=np.uint64).astype(np.uint32).view(
            np.int32)).to(dev)
    a0 = a.clone()
    ref = tc.execute(prog, {"A": a}, 3, out_bits=4)
    assert torch.equal(vm.run_uprogram(prog, [a], ["A"], 4), ref)
    assert torch.equal(a, a0)
    # outputs that are an input, its complement or a constant; a row
    # written twice by one AAP
    prog = alias_program()
    b = a[:1].clone()
    b0 = b.clone()
    ref = tc.execute(prog, {"A": a, "B": b}, 3, out_bits=7)
    for bw in (1, 32):
        assert torch.equal(vm.run_uprogram(prog, [a, b], ["A", "B"], 7,
                                           block_words=bw), ref)
    assert torch.equal(a, a0) and torch.equal(b, b0)


def test_vm_kernel_div32_in_blocks_of_1024(dev):
    ins = _case("div", 32, 5000, seed=32)
    ins[1] = np.where(ins[1] == 0, 1, ins[1])
    bps = [tc.pack_np(x, 32, device=dev) for x in ins]
    prog = tc.get_uprogram("div", 32)
    planes = [bp.planes for bp in bps]
    ref = tc.execute(prog, dict(zip(("A", "B"), planes)), bps[0].n_words,
                     out_bits=tc.OPS["div"].out_bits(32))
    for bw in (1024, 96):
        got = vm.run_uprogram(prog, planes, ("A", "B"),
                              tc.OPS["div"].out_bits(32), block_words=bw)
        assert torch.equal(got, ref), f"block_words={bw}"


@pytest.mark.parametrize("op,n", [("add", 8), ("if_else", 8), ("mul", 8),
                                  ("gt", 16)])
def test_vm_kernel_words_per_thread_and_ragged_tails(dev, op, n):
    """Word counts that make the wrapper give a thread 1, 2 and 4 words,
    none a multiple of words x threads; 1 word; and a word count large
    enough for 4 words per thread that only 1 divides."""
    spec = tc.OPS[op]
    prog = tc.get_uprogram(op, n)
    out_bits = spec.out_bits(n)
    cp, _ = vm.compiled(prog, spec.input_names, [n] * spec.n_inputs,
                        out_bits)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = vm.BLOCKS_PER_SM * n_sms
    for words, n_words in ((1, 1), (1, 45), (1, 4 * 32 * blocks + 5)) + \
            tuple((w, w * (32 * blocks - 1)) for w in (2, 4)):
        assert vm.launch_shape(cp.n_slots, n_words, 32, n_sms) == \
            (32, words)
        ins = _case(op, n, 32 * n_words - 17, seed=words)
        bps = [tc.pack_np(x, n, device=dev) for x in ins]
        planes = [bp.planes for bp in bps]
        ref = tc.execute(prog, dict(zip(spec.input_names, planes)), n_words,
                         out_bits=out_bits)
        got = vm.run_uprogram(prog, planes, spec.input_names, out_bits,
                              block_words=32)
        assert torch.equal(got, ref), f"{words} words per thread"
        for bp, x in zip(bps, ins):
            np.testing.assert_array_equal(tc.unpack_np(bp), x)


def test_simdram_wrappers_count_and_refuse(dev):
    x = torch.arange(100, dtype=torch.int32, device=dev)
    before = (tt.to_bitplanes.launches, tt.from_bitplanes.launches,
              vm.run_uprogram.launches)
    bp = tt.to_bitplanes(x, 8)
    tt.from_bitplanes(bp)
    vm.simdram_op("relu", bp)
    assert (tt.to_bitplanes.launches, tt.from_bitplanes.launches,
            vm.run_uprogram.launches) == tuple(b + 1 for b in before)
    with pytest.raises(TypeError):
        tt.to_bitplanes(x.to(torch.int16), 8)
    with pytest.raises(ValueError):
        tt.to_bitplanes(x[::2], 8)                        # non-contiguous
    with pytest.raises(TypeError):
        tt.from_bitplanes(tbp.BitPlaneArray(bp.planes.float(), 100))
    wide = tbp.BitPlaneArray(torch.zeros((8, 8), dtype=torch.int32,
                                         device=dev), 100)
    with pytest.raises(ValueError):
        tt.from_bitplanes(tbp.BitPlaneArray(wide.planes[:, ::2], 100))
    prog = tc.get_uprogram("add", 8)
    planes = [bp.planes, bp.planes]
    with pytest.raises(ValueError):                       # device mix
        vm.run_uprogram(prog, [bp.planes, bp.planes.cpu()], ("A", "B"), 8)
    with pytest.raises(TypeError):
        vm.run_uprogram(prog, [bp.planes, bp.planes.long()], ("A", "B"), 8)
    with pytest.raises(ValueError):                       # non-contiguous
        vm.run_uprogram(prog, [wide.planes[:, ::2], wide.planes[:, ::2]],
                        ("A", "B"), 8)
    with pytest.raises(ValueError):
        vm.run_uprogram(prog, planes, ("A",), 8)
    assert (tt.to_bitplanes.launches, tt.from_bitplanes.launches,
            vm.run_uprogram.launches) == tuple(b + 1 for b in before)


def test_cuda_path_never_runs_the_plain_versions(dev, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on CUDA tensors")
    monkeypatch.setattr(vm, "execute", refuse)
    monkeypatch.setattr(tt.ops, "pack", refuse)
    monkeypatch.setattr(tt.ops, "unpack", refuse)
    before = vm.run_uprogram.launches
    a, b = (tc.pack_np(_ints(16, 64, s), 16, device=dev) for s in (1, 2))
    out = tc.apply_op("max", a, b)
    assert vm.run_uprogram.launches == before + 1
    assert out.planes.is_cuda
    res = quickstart.main(device=dev)
    np.testing.assert_array_equal(res["xor_mask"],
                                  np.bitwise_xor(*res["inputs"][:2])
                                  & res["inputs"][2])
    assert vm.run_uprogram.launches == before + 3


# -- the bit-serial matmul -----------------------------------------------------
TOL_LOGITS = dict(atol=1e-4, rtol=1e-4)
#: the test grid, ragged shapes and the decode batches M = 1, 4
BSMM_SHAPES = [(128, 128, 128), (256, 128, 384), (5, 70, 33), (1, 128, 256),
               (4, 70, 33), (70, 130, 40), (4, 2048, 11008)]


def _bsmm_operands(M, K, N, n_bits, seed, device):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(np.int8))
    w = torch.from_numpy(rng.integers(0, 2, (n_bits, K, N)).astype(np.int8))
    return x.to(device), w.to(device)


@pytest.mark.parametrize("n_bits", [1, 2, 3, 4, 7, 8])
@pytest.mark.parametrize("shape", BSMM_SHAPES)
def test_bsmm_kernel_matches_plain(dev, shape, n_bits):
    x, w = _bsmm_operands(*shape, n_bits, seed=n_bits, device=dev)
    got = bs.bsmm_raw(x, w)
    assert got.dtype == torch.int32 and got.shape == (shape[0], shape[2])
    assert torch.equal(got, bs_ref.ref_bsmm_raw(x, w))
    assert torch.equal(got.cpu(), bs.bsmm_raw(x.cpu(), w.cpu()))
    wp = bs_ref.pack_planes(w)
    assert torch.equal(bs.bsmm_packed(x, wp), got)


@pytest.mark.parametrize("shape", [(128, 2048, 11008), (128, 11008, 2048)])
def test_bsmm_kernel_at_main_path_shapes(dev, shape):
    x, w = _bsmm_operands(*shape, 8, seed=1, device=dev)
    assert torch.equal(bs.bsmm_raw(x, w), bs_ref.ref_bsmm_raw(x, w))


#: (M, K, N, split): the w2 and w1/w3 shapes split K on an H100 SXM (132
#: SMs; the kernel itself splits for the card it runs on); a
#: grid of 8 x 64 output tiles does not; (64, 4000, 256) splits a K that is no
#: multiple of S x 32 (125 words in slices of whole 4-word chunks); the
#: decode batches M = 1 and 4 at both main-path shapes
SPLIT_SHAPES = [(128, 11008, 2048, True), (128, 2048, 11008, True),
                (1024, 1024, 4096, False), (64, 4000, 256, True),
                (1, 2048, 11008, True), (4, 11008, 2048, True),
                (1, 11008, 2048, True), (4, 2048, 11008, True)]


@pytest.mark.parametrize("M,K,N,split", SPLIT_SHAPES)
def test_bsmm_kernel_with_and_without_split_k(dev, M, K, N, split):
    assert (bs.split_k(M, N, K, 132)[0] > 1) == split
    x, w = _bsmm_operands(M, K, N, 8, seed=M + K, device=dev)
    wp = bs_ref.pack_planes(w)
    got = bs.bsmm_packed(x, wp)
    assert torch.equal(got, bs_ref.ref_bsmm_packed(x, wp))
    assert torch.equal(got, bs.bsmm_packed(x, wp))      # deterministic


def test_bsmm_kernel_on_unaligned_rows_and_empty_k(dev):
    """Rows that do not start on 4-byte boundaries (a view at an odd
    offset, odd K and N) are read byte by byte, rows on 4- but not 16-byte
    boundaries a word at a time; K = 0 gives zeros."""
    x, w = _bsmm_operands(9, 72, 40, 8, seed=5, device=dev)
    xv = x.reshape(-1)[3:3 + 8 * 72].reshape(8, 72)          # offset 3 B
    assert xv.is_contiguous() and xv.data_ptr() % 4 == 3
    assert torch.equal(bs.bsmm_raw(xv, w), bs_ref.ref_bsmm_raw(xv, w))
    x, w = _bsmm_operands(9, 2048, 40, 8, seed=7, device=dev)
    xv = x.reshape(-1)[4:4 + 8 * 2048].reshape(8, 2048)      # offset 4 B
    assert xv.data_ptr() % 16 == 4
    assert torch.equal(bs.bsmm_raw(xv, w), bs_ref.ref_bsmm_raw(xv, w))
    x, w = _bsmm_operands(3, 0, 5, 4, seed=6, device=dev)
    assert torch.equal(bs.bsmm_raw(x, w),
                       torch.zeros((3, 5), dtype=torch.int32, device=dev))
    x, w = _bsmm_operands(3, 9, 0, 4, seed=6, device=dev)
    assert bs.bsmm_raw(x, w).shape == (3, 0)


def test_bsmm_wrapper_counts_and_refuses(dev):
    x, w = _bsmm_operands(4, 64, 32, 8, seed=2, device=dev)
    wp = bs_ref.pack_planes(w)
    before = bs.bsmm_packed.launches
    bs.bsmm_packed(x, wp)
    assert bs.bsmm_packed.launches == before + 1
    bs.bsmm_raw(x, w)                       # packs, then one launch
    assert bs.bsmm_packed.launches == before + 2
    bad = [(x.float(), wp, TypeError), (x, wp.to(torch.int8), TypeError),
           (x, w, TypeError),                              # unpacked planes
           (x.t(), wp, ValueError),                        # non-contiguous
           (x, wp.transpose(1, 2), ValueError),
           (x, wp[:, :, :1].contiguous(), ValueError),     # word count
           (x[:, :32], wp, ValueError),                    # K mismatch
           (x, torch.zeros((9, 32, 2), dtype=torch.int32, device=dev),
            ValueError),                                   # 9 planes
           (x, wp[0], ValueError),                         # 2-D planes
           (x, wp.cpu(), ValueError)]                      # device mix
    for xx, ww, err in bad:
        with pytest.raises(err):
            bs.bsmm_packed(xx, ww)
    assert bs.bsmm_packed.launches == before + 2


def test_quantized_linear_and_qmm_on_card_match_cpu(dev):
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.standard_normal((200, 120)).astype(np.float32))
    ql = bs.QuantizedLinear.from_dense(w)
    qc = bs.QuantizedLinear.from_dense(w.to(dev))
    assert torch.equal(qc.w_planes.cpu(), ql.w_planes)
    assert torch.equal(qc.w_packed.cpu(), ql.w_packed)
    assert torch.equal(qc.w_scale.cpu(), ql.w_scale)
    for shape in ((1, 200), (2, 9, 200), (40, 200)):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        before = bs.bsmm_packed.launches
        y = qc(x.to(dev))
        assert bs.bsmm_packed.launches == before + 1
        torch.testing.assert_close(y.cpu(), ql(x), rtol=1e-6, atol=0)
    # qmm pads M to 17 and K, N to multiples of 8 for torch._int_mm, whose
    # weight goes in column-major (a row-major one is refused at M = 17-48
    # with K = 64); the row-major case is taken as well
    for M, K, N in ((1, 64, 32), (4, 13, 7), (17, 64, 32), (40, 64, 64),
                    (40, 200, 120), (128, 2048, 256)):
        x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
        wq = quantize_serving_params({"wo": torch.from_numpy(
            rng.standard_normal((K, N)).astype(np.float32))})["wo"]
        assert wq["q8"].stride(0) == 1
        want = qmm(x, wq)
        for q8 in (wq["q8"], wq["q8"].contiguous()):
            got = qmm(x.to(dev), {"q8": q8.to(dev), "s": wq["s"].to(dev)})
            torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=0)


def test_quantized_model_on_card_matches_cpu(dev):
    cfg = serve_config("qwen2.5-3b")
    params = quantize_serving_params(init_params(cfg, seed=0, device="cpu"))
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab, (2, 6)))
    want, wc = tm.prefill(cfg, params, {"tokens": toks}, 8)
    got, gc = tm.prefill(cfg, _to(params, dev), {"tokens": toks.to(dev)}, 8)
    torch.testing.assert_close(got.cpu(), want, **TOL_LOGITS)
    nxt = want[:, 0].argmax(-1)[:, None]
    want, _ = tm.decode_step(cfg, params, wc, nxt, 6)
    got, _ = tm.decode_step(cfg, _to(params, dev), gc, nxt.to(dev), 6)
    torch.testing.assert_close(got.cpu(), want, **TOL_LOGITS)
    want = tm.forward_train(cfg, params, {"tokens": toks})
    got = tm.forward_train(cfg, _to(params, dev), {"tokens": toks.to(dev)})
    torch.testing.assert_close(got.cpu(), want, **TOL_LOGITS)


def test_smoke_example_on_card_goes_through_the_kernel(dev, monkeypatch):
    cpu = simdram_quantized_lm.main(device="cpu", smoke=True)
    before = bs.bsmm_packed.launches
    res = simdram_quantized_lm.main(device=dev, smoke=True)
    assert bs.bsmm_packed.launches == before + 3 * res["cfg"].n_layers
    assert res["drift"] < simdram_quantized_lm.MAX_DRIFT
    for k in ("dense_bytes", "plane_bytes", "stored_plane_bytes"):
        assert res[k] == cpu[k]
    # the card draws other random weights than the CPU, so the perplexities
    # are not compared; the same forward through the plain version on the
    # card gives the same logits
    monkeypatch.setattr(bs, "bsmm_packed", bs_ref.ref_bsmm_packed)
    q_plain = simdram_quantized_lm.q_forward(res["cfg"], res["params"],
                                             res["qls"], res["tokens"])
    assert torch.equal(res["q_logits"], q_plain)


# -- training ----------------------------------------------------------------
def _train_batch(cfg, B, S_text, step, device):
    b = SyntheticLMData(cfg, B, cfg.n_vis_tokens + S_text, 0).batch_at(step)
    return {k: stage(v, device) for k, v in b.items()}


def _init_state(cfg, device):
    return _to(init_train_state(cfg, AdamWConfig(), seed=0, device="cpu"),
               device)


def test_train_step_on_card_matches_cpu(dev):
    import dataclasses
    cfg = dataclasses.replace(smoke_config("qwen3-0.6b"),
                              compute_dtype="float32")
    step = make_train_step(cfg, AdamWConfig())
    cpu = torch.device("cpu")
    states = {d: _init_state(cfg, d) for d in (cpu, dev)}
    for i in range(3):
        out = {d: step(states[d], _train_batch(cfg, 4, 32, i, d))
               for d in (cpu, dev)}
        states = {d: out[d][0] for d in out}
        for k in ("loss", "grad_norm"):
            torch.testing.assert_close(out[dev][1][k].cpu(), out[cpu][1][k],
                                       rtol=1e-5, atol=0)
    # params 1e-6 absolute (chip_smoke.py read 1.5e-8); each moment leaf
    # by the norm of its difference over its own norm, 1e-5 (Adam moves
    # an element by about its learning rate whatever its gradient, so
    # the params alone would miss wrong gradients; m and v do not)
    for a, b in zip(leaves(states[dev]["params"]),
                    leaves(states[cpu]["params"])):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-6)
    for name in ("m", "v"):
        for a, b in zip(leaves(states[dev]["opt"][name]),
                        leaves(states[cpu]["opt"][name])):
            assert float((a.cpu() - b).norm() / b.norm()) < 1e-5, name


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x7b",
                                  "internvl2-26b", "whisper-small"])
def test_train_step_is_sync_free(dev, arch):
    cfg = smoke_config(arch)
    assert cfg.compute_dtype == "bfloat16"
    step = make_train_step(cfg, AdamWConfig())
    state = _init_state(cfg, dev)
    state, m = step(state, _train_batch(cfg, 4, 16, 0, dev))
    batch = _train_batch(cfg, 4, 16, 1, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(float(m["loss"])) and int(state["opt"]["step"]) == 2


def test_whisper_prefill_decode_on_card_matches_cpu(dev):
    import dataclasses
    cfg = dataclasses.replace(smoke_config("whisper-small"),
                              compute_dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    b = SyntheticLMData(cfg, 2, 10, 0).batch_at(0)
    batch = {k: torch.from_numpy(v) for k, v in b.items() if k != "labels"}
    want, wc = tm.prefill(cfg, params, batch, 16)
    got, gc = tm.prefill(cfg, _to(params, dev), _to(batch, dev), 16)
    torch.testing.assert_close(got.cpu(), want, **TOL_LOGITS)
    nxt = want[:, 0].argmax(-1)[:, None]
    for pos in (10, 11):
        assert torch.equal(got[:, 0].argmax(-1).cpu(), nxt[:, 0])
        want, wc = tm.decode_step(cfg, params, wc, nxt, pos)
        got, gc = tm.decode_step(cfg, _to(params, dev), gc, nxt.to(dev), pos)
        torch.testing.assert_close(got.cpu(), want, **TOL_LOGITS)
        nxt = want[:, 0].argmax(-1)[:, None]


# -- serving on a device mesh --------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma3-12b",
                                  "recurrentgemma-9b", "mamba2-1.3b",
                                  "mixtral-8x7b", "qwen3-moe-235b-a22b"])
def test_mesh_1x1_on_card_equals_unmeshed(dev, arch):
    """The 1x1 mesh runs the same ops as no mesh (an MoE layer dispatches
    its tokens in one group there): the same tokens and kernel launches,
    no collective, and a horizon free of host syncs."""
    cfg = serve_config(arch)
    params = init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, 5).tolist() for _ in range(3)]
    mesh = make_host_mesh(1, 1, device="cuda")
    outs, launches = {}, {}
    for name, m in (("plain", None), ("mesh", mesh)):
        eng = PagedEngine(cfg, params, n_pages=33, page_size=8, max_seqs=2,
                          max_pages_per_seq=8, device=dev, mesh=m,
                          kv_layout="shard")
        sched = Scheduler(eng, prefill_chunk=4, decode_horizon=8)
        for p in prompts:
            sched.add_request(p, max_new=12)
        before = paged_attention.launches
        outs[name] = {r.rid: r.out for r in sched.run()}
        launches[name] = paged_attention.launches - before
    assert outs["mesh"] == outs["plain"]
    assert launches["mesh"] == launches["plain"]
    assert all(c["calls"] == 0 for c in mesh.collectives.values())
    for s in range(2):
        eng.alloc.reserve_span(eng.alloc.alloc(s), 4, 8)
    eng.prefill_chunk(torch.tensor([[3, 1, 4, 1], [5, 9, 2, 6]],
                                   dtype=torch.int32, device=dev),
                      torch.full((2,), 4, dtype=torch.int32, device=dev))
    toks = torch.tensor([7, 8], dtype=torch.int32, device=dev)
    mask = torch.ones(2, dtype=torch.bool, device=dev)
    steps = torch.full((2,), 8, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        block = eng.decode_many(toks, mask, steps, 8)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool((block.cpu() >= 0).all())
    assert all(c["calls"] == 0 for c in mesh.collectives.values())


def test_mesh_1x2_nccl_equals_unmeshed(dev, tmp_path):
    """Two ranks, one card each, on an nccl group: the qwen3 and mixtral
    smoke serves on a 1x2 mesh (``kv_layout`` shard; mixtral's experts
    dispatched by all-to-all) give the unmeshed tokens."""
    if torch.cuda.device_count() < 2:
        pytest.skip("a 1x2 mesh over nccl needs two cards; one H100 cannot "
                    "run it")
    import multiprocessing as mp

    import _torch_mesh_worker as W
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=W.run_nccl,
                         args=(r, 2, str(tmp_path / "rdzv"), str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0, 0], \
        [(tmp_path / f"rank{r}.err").read_text() for r in range(2)
         if (tmp_path / f"rank{r}.err").exists()]
    res = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
           for r in range(2)]
    for arch in ("qwen3-0.6b", "mixtral-8x7b"):
        assert res[0][arch]["mesh"] == res[0][arch]["plain"] \
            == res[1][arch]["mesh"], arch
    assert res[0]["qwen3-0.6b"]["all_to_all"] == 0
    assert res[0]["mixtral-8x7b"]["all_to_all"] > 0


def test_mesh_2x1_nccl_equals_unmeshed(dev, tmp_path):
    """Two ranks, one card each, on an nccl group: the qwen3 and mixtral
    smoke serves on a 2x1 ``data x model`` mesh (each rank its block of 4
    slots, the weights FSDP-cut over ``data``, the pools whole) give the
    unmeshed tokens on both ranks, by all-gathers over ``data`` alone."""
    if torch.cuda.device_count() < 2:
        pytest.skip("a 2x1 mesh over nccl needs two cards (one per data "
                    "rank); one H100 cannot run it")
    import multiprocessing as mp

    import _torch_mesh_data_worker as W
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=W.run_nccl,
                         args=(r, 2, str(tmp_path / "rdzv"), str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0, 0], \
        [(tmp_path / f"rank{r}.err").read_text() for r in range(2)
         if (tmp_path / f"rank{r}.err").exists()]
    res = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
           for r in range(2)]
    for arch in ("qwen3-0.6b", "mixtral-8x7b"):
        assert res[0][arch]["mesh"] == res[0][arch]["plain"] \
            == res[1][arch]["mesh"], arch
        calls = {k: c["calls"] for k, c in res[0][arch]["collectives"].items()
                 if c["calls"]}
        assert list(calls) == ["all_gather"], calls


# -- the legacy per-sequence path ----------------------------------------------
def test_paged_decode_attention_kernel_matches_plain(dev):
    """``paged_decode_attention`` on the card (the kernel) against the CPU
    (its plain twin) on a seeded state: rows [2, 0, 3] out of order, the
    first 4 of 8 columns; one launch per call."""
    rng = np.random.default_rng(3)
    shape = (2, 16, 4, 2, 16)
    arrays = (rng.standard_normal(shape).astype(np.float32),
              rng.standard_normal(shape).astype(np.float32),
              np.stack([rng.permutation(np.arange(1, 16))[:8]
                        for _ in range(4)]).astype(np.int32),
              np.asarray([5, 1, 13, 9], np.int32))
    q = torch.from_numpy(rng.standard_normal((3, 4, 16)).astype(np.float32))
    cpu = tk.PagedKVState(*(torch.from_numpy(a) for a in arrays))
    card = tk.PagedKVState(*(torch.from_numpy(a).to(dev) for a in arrays))
    for layer in (0, 1):
        want = ops.paged_decode_attention(q, cpu, layer, 2, [2, 0, 3], 4)
        before = paged_attention.launches
        got = ops.paged_decode_attention(q.to(dev), card, layer, 2,
                                         [2, 0, 3], 4)
        assert paged_attention.launches - before == 1
        torch.testing.assert_close(got.cpu(), want, **TOL)


def test_legacy_launcher_on_card(dev):
    """``--legacy --device cuda``: the engine launcher's tokens, and the
    server's attention is the kernel, one launch per layer per decode
    call."""
    base = ["--device", "cuda", "--requests", "3", "--max-new", "8"]
    before = paged_attention.launches
    legacy, srv, _ = launch_serve.main(base + ["--legacy"])
    launches = paged_attention.launches - before
    assert srv.decode_calls > 0
    assert launches == srv.cfg.n_layers * srv.decode_calls
    engine, _, _ = launch_serve.main(base)
    assert {r.rid: r.out for r in legacy} == {r.rid: r.out for r in engine}


# -- training on a 1x1 device mesh ---------------------------------------------
def test_train_step_on_1x1_mesh_bit_equal_unmeshed(dev, tmp_path,
                                                   monkeypatch):
    """The qwen3 smoke step on the card inside ``logical_axes`` of a 1x1
    mesh (``shard_state`` keeps the same tensors), through the SPMD step:
    losses, grad norms and state bit-equal to the unmeshed step over 3
    steps, no collective, one step under ``set_sync_debug_mode("error")``;
    a save through the mesh's shardings restores through them equal to
    the plain restore."""
    from repro_torch.checkpoint import restore_pytree, save_pytree
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.distributed.axes import logical_axes
    from repro_torch.distributed.sharding import (shard_state, shardings_of,
                                                  state_specs)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import step as step_mod
    from repro_torch.train.step import init_train_state, make_train_step
    from repro_torch.tree import leaves

    entered, spmd_train = [], step_mod.spmd_train
    monkeypatch.setattr(step_mod, "spmd_train",
                        lambda m, **kw: entered.append(m)
                        or spmd_train(m, **kw))
    cfg = smoke_config("qwen3-0.6b")
    opt = AdamWConfig(lr=1e-3, warmup_steps=1)
    mesh = make_host_mesh(1, 1, device="cuda")
    plain = init_train_state(cfg, opt, 0, dev)
    meshed = shard_state(cfg, init_train_state(cfg, opt, 0, dev), mesh, dev)
    step = make_train_step(cfg, opt)
    data = SyntheticLMData(cfg, 8, 32, seed=0)
    for i in range(3):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch_at(i).items()}
        plain, m_plain = step(plain, batch)
        torch.cuda.synchronize()
        if i == 2:
            torch.cuda.set_sync_debug_mode("error")
        try:
            with logical_axes(mesh):
                meshed, m_mesh = step(meshed, batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert all(torch.equal(m_plain[k], m_mesh[k]) for k in m_plain)
    assert entered == [mesh] * 3
    assert all(torch.equal(a, b) for a, b in zip(leaves(plain),
                                                 leaves(meshed)))
    assert all(c["calls"] == 0 for c in mesh.collectives.values())
    sh = shardings_of(state_specs(cfg, meshed, mesh), mesh)
    save_pytree(meshed, tmp_path, 3, shardings=sh)
    back = restore_pytree(meshed, tmp_path, 3, shardings=sh)
    want = restore_pytree(plain, tmp_path, 3)
    assert all(a.device == dev and torch.equal(a, b)
               for a, b in zip(leaves(back), leaves(want)))


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mamba2-1.3b"])
def test_train_stack_on_1x1_mesh_matches_unmeshed(dev, arch):
    """The MoE (mixtral) and Mamba-2 smoke steps on the card inside
    ``logical_axes`` of a 1x1 mesh against the unmeshed step, 2 steps at
    float32 compute from the same params and batches, no collective:
    Mamba-2 bit-equal; the MoE (one dispatch group through ``moe_ep``
    where the unmeshed step takes the local path's groups, at
    ``capacity_factor`` E/K, where neither drops a token) with loss and
    grad norm within 1e-5 relative, params within 4e-5 (Adam moves an
    element whose gradient is at rounding level by up to its rate either
    way, and the two steps' rates, 3e-6 and 6e-6, bound that at 2 x
    1.8e-5) and each m and v leaf within 1e-4 of its norm."""
    import dataclasses

    from repro_torch.distributed.axes import logical_axes
    from repro_torch.distributed.sharding import shard_state

    cfg = dataclasses.replace(smoke_config(arch), compute_dtype="float32")
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg,
                                  capacity_factor=cfg.n_experts / cfg.top_k)
    opt = AdamWConfig()
    mesh = make_host_mesh(1, 1, device="cuda")
    plain = init_train_state(cfg, opt, 0, dev)
    meshed = shard_state(cfg, init_train_state(cfg, opt, 0, dev), mesh, dev)
    step = make_train_step(cfg, opt)
    data = SyntheticLMData(cfg, 8, 32, seed=0)
    for i in range(2):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch_at(i).items()}
        plain, m_plain = step(plain, batch)
        with logical_axes(mesh, n_experts=cfg.n_experts):
            meshed, m_mesh = step(meshed, batch)
        if not cfg.n_experts:
            assert all(torch.equal(m_plain[k], m_mesh[k]) for k in m_plain)
        for k in ("loss", "grad_norm"):
            a, b = float(m_plain[k]), float(m_mesh[k])
            assert abs(a - b) <= 1e-5 * abs(a), (k, a, b)
    assert all(c["calls"] == 0 for c in mesh.collectives.values())
    if not cfg.n_experts:
        assert all(torch.equal(a, b) for a, b in zip(leaves(plain),
                                                     leaves(meshed)))
        return
    for a, b in zip(leaves(meshed["params"]), leaves(plain["params"])):
        assert float((a - b).abs().max()) <= 4e-5
    for k in ("m", "v"):
        for a, b in zip(leaves(meshed["opt"][k]), leaves(plain["opt"][k])):
            assert float((a - b).norm() / b.norm()) <= 1e-4
