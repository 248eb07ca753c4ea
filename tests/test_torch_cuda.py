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
    another order on the card).
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
from repro_torch.core.vbi.kvcache import make_ring_table
from repro_torch.kernels.simdram_vm import ops as vm
from repro_torch.launch.serve import serve_config
from repro_torch.models import model as tm
from repro_torch.models.model import init_params
from repro_torch.models.quantized import qmm, quantize_serving_params
from repro_torch.serve.engine import PagedEngine, batched_paged_attention
from repro_torch.serve.scheduler import Scheduler

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
