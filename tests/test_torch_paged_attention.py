"""The paged-attention kernel's plain twins on the CPU against the
reference's Pallas kernel, run in interpret mode as
``tests/test_kernels.py`` runs it.  The hand-written CUDA kernel itself is
held against the same twins on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); here a numpy model of how it divides a sequence's
tokens (tiles over warps, blocks over the sequence, partial softmax states
merged in a fixed order) is held against the same references.  Tolerance:
1e-5 absolute and relative (float32, different summation order)."""
import functools
import itertools
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.kernel import paged_attn_one_seq
from repro_torch.kernels.paged_attention import (build_kernel, ops,
                                                 paged_attention,
                                                 ref_paged_attention)
from repro_torch.serve.engine import batched_paged_attention

TOL = dict(atol=1e-5, rtol=1e-5)


def _case(seq_len, n_kv, g, seed):
    n_pages, ps, dh = 12, 4, 8
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((n_pages, ps, n_kv, dh)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, n_kv, dh)).astype(np.float32)
    pt = rng.choice(np.arange(1, n_pages), size=8,
                    replace=False).astype(np.int32)
    q = rng.standard_normal((n_kv, g, dh)).astype(np.float32)
    ln = np.array([seq_len], np.int32)
    return pt, ln, q, kp, vp


@pytest.mark.parametrize("seq_len", [0, 1, 5, 16, 31])
@pytest.mark.parametrize("gqa", [(2, 3), (1, 4), (4, 1)])
def test_plain_twins_match_pallas_kernel(seq_len, gqa):
    n_kv, g = gqa
    pt, ln, q, kp, vp = _case(seq_len, n_kv, g, seq_len * 10 + n_kv)
    ref = np.asarray(paged_attn_one_seq(*[jnp.asarray(x)
                                          for x in (pt, ln, q, kp, vp)]))
    t = [torch.from_numpy(x) for x in (pt, ln, q, kp, vp)]
    one = ref_paged_attention(*t)
    np.testing.assert_allclose(one.numpy(), ref, **TOL)
    # the batched forms: the wrapper (its CPU branch) and the engine twin,
    # with the row handed over wider than max_pages
    wide = torch.cat([t[0], torch.zeros(3, dtype=torch.int32)])[None]
    for fn in (paged_attention, batched_paged_attention):
        out = fn(t[2][None], t[3], t[4], wide, t[1], 8)
        np.testing.assert_allclose(out[0].numpy(), ref, **TOL)
    if seq_len == 0:
        assert not one.any()


def test_plain_twins_ignore_garbage_pages():
    """Entries beyond seq_len (incl. null page 0) must not affect output."""
    n_pages, ps, n_kv, g, dh = 6, 2, 1, 2, 4
    rng = np.random.default_rng(0)
    kp = torch.from_numpy(rng.standard_normal(
        (n_pages, ps, n_kv, dh)).astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal(
        (n_pages, ps, n_kv, dh)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((n_kv, g, dh)).astype(np.float32))
    pt1 = torch.tensor([3, 1, 0, 0], dtype=torch.int32)
    pt2 = torch.tensor([3, 1, 5, 2], dtype=torch.int32)
    ln = torch.tensor([3], dtype=torch.int32)
    torch.testing.assert_close(ref_paged_attention(pt1, ln, q, kp, vp),
                               ref_paged_attention(pt2, ln, q, kp, vp),
                               atol=1e-6, rtol=0)
    for fn in (paged_attention, batched_paged_attention):
        torch.testing.assert_close(
            fn(q[None], kp, vp, pt1[None], ln, 4),
            fn(q[None], kp, vp, pt2[None], ln, 4), atol=1e-6, rtol=0)


def test_wrapper_refuses_other_devices():
    q = torch.zeros((1, 1, 1, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        paged_attention(q, q, q, q, q, 1)


def test_build_needs_the_cuda_toolkit():
    if shutil.which("nvcc") is not None:
        pytest.skip("nvcc is installed here")
    with pytest.raises(RuntimeError, match="nvcc"):
        build_kernel()


# -- numpy model of the kernel's partition (csrc/paged_attention.cu) --------
# Change it together with the kernel: the tile size, the on-device block
# count, the pairs of tiles handed to warps and the merge order.
NEG = np.float32(-1e30)


def _np_partition(seq_len, max_tok, blocks, T, chunk):
    """(tokens, blocks that work, tiles per block) of one (kv head, slot),
    as the kernel works them out on the device from seq_len."""
    n_tok = min(max(seq_len, 0), max_tok)
    tiles = -(-n_tok // T)
    nb = min(blocks, max(1, n_tok // chunk))
    tpb = -(-tiles // nb) if tiles else 0
    nb = -(-tiles // tpb) if tiles else 1
    return n_tok, nb, tpb


def _np_warp_tiles(t_begin, n_blk, warps):
    """Each warp's tiles in the order it folds them: pairs, warp w taking
    2w, 2w + 1, 2w + 2W, 2w + 2W + 1, ... of the block's tiles."""
    active = max(1, min(warps, -(-n_blk // 2)))
    return [[t_begin + t for t in range(n_blk)
             if (t - 2 * w) % (2 * warps) in (0, 1) and t >= 2 * w]
            for w in range(active)]


def _np_merge(parts):
    """Merge (m, l, acc) states in list order: the max of the m's first,
    then the weighted sums (the kernel's ``merge``)."""
    m_all = np.full_like(parts[0][0], NEG)
    for m, _, _ in parts:
        m_all = np.maximum(m_all, m)
    l_all = np.zeros_like(parts[0][1])
    acc_all = np.zeros_like(parts[0][2])
    for m, l, acc in parts:
        wgt = np.exp(m - m_all)
        l_all += l * wgt
        acc_all += acc * wgt[..., None]
    return m_all, l_all, acc_all


def _np_kernel(pt, seq_len, q, kp, vp, *, blocks, warps, chunk=ops.CHUNK):
    """out [n_kv, g, d] of one slot computed the way the kernel divides the
    work; also returns the tokens read (each exactly once) and the blocks
    that did work."""
    ps, d = kp.shape[1], kp.shape[3]
    T = ops.tile_tokens(d)
    n_tok, nb, tpb = _np_partition(seq_len, len(pt) * ps, blocks, T, chunk)
    read = []
    parts = []
    for pb in range(nb):
        t_begin = pb * tpb
        n_blk = min(-(-n_tok // T), t_begin + tpb) - t_begin
        states = []
        for tiles in _np_warp_tiles(t_begin, n_blk, warps):
            m = np.full(q.shape[:2], NEG, np.float32)
            l = np.zeros(q.shape[:2], np.float32)
            acc = np.zeros(q.shape, np.float32)
            for t in tiles:
                toks = [p for p in range(t * T, t * T + T) if p < n_tok]
                read += toks
                pages = pt[[p // ps for p in toks]]
                k = kp[pages, [p % ps for p in toks]]        # [n, n_kv, d]
                v = vp[pages, [p % ps for p in toks]]
                sc = np.einsum("hgd,nhd->hgn", q, k)
                m_new = np.maximum(m, sc.max(-1))
                alpha = np.exp(m - m_new)
                p_ = np.exp(sc - m_new[..., None])
                l = l * alpha + p_.sum(-1)
                acc = acc * alpha[..., None] + np.einsum("hgn,nhd->hgd",
                                                         p_, v)
                m = m_new
            states.append((m, l, acc))
        parts.append(_np_merge(states) if len(states) > 1 else states[0])
    _, l, acc = _np_merge(parts) if nb > 1 else parts[0]
    return acc / np.maximum(l, 1e-30)[..., None], read, nb


#: ps = 3 makes tiles of 4 straddle pages; 70 pages = 210 tokens, three
#: chunks of 64, so up to 3 planned blocks get work (8 with a one-tile
#: chunk)
_PS, _PAGES = 3, 70
_LENS = sorted({0, 1, _PS - 1, _PS, _PS + 1, 4, 5, 7, 8, 63, 64, 65, 128,
                129, 192, 193, _PAGES * _PS - 1, _PAGES * _PS,
                _PAGES * _PS + 7})


@functools.lru_cache(maxsize=None)
def _model_case(seq_len):
    n_pages, n_kv, g, dh = _PAGES + 5, 2, 3, 8
    rng = np.random.default_rng(1000 + seq_len)
    kp = rng.standard_normal((n_pages, _PS, n_kv, dh)).astype(np.float32)
    vp = rng.standard_normal((n_pages, _PS, n_kv, dh)).astype(np.float32)
    pt = rng.permutation(np.arange(1, n_pages))[:_PAGES].astype(np.int32)
    # entries past seq_len point anywhere, out of range included: the
    # model (as the kernel) never dereferences them
    n_used = -(-min(seq_len, _PAGES * _PS) // _PS)
    pt[n_used:] = rng.choice([-1, n_pages + 1000], _PAGES - n_used)
    q = (rng.standard_normal((n_kv, g, dh)) / np.sqrt(dh)).astype(np.float32)
    ln = np.array([seq_len], np.int32)
    safe = np.where(np.arange(_PAGES) < n_used, pt, 0).astype(np.int32)
    ref = np.asarray(paged_attn_one_seq(*[jnp.asarray(x) for x in
                                          (safe, ln, q, kp, vp)]))
    return pt, safe, ln, q, kp, vp, ref


@pytest.mark.parametrize("blocks", [1, 2, 3, 8])
@pytest.mark.parametrize("seq_len", _LENS)
def test_partition_model_matches_pallas_and_twins(seq_len, blocks):
    pt, safe, ln, q, kp, vp, ref = _model_case(seq_len)
    n_tok = min(seq_len, _PAGES * _PS)
    # the planned chunk, and one tile (what a forced ``blocks`` uses)
    for warps, chunk in itertools.product((1, 3, ops.MAX_WARPS),
                                          (ops.CHUNK, ops.tile_tokens(8))):
        out, read, nb = _np_kernel(pt, seq_len, q, kp, vp, blocks=blocks,
                                   warps=warps, chunk=chunk)
        np.testing.assert_allclose(out, ref, **TOL)
        assert sorted(read) == list(range(n_tok))    # each token once
        assert nb == ops.blocks_used(seq_len, blocks, _PAGES, _PS, 8, chunk)
        assert nb <= blocks and (nb == 1 or n_tok >= nb * chunk)
    if seq_len == 0:
        assert not out.any()
    t = [torch.from_numpy(x) for x in (safe, ln, q, kp, vp)]
    np.testing.assert_allclose(ref_paged_attention(*t).numpy(), ref, **TOL)
    twin = batched_paged_attention(t[2][None], t[3], t[4], t[0][None], t[1],
                                   _PAGES)
    np.testing.assert_allclose(twin[0].numpy(), ref, **TOL)


@pytest.mark.parametrize("d", [8, 128, 132, 256])
def test_partition_model_tiles_and_blocks(d):
    """Block ranges cover the tiles in order, each block at least one
    chunk but the last (at most nb - 1 tiles short of one), each warp
    taking its block's tiles in pairs, and block 0's warp w always
    starting at tile 2w (so its page rows can be read before seq_len
    arrives)."""
    T = ops.tile_tokens(d)
    assert T * (1 if d <= 128 else 2) == 4
    for seq_len in range(0, 600, 7):
        for blocks in (1, 2, 3, 8):
            n_tok, nb, tpb = _np_partition(seq_len, 512, blocks, T,
                                           ops.CHUNK)
            tiles = -(-n_tok // T)
            spans = [(pb * tpb, min(tiles, pb * tpb + tpb))
                     for pb in range(nb)]
            assert spans[0][0] == 0 and spans[-1][1] == tiles
            assert all(a < b for a, b in spans) or tiles == 0
            assert all(b == a2 for (_, b), (a2, _) in zip(spans, spans[1:]))
            assert all((b - a) * T >= ops.CHUNK for a, b in spans[:-1])
            assert n_tok - spans[-1][0] * T >= min(
                n_tok, ops.CHUNK - (nb - 1) * T)
            for warps in (1, 5, 16):
                got = _np_warp_tiles(spans[0][0], spans[0][1], warps)
                assert [w[0] for w in got if w] == list(
                    range(0, min(2 * warps, spans[0][1]), 2))
                assert sorted(sum(got, [])) == list(range(*spans[0]))


def test_split_plan_invariants():
    for S, n_kv, max_pages, ps, n_sm in [
            (1, 1, 1, 1, 132), (4, 8, 32, 8, 132), (4, 8, 256, 8, 132),
            (1, 1, 65536, 16, 132), (64, 8, 8, 8, 132), (3, 5, 7, 3, 114),
            (65535, 1, 4, 16, 132), (2, 1, 10 ** 6, 1, 132)]:
        P = ops.split_plan(S, n_kv, max_pages, ps, n_sm)
        assert 1 <= P <= ops.MAX_GRID_YZ
        # one wave of BLOCKS_PER_SM blocks per SM at most
        assert S * n_kv * P <= max(ops.BLOCKS_PER_SM * n_sm, S * n_kv)
        if max_pages * ps <= ops.CHUNK:
            assert P == 1
        assert P <= -(-max_pages * ps // ops.CHUNK)
        for d in (8, 128, 256):
            assert 1 <= ops.default_warps(max_pages, ps, d, P) <= 16
    # the serve's shape (4 slots, 8 kv heads, 32 pages of 8, d = 128, on
    # 132 SMs): 4 blocks of 8 warps per (kv head, slot); at its decode
    # lengths (up to 20 tokens) only block 0 works, 3 warps of it
    assert ops.split_plan(4, 8, 32, 8, 132) == 4
    assert ops.default_warps(32, 8, 128, 4) == 8
    assert [ops.blocks_used(n, 4, 32, 8, 128)
            for n in (0, 19, 127, 128, 255, 256)] == [1, 1, 1, 2, 3, 4]
    # 2048 tokens: 8 blocks of 256 tokens, 8 warps of 8 tiles each
    assert ops.split_plan(4, 8, 256, 8, 132) == 8
    assert ops.default_warps(256, 8, 128, 8) == 8
    assert ops.blocks_used(2048, 8, 256, 8, 128) == 8
    assert ops.rows_per_block(2, 128) == (2, 1)
    for g in range(1, 17):
        for d in (64, 128, 192, 256):
            G, groups = ops.rows_per_block(g, d)
            assert G * groups >= g > G * (groups - 1)
            assert G in ((1, 2, 4) if d <= 128 else (1, 2))


def _shared_tables(seq_len, seed=3):
    """A pool and a page table whose rows share physical pages, as the
    prefix cache leaves them — rows 0 and 1 name the same pages, row 2 the
    same pages but a COW copy of the last one, whose tail past the
    matched 4 tokens holds the row's own K/V — beside a pool and table of
    private copies of each row's pages.  (pt, kp, vp, private pt, private
    kp, private vp, q, seq_lens)."""
    ps, n_kv, g, dh, S = 8, 2, 2, 8, 3
    n_used = -(-seq_len // ps)
    width = n_used + 2                      # a row wider than it is used
    rng = np.random.default_rng(seed)
    n_pages = 2 + n_used + 3
    kp = rng.standard_normal((n_pages, ps, n_kv, dh)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, n_kv, dh)).astype(np.float32)
    base = rng.permutation(np.arange(1, n_pages - 1))[:n_used]
    cow = n_pages - 1
    kp[cow, :4], vp[cow, :4] = kp[base[-1], :4], vp[base[-1], :4]
    pt = np.zeros((S, width), np.int32)
    pt[:, :n_used] = base
    pt[2, n_used - 1] = cow
    # the private pool: every (row, column) its own copy
    n_priv = 1 + S * n_used
    pkp = np.zeros((n_priv, ps, n_kv, dh), np.float32)
    pvp = np.zeros((n_priv, ps, n_kv, dh), np.float32)
    ppt = np.zeros((S, width), np.int32)
    for r in range(S):
        for c in range(n_used):
            ppt[r, c] = 1 + r * n_used + c
            pkp[ppt[r, c]], pvp[ppt[r, c]] = kp[pt[r, c]], vp[pt[r, c]]
    q = (rng.standard_normal((S, n_kv, g, dh)) / np.sqrt(dh)).astype(
        np.float32)
    q[1] = q[0]
    ln = np.full((S,), seq_len, np.int32)
    return pt, kp, vp, ppt, pkp, pvp, q, ln


@pytest.mark.parametrize("seq_len", [19, 256])
def test_shared_page_tables_match_private_copies(seq_len):
    """Rows that share physical pages (and one holding a COW copy) give
    what a table of private copies gives: through both plain twins, and
    through the numpy model of the kernel's partition with the planned
    and forced page splits."""
    pt, kp, vp, ppt, pkp, pvp, q, ln = _shared_tables(seq_len)
    width = pt.shape[1]
    shared = [torch.from_numpy(x) for x in (q, kp, vp, pt, ln)]
    private = [torch.from_numpy(x) for x in (q, pkp, pvp, ppt, ln)]
    for fn in (paged_attention, batched_paged_attention):
        got = fn(*shared, width).numpy()
        want = fn(*private, width).numpy()
        np.testing.assert_array_equal(got[1], got[0])
        np.testing.assert_allclose(got, want, **TOL)
    for r in range(3):
        one = ref_paged_attention(*[torch.from_numpy(x) for x in (
            pt[r], ln[r:r + 1], q[r], kp, vp)]).numpy()
        np.testing.assert_allclose(one, want[r], **TOL)
        for blocks, warps in itertools.product((1, 2, 3, 8),
                                               (1, 3, ops.MAX_WARPS)):
            out, read, _ = _np_kernel(pt[r], seq_len, q[r], kp, vp,
                                      blocks=blocks, warps=warps)
            priv, _, _ = _np_kernel(ppt[r], seq_len, q[r], pkp, pvp,
                                    blocks=blocks, warps=warps)
            np.testing.assert_array_equal(out, priv)
            np.testing.assert_allclose(out, want[r], **TOL)
            assert sorted(read) == list(range(seq_len))
