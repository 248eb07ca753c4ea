"""``repro_torch/core/vbi/blocks.py::VBIAllocator`` against the reference
allocator over the same pool geometry: the same lifecycle calls leave the
same host mirror, block fields and device free stack (exact integers)."""
import numpy as np
import pytest
import torch

from _torch_parity import Pool, one_torch_thread
from repro.core.vbi.blocks import PagePool, VBIAllocator as JAlloc
from repro_torch.core.vbi.address_space import VBProps
from repro_torch.core.vbi.blocks import (DEFAULT_BLOCK_PROPS, HostSwapTier,
                                         VBIAllocator)


def _pair(swap=0):
    geo = dict(n_pages=17, page_size=4, max_seqs=3)
    jal = JAlloc(PagePool(n_layers=1, n_kv=1, head_dim=2,
                          max_pages_per_seq=8, **geo), host_swap_pages=swap)
    tal = VBIAllocator(Pool(max_pages=8, **geo), host_swap_pages=swap)
    return jal, tal


def _same(jal, tal, jb, tb):
    assert tal.free_pages == jal.free_pages
    assert tal.device_free_pages == jal.device_free_pages
    assert tal.pages_in_use == jal.pages_in_use
    for f in ("slot", "n_tokens", "reserved_pages", "shared_pages",
              "status", "vbid"):
        assert getattr(tb, f) == getattr(jb, f), f
    assert int(tb.props) == int(jb.props)


@pytest.mark.parametrize("seed", range(3))
def test_lifecycle_matches_reference(seed):
    """Random alloc / reserve / span + commit / unreserve / free, and swap
    out to and back in from a host tier of 8 pages (into any free slot),
    on both allocators: the same mirror, block fields, device page table,
    free stack and refcounts after every op."""
    rng = np.random.default_rng(seed)
    jal, tal = _pair(swap=8)
    live, swapped = {}, []
    for _ in range(30):
        op = rng.choice(["alloc", "reserve", "span", "unreserve", "free",
                         "swap_out", "swap_in"])
        if op == "swap_in" and swapped and len(live) < 3:
            jb, tb = swapped[int(rng.integers(len(swapped)))]
            s = int(rng.choice([x for x in range(3) if x not in live]))
            if jal.pages_for(jb.n_tokens) <= jal.free_pages:
                jal.swap_in(jb, s)
                tal.swap_in(tb, s)
                swapped.remove((jb, tb))
                live[s] = (jb, tb)
                _same(jal, tal, jb, tb)
        elif op == "swap_out" and live:
            s = int(rng.choice(sorted(live)))
            jb, tb = live[s]
            ok = jal.swap_out(jb)
            assert tal.swap_out(tb) == ok
            if ok:
                swapped.append(live.pop(s))
            _same(jal, tal, jb, tb)
            assert tal.swap.used_pages == jal.swap.used_pages
        elif op == "alloc" and len(live) < 3:
            s = int(rng.choice([x for x in range(3) if x not in live]))
            live[s] = (jal.alloc(s), tal.alloc(s))
        elif live:
            s = int(rng.choice(sorted(live)))
            jb, tb = live[s]
            n = int(rng.integers(0, 12))
            if op == "reserve" and jal.pages_for(n) - jb.reserved_pages \
                    <= jal.free_pages:
                jal.reserve(jb, n)
                tal.reserve(tb, n)
            elif op == "span" and jal.pages_for(n + 3) - jb.reserved_pages \
                    <= jal.free_pages:
                jal.reserve_span(jb, n, 3)
                tal.reserve_span(tb, n, 3)
                jal.commit(jb, n)
                tal.commit(tb, n)
            elif op == "unreserve":
                jal.unreserve(jb, n)
                tal.unreserve(tb, n)
            elif op == "free":
                jal.free(jb)
                tal.free(tb)
                tal.free(tb)                     # double free: a no-op
                del live[s]
            _same(jal, tal, jb, tb)
    for f in ("page_table", "seq_lens", "free_stack", "page_refcounts"):
        np.testing.assert_array_equal(getattr(tal.pool.state, f).numpy(),
                                      np.asarray(getattr(jal.pool.state, f)))
    assert tal.stats == jal.stats


def test_blocks_are_placed_and_typed():
    _, tal = _pair()
    blk = tal.alloc(1, props=DEFAULT_BLOCK_PROPS | VBProps.PINNED)
    assert blk.placement == ("cpu:0",) and blk.pinned and blk.swappable
    assert not blk.props & VBProps.SHARDED
    tal.place_block(blk, ("cuda:0", "cuda:1"))
    assert blk.props & VBProps.SHARDED
    with pytest.raises(ValueError, match="busy"):
        tal.alloc(1)


def test_oversubscription_and_unported_parts_raise():
    _, tal = _pair()
    blk = tal.alloc(0)
    with pytest.raises(RuntimeError, match="oversubscribed"):
        tal.reserve_pages(blk, 17)
    # the host swap tier is built on request; without one, swap_out
    # declines and the caller discards
    assert tal.swap is None and not tal.swap_out(blk)
    swapping = VBIAllocator(tal.pool, host_swap_pages=4)
    assert swapping.swap.capacity_pages == 4 and swapping.swap.used_pages == 0
    assert hasattr(tal, "swap_in") and hasattr(tal, "map_shared")
    with pytest.raises(ValueError, match="capacity"):
        HostSwapTier(0)
    assert torch.equal(tal.pool.state.slot_active,
                       torch.tensor([True, False, False]))
