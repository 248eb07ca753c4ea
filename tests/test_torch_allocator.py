"""``repro_torch/core/vbi/blocks.py::VBIAllocator`` against the reference
allocator over the same pool geometry: the same lifecycle calls leave the
same host mirror, block fields and device free stack (exact integers)."""
import numpy as np
import pytest
import torch

from repro.core.vbi.blocks import PagePool, VBIAllocator as JAlloc
from repro_torch.core.vbi.address_space import VBProps
from repro_torch.core.vbi.blocks import DEFAULT_BLOCK_PROPS, VBIAllocator
from repro_torch.core.vbi.kvcache import init_serve_state


class _Pool:
    """The engine's pool protocol without a model."""

    def __init__(self, n_pages, page_size, max_seqs, max_pages):
        self.n_pages, self.page_size = n_pages, page_size
        self.max_seqs, self.max_pages = max_seqs, max_pages
        self.placement = ("cpu:0",)
        self.state = init_serve_state(
            n_layers=1, n_pages=n_pages, page_size=page_size, n_kv=1,
            head_dim=2, max_seqs=max_seqs, max_pages_per_seq=max_pages,
            device="cpu")


def _pair():
    geo = dict(n_pages=17, page_size=4, max_seqs=3)
    jal = JAlloc(PagePool(n_layers=1, n_kv=1, head_dim=2,
                          max_pages_per_seq=8, **geo))
    tal = VBIAllocator(_Pool(max_pages=8, **geo))
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
    rng = np.random.default_rng(seed)
    jal, tal = _pair()
    live = {}
    for _ in range(30):
        op = rng.choice(["alloc", "reserve", "span", "unreserve", "free"])
        if op == "alloc" and len(live) < 3:
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
    assert tal.stats["allocs"] == jal.stats["allocs"]
    assert tal.stats["frees"] == jal.stats["frees"]


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
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        VBIAllocator(tal.pool, host_swap_pages=4)
    assert not hasattr(tal, "swap_out") and not hasattr(tal, "map_shared")
    assert torch.equal(tal.pool.state.slot_active,
                       torch.tensor([True, False, False]))
