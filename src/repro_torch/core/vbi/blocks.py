"""The VBI memory API for serving — one allocator, property-driven placement
(counterpart of ``repro/core/vbi/blocks.py``).

:class:`VBIAllocator` is the only door to KV page lifecycle.  Each
request's KV is a :class:`VirtualBlock` with declared properties
(:class:`~repro_torch.core.vbi.address_space.VBProps`).  The allocator owns
the host page mirror (``free_pages``) and the MTL VB lifecycle; the device
owns translation and refcounts (``PagedServeState``).  It never reads
device state on the token path: the mirror is kept arithmetically.

This slice ports the lifecycle the closed-loop scheduler reaches — alloc,
free, page reservation (``reserve_pages``/``reserve``/``reserve_span``/
``commit``/``unreserve``) and placement.  The host swap tier, prefix
sharing and copy-on-write, block images, the tracer and the fault hooks
are queued in ROADMAP.md § A6; asking for them raises.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

from .address_space import VBProps
from .kvcache import admit_slot, release_slot
from .mtl import MTL, PhysicalMemory

DEFAULT_BLOCK_PROPS = (VBProps.KV_CACHE | VBProps.EVICTABLE
                       | VBProps.SWAPPABLE)


@dataclasses.dataclass
class VirtualBlock:
    """One request's KV stream: a slot-resident VB.

    ``reserved_pages`` is the block's charge against the allocator's host
    page mirror (budgeted ahead of device pops — the paper's early
    reservation); ``shared_pages`` counts pages in the block's span that
    the block does not own.  ``n_tokens`` mirrors the device ``seq_lens``
    entry."""
    bid: int
    slot: int
    props: VBProps
    n_tokens: int = 0
    reserved_pages: int = 0
    shared_pages: int = 0
    status: str = "resident"            # resident | freed
    vbid: int = -1                      # MTL VB id while resident
    # the device set the block's pages physically live on, stamped by
    # VBIAllocator.place_block (empty until placed)
    placement: tuple = ()

    @property
    def pinned(self) -> bool:
        return bool(self.props & VBProps.PINNED)

    @property
    def swappable(self) -> bool:
        return bool(self.props & VBProps.SWAPPABLE)

    @property
    def evictable(self) -> bool:
        return bool(self.props & VBProps.EVICTABLE)


class VBIAllocator:
    """The single interface through which KV memory is allocated and
    released.

    ``pool`` follows the engine's pool protocol: ``state``, ``n_pages``,
    ``page_size``, ``max_seqs``, ``max_pages``, ``placement`` and
    optionally ``has_full`` and ``kind_props``."""

    def __init__(self, pool, host_swap_pages: int = 0,
                 mtl: Optional[MTL] = None):
        if host_swap_pages:
            raise NotImplementedError(
                "the host swap tier is not ported yet (ROADMAP.md § A6); "
                "use host_swap_pages=0")
        self.pool = pool
        self.mtl = mtl or MTL(PhysicalMemory(1 << 12))
        self.placement = tuple(pool.placement)
        self.free_pages = pool.n_pages - 1          # host mirror (page 0 null)
        self.blocks: Dict[int, VirtualBlock] = {}   # resident, by slot
        self._next_bid = 0
        self.stats = {"allocs": 0, "frees": 0, "unreserved_pages": 0}

    def place_block(self, block: VirtualBlock,
                    placement: Optional[Sequence[str]] = None) -> None:
        """Stamp the device set the block's pages physically live on
        (``"cuda:0"``, ``"cpu:0"``): a declared property of the block."""
        block.placement = tuple(placement if placement is not None
                                else self.placement)
        if len(block.placement) > 1:
            block.props |= VBProps.SHARDED
        else:
            block.props &= ~VBProps.SHARDED

    # -- geometry / budget ---------------------------------------------------
    def pages_for(self, n_tokens: int) -> int:
        """Pool pages a span of ``n_tokens`` consumes; zero for a stack
        with no full-attention layer."""
        if not getattr(self.pool, "has_full", True):
            return 0
        return -(-n_tokens // self.pool.page_size)

    @property
    def device_free_pages(self) -> int:
        """Device free-stack depth.  Reads the device: never call on the
        token path."""
        return int(self.pool.state.free_top)

    @property
    def pages_in_use(self) -> int:
        """Device pages currently mapped by anyone.  Reads the device."""
        return self.pool.n_pages - 1 - self.device_free_pages

    # -- lifecycle -----------------------------------------------------------
    def alloc(self, slot: int,
              props: VBProps = DEFAULT_BLOCK_PROPS) -> VirtualBlock:
        """Enable a VB on ``slot``.  Allocates NOTHING — backing pages
        arrive on first dirty writeback (device ``reserve_positions``)."""
        if slot in self.blocks:
            raise ValueError(f"slot {slot} is busy")
        props |= getattr(self.pool, "kind_props", VBProps.NONE)
        blk = VirtualBlock(self._next_bid, slot, props)
        self._next_bid += 1
        blk.vbid = self.mtl.enable_vb(0, props)
        admit_slot(self.pool.state, slot)
        self.blocks[slot] = blk
        self.stats["allocs"] += 1
        self.place_block(blk)
        return blk

    def free(self, block: VirtualBlock) -> None:
        """Release the block: its device pages return to the free stack and
        its reservation to the mirror.  Double-free is a no-op."""
        if block.status == "freed":
            return
        release_slot(self.pool.state, block.slot)
        self.mtl.disable_vb(0, block.vbid)
        self.free_pages += block.reserved_pages
        block.reserved_pages = 0
        block.shared_pages = 0
        block.vbid = -1
        block.status = "freed"
        del self.blocks[block.slot]
        self.stats["frees"] += 1

    # -- reservation (host mirror of the device free stack; zero syncs) ------
    def reserve_pages(self, block: VirtualBlock, n_pages: int) -> None:
        """Grow the block's reservation to at least ``n_pages`` — budget
        charged before any device pop, so concurrent prefills can never
        oversubscribe the free stack."""
        if n_pages > block.reserved_pages:
            grow = n_pages - block.reserved_pages
            if grow > self.free_pages:
                raise RuntimeError(
                    f"KV pool oversubscribed: block {block.bid} needs "
                    f"{grow} more pages, {self.free_pages} free")
            self.free_pages -= grow
            block.reserved_pages = n_pages

    def reserve(self, block: VirtualBlock, n_tokens: int) -> None:
        """Token-level reservation: cover ``n_tokens`` minus pages in the
        span the block does not own."""
        self.reserve_pages(
            block, self.pages_for(n_tokens) - block.shared_pages)

    def reserve_span(self, block: VirtualBlock, n_tokens: int,
                     horizon: int) -> None:
        """Early reservation of a K-token decode span: charge the worst case
        of ``horizon`` more tokens past ``n_tokens`` before the fused
        horizon dispatches, so the device free stack cannot underflow
        mid-horizon."""
        self.reserve(block, n_tokens + horizon)

    def commit(self, block: VirtualBlock, n_tokens: int) -> None:
        """Record that ``n_tokens`` are now written on device."""
        block.n_tokens = n_tokens

    def unreserve(self, block: VirtualBlock, n_tokens: int) -> None:
        """Horizon-boundary reconciliation: shrink the reservation to
        exactly cover ``n_tokens`` (a slot that stopped early on device
        popped fewer pages than its worst-case span)."""
        keep = max(0, self.pages_for(n_tokens) - block.shared_pages)
        if keep < block.reserved_pages:
            returned = block.reserved_pages - keep
            self.free_pages += returned
            self.stats["unreserved_pages"] += returned
            block.reserved_pages = keep
