"""The VBI memory API for serving — one allocator, property-driven placement
(counterpart of ``repro/core/vbi/blocks.py``).

:class:`VBIAllocator` is the only door to KV page lifecycle.  Each
request's KV is a :class:`VirtualBlock` with declared properties
(:class:`~repro_torch.core.vbi.address_space.VBProps`):

  * ``SHARED_RO`` / ``COW`` — the block maps prefix-cache pages read-only /
    holds a copy-on-write clone (``map_shared`` / ``cow_break``);
  * ``RING`` / ``RECURRENT`` — stamped from the pool's layer kinds; such
    blocks are ineligible for sharing;
  * ``PINNED`` — never chosen as a preemption victim.

The allocator owns the host page mirror (``free_pages``), the custody
ledger between slots and the prefix cache (``retain``/``release``), and
the MTL VB lifecycle; the device owns translation and refcounts
(``PagedServeState``).  It never reads device state on the token path:
the mirror is kept arithmetically (``page_row`` and the two
``*_pages`` properties read the device, on the control path only).

Ported: alloc, free, page reservation (``reserve_pages``/``reserve``/
``reserve_span``/``commit``/``unreserve``), placement, and sharing
(``map_shared``, ``cow_break``, ``page_row``, ``retain``, ``release``).
The host swap tier, block images, the tracer and the fault hooks are
queued in ROADMAP.md § A6; asking for the swap tier raises.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ...device import stage
from .address_space import VBProps
from .kvcache import (admit_slot, clone_page_cow, map_prefix, release_pages,
                      release_slot, retain_pages)
from .mtl import MTL, PhysicalMemory

DEFAULT_BLOCK_PROPS = (VBProps.KV_CACHE | VBProps.EVICTABLE
                       | VBProps.SWAPPABLE)


@dataclasses.dataclass
class VirtualBlock:
    """One request's KV stream: a slot-resident VB.

    ``reserved_pages`` is the block's charge against the allocator's host
    page mirror (budgeted ahead of device pops — the paper's early
    reservation); ``shared_pages`` counts pages in the block's span that
    the block does NOT own (mapped read-only from the prefix cache, or
    whose custody moved to it).  ``n_tokens`` mirrors the device
    ``seq_lens`` entry."""
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
        self.stats = {"allocs": 0, "frees": 0, "prefix_maps": 0,
                      "prefix_pages_mapped": 0, "cow_clones": 0,
                      "cached_page_retains": 0, "cached_page_releases": 0,
                      "unreserved_pages": 0}

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

    def _padded_ids(self, pages: Sequence[int]) -> torch.Tensor:
        """``pages`` as a fresh int32 device row of ``max_pages`` entries
        (zeros past the list), staged without waiting on the device."""
        if len(pages) > self.pool.max_pages:
            raise ValueError(f"{len(pages)} page ids > a row of "
                             f"{self.pool.max_pages}")
        ids = np.zeros((self.pool.max_pages,), np.int32)
        ids[:len(pages)] = pages
        return stage(ids, self.pool.state.device)

    # -- lifecycle -----------------------------------------------------------
    def alloc(self, slot: int,
              props: VBProps = DEFAULT_BLOCK_PROPS) -> VirtualBlock:
        """Enable a VB on ``slot``.  Allocates NOTHING — backing pages
        arrive on first dirty writeback (device ``reserve_positions``) or
        via ``map_shared``."""
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
        """Release the block: device pages it owns return to the free stack
        (shared and cache-custody pages survive through their refcounts),
        its reservation returns to the mirror.  Double-free is a no-op."""
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

    # -- sharing / COW (the prefix-cache face of the API) ---------------------
    def _resident(self, block: VirtualBlock, what: str) -> None:
        if block.status != "resident":
            raise ValueError(f"{what} needs a resident block; block "
                             f"{block.bid} is {block.status}")

    def map_shared(self, block: VirtualBlock, page_ids: Sequence[int],
                   n_tokens: int) -> None:
        """Map already-filled cached pages read-only into the block (one
        device scatter, zero prefill FLOPs); each page gains a reference."""
        self._resident(block, "map_shared")
        if block.props & (VBProps.RING | VBProps.RECURRENT):
            raise ValueError(
                "RING/RECURRENT blocks are ineligible for prefix sharing: "
                "ring frames are position-recycled and recurrent state is "
                "not page-addressed")
        map_prefix(self.pool.state, block.slot, self._padded_ids(page_ids),
                   len(page_ids), n_tokens)
        block.shared_pages = len(page_ids)
        block.n_tokens = n_tokens
        block.props |= VBProps.SHARED_RO
        self.stats["prefix_maps"] += 1
        self.stats["prefix_pages_mapped"] += len(page_ids)

    def cow_break(self, block: VirtualBlock, page_idx: int, src_page: int,
                  new_len: int) -> None:
        """Copy-on-write break of a partially shared page into the block
        (pops one device page — the block's reservation must cover it)."""
        self._resident(block, "cow_break")
        clone_page_cow(self.pool.state, block.slot, page_idx, src_page,
                       new_len)
        block.n_tokens = new_len
        block.props |= VBProps.COW
        self.stats["cow_clones"] += 1

    def page_row(self, block: VirtualBlock, n_pages: int) -> List[int]:
        """Device→host read of the block's first ``n_pages`` page ids (for
        prefix-cache insertion).  Control path only: this syncs."""
        return self.pool.state.page_table[block.slot, :n_pages].tolist()

    def retain(self, page_ids: Sequence[int],
               from_block: Optional[VirtualBlock] = None) -> None:
        """The prefix cache takes custody: +1 device reference per page so
        they outlive their slot.  With ``from_block``, the pages move out
        of that block's reservation (the mirror stays exact: the pages are
        still in use, now on the cache's ledger)."""
        if from_block is not None and \
                from_block.reserved_pages < len(page_ids):
            raise RuntimeError(
                f"block {from_block.bid} reserves "
                f"{from_block.reserved_pages} pages, cannot hand "
                f"{len(page_ids)} to the cache")
        for i in range(0, len(page_ids), self.pool.max_pages):
            chunk = page_ids[i:i + self.pool.max_pages]
            retain_pages(self.pool.state, self._padded_ids(chunk),
                         len(chunk))
        if from_block is not None:
            from_block.reserved_pages -= len(page_ids)
            from_block.shared_pages += len(page_ids)
        self.stats["cached_page_retains"] += len(page_ids)

    def release(self, page_ids: Sequence[int]) -> None:
        """Prefix-cache eviction: drop the cache's reference; refcount-zero
        pages return to the free stack and to the host mirror."""
        for i in range(0, len(page_ids), self.pool.max_pages):
            chunk = page_ids[i:i + self.pool.max_pages]
            release_pages(self.pool.state, self._padded_ids(chunk),
                          len(chunk))
        self.free_pages += len(page_ids)
        self.stats["cached_page_releases"] += len(page_ids)
