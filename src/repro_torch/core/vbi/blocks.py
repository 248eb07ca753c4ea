"""The VBI memory API for serving — one allocator, property-driven placement
(counterpart of ``repro/core/vbi/blocks.py``).

:class:`VBIAllocator` is the only door to KV page lifecycle.  Each
request's KV is a :class:`VirtualBlock` with declared properties
(:class:`~repro_torch.core.vbi.address_space.VBProps`):

  * ``SHARED_RO`` / ``COW`` — the block maps prefix-cache pages read-only /
    holds a copy-on-write clone (``map_shared`` / ``cow_break``);
  * ``RING`` / ``RECURRENT`` — stamped from the pool's layer kinds; such
    blocks are ineligible for sharing, and their swap images carry the
    ring frames and recurrent rows;
  * ``PINNED`` — never chosen as a preemption victim, never swapped;
  * ``SWAPPABLE`` — under memory pressure the block's device pages are
    copied to the host tier (:class:`HostSwapTier`) and freed; on resume
    they are restored with one device scatter (``kvcache.py::
    restore_block``): exact KV, no re-prefill.

The allocator owns the host page mirror (``free_pages``), the custody
ledger between slots and the prefix cache (``retain``/``release``), the
swap tier and the MTL VB lifecycle; the device owns translation and
refcounts (``PagedServeState``).  It never reads device state on the
token path: the mirror is kept arithmetically, and the only reads are
``page_row``, the two ``*_pages`` properties and the gathers of
``swap_out``/``export_image``/``snapshot_image`` (control path).

A block also travels as a sealed :class:`BlockImage` (``export_image``,
``snapshot_image``, ``import_image``: the handoff unit of disaggregated
serving and crash recovery), whose CRC-32 equals the reference's for the
same state.  Images hold numpy arrays, as the reference's do.  Two
duck-typed hooks watch the allocator: a tracer (``attach_tracer``; every
op emits the reference's block events) and a fault plan
(``attach_faults``; consulted before a boundary op mutates anything).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ...device import resolve_device, stage
from .address_space import VBProps
from .kvcache import (PagedKVManager, admit_slot, aux_swap_charge,
                      clone_page_cow, init_serve_state, kv_payload_checksum,
                      make_ring_table, map_prefix, release_pages,
                      release_slot, restore_aux, restore_block, retain_pages,
                      snapshot_aux, snapshot_block)
from .mtl import MTL, PhysicalMemory

DEFAULT_BLOCK_PROPS = (VBProps.KV_CACHE | VBProps.EVICTABLE
                       | VBProps.SWAPPABLE)


@dataclasses.dataclass
class VirtualBlock:
    """One request's KV stream: a slot-resident (or host-swapped) VB.

    ``reserved_pages`` is the block's charge against the allocator's host
    page mirror (budgeted ahead of device pops — the paper's early
    reservation); ``shared_pages`` counts pages in the block's span that
    the block does NOT own (mapped read-only from the prefix cache, or
    whose custody moved to it).  ``n_tokens`` mirrors the device
    ``seq_lens`` entry — what a swap image must cover."""
    bid: int
    slot: int
    props: VBProps
    n_tokens: int = 0
    reserved_pages: int = 0
    shared_pages: int = 0
    status: str = "resident"            # resident | swapped | exported | freed
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


class PagePool:
    """A device page pool without a model: the state and geometry an
    allocator needs.  :class:`~repro_torch.serve.engine.PagedEngine`
    satisfies the same protocol (``state``, ``n_pages``, ``page_size``,
    ``max_seqs``, ``max_pages``, ``placement``, and the property-typed
    extension ``has_full``, ``kind_props``, ``aux_swap_pages``,
    ``ring_row``).  ``ring_layers``/``ring_pages`` add a RING pool (static
    per-slot frames), ``rg_layers``/``rnn_width`` a RECURRENT RG-LRU
    state; ``n_layers=0`` is a pool with no full-attention layer."""

    def __init__(self, n_layers: int, n_pages: int, page_size: int,
                 n_kv: int, head_dim: int, max_seqs: int,
                 max_pages_per_seq: int, dtype=torch.float32,
                 ring_layers: int = 0, ring_pages: int = 0,
                 rg_layers: int = 0, rnn_width: int = 0,
                 placement: Sequence[str] = (),
                 device: Union[str, torch.device] = "cuda"):
        dev = resolve_device(device)
        self.placement = (tuple(placement)
                          or (f"{dev.type}:{dev.index or 0}",))
        self.n_pages = n_pages
        self.page_size = page_size
        self.max_seqs = max_seqs
        self.max_pages = max_pages_per_seq
        self.has_full = n_layers > 0
        self.kind_props = VBProps.NONE
        if ring_layers:
            self.kind_props |= VBProps.RING
        if rg_layers:
            self.kind_props |= VBProps.RECURRENT
        self.aux_swap_pages = aux_swap_charge(ring_layers, ring_pages,
                                              rg_layers)
        self.ring_table = torch.from_numpy(make_ring_table(
            max_seqs, ring_pages if ring_layers else 0)).to(dev)
        self.state = init_serve_state(
            n_layers=n_layers, n_pages=n_pages, page_size=page_size,
            n_kv=n_kv, head_dim=head_dim, max_seqs=max_seqs,
            max_pages_per_seq=max_pages_per_seq, dtype=dtype,
            n_ring_layers=ring_layers, ring_pages=ring_pages,
            n_rg=rg_layers, rnn_width=rnn_width, device=dev)

    def ring_row(self, slot: int) -> torch.Tensor:
        """``slot``'s static ring frames, [ring_pages] int32 on the
        device."""
        return self.ring_table[slot]


# images compare by identity (eq=False): their numpy payloads have no
# single truth value
@dataclasses.dataclass(eq=False)
class _SwapImage:
    k: np.ndarray                       # [n_layers, n_pages, ps, n_kv, hd]
    v: np.ndarray
    n_pages: int                        # full-pool pages to pop on restore
    n_tokens: int
    charge: int                         # host-tier pages incl. the aux state
    # RING frames and RECURRENT rows (snapshot_aux); None for uniform stacks
    aux: Optional[tuple] = None


def _image_nbytes(img) -> int:
    """Exact host bytes one swap or block image holds (K/V pages + aux)."""
    n = img.k.nbytes + img.v.nbytes
    if img.aux is not None:
        n += sum(a.nbytes for a in img.aux)
    return n


class HostSwapTier:
    """Host backing store for swapped-out blocks, bounded in pages.  Holds
    the exact K/V bytes; the device holds nothing for a swapped block, so
    its pages serve other requests."""

    def __init__(self, capacity_pages: int):
        if capacity_pages <= 0:
            raise ValueError(f"swap tier capacity {capacity_pages} <= 0")
        self.capacity_pages = capacity_pages
        self.used_pages = 0
        self.images: Dict[int, _SwapImage] = {}

    def can_hold(self, n_pages: int) -> bool:
        return self.used_pages + n_pages <= self.capacity_pages

    def put(self, bid: int, img: _SwapImage) -> None:
        if bid in self.images or not self.can_hold(img.charge):
            raise RuntimeError(f"swap tier cannot take block {bid} "
                               f"({img.charge} pages, {self.used_pages} of "
                               f"{self.capacity_pages} used)")
        self.images[bid] = img
        self.used_pages += img.charge

    def pop(self, bid: int) -> _SwapImage:
        img = self.images.pop(bid)
        self.used_pages -= img.charge
        return img

    @property
    def bytes_held(self) -> int:
        """Exact host bytes parked in the tier."""
        return sum(_image_nbytes(img) for img in self.images.values())


@dataclasses.dataclass(eq=False)
class BlockImage:
    """A self-describing, portable snapshot of one request's block: the
    handoff unit of disaggregated serving and the crash-recovery
    checkpoint.  It carries what another allocator over a pool of another
    size needs to resume the request — token ids, committed length, K/V
    pages, ring and recurrent payloads, the declared :class:`VBProps` and
    the provenance ``lineage``.  Importer and exporter need only agree on
    the page size and the layer-kind split."""
    tokens: List[int]                   # committed token ids (prompt + out)
    n_tokens: int                       # committed length the K/V covers
    props: VBProps                      # declared properties travel along
    page_size: int
    n_pages: int                        # full-pool pages the payload holds
    charge: int                         # host pages held while in flight
    k: np.ndarray                       # [n_layers, n_pages, ps, n_kv, hd]
    v: np.ndarray
    aux: Optional[tuple] = None         # RING frames + RECURRENT state rows
    lineage: Optional[dict] = None      # provenance + the idempotency key
    src_bid: int = -1                   # identity in the exporting allocator
    src_pool: Optional[str] = None      # exporting tracer's pool label
    checksum: Optional[int] = None      # CRC over tokens + pages + aux

    @property
    def nbytes(self) -> int:
        return _image_nbytes(self)

    def compute_checksum(self) -> int:
        """CRC-32 of the payload (``kv_payload_checksum``) chained with the
        token ids and the custody metadata (committed length, page count,
        charge, declared props, page size), so a flipped payload bit and a
        falsified charge both fail :meth:`verify`."""
        crc = kv_payload_checksum(self.k, self.v, self.aux)
        meta = np.asarray(list(self.tokens)
                          + [self.n_tokens, self.n_pages, self.charge,
                             int(self.props), self.page_size], np.int64)
        return zlib.crc32(meta.tobytes(), crc) & 0xFFFFFFFF

    def verify(self) -> bool:
        """True iff the image carries a checksum and it matches."""
        return (self.checksum is not None
                and self.compute_checksum() == self.checksum)


class ImageIntegrityError(AssertionError):
    """A sealed :class:`BlockImage` failed its checksum at import.  Not
    retryable: the payload is damaged, so the exact recovery is to drop
    the image (``drop_image``) and re-prefill the request.  ``fault_id``
    names the injected fault when a fault plan caused the damage."""

    def __init__(self, msg: str, fault_id: Optional[int] = None):
        super().__init__(msg)
        self.fault_id = fault_id


#: the sharing annotations: pool-local, they die when pages are copied
_SHARING = VBProps.SHARED_RO | VBProps.COW


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (never a view of device state, also on the
    CPU), by a blocking copy: complete when this returns."""
    return t.to("cpu", copy=True).numpy()


class VBIAllocator:
    """The single interface through which KV memory is allocated, shared,
    cloned, swapped and released.

    ``pool`` follows the engine's pool protocol (see :class:`PagePool`).
    ``host_swap_pages > 0`` gives the allocator a host swap tier of that
    many pages."""

    def __init__(self, pool, host_swap_pages: int = 0,
                 mtl: Optional[MTL] = None):
        self.pool = pool
        self.mtl = mtl or MTL(PhysicalMemory(1 << 12))
        self.placement = tuple(pool.placement)
        self.free_pages = pool.n_pages - 1          # host mirror (page 0 null)
        self.blocks: Dict[int, VirtualBlock] = {}   # resident, by slot
        self.swap = (HostSwapTier(host_swap_pages) if host_swap_pages > 0
                     else None)
        self._next_bid = 0
        # duck-typed hooks (a TraceRecorder, a FaultPlan); None keeps every
        # op at one `is None` check
        self.tracer = None
        self.trace_pool = None
        self.faults = None
        # idempotent-import ledger: (src_pool, src_bid, lineage) of every
        # image adopted and still resident, so a retransmitted image
        # returns the live block instead of a second one
        self._imports: Dict[tuple, VirtualBlock] = {}
        self._import_keys: Dict[int, tuple] = {}    # bid -> ledger key
        self.stats = {"allocs": 0, "frees": 0, "prefix_maps": 0,
                      "prefix_pages_mapped": 0, "cow_clones": 0,
                      "cached_page_retains": 0, "cached_page_releases": 0,
                      "swap_outs": 0, "swap_ins": 0, "swapped_out_pages": 0,
                      "swapped_in_pages": 0, "swap_rejects": 0,
                      "unreserved_pages": 0, "swap_bytes_out": 0,
                      "swap_bytes_in": 0, "image_exports": 0,
                      "image_imports": 0, "image_bytes_out": 0,
                      "image_bytes_in": 0, "image_imports_deduped": 0,
                      "image_drops": 0, "image_snapshots": 0}

    # -- the two hooks ---------------------------------------------------------
    def attach_tracer(self, tracer) -> None:
        """Emit block-lifecycle events into ``tracer`` (the reference's
        ``TraceRecorder`` protocol: ``meta``, ``block_op``).  The first
        event is the pool geometry an offline checker replays against."""
        self.tracer = tracer
        # a scoped tracer carries a pool label; exported images stamp it
        self.trace_pool = getattr(tracer, "pool", None)
        if tracer is not None:
            tracer.meta(
                n_pages=self.pool.n_pages, page_size=self.pool.page_size,
                max_seqs=self.pool.max_seqs,
                swap_capacity=self.swap.capacity_pages if self.swap else 0)

    def _trace(self, op: str, blk: Optional[VirtualBlock] = None, **fields):
        t = self.tracer
        if t is None:
            return
        if blk is not None:
            # every block op carries the block's declared properties
            fields.setdefault("bid", blk.bid)
            fields.setdefault("slot", blk.slot)
            fields["props"] = int(blk.props)
            if blk.placement:
                fields.setdefault("placement", list(blk.placement))
        t.block_op(op, **fields)

    def attach_faults(self, faults) -> None:
        """Park a fault plan on the allocator (None detaches): its
        ``check(kind, tracer=, **ctx)`` may raise at each boundary, and
        ``deliver(img, tracer=)`` sees every image ``import_image`` takes."""
        self.faults = faults

    def _fault_point(self, kind: str, **ctx) -> None:
        """One boundary crossing of fault class ``kind``: the plan may
        raise here, BEFORE the op mutates anything, so a retry is safe."""
        if self.faults is not None:
            self.faults.check(kind, tracer=self.tracer, **ctx)

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
        self._trace("place", block)

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
        via ``map_shared``/``swap_in``."""
        if slot in self.blocks:
            raise ValueError(f"slot {slot} is busy")
        props |= getattr(self.pool, "kind_props", VBProps.NONE)
        blk = VirtualBlock(self._next_bid, slot, props)
        self._next_bid += 1
        blk.vbid = self.mtl.enable_vb(0, props)
        admit_slot(self.pool.state, slot)
        self.blocks[slot] = blk
        self.stats["allocs"] += 1
        self._trace("alloc", blk)
        self.place_block(blk)
        return blk

    def _detach(self, block: VirtualBlock) -> None:
        """Release a resident block's slot on the device and its
        reservation to the mirror; the block leaves ``blocks``."""
        release_slot(self.pool.state, block.slot)
        self.mtl.disable_vb(0, block.vbid)
        self.free_pages += block.reserved_pages
        block.reserved_pages = 0
        block.shared_pages = 0
        block.vbid = -1
        del self.blocks[block.slot]

    def free(self, block: VirtualBlock) -> None:
        """Release the block: device pages it owns return to the free stack
        (shared and cache-custody pages survive through their refcounts),
        its reservation returns to the mirror, a swapped block's host image
        is dropped.  Double-free is a no-op."""
        if block.status == "freed":
            return
        if block.status == "exported":
            # custody already left with the BlockImage
            block.status = "freed"
            return
        if block.status == "swapped":
            self.swap.pop(block.bid)
            block.status = "freed"
            self.stats["frees"] += 1
            self._forget_import(block)
            self._trace("free", block, freed_reserved=0, was="swapped")
            return
        self._forget_import(block)
        self._trace("free", block, freed_reserved=block.reserved_pages,
                    was="resident")
        self._detach(block)
        block.status = "freed"
        self.stats["frees"] += 1

    # -- reservation (host mirror of the device free stack; zero syncs) ------
    def reserve_pages(self, block: VirtualBlock, n_pages: int) -> None:
        """Grow the block's reservation to at least ``n_pages`` — budget
        charged before any device pop, so concurrent prefills can never
        oversubscribe the free stack."""
        if n_pages > block.reserved_pages:
            grow = n_pages - block.reserved_pages
            self._fault_point("alloc", bid=block.bid, grow=grow)
            if grow > self.free_pages:
                raise RuntimeError(
                    f"KV pool oversubscribed: block {block.bid} needs "
                    f"{grow} more pages, {self.free_pages} free")
            self.free_pages -= grow
            block.reserved_pages = n_pages
            self._trace("reserve", block, grow=grow, reserved=n_pages)

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
        self._trace("commit", block, n_tokens=n_tokens)

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
            self._trace("unreserve", block, returned=returned,
                        reserved=keep)

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
        self._trace("map_shared", block, n_pages=len(page_ids),
                    n_tokens=n_tokens)

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
        self._trace("cow_break", block, page_idx=page_idx,
                    src_page=src_page, n_tokens=new_len)

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
        if page_ids:
            self._trace("retain", n_pages=len(page_ids),
                        from_bid=from_block.bid if from_block else None,
                        slot=from_block.slot if from_block else -1)

    def release(self, page_ids: Sequence[int]) -> None:
        """Prefix-cache eviction: drop the cache's reference; refcount-zero
        pages return to the free stack and to the host mirror."""
        for i in range(0, len(page_ids), self.pool.max_pages):
            chunk = page_ids[i:i + self.pool.max_pages]
            release_pages(self.pool.state, self._padded_ids(chunk),
                          len(chunk))
        self.free_pages += len(page_ids)
        self.stats["cached_page_releases"] += len(page_ids)
        if page_ids:
            self._trace("release", n_pages=len(page_ids), slot=-1)

    # -- the host swap tier (property-driven placement) ------------------------
    def _gather(self, block: VirtualBlock):
        """The block's exact state on the host: ``(n_pages, charge, k, v,
        aux)``.  Gathers only the ``pages_for(n_tokens)`` pages the block
        maps (plus the ring frames and recurrent rows of a RING/RECURRENT
        block) and copies them to the host with a blocking copy, so the
        arrays are complete before anyone reads them.  Control path: this
        waits for the work enqueued before it.  On a mesh (the pool's
        ``shardings``) each rank gathers its block and an all-gather makes
        the whole image, the same bytes on every rank as the unmeshed
        pool's."""
        n_pages = self.pages_for(block.n_tokens)
        charge = n_pages + getattr(self.pool, "aux_swap_pages", 0)
        state = self.pool.state
        shardings = getattr(self.pool, "shardings", None)
        k, v = snapshot_block(state, block.slot, n_pages, shardings)
        aux = None
        if block.props & (VBProps.RING | VBProps.RECURRENT):
            # bounded by declared property: O(window) + O(1) however long
            # the block decoded
            aux = tuple(_host(a) for a in snapshot_aux(
                state, block.slot, self.pool.ring_row(block.slot),
                shardings))
        return n_pages, charge, _host(k), _host(v), aux

    def _scatter(self, slot: int, k: np.ndarray, v: np.ndarray,
                 aux: Optional[tuple], n_pages: int, n_tokens: int) -> None:
        """Restore a host image onto ``slot``: each array reaches the
        device through a fresh pinned buffer (``device.py::stage``), then
        one scatter of the pages and one of the aux state (on a mesh, of
        this rank's block of each).  Enqueues work only."""
        state = self.pool.state
        dev = state.device
        shardings = getattr(self.pool, "shardings", None)
        restore_block(state, slot, stage(k, dev), stage(v, dev), n_pages,
                      n_tokens, shardings)
        if aux is not None:
            restore_aux(state, slot, self.pool.ring_row(slot),
                        *(stage(a, dev) for a in aux), shardings=shardings)

    def swap_out(self, block: VirtualBlock) -> bool:
        """Demote the block to the host tier: copy its device pages (and
        aux state) out, free them, return its reservation to the mirror.
        Returns False — the caller falls back to discard — when the block's
        declared properties forbid it (not SWAPPABLE, or PINNED), no tier
        is configured, there is nothing to save, or the tier is full."""
        if (self.swap is None or not block.swappable or block.pinned
                or block.status != "resident" or block.n_tokens == 0):
            return False
        n_pages = self.pages_for(block.n_tokens)
        charge = n_pages + getattr(self.pool, "aux_swap_pages", 0)
        if not self.swap.can_hold(charge):
            self.stats["swap_rejects"] += 1
            return False
        self._fault_point("swap_out", bid=block.bid, n_pages=n_pages)
        n_pages, charge, k, v, aux = self._gather(block)
        img = _SwapImage(k, v, n_pages, block.n_tokens, charge, aux)
        self.swap.put(block.bid, img)
        n_bytes = _image_nbytes(img)
        self.stats["swap_bytes_out"] += n_bytes
        self._trace("swap_out", block, n_pages=n_pages, charge=charge,
                    freed_reserved=block.reserved_pages, bytes=n_bytes,
                    n_tokens=block.n_tokens,
                    gathered_from=list(self.placement))
        self._detach(block)
        block.slot = -1
        block.status = "swapped"
        self._forget_import(block)
        self.stats["swap_outs"] += 1
        self.stats["swapped_out_pages"] += n_pages
        return True

    def _charge(self, need: int, n_pages: int) -> None:
        """Charge an admission budget of ``need`` pages (at least the
        ``n_pages`` a restore pops) to the mirror."""
        if need < n_pages:
            raise ValueError(f"a budget of {need} pages cannot hold an "
                             f"image of {n_pages}")
        if need > self.free_pages:
            raise RuntimeError(f"KV pool oversubscribed: restore needs "
                               f"{need} pages, {self.free_pages} free")
        self.free_pages -= need

    def swap_in(self, block: VirtualBlock, slot: int,
                reserve_pages: Optional[int] = None) -> VirtualBlock:
        """Promote a swapped block back onto ``slot`` (any free slot):
        pop fresh pages and restore the host image with one device scatter
        — exact KV, no re-prefill.  ``reserve_pages`` (>= the image size) is
        charged to the mirror up front, like any admission budget.
        Enqueues device work only, so it may run under a horizon in
        flight."""
        if block.status != "swapped":
            raise ValueError(f"block {block.bid} is {block.status}, not "
                             f"swapped")
        if slot in self.blocks:
            raise ValueError(f"slot {slot} is busy")
        self._fault_point("swap_in", bid=block.bid)
        img = self.swap.images[block.bid]
        need = reserve_pages if reserve_pages is not None else img.n_pages
        self._charge(need, img.n_pages)
        self.swap.pop(block.bid)
        self._scatter(slot, img.k, img.v, img.aux, img.n_pages, img.n_tokens)
        block.slot = slot
        block.status = "resident"
        block.n_tokens = img.n_tokens
        block.reserved_pages = need
        block.shared_pages = 0
        # restored pages are private copies: the sharing annotations die
        block.props &= ~_SHARING
        block.vbid = self.mtl.enable_vb(0, block.props)
        self.blocks[slot] = block
        self.stats["swap_ins"] += 1
        self.stats["swapped_in_pages"] += img.n_pages
        n_bytes = _image_nbytes(img)
        self.stats["swap_bytes_in"] += n_bytes
        self._trace("swap_in", block, n_pages=img.n_pages, charge=img.charge,
                    reserve=need, bytes=n_bytes, n_tokens=img.n_tokens)
        self.place_block(block)
        return block

    # -- block images (the disaggregation and recovery unit) -------------------
    def _image(self, block: VirtualBlock, tokens, lineage) -> BlockImage:
        """A sealed image of the resident block's exact state."""
        n_pages, charge, k, v, aux = self._gather(block)
        img = BlockImage(
            tokens=list(tokens) if tokens is not None else [],
            n_tokens=block.n_tokens,
            # sharing annotations are pool-local and die at the boundary;
            # so does the placement bit (the image is whole on the host,
            # and the importing pool stamps its own placement), so a
            # block's image is the same bytes and CRC from any mesh
            props=block.props & ~(_SHARING | VBProps.SHARDED),
            page_size=self.pool.page_size, n_pages=n_pages, charge=charge,
            k=k, v=v, aux=aux, lineage=lineage, src_bid=block.bid,
            src_pool=self.trace_pool)
        # sealed: the importer verifies this digest before adoption
        img.checksum = img.compute_checksum()
        return img

    def export_image(self, block: VirtualBlock,
                     tokens: Optional[Sequence[int]] = None,
                     lineage: Optional[dict] = None) -> BlockImage:
        """Detach the block from this pool as a portable, sealed
        :class:`BlockImage`: one device gather of its pages (plus the aux
        state), then release the slot and return its reservation.  Custody
        moves to the image; the consumer may be another allocator over
        another pool (``import_image``)."""
        self._resident(block, "export_image")
        img = self._image(block, tokens, lineage)
        self._trace("export_image", block, n_pages=img.n_pages,
                    charge=img.charge, freed_reserved=block.reserved_pages,
                    bytes=img.nbytes, n_tokens=block.n_tokens,
                    gathered_from=list(self.placement))
        self._detach(block)
        block.slot = -1
        block.status = "exported"
        self._forget_import(block)
        self.stats["image_exports"] += 1
        self.stats["image_bytes_out"] += img.nbytes
        return img

    @staticmethod
    def _image_key(img: BlockImage) -> Optional[tuple]:
        """The idempotency identity of an image: (source pool, source bid,
        frozen lineage); None for an image with no source identity."""
        if img.src_bid < 0:
            return None
        lin = (tuple(sorted((str(k), str(v)) for k, v in img.lineage.items()))
               if isinstance(img.lineage, dict) else None)
        return (img.src_pool, img.src_bid, lin)

    def _forget_import(self, block: VirtualBlock) -> None:
        """Close the block's retransmission window: once an imported block
        leaves residency, a re-arriving copy of its image is a new import."""
        key = self._import_keys.pop(block.bid, None)
        if key is not None:
            self._imports.pop(key, None)

    def drop_image(self, img: BlockImage) -> None:
        """Give up an image without importing it (a corrupt or lost image:
        the request re-prefills from its tokens); the trace records it."""
        self.stats["image_drops"] += 1
        self._trace("drop_image", img_bid=img.src_bid,
                    img_pool=img.src_pool, charge=img.charge)

    def snapshot_image(self, block: VirtualBlock,
                       tokens: Optional[Sequence[int]] = None,
                       lineage: Optional[dict] = None) -> BlockImage:
        """Non-destructive :meth:`export_image`: a sealed image of the
        block while it stays resident (the crash-recovery checkpoint
        unit), stamped ``lineage["snapshot"]``."""
        self._resident(block, "snapshot_image")
        lin = dict(lineage or {})
        lin.setdefault("snapshot", True)
        img = self._image(block, tokens, lin)
        self.stats["image_snapshots"] += 1
        self._trace("snapshot_image", block, n_pages=img.n_pages,
                    bytes=img.nbytes, n_tokens=block.n_tokens,
                    gathered_from=list(self.placement))
        return img

    def import_image(self, img: BlockImage, slot: int,
                     reserve_pages: Optional[int] = None) -> VirtualBlock:
        """Adopt an image onto ``slot`` as a new block of this pool: charge
        the mirror, pop fresh pages and scatter the payload (its pages
        must fit one row of this pool; only they are staged to the
        device), stamping this pool's layer-kind properties on the
        declared ones.  Idempotent by (pool, bid, lineage): a re-delivered
        image whose block is still resident returns that block.  A sealed
        image that fails its checksum raises :class:`ImageIntegrityError`
        before any state changes."""
        key = self._image_key(img)
        if key is not None:
            live = self._imports.get(key)
            if live is not None and live.status == "resident":
                self.stats["image_imports_deduped"] += 1
                self._trace("import_dedup", live, img_bid=img.src_bid,
                            img_pool=img.src_pool)
                return live
        if self.faults is not None:     # transit: loss or corruption
            img = self.faults.deliver(img, tracer=self.tracer)
        if img.checksum is not None and not img.verify():
            raise ImageIntegrityError(
                f"block image (src_pool={img.src_pool} bid={img.src_bid}) "
                f"failed its integrity checksum — refusing to adopt",
                fault_id=getattr(img, "_fault_id", None))
        if slot in self.blocks:
            raise ValueError(f"slot {slot} is busy")
        if img.page_size != self.pool.page_size:
            raise ValueError(f"page-size mismatch: image {img.page_size} "
                             f"vs pool {self.pool.page_size}")
        kinds = VBProps.RING | VBProps.RECURRENT
        pool_kinds = getattr(self.pool, "kind_props", VBProps.NONE)
        if (img.props & kinds) != (pool_kinds & kinds):
            raise ValueError("image and destination pool disagree on layer "
                             "kinds")
        # the scatter writes only the image's pages, so the image needs no
        # padding to this pool's row (what crosses to the device is the
        # image's own bytes); it only has to fit one row
        if img.n_pages > self.pool.max_pages:
            raise ValueError(f"image holds {img.n_pages} pages > "
                             f"destination row width {self.pool.max_pages}")
        need = reserve_pages if reserve_pages is not None else img.n_pages
        self._charge(need, img.n_pages)
        blk = VirtualBlock(self._next_bid, slot,
                           (img.props & ~_SHARING) | pool_kinds)
        self._next_bid += 1
        self._scatter(slot, img.k, img.v, img.aux, img.n_pages,
                      img.n_tokens)
        blk.n_tokens = img.n_tokens
        blk.reserved_pages = need
        blk.vbid = self.mtl.enable_vb(0, blk.props)
        self.blocks[slot] = blk
        if key is not None:
            self._imports[key] = blk
            self._import_keys[blk.bid] = key
        self.stats["image_imports"] += 1
        self.stats["image_bytes_in"] += img.nbytes
        # snapshot images come from another process: not an in-trace export
        external = bool(isinstance(img.lineage, dict)
                        and img.lineage.get("snapshot"))
        self._trace("import_image", blk, n_pages=img.n_pages,
                    charge=img.charge, reserve=need, bytes=img.nbytes,
                    n_tokens=img.n_tokens, img_bid=img.src_bid,
                    img_pool=img.src_pool, img_external=external)
        self.place_block(blk)
        return blk


class LegacyKVAllocator:
    """The legacy, property-blind :class:`~repro_torch.core.vbi.kvcache.
    PagedKVManager` behind the VirtualBlock lifecycle subset: the oracle of
    the allocator's reservation arithmetic.  Sharing, COW and swap do not
    exist before VBI and raise."""

    def __init__(self, mgr: PagedKVManager):
        self.mgr = mgr
        self._next_bid = 0

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.mgr.page_size)

    def alloc(self, slot: int,
              props: VBProps = DEFAULT_BLOCK_PROPS) -> VirtualBlock:
        self.mgr.new_seq(slot)
        blk = VirtualBlock(self._next_bid, slot, props)
        self._next_bid += 1
        return blk

    def reserve(self, block: VirtualBlock, n_tokens: int) -> None:
        # no early reservation: the legacy manager allocates physically,
        # at once (the property-blind behaviour)
        self.mgr.ensure_capacity(block.slot, n_tokens)
        block.reserved_pages = len(self.mgr.seq_pages[block.slot])
        block.n_tokens = max(block.n_tokens, n_tokens)

    def free(self, block: VirtualBlock) -> None:
        if block.status == "freed":
            return
        self.mgr.release_seq(block.slot)
        block.reserved_pages = 0
        block.status = "freed"

    @property
    def pages_in_use(self) -> int:
        return self.mgr.pages_in_use

    def map_shared(self, *a, **k):
        raise NotImplementedError("legacy manager is property-blind")

    cow_break = swap_out = swap_in = map_shared
