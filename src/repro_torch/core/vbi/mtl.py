"""The Memory Translation Layer (Sec. 3.3.5, 3.4) — MTL.

The MTL lives in the memory controller and owns (1) physical allocation and
(2) VBI→physical translation.  This model implements, faithfully:

* **Base allocation** at 4 KB granularity with multi-level tables whose depth
  follows the VB size class (Sec. 3.3.5).
* **Delayed physical allocation** (Sec. 3.4.1): memory is allocated on the
  first *dirty LLC writeback*; reads of unbacked regions return zero lines
  without allocating or translating.
* **Flexible translation structures** (Sec. 3.4.2): direct-mapped /
  single-level / multi-level chosen per VB.
* **Early reservation** (Sec. 3.4.3): buddy-reserved contiguous regions keep
  VBs direct-mapped; three-level allocation priority (own-reserved →
  unreserved → steal-other-reserved).
* **clone_vb / promote_vb** (Sec. 3.3.4): copy-on-write frame sharing and
  size-class promotion preserving the mapped prefix.

Frames are 4 KB.  Data contents are stored per-frame (numpy) only when
written, so functional tests can verify zero-fill/COW semantics.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .address_space import SIZE_CLASSES, VBInfo, VBProps, offset_bits

PAGE = 4096
PAGE_BITS = 12
RADIX_BITS = 9          # 512-entry tables, x86-like fanout


# --------------------------------------------------------------------------
# translation structures
# --------------------------------------------------------------------------
class DirectMap:
    """Whole VB contiguous: one TLB entry, zero table walks."""
    kind = "direct"

    def __init__(self, base_frame: int, n_pages: int):
        self.base = base_frame
        self.n_pages = n_pages
        self.present = np.zeros(n_pages, dtype=bool)

    def translate(self, page: int) -> Tuple[Optional[int], int]:
        if page < self.n_pages and self.present[page]:
            return self.base + page, 0
        return None, 0

    def map(self, page: int, frame: int) -> None:
        assert frame == self.base + page, "direct map must stay contiguous"
        self.present[page] = True

    def unmap_all(self) -> List[int]:
        out = [self.base + p for p in np.nonzero(self.present)[0]]
        self.present[:] = False
        return out

    def mapped(self) -> List[Tuple[int, int]]:
        return [(int(p), self.base + int(p)) for p in np.nonzero(self.present)[0]]


class SingleLevel:
    """One flat table: 1 memory access per walk."""
    kind = "single"

    def __init__(self, n_pages: int):
        self.table: Dict[int, int] = {}
        self.n_pages = n_pages

    def translate(self, page: int) -> Tuple[Optional[int], int]:
        return self.table.get(page), 1

    def map(self, page: int, frame: int) -> None:
        self.table[page] = frame

    def unmap_all(self) -> List[int]:
        out = list(self.table.values())
        self.table.clear()
        return out

    def mapped(self):
        return list(self.table.items())


class MultiLevel:
    """Radix tree sized to the VB (fewer levels for smaller VBs)."""
    kind = "multi"

    def __init__(self, size_id: int):
        bits = offset_bits(size_id) - PAGE_BITS
        self.levels = max(1, -(-bits // RADIX_BITS))
        self.root: Dict = {}
        self.n_pages = 1 << bits if bits > 0 else 1

    def _path(self, page: int) -> List[int]:
        idxs = []
        for lvl in range(self.levels):
            shift = RADIX_BITS * (self.levels - 1 - lvl)
            idxs.append((page >> shift) & ((1 << RADIX_BITS) - 1))
        return idxs

    def translate(self, page: int) -> Tuple[Optional[int], int]:
        node = self.root
        accesses = 0
        for i, idx in enumerate(self._path(page)):
            accesses += 1
            if idx not in node:
                return None, accesses
            node = node[idx]
            if i == self.levels - 1:
                return node, accesses
        return None, accesses

    def map(self, page: int, frame: int) -> None:
        node = self.root
        path = self._path(page)
        for idx in path[:-1]:
            node = node.setdefault(idx, {})
        node[path[-1]] = frame

    def unmap_all(self) -> List[int]:
        out = []

        def rec(node, lvl):
            for v in node.values():
                if lvl == self.levels - 1:
                    out.append(v)
                else:
                    rec(v, lvl + 1)

        rec(self.root, 0)
        self.root = {}
        return out

    def mapped(self):
        out = []

        def rec(node, lvl, prefix):
            for k, v in node.items():
                pg = (prefix << RADIX_BITS) | k
                if lvl == self.levels - 1:
                    out.append((pg, v))
                else:
                    rec(v, lvl + 1, pg)

        rec(self.root, 0, 0)
        return out


# --------------------------------------------------------------------------
# physical memory with buddy reservation
# --------------------------------------------------------------------------
class PhysicalMemory:
    """Frame pool with a buddy allocator and per-VB reservations."""

    def __init__(self, n_frames: int):
        assert n_frames & (n_frames - 1) == 0, "power-of-two frames"
        self.n_frames = n_frames
        self.max_order = n_frames.bit_length() - 1
        self.free_lists: List[List[int]] = [[] for _ in range(self.max_order + 1)]
        self.free_lists[self.max_order].append(0)
        # frame state
        self.owner = np.full(n_frames, -1, dtype=np.int64)       # allocated to vb
        self.reserved_for = np.full(n_frames, -1, dtype=np.int64)
        self.refcount = np.zeros(n_frames, dtype=np.int32)       # COW sharing
        self.data: Dict[int, np.ndarray] = {}                    # lazily backed

    # buddy internals ------------------------------------------------------
    def _split_to(self, order: int) -> Optional[int]:
        for o in range(order, self.max_order + 1):
            if self.free_lists[o]:
                base = self.free_lists[o].pop()
                while o > order:
                    o -= 1
                    self.free_lists[o].append(base + (1 << o))
                return base
        return None

    def alloc_block(self, n_frames: int) -> Optional[int]:
        order = max(0, (n_frames - 1).bit_length())
        return self._split_to(order)

    def free_block(self, base: int, n_frames: int) -> None:
        order = max(0, (n_frames - 1).bit_length())
        # buddy coalescing
        while order < self.max_order:
            buddy = base ^ (1 << order)
            if buddy in self.free_lists[order]:
                self.free_lists[order].remove(buddy)
                base = min(base, buddy)
                order += 1
            else:
                break
        self.free_lists[order].append(base)

    # reservation-aware single-frame allocation (Sec. 3.4.3 priority) ------
    def reserve(self, vbuid: int, n_frames: int) -> Optional[int]:
        base = self.alloc_block(n_frames)
        if base is None:
            return None
        self.reserved_for[base:base + n_frames] = vbuid
        return base

    def take_reserved(self, vbuid: int, frame: int) -> int:
        assert self.reserved_for[frame] == vbuid and self.owner[frame] == -1
        self.owner[frame] = vbuid
        self.refcount[frame] = 1
        return frame

    def alloc_frame(self, vbuid: int) -> Optional[int]:
        """Unreserved first, then steal a frame reserved for another VB."""
        base = self._split_to(0)
        if base is not None:
            self.owner[base] = vbuid
            self.refcount[base] = 1
            self.reserved_for[base] = -1
            return base
        stolen = np.nonzero((self.reserved_for >= 0) & (self.owner == -1))[0]
        if len(stolen):
            f = int(stolen[0])
            self.owner[f] = vbuid
            self.refcount[f] = 1
            self.reserved_for[f] = -1
            return f
        return None

    def release_frame(self, frame: int) -> None:
        self.refcount[frame] -= 1
        if self.refcount[frame] <= 0:
            self.owner[frame] = -1
            self.refcount[frame] = 0
            self.data.pop(frame, None)
            if self.reserved_for[frame] < 0:
                self.free_block(frame, 1)

    # data -----------------------------------------------------------------
    def write(self, frame: int, off: int, buf: np.ndarray) -> None:
        page = self.data.setdefault(frame, np.zeros(PAGE, np.uint8))
        page[off:off + len(buf)] = buf

    def read(self, frame: int, off: int, length: int) -> np.ndarray:
        page = self.data.get(frame)
        if page is None:
            return np.zeros(length, np.uint8)
        return page[off:off + length].copy()

    @property
    def frames_in_use(self) -> int:
        return int((self.owner >= 0).sum())


# --------------------------------------------------------------------------
# the MTL
# --------------------------------------------------------------------------
class MTL:
    def __init__(self, phys: PhysicalMemory, early_reservation: bool = True,
                 flexible_translation: bool = True):
        self.phys = phys
        self.early_reservation = early_reservation
        self.flexible = flexible_translation
        self.vit: Dict[int, Dict[int, VBInfo]] = {i: {} for i in range(8)}
        self._next_vbid = [0] * 8
        self._reservation: Dict[Tuple[int, int], Tuple[int, int]] = {}
        self.stats = {"zero_fill_reads": 0, "delayed_allocs": 0,
                      "walk_accesses": 0, "walks": 0, "reservations": 0,
                      "cow_copies": 0, "promotions": 0, "swapped_out": 0}
        self.swap: Dict[Tuple[int, int, int], np.ndarray] = {}

    # -- VIT helpers --------------------------------------------------------
    def _info(self, size_id: int, vbid: int) -> VBInfo:
        return self.vit[size_id][vbid]

    def enable_vb(self, size_id: int, props: VBProps = VBProps.NONE) -> int:
        # reuse the lowest disabled vbid to bound the VIT (Sec. 3.3.5)
        tbl = self.vit[size_id]
        vbid = None
        for k, info in tbl.items():
            if not info.enabled:
                vbid = k
                break
        if vbid is None:
            vbid = self._next_vbid[size_id]
            self._next_vbid[size_id] += 1
        tbl[vbid] = VBInfo(enabled=True, props=props, refcount=0,
                           size_id=size_id)
        return vbid

    def disable_vb(self, size_id: int, vbid: int) -> None:
        info = self._info(size_id, vbid)
        assert info.refcount == 0, "disable_vb on attached VB"
        if info.translation is not None:
            for frame in info.translation.unmap_all():
                self.phys.release_frame(frame)
        res = self._reservation.pop((size_id, vbid), None)
        if res is not None:
            base, n = res
            still = [f for f in range(base, base + n)
                     if self.phys.owner[f] == -1]
            self.phys.reserved_for[base:base + n] = -1
            for f in still:
                self.phys.free_block(f, 1)
        self.vit[size_id][vbid] = VBInfo(enabled=False, size_id=size_id)

    def vb_pages(self, size_id: int) -> int:
        return SIZE_CLASSES[size_id] // PAGE

    # -- translation --------------------------------------------------------
    def _ensure_translation(self, size_id: int, vbid: int) -> None:
        info = self._info(size_id, vbid)
        if info.translation is not None:
            return
        n_pages = self.vb_pages(size_id)
        if self.early_reservation:
            base = self.phys.reserve(vbid, n_pages)
            if base is not None:
                self._reservation[(size_id, vbid)] = (base, n_pages)
                self.stats["reservations"] += 1
                info.translation = DirectMap(base, n_pages)
                info.translation_type = "direct"
                return
        if self.flexible and size_id <= 2:
            # 4KB direct would need a frame reservation; use single-level for
            # small VBs (1 access), multi-level for large ones (Sec. 3.4.2)
            info.translation = SingleLevel(n_pages)
            info.translation_type = "single"
        else:
            info.translation = MultiLevel(size_id)
            info.translation_type = "multi"

    def translate(self, size_id: int, vbid: int, offset: int
                  ) -> Tuple[Optional[int], int]:
        """VBI→physical (frame, byte-in-frame) or (None, off) if unbacked.
        Counts table-walk memory accesses for the translation benchmarks."""
        info = self._info(size_id, vbid)
        if info.translation is None:
            return None, offset % PAGE
        frame, accesses = info.translation.translate(offset // PAGE)
        self.stats["walks"] += 1
        self.stats["walk_accesses"] += accesses
        return frame, offset % PAGE

    # -- delayed allocation (Sec. 3.4.1) -------------------------------------
    def _alloc_page(self, size_id: int, vbid: int, page: int) -> int:
        info = self._info(size_id, vbid)
        self._ensure_translation(size_id, vbid)
        res = self._reservation.get((size_id, vbid))
        if res is not None and isinstance(info.translation, DirectMap):
            base, n = res
            if page < n and self.phys.reserved_for[base + page] == vbid \
                    and self.phys.owner[base + page] == -1:
                f = self.phys.take_reserved(vbid, base + page)
                info.translation.map(page, f)
                return f
            # reservation was stolen / out of range: degrade to single-level
            self._degrade_to_single(size_id, vbid)
        f = self.phys.alloc_frame(vbid)
        assert f is not None, "out of physical memory (swap not triggered)"
        info.translation.map(page, f)
        return f

    def _degrade_to_single(self, size_id: int, vbid: int) -> None:
        info = self._info(size_id, vbid)
        old = info.translation
        new = SingleLevel(self.vb_pages(size_id))
        for page, frame in old.mapped():
            new.map(page, frame)
        info.translation = new
        info.translation_type = "single"

    def read(self, size_id: int, vbid: int, offset: int, length: int = 64
             ) -> np.ndarray:
        """LLC-miss read: zero line if unbacked (no allocation, Sec. 3.4.1)."""
        frame, off = self.translate(size_id, vbid, offset)
        if frame is None:
            self.stats["zero_fill_reads"] += 1
            return np.zeros(length, np.uint8)
        return self.phys.read(frame, off, length)

    def writeback(self, size_id: int, vbid: int, offset: int,
                  data: np.ndarray) -> None:
        """Dirty LLC writeback: allocate on first touch, COW if shared."""
        info = self._info(size_id, vbid)
        page = offset // PAGE
        frame, off = self.translate(size_id, vbid, offset)
        if frame is None:
            frame = self._alloc_page(size_id, vbid, page)
            self.stats["delayed_allocs"] += 1
        elif self.phys.refcount[frame] > 1:        # COW break
            newf = self.phys.alloc_frame(vbid)
            self.phys.data[newf] = self.phys.read(frame, 0, PAGE)
            self.phys.release_frame(frame)
            if isinstance(info.translation, DirectMap):
                self._degrade_to_single(size_id, vbid)
            info.translation.map(page, newf)
            frame = newf
            self.stats["cow_copies"] += 1
        self.phys.write(frame, off, np.asarray(data, np.uint8))

    # -- clone / promote (Sec. 3.3.4) ----------------------------------------
    def clone_vb(self, size_id: int, src_vbid: int, dst_vbid: int) -> None:
        src = self._info(size_id, src_vbid)
        dst = self._info(size_id, dst_vbid)
        if src.translation is None:
            return
        dst.translation = SingleLevel(self.vb_pages(size_id))
        dst.translation_type = "single"
        for page, frame in src.translation.mapped():
            self.phys.refcount[frame] += 1
            dst.translation.map(page, frame)
        dst.cow_parent = src_vbid

    def promote_vb(self, small_sid: int, small_vbid: int,
                   large_sid: int, large_vbid: int) -> None:
        """Map the early portion of the larger VB to the small VB's frames."""
        assert large_sid > small_sid
        small = self._info(small_sid, small_vbid)
        large = self._info(large_sid, large_vbid)
        self._ensure_translation(large_sid, large_vbid)
        if isinstance(large.translation, DirectMap):
            self._degrade_to_single(large_sid, large_vbid)
        if small.translation is not None:
            for page, frame in small.translation.mapped():
                self.phys.refcount[frame] += 1
                large.translation.map(page, frame)
            for frame in small.translation.unmap_all():
                self.phys.release_frame(frame)
        small.translation = None
        self.stats["promotions"] += 1

    # -- capacity management (swap "system calls", Sec. 3.2.4) ---------------
    def swap_out(self, size_id: int, vbid: int, page: int) -> None:
        info = self._info(size_id, vbid)
        frame, acc = info.translation.translate(page)
        if frame is None:
            return
        self.swap[(size_id, vbid, page)] = self.phys.read(frame, 0, PAGE)
        if isinstance(info.translation, DirectMap):
            self._degrade_to_single(size_id, vbid)
        info.translation.table.pop(page, None) if isinstance(
            info.translation, SingleLevel) else None
        self.phys.release_frame(frame)
        self.stats["swapped_out"] += 1

    def swap_in(self, size_id: int, vbid: int, page: int) -> None:
        key = (size_id, vbid, page)
        if key not in self.swap:
            return
        frame = self._alloc_page(size_id, vbid, page)
        self.phys.data[frame] = self.swap.pop(key)
