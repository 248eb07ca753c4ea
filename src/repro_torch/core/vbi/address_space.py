"""VBI address space (Sec. 3.3.1).

A single global 64-bit address space of Virtual Blocks.  A VBI address is

    [ SizeID : 3 ][ VBID : 61 - log2(size) ][ offset : log2(size) ]

with eight size classes 4 KB … 128 TB.  ``VBUID = (SizeID << vbid_bits) |
VBID`` identifies a VB system-wide; programs address data as
``{CVT index, offset}`` and the CPU forms the VBI address from the CVT entry
(cvt.py).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

ADDR_BITS = 64
SIZE_ID_BITS = 3

KB = 1 << 10
MB = 1 << 20
GB = 1 << 30
TB = 1 << 40

# size classes (Sec. 3.3.1): 4KB, 128KB, 4MB, 128MB, 4GB, 128GB, 4TB, 128TB
SIZE_CLASSES = tuple(4 * KB * (32 ** i) for i in range(8))


def offset_bits(size_id: int) -> int:
    return (SIZE_CLASSES[size_id]).bit_length() - 1


def vbid_bits(size_id: int) -> int:
    return ADDR_BITS - SIZE_ID_BITS - offset_bits(size_id)


def size_class_for(nbytes: int) -> int:
    """Smallest size class that fits ``nbytes``."""
    for i, s in enumerate(SIZE_CLASSES):
        if nbytes <= s:
            return i
    raise ValueError(f"object of {nbytes} bytes exceeds largest size class")


def make_vbuid(size_id: int, vbid: int) -> int:
    assert 0 <= size_id < 8 and 0 <= vbid < (1 << vbid_bits(size_id))
    return (size_id << vbid_bits(size_id)) | vbid


def split_vbuid(vbuid: int, size_id: int) -> Tuple[int, int]:
    return size_id, vbuid & ((1 << vbid_bits(size_id)) - 1)


def encode_vbi_addr(size_id: int, vbid: int, offset: int) -> int:
    ob = offset_bits(size_id)
    assert 0 <= offset < (1 << ob)
    return (size_id << (ADDR_BITS - SIZE_ID_BITS)) | (vbid << ob) | offset


def decode_vbi_addr(addr: int) -> Tuple[int, int, int]:
    size_id = (addr >> (ADDR_BITS - SIZE_ID_BITS)) & 0x7
    ob = offset_bits(size_id)
    vbid = (addr >> ob) & ((1 << (ADDR_BITS - SIZE_ID_BITS - ob)) - 1)
    return size_id, vbid, addr & ((1 << ob) - 1)


class VBProps(enum.IntFlag):
    """Per-VB property bitvector (flags + software hints, Sec. 3.3.1)."""
    NONE = 0
    CODE = 1 << 0
    READ_ONLY = 1 << 1
    KERNEL = 1 << 2
    COMPRESSIBLE = 1 << 3
    PERSISTENT = 1 << 4
    LATENCY_SENSITIVE = 1 << 5
    BANDWIDTH_SENSITIVE = 1 << 6
    ERROR_TOLERANT = 1 << 7
    HOT = 1 << 8
    COLD = 1 << 9
    KV_CACHE = 1 << 10          # TPU adaptation: serving KV blocks
    # TPU serve adaptation (core/vbi/blocks.py, DESIGN.md §6): the declared
    # properties the VBIAllocator turns into placement decisions.
    PINNED = 1 << 11            # never preempted or swapped
    EVICTABLE = 1 << 12         # cache-custody pages may be LRU-dropped
    SWAPPABLE = 1 << 13         # preemption may demote to the host tier
    SHARED_RO = 1 << 14         # maps pages it does not own, read-only
    COW = 1 << 15               # holds a copy-on-write clone
    # data-property-typed cache blocks (DESIGN.md §8): per-layer-kind KV
    # state whose declared liveness/size properties the allocator exploits
    RING = 1 << 16              # bounded liveness: only the last `window`
    #                             tokens are ever read — footprint capped at
    #                             ceil(window/page_size) pages, frames
    #                             reused in place, ineligible for prefix
    #                             sharing (old tokens die, pages never grow)
    RECURRENT = 1 << 17         # constant size: per-slot recurrent state
    #                             (RG-LRU h / SSM state), snapshot/restore
    #                             is a dense copy, zero per-token growth
    # the placement axis (DESIGN.md §13): which device(s) a block's pages
    # physically live on is itself a declared data property — stamped by
    # VBIAllocator.place_block, carried on every trace op
    SHARDED = 1 << 18           # pages distributed across >1 mesh device
    #                             (addressing stays global: one page table,
    #                             gathers must name their source devices)


@dataclasses.dataclass
class VBInfo:
    """One VIT entry (Sec. 3.3.5)."""
    enabled: bool = False
    props: VBProps = VBProps.NONE
    refcount: int = 0
    translation_type: str = "none"      # 'direct' | 'single' | 'multi'
    translation: Optional[object] = None
    size_id: int = 0
    cow_parent: Optional[int] = None    # clone_vb source (copy-on-write)
