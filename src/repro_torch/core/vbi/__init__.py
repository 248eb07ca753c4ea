"""The Virtual Block Interface (VBI) on torch — the thesis' Contribution #2.

A data-aware alternative virtual memory framework: a global address space of
size-classed Virtual Blocks, OS-owned protection (CVT), and a Memory
Translation Layer (MTL) that owns physical allocation and VBI→physical
translation with per-VB flexible translation structures, delayed allocation
and early reservation.  The host-side models (``address_space``, ``cvt``,
``mtl``, ``transsim``, ``hetero``) are copies of the reference package's;
``kvcache`` and ``blocks`` put the MTL's mechanism for a paged KV cache on
the device (delayed page allocation on first append, size-class promotion,
data-aware placement, the host swap tier and sealed block images).

The exports are the reference's, name for name.
"""
from .address_space import (SIZE_CLASSES, VBProps, VBInfo, decode_vbi_addr,
                            encode_vbi_addr, make_vbuid, size_class_for,
                            split_vbuid)
from .cvt import Client, ClientVBTable, CVTCache, PermissionError_, RWX
from .mtl import MTL, PhysicalMemory
from .kvcache import PagedKVManager, PagedKVState
from .blocks import (DEFAULT_BLOCK_PROPS, HostSwapTier, LegacyKVAllocator,
                     PagePool, VBIAllocator, VirtualBlock)

__all__ = [
    "SIZE_CLASSES", "VBProps", "VBInfo", "encode_vbi_addr", "decode_vbi_addr",
    "make_vbuid", "split_vbuid", "size_class_for", "Client", "ClientVBTable",
    "CVTCache", "RWX", "PermissionError_", "MTL", "PhysicalMemory",
    "PagedKVManager", "PagedKVState", "VBIAllocator", "VirtualBlock",
    "PagePool", "HostSwapTier", "LegacyKVAllocator", "DEFAULT_BLOCK_PROPS",
]
