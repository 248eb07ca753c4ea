"""Memory clients and the Client-VB Table (Sec. 3.3.1–3.3.3; the port's
copy of the reference's pure-Python model).

Protection is decoupled from translation: the OS manages per-client CVTs
(attach/detach instructions); every access checks the CVT — via a small
direct-mapped CVT cache — *before* any translation happens.  VBI addresses
returned here feed on-chip caches directly (VIVT behaviour); the MTL is only
consulted on LLC misses.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Tuple

from .address_space import encode_vbi_addr, SIZE_CLASSES


class RWX(enum.IntFlag):
    NONE = 0
    X = 1
    W = 2
    R = 4
    RW = 6
    RX = 5
    RWX = 7


class PermissionError_(Exception):
    pass


@dataclasses.dataclass
class CVTEntry:
    valid: bool = False
    size_id: int = 0
    vbid: int = 0
    perms: RWX = RWX.NONE


class CVTCache:
    """Per-core direct-mapped CVT cache (Sec. 3.3.3)."""

    def __init__(self, entries: int = 64):
        self.entries = entries
        self.tags: Dict[int, int] = {}
        self.stats = {"hits": 0, "misses": 0}

    def lookup(self, client_id: int, index: int) -> bool:
        slot = index % self.entries
        key = (client_id << 32) | index
        if self.tags.get(slot) == key:
            self.stats["hits"] += 1
            return True
        self.stats["misses"] += 1
        self.tags[slot] = key
        return False

    @property
    def hit_rate(self) -> float:
        t = self.stats["hits"] + self.stats["misses"]
        return self.stats["hits"] / t if t else 0.0


@dataclasses.dataclass
class Client:
    """Anything that allocates memory: the OS, native processes, VM guests."""
    client_id: int
    name: str = ""
    vm_id: int = 0                      # VBI address-space partition (Sec. 3.5.1)


class ClientVBTable:
    """OS-managed CVTs + the attach/detach 'instructions' (Sec. 3.3.1)."""

    def __init__(self, mtl, max_clients: int = 1 << 16):
        self.mtl = mtl
        self.max_clients = max_clients
        self.cvt: Dict[int, List[CVTEntry]] = {}
        self.caches: Dict[int, CVTCache] = {}

    def new_client(self, client_id: int, name: str = "", vm_id: int = 0
                   ) -> Client:
        assert client_id < self.max_clients
        self.cvt[client_id] = []
        self.caches[client_id] = CVTCache()
        return Client(client_id, name, vm_id)

    def destroy_client(self, client: Client) -> None:
        """Process destruction: detach all VBs, free the client id."""
        for idx, e in enumerate(self.cvt[client.client_id]):
            if e.valid:
                self.detach(client, idx)
        del self.cvt[client.client_id]
        del self.caches[client.client_id]

    # -- attach / detach -----------------------------------------------------
    def attach(self, client: Client, size_id: int, vbid: int, perms: RWX
               ) -> int:
        table = self.cvt[client.client_id]
        info = self.mtl.vit[size_id][vbid]
        assert info.enabled, "attach to disabled VB"
        entry = CVTEntry(True, size_id, vbid, perms)
        for i, e in enumerate(table):           # reuse invalid slots
            if not e.valid:
                table[i] = entry
                info.refcount += 1
                return i
        table.append(entry)
        info.refcount += 1
        return len(table) - 1

    def detach(self, client: Client, index: int) -> None:
        e = self.cvt[client.client_id][index]
        assert e.valid
        e.valid = False
        self.mtl.vit[e.size_id][e.vbid].refcount -= 1

    # -- the access path (Fig. 3.4) -------------------------------------------
    def check_access(self, client: Client, index: int, offset: int,
                     mode: RWX) -> Tuple[int, int, int]:
        """CVT bounds + permission check; returns (size_id, vbid, offset) —
        i.e. the VBI address components used to index VIVT caches."""
        table = self.cvt[client.client_id]
        if index >= len(table) or not table[index].valid:
            raise PermissionError_(f"invalid CVT index {index}")
        self.caches[client.client_id].lookup(client.client_id, index)
        e = table[index]
        if offset >= SIZE_CLASSES[e.size_id]:
            raise PermissionError_("offset beyond VB size")
        if (e.perms & mode) != mode:
            raise PermissionError_(f"access {mode!r} denied (have {e.perms!r})")
        return e.size_id, e.vbid, offset

    def vbi_address(self, client: Client, index: int, offset: int,
                    mode: RWX = RWX.R) -> int:
        size_id, vbid, off = self.check_access(client, index, offset, mode)
        return encode_vbi_addr(size_id, vbid, off)
