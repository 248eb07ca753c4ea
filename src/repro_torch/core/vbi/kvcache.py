"""Device-resident paged KV state and its ops — the MTL's mechanism on the
device (counterpart of ``repro/core/vbi/kvcache.py``).

Each sequence's KV stream is a Virtual Block backed *lazily*: a physical
page is popped from the device free stack only when the first token lands
in it (the paper's delayed allocation: first dirty writeback), and
attention translates through a page table that never leaves the device.

Where the reference donates its buffers to a jitted op and gets new ones
back, the ops here update the state's tensors **in place** and return the
same state object, so one pool allocation serves the whole run.  The
reference's ``mode="drop"`` scatters aimed at an out-of-range sentinel
become scatters into a one-row padded scratch copy (an out-of-range index
is an error in torch and a device-side assert on CUDA).

Nothing here reads device state back to the host, so the decode path
stays free of synchronisation.  The host swap tier's two halves follow
that rule too: ``snapshot_block``/``snapshot_aux`` only gather (the
allocator's blocking copy to the host is the one read), and
``restore_block``/``restore_aux`` only enqueue scatters, so a swap resume
can run while a decode horizon is in flight.

The legacy per-sequence state (``PagedKVState``, ``PagedKVManager``) is
the reference's pre-VBI manager, kept as the oracle of the allocator's
reservation arithmetic (``blocks.py::LegacyKVAllocator``).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ...device import resolve_device
from .address_space import VBProps
from .mtl import MTL, PhysicalMemory


def make_ring_table(max_seqs: int, ring_pages: int) -> np.ndarray:
    """The RING pool's static translation: slot ``s``'s frames are pages
    ``1 + s*ring_pages + i`` (page 0 = null, mirroring the main pool)."""
    if ring_pages <= 0:
        return np.zeros((max_seqs, 1), np.int32)
    return (1 + np.arange(max_seqs)[:, None] * ring_pages
            + np.arange(ring_pages)[None]).astype(np.int32)


def aux_swap_charge(n_ring: int, ring_pages: int, n_recurrent: int) -> int:
    """Host-tier charge (in pages) of one slot's RING + RECURRENT aux
    image: the ring's capped frames plus one page-equivalent for the
    constant-size recurrent state."""
    return (ring_pages if n_ring else 0) + (1 if n_recurrent else 0)


def _nbytes(t: torch.Tensor) -> int:
    return t.nelement() * t.element_size()


def tier_nbytes(state: "PagedServeState") -> Dict[str, int]:
    """Byte footprint of each device-resident cache tier (shape metadata
    only — never touches device memory)."""
    return {
        "full": _nbytes(state.k_pages) + _nbytes(state.v_pages),
        "ring": _nbytes(state.k_ring) + _nbytes(state.v_ring),
        "recurrent": (_nbytes(state.rg_h) + _nbytes(state.rg_conv)
                      + _nbytes(state.ssm_state) + _nbytes(state.ssm_conv)),
        "translation": (_nbytes(state.page_table) + _nbytes(state.free_stack)
                        + _nbytes(state.page_refcounts)),
    }


@dataclasses.dataclass
class PagedServeState:
    """Everything the continuous-batching decode step needs, on device.

        k_pages, v_pages : [n_layers, n_pages, page_size, n_kv, head_dim]
        page_table       : [max_seqs, max_pages_per_seq] int32 (0 = null)
        seq_lens         : [max_seqs] int32 — next write position per slot
        slot_active      : [max_seqs] bool
        free_stack       : [n_pages] int32 — free page ids in [0, free_top)
        free_top         : [] int32
        page_refcounts   : [n_pages] int32 — mappers per page
        k_ring, v_ring   : [n_ring_layers, 1 + max_seqs*ring_pages, ...]
        rg_h, rg_conv    : [n_rg_layers, max_seqs, ...]
        ssm_state, ssm_conv : [n_ssm_layers, max_seqs, ...]

    Layer kinds absent from the model carry zero-size tensors; the uniform
    full-attention stacks this slice serves have n_ring = n_rg = n_ssm = 0.
    """
    k_pages: torch.Tensor
    v_pages: torch.Tensor
    page_table: torch.Tensor
    seq_lens: torch.Tensor
    slot_active: torch.Tensor
    free_stack: torch.Tensor
    free_top: torch.Tensor
    page_refcounts: torch.Tensor
    k_ring: torch.Tensor
    v_ring: torch.Tensor
    rg_h: torch.Tensor
    rg_conv: torch.Tensor
    ssm_state: torch.Tensor
    ssm_conv: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[2]

    @property
    def n_pages(self) -> int:
        return self.k_pages.shape[1]

    @property
    def max_seqs(self) -> int:
        return self.page_table.shape[0]

    @property
    def max_pages_per_seq(self) -> int:
        return self.page_table.shape[1]

    @property
    def device(self) -> torch.device:
        return self.page_table.device


#: pool leaves a device mesh may shard over its ``model`` axis, and the
#: candidate dims of each, tried in order
#: (``distributed/sharding.py::serve_state_specs``): the translation
#: leaves (page table, lengths, free stack, refcounts) stay replicated
SERVE_STATE_SHARD_DIMS = {
    "k_pages": (3, 4), "v_pages": (3, 4),       # [L, P, ps, n_kv, hd]
    "k_ring": (3, 4), "v_ring": (3, 4),         # [L, rows, ps, n_kv, hd]
    "rg_h": (2,),                               # [L, S, rnn_width]
    "rg_conv": (3,),                            # [L, S, cw-1, rnn_width]
    "ssm_state": (2,),                          # [L, S, H, P, N]
    "ssm_conv": (3,),                           # [L, S, cw-1, ch]
}


def init_serve_state(n_layers: int, n_pages: int, page_size: int, n_kv: int,
                     head_dim: int, max_seqs: int, max_pages_per_seq: int,
                     dtype=torch.float32, n_ring_layers: int = 0,
                     ring_pages: int = 0, n_rg: int = 0, rnn_width: int = 0,
                     conv_width: int = 4, n_ssm: int = 0, ssm_heads: int = 0,
                     ssm_proj: int = 0, ssm_state_size: int = 0,
                     ssm_conv_ch: int = 0, ssm_conv_width: int = 4,
                     device: Union[str, torch.device] = "cuda",
                     shard: Optional[Dict[str, Tuple[int, int]]] = None
                     ) -> PagedServeState:
    """Fresh pool on ``device``.  Page 0 is the null page (scratch target
    for masked-out slots, never attended to), so ``n_pages - 1`` pages are
    allocatable: ``free_stack = [1..n_pages]`` with ``free_top =
    n_pages - 1``.

    ``shard`` maps a pool leaf to ``(dim, n)``: the leaf is allocated as
    one rank's block, its whole shape with ``dim`` divided by ``n`` (a
    mesh's ``model`` shard; ``distributed/sharding.py``).  ``device="meta"``
    gives the whole shapes without storage."""
    device = (torch.device("meta") if str(device) == "meta"
              else resolve_device(device))
    n_ring_pages = 1 + max_seqs * ring_pages if n_ring_layers else 1
    i32 = dict(dtype=torch.int32, device=device)
    shard = shard or {}

    def z(name, shape, dt=dtype):
        if name in shard:
            d, n = shard[name]
            if shape[d] % n:
                raise ValueError(f"{name} dim {d} of {shape} does not split "
                                 f"into {n} blocks")
            shape = shape[:d] + (shape[d] // n,) + shape[d + 1:]
        return torch.zeros(shape, dtype=dt, device=device)

    kv = (n_layers, n_pages, page_size, n_kv, head_dim)
    ring = (n_ring_layers, n_ring_pages, page_size, n_kv, head_dim)
    return PagedServeState(
        k_pages=z("k_pages", kv),
        v_pages=z("v_pages", kv),
        page_table=torch.zeros((max_seqs, max_pages_per_seq), **i32),
        seq_lens=torch.zeros((max_seqs,), **i32),
        slot_active=torch.zeros((max_seqs,), dtype=torch.bool, device=device),
        free_stack=torch.arange(1, n_pages + 1, **i32),
        free_top=torch.tensor(n_pages - 1, **i32),
        page_refcounts=torch.zeros((n_pages,), **i32),
        k_ring=z("k_ring", ring),
        v_ring=z("v_ring", ring),
        rg_h=z("rg_h", (n_rg, max_seqs, rnn_width), torch.float32),
        rg_conv=z("rg_conv", (n_rg, max_seqs, conv_width - 1, rnn_width)),
        ssm_state=z("ssm_state", (n_ssm, max_seqs, ssm_heads, ssm_proj,
                                  ssm_state_size), torch.float32),
        ssm_conv=z("ssm_conv", (n_ssm, max_seqs, ssm_conv_width - 1,
                                ssm_conv_ch)),
    )


def _padded(x: torch.Tensor) -> torch.Tensor:
    """``x`` with one scratch element appended: the landing spot for
    scatter lanes the reference drops."""
    return torch.cat([x, x.new_zeros((1,))])


def admit_slot(state: PagedServeState, slot: int) -> PagedServeState:
    """Enable a VB for ``slot`` (in place): clear its translation row and
    length but allocate NOTHING — backing pages arrive on first dirty
    writeback.  RECURRENT rows are zeroed; RING frames need no reset.
    Every write is a fill of a view with a scalar kernel argument, so the
    op enqueues work and reads nothing (it runs while a decode horizon is
    in flight, in the scheduler's overlap mode)."""
    state.page_table[slot].zero_()
    state.seq_lens[slot].zero_()
    state.slot_active[slot].fill_(True)
    state.rg_h[:, slot].zero_()
    state.rg_conv[:, slot].zero_()
    state.ssm_state[:, slot].zero_()
    state.ssm_conv[:, slot].zero_()
    return state


def release_slot(state: PagedServeState, slot: int) -> PagedServeState:
    """Disable ``slot``'s VB (in place): drop one reference on every mapped
    page and push only the pages whose refcount reaches zero onto the free
    stack.  Releasing an already-released slot (seq_lens == 0) is a no-op.
    Runs entirely on device."""
    ps, P, n = state.page_size, state.max_pages_per_seq, state.n_pages
    # clamp: a slot never maps more pages than its table row holds
    n_mapped = torch.clamp(torch.div(state.seq_lens[slot] + ps - 1, ps,
                                     rounding_mode="floor"), max=P)
    mapped = torch.arange(P, device=state.device) < n_mapped
    pages = state.page_table[slot].clone()
    refc = _padded(state.page_refcounts)
    refc.index_add_(0, torch.where(mapped, pages, n).long(),
                    torch.full((P,), -1, dtype=refc.dtype,
                               device=state.device))
    refc = refc[:n]
    # the null page 0 is never freeable
    freed = mapped & (pages != 0) & (refc[pages.long()] <= 0)
    freed_i = freed.to(torch.int32)
    dst = torch.where(freed, state.free_top + torch.cumsum(freed_i, 0) - 1, n)
    stack = _padded(state.free_stack)
    stack[dst.long()] = pages
    state.free_stack.copy_(stack[:n])
    state.free_top += freed_i.sum(dtype=torch.int32)
    state.page_refcounts.copy_(torch.clamp(refc, min=0))
    state.page_table[slot] = 0
    state.seq_lens[slot] = 0
    state.slot_active[slot] = False
    return state


# --------------------------------------------------------------------------
# prefix sharing: refcounted read-only mapping + copy-on-write clone (the
# serve-path re-instantiation of MTL.clone_vb).  Page-id lists reach these
# ops as device tensors padded to a row (``VBIAllocator._padded_ids``);
# counts, slots and lengths are host ints, passed to kernels as arguments.
# --------------------------------------------------------------------------
def map_prefix(state: PagedServeState, slot: int, page_ids: torch.Tensor,
               n_shared: int, n_tokens: int) -> PagedServeState:
    """Map ``page_ids[:n_shared]`` (already-filled prompt pages) read-only
    into ``slot``'s page table and set its length to ``n_tokens``, in place
    — one device scatter, no recompute, no allocation.  Each mapped page
    gains a reference; the slot never writes them (its next write position
    is the page boundary at ``n_tokens``)."""
    P, n = state.max_pages_per_seq, state.n_pages
    shared = torch.arange(P, device=state.device) < n_shared
    refc = _padded(state.page_refcounts)
    refc.index_add_(0, torch.where(shared, page_ids, n).long(),
                    torch.ones((P,), dtype=refc.dtype, device=state.device))
    state.page_refcounts.copy_(refc[:n])
    state.page_table[slot].copy_(torch.where(shared, page_ids, 0))
    state.seq_lens[slot].fill_(n_tokens)
    state.slot_active[slot].fill_(True)
    return state


def clone_page_cow(state: PagedServeState, slot: int, page_idx: int,
                   src_page: int, new_len: int) -> PagedServeState:
    """Copy-on-write break for a *partially* shared page, in place: pop a
    fresh page off the device free stack, copy ``src_page``'s K/V into it
    for every full-attention layer, install it at ``page_table[slot,
    page_idx]`` and set the slot's length to ``new_len`` (the matched
    token count).  The source page keeps its references (the cache still
    owns it); the clone belongs to the slot, which overwrites the
    unmatched tail as prefill proceeds.  The popped id never leaves the
    device: it is read from ``free_stack[free_top - 1]`` as a one-element
    index tensor."""
    dev = state.device
    top = (state.free_top - 1).reshape(1).long()
    dst = state.free_stack.index_select(0, top)                    # [1]
    dst_l = dst.long()
    src = torch.full((1,), src_page, dtype=torch.long, device=dev)
    state.k_pages.index_copy_(1, dst_l, state.k_pages.index_select(1, src))
    state.v_pages.index_copy_(1, dst_l, state.v_pages.index_select(1, src))
    state.page_table[slot, page_idx:page_idx + 1].copy_(dst)
    state.seq_lens[slot].fill_(new_len)
    state.free_top.sub_(1)
    # index_fill_ takes the scalar as a kernel argument (an indexed
    # assignment of a Python scalar would copy it from the host and sync)
    state.page_refcounts.index_fill_(0, dst_l, 1)
    return state


def retain_pages(state: PagedServeState, page_ids: torch.Tensor,
                 n: int) -> PagedServeState:
    """Add one reference to ``page_ids[:n]``, in place — the prefix cache
    taking custody of freshly prefilled prompt pages so they outlive the
    slot."""
    held = torch.arange(page_ids.shape[0], device=state.device) < n
    refc = _padded(state.page_refcounts)
    refc.index_add_(0, torch.where(held, page_ids, state.n_pages).long(),
                    torch.ones(page_ids.shape, dtype=refc.dtype,
                               device=state.device))
    state.page_refcounts.copy_(refc[:state.n_pages])
    return state


def release_pages(state: PagedServeState, page_ids: torch.Tensor,
                  n: int) -> PagedServeState:
    """Drop one reference on ``page_ids[:n]`` (prefix-cache eviction), in
    place; pages reaching refcount zero return to the free stack."""
    n_pages = state.n_pages
    held = torch.arange(page_ids.shape[0], device=state.device) < n
    refc = _padded(state.page_refcounts)
    refc.index_add_(0, torch.where(held, page_ids, n_pages).long(),
                    torch.full(page_ids.shape, -1, dtype=refc.dtype,
                               device=state.device))
    refc = refc[:n_pages]
    freed = held & (refc[page_ids.long()] <= 0)
    freed_i = freed.to(torch.int32)
    dst = torch.where(freed, state.free_top + torch.cumsum(freed_i, 0) - 1,
                      n_pages)
    stack = _padded(state.free_stack)
    stack[dst.long()] = page_ids
    state.free_stack.copy_(stack[:n_pages])
    state.free_top += freed_i.sum(dtype=torch.int32)
    state.page_refcounts.copy_(torch.clamp(refc, min=0))
    return state


# --------------------------------------------------------------------------
# host swap tier: gather a block's device pages for a host copy and restore
# them with one scatter (the serve-path form of MTL.swap_out/swap_in; see
# blocks.py::VBIAllocator)
# --------------------------------------------------------------------------
def snapshot_block(state: PagedServeState, slot: int, n_pages: int,
                   shardings: Optional[Dict] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather the K/V of ``slot``'s first ``n_pages`` mapped pages (the
    reference gathers the whole row and slices it on the host): two
    device tensors of shape [n_layers, n_pages, page_size, n_kv,
    head_dim].  Enqueues a gather only; the caller copies the result to
    the host before it releases the slot.  On a mesh (``shardings``, the
    engine's ``{field: Sharding}``) each rank gathers its block and an
    all-gather over the sharded dim makes the whole pages on every
    rank."""
    pages = state.page_table[slot, :n_pages].long()
    k = state.k_pages.index_select(1, pages)
    v = state.v_pages.index_select(1, pages)
    if shardings is not None:
        k = shardings["k_pages"].whole(k)
        v = shardings["v_pages"].whole(v)
    return k, v


def restore_block(state: PagedServeState, slot: int, k_blk: torch.Tensor,
                  v_blk: torch.Tensor, n_pages: int, n_tokens: int,
                  shardings: Optional[Dict] = None) -> PagedServeState:
    """Swap-in, in place: pop ``n_pages`` pages off the device free stack
    (``free_stack[free_top - 1 - i]`` for page ``i``), install them as
    ``slot``'s page-table row and scatter the image's K/V (``k_blk``/
    ``v_blk`` on the device, [n_layers, >= n_pages, ...]) into them.  The
    restored pages are private: refcount 1, owned by the slot.  On a mesh
    (``shardings``) the image is whole and each rank scatters its block.

    Enqueues work only: the popped ids never leave the device, and every
    write is an index op or a fill of a view, so it can run while a decode
    horizon is in flight."""
    dev = state.device
    if shardings is not None:
        k_blk = shardings["k_pages"].local(k_blk)
        v_blk = shardings["v_pages"].local(v_blk)
    if n_pages:
        src = state.free_top - 1 - torch.arange(n_pages, device=dev)
        pages = state.free_stack.index_select(0, src.long())      # [n]
        pages_l = pages.long()
        state.k_pages.index_copy_(
            1, pages_l, k_blk[:, :n_pages].to(state.k_pages.dtype))
        state.v_pages.index_copy_(
            1, pages_l, v_blk[:, :n_pages].to(state.v_pages.dtype))
        state.page_refcounts.index_fill_(0, pages_l, 1)
        state.free_top.sub_(n_pages)
    state.page_table[slot].zero_()
    if n_pages:
        state.page_table[slot, :n_pages].copy_(pages)
    state.seq_lens[slot].fill_(n_tokens)
    state.slot_active[slot].fill_(True)
    return state


def pad_block_image(k: np.ndarray, v: np.ndarray, n_pages: int,
                    max_pages: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a host K/V page image ([n_layers, n_pages, ...]) to a
    destination pool's row width.  The image's geometry describes itself,
    so the destination only needs its pages to fit one row: its pool size
    and slot count may differ from the source's."""
    if n_pages > max_pages:
        raise ValueError(f"image holds {n_pages} pages > destination row "
                         f"width {max_pages}")
    kp = np.zeros((k.shape[0], max_pages) + k.shape[2:], k.dtype)
    vp = np.zeros_like(kp)
    kp[:, :n_pages] = k
    vp[:, :n_pages] = v
    return kp, vp


def kv_payload_checksum(k: np.ndarray, v: np.ndarray,
                        aux: Optional[Tuple[np.ndarray, ...]] = None) -> int:
    """CRC-32 over a block image's device-state payload, chained in a fixed
    order: K pages, V pages, then each RING/RECURRENT aux array — a pure
    function of the state ``restore_block``/``restore_aux`` would scatter
    back (the same digest as the reference's for the same bytes)."""
    crc = zlib.crc32(np.ascontiguousarray(k).tobytes())
    crc = zlib.crc32(np.ascontiguousarray(v).tobytes(), crc)
    for arr in (aux or ()):
        crc = zlib.crc32(np.ascontiguousarray(arr).tobytes(), crc)
    return crc & 0xFFFFFFFF


#: the aux image's arrays, in order, and how many leading dims of each
#: pool leaf the snapshot indexes away (the slot dim of a recurrent row)
_AUX_FIELDS = (("k_ring", 0), ("v_ring", 0), ("rg_h", 1), ("rg_conv", 1),
              ("ssm_state", 1), ("ssm_conv", 1))


def snapshot_aux(state: PagedServeState, slot: int, ring_row: torch.Tensor,
                 shardings: Optional[Dict] = None
                 ) -> Tuple[torch.Tensor, ...]:
    """Gather ``slot``'s RING frames (through its static ring row,
    [ring_pages] int32 on the device) and RECURRENT rows: (k_ring, v_ring,
    rg_h, rg_conv, ssm_state, ssm_conv), O(window) + O(1) whatever the
    block's length.  Enqueues gathers only; on a mesh (``shardings``) an
    all-gather per sharded array makes each whole on every rank."""
    row = ring_row.long()
    out = (state.k_ring.index_select(1, row),
           state.v_ring.index_select(1, row),
           state.rg_h[:, slot], state.rg_conv[:, slot],
           state.ssm_state[:, slot], state.ssm_conv[:, slot])
    if shardings is None:
        return out
    return tuple(shardings[name].whole(a, drop)
                 for a, (name, drop) in zip(out, _AUX_FIELDS))


def restore_aux(state: PagedServeState, slot: int, ring_row: torch.Tensor,
                k_ring_blk: torch.Tensor, v_ring_blk: torch.Tensor,
                rg_h: torch.Tensor, rg_conv: torch.Tensor,
                ssm_state: torch.Tensor, ssm_conv: torch.Tensor,
                shardings: Optional[Dict] = None) -> PagedServeState:
    """Swap-in of :func:`snapshot_aux`'s arrays (device tensors), in
    place: the ring frames into ``slot``'s static ring row, the recurrent
    state into its rows — which may be another slot's than the one they
    were gathered from.  Index copies and view copies only; on a mesh
    (``shardings``) the arrays are whole and each rank writes its
    block."""
    if shardings is not None:
        k_ring_blk, v_ring_blk, rg_h, rg_conv, ssm_state, ssm_conv = (
            shardings[name].local(a, drop) for a, (name, drop) in zip(
                (k_ring_blk, v_ring_blk, rg_h, rg_conv, ssm_state,
                 ssm_conv), _AUX_FIELDS))
    row = ring_row.long()
    state.k_ring.index_copy_(1, row, k_ring_blk.to(state.k_ring.dtype))
    state.v_ring.index_copy_(1, row, v_ring_blk.to(state.v_ring.dtype))
    state.rg_h[:, slot].copy_(rg_h)
    state.rg_conv[:, slot].copy_(rg_conv)
    state.ssm_state[:, slot].copy_(ssm_state)
    state.ssm_conv[:, slot].copy_(ssm_conv)
    return state


def reserve_positions(state: PagedServeState, slot_mask: torch.Tensor,
                      has_full: bool = True
                      ) -> Tuple[PagedServeState, torch.Tensor]:
    """Reserve the next token position for every masked slot — "allocate
    on first dirty writeback" resolved on device, in place.

    A slot whose next position opens a fresh page pops one from the free
    stack; all pops of one step are resolved with a single cumsum (no
    loop, no host read).  Returns (state, positions) where positions[i] is
    where slot i's K/V land this step.  The scheduler guarantees that the
    stack never underflows (its host mirror counts pages exactly).
    ``has_full=False`` is the fast path of stacks with no full-attention
    layer: no page is ever popped, positions just advance."""
    positions = state.seq_lens.clone()
    if not has_full:
        state.seq_lens += slot_mask.to(torch.int32)
        return state, positions
    ps, P, n = state.page_size, state.max_pages_per_seq, state.n_pages
    needs = slot_mask & (positions % ps == 0)
    needs_i = needs.to(torch.int32)
    order = torch.cumsum(needs_i, 0) - needs_i              # pop order
    src = torch.clamp(state.free_top - 1 - order, min=0)
    new_pages = state.free_stack[src.long()]
    rows = torch.arange(state.max_seqs, device=state.device)
    page_idx = torch.div(positions, ps, rounding_mode="floor")
    # a slot at the end of its row has no next page: the reference drops
    # that write, here it is masked off and its row left untouched
    col = torch.clamp(page_idx, max=P - 1).long()
    cur = state.page_table[rows, col]
    state.page_table[rows, col] = torch.where(needs & (page_idx < P),
                                              new_pages, cur)
    # a freshly popped page starts with exactly one mapper (its slot)
    # (index_fill_ takes the scalar on the device side: an indexed
    # assignment of a Python scalar copies it from the host and syncs)
    refc = _padded(state.page_refcounts)
    refc.index_fill_(0, torch.where(needs, new_pages, n).long(), 1)
    state.page_refcounts.copy_(refc[:n])
    state.seq_lens += slot_mask.to(torch.int32)
    state.free_top -= needs_i.sum(dtype=torch.int32)
    return state, positions


def write_token_kv(k_pages: torch.Tensor, v_pages: torch.Tensor, layer: int,
                   page_table: torch.Tensor, positions: torch.Tensor,
                   slot_mask: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter one decode step's K/V ([max_seqs, n_kv, head_dim]) for one
    layer into the page pool, in place.  Masked-out slots all write into
    the null page 0, in no defined order; page 0 is never attended."""
    ps, P = k_pages.shape[2], page_table.shape[1]
    rows = torch.arange(page_table.shape[0], device=page_table.device)
    col = torch.clamp(torch.div(positions, ps, rounding_mode="floor"),
                      max=P - 1).long()
    page = torch.where(slot_mask, page_table[rows, col], 0).long()
    slot_in_page = (positions % ps).long()
    k_pages[layer, page, slot_in_page] = k.to(k_pages.dtype)
    v_pages[layer, page, slot_in_page] = v.to(v_pages.dtype)
    return k_pages, v_pages


def fused_decode_scan(token_step: Callable, state: PagedServeState,
                      tokens: torch.Tensor, slot_mask: torch.Tensor,
                      steps_left: torch.Tensor, length: int,
                      eos_id: int = -1) -> Tuple[torch.Tensor,
                                                 PagedServeState]:
    """The fused decode horizon: ``length`` token steps with greedy
    sampling, token feedback and per-slot stop masking all on device.

    ``token_step(state, tokens, mask) -> (logits, state)`` is run
    ``length`` times; each step argmaxes its logits on device (first of
    equal maxima), feeds the winner back, and retires slots whose budget
    (``steps_left``) is spent or that emitted ``eos_id``.  A retired slot's
    remaining steps are fully masked: no KV write, no ``seq_lens`` bump,
    no page pop.  Returns ``(block, state)`` with ``block[k, s]`` the token
    slot ``s`` emitted at step ``k``, or ``-1`` on masked lanes.  Nothing
    is read back to the host."""
    toks = tokens
    left = steps_left
    stopped = torch.zeros_like(slot_mask)
    emitted = []
    for _ in range(length):
        active = slot_mask & (left > 0) & ~stopped
        logits, state = token_step(state, toks, active)
        nxt = torch.argmax(logits[:, 0], -1).to(torch.int32)
        emitted.append(torch.where(active, nxt, -1))
        stopped = stopped | (active & (nxt == eos_id))
        toks = torch.where(active, nxt, toks)
        left = left - active.to(torch.int32)
    return torch.stack(emitted), state


# --------------------------------------------------------------------------
# the legacy per-sequence KV state and its manager (the pre-VBI MTL): the
# oracle of the allocator's reservation arithmetic
# --------------------------------------------------------------------------
@dataclasses.dataclass
class PagedKVState:
    """k_pages, v_pages [n_layers, n_pages, page_size, n_kv, head_dim];
    page_table [max_seqs, max_pages_per_seq] int32; seq_lens [max_seqs]
    int32."""
    k_pages: torch.Tensor
    v_pages: torch.Tensor
    page_table: torch.Tensor
    seq_lens: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[2]


def _put_token(pages: torch.Tensor, layers: torch.Tensor,
               page: torch.Tensor, slot: torch.Tensor,
               x: torch.Tensor) -> None:
    """``pages[l, page, slot] = x[i]`` for ``l = layers[i]``, with the
    page and slot as device scalars (no host read)."""
    shape = layers.shape
    pages.index_put_((layers, page.expand(shape), slot.expand(shape)),
                     x.to(pages.dtype))


def append_kv(state: PagedKVState, seq_idx: int, k: torch.Tensor,
              v: torch.Tensor) -> PagedKVState:
    """Write one token's K/V ([n_layers, n_kv, head_dim]) for sequence
    ``seq_idx`` at its current length and bump its length, in place."""
    ps = state.page_size
    pos = state.seq_lens[seq_idx].long()
    page = state.page_table[seq_idx].index_select(0, (pos // ps)[None]).long()
    layers = torch.arange(state.k_pages.shape[0],
                          device=state.k_pages.device)
    _put_token(state.k_pages, layers, page, pos % ps, k)
    _put_token(state.v_pages, layers, page, pos % ps, v)
    state.seq_lens[seq_idx].add_(1)
    return state


def _write_layer_kv(state: PagedKVState, seq_idx: int, layer: int,
                    k: torch.Tensor, v: torch.Tensor) -> PagedKVState:
    """Write one layer's K/V ([n_kv, head_dim]) at the position the last
    ``begin_token`` reserved (``seq_lens - 1``), in place."""
    ps = state.page_size
    pos = state.seq_lens[seq_idx].long() - 1
    page = state.page_table[seq_idx].index_select(0, (pos // ps)[None]).long()
    layers = torch.tensor([layer], device=state.k_pages.device)
    _put_token(state.k_pages, layers, page, pos % ps, k[None])
    _put_token(state.v_pages, layers, page, pos % ps, v[None])
    return state


def gather_kv(state: PagedKVState, seq_idx: int, layer: int,
              max_pages: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One sequence's K/V for one layer: (k, v, valid_mask), k and v of
    shape [max_pages * page_size, n_kv, head_dim]."""
    pages = state.page_table[seq_idx, :max_pages].long()
    k = state.k_pages[layer].index_select(0, pages)
    v = state.v_pages[layer].index_select(0, pages)
    n = max_pages * state.page_size
    k = k.reshape(n, *k.shape[2:])
    v = v.reshape(n, *v.shape[2:])
    mask = torch.arange(n, device=k.device) < state.seq_lens[seq_idx]
    return k, v, mask


class PagedKVManager:
    """The MTL for the KV address space, host policy of the legacy
    per-sequence path: a host free list, power-of-4 size classes promoted
    on growth, pages allocated physically as tokens arrive.  ``append`` and
    ``begin_token`` read the sequence's length from the device."""

    SIZE_CLASS_PAGES = (1, 4, 16, 64, 256, 1024)

    def __init__(self, n_layers: int, n_pages: int, page_size: int,
                 n_kv: int, head_dim: int, max_seqs: int,
                 dtype=torch.bfloat16, mtl: Optional[MTL] = None,
                 device: Union[str, torch.device] = "cuda"):
        dev = resolve_device(device)
        self.page_size = page_size
        self.n_pages = n_pages
        self.max_seqs = max_seqs
        self.max_pages_per_seq = self.SIZE_CLASS_PAGES[-1]
        self.free_pages: List[int] = list(range(1, n_pages))  # page 0 null
        self.seq_class = np.full(max_seqs, -1, np.int32)      # class index
        self.seq_pages: List[List[int]] = [[] for _ in range(max_seqs)]
        self.seq_vbid = np.full(max_seqs, -1, np.int64)
        self.mtl = mtl or MTL(PhysicalMemory(1 << 12))
        self.stats = {"promotions": 0, "delayed_page_allocs": 0,
                      "released_pages": 0}
        shape = (n_layers, n_pages, page_size, n_kv, head_dim)
        self.state = PagedKVState(
            k_pages=torch.zeros(shape, dtype=dtype, device=dev),
            v_pages=torch.zeros(shape, dtype=dtype, device=dev),
            page_table=torch.zeros((max_seqs, self.max_pages_per_seq),
                                   dtype=torch.int32, device=dev),
            seq_lens=torch.zeros((max_seqs,), dtype=torch.int32,
                                 device=dev))

    # -- VB lifecycle --------------------------------------------------------
    def new_seq(self, seq_idx: int) -> None:
        """Enable the sequence's VB in the smallest class; allocates
        NOTHING (pages arrive on first append)."""
        if self.seq_class[seq_idx] != -1:
            raise ValueError(f"slot {seq_idx} is busy")
        self.seq_class[seq_idx] = 0
        self.seq_vbid[seq_idx] = self.mtl.enable_vb(0, VBProps.KV_CACHE)
        self.state.page_table[seq_idx].zero_()
        self.state.seq_lens[seq_idx].zero_()

    def release_seq(self, seq_idx: int) -> None:
        """Return the sequence's pages to the free list; a double release
        is a no-op."""
        if self.seq_class[seq_idx] == -1:
            return
        self.free_pages.extend(self.seq_pages[seq_idx])
        self.stats["released_pages"] += len(self.seq_pages[seq_idx])
        self.seq_pages[seq_idx] = []
        self.seq_class[seq_idx] = -1
        self.mtl.disable_vb(0, int(self.seq_vbid[seq_idx]))
        self.seq_vbid[seq_idx] = -1

    def _capacity_pages(self, seq_idx: int) -> int:
        return self.SIZE_CLASS_PAGES[self.seq_class[seq_idx]]

    def ensure_capacity(self, seq_idx: int, new_len: int) -> None:
        """Delayed allocation and promotion before ``new_len`` tokens."""
        need_pages = -(-new_len // self.page_size)
        while need_pages > self._capacity_pages(seq_idx):
            self.seq_class[seq_idx] += 1                # promote_vb
            self.stats["promotions"] += 1
        have = len(self.seq_pages[seq_idx])
        while have < need_pages:
            if not self.free_pages:
                raise RuntimeError("KV pool exhausted (evict first)")
            page = self.free_pages.pop()
            self.state.page_table[seq_idx, have].fill_(page)
            self.seq_pages[seq_idx].append(page)
            self.stats["delayed_page_allocs"] += 1
            have += 1

    # -- the per-token path --------------------------------------------------
    def append(self, seq_idx: int, k: torch.Tensor, v: torch.Tensor) -> None:
        cur = int(self.state.seq_lens[seq_idx])
        self.ensure_capacity(seq_idx, cur + 1)
        append_kv(self.state, seq_idx, k, v)

    def begin_token(self, seq_idx: int) -> int:
        """Reserve the next position (delayed page allocation happens here)
        and return it; ``write_layer`` then fills each layer's K/V."""
        cur = int(self.state.seq_lens[seq_idx])
        self.ensure_capacity(seq_idx, cur + 1)
        self.state.seq_lens[seq_idx].add_(1)
        return cur

    def write_layer(self, seq_idx: int, layer: int, k: torch.Tensor,
                    v: torch.Tensor) -> None:
        """k, v [n_kv, head_dim] for the position ``begin_token`` gave."""
        _write_layer_kv(self.state, seq_idx, layer, k, v)

    def gather(self, seq_idx: int, layer: int,
               max_pages: Optional[int] = None):
        mp = max_pages or self._capacity_pages(seq_idx)
        return gather_kv(self.state, seq_idx, layer, mp)

    @property
    def pages_in_use(self) -> int:
        return self.n_pages - 1 - len(self.free_pages)
