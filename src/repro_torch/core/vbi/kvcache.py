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
stays free of synchronisation.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple, Union

import numpy as np
import torch

from ...device import resolve_device


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


def init_serve_state(n_layers: int, n_pages: int, page_size: int, n_kv: int,
                     head_dim: int, max_seqs: int, max_pages_per_seq: int,
                     dtype=torch.float32, n_ring_layers: int = 0,
                     ring_pages: int = 0, n_rg: int = 0, rnn_width: int = 0,
                     conv_width: int = 4, n_ssm: int = 0, ssm_heads: int = 0,
                     ssm_proj: int = 0, ssm_state_size: int = 0,
                     ssm_conv_ch: int = 0, ssm_conv_width: int = 4,
                     device: Union[str, torch.device] = "cuda"
                     ) -> PagedServeState:
    """Fresh pool on ``device``.  Page 0 is the null page (scratch target
    for masked-out slots, never attended to), so ``n_pages - 1`` pages are
    allocatable: ``free_stack = [1..n_pages]`` with ``free_top =
    n_pages - 1``."""
    device = resolve_device(device)
    n_ring_pages = 1 + max_seqs * ring_pages if n_ring_layers else 1
    i32 = dict(dtype=torch.int32, device=device)

    def z(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return PagedServeState(
        k_pages=z((n_layers, n_pages, page_size, n_kv, head_dim)),
        v_pages=z((n_layers, n_pages, page_size, n_kv, head_dim)),
        page_table=torch.zeros((max_seqs, max_pages_per_seq), **i32),
        seq_lens=torch.zeros((max_seqs,), **i32),
        slot_active=torch.zeros((max_seqs,), dtype=torch.bool, device=device),
        free_stack=torch.arange(1, n_pages + 1, **i32),
        free_top=torch.tensor(n_pages - 1, **i32),
        page_refcounts=torch.zeros((n_pages,), **i32),
        k_ring=z((n_ring_layers, n_ring_pages, page_size, n_kv, head_dim)),
        v_ring=z((n_ring_layers, n_ring_pages, page_size, n_kv, head_dim)),
        rg_h=z((n_rg, max_seqs, rnn_width), torch.float32),
        rg_conv=z((n_rg, max_seqs, conv_width - 1, rnn_width)),
        ssm_state=z((n_ssm, max_seqs, ssm_heads, ssm_proj, ssm_state_size),
                    torch.float32),
        ssm_conv=z((n_ssm, max_seqs, ssm_conv_width - 1, ssm_conv_ch)),
    )


def _padded(x: torch.Tensor) -> torch.Tensor:
    """``x`` with one scratch element appended: the landing spot for
    scatter lanes the reference drops."""
    return torch.cat([x, x.new_zeros((1,))])


def admit_slot(state: PagedServeState, slot: int) -> PagedServeState:
    """Enable a VB for ``slot`` (in place): clear its translation row and
    length but allocate NOTHING — backing pages arrive on first dirty
    writeback.  RECURRENT rows are zeroed; RING frames need no reset."""
    state.page_table[slot] = 0
    state.seq_lens[slot] = 0
    state.slot_active[slot] = True
    state.rg_h[:, slot] = 0.0
    state.rg_conv[:, slot] = 0.0
    state.ssm_state[:, slot] = 0.0
    state.ssm_conv[:, slot] = 0.0
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
