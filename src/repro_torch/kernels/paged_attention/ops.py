"""Batched paged decode attention: the hand-written Hopper kernel
(``csrc/paged_attention.cu``) and its wrapper.

:func:`paged_attention` takes every slot at once.  On a CUDA tensor it
launches the kernel — or raises; on a CPU tensor it runs the plain twin
(:func:`~repro_torch.kernels.paged_attention.ref.ref_paged_attention`, one
sequence at a time).  There is no fallback from one to the other.

The kernel is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C entry point, loaded with ``ctypes``, by the
port's shared builder (``repro_torch.kernels._build``).
:func:`paged_decode_attention` is the legacy per-sequence path's call
into the same kernel (``serve/paged.py``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import _build
from .ref import ref_paged_attention

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
#: largest head_dim the kernel takes (two float4 per lane) and warps per
#: block (``splits``)
MAX_HEAD_DIM = 256
MAX_WARPS = 16
#: the plan's warps per block and blocks per SM: at 128 registers a
#: thread an SM holds two blocks of 8 warps, as many warps as one block of
#: 16, and short sequences launch fewer idle warps
PLAN_WARPS = 8
BLOCKS_PER_SM = 2
#: least tokens a block takes when a sequence is split over the planned
#: blocks (``chunk`` in the kernel; a forced ``blocks`` takes one tile)
CHUNK = 64
#: grid limit on the blocks per (kv head, slot) and on the slots
MAX_GRID_YZ = 65535


def tile_tokens(d: int) -> int:
    """Tokens per tile (``T`` in the kernel): one float4 per lane per row
    up to d = 128, two up to 256, with the tile's K/V bytes held alike."""
    return 4 if d <= 128 else 2


def rows_per_block(g: int, d: int) -> Tuple[int, int]:
    """(G, row groups): a block takes G query rows of a GQA group, G a
    power of two up to 4 (2 past d = 128), so ceil(g / G) blocks share
    each kv head's K/V; rows past g are masked."""
    g_max = 4 if d <= 128 else 2
    groups = -(-g // g_max)
    return 1 << (-(-g // groups) - 1).bit_length(), groups


def split_plan(S: int, n_kv: int, max_pages: int, ps: int, n_sm: int) -> int:
    """P, the blocks per (kv head, slot), from host ints only: enough to
    fill every SM with ``BLOCKS_PER_SM`` blocks when all ``S x n_kv``
    columns are long, no more than the longest sequence (``max_pages x
    ps`` tokens) has chunks of ``CHUNK``.  The kernel uses as many of them
    as each seq_len needs."""
    chunks = -(-max_pages * ps // CHUNK)
    return max(1, min(chunks, BLOCKS_PER_SM * n_sm // (S * n_kv),
                      MAX_GRID_YZ))


def default_warps(max_pages: int, ps: int, d: int, blocks: int) -> int:
    """Warps per block: one per pair of tiles of the longest span a block
    can get (under ``2 x CHUNK`` tokens, or a P-th of ``max_pages x ps``),
    up to ``PLAN_WARPS``; the kernel hands tiles to warps in pairs, and
    warps without a tile exit at once."""
    T = tile_tokens(d)
    tiles = -(-max_pages * ps // T)
    span = min(tiles, max(2 * CHUNK // T, -(-tiles // blocks)))
    return max(1, min(PLAN_WARPS, -(-span // 2)))


def blocks_used(seq_len: int, blocks: int, max_pages: int, ps: int,
                d: int, chunk: int = CHUNK) -> int:
    """How many of the ``blocks`` blocks of one (kv head, slot) the kernel
    gives work at this seq_len (the count it works out on the device)."""
    T = tile_tokens(d)
    n_tok = min(max(seq_len, 0), max_pages * ps)
    tiles = -(-n_tok // T)
    if tiles == 0:
        return 1
    nb = min(blocks, max(1, n_tok // chunk))
    return -(-tiles // -(-tiles // nb))


def build_kernel() -> Tuple[Path, str]:
    """Compile the kernel library if this source and these flags have not
    been built yet.  Returns (library path, compiler log); the log holds
    ``ptxas`` register, shared-memory and spill counts."""
    return _build.build(SOURCE, "paged_attention")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE, "paged_attention")
    fn = lib.repro_paged_attention_f32
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, p, p, p, p] + [i] * 11 + [p]
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


#: (device, stream) -> (workspace f32, counters i32) of the split launches
#: on that stream.  Launches on one stream run one after another and each
#: leaves its counters at 0, so they share them; another stream gets its
#: own.  Grown, never shrunk.
_scratch: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device: torch.device, stream: int, n_floats: int,
               n_counters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (device.index, stream)
    ws, cnt = _scratch.get(key, (None, None))
    if ws is None or ws.numel() < n_floats:
        ws = torch.empty(n_floats, dtype=torch.float32, device=device)
    if cnt is None or cnt.numel() < n_counters:
        cnt = torch.zeros(n_counters, dtype=torch.int32, device=device)
    _scratch[key] = (ws, cnt)
    return ws, cnt


def _plain(q, k_pages, v_pages, page_table, seq_lens, max_pages):
    pts = page_table[:, :max_pages]
    return torch.stack([
        ref_paged_attention(pts[s], seq_lens[s:s + 1], q[s], k_pages,
                            v_pages) for s in range(q.shape[0])])


def _positive(name, value, most) -> None:
    if value is not None and (not isinstance(value, int)
                              or not 1 <= value <= most):
        raise ValueError(f"{name} must be an int in [1, {most}], got "
                         f"{value!r}")


def _check_cuda_args(q, k_pages, v_pages, page_table, seq_lens,
                     max_pages, splits, blocks) -> None:
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("seq_lens", seq_lens)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (float4 loads)")
    for name, t in (("page_table", page_table), ("seq_lens", seq_lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError("q must be [S, n_kv, g, d] and k/v_pages "
                         "[n_pages, ps, n_kv, d]")
    S, n_kv, g, d = q.shape
    if k_pages.shape != v_pages.shape or k_pages.shape[2:] != (n_kv, d):
        raise ValueError(f"k/v_pages {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    _positive("splits", splits, MAX_WARPS)
    _positive("blocks", blocks, MAX_GRID_YZ)
    if d > MAX_HEAD_DIM or d % 4 or S > MAX_GRID_YZ:
        raise ValueError(f"head_dim {d} (a multiple of 4 up to "
                         f"{MAX_HEAD_DIM}) or {S} slots (up to "
                         f"{MAX_GRID_YZ}) is not supported by the kernel")
    if (page_table.dim() != 2 or page_table.shape[0] != S
            or page_table.stride(1) != 1):
        raise ValueError("page_table must be [S, width] with unit column "
                         "stride")
    if seq_lens.shape != (S,) or not seq_lens.is_contiguous():
        raise ValueError(f"seq_lens must be a contiguous [{S}] tensor")
    if not isinstance(max_pages, int) or not (
            1 <= max_pages <= page_table.shape[1]):
        raise ValueError(f"max_pages must be a Python int in "
                         f"[1, {page_table.shape[1]}], got {max_pages!r}")
    if max_pages * k_pages.shape[1] > 1 << 30:
        raise ValueError("max_pages x page size must be at most 2^30 tokens")
    if k_pages.shape[0] * k_pages.shape[1] >= 1 << 31:
        raise ValueError("the pool must hold fewer than 2^31 token rows")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    seq_lens: torch.Tensor, max_pages: int, *,
                    splits: Optional[int] = None,
                    blocks: Optional[int] = None) -> torch.Tensor:
    """All slots at once, translation through the device page table.

    q [S, n_kv, g, d] (pre-scaled f32); k/v_pages [n_pages, ps, n_kv, d];
    page_table [S, width] int32 of which the first ``max_pages`` columns
    are read (the row stride goes to the kernel, so a column slice needs
    no copy); seq_lens [S] int32 → out [S, n_kv, g, d] f32.

    ``max_pages`` is a Python int so that no launch needs a host read of
    device state.  ``splits`` is the number of warps that share one (kv
    head, slot)'s tokens inside a block, up to ``MAX_WARPS`` = 16 (None:
    :func:`default_warps`).  ``blocks`` is P, the blocks per (kv head,
    slot): None plans it for this card (:func:`split_plan`) and gives a
    sequence one block per ``CHUNK`` tokens, up to P; a forced P gives it
    one per tile, up to P, so that short sequences reach the merge too.
    One launch merges them.  ``paged_attention.launches`` counts kernel
    launches."""
    if q.device.type == "cpu":
        return _plain(q, k_pages, v_pages, page_table, seq_lens, max_pages)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on CUDA or CPU tensors, "
                         f"got {q.device}")
    _check_cuda_args(q, k_pages, v_pages, page_table, seq_lens, max_pages,
                     splits, blocks)
    S, n_kv, g, d = q.shape
    ps = k_pages.shape[1]
    rows, groups = rows_per_block(g, d)
    cols = n_kv * groups
    chunk = CHUNK if blocks is None else tile_tokens(d)
    n_sm = _sm_count(q.device.index)
    if blocks is None:
        blocks = split_plan(S, cols, max_pages, ps, n_sm)
    warps = splits or default_warps(max_pages, ps, d, blocks)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws_ptr = cnt_ptr = None
    if blocks > 1:
        ws, cnt = _workspace(q.device, stream,
                             S * cols * blocks * rows * (d + 2), S * cols)
        ws_ptr, cnt_ptr = ws.data_ptr(), cnt.data_ptr()
    out = torch.empty_like(q)
    rc = _library().repro_paged_attention_f32(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), page_table.stride(0), seq_lens.data_ptr(),
        out.data_ptr(), ws_ptr, cnt_ptr, S, n_kv, g, d, ps, max_pages, rows,
        warps, blocks, chunk, n_sm, stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed with CUDA "
                           f"error {rc}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def paged_decode_attention(q: torch.Tensor, state, layer: int, n_kv: int,
                           seq_ids=None,
                           max_pages: Optional[int] = None) -> torch.Tensor:
    """One decode step of the legacy per-sequence path (the reference's
    ``paged_decode_attention``): q [b, n_q, d], sequence ``i`` reading
    page-table row ``seq_ids[i]`` (default ``0..b-1``) of the
    ``PagedKVState`` ``state`` in layer ``layer`` → [b, n_q, d] float32.

    q is scaled by 1/sqrt(d) in float32 and grouped [b, n_kv, g, d]; the
    rows and lengths of ``seq_ids`` are taken on the device
    (``index_select``), with no host read of device state, and the first
    ``max_pages`` columns of the rows (default: all of them) go to
    :func:`paged_attention` by row stride: the kernel on CUDA tensors,
    its plain twin on CPU tensors.  ``seq_ids`` is a list of ints or an
    index tensor."""
    b, n_q, dh = q.shape
    scale = float(np.float32(1.0) / np.sqrt(np.float32(dh)))
    qg = (q.float() * scale).reshape(b, n_kv, n_q // n_kv, dh).contiguous()
    table, lens = state.page_table, state.seq_lens
    if seq_ids is None:
        table, lens = table[:b], lens[:b]
    else:
        ids = torch.as_tensor(seq_ids, dtype=torch.long, device=q.device)
        table, lens = table.index_select(0, ids), lens.index_select(0, ids)
    out = paged_attention(qg, state.k_pages[layer], state.v_pages[layer],
                          table, lens, max_pages or table.shape[1])
    return out.reshape(b, n_q, dh)
