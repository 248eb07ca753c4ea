"""Batched paged decode attention: the hand-written Hopper kernel
(``csrc/paged_attention.cu``) and its wrapper.

:func:`paged_attention` takes every slot at once.  On a CUDA tensor it
launches the kernel — or raises; on a CPU tensor it runs the plain twin
(:func:`~repro_torch.kernels.paged_attention.ref.ref_paged_attention`, one
sequence at a time).  There is no fallback from one to the other.

The kernel is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C entry point, loaded with ``ctypes``, by the
port's shared builder (``repro_torch.kernels._build``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch

from .. import _build
from .ref import ref_paged_attention

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
#: largest head_dim (8 elements per lane) and warps per block the kernel
#: takes; a block holds group x splits warps
MAX_HEAD_DIM = 256
MAX_WARPS = 16


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
    fn.argtypes = [p, p, p, p, i, p, p, i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return lib


def _plain(q, k_pages, v_pages, page_table, seq_lens, max_pages):
    pts = page_table[:, :max_pages]
    return torch.stack([
        ref_paged_attention(pts[s], seq_lens[s:s + 1], q[s], k_pages,
                            v_pages) for s in range(q.shape[0])])


def _check_cuda_args(q, k_pages, v_pages, page_table, seq_lens,
                     max_pages, splits) -> None:
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
    if splits is not None and (not isinstance(splits, int) or splits < 1):
        raise ValueError(f"splits must be a positive int, got {splits!r}")
    if d > MAX_HEAD_DIM or g * (splits or 1) > MAX_WARPS:
        raise ValueError(f"head_dim {d} > {MAX_HEAD_DIM} or group {g} x "
                         f"splits {splits or 1} > {MAX_WARPS} warps is not "
                         f"supported by the kernel")
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


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    seq_lens: torch.Tensor, max_pages: int, *,
                    splits: Optional[int] = None) -> torch.Tensor:
    """All slots at once, translation through the device page table.

    q [S, n_kv, g, d] (pre-scaled f32); k/v_pages [n_pages, ps, n_kv, d];
    page_table [S, width] int32 of which the first ``max_pages`` columns
    are read (the row stride goes to the kernel, so a column slice needs
    no copy); seq_lens [S] int32 → out [S, n_kv, g, d] f32.

    ``max_pages`` is a Python int so that no launch needs a host read of
    device state.  ``splits`` is the number of warps that share one query
    row's tokens inside a block (None: as many as fit 16 warps).
    ``paged_attention.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return _plain(q, k_pages, v_pages, page_table, seq_lens, max_pages)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on CUDA or CPU tensors, "
                         f"got {q.device}")
    _check_cuda_args(q, k_pages, v_pages, page_table, seq_lens, max_pages,
                     splits)
    S, n_kv, g, d = q.shape
    out = torch.empty_like(q)
    rc = _library().repro_paged_attention_f32(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), page_table.stride(0), seq_lens.data_ptr(),
        out.data_ptr(), S, n_kv, g, d, k_pages.shape[1], max_pages,
        splits or 0, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed with CUDA "
                           f"error {rc}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
