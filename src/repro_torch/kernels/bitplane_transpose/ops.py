"""The SIMDRAM transposition unit: the hand-written Hopper kernels
(``csrc/bitplane_transpose.cu``) and their wrappers.

:func:`to_bitplanes` (horizontal ints → vertical bit planes) and
:func:`from_bitplanes` (back, sign-extended) launch the pack and unpack
kernels for a CUDA tensor — or raise; for a CPU tensor they run the plain
versions, :func:`repro_torch.core.bitplane.pack` and
:func:`~repro_torch.core.bitplane.unpack`.  There is no fallback from one
to the other.  ``to_bitplanes.launches`` and ``from_bitplanes.launches``
count kernel launches.

Both kernels take at most 32 bit planes, as the reference's
``x.astype(uint32)`` does.  Planes are int32 tensors carrying the uint32
bit pattern (``core/bitplane.py``).  A block transposes a tile of
:data:`PACK_TILE` (pack) or :func:`unpack_tile` (unpack) words.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from ...core.bitplane import (WORD_BITS, BitPlaneArray, n_words_for, pack,
                              unpack)
from .. import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "bitplane_transpose.cu"
MAX_BITS = 32
#: words per block of the pack kernel at every size (``kPackK`` in the
#: .cu); on an H100 within 2% of 128 and 256 words at 2^26 elements
PACK_TILE = 64


def unpack_tile(n_bits: int) -> int:
    """Words per block of the unpack kernel (``unpack_k`` in the .cu): each
    of its 256 threads loads one 16-byte chunk of plane words, so 128 words
    at up to 8 planes and 64 above."""
    return 128 if n_bits <= 8 else 64


def build_kernel() -> Tuple[Path, str]:
    """Compile the pack/unpack library (once per source and flags).
    Returns (library path, compiler log with ``ptxas``' report)."""
    return _build.build(SOURCE, "bitplane_transpose")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE, "bitplane_transpose")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repro_bitplane_pack.argtypes = [p, i, ll, i, i, p, p]
    lib.repro_bitplane_pack.restype = i
    lib.repro_bitplane_unpack.argtypes = [p, i, i, ll, i, p, p]
    lib.repro_bitplane_unpack.restype = i
    return lib


def _check_bits(n_bits: int) -> None:
    if not isinstance(n_bits, int) or not 1 <= n_bits <= MAX_BITS:
        raise ValueError(f"the transpose kernels take 1..{MAX_BITS} bit "
                         f"planes, got {n_bits!r}")


def to_bitplanes(x: torch.Tensor, n_bits: int, signed: bool = True
                 ) -> BitPlaneArray:
    """Horizontal int array [n_elems] (int32 or int64, cut to its low 32
    bits) → vertical bit-plane layout [n_bits, ceil(n_elems / 32)]."""
    _check_bits(n_bits)
    if x.device.type == "cpu":
        return pack(x, n_bits, signed)
    if x.device.type != "cuda":
        raise ValueError(f"to_bitplanes runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    if x.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"x must be int32 or int64, got {x.dtype}")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError("x must be a contiguous 1-D tensor")
    n_elems = x.shape[0]
    nw = n_words_for(n_elems)
    planes = torch.empty((n_bits, nw), dtype=torch.int32, device=x.device)
    if n_elems:
        rc = _library().repro_bitplane_pack(
            x.data_ptr(), x.element_size(), n_elems, n_bits, nw,
            planes.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"bitplane pack kernel launch failed with "
                               f"CUDA error {rc}")
        to_bitplanes.launches += 1
    return BitPlaneArray(planes, n_elems, signed)


def from_bitplanes(bp: BitPlaneArray, out_dtype: torch.dtype = torch.int32
                   ) -> torch.Tensor:
    """Vertical bit-plane layout → horizontal ints [n_elems], sign-extended
    from plane ``n_bits - 1`` when ``bp.signed``."""
    planes = bp.planes
    _check_bits(bp.n_bits)
    if planes.device.type == "cpu":
        return unpack(bp, torch.int32).to(out_dtype)
    if planes.device.type != "cuda":
        raise ValueError(f"from_bitplanes runs on CUDA or CPU tensors, got "
                         f"{planes.device}")
    if planes.dtype != torch.int32:
        raise TypeError(f"planes must be int32, got {planes.dtype}")
    if planes.dim() != 2 or not planes.is_contiguous():
        raise ValueError("planes must be a contiguous [n_bits, n_words] "
                         "tensor")
    if bp.n_words * WORD_BITS < bp.n_elems:
        raise ValueError(f"{bp.n_words} words hold fewer than {bp.n_elems} "
                         f"elements")
    out = torch.empty((bp.n_elems,), dtype=torch.int32, device=planes.device)
    if bp.n_elems:
        rc = _library().repro_bitplane_unpack(
            planes.data_ptr(), bp.n_bits, bp.n_words, bp.n_elems,
            int(bp.signed and bp.n_bits < 32), out.data_ptr(),
            torch.cuda.current_stream(planes.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"bitplane unpack kernel launch failed with "
                               f"CUDA error {rc}")
        from_bitplanes.launches += 1
    return out.to(out_dtype)


def pack_tiles(x_words: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Lane values [n_words, 32] → planes [n_bits, n_words] (the
    reference's ``pack_tiles``; every lane is valid)."""
    return to_bitplanes(x_words.reshape(-1), n_bits).planes


def unpack_tiles(planes: torch.Tensor) -> torch.Tensor:
    """Planes [n_bits, n_words] → lane values [n_words, 32] (the
    reference's ``unpack_tiles``: the bit patterns, not sign-extended)."""
    n_bits, nw = planes.shape
    bp = BitPlaneArray(planes, nw * WORD_BITS, signed=False)
    return from_bitplanes(bp).reshape(nw, WORD_BITS)


to_bitplanes.launches = 0
from_bitplanes.launches = 0
