"""Vertical (bit-plane) data layout — SIMDRAM's first key technique.

A DRAM row in SIMDRAM holds bit *i* of every element; each bitline is a SIMD
lane.  Here 32 lanes pack into one 32-bit word, so a bit-plane is a
``[n_words]`` vector and a full vertical object is ``[n_bits, n_words]``.
``MAJ``/``NOT`` on packed words are the bitwise analogue of a row-wide
triple-row activation.

Torch's ``uint32`` lacks the shifts and reductions this needs, so planes are
**int32** tensors that carry the uint32 bit pattern: bit ``l`` of word ``w``
of plane ``b`` is bit ``b`` of lane ``32 w + l``, and ``to_numpy`` views the
words back as ``np.uint32``.  Torch's ``>>`` on int32 is arithmetic, so
every extraction masks after the shift.

Planes are LSB-first: ``planes[i]`` holds bit ``i`` (bit 0 = LSB).
Signed values use two's complement; the sign bit is plane ``n_bits-1``.

:func:`pack` and :func:`unpack` are the plain versions of the transposition
unit; ``repro_torch.kernels.bitplane_transpose`` holds the CUDA kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from ..device import resolve_device

WORD_BITS = 32
_WORD_WEIGHTS = (1 << np.arange(WORD_BITS)).astype(np.uint32)


def n_words_for(n_elems: int) -> int:
    return (n_elems + WORD_BITS - 1) // WORD_BITS


def _u32_to_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) → int32 with the same bit pattern."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


@dataclasses.dataclass
class BitPlaneArray:
    """A vertically-laid-out integer array (the SIMDRAM data object)."""

    planes: torch.Tensor       # int32[n_bits, n_words], uint32 bit patterns
    n_elems: int               # number of valid lanes
    signed: bool = True

    @property
    def n_bits(self) -> int:
        return self.planes.shape[0]

    @property
    def n_words(self) -> int:
        return self.planes.shape[1]

    @property
    def device(self) -> torch.device:
        return self.planes.device

    @classmethod
    def from_numpy(cls, planes_u32: np.ndarray, n_elems: int,
                   signed: bool = True,
                   device: Union[str, torch.device] = "cuda"
                   ) -> "BitPlaneArray":
        """Carry uint32 planes (e.g. the reference package's) onto
        ``device``, bit for bit."""
        arr = np.ascontiguousarray(planes_u32, np.uint32).view(np.int32)
        return cls(torch.from_numpy(arr.copy()).to(resolve_device(device)),
                   n_elems, signed)

    def to_numpy(self) -> np.ndarray:
        """The planes as ``np.uint32[n_bits, n_words]``."""
        return self.planes.detach().cpu().numpy().view(np.uint32)


def pack(x: torch.Tensor, n_bits: int, signed: bool = True) -> BitPlaneArray:
    """Horizontal → vertical transposition (plain version of the pack
    kernel).

    ``x``: integer tensor of shape (n_elems,), cut to its low 32 bits like
    ``x.astype(uint32)``; planes past bit 31 are zero.  Values are
    truncated to ``n_bits`` (two's complement wraparound), exactly as a
    fixed-width DRAM object would store them.
    """
    n_elems = x.shape[0]
    nw = n_words_for(n_elems)
    xu = torch.zeros(nw * WORD_BITS, dtype=torch.int64, device=x.device)
    xu[:n_elems] = x.to(torch.int64) & 0xFFFFFFFF
    lanes = xu.reshape(nw, WORD_BITS)
    bits = torch.arange(n_bits, device=x.device)
    shifts = torch.arange(WORD_BITS, device=x.device)
    # [n_bits, nw, 32]: bit b of each lane, moved to its lane position;
    # the positions differ, so the sum is the OR (and fits in int64)
    b = (lanes[None] >> bits[:, None, None]) & 1
    planes = (b << shifts).sum(dim=-1)
    return BitPlaneArray(_u32_to_i32(planes), n_elems, signed)


def unpack(bp: BitPlaneArray, out_dtype: torch.dtype = torch.int32
           ) -> torch.Tensor:
    """Vertical → horizontal transposition with sign extension (plain
    version of the unpack kernel)."""
    n_bits, nw = bp.planes.shape
    lanes = ((bp.planes[:, :, None]
              >> torch.arange(WORD_BITS, device=bp.device)) & 1)
    lanes = lanes.reshape(n_bits, nw * WORD_BITS).to(torch.int64)
    val = torch.zeros(nw * WORD_BITS, dtype=torch.int64, device=bp.device)
    for i in range(n_bits):
        val |= lanes[i] << i
    if bp.signed and n_bits < 64:
        val = val - (lanes[n_bits - 1] << n_bits)
    return val[: bp.n_elems].to(out_dtype)


def pack_np(x: np.ndarray, n_bits: int, signed: bool = True,
            device: Union[str, torch.device] = "cuda") -> BitPlaneArray:
    """NumPy pack (host-side helper for tests and benchmarks), 64-bit
    exact; the planes are placed on ``device``."""
    x = np.asarray(x, dtype=np.int64)
    n_elems = x.shape[0]
    nw = n_words_for(n_elems)
    xu = np.zeros(nw * WORD_BITS, np.uint64)
    xu[:n_elems] = x.astype(np.uint64)
    lanes = xu.reshape(nw, WORD_BITS)
    planes = np.zeros((n_bits, nw), np.uint32)
    for i in range(n_bits):
        bits = ((lanes >> np.uint64(i)) & np.uint64(1)).astype(np.uint32)
        planes[i] = (bits * _WORD_WEIGHTS).sum(axis=-1, dtype=np.uint32)
    return BitPlaneArray.from_numpy(planes, n_elems, signed, device)


def unpack_np(bp: BitPlaneArray) -> np.ndarray:
    """Exact 64-bit-safe host-side unpack (sign-extended int64)."""
    planes = bp.to_numpy()
    n_bits, nw = planes.shape
    lanes = np.zeros((n_bits, nw * WORD_BITS), np.uint64)
    for k in range(WORD_BITS):
        lanes[:, k::WORD_BITS] = (planes >> np.uint32(k)) & np.uint32(1)
    val = np.zeros(nw * WORD_BITS, np.uint64)
    for i in range(n_bits):
        val |= lanes[i] << np.uint64(i)
    out = val.astype(np.int64)
    if bp.signed and n_bits < 64:
        sign = (lanes[n_bits - 1] != 0)
        out = np.where(sign, out - (np.int64(1) << np.int64(n_bits)), out)
    return out[: bp.n_elems]


def maj3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Packed-word majority — the TRA analogue.  MAJ(a,b,c)=ab+ac+bc."""
    return (a & b) | (a & c) | (b & c)
