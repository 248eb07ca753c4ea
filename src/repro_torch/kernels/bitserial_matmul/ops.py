"""Quantization and the public API of the bit-serial (bit-plane) matmul:
the hand-written Hopper kernel (``csrc/bitserial_matmul.cu``) and its
wrapper (counterpart of ``repro/kernels/bitserial_matmul/ops.py`` and
``kernel.py``).

:class:`QuantizedLinear` is what the LM embeds: weights live as bit planes
(SIMDRAM's vertical layout) packed 1 bit per weight per plane
(:func:`~.ref.pack_planes`), activations are quantized to int8 per row at
each call, and the product runs through :func:`bsmm_packed`.  On a CUDA
tensor :func:`bsmm_packed` launches the kernel — or raises; on a CPU
tensor it runs the plain version (:func:`~.ref.ref_bsmm_packed`).  There
is no fallback from one to the other.  ``bsmm_packed.launches`` counts
kernel launches.  :func:`bsmm_raw` keeps the reference's contract on
unpacked planes: it packs, then calls :func:`bsmm_packed`.

The kernel takes any M, K and N (ragged edges are masked inside it), so
unlike the reference's :func:`bitserial_matmul` nothing is padded and the
weight planes are never copied per call.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple, Union

import numpy as np
import torch
from torch import nn

from ...device import resolve_device
from .. import _build
from .ref import pack_planes, ref_bsmm_packed, unpack_planes

SOURCE = Path(__file__).resolve().parent / "csrc" / "bitserial_matmul.cu"
#: planes the kernel takes: u = Σ_b W_b << b must fit an unsigned byte
MAX_BITS = 8
#: the kernel's output tile (BM x BN) and K chunk in packed words; keep
#: equal to BM, BN and BKW in the source
BM, BN, CHUNK_WORDS = 128, 64, 4
#: split K only while every slice keeps at least this many chunks, so the
#: pipeline of each block has chunks to hide its first loads behind
MIN_SLICE_CHUNKS = 4
#: blocks of the kernel resident on one SM (``__launch_bounds__``)
BLOCKS_PER_SM = 2


def build_kernel() -> Tuple[Path, str]:
    """Compile the kernel library (once per source and flags).  Returns
    (library path, compiler log with ``ptxas``' report)."""
    return _build.build(SOURCE, "bitserial_matmul")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE, "bitserial_matmul")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_bsmm_packed.argtypes = [p, p, p, i, i, i, i, i, i, i, i, p]
    lib.repro_bsmm_packed.restype = i
    lib.repro_dp4a_probe.argtypes = [p, i, i, p]
    lib.repro_dp4a_probe.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_k(M: int, N: int, K: int, sms: int) -> Tuple[int, int]:
    """(slices S, packed words per slice) for an [M, K] x [K, N] product on
    a card with ``sms`` SMs.  S > 1 only where the M x N tiles give fewer
    than ``BLOCKS_PER_SM`` blocks per SM; then, over the S that keep
    ``MIN_SLICE_CHUNKS`` chunks per slice, the least waves of blocks times
    chunks per slice (the smallest S on a tie).  Slices are whole chunks,
    the last one possibly shorter, and none is empty."""
    chunks = -(-(-(-K // 32)) // CHUNK_WORDS)
    tiles = -(-M // BM) * -(-N // BN)
    slots = BLOCKS_PER_SM * sms
    best_cost, best = -(-tiles // slots) * chunks, 1
    if tiles < slots:
        for s in range(2, chunks // MIN_SLICE_CHUNKS + 1):
            cost = -(-tiles * s // slots) * -(-chunks // s)
            if cost < best_cost:
                best_cost, best = cost, s
    per = -(-chunks // best) if chunks else 0
    return (-(-chunks // per) if chunks else 1), CHUNK_WORDS * per


def _check_cuda_args(x: torch.Tensor, w_packed: torch.Tensor) -> None:
    if w_packed.device != x.device:
        raise ValueError(f"w_packed is on {w_packed.device}, x on {x.device}")
    for name, t, dtype in (("x", x, torch.int8),
                           ("w_packed", w_packed, torch.int32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() != 2 or w_packed.dim() != 3:
        raise ValueError(f"x must be [M, K] and w_packed [n_bits, N, "
                         f"ceil(K/32)], got {tuple(x.shape)} and "
                         f"{tuple(w_packed.shape)}")
    if w_packed.shape[2] != -(-x.shape[1] // 32):
        raise ValueError(f"w_packed {tuple(w_packed.shape)} does not hold "
                         f"ceil(K/32) words for K = {x.shape[1]}")
    if not 1 <= w_packed.shape[0] <= MAX_BITS:
        raise ValueError(f"the kernel takes 1..{MAX_BITS} planes, got "
                         f"{w_packed.shape[0]}")
    if max(x.shape[0], x.shape[1], w_packed.shape[1]) >= 2 ** 31:
        raise ValueError("M, K and N must each be below 2^31")
    if -(-w_packed.shape[1] // BN) > 65535:
        raise ValueError(f"N = {w_packed.shape[1]} needs more than 65535 "
                         f"column tiles")


def _x_mode(x: torch.Tensor) -> int:
    """How the kernel may read x's rows: 2 in 16-byte pieces, 1 a word at a
    time, 0 byte by byte (rows off 4-byte boundaries)."""
    K, ptr = x.shape[1], x.data_ptr()
    if K % 16 == 0 and ptr % 16 == 0:
        return 2
    return int(K % 4 == 0 and ptr % 4 == 0)


def bsmm_packed(x: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    """Σ_b 2^b (x @ W_b) — the raw biased accumulation, int32 [M, N], from
    x int8 [M, K] and the planes packed by :func:`~.ref.pack_planes`, int32
    [n_bits, N, ceil(K/32)]."""
    if x.device.type == "cpu":
        return ref_bsmm_packed(x, w_packed)
    if x.device.type != "cuda":
        raise ValueError(f"bsmm_packed runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    _check_cuda_args(x, w_packed)
    (M, K), (n_bits, N, kw) = x.shape, w_packed.shape
    splits, slice_words = split_k(M, N, K, _sm_count(x.device.index or 0))
    # slices add into the output, so it starts at zero (same stream)
    out = (torch.zeros if splits > 1 else torch.empty)(
        (M, N), dtype=torch.int32, device=x.device)
    if M and N:
        w_vec = int(kw % 4 == 0 and w_packed.data_ptr() % 16 == 0)
        rc = _library().repro_bsmm_packed(
            x.data_ptr(), w_packed.data_ptr(), out.data_ptr(), M, K, N,
            n_bits, splits, slice_words, _x_mode(x), w_vec,
            torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"bit-serial matmul kernel launch failed with "
                               f"CUDA error {rc}")
        bsmm_packed.launches += 1
    return out


bsmm_packed.launches = 0


def bsmm_raw(x: torch.Tensor, w_planes: torch.Tensor) -> torch.Tensor:
    """The reference's contract: Σ_b 2^b (x @ w_planes[b]), int32 [M, N],
    from x int8 [M, K] and w_planes int8 [n_bits, K, N] holding 0 or 1.
    Packs the planes, then calls :func:`bsmm_packed`."""
    return bsmm_packed(x, pack_planes(w_planes))


def dp4a_probe(out: torch.Tensor, iters: int) -> None:
    """Launch the kernel library's dp4a rate probe: ``out.numel()`` threads
    (a multiple of 256) each run ``iters`` x 8 independent ``dp4a`` and
    write one int32.  For measuring the card's dp4a rate only."""
    if out.dtype != torch.int32 or out.numel() % 256 or out.device.type != \
            "cuda":
        raise ValueError("out must be a CUDA int32 tensor of a multiple of "
                         "256 elements")
    rc = _library().repro_dp4a_probe(
        out.data_ptr(), out.numel() // 256, iters,
        torch.cuda.current_stream(out.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dp4a probe launch failed with CUDA error {rc}")


def div_exact(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d rounded as one IEEE division, as the reference rounds it.  For
    a Python-number divisor torch multiplies a CUDA tensor by the
    reciprocal instead, which can land one ulp away and move a
    quantization code; a 0-dim tensor divisor is divided elementwise."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def quantize_weights(w: torch.Tensor, n_bits: int = 8
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-column quantization of w [K, N] → (planes int8
    [n_bits, K, N] ∈ {0, 1}, scale f32 [N]).  The planes store the bits of
    q + 2^{n-1} (the unsigned offset)."""
    qmax = (1 << (n_bits - 1)) - 1
    scale = div_exact(torch.clamp(w.abs().amax(dim=0), min=1e-8), qmax)
    q = torch.clamp(torch.round(w / scale[None, :]), -qmax - 1, qmax
                    ).to(torch.int32)
    # q + 2^{n-1} lies in [0, 2^n): int32 holds it, and the mask after each
    # shift stands in for the reference's uint32 arithmetic
    u = q + (1 << (n_bits - 1))
    planes = torch.stack([((u >> b) & 1).to(torch.int8)
                          for b in range(n_bits)])
    return planes, scale.to(torch.float32)


def quantize_activations(x: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-row int8 quantization of x [..., K]."""
    scale = div_exact(torch.clamp(x.abs().amax(dim=-1), min=1e-8), 127.0)
    xi = torch.clamp(torch.round(x / scale[..., None]), -127, 127
                     ).to(torch.int8)
    return xi, scale.to(torch.float32)


def _bsmm_dequant(x_i8: torch.Tensor, x_scale: torch.Tensor,
                  w_packed: torch.Tensor, w_scale: torch.Tensor
                  ) -> torch.Tensor:
    """:func:`bitserial_matmul` on packed planes."""
    zero = 1 << (w_packed.shape[0] - 1)
    acc = bsmm_packed(x_i8, w_packed)
    acc = acc - zero * x_i8.to(torch.int32).sum(dim=1, keepdim=True,
                                                 dtype=torch.int32)
    return acc.to(torch.float32) * x_scale[:, None] * w_scale[None, :]


def bitserial_matmul(x_i8: torch.Tensor, x_scale: torch.Tensor,
                     w_planes: torch.Tensor, w_scale: torch.Tensor
                     ) -> torch.Tensor:
    """The full quantized matmul: dequantized f32 [M, N] from x_i8 [M, K]
    with its row scales and the planes (int8 [n_bits, K, N], the
    reference's layout; packed here per call) with their column scales."""
    return _bsmm_dequant(x_i8, x_scale, pack_planes(w_planes), w_scale)


class QuantizedLinear(nn.Module):
    """A linear layer stored in vertical (bit-plane) layout, packed 1 bit
    per weight per plane: buffers ``w_packed`` int32 [n_bits, N,
    ceil(K/32)] (:func:`~.ref.pack_planes`) and ``w_scale`` f32 [N], and
    ``in_features`` = K.  The unpacked planes are never kept:
    :attr:`w_planes` unpacks them on each read."""

    def __init__(self, w_packed: torch.Tensor, w_scale: torch.Tensor,
                 in_features: int):
        super().__init__()
        self.in_features = in_features
        self.register_buffer("w_packed", w_packed)
        self.register_buffer("w_scale", w_scale)

    @classmethod
    def from_planes(cls, w_planes: torch.Tensor, w_scale: torch.Tensor
                    ) -> "QuantizedLinear":
        """Pack int8 planes [n_bits, K, N] ∈ {0, 1}."""
        return cls(pack_planes(w_planes), w_scale, w_planes.shape[1])

    @classmethod
    def from_dense(cls, w: torch.Tensor, n_bits: int = 8
                   ) -> "QuantizedLinear":
        return cls.from_planes(*quantize_weights(w, n_bits))

    @classmethod
    def from_numpy(cls, w_planes: np.ndarray, w_scale: np.ndarray,
                   device: Union[str, torch.device] = "cuda"
                   ) -> "QuantizedLinear":
        """The bridge from the reference's planes and scale (as numpy)."""
        dev = resolve_device(device)
        return cls.from_planes(
            torch.from_numpy(np.array(w_planes, np.int8)).to(dev),
            torch.from_numpy(np.array(w_scale, np.float32)).to(dev))

    @property
    def w_planes(self) -> torch.Tensor:
        """The planes in the reference's layout, int8 [n_bits, K, N]
        (unpacked on each read)."""
        return unpack_planes(self.w_packed, self.in_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        xi, xs = quantize_activations(x.reshape(-1, shape[-1]))
        y = _bsmm_dequant(xi, xs, self.w_packed, self.w_scale)
        return y.reshape(*shape[:-1], -1).to(x.dtype)

    @property
    def hbm_bytes(self) -> int:
        """Weight bytes with the planes packed, 1 bit per weight per plane,
        and the scales: the reference's formula."""
        nb, N, _ = self.w_packed.shape
        return nb * self.in_features * N // 8 + 4 * N

    @property
    def stored_bytes(self) -> int:
        """The bytes this layer really stores: packed words (whole words
        per column, so K is rounded up to 32) and scales.  Equal to
        :attr:`hbm_bytes` when K is a multiple of 32."""
        return 4 * (self.w_packed.numel() + self.w_scale.numel())
