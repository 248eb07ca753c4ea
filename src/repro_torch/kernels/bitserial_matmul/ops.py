"""Quantization and the public API of the bit-serial (bit-plane) matmul:
the hand-written Hopper kernel (``csrc/bitserial_matmul.cu``) and its
wrapper (counterpart of ``repro/kernels/bitserial_matmul/ops.py`` and
``kernel.py``).

:class:`QuantizedLinear` is what the LM embeds: weights live as bit planes
(SIMDRAM's vertical layout), activations are quantized to int8 per row at
each call, and the product runs through :func:`bsmm_raw`.  On a CUDA
tensor :func:`bsmm_raw` launches the kernel — or raises; on a CPU tensor it
runs the plain version (:func:`~.ref.ref_bsmm_raw`).  There is no fallback
from one to the other.  ``bsmm_raw.launches`` counts kernel launches.

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
from .ref import ref_bsmm_raw

SOURCE = Path(__file__).resolve().parent / "csrc" / "bitserial_matmul.cu"
#: planes the kernel takes: u = Σ_b W_b << b must fit an unsigned byte
MAX_BITS = 8


def build_kernel() -> Tuple[Path, str]:
    """Compile the kernel library (once per source and flags).  Returns
    (library path, compiler log with ``ptxas``' report)."""
    return _build.build(SOURCE, "bitserial_matmul")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE, "bitserial_matmul")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_bsmm_raw.argtypes = [p, p, p, i, i, i, i, i, i, p]
    lib.repro_bsmm_raw.restype = i
    return lib


def _check_cuda_args(x: torch.Tensor, w_planes: torch.Tensor) -> None:
    if w_planes.device != x.device:
        raise ValueError(f"w_planes is on {w_planes.device}, x on {x.device}")
    for name, t in (("x", x), ("w_planes", w_planes)):
        if t.dtype != torch.int8:
            raise TypeError(f"{name} must be int8, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() != 2 or w_planes.dim() != 3:
        raise ValueError(f"x must be [M, K] and w_planes [n_bits, K, N], got "
                         f"{tuple(x.shape)} and {tuple(w_planes.shape)}")
    if w_planes.shape[1] != x.shape[1]:
        raise ValueError(f"K of x {tuple(x.shape)} and w_planes "
                         f"{tuple(w_planes.shape)} differ")
    if not 1 <= w_planes.shape[0] <= MAX_BITS:
        raise ValueError(f"the kernel takes 1..{MAX_BITS} planes, got "
                         f"{w_planes.shape[0]}")
    if max(x.shape[0], x.shape[1], w_planes.shape[2]) >= 2 ** 31:
        raise ValueError("M, K and N must each be below 2^31")


def _vec(t: torch.Tensor, row: int) -> int:
    """1 when every row of ``t`` (``row`` bytes long) starts on a 4-byte
    boundary, so the kernel may read it a word at a time."""
    return int(row % 4 == 0 and t.data_ptr() % 4 == 0)


def bsmm_raw(x: torch.Tensor, w_planes: torch.Tensor) -> torch.Tensor:
    """Σ_b 2^b (x @ w_planes[b]) — the raw biased accumulation, int32
    [M, N], from x int8 [M, K] and w_planes int8 [n_bits, K, N] holding 0
    or 1 (other values give other sums than the plain version)."""
    if x.device.type == "cpu":
        return ref_bsmm_raw(x, w_planes)
    if x.device.type != "cuda":
        raise ValueError(f"bsmm_raw runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    _check_cuda_args(x, w_planes)
    (M, K), (n_bits, _, N) = x.shape, w_planes.shape
    out = torch.empty((M, N), dtype=torch.int32, device=x.device)
    if M and N:
        rc = _library().repro_bsmm_raw(
            x.data_ptr(), w_planes.data_ptr(), out.data_ptr(), M, K, N,
            n_bits, _vec(x, K), _vec(w_planes, N),
            torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"bit-serial matmul kernel launch failed with "
                               f"CUDA error {rc}")
        bsmm_raw.launches += 1
    return out


bsmm_raw.launches = 0


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


def bitserial_matmul(x_i8: torch.Tensor, x_scale: torch.Tensor,
                     w_planes: torch.Tensor, w_scale: torch.Tensor
                     ) -> torch.Tensor:
    """The full quantized matmul: dequantized f32 [M, N] from x_i8 [M, K]
    with its row scales and the planes with their column scales."""
    zero = 1 << (w_planes.shape[0] - 1)
    acc = bsmm_raw(x_i8, w_planes)
    acc = acc - zero * x_i8.to(torch.int32).sum(dim=1, keepdim=True,
                                                 dtype=torch.int32)
    return acc.to(torch.float32) * x_scale[:, None] * w_scale[None, :]


class QuantizedLinear(nn.Module):
    """A linear layer stored in vertical (bit-plane) layout: buffers
    ``w_planes`` int8 [n_bits, K, N] ∈ {0, 1} and ``w_scale`` f32 [N]."""

    def __init__(self, w_planes: torch.Tensor, w_scale: torch.Tensor):
        super().__init__()
        self.register_buffer("w_planes", w_planes)
        self.register_buffer("w_scale", w_scale)

    @classmethod
    def from_dense(cls, w: torch.Tensor, n_bits: int = 8
                   ) -> "QuantizedLinear":
        return cls(*quantize_weights(w, n_bits))

    @classmethod
    def from_numpy(cls, w_planes: np.ndarray, w_scale: np.ndarray,
                   device: Union[str, torch.device] = "cuda"
                   ) -> "QuantizedLinear":
        """The bridge from the reference's planes and scale (as numpy)."""
        dev = resolve_device(device)
        return cls(torch.from_numpy(np.array(w_planes, np.int8)).to(dev),
                   torch.from_numpy(np.array(w_scale, np.float32)).to(dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        xi, xs = quantize_activations(x.reshape(-1, shape[-1]))
        y = bitserial_matmul(xi, xs, self.w_planes, self.w_scale)
        return y.reshape(*shape[:-1], -1).to(x.dtype)

    @property
    def hbm_bytes(self) -> int:
        """Weight bytes with the planes packed, 1 bit per weight per plane
        (the reference's figure).  The planes as stored, and as the kernel
        reads them, take one byte per bit: 8x this for the planes."""
        nb, K, N = self.w_planes.shape
        return nb * K * N // 8 + 4 * N
