"""Plain-PyTorch versions of the bit-serial matmul (counterpart of
``repro/kernels/bitserial_matmul/ref.py``).

Torch has no integer matmul on CUDA, and a float32 product of int-valued
operands is not exact once its sums pass 2^24 (K >= 1041 at int8 x 0/1).
So the integer products here run in float64: every term and partial sum is
an integer far below 2^53, so each product is exact in any summation
order, on either device.  The result goes through int64 to int32, which
wraps modulo 2^32 as the reference's int32 arithmetic does.

The planes are stored packed, 1 bit per weight per plane
(:func:`pack_planes`): int32 ``[n_bits, N, ceil(K/32)]``, bit ``j`` of word
``[b, n, w]`` is plane ``b`` at ``k = 32 w + j``, bits past K zero.  The
words carry the uint32 bit pattern, so every right shift is masked
(torch's int32 ``>>`` is arithmetic).
"""
from __future__ import annotations

import torch


def _exact_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Integer a [M, K] @ b [K, N] as float64 (exact, see the module)."""
    return a.to(torch.float64) @ b.to(torch.float64)


def _to_int32(acc: torch.Tensor) -> torch.Tensor:
    return acc.to(torch.int64).to(torch.int32)


def ref_bsmm_raw(x: torch.Tensor, w_planes: torch.Tensor) -> torch.Tensor:
    """Σ_b 2^b (x @ w_planes[b]) in int32: x int8 [M, K], w_planes int8
    [n_bits, K, N] → [M, N]."""
    acc = torch.zeros((x.shape[0], w_planes.shape[2]), dtype=torch.float64,
                      device=x.device)
    for b in range(w_planes.shape[0]):
        acc += _exact_dot(x, w_planes[b]) * float(1 << b)
    return _to_int32(acc)


def pack_planes(w_planes: torch.Tensor) -> torch.Tensor:
    """int8 planes ``[n_bits, K, N]`` ∈ {0, 1} → packed int32 words
    ``[n_bits, N, ceil(K/32)]`` (layout in the module docstring).  Packs
    through int64 one bit position at a time, so beside one int8 copy of
    the planes the intermediates are the size of the words."""
    nb, K, N = w_planes.shape
    kw = -(-K // 32)
    bits = torch.zeros((nb, N, 32 * kw), dtype=torch.int8,
                       device=w_planes.device)
    bits[:, :, :K] = w_planes.transpose(1, 2)
    bits = bits.view(nb, N, kw, 32)
    words = torch.zeros((nb, N, kw), dtype=torch.int64,
                        device=w_planes.device)
    for j in range(32):
        words |= bits[..., j].to(torch.int64) << j
    return _to_int32(words)


def unpack_planes(w_packed: torch.Tensor, K: int) -> torch.Tensor:
    """The inverse of :func:`pack_planes`: int8 planes ``[n_bits, K, N]``."""
    nb, N, kw = w_packed.shape
    j = torch.arange(32, dtype=torch.int32, device=w_packed.device)
    bits = ((w_packed[..., None] >> j) & 1).to(torch.int8)
    return bits.reshape(nb, N, 32 * kw)[:, :, :K].transpose(1, 2) \
        .contiguous()


def ref_bsmm_packed(x: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    """:func:`ref_bsmm_raw` on packed planes: x int8 [M, K], w_packed int32
    [n_bits, N, ceil(K/32)] → int32 [M, N]."""
    return ref_bsmm_raw(x, unpack_planes(w_packed, x.shape[1]))


def ref_quantized_matmul(x_i8: torch.Tensor, x_scale: torch.Tensor,
                         w_q: torch.Tensor, w_scale: torch.Tensor,
                         zero: int) -> torch.Tensor:
    """Dequantized reference: (x_i8 @ w_q) * scales with the unsigned-bias
    zero point, as ``bitserial_matmul`` computes it from the planes."""
    acc = _to_int32(_exact_dot(x_i8, w_q.to(torch.int32) + zero))
    acc = acc - zero * x_i8.to(torch.int32).sum(dim=1, keepdim=True,
                                                 dtype=torch.int32)
    return acc.to(torch.float32) * x_scale[:, None] * w_scale[None, :]
