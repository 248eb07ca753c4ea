"""Plain-PyTorch versions of the bit-serial matmul (counterpart of
``repro/kernels/bitserial_matmul/ref.py``).

Torch has no integer matmul on CUDA, and a float32 product of int-valued
operands is not exact once its sums pass 2^24 (K >= 1041 at int8 x 0/1).
So the integer products here run in float64: every term and partial sum is
an integer far below 2^53, so each product is exact in any summation
order, on either device.  The result goes through int64 to int32, which
wraps modulo 2^32 as the reference's int32 arithmetic does.
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


def ref_quantized_matmul(x_i8: torch.Tensor, x_scale: torch.Tensor,
                         w_q: torch.Tensor, w_scale: torch.Tensor,
                         zero: int) -> torch.Tensor:
    """Dequantized reference: (x_i8 @ w_q) * scales with the unsigned-bias
    zero point, as ``bitserial_matmul`` computes it from the planes."""
    acc = _to_int32(_exact_dot(x_i8, w_q.to(torch.int32) + zero))
    acc = acc - zero * x_i8.to(torch.int32).sum(dim=1, keepdim=True,
                                                 dtype=torch.int32)
    return acc.to(torch.float32) * x_scale[:, None] * w_scale[None, :]
