"""Quantized serving weights (counterpart of ``repro/models/quantized.py``).

``quantize_serving_params`` maps every dense matmul leaf (wq, wk, wv, wo,
w1, w2, w3, lm_head) to ``{"q8": int8[W.shape], "s": f32[..., N]}``, with
per-column scales; MoE expert tensors stay dense, as in the reference.
``qmm`` dispatches on that structure.  It is the reference's exact
int8 x int8 → int32 dot with per-row activation scales, not the bit-plane
kernel: on CUDA the dot is ``torch._int_mm``, on the CPU the same call.

``q8`` holds the reference's values with the reference's shape, stored
column-major (each [K, N] matrix is the transpose of a contiguous
[N, K]): cuBLASLt's int8 product takes that layout at every M tried,
while a row-major weight was refused at M = 17-48 with K = 64 (torch 2.11,
CUDA 12.8, on an H100).

The reference's ``abstract`` mode (shape-only trees for the XLA dry run) has
no counterpart here: the port has no abstract parameter trees.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ..kernels.bitserial_matmul.ops import div_exact

_TARGETS = {"wq", "wk", "wv", "wo", "w1", "w2", "w3", "lm_head"}


def _quantize(leaf: torch.Tensor) -> dict:
    w = leaf.to(torch.float32)
    scale = div_exact(torch.clamp(w.abs().amax(dim=-2), min=1e-8), 127.0)
    q = torch.clamp(torch.round(w / scale[..., None, :]), -127, 127
                    ).to(torch.int8)
    return {"q8": _column_major(q), "s": scale}


def _column_major(q: torch.Tensor) -> torch.Tensor:
    return q.transpose(-1, -2).contiguous().transpose(-1, -2)


def quantize_serving_params(params):
    """The params tree with every target leaf (of 2 dims or more, never
    under ``moe``) replaced by its ``{"q8", "s"}`` form; other leaves are
    the same tensors."""

    def tx(names, node):
        if isinstance(node, dict):
            return {k: tx(names + [str(k)], v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [tx(names + [""], v) for v in node]
        if ("moe" in names or not names or names[-1] not in _TARGETS
                or node.dim() < 2):
            return node
        return _quantize(node)

    return tx([], params)


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q8" in w


def _int_mm(xi: torch.Tensor, q8: torch.Tensor) -> torch.Tensor:
    """Exact int8 [M, K] @ int8 [K, N] → int32.  On CUDA ``torch._int_mm``
    asks for M > 16 and K, N multiples of 8, so there M is zero-padded to
    17 (M is the batch at decode) and K, N to multiples of 8 — zero rows and
    columns add nothing — and the weight goes in column-major (see the
    module)."""
    if xi.device.type != "cuda":
        return torch._int_mm(xi, q8)
    (M, K), N = xi.shape, q8.shape[1]
    pm, pk, pn = max(17 - M, 0), -K % 8, -N % 8
    if pk or pn or q8.stride(0) != 1:
        q8 = _column_major(F.pad(q8, (0, pn, 0, pk)))
    out = torch._int_mm(F.pad(xi, (0, pk, 0, pm)), q8)
    return out[:M, :N] if pm or pn else out


def qmm(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for dense or quantized (int8 + per-column scale) weights."""
    if not is_quantized(w):
        return x @ w
    shape = x.shape
    x2 = x.reshape(-1, shape[-1]).to(torch.float32)
    xs = div_exact(torch.clamp(x2.abs().amax(dim=-1), min=1e-8), 127.0)
    xi = torch.clamp(torch.round(x2 / xs[:, None]), -127, 127
                     ).to(torch.int8)
    acc = _int_mm(xi, w["q8"])
    y = acc.to(torch.float32) * xs[:, None] * w["s"][None, :]
    return y.reshape(*shape[:-1], -1).to(x.dtype)
