"""Gradient compression for cross-pod reductions (the port's counterpart
of ``repro/distributed/compression.py``, the same formulas).

int8 symmetric quantization with a per-leaf scale and error feedback.
Used either (a) as a ``compress`` hook on the train step (it models the
quantization error end to end), or (b) as :func:`compressed_psum`, the
bandwidth saver: a sum over a mesh axis whose operands cross the link as
int8 codes under one shared scale.  Divisions are by 0-dim tensors, never
by a Python number: on CUDA torch turns the latter into a multiply by its
reciprocal, and the codes would differ from the reference's.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from ..optim.adamw import _const
from ..tree import leaves, leaves_with_path, map_with_path, tree_map


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.maximum(amax, _const(amax, 1e-12)) / _const(amax, 127.0)


def _codes(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def quantize_leaf(g: torch.Tensor, mesh=None, axes=()
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, float32 scale) of ``g``: scale = max|g| / 127 (at
    least 1e-12 / 127), codes = round(g / scale) clipped to ±127.  When
    ``g`` is this rank's block of a leaf cut over ``axes`` of ``mesh``,
    max|g| is the whole leaf's (an all-reduce max), as under GSPMD."""
    amax = torch.abs(g).max().float()
    if mesh is not None and axes:
        amax = mesh.all_reduce(amax.clone(), axes, op="max")
    scale = _scale(amax)
    return _codes(g, scale), scale


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def make_ef_compressor(ef_state: Optional[Any] = None, shardings=None
                       ) -> Tuple[Callable, Callable]:
    """Error-feedback int8 compressor: returns ``(compress, init)``.

    ``compress(grads, ef) → (decompressed grads, new ef)``: the
    quantization residual is carried to the next step instead of lost;
    ``init(params)`` gives float32 zeros of the params' shapes.  For a
    train step on a device mesh pass the params' ``Sharding`` tree as
    ``shardings``: each leaf is then this rank's block and its scale the
    whole leaf's.  ``ef_state`` is unused, as in the reference."""
    def init(params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

    by_path = (None if shardings is None else
               {k: sh for k, sh in leaves_with_path(shardings)})

    def compress(grads, ef):
        deq, res = {}, {}
        for (path, g), e in zip(leaves_with_path(grads), leaves(ef),
                                strict=True):
            g32 = g.float() + e
            sh = None if by_path is None else by_path[path]
            q, s = quantize_leaf(g32, *(() if sh is None
                                        else (sh.mesh, sh.axes())))
            deq[path] = dequantize_leaf(q, s)
            res[path] = g32 - deq[path]
        return (map_with_path(lambda k, _: deq[k], grads),
                map_with_path(lambda k, _: res[k], grads))

    return compress, init


def compressed_psum(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``axis`` with int8 codes on the
    wire: the scale is the axis maximum of the ranks' scales (one
    all-reduce max), each rank's codes are taken under it and summed in
    int32 (one all-reduce), then rescaled — the reference's formula."""
    _, scale = quantize_leaf(x)
    scale = mesh.all_reduce(scale.clone(), axis, op="max")
    acc = mesh.all_reduce(_codes(x, scale).to(torch.int32), axis)
    return acc.to(torch.float32) * scale
