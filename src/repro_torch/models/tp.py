"""The model's products in their tensor-parallel forms.

On a device mesh (inside ``distributed.axes.logical_axes``) a weight cut
by ``distributed/sharding.py::param_specs`` is this rank's block over
``model``.  :func:`row_parallel` multiplies by a row block and
:func:`vocab_embed` looks tokens up in a vocab-sharded table; each ends
in one all-reduce.  Under no scope, or on a 1-wide ``model`` axis, each
is the plain op it replaces.
"""
from __future__ import annotations

import torch

from ..distributed.axes import model_axis, to_block, to_whole
from .quantized import qmm


def _rows(w) -> int:
    return (w["q8"] if isinstance(w, dict) else w).shape[-2]


def row_parallel(x: torch.Tensor, w, whole: int) -> torch.Tensor:
    """``x @ w`` where ``w``'s ``whole`` input rows may be a ``model``
    block: then ``x`` is taken as the matching block and the partial
    products end in one all-reduce; a whole ``w`` takes ``x`` whole."""
    m = model_axis()
    if m is None or _rows(w) == whole:
        return qmm(to_whole(x, -1, whole), w)
    y = qmm(to_block(x, -1, whole), w)
    return m[0].all_reduce(y.contiguous())


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor,
                vocab: int) -> torch.Tensor:
    """``table[tokens]`` for a vocab-sharded table: each rank looks up the
    tokens its row block holds, zeros the rest, and one all-reduce sums
    them — exact, since one rank adds each non-zero row."""
    m = model_axis()
    if m is None or table.shape[0] == vocab:
        return table[tokens]
    mesh, _, r = m
    n_loc = table.shape[0]
    local = tokens.long() - r * n_loc
    mine = (local >= 0) & (local < n_loc)
    rows = table[torch.clamp(local, 0, n_loc - 1)]
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return mesh.all_reduce(rows.contiguous())
