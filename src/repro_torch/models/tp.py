"""The model's products in their tensor-parallel forms.

On a device mesh (inside ``distributed.axes.logical_axes``) a weight cut
by ``distributed/sharding.py::param_specs`` is this rank's block over
``model``.  :func:`row_parallel` multiplies by a row block and
:func:`vocab_embed` looks tokens up in a vocab-sharded table; each ends
in one all-reduce (an int8 row block in two: the row scale's max and the
int32 sum, ``quantized.qmm_row_block``).  :func:`gather_cols` gathers
column blocks whole in one all-gather.  Under no scope, or on a 1-wide
``model`` axis, each is the plain op it replaces.

Those are the serve path's forms: collectives in place, nothing to
differentiate.  Under the train step's ``spmd_train`` scope on a mesh
wider than one device (``axes.train_mesh``) the same functions take the
autograd forms of ``launch/mesh.py``, and :func:`col_inputs`,
:func:`gather_cols` and :func:`fsdp_layer` join them:

  * a replicated activation enters column blocks through ``to_model``
    (:func:`col_inputs`), and column blocks are gathered whole with
    ``gather_model`` (:func:`gather_cols`: q/k/v, the logits);
  * a row block takes this rank's slice of a whole activation
    (``split_model``) and ends in ``from_model`` (:func:`row_parallel`:
    ``wo``, ``w2``); the vocab-sharded lookup ends in ``from_model``;
  * each layer's FSDP blocks are gathered over the FSDP axes at the start
    of the layer (:func:`fsdp_layer`), their gradients reduce-scattered
    back; the serve step on a wide ``data`` axis gathers them by the same
    walk, in place, in one all-gather a layer.

Every activation between those points is whole and the same on every
``model`` rank, so whatever divides what (half a KV head a rank, a
weight left whole where its dim does not split) each rank's gradient of
its blocks is the one-device gradient's block.
"""
from __future__ import annotations

import torch

from ..distributed.axes import (data_axis, model_axis, to_block, to_whole,
                                to_whole_last, train_mesh)
from ..distributed.sharding import fsdp_axes_of
from ..launch.mesh import (fsdp_gather, from_model, gather_model,
                           split_model, to_model)
from .quantized import is_quantized, qmm, qmm_row_block


def _rows(w) -> int:
    return (w["q8"] if isinstance(w, dict) else w).shape[-2]


def _cols(w) -> int:
    return (w["q8"] if isinstance(w, dict) else w).shape[-1]


def col_inputs(x: torch.Tensor, ws, wholes):
    """``x`` as it enters each ``x @ w`` of ``ws``, whose ``wholes``
    output columns may be ``model`` blocks: under the train step on a
    mesh, the products by blocks share one ``to_model(x)`` (their
    gradients of ``x`` are shares, summed over ``model`` backward in one
    all-reduce) and a whole ``w`` takes ``x``; everywhere else ``x``."""
    m = train_mesh()
    cut = [_cols(w) != n for w, n in zip(ws, wholes)]
    if m is None or not any(cut):
        return [x] * len(cut)
    xm = to_model(x, m)
    return [xm if c else x for c in cut]


def col_input(x: torch.Tensor, w, whole: int) -> torch.Tensor:
    """:func:`col_inputs` for one product."""
    return col_inputs(x, [w], [whole])[0]


def gather_cols(xs, wholes):
    """Products by column blocks whole along their last dim: under the
    train step on a mesh one ``gather_model`` for every block among
    ``xs`` (q, k and v of one layer: one all-gather), a tensor already
    whole left as it is; in a serve step on a mesh the same by the
    in-place ``axes.to_whole_last``; elsewhere ``xs`` as they are."""
    m = train_mesh()
    if m is None:
        return to_whole_last(xs, wholes)
    blk = [x.shape[-1] != w for x, w in zip(xs, wholes)]
    if not any(blk):
        return tuple(xs)
    n = m.shape["model"]
    cut = [x for x, b in zip(xs, blk) if b]
    widths = [x.shape[-1] for x in cut]
    g = gather_model(torch.cat(cut, -1), m, -1)
    parts = iter(torch.split(g.reshape(*g.shape[:-1], n, sum(widths)),
                             widths, -1))
    return tuple(next(parts).flatten(-2) if b else x
                 for x, b in zip(xs, blk))


def row_parallel(x: torch.Tensor, w, whole: int) -> torch.Tensor:
    """``x @ w`` where ``w``'s ``whole`` input rows may be a ``model``
    block: then ``x`` is taken as the matching block and the partial
    products end in one all-reduce; a whole ``w`` takes ``x`` whole.
    Under the train step the block of a whole ``x`` is ``split_model``'s
    and the sum ``from_model``'s."""
    m = train_mesh()
    if m is not None:
        if _rows(w) == whole:
            if x.shape[-1] != whole:
                x = gather_model(x, m, -1)
            return qmm(x, w)
        if x.shape[-1] == whole:
            x = split_model(x, m, -1)
        return from_model(qmm(x, w), m)
    m = model_axis()
    if m is None or _rows(w) == whole:
        return qmm(to_whole(x, -1, whole), w)
    if is_quantized(w):
        return qmm_row_block(to_block(x, -1, whole), w, m[0])
    y = qmm(to_block(x, -1, whole), w)
    return m[0].all_reduce(y.contiguous())


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor,
                vocab: int) -> torch.Tensor:
    """``table[tokens]`` for a vocab-sharded table: each rank looks up the
    tokens its row block holds, zeros the rest, and one all-reduce sums
    them — exact, since one rank adds each non-zero row (``from_model``
    under the train step)."""
    tm = train_mesh()
    m = model_axis() if tm is None else (
        (tm, tm.shape["model"], tm.coords["model"])
        if tm.shape["model"] > 1 else None)
    if m is None or table.shape[0] == vocab:
        return table[tokens]
    mesh, _, r = m
    n_loc = table.shape[0]
    local = tokens.long() - r * n_loc
    mine = (local >= 0) & (local < n_loc)
    rows = table[torch.clamp(local, 0, n_loc - 1)]
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    if tm is not None:
        return from_model(rows, mesh)
    return mesh.all_reduce(rows.contiguous())


def fsdp_layer(p, specs, cfg):
    """One layer's params with every FSDP block gathered whole over the
    FSDP axes: under the train step on a mesh by ``fsdp_gather``
    (reduce-scatter backward); in a serve step whose batch axes are wide
    by one in-place all-gather for all of the layer's blocks of a dtype
    (:func:`_gather_blocks`: nothing to differentiate); elsewhere ``p``
    itself.  ``specs`` is the layer's subtree of ``sharding.param_specs``
    over the stacked params (each spec's first entry is the stack dim,
    which ``p`` has dropped): a leaf is a block of the dim its spec cuts
    over the FSDP axes, whatever that dim is (d_model on the projections,
    ``rnn_width`` on RG-LRU's ``w_a``/``w_i``), and whole where the spec
    cuts none."""
    m = train_mesh()
    serve = m is None
    if serve:
        d = data_axis()
        m = None if d is None else d[0]
    axes = None if m is None else fsdp_axes_of(cfg, m)
    if m is None or specs is None or not m.wide(axes):
        return p

    def walk(leaf, spec, fn):
        if isinstance(leaf, dict):
            return {k: walk(v, spec[k], fn) for k, v in leaf.items()}
        dims = [i for i, ax in enumerate(spec[1:]) if ax == axes]
        return fn(leaf, dims[0]) if dims else leaf

    if not serve:
        return walk(p, specs, lambda x, dim: fsdp_gather(x, m, dim, axes))
    blocks = []
    walk(p, specs, lambda x, dim: blocks.append((x, dim)))
    whole = iter(_gather_blocks(blocks, m, axes))
    return walk(p, specs, lambda x, dim: next(whole))


def _gather_blocks(blocks, mesh, axes):
    """Each ``(block, dim)`` of ``blocks`` whole along its ``dim`` over
    ``axes``, with one all-gather per dtype among them: the blocks are
    flattened with their cut dim first, concatenated, gathered, and each
    rank's part put back in axis order."""
    n = mesh.axis_size(axes)
    out = [None] * len(blocks)
    by_dtype = {}
    for i, (x, _) in enumerate(blocks):
        by_dtype.setdefault(x.dtype, []).append(i)
    for idx in by_dtype.values():
        moved = [blocks[i][0].movedim(blocks[i][1], 0) for i in idx]
        g = mesh.all_gather(torch.cat([t.reshape(-1) for t in moved]), 0,
                            axes).reshape(n, -1)
        for i, t, part in zip(idx, moved, torch.split(
                g, [t.numel() for t in moved], 1)):
            out[i] = part.reshape(n * t.shape[0], *t.shape[1:]).movedim(
                0, blocks[i][1])
    return out
