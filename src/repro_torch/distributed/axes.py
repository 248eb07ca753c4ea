"""Logical activation-sharding axes (counterpart of
``repro/distributed/axes.py``).

Tokens: 'batch' → the data-parallel axes of the active mesh ('pod',
'data'); 'model' → the tensor-parallel axis; 'expert' → 'model' when EP
is active.  Outside a ``logical_axes(mesh)`` scope every constraint is a
no-op.  Where a decode cache's sequence is cut is not a logical axis:
``sharding.cache_specs`` decides it from the batch alone, and
:func:`seq_axis` reads the axes it chose.

The reference's ``constrain`` asks GSPMD for a layout.  The port runs one
process per mesh device, so a tensor here is either whole on every rank
or this rank's block of a dim, and :func:`constrain` *slices* (no
communication) or *gathers* ``x`` into the named layout: a named dim
whose axes divide its whole size ends as this rank's block, every other
dim ends whole.  Gathers are collectives of the mesh and are counted
there.  Two axes carry activation blocks: ``model`` (the
tensor-parallel products' heads, hidden and vocab blocks) and the batch
axes, which the serve engine cuts its slot rows over (a dim named
``batch``; the train step cuts its batch itself).  A dim the axes do not
divide stays whole on every rank, the reference's fallback rule.

The tensor-parallel helpers below (:func:`to_whole`, :func:`to_block`,
:func:`model_sum`) are the step's forms of the same rule over
``model``, and :func:`batch_whole` gathers slot rows back over the batch
axes; ``models/tp.py`` builds the row-parallel product and the
vocab-sharded lookup on them; under no scope, or on a 1-wide axis, each
is the plain op it replaces.  They are the serve path's in-place forms;
the train step runs the model's forward under :func:`spmd_train`, and
there ``models/tp.py`` takes the autograd forms of ``launch/mesh.py``
instead (:func:`train_mesh` says which).  This module imports nothing of
``models/``.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Sequence, Tuple

import torch

_AXES: contextvars.ContextVar[Optional[dict]] = contextvars.ContextVar(
    "logical_axes", default=None)
_TRAIN: contextvars.ContextVar[Optional[object]] = contextvars.ContextVar(
    "spmd_train", default=None)


@contextlib.contextmanager
def spmd_train(mesh, batch_cut: bool = True):
    """The train step's scope: inside it a mesh wider than one device
    makes :func:`train_mesh` return it, and the model's forward takes its
    blocked, differentiable forms; ``mesh`` None (or one device) leaves
    the plain forms.  ``batch_cut`` says whether the step cut its batch
    over the batch axes (``sharding.batch_spec`` leaves a batch whole on
    every rank when the batch ranks do not divide it), which decides the
    MoE's route (:func:`batch_cut`).  A remat'd layer re-enters it
    and the logical axes with the scope it was run in
    (:func:`train_scope`, :func:`in_scope`)."""
    tok = _TRAIN.set((mesh, bool(batch_cut))
                     if mesh is not None and mesh.size > 1 else None)
    try:
        yield
    finally:
        _TRAIN.reset(tok)


def train_mesh():
    """The mesh the train step runs on when it is wider than one device,
    else None (outside :func:`spmd_train`, too)."""
    scope = _TRAIN.get()
    return None if scope is None else scope[0]


def batch_cut() -> bool:
    """Whether the batch the model sees is this rank's block over the
    batch axes: the train step's flag under a wide train scope, else the
    logical axes' (the serve engine's: whether the batch axes divide its
    slots), True outside any scope."""
    scope = _TRAIN.get()
    if scope is not None:
        return scope[1]
    ctx = _AXES.get()
    return True if ctx is None else ctx["batch_cut"]


def train_scope() -> tuple:
    """The context the model's forward runs in (the logical axes and the
    train step's scope), for :func:`in_scope` to re-enter: a remat
    replay may run on autograd's device thread, which sees no context
    variable of the caller's."""
    return _AXES.get(), _TRAIN.get()


@contextlib.contextmanager
def in_scope(scope: tuple):
    """Run inside a context :func:`train_scope` captured."""
    tok_a, tok_t = _AXES.set(scope[0]), _TRAIN.set(scope[1])
    try:
        yield
    finally:
        _TRAIN.reset(tok_t)
        _AXES.reset(tok_a)


@contextlib.contextmanager
def logical_axes(mesh, n_experts: int = 0, batch_cut: bool = True):
    """The scope of the logical axes on ``mesh``.  ``batch_cut`` says
    whether the model's batch inside is this rank's block over the batch
    axes (:func:`batch_cut`; the serve engine passes whether the batch
    axes divide its slots)."""
    names = set(mesh.axis_names)
    batch = tuple(a for a in ("pod", "data") if a in names)
    mapping = {
        "batch": batch if len(batch) > 1 else (batch[0] if batch else None),
        "model": "model" if "model" in names else None,
        "expert": ("model" if ("model" in names and n_experts
                               and n_experts % mesh.shape["model"] == 0)
                   else None),
    }
    tok = _AXES.set({"mesh": mesh, "map": mapping,
                     "batch_cut": bool(batch_cut)})
    try:
        yield
    finally:
        _AXES.reset(tok)


def model_axis():
    """(mesh, n, index) of the active ``model`` axis when it is wider than
    1, else None."""
    ctx = _AXES.get()
    if ctx is None:
        return None
    mesh = ctx["mesh"]
    n = mesh.shape["model"]
    return (mesh, n, mesh.coords["model"]) if n > 1 else None


def data_axis():
    """(mesh, n, index) of the active batch axes (``data``, with ``pod``
    when the mesh names it) when they are wider than 1, else None; ``n``
    is their size and ``index`` this rank's row-major index over them."""
    ctx = _AXES.get()
    if ctx is None:
        return None
    mesh = ctx["mesh"]
    axes = mesh.wide(_axes_of(ctx, "batch"))
    return (mesh, mesh.axis_size(axes), mesh.axis_index(axes)) if axes \
        else None


def seq_axis(axes):
    """(mesh, n, index) of the axes a decode cache's sequence is cut over
    when they are wider than 1, else None (and None outside a scope).
    ``axes`` is the cut ``sharding.cache_specs`` gave the cache's seq
    dim: ``model`` where the batch axes divide the batch, else
    ``("data", "model")`` (the ``pod`` axis stays whole), None where the
    sequence does not divide; ``index`` is row-major over the wide ones
    in mesh order, the order of a ``Sharding``'s blocks."""
    ctx = _AXES.get()
    if ctx is None or axes is None:
        return None
    mesh = ctx["mesh"]
    wide = mesh.wide(axes)
    return (mesh, mesh.axis_size(wide), mesh.axis_index(wide)) if wide \
        else None


def scope_mesh():
    """The mesh of the active ``logical_axes`` scope, or None."""
    ctx = _AXES.get()
    return None if ctx is None else ctx["mesh"]


def _axes_of(ctx, name: Optional[str]) -> Tuple[str, ...]:
    """The mesh axes the logical ``name`` maps to in the scope ``ctx``."""
    ax = ctx["map"].get(name) if name else None
    return () if ax is None else (ax if isinstance(ax, tuple) else (ax,))


def _gather(x: torch.Tensor, dim: int, whole: int, mesh,
            axes=("model",)) -> torch.Tensor:
    if x.shape[dim] == whole:
        return x
    if x.shape[dim] * mesh.axis_size(axes) != whole:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} is neither whole "
                         f"({whole}) nor a block of it over {tuple(axes)}")
    return mesh.all_gather(x, dim, axes)


def _slice(x: torch.Tensor, dim: int, whole: int, n: int,
           r: int) -> torch.Tensor:
    blk = whole // n
    if x.shape[dim] == blk:
        return x
    if x.shape[dim] != whole:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} is neither whole "
                         f"({whole}) nor a block of {blk}")
    return x.narrow(dim, r * blk, blk)


def constrain(x: torch.Tensor, *dims: Optional[str],
              whole: Optional[Sequence[int]] = None,
              src: Optional[Sequence[Optional[str]]] = None
              ) -> torch.Tensor:
    """Bring ``x`` into the named layout; no-op outside logical_axes().

    ``whole`` is the tensor's whole shape (default ``x.shape``: ``x`` is
    whole).  A dim named by a logical axis whose mesh axes divide its
    whole size (the reference's fallback rule) ends as this rank's block
    over those axes (a view); every other dim ends whole, gathered if it
    was a block.  ``src`` names, per dim, the logical axis ``x`` holds a
    block of where its size differs from ``whole`` (default ``model``):
    ``constrain(rows, None, whole=(S,), src=("batch",))`` gathers slot
    rows cut over the batch axes back whole."""
    ctx = _AXES.get()
    if ctx is None:
        return x
    if len(dims) != x.dim():
        raise ValueError(f"constrain got {len(dims)} names for a "
                         f"{x.dim()}-d tensor")
    mesh = ctx["mesh"]
    whole = tuple(x.shape) if whole is None else tuple(whole)
    src = (None,) * len(dims) if src is None else tuple(src)
    for i, d in enumerate(dims):
        axes = mesh.wide(_axes_of(ctx, d))
        n = mesh.axis_size(axes)
        if axes and whole[i] > 0 and whole[i] % n == 0:
            x = _slice(x, i, whole[i], n, mesh.axis_index(axes))
        else:
            x = _gather(x, i, whole[i], mesh,
                        mesh.wide(_axes_of(ctx, src[i] or "model")))
    return x


def batch_whole(xs, whole: int):
    """Tensors whose dim 0 is this rank's block over the batch axes (of
    ``whole`` rows), whole along dim 0 with one all-gather for all of
    them: each flattened to ``[rows, -1]``, concatenated (dtypes
    promoted), gathered by :func:`constrain` and split back.  Tensors
    already whole (no wide batch axis, or a batch the axes do not divide)
    come back as they are."""
    if data_axis() is None or xs[0].shape[0] == whole:
        return tuple(xs)
    flat = [x.reshape(x.shape[0], -1) for x in xs]
    widths = [f.shape[1] for f in flat]
    g = constrain(torch.cat(flat, 1), None, None,
                  whole=(whole, sum(widths)), src=("batch", None))
    return tuple(p.reshape(whole, *x.shape[1:])
                 for p, x in zip(torch.split(g, widths, 1), xs))


def to_whole(x: torch.Tensor, dim: int, whole: int) -> torch.Tensor:
    """``x`` whole along ``dim`` (``whole`` long): all-gathered over
    ``model`` if it is a block, else ``x`` itself."""
    m = model_axis()
    if m is None or x.shape[dim] == whole:
        return x
    return _gather(x, dim, whole, m[0])


def to_whole_last(xs, wholes):
    """:func:`to_whole` along the last dim of several tensors of the same
    leading shape, with one all-gather for all the blocks among them (the
    q/k/v projections of one attention layer)."""
    m = model_axis()
    if m is None:
        return tuple(xs)
    blk = [x.shape[-1] != w for x, w in zip(xs, wholes)]
    if sum(blk) < 2:
        return tuple(to_whole(x, -1, w) for x, w in zip(xs, wholes))
    mesh, n, _ = m
    cut = [x for x, b in zip(xs, blk) if b]
    widths = [x.shape[-1] for x in cut]
    g = _gather(torch.cat(cut, -1), -1, n * sum(widths), mesh)
    parts = iter(torch.split(g.reshape(*g.shape[:-1], n, sum(widths)),
                             widths, -1))
    return tuple(next(parts).flatten(-2) if b else x
                 for x, b in zip(xs, blk))


def to_block(x: torch.Tensor, dim: int, whole: int) -> torch.Tensor:
    """This rank's ``model`` block of ``x`` along ``dim`` when ``model``
    divides ``whole`` (a view, no communication), else ``x`` whole."""
    m = model_axis()
    if m is None or whole % m[1]:
        return x
    return _slice(x, dim, whole, m[1], m[2])


def model_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ``model`` axis (one all-reduce; ``x`` itself
    without a mesh)."""
    m = model_axis()
    return x if m is None else m[0].all_reduce(x.contiguous())
