"""The step cost walker (counterpart of ``repro/distributed/hlo_cost.py``).

The reference lowers a step for a mesh of fake host devices, parses the
SPMD-partitioned (per-device) HLO text, builds its call graph and
multiplies each ``while`` body by the trip count it reads from the loop's
condition.  The port has no HLO: a step is eager PyTorch, one process per
mesh device.  So the walker *runs* one rank's step, on ``device="meta"``
(shapes and dtypes, no storage, nothing computed) and on a
``launch/mesh.py::CountingMesh`` whose collectives move nothing, under a
``TorchDispatchMode`` that sees every aten op as it is dispatched —
forward, autograd's backward and the optimizer alike.  A Python loop runs
its body once per trip, so trip counts come out as run: there is no trip
count to parse.

Counting rules, by aten op (the reference's, by HLO op):

  * the matmul family (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
    ``_int_mm``, ``mv``, ``dot``, ``convolution``; ``einsum``,
    ``linear`` and ``matmul`` reach the dispatcher as these) counts its
    exact product, 2 · |result| · |contracted dims|;
  * an elementwise op (an aten op tagged ``pointwise``) counts 1 FLOP a
    result element, a reduction (``sum``, ``amax``, softmax, ``cumsum``,
    ``topk``...) 1 a input element;
  * ``bytes`` is every op's operands plus its results (the reference's
    pessimistic count: XLA:CPU's top-level ops, eager PyTorch's
    kernels); views and metadata ops (``view``, ``expand``, ``empty``...)
    are free;
  * ``bytes_min`` counts the matmuls' operands and results plus 2x the
    smallest tensor of each gather, scatter, index or slice-update op
    (``index``, ``index_put_``, ``gather``, ``scatter``, ``embedding``,
    ``copy_``...): the reference's fusion-like lower bound;
  * collectives come from the counting mesh's record of the calls made
    during the trace: an all-reduce 2 x its result's bytes (a ring's
    reduce-scatter and all-gather), a reduce-scatter its operand's, every
    other kind its result's.  The port's ``broadcast`` (``pipeline_apply``
    only) counts as HLO's ``collective-broadcast``.

XLA fuses elementwise work into its consumers and this walker sees each
dispatched op, so ``flops`` and ``bytes`` agree with the reference's to
within the elementwise share (``tests/test_torch_hlo_cost.py`` states
the tolerance); the matmul FLOPs are exact.

Beside the totals the walker keeps the peak of the bytes held by the
tensors the step allocated (``peak_bytes``: the dry run's ``temp``), and
one row per loop scope (:func:`loop`; ``models/model.py::run_stages``
opens one per stage): its trips and one trip's FLOPs and bytes, the
counterpart of ``while_report``.  A traced step that reaches a
hand-written kernel fails: its ``ops.py`` raises on a meta tensor, and on
CUDA tensors a kernel's ctypes launch is invisible to the dispatcher, so
the walker checks that no launch counter moved.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import math
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute", "collective-broadcast")
#: the port's collective kinds (``Mesh.collectives``) → HLO's
HLO_KIND = {"all_reduce": "all-reduce", "all_gather": "all-gather",
            "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
            "ppermute": "collective-permute",
            "broadcast": "collective-broadcast"}

#: the matmul family; the contracted operand is the first matrix
_MATMUL = {"mm": 0, "bmm": 0, "_int_mm": 0, "mv": 0, "dot": 0,
           "addmm": 1, "baddbmm": 1, "addmv": 1}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
           "prod", "cumsum", "cumprod", "logsumexp", "logcumsumexp",
           "_softmax", "_log_softmax", "_softmax_backward_data",
           "_log_softmax_backward_data", "all", "any", "norm",
           "linalg_vector_norm", "var", "var_mean", "std", "std_mean",
           "nansum", "topk", "sort", "argsort"}
_SLICE_LIKE = {"gather", "scatter", "scatter_", "scatter_add",
               "scatter_add_", "scatter_reduce", "scatter_reduce_",
               "index", "_unsafe_index", "index_put", "index_put_",
               "_index_put_impl_", "_unsafe_index_put", "index_select",
               "index_add", "index_add_", "index_copy", "index_copy_",
               "embedding", "embedding_dense_backward", "slice_scatter",
               "select_scatter", "masked_scatter", "take_along_dim",
               "copy_"}
_FREE = {"_unsafe_view", "empty", "empty_like", "empty_strided",
         "new_empty", "new_empty_strided", "lift_fresh", "_reshape_alias",
         "set_", "resize_", "sym_size", "sym_stride", "sym_numel",
         "sym_storage_offset", "is_same_size",
         "_has_compatible_shallow_copy_type"}

_ACTIVE: contextvars.ContextVar[Optional["StepCost"]] = \
    contextvars.ContextVar("hlo_cost_trace", default=None)


def active() -> Optional["StepCost"]:
    """The trace running now, or None (outside :func:`trace_step`)."""
    return _ACTIVE.get()


@contextlib.contextmanager
def loop(name: str, trips: int):
    """A loop scope the walker reports (:meth:`StepCost.while_report`):
    ``trips`` runs of a body inside it.  Outside a trace it does
    nothing."""
    cost = _ACTIVE.get()
    if cost is None:
        yield
        return
    cost.enter_loop(name, trips)
    try:
        yield
    finally:
        cost.exit_loop()


def _nbytes(t: torch.Tensor) -> int:
    return t.nelement() * t.element_size()


def _flat(xs, out: list) -> list:
    """The leaves of an op's arguments or results (tuples and lists of
    tensors and scalars; dicts of keyword arguments)."""
    for x in xs:
        if isinstance(x, (list, tuple)):
            _flat(x, out)
        elif isinstance(x, dict):
            _flat(x.values(), out)
        else:
            out.append(x)
    return out


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in _flat((tree,), []) if isinstance(x, torch.Tensor)]


def _launch_counts() -> Dict[str, int]:
    """Every hand-written kernel's launch counter, by wrapper."""
    from ..kernels.bitplane_transpose import ops as bt
    from ..kernels.bitserial_matmul import ops as bs
    from ..kernels.paged_attention import ops as pa
    from ..kernels.simdram_vm import ops as vm
    fns = (pa.paged_attention, bs.bsmm_packed, bt.to_bitplanes,
           bt.from_bitplanes, vm.run_uprogram)
    return {f.__name__: f.launches for f in fns}


class StepCost:
    """What one traced step did: FLOPs, bytes, collectives, the peak of
    the bytes its own tensors held, and its loop scopes."""

    def __init__(self):
        self.flops = 0.0
        self.bytes = 0.0
        self.bytes_min = 0.0
        self.coll = {c: 0.0 for c in COLLECTIVES}
        self.coll_counts = {c: 0.0 for c in COLLECTIVES}
        self.n_ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}
        self._loops: List[dict] = []
        self._stack: List[dict] = []
        self.result = None

    # -- loop scopes --------------------------------------------------------
    def enter_loop(self, name: str, trips: int) -> None:
        path = tuple(r["body"] for r in self._stack) + (name,)
        row = next((r for r in self._loops if r["path"] == path), None)
        if row is None:
            row = {"path": path, "body": name, "trips": float(trips),
                   "entries": 0, "flops": 0.0, "bytes": 0.0}
            self._loops.append(row)
        row["entries"] += 1
        self._stack.append(row)

    def exit_loop(self) -> None:
        self._stack.pop()

    def while_report(self) -> List[dict]:
        """One row per loop scope: ``trips``, ``enclosing_mult`` (the
        scope's entries: the product of the enclosing loops' trips) and
        one trip's ``body_flops`` and ``body_bytes``, inner loops
        included (the reference's ``while_report``)."""
        return [{"body": r["body"], "trips": r["trips"],
                 "enclosing_mult": float(r["entries"]),
                 "body_flops": r["flops"] / (r["entries"] * r["trips"]),
                 "body_bytes": r["bytes"] / (r["entries"] * r["trips"])}
                for r in self._loops]

    # -- ops ---------------------------------------------------------------
    def _track(self, outs: List[torch.Tensor]) -> None:
        """Add each new storage among ``outs`` to the live bytes until it
        is freed (a storage's Python object lives as long as the storage
        does)."""
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self._live:
                continue
            nb = st.nbytes()
            self._live[key] = (nb, weakref.ref(
                st, lambda _, key=key: self._free(key)))
            self.live_bytes += nb
            if self.live_bytes > self.peak_bytes:
                self.peak_bytes = self.live_bytes

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, (0,))[0]

    def add(self, counts: Tuple[float, float, float]) -> None:
        """Add one op's (FLOPs, bytes, bytes_min) (:func:`_op_counts`)."""
        flops, b, b_min = counts
        self.n_ops += 1
        self.flops += flops
        self.bytes += b
        self.bytes_min += b_min
        for row in self._stack:
            row["flops"] += flops
            row["bytes"] += b

    def add_collectives(self, calls: List[dict]) -> None:
        """The hlo_cost byte rules over a counting mesh's call records."""
        for c in calls:
            kind = HLO_KIND[c["kind"]]
            if kind == "all-reduce":
                nb = 2 * c["result_bytes"]
            elif kind == "reduce-scatter":
                nb = max(c["operand_bytes"], c["result_bytes"])
            else:
                nb = c["result_bytes"]
            self.coll[kind] += nb
            self.coll_counts[kind] += 1

    def report(self) -> dict:
        """The keys of the reference's ``analyze_hlo``."""
        return {"flops": self.flops, "bytes": self.bytes,
                "bytes_min": self.bytes_min,
                "collectives": {**self.coll,
                                "total": sum(self.coll.values())},
                "collective_counts": dict(self.coll_counts)}


_SKIP, _FREE_OP, _MM, _CONV, _POINTWISE, _REDUCE_OP, _OTHER = range(7)
#: ops whose result aliases an input's storage without being declared a
#: view: run, never rebuilt from the cache
_NO_CACHE = {"_unsafe_view", "lift_fresh", "alias", "_reshape_alias",
             "set_", "resize_"}


@functools.lru_cache(maxsize=None)
def _classify(func) -> Tuple[int, int, bool, bool]:
    """(class, the matmul's contracted operand, slice-like, cacheable)
    of an op overload."""
    if func.namespace != "aten" or func.is_view:
        return _SKIP, 0, False, False
    name = func._opname
    if name in _FREE:
        kind = _FREE_OP
    elif name in _MATMUL:
        kind = _MM
    elif name == "convolution":
        kind = _CONV
    elif torch.Tag.pointwise in func.tags:
        kind = _POINTWISE
    elif name in _REDUCE:
        kind = _REDUCE_OP
    else:
        kind = _OTHER
    cacheable = name not in _NO_CACHE and not any(
        r.alias_info is not None for r in func._schema.returns)
    return kind, _MATMUL.get(name, 0), name in _SLICE_LIKE, cacheable


def _op_counts(cls, ins: List[torch.Tensor], outs: List[torch.Tensor]
               ) -> Tuple[float, float, float]:
    """(FLOPs, bytes, bytes_min) of one op of class ``cls``
    (:func:`_classify`) by the module's rules."""
    kind, lhs, slice_like = cls[:3]
    rbytes = sum(_nbytes(t) for t in outs)
    obytes = sum(_nbytes(t) for t in ins)
    flops = 0.0
    b = float(rbytes + obytes)
    b_min = 0.0
    if kind == _MM:
        flops = 2.0 * sum(t.numel() for t in outs) * ins[lhs].shape[-1]
        b_min = b
    elif kind == _CONV:
        flops = 2.0 * sum(t.numel() for t in outs) \
            * math.prod(ins[1].shape[1:])
        b_min = b
    elif kind == _POINTWISE:
        flops = float(sum(t.numel() for t in outs))
    elif kind == _REDUCE_OP:
        flops = float(ins[0].numel()) if ins else 0.0
    if slice_like:
        sizes = [n for n in [rbytes] + [_nbytes(t) for t in ins] if n]
        if sizes:
            b_min = 2.0 * min(sizes)
    return flops, b, b_min


def _meta_key(func, args, kwargs, flat) -> Optional[tuple]:
    """The key of a call whose tensors all live on ``meta`` (a call whose
    results do is cached): what its results' shapes, strides and dtypes
    depend on; None otherwise."""
    parts = [func, len(args), tuple(kwargs)]
    for a in flat:
        if isinstance(a, torch.Tensor):
            if a.device.type != "meta":
                return None
            parts.append((a.shape, a.stride(), a.dtype, a.storage_offset()))
        else:
            try:
                hash(a)
            except TypeError:
                return None
            parts.append((type(a), a))
    return tuple(parts)


def _empty_like_meta(spec) -> torch.Tensor:
    shape, stride, dtype = spec
    return torch.empty_strided(shape, stride, dtype=dtype, device="meta")


class _CostMode(TorchDispatchMode):
    """Counts every op; on meta tensors a functional op's results are
    rebuilt from the first call of the same op on the same shapes,
    strides and dtypes (a meta result is only those: PyTorch's meta
    functions are largely Python, and a step repeats a few hundred
    distinct calls thousands of times)."""

    def __init__(self, cost: StepCost):
        super().__init__()
        self.cost = cost
        self.cache: Dict[tuple, object] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        cls = _classify(func)
        if cls[0] == _SKIP:
            return func(*args, **kwargs)
        flat = _flat(args, _flat(kwargs.values(), []) if kwargs else [])
        key = _meta_key(func, args, kwargs, flat) if cls[3] else None
        hit = None if key is None else self.cache.get(key)
        if hit is not None:
            kind, specs, counts = hit
            outs = [_empty_like_meta(sp) for sp in specs]
            out = outs[0] if kind is None else kind(outs)
        else:
            out = func(*args, **kwargs)
            outs = _tensors(out)
            counts = None if cls[0] == _FREE_OP else _op_counts(
                cls, [a for a in flat if isinstance(a, torch.Tensor)], outs)
            if key is not None and all(t.device.type == "meta"
                                       for t in outs):
                single = isinstance(out, torch.Tensor)
                if single or (isinstance(out, (tuple, list))
                              and len(outs) == len(out)):
                    self.cache[key] = (
                        None if single else type(out),
                        [(t.shape, t.stride(), t.dtype) for t in outs],
                        counts)
        self.cost._track(outs)
        if counts is not None:
            self.cost.add(counts)
        return out


def trace_step(fn: Callable, *args, mesh=None, **kwargs) -> StepCost:
    """Run ``fn(*args, **kwargs)`` once under the walker and return its
    :class:`StepCost` (``.result`` holds what ``fn`` returned).
    ``mesh`` is the :class:`~repro_torch.launch.mesh.CountingMesh` the
    step runs on, whose calls during the trace give the collectives;
    a mesh that counts no call records (a live one) must see none.
    Raises if the step launched a hand-written kernel."""
    if _ACTIVE.get() is not None:
        raise RuntimeError("a step is traced already")
    calls = getattr(mesh, "calls", None)
    n_calls = 0 if calls is None else len(calls)
    live_before = (None if mesh is None or calls is not None else
                   {k: dict(v) for k, v in mesh.collectives.items()})
    launches = _launch_counts()
    cost = StepCost()
    token = _ACTIVE.set(cost)
    try:
        with _CostMode(cost):
            cost.result = fn(*args, **kwargs)
    finally:
        _ACTIVE.reset(token)
    moved = {k: v - launches[k] for k, v in _launch_counts().items()
             if v != launches[k]}
    if moved:
        raise RuntimeError(
            f"the traced step launched hand-written kernels {moved}: a "
            f"ctypes launch is invisible to the dispatcher, so the count "
            f"would be short (trace the plain path)")
    if calls is not None:
        cost.add_collectives(mesh.calls[n_calls:])
    elif live_before is not None and live_before != mesh.collectives:
        raise ValueError("the step made collectives on a mesh that keeps "
                         "no call record: trace it on a CountingMesh")
    return cost


def analyze_step(fn: Callable, *args, mesh=None, **kwargs) -> dict:
    """``trace_step(...).report()``: the keys of the reference's
    ``analyze_hlo`` — ``flops``, ``bytes``, ``bytes_min``,
    ``collectives`` (bytes by HLO kind and ``total``) and
    ``collective_counts``."""
    return trace_step(fn, *args, mesh=mesh, **kwargs).report()


def comms_share(report: dict) -> float:
    """Predicted fraction of memory traffic spent on collectives — the
    layout-selection figure of merit (DESIGN.md §13): collective bytes
    over collective + compute bytes, in [0, 1)."""
    coll = report["collectives"]["total"]
    denom = coll + max(report["bytes"], 1.0)
    return coll / denom if denom else 0.0
