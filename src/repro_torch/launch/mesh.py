"""Device meshes for the port (counterpart of ``repro/launch/mesh.py``).

The port runs a mesh as an SPMD program over ``torch.distributed``: one
process per mesh device, each running the same code over its own shard,
and every cross-device step an explicit, counted collective of the
:class:`Mesh` (where the reference leaves them to GSPMD).  A mesh names an
ordered set of axes among ``pod``, ``data``, ``model`` and ``pipe``
(``("data", "model")`` by default; ``data`` and ``model`` are always
there, 1 wide when not named).  Ranks map to mesh coordinates row-major
over the axes in their order: on ``data x model``, rank ``r`` sits at
``data = r // model``, ``model = r % model``.

``make_host_mesh(1, 1)`` needs no process group.  A larger mesh needs one
that is already initialised with exactly as many ranks as the mesh has
devices (``torchrun --nproc-per-node N``, or :func:`init_distributed`
from the environment ``torchrun`` sets); the backend follows the device,
gloo for ``cpu`` and nccl for ``cuda``.

:class:`CountingMesh` is one rank of any mesh with no process group: its
collectives count as a real rank's and move nothing (the dry run's mesh,
``distributed/hlo_cost.py``); ``make_production_mesh(counting=True)``
builds the production meshes so, with no 256 or 512 ranks.

Training differentiates through collectives, so beside the in-place
helpers of :class:`Mesh` (the serve path's) this module holds their
autograd forms (:func:`to_model`, :func:`from_model`,
:func:`gather_model`, :func:`split_model`, :func:`fsdp_gather`,
:func:`all_to_all`), each a
``torch.autograd.Function`` whose backward is the collective that makes
the gradients of every rank's blocks those of one device.
"""
from __future__ import annotations

import datetime
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

AXIS_NAMES = ("data", "model")
#: every axis a mesh may name
KNOWN_AXES = ("pod", "data", "model", "pipe")
#: the batch (data-parallel) axes, in mesh order
BATCH_AXES = ("pod", "data")
_KINDS = ("all_reduce", "all_gather", "all_to_all", "broadcast",
          "reduce_scatter", "ppermute")
#: the production meshes (the reference's ``repro/launch/mesh.py:13-16``)
PRODUCTION_AXES = {False: {"data": 16, "model": 16},
                   True: {"pod": 2, "data": 16, "model": 16}}

Axis = Union[str, Sequence[str]]


class Mesh:
    """A mesh of processes over named axes.

    ``shape`` is ``{axis: size}`` in the mesh's axis order (the
    reference's ``mesh.shape``; ``{"data": D, "model": M}`` by default),
    ``axis_names`` that order, ``devices`` names each rank's device,
    ``coords`` is this rank's position and ``groups`` holds one process
    group per axis wider than 1 (None on a 1-wide axis), and one per
    tuple of axes a collective spans together (the batch axes ``("pod",
    "data")`` when both are wide; every wide axis at once).  The
    collective helpers work over one axis or such a tuple; each counts
    its calls and the bytes this rank sends in ``collectives[kind]``, and
    on a 1-wide axis returns its input untouched and counts nothing.

    ``axes`` (an ordered ``{name: size}``) names the axes; without it the
    mesh is ``data x model``."""

    def __init__(self, data: int = 1, model: int = 1,
                 device_type: str = "cpu", rank: int = 0,
                 groups: Optional[Dict] = None,
                 axes: Optional[Dict[str, int]] = None):
        shape = dict(axes) if axes is not None else {"data": data,
                                                     "model": model}
        bad = [a for a in shape if a not in KNOWN_AXES]
        if bad or any(n < 1 for n in shape.values()):
            raise ValueError(f"mesh axes must be among {KNOWN_AXES} and "
                             f">= 1, got {shape}")
        for a in AXIS_NAMES:
            shape.setdefault(a, 1)
        self.shape: Dict[str, int] = shape
        self.axis_names: Tuple[str, ...] = tuple(shape)
        self.size = math.prod(shape.values())
        self.device_type = device_type
        self.rank = rank
        self.coords: Dict[str, int] = _coords(shape, rank)
        self.devices: Tuple[str, ...] = tuple(
            f"{device_type}:{r}" for r in range(self.size))
        self.groups: Dict = dict(groups or {a: None for a in shape})
        self.collectives: Dict[str, Dict[str, int]] = {}
        self.reset_collectives()

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank}, "
                f"{self.device_type})")

    def reset_collectives(self) -> None:
        self.collectives = {k: {"calls": 0, "bytes": 0} for k in _KINDS}

    def _count(self, kind: str, x: torch.Tensor) -> None:
        c = self.collectives[kind]
        c["calls"] += 1
        c["bytes"] += x.nelement() * x.element_size()

    def wide(self, axis: Axis) -> Tuple[str, ...]:
        """The axes of ``axis`` (a name or a tuple of names) wider than 1,
        in mesh order."""
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        for a in names:
            if a not in self.shape:
                raise ValueError(f"no axis {a!r} in {self.axis_names}")
        return tuple(a for a in self.axis_names
                     if a in names and self.shape[a] > 1)

    def axis_size(self, axis: Axis) -> int:
        return math.prod(self.shape[a] for a in self.wide(axis))

    def axis_index(self, axis: Axis) -> int:
        """This rank's index along ``axis``: row-major over its wide axes
        in mesh order (the order of a group's ranks)."""
        idx = 0
        for a in self.wide(axis):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def all_axes(self) -> Tuple[str, ...]:
        """Every axis wider than 1 (a collective over all of them spans
        every rank)."""
        return self.wide(self.axis_names)

    def _group(self, wide: Tuple[str, ...]):
        key = wide[0] if len(wide) == 1 else wide
        if key not in self.groups:
            raise ValueError(f"no process group spans {wide} together "
                             f"(groups: {list(self.groups)})")
        return self.groups[key]

    def all_reduce(self, x: torch.Tensor, axis: Axis = "model",
                   op: str = "sum") -> torch.Tensor:
        """Reduce ``x`` over ``axis`` (``op`` ``sum`` or ``max``), in place
        (``x`` must be contiguous and not a view another tensor still
        needs); returns it."""
        ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
        if op not in ops:
            raise ValueError(f"all_reduce op must be one of {list(ops)}")
        wide = self.wide(axis)
        if not wide:
            return x
        self._count("all_reduce", x)
        dist.all_reduce(x, op=ops[op], group=self._group(wide))
        return x

    def all_gather(self, x: torch.Tensor, dim: int, axis: Axis = "model"
                   ) -> torch.Tensor:
        """Concatenate every rank's ``x`` along ``dim``, in axis order."""
        wide = self.wide(axis)
        if not wide:
            return x
        self._count("all_gather", x)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.axis_size(wide))]
        dist.all_gather(parts, x, group=self._group(wide))
        return torch.cat(parts, dim=dim)

    def reduce_scatter(self, x: torch.Tensor, dim: int,
                       axis: Axis = "model") -> torch.Tensor:
        """``x`` summed over ``axis``, of which this rank keeps its block
        along ``dim`` (the axis index's of equal blocks): the backward of
        :meth:`all_gather`."""
        wide = self.wide(axis)
        if not wide:
            return x
        n = self.axis_size(wide)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"split into {n} blocks")
        self._count("reduce_scatter", x)
        chunks = [c.contiguous() for c in x.chunk(n, dim)]
        out = torch.empty_like(chunks[0])
        dist.reduce_scatter(out, chunks, group=self._group(wide))
        return out

    def all_to_all(self, x: torch.Tensor, axis: str = "model"
                   ) -> torch.Tensor:
        """Split dim 0 of ``x`` into one equal chunk per rank of ``axis``
        and send chunk ``j`` to the axis index ``j``; returns the chunks
        received, concatenated on dim 0 in axis order (the reference's
        ``lax.all_to_all(split_axis=0, concat_axis=0)``)."""
        wide = self.wide(axis)
        if not wide:
            return x
        n = self.axis_size(wide)
        if x.shape[0] % n:
            raise ValueError(f"dim 0 of {tuple(x.shape)} does not split "
                             f"into {n} chunks")
        self._count("all_to_all", x)
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self._group(wide))
        return out

    def broadcast(self, x: torch.Tensor, src: int = 0, axis: Axis = "model"
                  ) -> torch.Tensor:
        """Every rank's ``x`` becomes the axis index ``src``'s, in place."""
        wide = self.wide(axis)
        if not wide:
            return x
        self._count("broadcast", x)
        g = self._group(wide)
        dist.broadcast(x, src=dist.get_global_rank(g, src), group=g)
        return x

    def ppermute(self, x: torch.Tensor, axis: str = "pipe",
                 shift: int = 1) -> torch.Tensor:
        """The ring shift over ``axis``: this rank sends ``x`` to the axis
        index ``i + shift`` and returns what index ``i - shift`` sent (the
        reference's ``lax.ppermute`` with pairs ``(i, (i + shift) % n)``);
        one send and one receive a rank."""
        wide = self.wide(axis)
        if not wide:
            return x
        n, i = self.axis_size(wide), self.axis_index(wide)
        g = self._group(wide)
        self._count("ppermute", x)
        x = x.contiguous()
        out = torch.empty_like(x)
        reqs = [dist.isend(x, dst=dist.get_global_rank(g, (i + shift) % n),
                           group=g),
                dist.irecv(out, src=dist.get_global_rank(g, (i - shift) % n),
                           group=g)]
        for r in reqs:
            r.wait()
        return out

    def barrier(self) -> None:
        """Wait until every rank of the mesh is here (an all-reduce of one
        element over every wide axis, counted)."""
        if self.all_axes():
            self.all_reduce(torch.zeros(1, device=self.device_type),
                            self.all_axes())

    def agree(self, flag: bool) -> bool:
        """True on every rank if ``flag`` is true on any (an all-reduce
        max over every wide axis; ``flag`` itself on one device)."""
        if not self.all_axes():
            return bool(flag)
        t = torch.full((1,), int(bool(flag)), dtype=torch.int32,
                       device=self.device_type)
        return bool(self.all_reduce(t, self.all_axes(), op="max").item())


class CountingMesh(Mesh):
    """A mesh that counts collectives and moves nothing: the dry run's
    mesh (``distributed/hlo_cost.py``), where the reference forces 512
    fake host devices and lowers under ``jax.make_mesh``.

    It is one rank of ``axes`` (rank 0 by default) with no process group.
    Each collective returns what :class:`Mesh`'s returns, of the same
    shape, dtype and device (an all-reduce or broadcast ``x`` itself, the
    others a fresh uninitialised tensor), after the same local copies the
    real one makes (``contiguous``, the chunks of a reduce-scatter); it
    counts ``collectives[kind]`` exactly as a real rank does, and appends
    one record per call to ``calls``: ``{"kind", "operand_bytes",
    "result_bytes"}``, what ``hlo_analysis.collective_bytes`` reads.
    :meth:`agree` counts its all-reduce and returns this rank's flag.
    ``device_type`` is ``meta`` unless the traced tensors live elsewhere
    (the values a collective returns there are garbage).  A collective
    over a tuple of axes that no process group of a real mesh of the
    same shape spans (:func:`_group_keys`) raises, as it would there."""

    def __init__(self, axes: Dict[str, int], rank: int = 0,
                 device_type: str = "meta"):
        super().__init__(axes=axes, rank=rank, device_type=device_type)
        self.groups.update({k: None for k in _group_keys(self.shape)
                            if len(k) > 1})

    def __repr__(self) -> str:
        return f"CountingMesh({self.shape}, rank {self.rank})"

    def reset_collectives(self) -> None:
        super().reset_collectives()
        self.calls = []

    def _record(self, kind: str, x: torch.Tensor,
                out: torch.Tensor) -> torch.Tensor:
        self._count(kind, x)
        self.calls.append({
            "kind": kind,
            "operand_bytes": x.nelement() * x.element_size(),
            "result_bytes": out.nelement() * out.element_size()})
        return out

    def all_reduce(self, x: torch.Tensor, axis: Axis = "model",
                   op: str = "sum") -> torch.Tensor:
        if op not in ("sum", "max"):
            raise ValueError("all_reduce op must be one of ['sum', 'max']")
        wide = self.wide(axis)
        if not wide:
            return x
        self._group(wide)
        return self._record("all_reduce", x, x)

    def all_gather(self, x: torch.Tensor, dim: int, axis: Axis = "model"
                   ) -> torch.Tensor:
        wide = self.wide(axis)
        if not wide:
            return x
        self._group(wide)
        x = x.contiguous()
        shape = list(x.shape)
        shape[dim] *= self.axis_size(wide)
        return self._record("all_gather", x, x.new_empty(shape))

    def reduce_scatter(self, x: torch.Tensor, dim: int,
                       axis: Axis = "model") -> torch.Tensor:
        wide = self.wide(axis)
        if not wide:
            return x
        self._group(wide)
        n = self.axis_size(wide)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"split into {n} blocks")
        chunks = [c.contiguous() for c in x.chunk(n, dim)]
        return self._record("reduce_scatter", x,
                            torch.empty_like(chunks[0]))

    def all_to_all(self, x: torch.Tensor, axis: str = "model"
                   ) -> torch.Tensor:
        wide = self.wide(axis)
        if not wide:
            return x
        self._group(wide)
        n = self.axis_size(wide)
        if x.shape[0] % n:
            raise ValueError(f"dim 0 of {tuple(x.shape)} does not split "
                             f"into {n} chunks")
        x = x.contiguous()
        return self._record("all_to_all", x, torch.empty_like(x))

    def broadcast(self, x: torch.Tensor, src: int = 0, axis: Axis = "model"
                  ) -> torch.Tensor:
        wide = self.wide(axis)
        if not wide:
            return x
        self._group(wide)
        return self._record("broadcast", x, x)

    def ppermute(self, x: torch.Tensor, axis: str = "pipe",
                 shift: int = 1) -> torch.Tensor:
        if not self.wide(axis):
            return x
        x = x.contiguous()
        return self._record("ppermute", x, torch.empty_like(x))

    def agree(self, flag: bool) -> bool:
        if self.all_axes():
            self.all_reduce(torch.zeros((1,), dtype=torch.int32,
                                        device=self.device_type),
                            self.all_axes(), op="max")
        return bool(flag)


def _coords(shape: Dict[str, int], rank: int) -> Dict[str, int]:
    """Rank ``rank``'s coordinates, row-major over ``shape``'s order."""
    out = {}
    for a in reversed(tuple(shape)):
        out[a] = rank % shape[a]
        rank //= shape[a]
    return {a: out[a] for a in shape}


def _group_keys(shape: Dict[str, int]) -> List[Tuple[str, ...]]:
    """The axes of each process group of a mesh of ``shape``: one per
    axis wider than 1, and one per tuple of axes a collective spans
    together (the batch axes when both are wide, every wide axis when
    more than one is, and ``data x model``, which a decode cache's
    sequence is cut over, beside a wide ``pod``)."""
    wide = tuple(a for a in shape if shape[a] > 1)
    keys = [(a,) for a in wide]
    batch = tuple(a for a in wide if a in BATCH_AXES)
    if len(batch) > 1:
        keys.append(batch)
    if len(wide) > 1 and wide not in keys:
        keys.append(wide)
    seq = tuple(a for a in wide if a in ("data", "model"))
    if len(seq) > 1 and seq not in keys:
        keys.append(seq)
    return keys


def _axis_groups(shape: Dict[str, int], rank: int) -> Dict:
    """This rank's member of each process group :func:`_group_keys`
    names.  Every rank creates every group, in the same order, as
    ``dist.new_group`` requires; a group's ranks are ascending, so its
    index order is row-major over its axes in mesh order."""
    keys = _group_keys(shape)
    groups: Dict = {a: None for a in shape}
    n = math.prod(shape.values())
    all_coords = [_coords(shape, r) for r in range(n)]
    for key in keys:
        parts: Dict[Tuple, list] = {}
        for r, c in enumerate(all_coords):
            rest = tuple(c[a] for a in shape if a not in key)
            parts.setdefault(rest, []).append(r)
        for rest in sorted(parts):
            g = dist.new_group(parts[rest])
            if rank in parts[rest]:
                groups[key[0] if len(key) == 1 else key] = g
    return groups


# --------------------------------------------------------------------------
# collectives autograd differentiates through (the train path's forms)
# --------------------------------------------------------------------------
def _block(x: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"into {n} blocks")
    b = x.shape[dim] // n
    return x.narrow(dim, i * b, b)


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        return ctx.mesh.all_reduce(g, "model"), None


class _FromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(
            x.clone(memory_format=torch.contiguous_format), "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.all_gather(x, dim, "model")

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh
        return (_block(g, ctx.dim, m.shape["model"], m.coords["model"]),
                None, None)


class _SplitModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _block(x, dim, mesh.shape["model"], mesh.coords["model"]
                      ).clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g, ctx.dim, "model"), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_to_all(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_to_all(g, ctx.axis), None, None


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, axes):
        ctx.mesh, ctx.dim, ctx.axes = mesh, dim, axes
        return mesh.all_gather(x, dim, axes)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.reduce_scatter(g, ctx.dim, ctx.axes), None, None,
                None)


def to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Megatron's *f*: ``x`` itself forward; its gradient all-reduced over
    ``model`` backward.  For a replicated activation entering a product
    with a column block: each rank's gradient of ``x`` holds only its
    block's share."""
    return x if mesh.shape["model"] == 1 else _ToModel.apply(x, mesh)


def from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Megatron's *g*: ``x`` all-reduced over ``model`` forward (the
    partial products of a row block); the gradient untouched backward
    (every rank's is the whole one)."""
    return x if mesh.shape["model"] == 1 else _FromModel.apply(x, mesh)


def gather_model(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """``model`` blocks of ``dim`` gathered whole forward; backward this
    rank's block of the gradient, not summed: downstream of the gather
    every ``model`` rank computes the same thing, so each holds the whole
    gradient already."""
    if mesh.shape["model"] == 1:
        return x
    return _GatherModel.apply(x, mesh, dim % x.dim())


def split_model(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """The conjugate of :func:`gather_model`: this rank's ``model`` block
    of a replicated ``x`` forward (entering a product with a row block);
    backward every rank's block of the gradient gathered whole, since
    upstream every ``model`` rank computes the same thing."""
    if mesh.shape["model"] == 1:
        return x
    return _SplitModel.apply(x, mesh, dim % x.dim())


def fsdp_gather(x: torch.Tensor, mesh: Mesh, dim: int, axes: Axis
                ) -> torch.Tensor:
    """A parameter's FSDP blocks of ``dim`` over ``axes`` (``"data"``, or
    ``("pod", "data")``) gathered whole forward; backward the gradient
    reduce-scattered (summed) over the same axes, so each rank gets the
    sum over the batch ranks of its own block's gradient."""
    if not mesh.wide(axes):
        return x
    return _FsdpGather.apply(x, mesh, dim % x.dim(), axes)


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str = "model"
               ) -> torch.Tensor:
    """:meth:`Mesh.all_to_all` forward; backward the same exchange of the
    gradient (chunk ``j`` of this rank's gradient goes back to the axis
    index ``j``, which sent it): the exchange is a permutation of the
    ranks' chunks, and its transpose is itself."""
    if not mesh.wide(axis):
        return x
    return _AllToAll.apply(x, mesh, axis)


def _label(shape: Dict[str, int]) -> str:
    return "x".join(str(n) for n in shape.values())


def _mesh_on_group(shape: Dict[str, int], device: Optional[str],
                   what: str) -> Mesh:
    """A mesh of ``shape`` over the processes of the initialised group,
    which must hold exactly as many ranks as the mesh has devices."""
    n = math.prod(shape.values())
    initialised = dist.is_available() and dist.is_initialized()
    if not initialised:
        raise RuntimeError(
            f"{what} needs {n} processes, one per device, and no process "
            f"group is initialised: launch with `torchrun "
            f"--nproc-per-node {n} ...` (or call init_distributed)")
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(
            f"{what} needs {n} processes but the process group has "
            f"{world}: launch with `torchrun --nproc-per-node {n} ...`")
    dt = "cpu" if dist.get_backend() == "gloo" else "cuda"
    if device is not None and torch.device(device).type != dt:
        raise ValueError(f"the process group's backend "
                         f"{dist.get_backend()} serves {dt}, not {device}")
    rank = dist.get_rank()
    return Mesh(device_type=dt, rank=rank, axes=shape,
                groups=_axis_groups(shape, rank))


def make_host_mesh(data: int = 1, model: int = 1,
                   device: Optional[str] = None,
                   axes: Optional[Dict[str, int]] = None) -> Mesh:
    """A ``data x model`` mesh (or one over ``axes``, an ordered ``{name:
    size}``, e.g. ``{"pipe": 4}``) over the processes of the initialised
    group.

    One device needs no group (and ignores one: it is one device, with no
    collective); its device name is ``device``, or the group's if one
    exists, else ``cuda`` when a card is present and ``cpu`` otherwise (a
    label only: the mesh itself runs nothing).  A larger mesh raises
    unless a process group of exactly as many ranks is initialised, and
    takes its device type from that group's backend."""
    shape = dict(axes) if axes is not None else {"data": data,
                                                 "model": model}
    if any(n < 1 for n in shape.values()):
        raise ValueError(f"mesh axes must be >= 1, got {_label(shape)}")
    if math.prod(shape.values()) == 1:
        # one device, no collective: each rank of a larger group may hold
        # its own
        initialised = dist.is_available() and dist.is_initialized()
        dt = device or (("cpu" if dist.get_backend() == "gloo" else "cuda")
                        if initialised else
                        ("cuda" if torch.cuda.is_available() else "cpu"))
        return Mesh(device_type=torch.device(dt).type, axes=shape)
    return _mesh_on_group(shape, device, f"a {_label(shape)} mesh")


def init_distributed(device: str) -> torch.device:
    """Initialise the default process group from the environment
    ``torchrun`` sets (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``/
    ``MASTER_PORT``) unless one is, with the backend of ``device`` (gloo
    for ``cpu``, nccl for ``cuda``), and return this rank's device: on
    CUDA the card ``LOCAL_RANK`` modulo the visible cards."""
    dt = torch.device(device).type
    if dt not in ("cpu", "cuda"):
        raise ValueError(f"no collective backend for device {device!r}: "
                         f"use 'cpu' or 'cuda'")
    if dt == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' was asked for but no CUDA "
                               "device is available; pass --device cpu")
        local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                "no process group and no WORLD_SIZE in the environment: "
                "launch with `torchrun --nproc-per-node N ...`")
        dist.init_process_group(
            backend="gloo" if dt == "cpu" else "nccl", init_method="env://",
            world_size=int(os.environ["WORLD_SIZE"]),
            rank=int(os.environ.get("RANK", 0)),
            timeout=datetime.timedelta(seconds=300))
    if dt == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_production_mesh(*, multi_pod: bool = False,
                         device: Optional[str] = None,
                         counting: bool = False) -> Mesh:
    """The reference's training mesh: ``data 16 x model 16`` (256 ranks;
    ``multi_pod``: ``pod 2 x data 16 x model 16``, 512) over the
    initialised group, which must hold exactly that many ranks; any other
    world size raises, naming the count.

    ``counting``: rank 0 of that mesh as a :class:`CountingMesh` on
    ``device`` (``meta`` by default), with no process group (the dry
    run's mesh; the reference's counterpart forces
    ``--xla_force_host_platform_device_count=512``)."""
    shape = PRODUCTION_AXES[bool(multi_pod)]
    if counting:
        return CountingMesh(dict(shape), device_type=device or "meta")
    return _mesh_on_group(dict(shape), device,
                          f"the production mesh {_label(shape)} "
                          f"({', '.join(shape)})")
