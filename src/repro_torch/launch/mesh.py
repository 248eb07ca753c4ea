"""Device meshes for the port (counterpart of ``repro/launch/mesh.py``).

The port runs a mesh as an SPMD program over ``torch.distributed``: one
process per mesh device, each running the same code over its own shard,
and every cross-device step an explicit, counted collective of the
:class:`Mesh` (where the reference leaves them to GSPMD).  Ranks map to
mesh coordinates row-major over ``("data", "model")``: rank ``r`` sits at
``data = r // model``, ``model = r % model``.

``make_host_mesh(1, 1)`` needs no process group.  A larger mesh needs one
that is already initialised with exactly ``data * model`` ranks
(``torchrun --nproc-per-node N``, or :func:`init_distributed` from the
environment ``torchrun`` sets); the backend follows the device, gloo for
``cpu`` and nccl for ``cuda``.
"""
from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

AXIS_NAMES = ("data", "model")
_KINDS = ("all_reduce", "all_gather", "all_to_all", "broadcast")


class Mesh:
    """A ``data x model`` mesh of processes.

    ``shape`` is ``{"data": D, "model": M}`` (the reference's
    ``mesh.shape``), ``devices`` names each rank's device, ``coords`` is
    this rank's position and ``groups`` holds one process group per axis
    wider than 1 (None on a 1-wide axis).  The collective helpers work
    over one axis; each counts its calls and the bytes this rank sends in
    ``collectives[kind]``, and on a 1-wide axis returns its input
    untouched and counts nothing."""

    axis_names = AXIS_NAMES

    def __init__(self, data: int, model: int, device_type: str,
                 rank: int = 0, groups: Optional[Dict] = None):
        self.shape: Dict[str, int] = {"data": data, "model": model}
        self.size = data * model
        self.device_type = device_type
        self.rank = rank
        self.coords: Dict[str, int] = {"data": rank // model,
                                       "model": rank % model}
        self.devices: Tuple[str, ...] = tuple(
            f"{device_type}:{r}" for r in range(self.size))
        self.groups: Dict[str, Optional[object]] = dict(
            groups or {"data": None, "model": None})
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

    def all_reduce(self, x: torch.Tensor, axis: str = "model"
                   ) -> torch.Tensor:
        """Sum ``x`` over ``axis``, in place (``x`` must be contiguous and
        not a view another tensor still needs); returns it."""
        if self.shape[axis] == 1:
            return x
        self._count("all_reduce", x)
        dist.all_reduce(x, group=self.groups[axis])
        return x

    def all_gather(self, x: torch.Tensor, dim: int, axis: str = "model"
                   ) -> torch.Tensor:
        """Concatenate every rank's ``x`` along ``dim``, in axis order."""
        n = self.shape[axis]
        if n == 1:
            return x
        self._count("all_gather", x)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=self.groups[axis])
        return torch.cat(parts, dim=dim)

    def all_to_all(self, x: torch.Tensor, axis: str = "model"
                   ) -> torch.Tensor:
        """Split dim 0 of ``x`` into one equal chunk per rank of ``axis``
        and send chunk ``j`` to the axis index ``j``; returns the chunks
        received, concatenated on dim 0 in axis order (the reference's
        ``lax.all_to_all(split_axis=0, concat_axis=0)``)."""
        n = self.shape[axis]
        if n == 1:
            return x
        if x.shape[0] % n:
            raise ValueError(f"dim 0 of {tuple(x.shape)} does not split "
                             f"into {n} chunks")
        self._count("all_to_all", x)
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.groups[axis])
        return out

    def broadcast(self, x: torch.Tensor, src: int = 0, axis: str = "model"
                  ) -> torch.Tensor:
        """Every rank's ``x`` becomes the axis index ``src``'s, in place."""
        if self.shape[axis] == 1:
            return x
        self._count("broadcast", x)
        g = self.groups[axis]
        dist.broadcast(x, src=dist.get_global_rank(g, src), group=g)
        return x


def _axis_groups(data: int, model: int, rank: int) -> Dict:
    """One process group per axis wider than 1, this rank's member of it.
    Every rank creates every group, in the same order, as
    ``dist.new_group`` requires."""
    groups: Dict[str, Optional[object]] = {"data": None, "model": None}
    if model > 1:
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if rank // model == d:
                groups["model"] = g
    if data > 1:
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if rank % model == m:
                groups["data"] = g
    return groups


def make_host_mesh(data: int = 1, model: int = 1,
                   device: Optional[str] = None) -> Mesh:
    """A ``data x model`` mesh over the processes of the initialised group.

    ``1 x 1`` needs no group (and ignores one: it is one device, with no
    collective); its device name is ``device``, or the group's if one
    exists, else ``cuda`` when a card is present and ``cpu`` otherwise (a
    label only: the mesh itself runs nothing).  A larger mesh
    raises unless a process group of exactly ``data * model`` ranks is
    initialised, and takes its device type from that group's backend."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got {data}x{model}")
    n = data * model
    initialised = dist.is_available() and dist.is_initialized()
    if n == 1:
        # one device, no collective: each rank of a larger group may hold
        # its own
        dt = device or (("cpu" if dist.get_backend() == "gloo" else "cuda")
                        if initialised else
                        ("cuda" if torch.cuda.is_available() else "cpu"))
        return Mesh(1, 1, torch.device(dt).type)
    if not initialised:
        raise RuntimeError(
            f"a {data}x{model} mesh needs {n} processes, one per device, "
            f"and no process group is initialised: launch with "
            f"`torchrun --nproc-per-node {n} ...` (or call "
            f"init_distributed)")
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(
            f"a {data}x{model} mesh needs {n} processes but the process "
            f"group has {world}: launch with `torchrun --nproc-per-node "
            f"{n} ...`")
    dt = "cpu" if dist.get_backend() == "gloo" else "cuda"
    if device is not None and torch.device(device).type != dt:
        raise ValueError(f"the process group's backend "
                         f"{dist.get_backend()} serves {dt}, not {device}")
    rank = dist.get_rank()
    return Mesh(data, model, dt, rank, _axis_groups(data, model, rank))


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


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's 16 x 16 (or 2 x 16 x 16) training mesh: not ported;
    it comes with training on a mesh."""
    shape = "2x16x16" if multi_pod else "16x16"
    raise NotImplementedError(
        f"make_production_mesh ({shape}, {512 if multi_pod else 256} "
        f"devices) waits for training on a device mesh (ROADMAP.md "
        f"§ A14b)")
