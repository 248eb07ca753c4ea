"""Fault-tolerant checkpointing of tensor trees (the port's counterpart of
``repro/checkpoint/checkpoint.py``, with the same on-disk format, so each
side reads the other's directories).

A tree is nested ``dict`` / ``list`` / ``tuple`` whose leaves are
``torch.Tensor``, ``np.ndarray`` or Python numbers (``None`` holds no
leaf).  Leaves are visited in the reference's order and keyed as the
reference renders a leaf path (``repro_torch/tree.py``).

* **Atomic**: every file is written to a ``.tmp`` name and renamed, the
  manifest is written last, and the whole step directory lands via one
  ``os.replace`` of ``step_N.tmp`` → ``step_N`` — a crash at ANY point
  mid-save leaves either the previous checkpoint or a ``.tmp`` directory
  that readers ignore, never a torn ``step_N``.
* **Corruption-tolerant**: :func:`latest_step` validates each candidate
  (manifest parses, every leaf file loads and matches its recorded
  shape/dtype) and skips damaged steps, so
  ``CheckpointManager.restore_latest`` falls back to the newest intact
  step.  :func:`restore_pytree` on an explicitly requested damaged step
  raises :class:`CheckpointCorruptError` naming the broken file.
* **Async**: device→host copies happen before the writer thread starts
  (``.detach().to("cpu", copy=True)``: the thread holds host copies,
  never views of live tensors, also for CPU tensors); file IO runs on the
  thread.
* **Retention**: keep the last ``keep`` checkpoints.

A dtype numpy lacks (``bfloat16``) is stored widened to float32, which
holds it exactly; :func:`restore_pytree` casts back to the template's
dtype.

* **Elastic**: a state sharded on a device mesh (``shardings=``, a tree
  of ``distributed.sharding.Sharding``) is saved whole: every rank
  gathers each leaf, rank 0 writes, and a barrier follows the final
  rename, so every rank's :func:`latest_step` sees the step — a save is
  a collective, made at the same step by every rank.  ``restore_pytree``
  with ``shardings=`` loads whole leaves on the host and copies this
  rank's block to its device, so a checkpoint of one mesh restores onto
  any other, onto no mesh, and into the reference's ``restore_pytree``.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..tree import leaves, leaves_with_path, map_with_path


class CheckpointCorruptError(RuntimeError):
    """A checkpoint step is partial or damaged (unparseable manifest,
    missing/truncated leaf, shape or dtype mismatch).  Raised only when
    that step was *explicitly* requested; the discovery path
    (:func:`latest_step`) skips damaged steps instead, so restores fall
    back to the previous intact one."""


def _to_host(leaf) -> np.ndarray:
    """A host copy of one leaf (never a view of live state)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _mesh_of(shardings):
    """The mesh of a ``Sharding`` tree when it is wider than one device."""
    if shardings is None:
        return None
    mesh = leaves(shardings)[0].mesh
    return mesh if mesh.size > 1 else None


def save_pytree(tree, directory: str | Path, step: int,
                blocking: bool = True, shardings=None) -> threading.Thread:
    """Save; returns the writer thread (join it or let the manager track).
    With ``shardings`` on a mesh wider than one device ``tree`` is this
    rank's blocks: the save is a blocking collective (module doc)."""
    directory = Path(directory)
    mesh = _mesh_of(shardings)
    if mesh is not None:
        host_leaves = [(k, _to_host(sh.whole(v))) for (k, v), sh in zip(
            leaves_with_path(tree), leaves(shardings), strict=True)]
        t = (_writer(host_leaves, directory, step) if mesh.rank == 0
             else threading.Thread(target=lambda: None))
        t.start()
        t.join()
        mesh.barrier()
        return t
    host_leaves = [(k, _to_host(v)) for k, v in leaves_with_path(tree)]
    t = _writer(host_leaves, directory, step)
    t.start()
    if blocking:
        t.join()
    return t


def _writer(host_leaves, directory: Path, step: int) -> threading.Thread:
    """The (unstarted) thread that writes ``host_leaves`` as step
    ``step`` of ``directory``."""
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f"step_{step}.tmp"
    final = directory / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    def _write():
        manifest = {"step": step, "leaves": []}
        for i, (key, arr) in enumerate(host_leaves):
            fn = f"leaf_{i}.npy"
            # temp-then-rename per leaf: even inside the .tmp dir no file
            # is ever observable half-written
            np.save(tmp / (fn + ".tmp"), arr)
            os.replace(tmp / (fn + ".tmp.npy"), tmp / fn)
            manifest["leaves"].append(
                {"key": key, "file": fn, "shape": list(arr.shape),
                 "dtype": str(arr.dtype)})
        # manifest last: its presence asserts every leaf preceding it
        (tmp / "manifest.json.tmp").write_text(json.dumps(manifest))
        os.replace(tmp / "manifest.json.tmp", tmp / "manifest.json")
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)

    return threading.Thread(target=_write, daemon=True)


def _validate_step(directory: Path) -> Optional[str]:
    """None if the step directory is intact, else a description of the
    first problem found (unparseable manifest, missing/truncated leaf,
    shape/dtype mismatch vs the manifest)."""
    try:
        manifest = json.loads((directory / "manifest.json").read_text())
    except (OSError, ValueError) as e:
        return f"manifest unreadable: {e}"
    for e in manifest.get("leaves", []):
        path = directory / e["file"]
        try:
            # mmap validates the npy header AND that the file really holds
            # shape*itemsize bytes — a mid-file truncation fails here
            # without reading the payload
            arr = np.load(path, mmap_mode="r")
        except (OSError, ValueError, EOFError) as err:
            # EOFError: a zero-byte leaf (crash before any bytes landed)
            return f"leaf {e['file']} unreadable/truncated: {err}"
        if list(arr.shape) != list(e["shape"]) \
                or str(arr.dtype) != e["dtype"]:
            return (f"leaf {e['file']} mismatches manifest: "
                    f"{arr.shape}/{arr.dtype} vs {e['shape']}/{e['dtype']}")
    return None


def latest_step(directory: str | Path) -> Optional[int]:
    """Newest INTACT step: damaged/partial candidates are skipped (with a
    warning on stderr) so a crash mid-save or on-disk corruption degrades
    to the previous checkpoint instead of a failed restore."""
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = []
    for p in directory.iterdir():
        if p.is_dir() and p.name.startswith("step_") \
                and not p.name.endswith(".tmp") \
                and (p / "manifest.json").exists():
            steps.append(int(p.name.split("_")[1]))
    for step in sorted(steps, reverse=True):
        problem = _validate_step(directory / f"step_{step}")
        if problem is None:
            return step
        print(f"checkpoint: skipping corrupt step_{step} ({problem})",
              file=sys.stderr)
    return None


def _manifest(directory: str | Path, step: int) -> Tuple[Path, dict]:
    step_dir = Path(directory) / f"step_{step}"
    problem = _validate_step(step_dir)
    if problem is not None:
        raise CheckpointCorruptError(f"step_{step}: {problem}")
    return step_dir, json.loads((step_dir / "manifest.json").read_text())


def load_leaves(directory: str | Path, step: int) -> Dict[str, np.ndarray]:
    """Template-free restore: the step's leaves as ``{key: array}``.  For
    consumers whose tree structure is data-dependent (the serve
    crash-recovery snapshots in ``serve/recovery.py`` hold one entry per
    in-flight request) and so cannot supply a static template.  Same
    corruption contract as :func:`restore_pytree`."""
    step_dir, manifest = _manifest(directory, step)
    return {e["key"]: np.load(step_dir / e["file"])
            for e in manifest["leaves"]}


def restore_pytree(template, directory: str | Path, step: int,
                   shardings=None) -> Any:
    """Restore into the structure of ``template``: a tensor leaf comes back
    as a tensor of the template leaf's dtype on its device, any other leaf
    as a numpy array of its dtype.  With ``shardings`` (a ``Sharding``
    tree of the template's nesting) each template leaf is this rank's
    block: the whole leaf is loaded on the host and this rank's block
    copied to fresh storage (any mesh, whatever the saving mesh was).
    Raises :class:`CheckpointCorruptError` — naming the damaged file — if
    the requested step is partial/corrupt, so callers can fall back to
    ``latest_step`` (which already skips damaged steps)."""
    step_dir, manifest = _manifest(directory, step)
    by_key = {e["key"]: e for e in manifest["leaves"]}
    blocks = (None if shardings is None else
              {k: sh for k, sh in leaves_with_path(shardings)})

    def load(key, leaf):
        t = torch.from_numpy(np.load(step_dir / by_key[key]["file"]))
        if blocks is not None:
            t = blocks[key].local(t)
        shape = tuple(np.shape(leaf))
        if tuple(t.shape) != shape:
            raise ValueError(f"shape mismatch for {key}: ckpt "
                             f"{tuple(t.shape)} vs {shape}")
        if not isinstance(leaf, torch.Tensor):
            return t.numpy().astype(np.asarray(leaf).dtype)
        if blocks is not None:            # a fresh block, not a view
            return torch.empty(shape, dtype=leaf.dtype,
                               device=leaf.device).copy_(t)
        return t.to(device=leaf.device, dtype=leaf.dtype)

    return map_with_path(load, template)


class CheckpointManager:
    """Retention + async tracking + resume.  With ``shardings`` (the
    state's ``Sharding`` tree on a mesh wider than one device) every save
    is the collective of :func:`save_pytree` and rank 0 alone prunes."""

    def __init__(self, directory: str | Path, keep: int = 3,
                 shardings=None):
        self.dir = Path(directory)
        self.keep = keep
        self.shardings = shardings
        self._pending: Optional[threading.Thread] = None

    def save(self, tree, step: int, blocking: bool = False) -> None:
        self.wait()
        self._pending = save_pytree(tree, self.dir, step, blocking=blocking,
                                    shardings=self.shardings)
        mesh = _mesh_of(self.shardings)
        if mesh is None or mesh.rank == 0:
            self._gc()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self) -> None:
        steps = sorted(
            int(p.name.split("_")[1]) for p in self.dir.iterdir()
            if p.is_dir() and p.name.startswith("step_")
            and not p.name.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    def restore_latest(self, template, shardings=None):
        step = latest_step(self.dir)       # skips corrupt steps
        if step is None:
            return None, None
        self.wait()
        return restore_pytree(template, self.dir, step, shardings), step
