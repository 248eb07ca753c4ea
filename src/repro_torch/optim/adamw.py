"""AdamW with global-norm clipping (the port's counterpart of
``repro/optim/adamw.py``).

Optimizer state dtype is configurable (``state_dtype='bfloat16'`` halves
the m/v footprint).  Math is always done in float32; states are cast on
load and store.  The update runs in place under ``torch.no_grad()`` and
never reads the device: the step, the clip scale, the learning rate and
the bias corrections are device tensors (a Python ``min(1.0, clip /
gnorm)`` would wait for the gradients' norm).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from ..tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"
    warmup_steps: int = 100


def _state_dtype(cfg: AdamWConfig) -> torch.dtype:
    dt = getattr(torch, cfg.state_dtype, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown state_dtype {cfg.state_dtype!r}")
    return dt


def init_opt_state(params, cfg: AdamWConfig) -> Dict[str, Any]:
    """Zero moments ``m``, ``v`` in ``state_dtype`` with the params' tree
    and ``step``, an int32 0-dim tensor, on the params' device."""
    dt = _state_dtype(cfg)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt,  # noqa: E731
                                  device=p.device)
    dev = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _const(like: torch.Tensor, value: float) -> torch.Tensor:
    """A float32 0-dim tensor on ``like``'s device (a fill, no copy): the
    divisions below divide by it because torch turns a division of a CUDA
    tensor by a Python number into a multiply by its reciprocal, and
    ``number / tensor`` into one everywhere."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(
        step.float() / _const(step, max(cfg.warmup_steps, 1)), max=1.0)
    return cfg.lr * warm


def global_norm(tree, shardings=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32 (a 0-dim device
    tensor; the leaves are summed in the reference's order).

    With ``shardings`` (a tree of ``distributed.sharding.Sharding`` on a
    mesh) each leaf is this rank's block: each element is counted once
    over the mesh — a leaf only on the ranks at index 0 of every wide axis
    it is not cut over — and one all-reduce over every wide axis sums the
    ranks' shares, so every rank gets the same scalar (on a 1x1 mesh: the
    plain sum, in its order, and no all-reduce)."""
    if shardings is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in leaves(tree)))
    sh = leaves(shardings)
    mesh = sh[0].mesh
    xs = leaves(tree)
    total = torch.zeros((), dtype=torch.float32, device=xs[0].device)
    for x, s in zip(xs, sh, strict=True):
        cut = s.axes()
        if all(mesh.coords[a] == 0 for a in mesh.all_axes()
               if a not in cut):
            total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(mesh.all_reduce(total, mesh.all_axes()))


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, shardings=None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: warmup schedule, clipping by the global norm, bias
    correction, decoupled weight decay.  ``params`` and the moments of
    ``state`` are updated in place and returned with the metrics
    ``{"grad_norm", "lr"}`` (0-dim device tensors).  On a device mesh
    each leaf is this rank's block and ``shardings`` (the params'
    ``Sharding`` tree) makes the norm the whole tree's
    (:func:`global_norm`); the update itself is elementwise."""
    state["step"].add_(1)
    step = state["step"].float()
    gnorm = global_norm(grads, shardings)
    scale = torch.clamp(_const(gnorm, cfg.clip_norm) / (gnorm + 1e-9),
                        max=1.0)
    lr = _schedule(cfg, state["step"])
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step
    bc2 = 1.0 - b2 ** step
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"])):
        g = g.float() * scale
        m32 = b1 * m.float() + (1 - b1) * g
        v32 = b2 * v.float() + (1 - b2) * g * g
        mh = m32 / bc1
        vh = v32 / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    return params, state, {"grad_norm": gnorm, "lr": lr}
