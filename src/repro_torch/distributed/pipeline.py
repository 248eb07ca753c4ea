"""Pipeline parallelism, GPipe-style, over a ``pipe`` mesh axis (the
port's counterpart of ``repro/distributed/pipeline.py``).

Stages live on different ranks; microbatches stream through with one
ring shift (``Mesh.ppermute``) a tick between them.  The schedule is the
classic fill–steady–drain loop: with M microbatches and P stages,
M + P - 1 ticks and a bubble fraction of (P - 1) / (M + P - 1).  Forward
only, as in the reference.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..tree import leaves, tree_map


def pipeline_apply(stage_fn: Callable, params_stacked, x_mb: torch.Tensor,
                   mesh, axis: str = "pipe") -> torch.Tensor:
    """Run ``x_mb`` [M, mb, ...] through the ``mesh.shape[axis]`` stages.

    ``params_stacked``'s leaves are this rank's block of the stage-major
    stack (a leading dim of 1, as ``Sharding(mesh, Spec(axis)).local``
    cuts it): each rank holds only its stage's params.
    ``stage_fn(stage_params, x) -> x`` is one stage's
    computation, shape-preserving.  Every rank runs every tick (stage 0
    feeds microbatch t at tick t; a stage's output moves to the next
    stage by the ring shift), and the last stage's outputs [M, mb, ...]
    come back on every rank (one broadcast over ``axis``)."""
    n = mesh.shape[axis]
    idx = mesh.coords[axis]
    lead = leaves(params_stacked)[0].shape[0]
    if lead != 1:
        raise ValueError(f"params hold {lead} stages: pass this rank's "
                         f"block of the stage-major stack (leading dim 1)")
    sp = tree_map(lambda p: p[0], params_stacked)
    M = x_mb.shape[0]
    buf = torch.zeros_like(x_mb[0])
    outs = torch.zeros_like(x_mb)
    for t in range(M + n - 1):
        cur = x_mb[t] if (idx == 0 and t < M) else buf
        y = stage_fn(sp, cur)
        if idx == n - 1 and t >= n - 1:
            outs[t - (n - 1)] = y
        buf = mesh.ppermute(y, axis)
    return mesh.broadcast(outs, src=n - 1, axis=axis)
