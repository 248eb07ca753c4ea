"""The training step: loss → grads (with microbatched gradient
accumulation) → AdamW update (the port's counterpart of
``repro/train/step.py``).

Gradients are autograd's (``torch.autograd.grad``) over the model's plain
ops, where the reference takes ``jax.value_and_grad``.  With
``cfg.grad_accum`` > 1 the batch splits into that many contiguous
microbatches; their gradients add into float32 buffers, as the
reference's float32 ``lax.scan`` carry does, and are divided by the count.
The step reads nothing back from the device: its loss, grad norm and
learning rate come back as 0-dim device tensors, and the optimizer
updates the state's tensors in place.

Called inside ``distributed.axes.logical_axes(mesh)``, the same step
runs SPMD (as the reference's runs under
``jit`` with ``in_shardings``): the state holds this rank's blocks
(``distributed.sharding.shard_state``), the step takes the global batch
and keeps its ``batch_spec`` block, and the forward runs in its blocked
form (``distributed.axes.spmd_train``).  Each rank differentiates its
local mean loss divided by the batch ranks' count; the FSDP gathers'
backward sums the cut leaves' gradients over the batch axes, an
all-reduce sums the rest over the batch axes they are not cut over, and
over ``model`` every rank's gradient of a replicated leaf is the same by
construction — so each rank's gradients are the one-device step's, on
its blocks.  The loss is the global batch's mean (one all-reduce), the
clip norm the whole tree's (``optim.adamw.global_norm``).  A 1x1 mesh
takes the same SPMD step, with the plain forward: its extra ops are exact
there (the loss divided by 1.0, no collective on an axis of width 1, the
norm's leaves summed in the plain order), so it is bit-equal to the
unmeshed step.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Union

import torch

from ..distributed.axes import _AXES, spmd_train
from ..distributed.sharding import (batch_axes_for, batch_spec,
                                    param_specs, shardings_of)
from ..models.config import ModelConfig
from ..models.model import init_params, lm_loss, params_shape
from ..optim.adamw import AdamWConfig, adamw_update, init_opt_state
from ..tree import leaves, leaves_with_path, map_with_path, tree_map


def init_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig, seed: int = 0,
                     device: Union[str, torch.device] = "cuda"
                     ) -> Dict[str, Any]:
    """``{"params", "opt": {"m", "v", "step"}}``, the reference's tree, with
    params drawn by :func:`repro_torch.models.model.init_params`."""
    params = init_params(cfg, seed, device)
    return {"params": params, "opt": init_opt_state(params, opt_cfg)}


def abstract_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig
                         ) -> Dict[str, Any]:
    """The reference's ``abstract_train_state`` (``jax.eval_shape`` of
    ``init_train_state``): the state tree as meta tensors."""
    params = params_shape(cfg)
    return {"params": params, "opt": init_opt_state(params, opt_cfg)}


def _split_microbatches(batch: Dict, accum: int) -> Dict:
    """Each leaf [B, ...] → [accum, B // accum, ...]: microbatch i holds
    rows i·B/accum .. (i+1)·B/accum - 1."""
    def r(x):
        b = x.shape[0]
        if b % accum:
            raise ValueError(f"batch {b} not divisible by accum {accum}")
        return x.reshape(accum, b // accum, *x.shape[1:])
    return {k: r(v) for k, v in batch.items()}


def _bf16_in_compute(params):
    """Float32 leaves of rank 2 and above as bfloat16 (autograd carries
    their gradients back to the float32 leaves)."""
    return tree_map(lambda x: x.to(torch.bfloat16)
                    if x.dtype == torch.float32 and x.dim() >= 2 else x,
                    params)


def _value_and_grad(loss_fn: Callable, params, batch):
    """(loss, grads with the params' tree).  The loss runs on detached
    views of the params that require grad, so the state's tensors record
    no graph; a leaf the loss does not reach gets zeros, as under
    ``jax.value_and_grad``."""
    views = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = loss_fn(views, batch)
        flat = leaves(views)
        gs = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = {id(v): torch.zeros_like(v) if g is None else g
             for v, g in zip(flat, gs)}
    return loss.detach(), tree_map(lambda v: grads[id(v)], views)


def _active_mesh():
    """The mesh of the enclosing ``logical_axes`` scope, else None."""
    ctx = _AXES.get()
    return None if ctx is None else ctx["mesh"]


def _grads(loss_fn: Callable, params, batch, accum: int):
    """(loss, grads) of one step's batch: ``accum`` contiguous
    microbatches, their gradients added in float32 and divided by the
    count (device 0-dim divisors)."""
    if accum == 1:
        return _value_and_grad(loss_fn, params, batch)
    mbs = _split_microbatches(batch, accum)
    gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
    lsum = None
    for i in range(accum):
        l, g = _value_and_grad(loss_fn, params,
                               {k: v[i] for k, v in mbs.items()})
        for a, b in zip(leaves(gsum), leaves(g)):
            a.add_(b)
        lsum = l.float() if lsum is None else lsum + l
    n = torch.full((), accum, dtype=torch.float32, device=lsum.device)
    return lsum / n, tree_map(lambda g: g / n, gsum)


def _sum_over_batch(grads, shardings, mesh):
    """Each leaf's gradient summed over the wide batch axes it is not cut
    over (a cut leaf's FSDP backward summed it over the others): one
    all-reduce a leaf, in place."""
    baxes = mesh.wide(batch_axes_for(mesh))
    out = []
    for g, sh in zip(leaves(grads), leaves(shardings), strict=True):
        rest = tuple(a for a in baxes if a not in sh.axes())
        out.append(mesh.all_reduce(g.contiguous(), rest) if rest else g)
    return out


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    loss_fn: Optional[Callable] = None,
                    compress: Optional[Callable] = None) -> Callable:
    """Returns ``train_step(state, batch) → (state, metrics)``: ``state``
    updated in place and returned, ``metrics`` ``{"loss", "grad_norm",
    "lr"}`` as 0-dim device tensors.  Inside ``logical_axes(mesh)``, a
    1x1 mesh included, the step runs SPMD (module doc): ``state``
    is this rank's blocks, ``batch`` the global batch, and the metrics
    are the same on every rank.

    ``compress`` optionally transforms grads before the optimizer (e.g.
    int8 error-feedback compression for a cross-pod all-reduce); on a mesh
    it gets this rank's blocks of the summed gradients."""
    base_loss = loss_fn or (lambda p, b: lm_loss(cfg, p, b))
    accum = max(1, cfg.grad_accum)
    if cfg.bf16_params_in_compute:
        def loss_fn(p, b):        # noqa: F811
            return base_loss(_bf16_in_compute(p), b)
    else:
        loss_fn = base_loss

    specs = {}                  # mesh → the params' Sharding tree

    def finish(state, loss, grads, shardings=None):
        if compress is not None:
            grads = compress(grads)
        _, opt, om = adamw_update(state["params"], grads, state["opt"],
                                  opt_cfg, shardings)
        state["opt"] = opt
        return state, {"loss": loss, **om}

    def spmd_step(state, batch, mesh):
        if mesh.shape.get("pipe", 1) > 1:
            raise NotImplementedError(
                "the train step runs on 'pod', 'data' and 'model' axes; "
                "'pipe' is for distributed/pipeline.py::pipeline_apply")
        params = state["params"]
        b_sh = shardings_of(batch_spec(cfg, batch, mesh), mesh)
        local = {k: b_sh[k].local(v) for k, v in batch.items()}
        baxes = mesh.wide(batch_axes_for(mesh))
        n_b = torch.full((), mesh.axis_size(baxes), dtype=torch.float32,
                         device=leaves(params)[0].device)
        cut = not baxes or bool(b_sh["tokens"].blocks())
        with spmd_train(mesh, batch_cut=cut):
            loss, grads = _grads(lambda p, b: loss_fn(p, b) / n_b, params,
                                 local, accum)
        if mesh not in specs:
            specs[mesh] = shardings_of(
                param_specs(cfg, params_shape(cfg), mesh), mesh)
        p_sh = specs[mesh]
        summed = dict(zip((k for k, _ in leaves_with_path(grads)),
                          _sum_over_batch(grads, p_sh, mesh)))
        grads = map_with_path(lambda k, _: summed[k], grads)
        loss = mesh.all_reduce(loss.clone(), baxes)
        return finish(state, loss, grads, p_sh)

    def train_step(state, batch):
        mesh = _active_mesh()
        if mesh is not None:
            return spmd_step(state, batch, mesh)
        loss, grads = _grads(loss_fn, state["params"], batch, accum)
        return finish(state, loss, grads)

    return train_step
