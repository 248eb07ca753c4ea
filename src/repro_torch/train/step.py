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
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Union

import torch

from ..models.config import ModelConfig
from ..models.model import init_params, lm_loss
from ..optim.adamw import AdamWConfig, adamw_update, init_opt_state
from ..tree import leaves, tree_map


def init_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig, seed: int = 0,
                     device: Union[str, torch.device] = "cuda"
                     ) -> Dict[str, Any]:
    """``{"params", "opt": {"m", "v", "step"}}``, the reference's tree, with
    params drawn by :func:`repro_torch.models.model.init_params`."""
    params = init_params(cfg, seed, device)
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


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    loss_fn: Optional[Callable] = None,
                    compress: Optional[Callable] = None) -> Callable:
    """Returns ``train_step(state, batch) → (state, metrics)``: ``state``
    updated in place and returned, ``metrics`` ``{"loss", "grad_norm",
    "lr"}`` as 0-dim device tensors.

    ``compress`` optionally transforms grads before the optimizer (e.g.
    int8 error-feedback compression for a cross-pod all-reduce)."""
    base_loss = loss_fn or (lambda p, b: lm_loss(cfg, p, b))
    accum = max(1, cfg.grad_accum)
    if cfg.bf16_params_in_compute:
        def loss_fn(p, b):        # noqa: F811
            return base_loss(_bf16_in_compute(p), b)
    else:
        loss_fn = base_loss

    def train_step(state, batch):
        params = state["params"]
        if accum == 1:
            loss, grads = _value_and_grad(loss_fn, params, batch)
        else:
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
            n = torch.full((), accum, dtype=torch.float32,
                           device=lsum.device)
            grads = tree_map(lambda g: g / n, gsum)
            loss = lsum / n
        if compress is not None:
            grads = compress(grads)
        _, opt, om = adamw_update(params, grads, state["opt"], opt_cfg)
        state["opt"] = opt
        return state, {"loss": loss, **om}

    return train_step
