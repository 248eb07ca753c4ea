"""Serving steps: prefill and decode as plain functions (counterpart of
``repro/serve/step.py``).

The reference's ``decode_*`` dry-run cells lower ``serve_step``: one new
token against a KV cache of ``seq_len``; the port's dry run
(``launch/dryrun.py``) traces the same functions on meta tensors.  The
VBI-paged serving path is ``serve/engine.py``.

On a device mesh a step is called inside the caller's
``distributed.axes.logical_axes(mesh, n_experts, batch_cut)``,
``batch_cut`` saying whether the batch axes divide the batch B, and takes
this rank's blocks: the params cut by ``param_specs`` (``shard_params``:
each layer gathers its FSDP blocks over ``data``), the batch or token
rows by ``batch_spec``; the logits come back as this rank's rows, whole
over the vocab.  The caches are ``CacheBlocks`` cut by ``cache_specs``:
``k``/``v``/``xk``/``xv`` by batch over the batch axes where they divide
B, and by sequence over ``model`` then, else over ``data x model`` (a
sequence those axes do not divide stays whole; ``cache_specs`` decides
the sequence cut from B alone); the Mamba ``state`` by heads, RG-LRU
``h`` by width and ``conv`` by channels over ``model``.
Decode against a cut sequence attends sequence-parallel
(``models/model.py::_self_attn_decode``).
"""
from __future__ import annotations

from typing import Callable

from ..models.config import ModelConfig
from ..models.model import decode_step, prefill


def make_prefill_step(cfg: ModelConfig, max_len: int) -> Callable:
    """``prefill_step(params, batch) → (last logits, caches)``; on a mesh
    the caches are this rank's ``CacheBlocks`` (module doc)."""
    def prefill_step(params, batch):
        return prefill(cfg, params, batch, max_len)
    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """``serve_step(params, caches, token, pos) → (logits, caches)``, the
    caches updated in place; ``pos`` is a host int, the same on every
    rank of a mesh."""
    def serve_step(params, caches, token, pos):
        return decode_step(cfg, params, caches, token, pos)
    return serve_step
