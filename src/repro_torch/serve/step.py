"""Serving steps: prefill and decode as plain functions (counterpart of
``repro/serve/step.py``).

The reference's ``decode_*`` dry-run cells lower ``serve_step``: one new
token against a KV cache of ``seq_len``; the port's dry run
(``launch/dryrun.py``) traces the same functions on meta tensors.  The
VBI-paged serving path is ``serve/engine.py``.  Both steps take the
model's dense caches whole: on a mesh of more than one device they have
no form yet (ROADMAP.md § A15b-iii).
"""
from __future__ import annotations

from typing import Callable

from ..models.config import ModelConfig
from ..models.model import decode_step, prefill


def make_prefill_step(cfg: ModelConfig, max_len: int) -> Callable:
    """``prefill_step(params, batch) → (last logits, caches)``."""
    def prefill_step(params, batch):
        return prefill(cfg, params, batch, max_len)
    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """``serve_step(params, caches, token, pos) → (logits, caches)``, the
    caches updated in place."""
    def serve_step(params, caches, token, pos):
        return decode_step(cfg, params, caches, token, pos)
    return serve_step
