"""Per-slot-position QKV projection for the batched serve step.

Counterpart of ``_qkv_ragged`` in ``repro/serve/paged.py``; the legacy
per-sequence ``PagedServer`` there is not ported (ROADMAP.md § A15).
"""
from __future__ import annotations

import torch

from ..models.config import ModelConfig
from ..models.layers import rms_norm, rope


def _qkv_ragged(cfg: ModelConfig, p, x: torch.Tensor,
                positions: torch.Tensor):
    """Like ``models.model._qkv`` but with a per-sequence position vector:
    x [B, S, d], positions [B] → q [B, H, S, hd], k/v [B, KV, S, hd]."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd).transpose(1, 2)
    k = k.reshape(B, S, KV, hd).transpose(1, 2)
    v = v.reshape(B, S, KV, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    pos = positions[:, None, None]              # one position per sequence
    return (rope(q, pos, cfg.rope_theta), rope(k, pos, cfg.rope_theta), v)
