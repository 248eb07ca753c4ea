"""Per-slot-position QKV projection for the batched serve step.

Counterpart of ``_qkv_ragged`` in ``repro/serve/paged.py``; the legacy
per-sequence ``PagedServer`` there is not ported (ROADMAP.md § A14a-ii).
"""
from __future__ import annotations

import torch

from ..distributed.axes import to_whole_last
from ..models.config import ModelConfig
from ..models.layers import rms_norm, rope


def _qkv_ragged(cfg: ModelConfig, p, x: torch.Tensor,
                positions: torch.Tensor, heads_local: bool = False):
    """Like ``models.model._qkv`` but with a per-sequence position vector:
    x [B, S, d], positions [B] → q [B, H, S, hd], k/v [B, KV, S, hd].

    On a device mesh ``wq``/``wk``/``wv`` (and biases) are column blocks
    over ``model``: ``heads_local`` keeps this rank's blocks, which are
    whole heads when ``model`` divides ``n_kv`` (a rank's q heads are then
    its kv heads' GQA groups), and returns its H / n and KV / n heads;
    otherwise the projections are all-gathered whole first, in one
    all-gather."""
    B, S, _ = x.shape
    KV, hd = cfg.n_kv, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if not heads_local:                 # one all-gather for the blocks
        q, k, v = to_whole_last((q, k, v), (cfg.n_heads * hd, KV * hd,
                                            KV * hd))
    q = q.reshape(B, S, -1, hd).transpose(1, 2)
    k = k.reshape(B, S, -1, hd).transpose(1, 2)
    v = v.reshape(B, S, -1, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    pos = positions[:, None, None]              # one position per sequence
    return (rope(q, pos, cfg.rope_theta), rope(k, pos, cfg.rope_theta), v)
