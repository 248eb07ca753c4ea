"""Assigned-architecture registry: ``get_config(arch_id)`` and reduced
``smoke_config(arch_id)`` variants for CPU tests."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from ..models.config import ModelConfig

ARCH_IDS: List[str] = [
    "internvl2-26b", "mixtral-8x7b", "qwen3-moe-235b-a22b", "whisper-small",
    "qwen3-0.6b", "qwen2.5-3b", "nemotron-4-340b", "gemma3-12b",
    "recurrentgemma-9b", "mamba2-1.3b",
]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f".{_MODULES[arch_id]}", __package__)
    return mod.CONFIG


def smoke_config(arch_id: str) -> ModelConfig:
    """Reduced same-family config: tiny widths, few layers/experts."""
    cfg = get_config(arch_id)
    period = 1
    if cfg.local_global_period:
        period = cfg.local_global_period + 1
    if cfg.rglru_period:
        period = cfg.rglru_period
    upd: Dict = dict(
        name=cfg.name + "-smoke",
        n_layers=max(2, period),
        d_model=64,
        n_heads=4 if cfg.n_heads else 0,
        n_kv=min(cfg.n_kv, 2) if cfg.n_kv else 0,
        head_dim=16 if cfg.head_dim else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        grad_accum=1,
        attn_chunk_q=64, attn_chunk_k=64,
    )
    if cfg.n_experts:
        upd.update(n_experts=4, top_k=2, expert_d_ff=96)
    if cfg.family == "ssm":
        upd.update(ssm_state=16, ssm_heads=4, ssm_head_dim=32, ssm_chunk=16)
    if cfg.rglru_period:
        upd.update(rnn_width=64, local_window=16)
    if cfg.local_global_period:
        upd.update(local_window=16)
    if cfg.window:
        upd.update(window=16)
    if cfg.is_encdec:
        upd.update(n_enc_layers=2, n_audio_frames=16)
    if cfg.n_vis_tokens:
        upd.update(n_vis_tokens=8)
    return dataclasses.replace(cfg, **upd)


def pad_vocab(v: int, mult: int = 256) -> int:
    return ((v + mult - 1) // mult) * mult
