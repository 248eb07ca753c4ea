"""Assigned input shapes, meta-tensor stand-ins for every model input and
the analytic MODEL_FLOPS of the roofline's useful-compute ratio
(counterpart of ``repro/launch/specs.py``).

Where the reference builds ``jax.ShapeDtypeStruct`` trees, the port
builds ``device="meta"`` tensors: shapes and dtypes, no storage, which
the dry run (``launch/dryrun.py``) traces a step over.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..models.config import ModelConfig
from ..models.model import abstract_cache, abstract_params
from ..optim.adamw import AdamWConfig
from ..train.step import abstract_train_state

SHAPES: Dict[str, dict] = {
    "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"kind": "decode", "seq": 32768, "batch": 128},
    "long_500k": {"kind": "decode", "seq": 524288, "batch": 1},
}


def cell_skip_reason(cfg: ModelConfig, shape_name: str) -> Optional[str]:
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return ("needs sub-quadratic attention; " + cfg.name +
                " is pure full-attention (DESIGN.md §Arch-applicability)")
    return None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, batch: int, seq: int) -> Dict:
    """Training/prefill batch stand-ins: ``tokens`` and ``labels``
    (int32; the vision tokens come off ``seq``), ``audio_frames`` and
    ``vision_embeds`` (float32) where the stack takes them."""
    s_text = seq - (cfg.n_vis_tokens or 0)
    out = {"tokens": _meta((batch, s_text), torch.int32),
           "labels": _meta((batch, s_text), torch.int32)}
    if cfg.is_encdec:
        out["audio_frames"] = _meta(
            (batch, cfg.n_audio_frames, cfg.d_model), torch.float32)
    if cfg.n_vis_tokens:
        out["vision_embeds"] = _meta(
            (batch, cfg.n_vis_tokens, cfg.d_model), torch.float32)
    return out


def input_specs(cfg: ModelConfig, shape_name: str,
                opt_cfg: Optional[AdamWConfig] = None) -> Tuple:
    """The meta-tensor args of the step the cell traces: ``(state,
    batch)`` for train, ``(params, batch)`` for prefill, ``(params,
    caches, token, pos)`` for decode (one new token against caches of
    length ``seq``; ``pos`` a 0-dim int32, as the reference's)."""
    sh = SHAPES[shape_name]
    B, S = sh["batch"], sh["seq"]
    if sh["kind"] == "train":
        state = abstract_train_state(cfg, opt_cfg or AdamWConfig())
        return (state, batch_specs(cfg, B, S))
    if sh["kind"] == "prefill":
        return (abstract_params(cfg), batch_specs(cfg, B, S))
    return (abstract_params(cfg), abstract_cache(cfg, B, S),
            _meta((B, 1), torch.int32), _meta((), torch.int32))


# --------------------------------------------------------------------------
# analytic useful-FLOPs (MODEL_FLOPS) for §Roofline
# --------------------------------------------------------------------------
def model_flops_estimate(cfg: ModelConfig, shape_name: str) -> float:
    sh = SHAPES[shape_name]
    B, S = sh["batch"], sh["seq"]
    n_active = cfg.param_count(active_only=True)
    kinds = cfg.layer_kinds()

    def attn_flops(s_q, s_kv, causal_frac=0.5):
        return 2 * 2 * B * cfg.n_heads * cfg.head_dim * s_q * s_kv \
            * causal_frac

    # encoder-decoder: encoder params see B·frames tokens, cross-attention
    # K/V see frames while Q/O see decoder tokens — weight the parameter
    # FLOPs accordingly instead of lumping everything at decoder tokens.
    enc_extra = 0.0
    if cfg.is_encdec:
        d, hd = cfg.d_model, cfg.head_dim
        F = cfg.n_audio_frames
        enc_params = cfg.n_enc_layers * (
            d * (cfg.n_heads + 2 * cfg.n_kv) * hd + cfg.n_heads * hd * d
            + 2 * d * cfg.d_ff)
        cross_kv = cfg.n_layers * 2 * d * cfg.n_kv * hd
        enc_extra = (2 * enc_params * B * F            # encoder matmuls
                     + 2 * cross_kv * B * F            # cross K/V projections
                     + cfg.n_enc_layers * attn_flops(F, F, 1.0))
        if sh["kind"] in ("train", "prefill"):
            # cross-attention scores/PV for decoder tokens against frames
            enc_extra += cfg.n_layers * attn_flops(S, F, 1.0)
        n_active = n_active - enc_params - cross_kv    # avoid double count

    if sh["kind"] == "train":
        tokens = B * S
        fwd = 2 * n_active * tokens + enc_extra
        for spec in kinds:
            if spec.kind in ("attn", "local"):
                w = spec.window or cfg.window
                s_kv = min(w, S) if w else S
                fwd += attn_flops(S, s_kv, 0.5)
        return 3.0 * fwd                       # fwd + 2x bwd
    if sh["kind"] == "prefill":
        tokens = B * S
        total = 2 * n_active * tokens + enc_extra
        for spec in kinds:
            if spec.kind in ("attn", "local"):
                w = spec.window or cfg.window
                s_kv = min(w, S) if w else S
                total += attn_flops(S, s_kv, 0.5)
        return total
    # decode: 1 token, full KV (cross-attn reads cached enc K/V: tiny)
    total = 2 * n_active * B
    for spec in kinds:
        if spec.kind in ("attn", "local"):
            w = spec.window or cfg.window
            s_kv = min(w, S) if w else S
            total += attn_flops(1, s_kv, 1.0)
    if cfg.is_encdec:
        total += cfg.n_layers * attn_flops(1, cfg.n_audio_frames, 1.0)
    return total
