"""Stage-structured decoder for the decoder-only stacks.

Counterpart of ``repro/models/model.py``.  Params are a plain nested dict
with the reference's tree layout: ``embed``, ``final_norm``, optional
``lm_head``, and ``stages[i][j]`` — one dict per period entry of stage i,
every leaf stacked along a leading ``[count]`` axis.  Caches mirror the
same structure.

Entry points (plain functions of ``(cfg, params, ...)``):

  * ``forward_train`` — the causal LM forward over a batch → logits;
  * ``prefill``       — forward over a prompt + emit the KV caches;
  * ``decode_step``   — one token with caches.

Every attention and MLP projection goes through ``quantized.qmm``, so the
three also run a ``quantize_serving_params`` tree.  Every layer kind is
ported: attention (``attn``, and windowed ``local``/SWA ones), RG-LRU
(``rglru.py``) and Mamba-2 (``ssm.py``) mixers, dense and top-k MoE
channel mixers.  Vision and encoder-decoder inputs, ``lm_loss`` and
gradients are queued in ROADMAP.md.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from .config import LayerSpec, ModelConfig
from .layers import attention, mlp, moe, rms_norm, rope
from .quantized import qmm
from .rglru import init_rglru_params, rglru_decode_step, rglru_forward
from .ssm import init_mamba_params, mamba_decode_step, mamba_forward, ssm_dims


def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _dt(cfg: ModelConfig) -> torch.dtype:
    return _dtype(cfg.param_dtype)


def _cdt(cfg: ModelConfig) -> torch.dtype:
    return _dtype(cfg.compute_dtype)


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder stacks are not ported yet "
            f"(ROADMAP.md § A5b)")


# --------------------------------------------------------------------------
# parameter init
# --------------------------------------------------------------------------
class _Init:
    """Draws N(0, 1)·scale leaves from one ``torch.Generator``."""

    def __init__(self, gen: torch.Generator, device: torch.device):
        self.gen = gen
        self.device = device

    def normal(self, shape, scale: float, dtype) -> torch.Tensor:
        x = torch.randn(shape, generator=self.gen, device=self.device,
                        dtype=torch.float32)
        return (x * scale).to(dtype)

    def zeros(self, shape, dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def full(self, shape, value: float, dtype) -> torch.Tensor:
        return torch.full(shape, value, dtype=dtype, device=self.device)


def _init_attn(cfg: ModelConfig, ini: _Init, n: int, dtype) -> Dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    s = d ** -0.5
    p = {
        "wq": ini.normal((n, d, H * hd), s, dtype),
        "wk": ini.normal((n, d, KV * hd), s, dtype),
        "wv": ini.normal((n, d, KV * hd), s, dtype),
        "wo": ini.normal((n, H * hd, d), (H * hd) ** -0.5, dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = ini.zeros((n, H * hd), dtype)
        p["bk"] = ini.zeros((n, KV * hd), dtype)
        p["bv"] = ini.zeros((n, KV * hd), dtype)
    if cfg.qk_norm:
        p["q_norm"] = ini.zeros((n, hd), torch.float32)
        p["k_norm"] = ini.zeros((n, hd), torch.float32)
    return p


def _init_mlp(cfg: ModelConfig, ini: _Init, n: int, dtype) -> Dict:
    d, ff = cfg.d_model, cfg.d_ff
    p = {"w1": ini.normal((n, d, ff), d ** -0.5, dtype),
         "w2": ini.normal((n, ff, d), ff ** -0.5, dtype)}
    if cfg.act == "swiglu":
        p["w3"] = ini.normal((n, d, ff), d ** -0.5, dtype)
    return p


def _init_moe(cfg: ModelConfig, ini: _Init, n: int, dtype) -> Dict:
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.expert_d_ff or cfg.d_ff
    return {
        "router": ini.normal((n, d, E), d ** -0.5, torch.float32),
        "w1": ini.normal((n, E, d, ff), d ** -0.5, dtype),
        "w3": ini.normal((n, E, d, ff), d ** -0.5, dtype),
        "w2": ini.normal((n, E, ff, d), ff ** -0.5, dtype),
    }


def _init_layer(spec: LayerSpec, cfg: ModelConfig, ini: _Init, n: int,
                dtype) -> Dict:
    """One period entry's leaves, stacked over its ``n`` layers: the
    reference's tree (mamba layers have no ``ln2`` and no channel mixer;
    MoE layers carry ``moe`` in place of ``mlp``)."""
    d = cfg.d_model
    p: Dict[str, Any] = {"ln1": ini.zeros((n, d), torch.float32)}
    if spec.kind in ("attn", "local"):
        p["attn"] = _init_attn(cfg, ini, n, dtype)
    elif spec.kind == "mamba":
        p["mamba"] = init_mamba_params(cfg, ini, n, dtype)
    else:                                           # rglru
        p["rglru"] = init_rglru_params(cfg, ini, n, dtype)
    if spec.kind != "mamba":
        p["ln2"] = ini.zeros((n, d), torch.float32)
        if spec.moe:
            p["moe"] = _init_moe(cfg, ini, n, dtype)
        else:
            p["mlp"] = _init_mlp(cfg, ini, n, dtype)
    return p


def init_params(cfg: ModelConfig, seed: int = 0,
                device: Union[str, torch.device] = "cuda") -> Dict:
    """Random params with the reference's shapes, scales and tree layout,
    drawn on ``device`` from a ``torch.Generator`` seeded with ``seed``.
    The values differ from the reference's ``jax.random`` draws; tests
    that compare the two packages bridge the reference's params with
    :func:`params_from_numpy` instead."""
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    ini = _Init(gen, dev)
    dtype = _dt(cfg)
    d = cfg.d_model
    params: Dict[str, Any] = {
        "embed": ini.normal((cfg.vocab, d), d ** -0.5, dtype),
        "final_norm": ini.zeros((d,), torch.float32),
        "stages": [],
    }
    for st in cfg.stages():
        params["stages"].append([_init_layer(spec, cfg, ini, st.count, dtype)
                                 for spec in st.period])
    if not cfg.tie_embeddings:
        params["lm_head"] = ini.normal((d, cfg.vocab), d ** -0.5, dtype)
    return params


def params_from_numpy(tree, device: Union[str, torch.device] = "cuda"):
    """The weight bridge: a params tree whose leaves are numpy arrays (the
    reference's ``init_params`` output converted leaf by leaf) → the same
    nesting of torch tensors on ``device``, bytes unchanged."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    return conv(tree)


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------
def _cache_len(spec: LayerSpec, cfg: ModelConfig, max_len: int) -> int:
    w = spec.window or cfg.window
    return min(w, max_len) if w else max_len


def _layer_cache_shapes(spec: LayerSpec, cfg: ModelConfig, batch: int,
                        max_len: int, dtype) -> Dict:
    """name → (shape, dtype) of one layer's cache, per kind: ``{"k", "v"}``
    for attention, ``{"state", "conv"}`` for mamba, ``{"h", "conv"}`` for
    rglru (recurrent state in float32)."""
    if spec.kind in ("attn", "local"):
        S = _cache_len(spec, cfg, max_len)
        shape = (batch, cfg.n_kv, S, cfg.head_dim)
        return {"k": (shape, dtype), "v": (shape, dtype)}
    if spec.kind == "mamba":
        d_inner, H, P = ssm_dims(cfg)
        conv_ch = d_inner + 2 * cfg.ssm_state
        return {"state": ((batch, H, P, cfg.ssm_state), torch.float32),
                "conv": ((batch, 3, conv_ch), dtype)}
    w = cfg.rnn_width or cfg.d_model                # rglru
    return {"h": ((batch, w), torch.float32),
            "conv": ((batch, cfg.conv_width - 1, w), dtype)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Union[str, torch.device] = "cuda") -> List:
    """Per stage, per period entry: the layer kind's cache leaves as
    ``[count, batch, ...]`` zeros (``k``/``v`` of ``[count, batch, n_kv,
    S_cache, head_dim]`` for attention)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dtype = (_dtype(cfg.kv_cache_dtype) if cfg.kv_cache_dtype
             else _cdt(cfg))
    out = []
    for st in cfg.stages():
        out.append([
            {name: torch.zeros((st.count,) + shape, dtype=dt, device=dev)
             for name, (shape, dt) in _layer_cache_shapes(
                 spec, cfg, batch, max_len, dtype).items()}
            for spec in st.period])
    return out


# --------------------------------------------------------------------------
# layer application
# --------------------------------------------------------------------------
def _qkv(cfg: ModelConfig, p, x: torch.Tensor, positions: torch.Tensor):
    """x [B, S, d] → q [B, H, S, hd], k/v [B, KV, S, hd] (qk-norm, RoPE)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = qmm(x, p["wq"])
    k = qmm(x, p["wk"])
    v = qmm(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd).transpose(1, 2)
    k = k.reshape(B, S, KV, hd).transpose(1, 2)
    v = v.reshape(B, S, KV, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _self_attn_full(spec: LayerSpec, cfg: ModelConfig, p,
                    x: torch.Tensor) -> torch.Tensor:
    """Causal self-attention over the whole sequence (prefill and train;
    the reference's ``_self_attn_train``)."""
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, p, x, torch.arange(S, device=x.device))
    window = spec.window or cfg.window
    o = attention(q, k, v, causal=True, window=window,
                  chunk_q=cfg.attn_chunk_q, chunk_k=cfg.attn_chunk_k,
                  p_bf16=cfg.attn_p_bf16,
                  causal_groups=cfg.attn_causal_groups)
    return qmm(o.transpose(1, 2).reshape(B, S, -1), p["wo"])


def _self_attn_decode(spec: LayerSpec, cfg: ModelConfig, p,
                      x: torch.Tensor, cache: Dict, pos: int):
    """One-token decode against a ring (window) or linear cache.  The
    cache tensors are updated in place (the reference returns new ones)."""
    B = x.shape[0]
    q, k, v = _qkv(cfg, p, x, torch.full((1,), pos, device=x.device))
    ck, cv = cache["k"], cache["v"]
    S_c = ck.shape[2]
    window = spec.window or cfg.window
    slot = (pos % S_c) if window else min(pos, S_c - 1)
    ck[:, :, slot] = k[:, :, 0].to(ck.dtype)
    cv[:, :, slot] = v[:, :, 0].to(cv.dtype)
    n_valid = min(pos + 1, S_c)
    kv_valid = (torch.arange(S_c, device=x.device)[None] < n_valid
                ).expand(B, S_c)
    o = attention(q, ck, cv, causal=False, window=0, kv_valid=kv_valid)
    o = o.transpose(1, 2).reshape(B, 1, -1)
    return qmm(o, p["wo"]), {"k": ck, "v": cv}


def _prefill_kv(spec: LayerSpec, cfg: ModelConfig, p, h: torch.Tensor,
                cache: Dict) -> Dict:
    """Recompute K/V for the cache at prefill (window layers keep the ring
    tail)."""
    B, S, _ = h.shape
    _, k, v = _qkv(cfg, p, h, torch.arange(S, device=h.device))
    S_c = cache["k"].shape[2]
    window = spec.window or cfg.window
    ck = torch.zeros_like(cache["k"])
    cv = torch.zeros_like(cache["v"])
    if window and S >= S_c:
        # ring buffer: the last S_c tokens land at slots pos % S_c
        idx = torch.arange(S - S_c, S, device=h.device) % S_c
        ck[:, :, idx] = k[:, :, S - S_c:].to(ck.dtype)
        cv[:, :, idx] = v[:, :, S - S_c:].to(cv.dtype)
    else:
        n = min(S, S_c)
        ck[:, :, :n] = k[:, :, :n].to(ck.dtype)
        cv[:, :, :n] = v[:, :, :n].to(cv.dtype)
    return {"k": ck, "v": cv}


def apply_layer(spec: LayerSpec, cfg: ModelConfig, p, x: torch.Tensor, *,
                mode: str, cache: Optional[Dict] = None,
                pos: Optional[int] = None):
    """mode: 'train' | 'prefill' | 'decode' ('train' is prefill without
    the caches).  Returns (x, new_cache): the layer's cache leaves as
    computed (attention decode returns the cache tensors it updated in
    place; the recurrent kinds return new state tensors)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    new_cache: Dict[str, Any] = {}
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if spec.kind in ("attn", "local"):
        if mode == "decode":
            o, kv = _self_attn_decode(spec, cfg, p["attn"], h, cache, pos)
            new_cache.update(kv)
        else:
            o = _self_attn_full(spec, cfg, p["attn"], h)
            if mode == "prefill":
                new_cache.update(_prefill_kv(spec, cfg, p["attn"], h,
                                             cache))
    elif spec.kind == "mamba":
        if mode == "decode":
            o, st, cv = mamba_decode_step(p["mamba"], h, cache["state"],
                                          cache["conv"], cfg)
        else:
            o, st, cv = mamba_forward(p["mamba"], h, cfg)
        if mode != "train":
            new_cache.update({"state": st, "conv": cv})
    else:                                           # rglru
        if mode == "decode":
            o, hh, cv = rglru_decode_step(p["rglru"], h, cache["h"],
                                          cache["conv"], cfg)
        else:
            o, hh, cv = rglru_forward(p["rglru"], h, cfg)
        if mode != "train":
            new_cache.update({"h": hh, "conv": cv})
    x = x + o
    if spec.kind != "mamba":
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        if spec.moe:
            x = x + moe(p["moe"], h2, cfg)
        else:
            x = x + mlp(p["mlp"], h2, cfg.act)
    return x.to(_cdt(cfg)), new_cache


def _layer_params(tree, j: int):
    """Slice layer ``j`` out of a ``[count, ...]``-stacked params subtree."""
    if isinstance(tree, dict):
        return {k: _layer_params(v, j) for k, v in tree.items()}
    return tree[j]


# --------------------------------------------------------------------------
# stage loop
# --------------------------------------------------------------------------
def run_stages(cfg: ModelConfig, stages_params, x: torch.Tensor, *,
               mode: str, caches=None, pos: Optional[int] = None,
               stage_list=None):
    """Run every stage's period ``count`` times (a Python loop where the
    reference scans).  ``caches`` is updated in place — prefill writes each
    layer's recomputed K/V and recurrent state into it, decode the new
    token's — and returned: (x, caches).  Mode 'train' takes no caches."""
    stage_list = stage_list or cfg.stages()
    for si, (stage, sp) in enumerate(zip(stage_list, stages_params)):
        for j in range(stage.count):
            for i, spec in enumerate(stage.period):
                cc = (None if caches is None
                      else _layer_params(caches[si][i], j))
                x, nc = apply_layer(spec, cfg, _layer_params(sp[i], j), x,
                                    mode=mode, cache=cc, pos=pos)
                for name, t in nc.items():
                    if t is not cc[name]:
                        cc[name].copy_(t)
    return x, caches


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------
def _embed_tokens(cfg: ModelConfig, params, tokens: torch.Tensor
                  ) -> torch.Tensor:
    return params["embed"][tokens].to(_cdt(cfg))


def _logits(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    if isinstance(head, dict):
        return qmm(x, head).float()
    return (x @ head.to(x.dtype)).float()


def forward_train(cfg: ModelConfig, params, batch: Dict) -> torch.Tensor:
    """batch["tokens"] [B, S] → logits [B, S, V] (decoder-only stacks; the
    reference's vision and audio inputs are not ported)."""
    _check_supported(cfg)
    if cfg.n_vis_tokens:
        raise NotImplementedError(
            f"{cfg.name}: vision embeddings are not ported yet "
            f"(ROADMAP.md § A5b)")
    x = _embed_tokens(cfg, params, batch["tokens"])
    x, _ = run_stages(cfg, params["stages"], x, mode="train")
    return _logits(cfg, params, x)


def prefill(cfg: ModelConfig, params, batch: Dict, max_len: int
            ) -> Tuple[torch.Tensor, List]:
    """batch["tokens"] [B, S] → (last-position logits [B, 1, V], caches)."""
    _check_supported(cfg)
    tokens = batch["tokens"]
    x = _embed_tokens(cfg, params, tokens)
    caches = init_cache(cfg, x.shape[0], max_len, device=x.device)
    x, caches = run_stages(cfg, params["stages"], x, mode="prefill",
                           caches=caches)
    return _logits(cfg, params, x[:, -1:]), caches


def decode_step(cfg: ModelConfig, params, caches, token: torch.Tensor,
                pos: int) -> Tuple[torch.Tensor, List]:
    """token [B, 1] int; pos int → (logits [B, 1, V], caches).  The cache
    tensors are updated in place and returned."""
    x = _embed_tokens(cfg, params, token)
    x, caches = run_stages(cfg, params["stages"], x, mode="decode",
                           caches=caches, pos=int(pos))
    return _logits(cfg, params, x), caches
