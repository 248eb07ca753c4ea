"""Stage-structured decoder (+ optional encoder) for every architecture.

Counterpart of ``repro/models/model.py``.  Params are a plain nested dict
with the reference's tree layout: ``embed``, ``final_norm``, optional
``lm_head``, ``stages[i][j]`` — one dict per period entry of stage i,
every leaf stacked along a leading ``[count]`` axis — and, for
encoder-decoder stacks, ``encoder`` (``{"stages": [[attn layer]],
"final_norm"}``).  Caches mirror the decoder's structure.

Entry points (plain functions of ``(cfg, params, ...)``):

  * ``forward_train`` — the causal LM forward over a batch → logits;
  * ``lm_loss``       — mean next-token cross entropy of those logits;
  * ``prefill``       — forward over a prompt + emit the caches;
  * ``decode_step``   — one token with caches.

A batch holds ``tokens`` (and ``labels`` for the loss), plus
``audio_frames`` [B, n_audio_frames, d] for encoder-decoder stacks
(whisper: a bidirectional encoder over stub frame embeddings, whose
output every decoder layer cross-attends between its mixer and channel
mixer; prefill keeps the cross K/V in the cache as ``xk``/``xv``, decode
reads them there) and ``vision_embeds`` [B, n_vis_tokens, d] for vision
stacks (internvl2: prepended to the token embeddings).

Every attention and MLP projection goes through ``quantized.qmm``, so the
entry points also run a ``quantize_serving_params`` tree.  Every layer
kind is ported: attention (``attn``, and windowed ``local``/SWA ones),
RG-LRU (``rglru.py``) and Mamba-2 (``ssm.py``) mixers, dense and top-k
MoE channel mixers.  A product of a bfloat16 activation and a float32
weight computes in float32, as in the reference (``quantized.promoted``).
Gradients are autograd's over these ops; with ``cfg.remat`` a train
forward that records them runs each decoder and encoder layer under
``torch.utils.checkpoint`` (``remat_policy="dots"`` keeps the outputs of
the 2-D matmuls), which changes memory only.

``prefill`` and ``decode_step`` also run one rank's blocks of a device
mesh (``serve/step.py``): ``shard_params`` blocks whose layers gather
their FSDP blocks, caches cut by ``cache_specs`` (``CacheBlocks``), and
a decode attention that is sequence-parallel over a cut cache.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch.utils import checkpoint as torch_checkpoint

from ..device import resolve_device
from ..distributed import hlo_cost
from ..distributed.axes import (batch_cut, data_axis, in_scope, model_axis,
                                scope_mesh, seq_axis, to_block, train_mesh,
                                train_scope)
from ..distributed.sharding import (CacheBlocks, Sharding, cache_specs,
                                    param_specs, shardings_of)
from ..tree import leaves
from .config import LayerSpec, ModelConfig
from .layers import NEG_INF, attention, mlp, moe, rms_norm, rope
from .quantized import qmm
from .tp import (col_input, col_inputs, fsdp_layer, gather_cols,
                 row_parallel, vocab_embed)
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


def _init_attn(cfg: ModelConfig, ini: _Init, n: int, dtype,
               cross: bool = False) -> Dict:
    """Attention leaves; a cross-attention block has no bias and no
    qk-norm."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    s = d ** -0.5
    p = {
        "wq": ini.normal((n, d, H * hd), s, dtype),
        "wk": ini.normal((n, d, KV * hd), s, dtype),
        "wv": ini.normal((n, d, KV * hd), s, dtype),
        "wo": ini.normal((n, H * hd, d), (H * hd) ** -0.5, dtype),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = ini.zeros((n, H * hd), dtype)
        p["bk"] = ini.zeros((n, KV * hd), dtype)
        p["bv"] = ini.zeros((n, KV * hd), dtype)
    if cfg.qk_norm and not cross:
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
                dtype, with_cross: bool = False) -> Dict:
    """One period entry's leaves, stacked over its ``n`` layers: the
    reference's tree (mamba layers have no ``ln2`` and no channel mixer;
    MoE layers carry ``moe`` in place of ``mlp``; an encoder-decoder's
    decoder layers add ``ln_x`` and the cross-attention ``xattn``)."""
    d = cfg.d_model
    p: Dict[str, Any] = {"ln1": ini.zeros((n, d), torch.float32)}
    if spec.kind in ("attn", "local"):
        p["attn"] = _init_attn(cfg, ini, n, dtype)
    elif spec.kind == "mamba":
        p["mamba"] = init_mamba_params(cfg, ini, n, dtype)
    else:                                           # rglru
        p["rglru"] = init_rglru_params(cfg, ini, n, dtype)
    if with_cross:
        p["ln_x"] = ini.zeros((n, d), torch.float32)
        p["xattn"] = _init_attn(cfg, ini, n, dtype, cross=True)
    if spec.kind != "mamba":
        p["ln2"] = ini.zeros((n, d), torch.float32)
        if spec.moe:
            p["moe"] = _init_moe(cfg, ini, n, dtype)
        else:
            p["mlp"] = _init_mlp(cfg, ini, n, dtype)
    return p


def _build_params(cfg: ModelConfig, ini) -> Dict:
    dtype = _dt(cfg)
    d = cfg.d_model
    params: Dict[str, Any] = {
        "embed": ini.normal((cfg.vocab, d), d ** -0.5, dtype),
        "final_norm": ini.zeros((d,), torch.float32),
        "stages": [],
    }
    for st in cfg.stages():
        params["stages"].append([
            _init_layer(spec, cfg, ini, st.count, dtype,
                        with_cross=cfg.is_encdec)
            for spec in st.period])
    if not cfg.tie_embeddings:
        params["lm_head"] = ini.normal((d, cfg.vocab), d ** -0.5, dtype)
    if cfg.is_encdec:
        params["encoder"] = {
            "stages": [[_init_layer(LayerSpec("attn"), cfg, ini,
                                    cfg.n_enc_layers, dtype)]],
            "final_norm": ini.zeros((d,), torch.float32),
        }
    return params


def init_params(cfg: ModelConfig, seed: int = 0,
                device: Union[str, torch.device] = "cuda") -> Dict:
    """Random params with the reference's shapes, scales and tree layout,
    drawn on ``device`` from a ``torch.Generator`` seeded with ``seed``.
    The values differ from the reference's ``jax.random`` draws; tests
    that compare the two packages bridge the reference's params with
    :func:`params_from_numpy` instead."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return _build_params(cfg, _Init(gen, dev))


class _MetaInit:
    """Leaves on the ``meta`` device: shapes and dtypes, no storage."""

    def normal(self, shape, scale, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    def zeros(self, shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    def full(self, shape, value, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")


def params_shape(cfg: ModelConfig) -> Dict:
    """The params tree of ``cfg`` as ``meta`` tensors (the reference's
    ``jax.eval_shape`` of ``init_params``): what sharding rules read when
    a rank holds only blocks."""
    return _build_params(cfg, _MetaInit())


def abstract_params(cfg: ModelConfig) -> Dict:
    """The reference's ``abstract_params`` (``jax.eval_shape`` of
    ``init_params``: the dry run's params): :func:`params_shape`, the
    same paths, shapes and dtypes as meta tensors."""
    return params_shape(cfg)


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
    rglru (recurrent state in float32); an encoder-decoder's layers add
    the cross-attention's ``{"xk", "xv"}`` over the audio frames."""
    if spec.kind in ("attn", "local"):
        S = _cache_len(spec, cfg, max_len)
        shape = (batch, cfg.n_kv, S, cfg.head_dim)
        out = {"k": (shape, dtype), "v": (shape, dtype)}
    elif spec.kind == "mamba":
        d_inner, H, P = ssm_dims(cfg)
        conv_ch = d_inner + 2 * cfg.ssm_state
        out = {"state": ((batch, H, P, cfg.ssm_state), torch.float32),
               "conv": ((batch, 3, conv_ch), dtype)}
    else:                                           # rglru
        w = cfg.rnn_width or cfg.d_model
        out = {"h": ((batch, w), torch.float32),
               "conv": ((batch, cfg.conv_width - 1, w), dtype)}
    if cfg.is_encdec:
        shape = (batch, cfg.n_kv, cfg.n_audio_frames, cfg.head_dim)
        out.update(xk=(shape, dtype), xv=(shape, dtype))
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Union[str, torch.device] = "cuda") -> List:
    """Per stage, per period entry: the layer kind's cache leaves as
    ``[count, batch, ...]`` zeros (``k``/``v`` of ``[count, batch, n_kv,
    S_cache, head_dim]`` for attention); on ``device="meta"`` shapes and
    dtypes only (:func:`abstract_cache`).

    Under a mesh's ``logical_axes`` ``batch`` is the whole batch and each
    leaf is this rank's block by ``sharding.cache_specs`` (a
    ``CacheBlocks`` carrying the specs): ``k``/``v``/``xk``/``xv`` by
    batch and sequence, the Mamba ``state`` by heads, the RG-LRU ``h`` by
    width, ``conv`` by channels."""
    dev = (torch.device("meta") if str(device) == "meta"
           else resolve_device(device))
    dtype = (_dtype(cfg.kv_cache_dtype) if cfg.kv_cache_dtype
             else _cdt(cfg))
    mesh = scope_mesh()
    out = []
    for st in cfg.stages():
        out.append([
            {name: torch.zeros((st.count,) + shape, dtype=dt,
                               device="meta" if mesh is not None else dev)
             for name, (shape, dt) in _layer_cache_shapes(
                 spec, cfg, batch, max_len, dtype).items()}
            for spec in st.period])
    if mesh is None:
        return out
    specs = cache_specs(cfg, out, mesh, batch)
    blocks = CacheBlocks(_zeros_blocks(out, shardings_of(specs, mesh), dev))
    blocks.mesh, blocks.specs = mesh, specs
    return blocks


def _zeros_blocks(tree, shardings, dev):
    """Zeros of each meta leaf's block by its ``Sharding``, on ``dev``."""
    if isinstance(tree, dict):
        return {k: _zeros_blocks(v, shardings[k], dev)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_blocks(c, s, dev) for c, s in zip(tree, shardings)]
    return torch.zeros(shardings.local(tree).shape, dtype=tree.dtype,
                       device=dev)


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int) -> List:
    """The reference's ``abstract_cache`` (``jax.eval_shape`` of
    ``init_cache``): the cache tree as meta tensors (this rank's blocks
    under a mesh's ``logical_axes``, as :func:`init_cache`)."""
    return init_cache(cfg, batch, max_len, device="meta")


# --------------------------------------------------------------------------
# layer application
# --------------------------------------------------------------------------
def heads_cut_on(cfg: ModelConfig, M: int) -> bool:
    """Whether the query heads split into M blocks of whole heads, each
    reading a whole block of the kv heads or lying within one kv head:
    the condition for :func:`_qkv`'s ``q_block``."""
    H, KV = cfg.n_heads, cfg.n_kv
    if not H or H % M:
        return False
    hb, g = H // M, H // KV
    return hb % g == 0 or g % hb == 0


def _heads_cut(cfg: ModelConfig) -> bool:
    """Attention here may run on this rank's block of the query heads: a
    serve step on a wide ``model`` axis whose heads split
    (:func:`heads_cut_on`)."""
    m = model_axis()
    return (m is not None and train_mesh() is None
            and heads_cut_on(cfg, m[1]))


def _kv_heads(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor):
    """k/v [B, KV, S, hd], whole over the heads, narrowed to the kv heads
    that q [B, Hb, S, hd] reads when q is this rank's block of the query
    heads (``_qkv(q_block=True)``); k and v as they are when q is whole."""
    hb = q.shape[1]
    if hb == cfg.n_heads:
        return k, v
    g = cfg.n_heads // cfg.n_kv
    kv0, n = model_axis()[2] * hb // g, max(hb // g, 1)
    return k.narrow(1, kv0, n), v.narrow(1, kv0, n)


def _qkv(cfg: ModelConfig, p, x: torch.Tensor, positions: torch.Tensor,
         q_block: bool = False):
    """x [B, S, d] → q [B, H, S, hd], k/v [B, KV, S, hd] (qk-norm, RoPE).
    On a mesh the projections may be column blocks, gathered whole over
    ``model`` in one all-gather (``tp.gather_cols``, in the train step
    and the serve steps alike); head counts come from the projections'
    widths.  With ``q_block`` in a serve step whose heads split
    (:func:`_heads_cut`) q stays this rank's block of heads, and only k
    and v are gathered: the attention then runs on the rank's heads
    (:func:`_kv_heads`) into ``wo``'s row block, and k and v are whole
    for the caches."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    wholes = (cfg.n_heads * hd, cfg.n_kv * hd, cfg.n_kv * hd)
    ws = (p["wq"], p["wk"], p["wv"])
    q, k, v = (qmm(xi, w) for xi, w in zip(col_inputs(x, ws, wholes), ws))
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if q_block and _heads_cut(cfg):
        q = to_block(q, -1, wholes[0])
        k, v = gather_cols((k, v), wholes[1:])
    else:
        q, k, v = gather_cols((q, k, v), wholes)
    q = q.reshape(B, S, q.shape[-1] // hd, hd).transpose(1, 2)
    k = k.reshape(B, S, k.shape[-1] // hd, hd).transpose(1, 2)
    v = v.reshape(B, S, v.shape[-1] // hd, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _self_attn_full(spec: LayerSpec, cfg: ModelConfig, p,
                    x: torch.Tensor):
    """Causal self-attention over the whole sequence (prefill and train;
    the reference's ``_self_attn_train``) → (output, k, v): prefill
    writes the caches from this k and v (one q/k/v projection a layer,
    as XLA's common-subexpression pass leaves the reference's).  ``wo``
    may be a row block on a mesh (``tp.row_parallel``); in a serve step
    the attention runs on this rank's block of the heads where they
    split (``_qkv``'s ``q_block``)."""
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, p, x, torch.arange(S, device=x.device), True)
    window = spec.window or cfg.window
    o = attention(q, *_kv_heads(cfg, q, k, v), causal=True, window=window,
                  chunk_q=cfg.attn_chunk_q, chunk_k=cfg.attn_chunk_k,
                  p_bf16=cfg.attn_p_bf16,
                  causal_groups=cfg.attn_causal_groups)
    return (row_parallel(o.transpose(1, 2).reshape(B, S, -1), p["wo"],
                         cfg.n_heads * cfg.head_dim), k, v)


def _seq_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   valid: Optional[torch.Tensor], seq) -> torch.Tensor:
    """One query a sequence, q [B, H, 1, hd], against this rank's block of
    the keys and values k/v [B, KV, S_blk, hd] (``valid`` [S_blk]: which
    of them count; None: all), the blocks of the ranks of ``seq``
    (``axes.seq_axis``) making the whole sequence.  Each rank's partial
    online softmax — its running max ``m``, its sum ``l`` and its
    ``acc = Σ e^(s - m) v`` — is combined over ``seq``'s axes with one
    all-reduce max of ``m`` and one all-reduce sum of ``[acc·e^(m-M) |
    l·e^(m-M)]``.  A block with no valid key is the neutral partial (l and
    acc 0, m at the mask constant, whose weight e^(m-M) is 0 beside any
    valid key's), so no rank takes e^(-inf + inf)."""
    B, H, _, D = q.shape
    KV = k.shape[1]
    qg = q.reshape(B, KV, H // KV, 1, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float() * (1.0 / math.sqrt(D)),
                     k.float())
    if valid is not None:
        s = torch.where(valid, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    if valid is not None:
        e = torch.where(valid, e, 0.0)
    part = torch.cat([torch.einsum("bhgqk,bhkd->bhgqd", e, v.float()),
                      e.sum(-1, keepdim=True)], -1)
    big = seq.mesh.all_reduce(m.clone(), seq.axes, op="max")
    part = seq.mesh.all_reduce((part * torch.exp(m - big)).contiguous(),
                               seq.axes)
    out = part[..., :D] / torch.clamp(part[..., D:], min=1e-30)
    return out.to(q.dtype).reshape(B, H, 1, D)


class _SeqCut(NamedTuple):
    """A cache leaf's sequence cut: ``n`` blocks over ``axes`` of
    ``mesh``, this rank's the ``index``-th."""
    mesh: Any
    n: int
    index: int
    axes: Any


def _seq_block(cache_spec, name: str) -> Optional[_SeqCut]:
    """The sequence cut of the cache leaf ``name`` (its spec's dim 3,
    ``axes.seq_axis``), or None: the cache is whole over its sequence."""
    if cache_spec is None:
        return None
    ax = cache_spec[name][3]
    got = seq_axis(ax)
    return None if got is None else _SeqCut(*got, ax)


def _self_attn_decode(spec: LayerSpec, cfg: ModelConfig, p,
                      x: torch.Tensor, cache: Dict, pos: int, seq=None):
    """One-token decode against a ring (window) or linear cache.  The
    cache tensors are updated in place (the reference returns new ones).

    ``seq`` (:func:`_seq_block`) says the cache is this rank's block of
    the sequence: q, k and v come whole over ``model`` (one all-gather),
    only the rank whose block holds the new token's slot writes it, and
    each rank attends over its block (:func:`_seq_attention`) before
    ``wo``'s row block (``tp.row_parallel``).  A cache whole over its
    sequence is attended on this rank's block of the heads where they
    split (``_qkv``'s ``q_block``), through ``layers.attention``'s direct
    path, the reference's formulation: an unmeshed decode computes what it
    computed before the sequence cut existed, so every check held against
    it (the reference within tolerance, the paged engine's tokens) holds
    unchanged, and only a cut cache takes the partials' combine.  ``pos``
    is a host int, the same on every rank."""
    B = x.shape[0]
    q, k, v = _qkv(cfg, p, x, torch.full((1,), pos, device=x.device),
                   seq is None)
    ck, cv = cache["k"], cache["v"]
    n, r = (1, 0) if seq is None else (seq.n, seq.index)
    S_blk = ck.shape[2]
    S_c, s0 = S_blk * n, r * S_blk
    window = spec.window or cfg.window
    slot = (pos % S_c) if window else min(pos, S_c - 1)
    if s0 <= slot < s0 + S_blk:
        ck[:, :, slot - s0] = k[:, :, 0].to(ck.dtype)
        cv[:, :, slot - s0] = v[:, :, 0].to(cv.dtype)
    n_valid = min(pos + 1, S_c)
    kpos = torch.arange(s0, s0 + S_blk, device=x.device)
    if seq is None:
        kv_valid = (kpos[None] < n_valid).expand(B, S_c)
        o = attention(q, *_kv_heads(cfg, q, ck, cv), causal=False,
                      window=0, kv_valid=kv_valid)
    else:
        o = _seq_attention(q, ck, cv, kpos < n_valid, seq)
    o = o.transpose(1, 2).reshape(B, 1, -1)
    return (row_parallel(o, p["wo"], cfg.n_heads * cfg.head_dim),
            {"k": ck, "v": cv})


def _prefill_kv(spec: LayerSpec, cfg: ModelConfig, k: torch.Tensor,
                v: torch.Tensor, cache: Dict, seq=None) -> Dict:
    """Write the prompt's K/V [B, KV, S, hd] into the fresh (zero) cache
    in place (window layers keep the ring tail, token t at slot
    ``t % S_c``); under ``seq`` (:func:`_seq_block`) the cache is this
    rank's block of the sequence, and takes the slots it holds."""
    S = k.shape[2]
    ck, cv = cache["k"], cache["v"]
    n, r = (1, 0) if seq is None else (seq.n, seq.index)
    S_blk = ck.shape[2]
    S_c, s0 = S_blk * n, r * S_blk
    window = spec.window or cfg.window
    if window and S >= S_c:
        # ring buffer: slot g holds the token t of the last S_c with
        # t % S_c == g
        g = torch.arange(s0, s0 + S_blk, device=k.device)
        t = S - S_c + (g - S) % S_c
        ck.copy_(k[:, :, t])
        cv.copy_(v[:, :, t])
    else:
        m = max(min(min(S, S_c) - s0, S_blk), 0)
        ck[:, :, :m] = k[:, :, s0:s0 + m].to(ck.dtype)
        cv[:, :, :m] = v[:, :, s0:s0 + m].to(cv.dtype)
    return {"k": ck, "v": cv}


def _cross_attn(cfg: ModelConfig, p, x: torch.Tensor, xk: torch.Tensor,
                xv: torch.Tensor, seq=None) -> torch.Tensor:
    """x [B, S, d] attends, unmasked, to the encoder's K/V [B, KV, F, hd].
    On a mesh ``wq`` may be a column block and ``wo`` a row block
    (``tp.row_parallel``), as in self-attention: q is gathered whole
    (``tp.gather_cols``) under ``seq`` (decode against cached ``xk``/``xv``
    cut over the frames, whose partials combine as in self-attention,
    :func:`_seq_attention`) and in the train step, and otherwise stays
    this rank's block of heads where they split (:func:`_heads_cut`)."""
    B, S, _ = x.shape
    width = cfg.n_heads * cfg.head_dim
    q = qmm(col_input(x, p["wq"], width), p["wq"])
    q = (to_block(q, -1, width) if seq is None and _heads_cut(cfg)
         else gather_cols((q,), (width,))[0])
    q = q.reshape(B, S, -1, cfg.head_dim).transpose(1, 2)
    if seq is None:
        o = attention(q, *_kv_heads(cfg, q, xk, xv), causal=False, window=0)
    else:
        o = _seq_attention(q, xk, xv, None, seq)
    return row_parallel(o.transpose(1, 2).reshape(B, S, -1), p["wo"], width)


def _make_cross_kv(cfg: ModelConfig, p, enc_out: torch.Tensor):
    """The cross-attention's K/V [B, KV, F, hd] of the encoder output (on
    a train mesh from column blocks, gathered whole in one all-gather)."""
    B, F_, _ = enc_out.shape
    KV, hd = cfg.n_kv, cfg.head_dim
    ws, wholes = (p["wk"], p["wv"]), (KV * hd, KV * hd)
    xk, xv = gather_cols([qmm(e, w) for e, w in zip(
        col_inputs(enc_out, ws, wholes), ws)], wholes)
    return (xk.reshape(B, F_, KV, hd).transpose(1, 2),
            xv.reshape(B, F_, KV, hd).transpose(1, 2))


def apply_layer(spec: LayerSpec, cfg: ModelConfig, p, x: torch.Tensor, *,
                mode: str, cache: Optional[Dict] = None,
                pos: Optional[int] = None,
                enc_out: Optional[torch.Tensor] = None, cache_spec=None):
    """mode: 'train' | 'prefill' | 'decode' ('train' is prefill without
    the caches).  Returns (x, new_cache): the layer's cache leaves as
    computed (attention returns the cache tensors it wrote in place; the
    recurrent kinds return new state tensors, whole where a mesh cuts
    the cache: ``run_stages`` keeps this rank's block).  In an
    encoder-decoder stack, train and prefill compute the cross K/V from
    ``enc_out`` (prefill returns them for the cache), decode reads them
    from the cache.  ``cache_spec`` is the layer's ``cache_specs`` (name
    → spec, the stack dim first) when the caches are a mesh rank's
    blocks (``CacheBlocks``), else None."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    new_cache: Dict[str, Any] = {}
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if spec.kind in ("attn", "local"):
        seq = _seq_block(cache_spec, "k")
        if mode == "decode":
            o, kv = _self_attn_decode(spec, cfg, p["attn"], h, cache, pos,
                                      seq)
            new_cache.update(kv)
        else:
            o, k, v = _self_attn_full(spec, cfg, p["attn"], h)
            if mode == "prefill":
                new_cache.update(_prefill_kv(spec, cfg, k, v, cache, seq))
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
    if cfg.is_encdec and (enc_out is not None or mode == "decode"):
        hx = rms_norm(x, p["ln_x"], cfg.norm_eps)
        if mode == "decode":
            xk, xv = cache["xk"], cache["xv"]
        else:
            xk, xv = _make_cross_kv(cfg, p["xattn"], enc_out)
        if mode != "train":
            new_cache.update({"xk": xk, "xv": xv})
        seq = _seq_block(cache_spec, "xk") if mode == "decode" else None
        x = x + _cross_attn(cfg, p["xattn"], hx, xk, xv, seq)
    if spec.kind != "mamba":
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        if spec.moe:
            x = x + moe(p["moe"], h2, cfg)
        else:
            x = x + mlp(p["mlp"], h2, cfg.act, cfg.d_ff)
    return x.to(_cdt(cfg)), new_cache


def _layer_params(tree, j: int):
    """Slice layer ``j`` out of a ``[count, ...]``-stacked params subtree."""
    if isinstance(tree, dict):
        return {k: _layer_params(v, j) for k, v in tree.items()}
    return tree[j]


def _per_layer(tree, count: int) -> List:
    """A ``[count, ...]``-stacked params or cache subtree as ``count``
    per-layer subtrees of views, one ``unbind`` per leaf (a cache layer's
    view is written in place with ``copy_``).  Its backward stacks the
    layers' gradients once; slicing each layer out on its own
    (:func:`_layer_params`) would make autograd build and add up ``count``
    zero-padded full-size gradients per leaf."""
    if isinstance(tree, dict):
        kids = {k: _per_layer(v, count) for k, v in tree.items()}
        return [{k: kids[k][j] for k in kids} for j in range(count)]
    return tree.unbind(0)


# --------------------------------------------------------------------------
# stage loop
# --------------------------------------------------------------------------
#: what ``remat_policy="dots"`` keeps: the outputs of 2-D matmuls, which
#: every projection lowers to (the reference's
#: ``dots_with_no_batch_dims_saveable``); batched products — attention's
#: and the experts' einsums — are recomputed, as there
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    policy = torch_checkpoint.CheckpointPolicy
    return policy.MUST_SAVE if op in _DOTS else policy.PREFER_RECOMPUTE


def _remat_kwargs(policy: str) -> Dict:
    """``torch.utils.checkpoint.checkpoint`` arguments for a remat policy.
    Nothing in a layer draws random numbers, so no RNG state is kept."""
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts,
            _save_dots)
    elif policy != "nothing":
        raise ValueError(f"unknown remat_policy {policy!r}")
    return kw


@functools.lru_cache(maxsize=8)
def _train_specs(cfg: ModelConfig, mesh):
    """``param_specs`` of ``cfg``'s whole params on ``mesh`` (None without
    a mesh): what :func:`tp.fsdp_layer` reads a layer's FSDP dims from."""
    return None if mesh is None else param_specs(cfg, params_shape(cfg), mesh)


def _train_layer(spec, cfg, p, x, enc_out, scope, specs=None):
    """One layer of the train forward, in ``scope`` (the caller's
    ``axes.train_scope``).  Under the train step on a mesh its FSDP
    blocks are gathered first (``specs``: the layer's param specs); a
    remat replay re-enters the caller's scope (the replay may run on
    autograd's device thread, which sees no context of the caller's: the
    MoE's route and the blocked forms read it) and so gathers again, in
    the same order on every rank."""
    with in_scope(scope):
        return apply_layer(spec, cfg, fsdp_layer(p, specs, cfg), x,
                           mode="train", enc_out=enc_out)[0]


def _train_rematted(fn, remat_kw, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``remat_kw``
    is given."""
    if remat_kw is None:
        return fn(*args)
    return torch_checkpoint.checkpoint(fn, *args, **remat_kw)


def _remat(cfg: ModelConfig, mode: str, x: torch.Tensor, params):
    """The remat arguments of a forward: None unless ``cfg.remat`` and
    autograd records a train forward."""
    remat = (cfg.remat and mode == "train" and torch.is_grad_enabled()
             and (x.requires_grad
                  or any(t.requires_grad for t in leaves(params))))
    return _remat_kwargs(cfg.remat_policy) if remat else None


def run_stages(cfg: ModelConfig, stages_params, x: torch.Tensor, *,
               mode: str, caches=None, pos: Optional[int] = None,
               enc_out: Optional[torch.Tensor] = None, stage_list=None,
               serve_specs=None):
    """Run every stage's period ``count`` times (a Python loop where the
    reference scans).  ``caches`` is updated in place — prefill writes each
    layer's K/V and recurrent state into it, decode the new token's — and
    returned: (x, caches).  Mode 'train' takes no caches; with
    ``cfg.remat``, when autograd records the forward, each layer runs
    under ``torch.utils.checkpoint`` (its activations are recomputed in
    the backward, as under the reference's ``jax.checkpoint``).  Under the
    train step on a mesh each train layer gathers its FSDP blocks first
    (``_train_layer``); in prefill and decode ``serve_specs`` (the
    ``param_specs`` a ``ParamBlocks`` carries) names the FSDP blocks each
    layer gathers over ``data`` first (``tp.fsdp_layer``'s serve form),
    and ``CacheBlocks`` caches are written as this rank's blocks.  Under
    the dry run's walker each stage is a loop scope of ``count`` trips
    (``distributed/hlo_cost.py``)."""
    stage_list = stage_list or cfg.stages()
    remat_kw = _remat(cfg, mode, x, stages_params)
    mesh = train_mesh() if mode == "train" else None
    scope, specs = train_scope(), _train_specs(cfg, mesh)
    cspecs = getattr(caches, "specs", None)
    walker = hlo_cost.active()          # None unless a dry run traces
    for si, (stage, sp) in enumerate(zip(stage_list, stages_params)):
        if walker is not None:
            walker.enter_loop(f"{mode} stages[{si}]", stage.count)
        layers = [_per_layer(sp[i], stage.count)
                  for i in range(len(stage.period))]
        layer_caches = (None if caches is None else
                        [_per_layer(caches[si][i], stage.count)
                         for i in range(len(stage.period))])
        for j in range(stage.count):
            for i, spec in enumerate(stage.period):
                pp = layers[i][j]
                if remat_kw is not None or mesh is not None:
                    x = _train_rematted(
                        _train_layer, remat_kw, spec, cfg, pp, x, enc_out,
                        scope, None if specs is None else
                        specs["stages"][si][i])
                    continue
                if serve_specs is not None:
                    pp = fsdp_layer(pp, serve_specs["stages"][si][i], cfg)
                cc = None if caches is None else layer_caches[i][j]
                cs = None if cspecs is None else cspecs[si][i]
                x, nc = apply_layer(spec, cfg, pp, x, mode=mode, cache=cc,
                                    pos=pos, enc_out=enc_out, cache_spec=cs)
                for name, t in nc.items():
                    if t is not cc[name]:
                        cc[name].copy_(t if cs is None else _block_of(
                            t, cc[name], Sharding(caches.mesh, cs[name])))
        if walker is not None:
            walker.exit_loop()
    return x, caches


def _block_of(t: torch.Tensor, like: torch.Tensor,
              sharding: Sharding) -> torch.Tensor:
    """``t``, one layer's cache leaf as a layer computed it, as the block
    ``like`` holds: narrowed to this rank's block on each dim the
    sharding cuts where ``t`` is whole (the stack dim is gone; the batch
    is already the rank's rows)."""
    for i, _, _, idx in sharding.blocks():
        d, blk = i - 1, like.shape[i - 1]
        if t.shape[d] != blk:
            t = t.narrow(d, idx * blk, blk)
    return t


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------
def _embed_tokens(cfg: ModelConfig, params, tokens: torch.Tensor,
                  extra_embeds: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Token embeddings in the compute dtype, ``extra_embeds`` (vision
    tokens) in front; a vocab-sharded lookup under the train step on a
    mesh (``tp.vocab_embed``)."""
    x = vocab_embed(params["embed"], tokens, cfg.vocab).to(_cdt(cfg))
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(_cdt(cfg)), x], dim=1)
    return x


def _logits(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """Final norm and the vocab product, as float32.  Under the train
    step on a mesh the head may be a vocab column block: the logits are
    gathered whole over ``model`` (in the compute dtype) before the loss,
    so every rank holds all of them, B·S·V·4 bytes once cast (0.62 GB at
    qwen3-0.6b's 151,936-word vocab and 8 x 128 tokens)."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    if isinstance(head, dict):
        y = qmm(x, head)
    else:
        y = col_input(x, head, cfg.vocab) @ head.to(x.dtype)
    return gather_cols((y,), (cfg.vocab,))[0].float()


def _encoder_layer(cfg: ModelConfig, p, x: torch.Tensor, scope,
                   specs=None) -> torch.Tensor:
    """One encoder layer, in ``scope``: bidirectional attention with RoPE
    and a gelu MLP, in the train step's blocked forms on a mesh (its FSDP
    blocks gathered first, as in :func:`_train_layer`)."""
    with in_scope(scope):
        p = fsdp_layer(p, specs, cfg)
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        B, S, _ = h.shape
        q, k, v = _qkv(cfg, p["attn"], h, torch.arange(S, device=h.device),
                       True)
        o = attention(q, *_kv_heads(cfg, q, k, v), causal=False, window=0)
        x = x + row_parallel(o.transpose(1, 2).reshape(B, S, -1),
                             p["attn"]["wo"], cfg.n_heads * cfg.head_dim)
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        return (x + mlp(p["mlp"], h2, "gelu", cfg.d_ff)).to(_cdt(cfg))


def _run_encoder(cfg: ModelConfig, params, frames: torch.Tensor,
                 serve_specs=None) -> torch.Tensor:
    """Whisper-style encoder over stub frame embeddings [B, F, d]: each
    layer (:func:`_encoder_layer`, under remat as the decoder's layers
    are), then the encoder's final norm.  ``serve_specs``: as in
    :func:`run_stages`."""
    enc = params["encoder"]["stages"][0][0]
    x = frames.to(_cdt(cfg))
    remat_kw = _remat(cfg, "train", x, enc)
    scope = train_scope()
    specs = _train_specs(cfg, train_mesh()) or serve_specs
    for p in _per_layer(enc, cfg.n_enc_layers):
        x = _train_rematted(_encoder_layer, remat_kw, cfg, p, x, scope,
                            None if specs is None else
                            specs["encoder"]["stages"][0][0])
    return rms_norm(x, params["encoder"]["final_norm"], cfg.norm_eps)


def _inputs(cfg: ModelConfig, params, batch: Dict, serve_specs=None):
    """(decoder input embeddings, encoder output or None) of a batch."""
    enc_out = (_run_encoder(cfg, params, batch["audio_frames"], serve_specs)
               if cfg.is_encdec else None)
    extra = batch["vision_embeds"] if cfg.n_vis_tokens else None
    return _embed_tokens(cfg, params, batch["tokens"], extra), enc_out


def forward_train(cfg: ModelConfig, params, batch: Dict) -> torch.Tensor:
    """batch: tokens [B, S'] (+ audio_frames / vision_embeds) → logits
    [B, S, V] (S = n_vis_tokens + S' for vision stacks)."""
    x, enc_out = _inputs(cfg, params, batch)
    x, _ = run_stages(cfg, params["stages"], x, mode="train",
                      enc_out=enc_out)
    return _logits(cfg, params, x)


def lm_loss(cfg: ModelConfig, params, batch: Dict) -> torch.Tensor:
    """Mean over positions of logsumexp minus the label's logit, the
    vision positions sliced off first.  The label logit is a ``gather``:
    exact, and equal to the reference's masked sum over the vocab."""
    logits = forward_train(cfg, params, batch)
    if cfg.n_vis_tokens:
        logits = logits[:, cfg.n_vis_tokens:]
    lse = torch.logsumexp(logits, dim=-1)
    labels = batch["labels"].long()
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (lse - ll).mean()


def _whole_batch(rows: int) -> int:
    """The whole batch of which ``rows`` are this rank's: times the batch
    axes' width when the scope says they cut it (``axes.batch_cut``)."""
    d = data_axis()
    return rows * d[1] if d is not None and batch_cut() else rows


def prefill(cfg: ModelConfig, params, batch: Dict, max_len: int
            ) -> Tuple[torch.Tensor, List]:
    """batch: tokens [B, S'] (+ audio_frames / vision_embeds) →
    (last-position logits [B, 1, V], caches).  ``max_len`` bounds the
    positions, vision tokens included.

    On a mesh (inside ``logical_axes``, whose ``batch_cut`` says whether
    the batch is this rank's block over the batch axes) ``params`` may be
    ``shard_params`` blocks: each layer gathers its FSDP blocks, the
    products are tensor-parallel, and the caches come back as this rank's
    ``CacheBlocks``; the logits are this rank's rows, whole over the
    vocab."""
    specs = getattr(params, "specs", None)
    x, enc_out = _inputs(cfg, params, batch, specs)
    caches = init_cache(cfg, _whole_batch(x.shape[0]), max_len,
                        device=x.device)
    x, caches = run_stages(cfg, params["stages"], x, mode="prefill",
                           caches=caches, enc_out=enc_out, serve_specs=specs)
    return _logits(cfg, params, x[:, -1:]), caches


def decode_step(cfg: ModelConfig, params, caches, token: torch.Tensor,
                pos: int) -> Tuple[torch.Tensor, List]:
    """token [B, 1] int; pos int → (logits [B, 1, V], caches).  The cache
    tensors are updated in place and returned; an encoder-decoder's
    cross-attention reads the K/V prefill left there.  On a mesh as
    :func:`prefill`: ``CacheBlocks`` caches cut over their sequence make
    the attention sequence-parallel (``_self_attn_decode``)."""
    x = _embed_tokens(cfg, params, token)
    x, caches = run_stages(cfg, params["stages"], x, mode="decode",
                           caches=caches, pos=int(pos),
                           serve_specs=getattr(params, "specs", None))
    return _logits(cfg, params, x), caches
