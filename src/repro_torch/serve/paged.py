"""VBI-paged serving, the legacy per-sequence path (counterpart of
``repro/serve/paged.py``), and the per-slot-position QKV projection that
the batched serve step shares with it.

:class:`PagedServer` decodes a batch of ragged sequences, each a Virtual
Block of ``core/vbi/kvcache.py::PagedKVManager``.  Per decode step and
layer: ``begin_token`` reserves the next position (delayed page
allocation), ``write_layer`` stores each sequence's new K/V, and
``kernels/paged_attention::paged_decode_attention`` attends over the page
table — the Hopper kernel on the card, its plain twin on the CPU.  It
reads each sequence's length from the device per token and writes K/V
one sequence at a time, by design: it is the numerical oracle of
``serve/engine.py::PagedEngine``, which folds the whole step into device
work with no host read.  New code should use the engine.
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from ..core.vbi.kvcache import PagedKVManager
from ..device import stage
from ..distributed.axes import to_whole_last
from ..kernels.paged_attention import paged_decode_attention
from ..models.config import ModelConfig
from ..models.layers import mlp, rms_norm, rope
from ..models.model import _logits, _per_layer
from ..models.quantized import matmul, qmm


class PagedServer:
    """Minimal single-device paged decoder for uniform dense GQA stacks.

    ``device`` defaults to ``cuda``, where attention is the kernel; on
    ``cpu`` it is the kernel's plain twin.  ``params`` must live on
    ``device``."""

    def __init__(self, cfg: ModelConfig, params, n_pages: int = 256,
                 page_size: int = 16, max_seqs: int = 8,
                 device: Union[str, torch.device] = "cuda"):
        if (cfg.local_global_period or cfg.rglru_period
                or cfg.family not in ("dense", "vlm")):
            raise ValueError(f"paged server supports uniform GQA stacks, "
                             f"not {cfg.name}")
        self.cfg = cfg
        self.params = params
        self.kv = PagedKVManager(
            n_layers=cfg.n_layers, n_pages=n_pages, page_size=page_size,
            n_kv=cfg.n_kv, head_dim=cfg.head_dim, max_seqs=max_seqs,
            dtype=torch.float32, device=device)
        self.device = self.kv.state.k_pages.device
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"server on {self.device}")
        self._layers = _per_layer(params["stages"][0][0], cfg.n_layers)
        #: decode calls made (each attends once per layer)
        self.decode_calls = 0

    def admit(self, seq_idx: int) -> None:
        self.kv.new_seq(seq_idx)

    def evict(self, seq_idx: int) -> None:
        self.kv.release_seq(seq_idx)

    def decode(self, tokens: torch.Tensor,
               seq_ids: Sequence[int]) -> torch.Tensor:
        """One token for each listed sequence slot: tokens [B, 1] → logits
        [B, 1, V] on the device.  The attention reads the first
        ``max_pages`` columns of the rows, the most pages any listed
        sequence holds after ``begin_token``, taken from the manager's host
        page lists (the reference reads ``seq_lens.max()`` from the
        device: the same columns are read, as each row masks past its
        length)."""
        cfg, dev = self.cfg, self.device
        x = self.params["embed"][tokens.to(dev).long()].float()  # [B,1,d]
        positions = stage(np.asarray(
            [self.kv.begin_token(s) for s in seq_ids], np.int32), dev)
        ids = stage(np.asarray(seq_ids, np.int64), dev)
        max_pages = max(1, max(len(self.kv.seq_pages[s]) for s in seq_ids))
        B = x.shape[0]
        for li, lp in enumerate(self._layers):
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            q, k, v = _qkv_ragged(cfg, lp["attn"], h, positions)
            for bi, sid in enumerate(seq_ids):
                self.kv.write_layer(sid, li, k[bi, :, 0], v[bi, :, 0])
            o = paged_decode_attention(q[:, :, 0], self.kv.state, li,
                                       n_kv=cfg.n_kv, seq_ids=ids,
                                       max_pages=max_pages)
            x = x + matmul(o.reshape(B, 1, -1).to(x.dtype), lp["attn"]["wo"])
            h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
            x = x + mlp(lp["mlp"], h2, cfg.act, cfg.d_ff)
        self.decode_calls += 1
        return _logits(cfg, self.params, x)


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
    q, k, v = (qmm(x, p[n]) for n in ("wq", "wk", "wv"))
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
