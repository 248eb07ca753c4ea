"""Shared model layers: norms, RoPE, direct and chunked (flash-style)
attention, and the dense MLPs.

Counterpart of ``repro/models/layers.py``.  All attention flows through
:func:`attention`, which dispatches between a direct path (small S) and a
memory-bounded chunked online-softmax path, so activation memory stays
O(S·chunk) instead of O(S²).  The sort-based MoE layer is not part of this
slice (ROADMAP.md § A5).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .quantized import qmm

#: additive mask constant of the dense attention paths; the paged paths
#: (serve/engine.py, kernels/paged_attention) use -1e30 instead
NEG_INF = -2.0 ** 30


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32 with a ``1 + scale`` gain (zero-initialised
    scales are the identity)."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding over ``x [..., S, D]``; ``positions`` broadcasts
    against ``x.shape[:-1]``.  Pairs are the two halves of the vector
    (element i with element i + D/2), not interleaved neighbours."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions.float()[..., None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------
def _mask_bias(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
               window: int) -> torch.Tensor:
    """[Sq, Sk] additive bias: 0 where allowed, ``NEG_INF`` elsewhere."""
    ok = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                    device=qpos.device)
    if causal:
        ok &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        ok &= qpos[:, None] - kpos[None, :] < window
    return torch.where(ok, 0.0, NEG_INF)


def direct_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                     kv_valid: Optional[torch.Tensor] = None):
    """q [B,Hkv,G,Sq,D], k/v [B,Hkv,Sk,D] → [B,Hkv,G,Sq,D]."""
    Sq, D = q.shape[3], q.shape[4]
    Sk = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", q.float() * scale, k.float())
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    s = s + _mask_bias(qpos, kpos, causal, window)[None, None, None]
    if kv_valid is not None:
        s = torch.where(kv_valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bhkd->bhgqd", p, v.float()).to(q.dtype)


def chunked_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                      chunk_q=512, chunk_k=1024, p_bf16=False,
                      causal_groups=0,
                      kv_valid: Optional[torch.Tensor] = None):
    """Flash-style two-level loop with an online softmax; O(Sq·chunk_k)
    live memory.  ``causal_groups=N`` splits the q axis into N groups, each
    visiting only its causal KV prefix."""
    if kv_valid is not None:
        raise ValueError("kv_valid is only supported on the direct path")
    B, H, G, Sq, D = q.shape
    Sk = k.shape[2]
    cq, ck = min(chunk_q, Sq), min(chunk_k, Sk)
    pad_q, pad_k = (-Sq) % cq, (-Sk) % ck
    qp = F.pad(q, (0, 0, 0, pad_q))
    kp = F.pad(k, (0, 0, 0, pad_k))
    vp = F.pad(v, (0, 0, 0, pad_k))
    valid = torch.arange(Sk + pad_k, device=q.device) < Sk
    nq, nk = qp.shape[3] // cq, kp.shape[2] // ck
    scale = 1.0 / math.sqrt(D)

    def q_chunk(qi: int, nk_bound: int) -> torch.Tensor:
        qpos = q_offset + qi * cq + torch.arange(cq, device=q.device)
        qc = qp[:, :, :, qi * cq:(qi + 1) * cq].float() * scale
        m = torch.full((B, H, G, cq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, H, G, cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, G, cq, D), dtype=torch.float32,
                          device=q.device)
        for ki in range(nk_bound):
            kc = kp[:, :, ki * ck:(ki + 1) * ck].float()
            vc = vp[:, :, ki * ck:(ki + 1) * ck]
            kpos = ki * ck + torch.arange(ck, device=q.device)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qc, kc)
            s = s + _mask_bias(qpos, kpos, causal, window)[None, None, None]
            s = torch.where(valid[ki * ck:(ki + 1) * ck][None, None, None,
                                                         None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            if p_bf16:
                pv = torch.einsum("bhgqk,bhkd->bhgqd", p.bfloat16(),
                                  vc.bfloat16()).float()
            else:
                pv = torch.einsum("bhgqk,bhkd->bhgqd", p, vc.float())
            acc = acc * alpha[..., None] + pv
            m = m_new
        return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)

    if causal and causal_groups > 1 and not window and q_offset == 0:
        # triangular scheduling: q group g only visits its causal KV prefix
        ngr = min(causal_groups, nq)
        per = -(-nq // ngr)
        outs = []
        for g in range(ngr):
            q_lo, q_hi = g * per, min((g + 1) * per, nq)
            if q_lo >= q_hi:
                break
            nk_bound = min(nk, -(-(q_hi * cq) // ck))
            outs.extend(q_chunk(qi, nk_bound) for qi in range(q_lo, q_hi))
    else:
        outs = [q_chunk(qi, nk) for qi in range(nq)]
    return torch.cat(outs, dim=3)[:, :, :, :Sq]


def attention(q, k, v, *, causal=True, window=0, q_offset=0,
              chunk_q=512, chunk_k=1024, p_bf16=False, causal_groups=0,
              kv_valid=None):
    """Dispatch: q [B,Hq,Sq,D] (Hq = Hkv·G), k/v [B,Hkv,Sk,D]."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, Sq, D)
    if Sq * Sk <= 512 * 2048 or Sq == 1:
        out = direct_attention(qg, k, v, causal=causal, window=window,
                               q_offset=q_offset, kv_valid=kv_valid)
    else:
        out = chunked_attention(qg, k, v, causal=causal, window=window,
                                q_offset=q_offset, chunk_q=chunk_q,
                                chunk_k=chunk_k, p_bf16=p_bf16,
                                causal_groups=causal_groups,
                                kv_valid=kv_valid)
    return out.reshape(B, Hq, Sq, D)


# --------------------------------------------------------------------------
# channel mixers
# --------------------------------------------------------------------------
def mlp(params, x: torch.Tensor, act: str) -> torch.Tensor:
    """MLP with dense or quantized weights (``quantized.qmm``): ``swiglu``
    (w1, w3, w2), ``sq_relu`` (nemotron) or ``gelu`` with the tanh
    approximation (whisper)."""
    if act == "swiglu":
        h = F.silu(qmm(x, params["w1"])) * qmm(x, params["w3"])
    elif act == "sq_relu":
        h = torch.square(F.relu(qmm(x, params["w1"])))
    elif act == "gelu":
        h = F.gelu(qmm(x, params["w1"]), approximate="tanh")
    else:
        raise ValueError(f"unknown activation {act!r}")
    return qmm(h, params["w2"])
